"""The training step: microbatched gradient accumulation in
``cfg.grad_dtype``, the optimizer's update, loss metrics
(``repro/train/train_step.py``).

The state is ``{"params": Params, "opt": optimizer state, "step": int}``.
The step runs the microbatches one after another (the JAX package's
``lax.scan``), each a forward and a backward through ``lm.loss_fn``;
only the last phase, the optimizer's update, changes the state, and it
changes the weights in place.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
from torch.distributed.tensor import DTensor, Replicate

from ..models import lm
from ..models.config import ModelConfig
from .optimizer import get_optimizer


def init_train_state(
    cfg: ModelConfig,
    generator: Optional[torch.Generator] = None,
    device: Optional[Union[str, torch.device]] = None,
    params: Optional[lm.Params] = None,
) -> Dict:
    """A fresh train state: ``params`` (or weights drawn from
    ``generator`` on ``device``) made trainable, and the optimizer's
    state.  Serving keeps its weights frozen; this is where training
    makes its own trainable ones."""
    if params is None:
        params = lm.init_params(cfg, generator, device=device)
    params.requires_grad_(True)
    opt = get_optimizer(cfg.optimizer)
    return {"params": params, "opt": opt.init(params), "step": 0}


def _microbatch(v: torch.Tensor, n_micro: int, i: int) -> torch.Tensor:
    """Rows ``[i * B / n_micro, (i + 1) * B / n_micro)`` of the batch, as
    the JAX package's ``reshape(n_micro, B // n_micro, ...)`` and scan take
    them.  A DTensor batch sharded on its batch dim cannot be split so
    when the ranks do not divide ``n_micro`` (DTensor has no strategy for
    that view): it is gathered (an explicit redistribute to replicated),
    split, and microbatch i sharded again as the batch was."""
    if isinstance(v, DTensor) and any(p.is_shard() for p in v.placements):
        whole = v.redistribute(v.device_mesh, [Replicate()] * v.device_mesh.ndim)
        part = whole.reshape(n_micro, v.shape[0] // n_micro, *v.shape[1:])[i]
        return part.redistribute(v.device_mesh, v.placements)
    return v.reshape(n_micro, v.shape[0] // n_micro, *v.shape[1:])[i]


def make_train_step(cfg: ModelConfig):
    opt = get_optimizer(cfg.optimizer)
    gdt = getattr(torch, cfg.grad_dtype)

    def train_step(state: Dict, batch: Dict[str, torch.Tensor]) -> Tuple[Dict, Dict]:
        params = state["params"]
        n_micro = cfg.microbatches
        named = list(params.named_parameters())
        leaves = [p for _, p in named]
        # zeros_like: a DTensor weight's accumulator is a DTensor of its placements
        acc = [torch.zeros_like(p, dtype=gdt) for p in leaves]
        losses = []
        for i in range(n_micro):
            mb = {k: _microbatch(v, n_micro, i) for k, v in batch.items()}
            loss, _ = lm.loss_fn(cfg, params, mb)
            grads = torch.autograd.grad(loss, leaves)
            with torch.no_grad():
                for a, g in zip(acc, grads):
                    a.add_(g.to(gdt))
            losses.append(loss.detach())
            del loss, grads
        with torch.no_grad():
            grads = {name: a.div_(n_micro).to(torch.float32) for (name, _), a in zip(named, acc)}
            del acc
            new_opt = opt.update(grads, state["opt"], params)
            metrics = {
                "loss": torch.stack(losses).mean(),
                "grad_norm": torch.sqrt(sum(torch.sum(g * g) for g in grads.values())),
            }
        return {"params": params, "opt": new_opt, "step": state["step"] + 1}, metrics

    return train_step
