"""Optimizers: AdamW (float32 master copy and moments) and memory-lean
Adafactor (factored second moment, no first moment), with the JAX
package's arithmetic (``repro/train/optimizer.py``).

They work on the port's weights, a ``Params`` module, and on gradients
keyed by parameter name (``named_parameters``), and update the weights
in place where the JAX package returns new ones: a second copy of the
weights at full width would not fit the card.  ``update`` returns the new
optimizer state.

AdamW is elementwise, so it runs leaf by leaf.  Adafactor is not: the
JAX package factors the second moment of each leaf of its stacked layer
parameters (L, ...) and clips each leaf's update by its RMS over all L
layers, so a block weight of rank 1 (a norm scale, (L, D) stacked) is
factored across layers.  The port stacks each group of per-block weights
(``blocks.<i>.attn.wq`` for every i) the same way for the update, so both
packages keep the same moments (keyed by the group, ``blocks.attn.wq``)
and make the same updates.  ``state_specs`` gives the partition spec of
every leaf of the state from the weights' (``models.partition``): a
per-weight leaf the weight's own, a stacked group's moments the
reference's stacked spec.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from ..models.lm import Params
from ..models.partition import P

Grads = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Params], Dict]
    update: Callable[[Grads, Dict, Params], Dict]  # (grads, state, params) -> state
    state_specs: Callable[[Dict[str, P], Params], Dict]  # (param_specs, params) -> specs


def _f32_pow(base: float, step: int) -> float:
    """``base ** step`` rounded as the JAX package computes it, in float32."""
    return float(np.float32(base) ** np.float32(step))


def _one_minus_pow(base: float, step):
    """``1 - base ** step`` in float32: a float for a host int step, a 0-d
    float32 tensor for a step held in a tensor (the sharded dry run's
    state, which no host reads)."""
    if isinstance(step, torch.Tensor):
        return 1 - torch.pow(torch.full_like(step, base, dtype=torch.float32),
                             step.to(torch.float32))
    return float(np.float32(1) - np.float32(_f32_pow(base, step)))


# ----------------------------------------------------------------------
# AdamW
# ----------------------------------------------------------------------
def adamw(
    lr: float = 3e-4,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
) -> Optimizer:
    def init(params: Params) -> Dict:
        named = dict(params.named_parameters())
        return {
            "m": {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                  for n, p in named.items()},
            "v": {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                  for n, p in named.items()},
            "master": {n: p.detach().to(torch.float32, copy=True) for n, p in named.items()},
            "step": 0,
        }

    @torch.no_grad()
    def update(grads: Grads, state: Dict, params: Params) -> Dict:
        step = state["step"] + 1
        b1t, b2t = _one_minus_pow(b1, step), _one_minus_pow(b2, step)
        for name, p in params.named_parameters():
            g = grads[name].to(torch.float32)
            m, v, master = state["m"][name], state["v"][name], state["master"][name]
            m.mul_(b1).add_(g * (1 - b1))
            v.mul_(b2).add_((1 - b2) * g * g)
            u = (m / b1t).div_((v / b2t).sqrt_().add_(eps))
            master.sub_(u.add_(master * weight_decay).mul_(lr))
            p.copy_(master)
        return {"m": state["m"], "v": state["v"], "master": state["master"], "step": step}

    def state_specs(param_specs: Dict[str, P], params: Params) -> Dict:
        return {
            "m": param_specs,
            "v": param_specs,
            "master": param_specs,
            "step": P(),
        }

    return Optimizer(init, update, state_specs)


# ----------------------------------------------------------------------
# Adafactor (factored second moment, beta1=0, no master copy)
# ----------------------------------------------------------------------
def groups(params: Params) -> Dict[str, List[Tuple[str, torch.nn.Parameter]]]:
    """Parameters by the leaf of the JAX package's stacked tree they belong
    to: the per-block weights ``blocks.<i>.x`` of every i under
    ``blocks.x``, in block order; any other weight alone, under its name."""
    out: Dict[str, List] = {}
    for name, p in params.named_parameters():
        key = ".".join(part for part in name.split(".") if not part.isdigit())
        out.setdefault(key, []).append((name, p))
    return out


def _stacked(members) -> bool:
    return any(part.isdigit() for part in members[0][0].split("."))


def adafactor(lr: float = 1e-3, eps: float = 1e-30, clip: float = 1.0,
              decay: float = 0.8) -> Optimizer:
    def _factored(shape) -> bool:
        return len(shape) >= 2

    def init(params: Params) -> Dict:
        moments = {}
        for key, members in groups(params).items():
            p = members[0][1]
            shape = ((len(members),) if _stacked(members) else ()) + tuple(p.shape)
            zeros = lambda s: torch.zeros(s, dtype=torch.float32, device=p.device)
            moments[key] = ({"vr": zeros(shape[:-1]), "vc": zeros(shape[:-2] + shape[-1:])}
                            if _factored(shape) else {"v": zeros(shape)})
        return {"moments": moments, "step": 0}

    @torch.no_grad()
    def update(grads: Grads, state: Dict, params: Params) -> Dict:
        step = state["step"] + 1
        if isinstance(step, torch.Tensor):
            beta = 1 - torch.pow((step + 1).to(torch.float32), -decay)
        else:
            beta = 1.0 - float(np.float32(step + 1) ** np.float32(-decay))
        moments = {}
        for key, members in groups(params).items():
            stacked = _stacked(members)
            if stacked:
                g = torch.stack([grads[name].to(torch.float32) for name, _ in members])
            else:
                g = grads[members[0][0]].to(torch.float32)
            mom = state["moments"][key]
            g2 = g * g + eps
            if _factored(g.shape):
                vr = beta * mom["vr"] + (1 - beta) * g2.mean(dim=-1)
                vc = beta * mom["vc"] + (1 - beta) * g2.mean(dim=-2)
                denom = torch.clamp(vr.mean(dim=-1, keepdim=True), min=1e-30)
                vhat = lambda r, c, d: r[..., None] * c[..., None, :] / d[..., None]
                if stacked and g.ndim > 2:
                    # each block's update from its own rows of the moments:
                    # on DTensors the stacked product may come out sharded
                    # on the block dim, and picking one block of it would
                    # gather them all
                    us = [g[i] / torch.sqrt(vhat(vr[i], vc[i], denom[i]) + eps)
                          for i in range(len(members))]
                    u = torch.stack(us)
                else:
                    u = g / torch.sqrt(vhat(vr, vc, denom) + eps)
                    us = list(u) if stacked else [u]
                moments[key] = {"vr": vr, "vc": vc}
            else:
                v = beta * mom["v"] + (1 - beta) * g2
                u = g / torch.sqrt(v + eps)
                us = list(u) if stacked else [u]
                moments[key] = {"v": v}
            # update clipping by RMS, over the whole stacked leaf
            rms = torch.sqrt(torch.mean(u * u) + 1e-30)
            scale = torch.clamp(rms / clip, min=1.0)
            for (_, p), ui in zip(members, us):
                p.copy_(p.to(torch.float32) - lr * (ui / scale))
        return {"moments": moments, "step": step}

    def state_specs(param_specs: Dict[str, P], params: Params) -> Dict:
        def leaf_spec(spec, shape):
            if _factored(shape):
                return {
                    "vr": P(*spec[: len(shape) - 1]),
                    "vc": P(*(list(spec[: len(shape) - 2]) + [spec[len(shape) - 1]]))
                    if len(spec) >= len(shape)
                    else P(),
                }
            return {"v": P(*spec)}

        moments = {}
        for key, members in groups(params).items():
            stacked = _stacked(members)
            shape = ((len(members),) if stacked else ()) + tuple(members[0][1].shape)
            # a stacked group's spec: the weight's with the layer dim in front
            spec = ((None,) if stacked else ()) + tuple(param_specs[members[0][0]])
            moments[key] = leaf_spec(spec + (None,) * (len(shape) - len(spec)), shape)
        return {"moments": moments, "step": P()}

    return Optimizer(init, update, state_specs)


def get_optimizer(name: str) -> Optimizer:
    if name == "adamw":
        return adamw()
    if name == "adafactor":
        return adafactor()
    raise KeyError(name)
