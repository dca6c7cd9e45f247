"""Model facade: init / forward / prefill / decode for the dense and
RWKV6 families, a Python loop over layers where the JAX package scans
over stacked layer parameters.

Mirrors ``repro/models/lm.py``.  Weights live in a ``Params`` module:
one sub-module per block (``params["blocks"][i]``), every weight a
frozen parameter under the reference's name.  ``load_reference_params``
carries the JAX package's parameter pytree over, so both packages
compute the same logits from the same weights.

Families and features of the JAX package that are not ported yet
(``moe``, ``mamba_hybrid``, ``cross_attn_every``, ``embed_inputs=False``)
raise ``NotImplementedError``; ROADMAP.md queues them under M11.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..core.config import resolve_device
from . import layers, rwkv
from .config import ModelConfig
from .layers import cdtype


class Params(nn.Module):
    """A tree of weights as a module: each tensor of ``tree`` becomes a
    frozen parameter, each dict a sub-module and each list a
    ``ModuleList``.  Read by name, ``p["wq"]``, as the JAX package reads
    its pytrees."""

    def __init__(self, tree: Mapping):
        super().__init__()
        for name, val in tree.items():
            if isinstance(val, Mapping):
                self.add_module(name, Params(val))
            elif isinstance(val, (list, tuple)):
                self.add_module(name, nn.ModuleList(Params(v) for v in val))
            else:
                self.register_parameter(name, nn.Parameter(val, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a family or feature this slice of the port lacks."""
    missing = []
    if cfg.family not in ("dense", "rwkv6"):
        missing.append(f"family {cfg.family!r}")
    if cfg.moe is not None:
        missing.append("the MoE FFN")
    if cfg.cross_attn_every:
        missing.append("cross-attention layers")
    if not cfg.embed_inputs:
        missing.append("embed_inputs=False")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet (ROADMAP.md, M11)"
        )


# ----------------------------------------------------------------------
# init
# ----------------------------------------------------------------------
def init_params(
    cfg: ModelConfig,
    generator: Optional[torch.Generator] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> Params:
    """Random weights drawn from ``generator`` on ``device`` (the CUDA
    card unless the caller asks for the CPU).  The generator must live on
    that device; none means one seeded with 0.  Its numbers differ from
    ``jax.random``'s: carry the JAX package's weights over with
    ``load_reference_params`` to compare the two."""
    check_supported(cfg)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(dev).manual_seed(0)
    if torch.device(generator.device).type != dev.type:
        raise ValueError(f"generator on {generator.device}, weights wanted on {dev}")
    return Params(_init_tree(cfg, generator))


def _init_tree(cfg: ModelConfig, gen: torch.Generator) -> Dict:
    pd = layers.pdtype(cfg)
    D, V = cfg.d_model, cfg.vocab
    dev = gen.device
    p: Dict = {
        "final_norm": torch.ones((D,), dtype=pd, device=dev),
        "lm_head": layers.normal(gen, (D, V), 1.0 / np.sqrt(D), pd),
        "embed": layers.normal(gen, (V, D), 0.02, pd),
    }
    if cfg.family == "rwkv6":
        p["blocks"] = [rwkv.init_rwkv_block(gen, cfg) for _ in range(cfg.n_layers)]
        return p
    p["blocks"] = [
        {
            "norm1": torch.ones((D,), dtype=pd, device=dev),
            "attn": layers.init_attention(gen, cfg),
            "norm2": torch.ones((D,), dtype=pd, device=dev),
            "mlp": layers.init_mlp(gen, cfg),
        }
        for _ in range(cfg.n_layers)
    ]
    return p


def load_reference_params(
    cfg: ModelConfig, tree: Mapping, device: Optional[Union[str, torch.device]] = None
) -> Params:
    """The port's weights from the JAX package's parameter pytree, given
    as numpy arrays (``jax.tree.map(np.asarray, params)``).  The leading
    layer axis of ``tree["blocks"]`` is unstacked into one module per
    block; dtypes are kept."""
    check_supported(cfg)
    dev = resolve_device(device)

    def to_torch(val):
        if isinstance(val, Mapping):
            return {name: to_torch(v) for name, v in val.items()}
        arr = np.asarray(val)
        if arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: go through its bits
            return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16).to(dev)
        return torch.from_numpy(np.array(arr)).to(dev)

    out = {name: to_torch(val) for name, val in tree.items() if name != "blocks"}
    stacked = to_torch(tree["blocks"])
    out["blocks"] = [_take_layer(stacked, i) for i in range(cfg.n_layers)]
    return Params(out)


def _take_layer(tree: Mapping, i: int) -> Dict:
    return {
        name: _take_layer(val, i) if isinstance(val, Mapping) else val[i]
        for name, val in tree.items()
    }


# ----------------------------------------------------------------------
# forward (train / prefill)
# ----------------------------------------------------------------------
def _self_block(cfg: ModelConfig, x, bp, positions):
    h, _ = layers.attention(
        bp["attn"], cfg, layers.rms_norm(x, bp["norm1"], cfg.norm_eps), positions
    )
    x = x + h
    return x + layers.mlp(bp["mlp"], cfg, layers.rms_norm(x, bp["norm2"], cfg.norm_eps))


def forward(
    cfg: ModelConfig,
    params: Params,
    batch: Mapping[str, torch.Tensor],
    return_hidden: bool = False,
) -> torch.Tensor:
    """batch: {'tokens' (B,S)}.  Returns logits (B, S, V) in f32 (or the
    final hidden states)."""
    check_supported(cfg)
    dt = cdtype(cfg)
    x = params["embed"].to(dt)[batch["tokens"]]
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int64, device=x.device).expand(B, S)
    for bp in params["blocks"]:
        if cfg.family == "rwkv6":
            x, _ = rwkv.rwkv_block(bp, cfg, x)
        else:
            x = _self_block(cfg, x, bp, positions)
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if return_hidden:
        return x
    logits = torch.einsum("bsd,dv->bsv", x, params["lm_head"].to(dt))
    return logits.to(torch.float32)


def prefill(cfg: ModelConfig, params: Params, batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Prefill: run the stack over the prompt and emit logits for the
    LAST position only, (B, V) in f32."""
    h = forward(cfg, params, batch, return_hidden=True)
    logits = torch.einsum("bd,dv->bv", h[:, -1, :], params["lm_head"].to(cdtype(cfg)))
    return logits.to(torch.float32)


# ----------------------------------------------------------------------
# decode state and step
# ----------------------------------------------------------------------
def init_decode_state(
    cfg: ModelConfig,
    batch_size: int,
    max_len: int,
    device: Optional[Union[str, torch.device]] = None,
) -> Dict:
    """Zero caches (dense) or recurrent state (rwkv6), stacked over layers
    as in the JAX package; ``pos`` is a host int."""
    check_supported(cfg)
    dev = resolve_device(device)
    dt = cdtype(cfg)
    L, D = cfg.n_layers, cfg.d_model
    if cfg.family == "rwkv6":
        H = cfg.n_heads
        hd = D // H
        return {
            "S": torch.zeros((L, batch_size, H, hd, hd), dtype=torch.float32, device=dev),
            "tm_prev": torch.zeros((L, batch_size, 1, D), dtype=dt, device=dev),
            "cm_prev": torch.zeros((L, batch_size, 1, D), dtype=dt, device=dev),
            "pos": 0,
        }
    shape = (L, batch_size, max_len, cfg.n_kv_heads, cfg.hd)
    return {
        "k": torch.zeros(shape, dtype=dt, device=dev),
        "v": torch.zeros(shape, dtype=dt, device=dev),
        "pos": 0,
    }


def decode_step(
    cfg: ModelConfig,
    params: Params,
    state: Dict,
    batch: Mapping[str, torch.Tensor],
) -> Tuple[torch.Tensor, Dict]:
    """batch: {'tokens' (B,1)} [+ 'kv_start' (B,)].  Returns (logits
    (B, V) f32, new state).  The state's tensors are updated in place and
    shared with the new state, whose ``pos`` is one more."""
    check_supported(cfg)
    dt = cdtype(cfg)
    x = params["embed"].to(dt)[batch["tokens"]]
    pos = int(state["pos"])
    if cfg.family == "rwkv6":
        for i, bp in enumerate(params["blocks"]):
            S_i = state["S"][i]  # the WKV kernel writes the new state over it
            x, ns = rwkv.rwkv_block(
                bp, cfg, x,
                state={"S": S_i, "tm_prev": state["tm_prev"][i],
                       "cm_prev": state["cm_prev"][i]},
                S_out=S_i,
            )
            for name in ("tm_prev", "cm_prev"):
                state[name][i].copy_(ns[name])
    else:
        kv_start = batch.get("kv_start")
        for i, bp in enumerate(params["blocks"]):
            h, _, _ = layers.decode_attention(
                bp["attn"], cfg, layers.rms_norm(x, bp["norm1"], cfg.norm_eps),
                state["k"][i], state["v"][i], pos, kv_start=kv_start,
            )
            x = x + h
            x = x + layers.mlp(bp["mlp"], cfg, layers.rms_norm(x, bp["norm2"], cfg.norm_eps))
    new_state = dict(state)
    new_state["pos"] = pos + 1
    x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = torch.einsum("bsd,dv->bsv", x, params["lm_head"].to(dt))
    return logits[:, 0].to(torch.float32), new_state
