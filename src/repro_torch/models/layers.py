"""Shared layers of the port's LM stack: RMSNorm, RoPE, GQA self- and
cross-attention (prefill through the K4 kernel, cached decode in plain
torch), the SwiGLU MLP and the sort-based MoE FFN.

Mirrors ``repro/models/layers.py``: the same einsums over explicitly
shaped weights, read by name (``p["wq"]``) from a ``Params`` module or a
dict, and the same casts in the same order, so the two packages agree
on the same weights.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import ops
from .config import ModelConfig


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def pdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * scale.to(dt)


#: ``normal`` draws a weight in slices of its first dim of about
#: SLICE_ELEMS elements, so that no float32 temporary above 3.2 GB is
#: made (one kimi-k2 expert weight in one draw would need 22.5 GB)
SLICE_ELEMS = 1 << 27


def normal(gen: torch.Generator, shape, scale: float, dtype: torch.dtype) -> torch.Tensor:
    """Random weights ``N(0, 1) * scale`` drawn on the generator's device."""
    shape = tuple(shape)
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    rows = max(1, SLICE_ELEMS // math.prod(shape[1:]))
    for i in range(0, shape[0], rows):
        part = out[i:i + rows]
        part.copy_(torch.randn(part.shape, generator=gen, device=gen.device) * float(scale))
    return out


# ----------------------------------------------------------------------
# RoPE (split-half, not interleaved)
# ----------------------------------------------------------------------
def rope_frequencies(hd: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, hd, 2, dtype=np.float32) / hd))


@functools.lru_cache(maxsize=32)
def _rope_frequencies_on(hd: int, theta: float, device: torch.device) -> torch.Tensor:
    # copied to the device once: a copy from host memory on every call
    # would wait for the card in every layer of every decode step
    return torch.from_numpy(rope_frequencies(hd, theta)).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (..., S, H, hd); positions (..., S) int."""
    hd = x.shape[-1]
    freqs = _rope_frequencies_on(hd, theta, x.device)  # (hd/2,)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------
# attention
# ----------------------------------------------------------------------
def init_attention(gen: torch.Generator, cfg: ModelConfig, cross: bool = False) -> Dict:
    D, hd = cfg.d_model, cfg.hd
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
    pd = pdtype(cfg)
    s = 1.0 / np.sqrt(D)
    p = {
        "wq": normal(gen, (D, Hq * hd), s, pd),
        "wk": normal(gen, (D, Hkv * hd), s, pd),
        "wv": normal(gen, (D, Hkv * hd), s, pd),
        "wo": normal(gen, (Hq * hd, D), s, pd),
    }
    dev = gen.device
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((Hq * hd,), dtype=pd, device=dev)
        p["bk"] = torch.zeros((Hkv * hd,), dtype=pd, device=dev)
        p["bv"] = torch.zeros((Hkv * hd,), dtype=pd, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=pd, device=dev)
        p["k_norm"] = torch.ones((hd,), dtype=pd, device=dev)
    if cross:
        # tanh-gated cross-attention (llama-vision), closed at the start
        p["gate"] = torch.zeros((), dtype=pd, device=dev)
    return p


def _qkv(p, cfg: ModelConfig, x: torch.Tensor, kv_x: torch.Tensor):
    """x (B,S,D) -> q (B,S,Hq,hd), k/v (B,Skv,Hkv,hd)."""
    hd = cfg.hd
    dt = cdtype(cfg)
    xd = x.to(dt)
    kvd = xd if kv_x is x else kv_x.to(dt)
    q = torch.einsum("bsd,dh->bsh", xd, p["wq"].to(dt))
    k = torch.einsum("bsd,dh->bsh", kvd, p["wk"].to(dt))
    v = torch.einsum("bsd,dh->bsh", kvd, p["wv"].to(dt))
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    q = q.reshape(*q.shape[:2], cfg.n_heads, hd)
    k = k.reshape(*k.shape[:2], cfg.n_kv_heads, hd)
    v = v.reshape(*v.shape[:2], cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _sdpa(q, k, v, *, causal: bool, q_offset: int, kv_len=None, kv_start=None):
    """q (B,Sq,Hq,hd); k,v (B,Sk,Hkv,hd).  Grouped-query attention with
    f32 softmax.  kv_len masks out positions >= kv_len (decode caches);
    kv_start (B,) masks out positions before each slot's window start."""
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, group, hd)
    logits = torch.einsum(
        "bqkgh,bskh->bkgqs", qg.to(torch.float32), k.to(torch.float32)
    )
    logits = logits / float(np.sqrt(hd))
    ki = torch.arange(Sk, device=q.device)[None, :]
    if causal:
        qi = (q_offset + torch.arange(Sq, device=q.device))[:, None]
        logits = logits.masked_fill(ki > qi, -1e30)
    if kv_len is not None:
        logits = logits.masked_fill(ki >= kv_len, -1e30)
    if kv_start is not None:
        # per-slot window start (continuous batching: refilled slots must
        # not attend the previous occupant's cache prefix)
        start = kv_start.to(torch.int64).reshape(-1, 1, 1, 1, 1)  # (B,1,1,1,1)
        keys = torch.arange(Sk, device=q.device)[None, None, None, None, :]
        logits = logits.masked_fill(keys < start, -1e30)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", w, v.to(torch.float32))
    return out.reshape(B, Sq, Hq, hd).to(q.dtype)


def attention(
    p,
    cfg: ModelConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    causal: bool = True,
    kv_x: Optional[torch.Tensor] = None,
    rope: bool = True,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Training / prefill attention.  Returns (out, (k, v)) for caching.
    With ``kv_x`` (B, Skv, D) it is cross-attention: keys and values from
    ``kv_x``, no RoPE, no causal mask.  The whole sequence goes through
    the K4 kernel in one call, where the JAX package chunks queries by
    ``cfg.q_chunk``; the result is the same."""
    kv_src = x if kv_x is None else kv_x
    q, k, v = _qkv(p, cfg, x, kv_src)
    if rope and kv_x is None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    B, S = x.shape[:2]
    out = ops.flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal and kv_x is None,
    )  # (B, Hq, S, hd)
    dt = cdtype(cfg)
    y = torch.einsum(
        "bsh,hd->bsd", out.transpose(1, 2).reshape(B, S, -1).to(dt), p["wo"].to(dt)
    )
    if "gate" in p:
        y = torch.tanh(p["gate"].to(dt)) * y
    return y, (k, v)


def decode_attention(
    p,
    cfg: ModelConfig,
    x: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    pos: int,
    *,
    rope: bool = True,
    update_cache: bool = True,
    kv_len: Optional[int] = None,
    kv_start: Optional[torch.Tensor] = None,
    gated: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode against a (B, Smax, Hkv, hd) KV cache.

    With ``update_cache`` writes the new token's k and v into the caches
    in place, at ``pos`` clamped to ``Smax - 1`` as
    ``jax.lax.dynamic_update_slice`` clamps it in the JAX package.
    Attends keys below ``kv_len`` (``pos + 1`` unless given).  With
    ``gated`` (a cross layer, which has ``p["gate"]``) the output is
    scaled by ``tanh(gate)``; the caller says so once, where the JAX
    package looks for the key in every layer.  Returns (out, cache_k,
    cache_v)."""
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    q, k, v = _qkv(p, cfg, x, x)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if update_cache:
        slot = min(max(pos, 0), cache_k.shape[1] - 1)
        cache_k[:, slot] = k[:, 0].to(cache_k.dtype)
        cache_v[:, slot] = v[:, 0].to(cache_v.dtype)
    out = _sdpa(q, cache_k, cache_v, causal=False, q_offset=0,
                kv_len=(pos + 1) if kv_len is None else kv_len, kv_start=kv_start)
    dt = cdtype(cfg)
    y = torch.einsum("bsh,hd->bsd", out.reshape(B, 1, -1).to(dt), p["wo"].to(dt))
    if gated:
        y = torch.tanh(p["gate"].to(dt)) * y
    return y, cache_k, cache_v


# ----------------------------------------------------------------------
# MLP (SwiGLU)
# ----------------------------------------------------------------------
def init_mlp(gen: torch.Generator, cfg: ModelConfig, d_ff: Optional[int] = None) -> Dict:
    D = cfg.d_model
    Fd = d_ff or cfg.d_ff
    pd = pdtype(cfg)
    s = 1.0 / np.sqrt(D)
    return {
        "w_gate": normal(gen, (D, Fd), s, pd),
        "w_up": normal(gen, (D, Fd), s, pd),
        "w_down": normal(gen, (Fd, D), 1.0 / np.sqrt(Fd), pd),
    }


def mlp(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    dt = cdtype(cfg)
    xd = x.to(dt)
    g = torch.einsum("bsd,df->bsf", xd, p["w_gate"].to(dt))
    u = torch.einsum("bsd,df->bsf", xd, p["w_up"].to(dt))
    return torch.einsum("bsf,fd->bsd", F.silu(g) * u, p["w_down"].to(dt))


# ----------------------------------------------------------------------
# MoE: sort-based capacity dispatch (no one-hot einsum waste)
# ----------------------------------------------------------------------
def init_moe(gen: torch.Generator, cfg: ModelConfig) -> Dict:
    D, Fd = cfg.d_model, cfg.d_ff
    E = cfg.moe.n_experts
    pd = pdtype(cfg)
    s = 1.0 / np.sqrt(D)
    p = {
        "router": normal(gen, (D, E), s, torch.float32),  # float32 whatever pd is
        "w_gate": normal(gen, (E, D, Fd), s, pd),
        "w_up": normal(gen, (E, D, Fd), s, pd),
        "w_down": normal(gen, (E, Fd, D), 1.0 / np.sqrt(Fd), pd),
    }
    if cfg.moe.n_shared:
        p["shared"] = init_mlp(gen, cfg, d_ff=cfg.moe.n_shared * cfg.d_ff)
    return p


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest of the last dim and their indices, the lower index
    first on ties as ``jax.lax.top_k`` puts it (``torch.topk`` does not)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Token slots per expert for ``n_tokens`` tokens, from shapes alone."""
    mc = cfg.moe
    C = int(np.ceil(n_tokens * mc.top_k * mc.capacity_factor / mc.n_experts))
    return max(1, min(C, n_tokens))


def moe_ffn(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """x (B, S, D).  Sort-based top-k dispatch into an (E, C, D) buffer;
    token-slots past an expert's capacity C are dropped."""
    mc = cfg.moe
    B, S, D = x.shape
    N = B * S
    dt = cdtype(cfg)
    xt = x.reshape(N, D)
    logits = (xt.to(torch.float32) @ p["router"]).to(torch.float32)  # (N, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = top_k(probs, mc.top_k)  # (N, K)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)  # renormalize

    K = mc.top_k
    E = mc.n_experts
    C = moe_capacity(cfg, N)
    flat_e = top_e.reshape(-1)  # (N*K,)
    order = torch.argsort(flat_e, stable=True)  # ties keep token order
    sorted_e = flat_e[order]
    # rank within expert = position - first index of that expert's run
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    rank = torch.arange(N * K, device=x.device) - first
    keep = rank < C
    dest = torch.where(keep, sorted_e * C + rank, E * C)  # overflow -> trash row
    src_token = order // K
    buf = torch.zeros((E * C + 1, D), dtype=dt, device=x.device)
    buf.index_copy_(0, dest, xt[src_token].to(dt))
    buf = buf[: E * C].reshape(E, C, D)

    g = torch.bmm(buf, p["w_gate"].to(dt))  # einsum("ecd,edf->ecf")
    u = torch.bmm(buf, p["w_up"].to(dt))
    y = torch.bmm(F.silu(g) * u, p["w_down"].to(dt))  # einsum("ecf,efd->ecd")

    y_flat = torch.cat([y.reshape(E * C, D), torch.zeros((1, D), dtype=dt, device=x.device)])
    per_slot = y_flat[dest]  # (N*K, D); dropped slots read the zero row
    gates = top_p.reshape(-1)[order].to(dt)
    contrib = per_slot * torch.where(keep, gates, 0.0)[:, None]
    out = torch.zeros((N, D), dtype=dt, device=x.device).index_add_(0, src_token, contrib)
    if mc.n_shared:
        out = out + mlp(p["shared"], cfg, x).reshape(N, D)
    return out.reshape(B, S, D)


def moe_aux_loss(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Load-balancing auxiliary loss (switch-style)."""
    mc = cfg.moe
    xt = x.reshape(-1, x.shape[-1])
    probs = torch.softmax(xt.to(torch.float32) @ p["router"], dim=-1)
    top_e = torch.argmax(probs, dim=-1)
    frac = F.one_hot(top_e, mc.n_experts).to(torch.float32).mean(dim=0)
    imp = probs.mean(dim=0)
    return mc.n_experts * torch.sum(frac * imp)
