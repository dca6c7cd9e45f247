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
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..kernels import ops
from ..kernels.sharded import grad_to_own
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


def unflatten(t: torch.Tensor, dim: int, sizes: Tuple[int, ...]) -> torch.Tensor:
    """``t`` with dim ``dim`` split into ``sizes``.  A DTensor sharded on
    that dim over a mesh dim that does not divide ``sizes[0]`` (40 query
    heads on 16 ranks, 8 kv groups of 64 sharded heads) cannot be split
    so (DTensor refuses the view): that mesh dim is replicated first, an
    explicit redistribute."""
    dim = dim % t.ndim
    if isinstance(t, DTensor):
        pl = list(t.placements)
        for i, p in enumerate(pl):
            if isinstance(p, Shard) and p.dim == dim and sizes[0] % t.device_mesh.size(i):
                pl[i] = Replicate()
        if pl != list(t.placements):
            t = t.redistribute(t.device_mesh, pl)
    return t.reshape(*t.shape[:dim], *sizes, *t.shape[dim + 1:])


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    """(..., heads, hd) -> (..., heads * hd).  On a DTensor the merged
    tensor passes through a redistribute to its own placements, whose
    backward brings the gradient to them: the gradient that reaches the
    merge may be sharded on the merged dim over a mesh dim that does not
    divide the heads, which the view's backward could not split."""
    out = t.reshape(*t.shape[:-2], t.shape[-2] * t.shape[-1])
    if isinstance(out, DTensor):
        out = out.redistribute(out.device_mesh, out.placements)
    return out


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
    q = unflatten(q, -1, (cfg.n_heads, hd))
    k = unflatten(k, -1, (cfg.n_kv_heads, hd))
    v = unflatten(v, -1, (cfg.n_kv_heads, hd))
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
    qg = unflatten(q, 2, (Hkv, group))
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
    y = torch.einsum("bsh,hd->bsd", merge_heads(out.transpose(1, 2)).to(dt), p["wo"].to(dt))
    if "gate" in p:
        y = torch.tanh(p["gate"].to(dt)) * y
    return y, (k, v)


def _write_slot(cache: torch.Tensor, pos: torch.Tensor, new: torch.Tensor) -> None:
    """``cache[:, clamp(pos)] = new`` for a position held in a 0-d tensor,
    read by no host.  A DTensor cache (sharded on its sequence dim in the
    sharded decode step, which DTensor's ``index_copy_`` does not take)
    is written shard by shard through ``local_map``: each rank writes the
    slot where it falls inside its own span of the sequence."""
    Smax = cache.shape[1]
    slot = pos.to(torch.int64).clamp(0, Smax - 1).reshape(1)
    if not isinstance(cache, DTensor):
        cache.index_copy_(1, slot, new[:, None].to(cache.dtype))
        return
    mesh = cache.device_mesh
    offset = 0  # first sequence position of this rank's span
    for i, pl in enumerate(cache.placements):
        if isinstance(pl, Shard) and pl.dim == 1:
            offset += mesh.get_local_rank(i) * -(-Smax // mesh.size(i))
    batch = tuple(Shard(0) if isinstance(pl, Shard) and pl.dim == 0 else Replicate()
                  for pl in cache.placements)

    def local(c, s, n):
        idx = (s - offset).clamp(0, max(c.shape[1] - 1, 0))
        inside = ((s - offset) >= 0) & ((s - offset) < c.shape[1])
        c.index_copy_(1, idx, torch.where(inside, n[:, None].to(c.dtype), c.index_select(1, idx)))

    local_map(local, out_placements=None,
              in_placements=(cache.placements, (Replicate(),) * mesh.ndim, batch),
              redistribute_inputs=True, device_mesh=mesh)(cache, slot, new)


def decode_attention(
    p,
    cfg: ModelConfig,
    x: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    pos: Union[int, torch.Tensor],
    *,
    rope: bool = True,
    update_cache: bool = True,
    kv_len: Optional[int] = None,
    kv_start: Optional[torch.Tensor] = None,
    gated: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode against a (B, Smax, Hkv, hd) KV cache.

    ``pos`` is a host int or a 0-d integer tensor (the sharded dry run's
    decode step, whose position no host reads).  With ``update_cache``
    writes the new token's k and v into the caches in place, at ``pos``
    clamped to ``Smax - 1`` as
    ``jax.lax.dynamic_update_slice`` clamps it in the JAX package.
    Attends keys below ``kv_len`` (``pos + 1`` unless given).  With
    ``gated`` (a cross layer, which has ``p["gate"]``) the output is
    scaled by ``tanh(gate)``; the caller says so once, where the JAX
    package looks for the key in every layer.  Returns (out, cache_k,
    cache_v)."""
    B = x.shape[0]
    if isinstance(pos, torch.Tensor):
        positions = pos.to(torch.int64).reshape(1, 1).expand(B, 1)
    else:
        positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    q, k, v = _qkv(p, cfg, x, x)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if update_cache and isinstance(pos, torch.Tensor):
        _write_slot(cache_k, pos, k[:, 0])
        _write_slot(cache_v, pos, v[:, 0])
    elif update_cache:
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


def _moe_dispatch(xt, top_e, C: int, E: int, K: int, dt, e0: int, n: int):
    """The (n, C, D) rows of experts ``[e0, e0 + n)`` of the (E, C, D)
    expert buffer of tokens xt (N, D) routed to top_e (N, K), with each
    token slot's destination row in the whole buffer (``E * C`` where
    dropped), the sort order and the kept mask."""
    N, D = xt.shape
    flat_e = top_e.reshape(-1)  # (N*K,)
    order = torch.argsort(flat_e, stable=True)  # ties keep token order
    sorted_e = flat_e[order]
    # rank within expert = position - first index of that expert's run
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    rank = torch.arange(N * K, device=xt.device) - first
    keep = rank < C
    dest = torch.where(keep, sorted_e * C + rank, E * C)  # overflow -> trash row
    mine = keep & (sorted_e >= e0) & (sorted_e < e0 + n)
    buf = torch.zeros((n * C + 1, D), dtype=dt, device=xt.device)
    buf.index_copy_(0, torch.where(mine, dest - e0 * C, n * C), xt[order // K].to(dt))
    return buf[: n * C].reshape(n, C, D), dest, order, keep


def _moe_combine(y: torch.Tensor, dest, order, keep, top_p: torch.Tensor, K: int, dt, e0: int):
    """Each token's gated sum of its kept slots' outputs in experts ``[e0,
    e0 + n)``, y (n, C, D): with all E experts, the token's output; with a
    slice of them, its partial sum over the ranks that hold the others."""
    n, C, D = y.shape
    N = top_p.shape[0]
    mine = keep & (dest >= e0 * C) & (dest < (e0 + n) * C)
    y_flat = torch.cat([y.reshape(n * C, D), torch.zeros((1, D), dtype=dt, device=y.device)])
    # dropped slots and other ranks' experts read the zero row
    per_slot = y_flat[torch.where(mine, dest - e0 * C, n * C)]  # (N*K, D)
    gates = top_p.reshape(-1)[order].to(dt)
    contrib = per_slot * torch.where(mine, gates, 0.0)[:, None]
    return torch.zeros((N, D), dtype=dt, device=y.device).index_add_(0, order // K, contrib)


def moe_ffn(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """x (B, S, D).  Sort-based top-k dispatch into an (E, C, D) buffer;
    token-slots past an expert's capacity C are dropped.

    On DTensors (the sharded step) the dispatch and the combine have no
    sharding strategy in DTensor (``searchsorted``, the sort-order
    gathers, ``index_copy_``/``index_add_``): each runs through
    ``local_map`` on each rank's own tokens, which fill that rank's
    capacity slots (C from its token count, the buffer sharded on C where
    the tokens are sharded).  Where a mesh dim of more than one rank
    shards the experts (expert parallelism over "model"), a rank fills
    and reads only its own experts' rows, and the combine leaves each
    token's output a partial sum over that dim; the expert products run
    on DTensors."""
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
    if isinstance(xt, DTensor):
        mesh = xt.device_mesh
        tok = [isinstance(pl, Shard) and pl.dim == 0 and N % mesh.size(i) == 0
               for i, pl in enumerate(xt.placements)]
        ranks = math.prod(mesh.size(i) for i, t in enumerate(tok) if t)
        C = moe_capacity(cfg, N // ranks)
        tok_pl = tuple(Shard(0) if t else Replicate() for t in tok)
        w = p["w_gate"]
        ex = [i for i, pl in enumerate(getattr(w, "placements", ()))
              if not tok[i] and isinstance(pl, Shard) and pl.dim == 0 and mesh.size(i) > 1
              and E % mesh.size(i) == 0][:1]
        buf_pl = tuple(Shard(1) if t else Shard(0) if i in ex else Replicate()
                       for i, t in enumerate(tok))
        out_pl = tuple(Shard(0) if t else Partial() if i in ex else Replicate()
                       for i, t in enumerate(tok))
        # a rank's tokens reach only its experts' rows: the gradient of
        # the tokens and of their gates is a partial sum over the experts' dim
        tok_grad = tuple(Partial() if i in ex else pl for i, pl in enumerate(tok_pl))
        if ex:
            xt, top_p = grad_to_own(xt), grad_to_own(top_p)
        n = E // mesh.size(ex[0]) if ex else E
        e0 = mesh.get_local_rank(ex[0]) * n if ex else 0
        fill = lambda a, b: _moe_dispatch(a, b, C, E, K, dt, e0, n)
        gather = lambda *a: _moe_combine(*a, K, dt, e0)
        dispatch = local_map(fill, out_placements=(buf_pl, tok_pl, tok_pl, tok_pl),
                             in_placements=(tok_pl, tok_pl), in_grad_placements=(tok_grad, tok_pl),
                             redistribute_inputs=True, device_mesh=mesh)
        combine = local_map(gather, out_placements=(out_pl,),
                            in_placements=(buf_pl, tok_pl, tok_pl, tok_pl, tok_pl),
                            in_grad_placements=(buf_pl, tok_pl, tok_pl, tok_pl, tok_grad),
                            redistribute_inputs=True, device_mesh=mesh)
    else:
        C = moe_capacity(cfg, N)
        dispatch = lambda a, b: _moe_dispatch(a, b, C, E, K, dt, 0, E)
        combine = lambda *a: _moe_combine(*a, K, dt, 0)
    buf, dest, order, keep = dispatch(xt, top_e)

    g = torch.bmm(buf, p["w_gate"].to(dt))  # einsum("ecd,edf->ecf")
    u = torch.bmm(buf, p["w_up"].to(dt))
    y = torch.bmm(F.silu(g) * u, p["w_down"].to(dt))  # einsum("ecf,efd->ecd")

    out = combine(y, dest, order, keep, top_p)
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
