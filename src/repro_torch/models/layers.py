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


def _moe_dispatch(xt, top_e, C: int, Cb: int, E: int, K: int, dt, e0: int, n: int,
                  offset: Optional[torch.Tensor] = None, n_valid: Optional[int] = None):
    """The (n, Cb, D) rows of experts ``[e0, e0 + n)`` of the (E, Cb, D)
    expert buffer of tokens xt (N, D) routed to top_e (N, K): each token
    slot's rank within its expert (ties in token order), plus ``offset``
    (E,), the slots of each expert on the token ranks before this one;
    slots of rank C or more are dropped, and so are the slots of tokens
    from ``n_valid`` on (padding).  Returns the rows, each slot's
    destination row in the whole buffer (``E * Cb`` where dropped), the
    sort order and the kept mask."""
    N, D = xt.shape
    flat_e = top_e.reshape(-1)  # (N*K,)
    if n_valid is not None:  # padding's slots go to a sentinel expert E, sorted last
        pads = torch.arange(N * K, device=xt.device) >= n_valid * K
        flat_e = torch.where(pads, E, flat_e)
    order = torch.argsort(flat_e, stable=True)  # ties keep token order
    sorted_e = flat_e[order]
    # rank within expert = position - first index of that expert's run
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    rank = torch.arange(N * K, device=xt.device) - first
    if offset is not None:
        rank = rank + offset[sorted_e.clamp(max=E - 1)]
    keep = (rank < C) & (sorted_e < E)
    dest = torch.where(keep, sorted_e * Cb + rank, E * Cb)  # overflow -> trash row
    mine = keep & (sorted_e >= e0) & (sorted_e < e0 + n)
    buf = torch.zeros((n * Cb + 1, D), dtype=dt, device=xt.device)
    buf.index_copy_(0, torch.where(mine, dest - e0 * Cb, n * Cb), xt[order // K].to(dt))
    return buf[: n * Cb].reshape(n, Cb, D), dest, order, keep


def _moe_combine(y: torch.Tensor, dest, order, keep, top_p: torch.Tensor, K: int, dt, e0: int):
    """Each token's gated sum of its kept slots' outputs in experts ``[e0,
    e0 + n)``, y (n, Cb, D): with all E experts, the token's output; with a
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


def _slot_counts(top_e: torch.Tensor, E: int, n_valid: Optional[int] = None) -> torch.Tensor:
    """(1, E): the slots of the first ``n_valid`` tokens (all) routed to
    each expert (a static shape, so fake tensors take it too)."""
    flat_e = top_e[:n_valid].reshape(-1)
    counts = torch.zeros((E,), dtype=torch.int64, device=top_e.device)
    return counts.scatter_add_(0, flat_e, torch.ones_like(flat_e))[None]


def moe_ffn(p, cfg: ModelConfig, x: torch.Tensor, real_rows: Optional[int] = None) -> torch.Tensor:
    """x (B, S, D).  Sort-based top-k dispatch into an (E, C, D) buffer;
    token-slots past an expert's capacity C are dropped.  ``real_rows``,
    where the sharded step padded the batch (``lm._row_pad``): the rows of
    each token shard that are not padding; the padding's tokens take no
    slot and do not count in C.

    On DTensors (the sharded step) the dispatch and the combine have no
    sharding strategy in DTensor (``searchsorted``, the sort-order
    gathers, ``index_copy_``/``index_add_``): each runs through
    ``local_map`` on each rank's own tokens.  The reference takes one
    capacity C from all N tokens and ranks every slot in one stable sort
    over all of them; tokens are sharded in order, so a slot's rank within
    its expert is its rank among its own rank's slots plus the slots of
    that expert on the token ranks before it: each rank counts its slots
    per expert, one all-gather of those E counts gives every rank its
    offsets, and a slot is kept where its global rank is below C, where
    the reference keeps it.  Its row in the buffer is the reference's row,
    expert e's row e C + rank (C padded to a multiple of the token ranks,
    the padded rows empty).  Which rank a slot lands on follows from the
    data, so the buffer leaves the dispatch ``Partial`` over the token
    dims, each rank's rows filled disjointly (a sum of its rows and other
    ranks' zeros, exact), and is reduce-scattered to rows a rank owns
    (``Shard(1)``), each rank's share of every expert's rows: the expert
    products run on DTensors, on a rank's C / ranks rows as in the
    reference's partitioning.  The combine gathers the outputs' rows over
    the token dims and each rank reads its own slots' rows; its gradient
    for them is a partial sum over those dims.  Where a mesh dim of more
    than one rank shards the experts (expert parallelism over "model"), a
    rank fills and reads only its own experts' rows, and the combine
    leaves each token's output a partial sum over that dim."""
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
    if isinstance(xt, DTensor):
        mesh = xt.device_mesh
        tok = [isinstance(pl, Shard) and pl.dim == 0 and N % mesh.size(i) == 0
               for i, pl in enumerate(xt.placements)]
        tok_pl = tuple(Shard(0) if t else Replicate() for t in tok)
        rep = (Replicate(),) * mesh.ndim
        # this rank's place among the token ranks: dim 0 is split over the
        # token dims in mesh order, the first one outermost
        ranks, tok_index = 1, 0
        for i, t in enumerate(tok):
            if t:
                ranks *= mesh.size(i)
                tok_index = tok_index * mesh.size(i) + mesh.get_local_rank(i)
        n_valid = None if real_rows is None else real_rows * S
        if n_valid is not None:
            C = moe_capacity(cfg, ranks * n_valid)
        Cb = -(-C // ranks) * ranks
        w = p["w_gate"]
        ex = [i for i, pl in enumerate(getattr(w, "placements", ()))
              if not tok[i] and isinstance(pl, Shard) and pl.dim == 0 and mesh.size(i) > 1
              and E % mesh.size(i) == 0][:1]
        exp_pl = lambda on_tok: tuple(on_tok if t else Shard(0) if i in ex else Replicate()
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
        count = local_map(lambda e: _slot_counts(e, E, n_valid), out_placements=(tok_pl,),
                          in_placements=(tok_pl,), redistribute_inputs=True, device_mesh=mesh)
        counts = count(top_e).redistribute(mesh, rep)  # (ranks, E) on every rank: an all-gather
        fill = lambda a, b, cnt: _moe_dispatch(a, b, C, Cb, E, K, dt, e0, n,
                                               cnt[:tok_index].sum(0), n_valid)
        gather = lambda *a: _moe_combine(*a, K, dt, e0)
        dispatch = local_map(fill, out_placements=(exp_pl(Partial()), tok_pl, tok_pl, tok_pl),
                             in_placements=(tok_pl, tok_pl, rep),
                             in_grad_placements=(tok_grad, tok_pl, rep),
                             redistribute_inputs=True, device_mesh=mesh)
        combine = local_map(gather, out_placements=(out_pl,),
                            in_placements=(exp_pl(Replicate()), tok_pl, tok_pl, tok_pl, tok_pl),
                            in_grad_placements=(exp_pl(Partial()), tok_pl, tok_pl, tok_pl,
                                                tok_grad),
                            redistribute_inputs=True, device_mesh=mesh)
        buf, dest, order, keep = dispatch(xt, top_e, counts)
        buf = buf.redistribute(mesh, exp_pl(Shard(1)))  # rows a rank owns: a reduce-scatter
    else:
        buf, dest, order, keep = _moe_dispatch(xt, top_e, C, C, E, K, dt, 0, E)
        combine = lambda *a: _moe_combine(*a, K, dt, 0)

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
