"""Mamba2 (SSD) blocks for the Zamba2 hybrid.

Mirrors ``repro/models/mamba.py``: the chunked state-space-dual form,
within-chunk work as products over a segment-sum decay matrix, the
(H, P, N) state carried across chunks (and the O(1) decode state).  The
within-chunk terms of all chunks are computed at once; only the state
carry loops over chunks.  The JAX package has no TPU kernel for the
scan, so this is plain PyTorch on both devices.

Simplifications vs the full Mamba2 block, as in the JAX package: a
single B/C group, no depthwise conv1d prefix.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import cdtype, normal, pdtype, rms_norm


def init_mamba_block(gen: torch.Generator, cfg: ModelConfig) -> Dict:
    D = cfg.d_model
    H = cfg.ssm_heads or cfg.n_heads
    P = cfg.ssm_head_dim
    N = cfg.ssm_state
    d_inner = H * P
    pd = pdtype(cfg)
    dev = gen.device
    s = 1.0 / np.sqrt(D)
    return {
        "norm": torch.ones((D,), dtype=pd, device=dev),
        "in_proj": normal(gen, (D, 2 * d_inner + 2 * N + H), s, pd),
        "out_proj": normal(gen, (d_inner, D), 1.0 / np.sqrt(d_inner), pd),
        "A_log": torch.zeros((H,), dtype=torch.float32, device=dev),
        "D_skip": torch.ones((H,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((H,), dtype=torch.float32, device=dev),
        "gated_norm": torch.ones((d_inner,), dtype=pd, device=dev),
    }


def _segsum(loga: torch.Tensor) -> torch.Tensor:
    """loga (..., C) -> (..., C, C) lower-tri cumulative sums:
    out[t, s] = sum_{r=s+1..t} loga[r] (0 on diagonal, -inf above)."""
    C = loga.shape[-1]
    cs = torch.cumsum(loga, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]  # sum_{r=s+1..t}
    above = torch.ones((C, C), dtype=torch.bool, device=loga.device).triu(1)
    return diff.masked_fill(above, -torch.inf)


def ssd_chunked(
    xbar: torch.Tensor,  # (B, T, H, P)  (already dt-scaled inputs)
    loga: torch.Tensor,  # (B, T, H)     log decay per step
    Bm: torch.Tensor,  # (B, T, N)
    Cm: torch.Tensor,  # (B, T, N)
    state: Optional[torch.Tensor] = None,  # (B, H, P, N) f32
    chunk: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, T, H, P) f32, final state (B, H, P, N) f32).  The
    chunk is halved until it divides T, as in the JAX package (T 37 and
    T 1 take chunk 1), so the sums are the same."""
    B_, T, H, P = xbar.shape
    N = Bm.shape[-1]
    while T % chunk:
        chunk //= 2
    nc = T // chunk
    if state is None:
        state = torch.zeros((B_, H, P, N), dtype=torch.float32, device=xbar.device)

    f32 = torch.float32
    xc = xbar.to(f32).reshape(B_, nc, chunk, H, P)
    la = loga.to(f32).reshape(B_, nc, chunk, H).transpose(2, 3)  # (B, nc, H, C)
    bc = Bm.to(f32).reshape(B_, nc, chunk, N)
    cc = Cm.to(f32).reshape(B_, nc, chunk, N)

    # intra-chunk, every chunk at once: y_t += C_t . sum_s L[t,s] (xbar_s B_s),
    # as (C B^T) * L, then times xbar (einsum "btn,bhts,bsn,bshp->bthp")
    L = torch.exp(_segsum(la))  # (B, nc, H, C, C), decay s -> t
    cb = torch.einsum("bctn,bcsn->bcts", cc, bc)  # (B, nc, C, C)
    y_intra = torch.einsum("bchts,bcshp->bcthp", cb[:, :, None] * L, xc)
    # decay from chunk start to t (including step t), and from s+1 to the end
    dec0 = torch.exp(torch.cumsum(la, dim=-1))  # (B, nc, H, C)
    dec_end = torch.exp(torch.flip(torch.cumsum(torch.flip(la, (-1,)), dim=-1), (-1,)) - la)
    total = dec0[..., -1]  # (B, nc, H)
    # each chunk's own contribution to the state at its end
    # (einsum "bhs,bshp,bsn->bhpn")
    own = torch.einsum("bcshp,bcsn->bchpn", xc * dec_end.transpose(2, 3)[..., None], bc)

    # the state carry: h at the start of every chunk
    starts = []
    h = state.to(f32)
    for c in range(nc):
        starts.append(h)
        h = total[:, c, :, None, None] * h + own[:, c]
    h0 = torch.stack(starts, dim=1)  # (B, nc, H, P, N)
    # inter-chunk: C_t . h(chunk start), decayed to t (einsum "bcn,bhc,bhpn->bchp")
    y_inter = torch.einsum("bctn,bchpn->bcthp", cc, h0) * dec0.transpose(2, 3)[..., None]
    y = (y_intra + y_inter).reshape(B_, T, H, P)
    return y, h


def mamba_block(
    p,
    cfg: ModelConfig,
    x: torch.Tensor,
    state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,D) -> (y, new_state (B,H,P,N) f32)."""
    B, S, D = x.shape
    H, P, N = (cfg.ssm_heads or cfg.n_heads), cfg.ssm_head_dim, cfg.ssm_state
    d_inner = H * P
    dt = cdtype(cfg)
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    proj = torch.einsum("bsd,de->bse", xn.to(dt), p["in_proj"].to(dt))
    z, xin, Bm, Cm, dt_raw = torch.split(proj, [d_inner, d_inner, N, N, H], dim=-1)
    delta = F.softplus(dt_raw.to(torch.float32) + p["dt_bias"])  # (B,S,H)
    A = -torch.exp(p["A_log"])  # (H,) negative
    loga = delta * A  # (B,S,H)
    xh = xin.reshape(B, S, H, P).to(torch.float32)
    xbar = xh * delta[..., None]
    y, h_new = ssd_chunked(xbar, loga, Bm.to(torch.float32), Cm.to(torch.float32), state)
    y = y + p["D_skip"][None, None, :, None] * xh
    y = y.reshape(B, S, d_inner).to(dt)
    y = y * F.silu(z)
    y = rms_norm(y, p["gated_norm"], cfg.norm_eps)
    out = torch.einsum("bse,ed->bsd", y, p["out_proj"].to(dt))
    return x + out, h_new
