"""RWKV6 (Finch) blocks: time-mix with data-dependent per-channel decay
and channel-mix, with O(1)-state decode.

Mirrors ``repro/models/rwkv.py``.  The WKV recurrence goes through the
K5 kernel (``kernels.ops.wkv6``) for any sequence length, the state
carried in and out; the JAX package's chunked matmul form
(``wkv6_chunked``, its TPU adaptation of the same function) is not
ported.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import ops
from .config import ModelConfig
from .layers import cdtype, normal, pdtype, rms_norm

LORA_R = 64


def init_rwkv_block(gen: torch.Generator, cfg: ModelConfig) -> Dict:
    D = cfg.d_model
    H = cfg.n_heads
    hd = D // H
    Fd = cfg.d_ff
    pd = pdtype(cfg)
    dev = gen.device
    s = 1.0 / np.sqrt(D)
    full = lambda value: torch.full((D,), value, dtype=pd, device=dev)
    return {
        # time-mix
        "tm_norm": full(1.0),
        "mix_r": full(0.5),
        "mix_k": full(0.5),
        "mix_v": full(0.5),
        "mix_w": full(0.5),
        "wr": normal(gen, (D, D), s, pd),
        "wk": normal(gen, (D, D), s, pd),
        "wv": normal(gen, (D, D), s, pd),
        "wg": normal(gen, (D, D), s, pd),
        "wo": normal(gen, (D, D), s, pd),
        # data-dependent decay LoRA: w_t = exp(-exp(w0 + tanh(x A) B))
        "w0": full(-2.0),
        "wA": normal(gen, (D, LORA_R), s, pd),
        "wB": normal(gen, (LORA_R, D), 0.1, pd),
        "u": normal(gen, (H, hd), 0.1, pd),
        # channel-mix
        "cm_norm": full(1.0),
        "cmix_k": full(0.5),
        "cmix_r": full(0.5),
        "ck": normal(gen, (D, Fd), s, pd),
        "cv": normal(gen, (Fd, D), 1.0 / np.sqrt(Fd), pd),
        "cr": normal(gen, (D, D), s, pd),
    }


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]) -> torch.Tensor:
    """x (B,S,D): shift right by one; ``prev`` is the last token of the
    previous segment (decode/state carry), zeros at start."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev, x[:, :-1]], dim=1)


def rwkv_block(
    p,
    cfg: ModelConfig,
    x: torch.Tensor,
    state: Optional[Dict] = None,
    S_out: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict]:
    """Full RWKV6 block (time-mix + channel-mix).  state carries
    {'S': (B,H,hd,hd) f32, 'tm_prev': (B,1,D), 'cm_prev': (B,1,D)} for
    segment-chained prefill and O(1) decode.  ``S_out``, where given,
    receives the new WKV state (it may be ``state['S']``, updated in
    place) and is the returned state's 'S'."""
    B, S, D = x.shape
    H = cfg.n_heads
    hd = D // H
    dt = cdtype(cfg)
    st = state or {}

    # ---- time mix ----
    xn = rms_norm(x, p["tm_norm"], cfg.norm_eps)
    xs = _token_shift(xn, st.get("tm_prev"))

    def mixed(name):
        m = p["mix_" + name].to(dt)
        return (xn * m + xs * (1 - m)).to(dt)

    r = torch.einsum("bsd,de->bse", mixed("r"), p["wr"].to(dt))
    k = torch.einsum("bsd,de->bse", mixed("k"), p["wk"].to(dt))
    v = torch.einsum("bsd,de->bse", mixed("v"), p["wv"].to(dt))
    g = torch.einsum("bsd,de->bse", mixed("r"), p["wg"].to(dt))
    # data-dependent decay
    wl = torch.einsum(
        "bsr,rd->bsd",
        torch.tanh(torch.einsum("bsd,dr->bsr", mixed("w"), p["wA"].to(dt))),
        p["wB"].to(dt),
    )
    w = torch.exp(-torch.exp(p["w0"].to(torch.float32) + wl.to(torch.float32)))

    def heads(t):  # (B,S,D) -> (B,H,S,hd), a view: the kernel takes strides
        return t.reshape(B, S, H, hd).transpose(1, 2)

    y, S_new = ops.wkv6(
        heads(r), heads(k), heads(v), heads(w.to(dt)), p["u"], state=st.get("S"),
        state_out=S_out,
    )
    y = y.transpose(1, 2).reshape(B, S, D)  # a view of the kernel's (B, S, H, hd)
    y = y * F.silu(g)
    y = torch.einsum("bsd,de->bse", y.to(dt), p["wo"].to(dt))
    x = x + y

    # ---- channel mix ----
    xn2 = rms_norm(x, p["cm_norm"], cfg.norm_eps)
    xs2 = _token_shift(xn2, st.get("cm_prev"))
    mk = p["cmix_k"].to(dt)
    mr = p["cmix_r"].to(dt)
    kk = torch.einsum("bsd,df->bsf", (xn2 * mk + xs2 * (1 - mk)).to(dt), p["ck"].to(dt))
    kk = torch.square(torch.relu(kk))
    vv = torch.einsum("bsf,fd->bsd", kk, p["cv"].to(dt))
    rr = torch.sigmoid(
        torch.einsum("bsd,de->bse", (xn2 * mr + xs2 * (1 - mr)).to(dt), p["cr"].to(dt))
    )
    x = x + rr * vv

    new_state = {
        "S": S_new,
        "tm_prev": xn[:, -1:, :],
        "cm_prev": xn2[:, -1:, :],
    }
    return x, new_state
