"""RWKV6 WKV recurrence (K5) with data-dependent per-channel decay.

    y_t = r_t · (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

``wkv6_cuda`` launches the hand-written kernel in ``csrc/wkv6.cu``, the
Hopper counterpart of the TPU kernel ``wkv6_pallas``; ``wkv6_plain`` is
the plain PyTorch version, the per-step recurrence of
``ref.wkv6_reference``.  ``kernels.ops.wkv6`` picks between them by the
tensor's device.  The state is carried in and out in float32, so two
calls chained through it equal one call over the whole sequence.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import build

#: input dtypes the kernel takes, with the C interface's dtype code
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: head sizes the kernel is instantiated for (one thread per state column)
HEAD_DIMS = (16, 32, 64, 128)


def wkv6_plain(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/w (B, H, T, D), u (H, D), state (B, H, D, D) or None.

    Returns (y (B, H, T, D) in r's dtype, final state (B, H, D, D) f32)."""
    B, H, T, D = r.shape
    rf, kf, vf, wf = (t.to(torch.float32) for t in (r, k, v, w))
    uf = u.to(torch.float32)[None, :, :, None]
    S = (
        torch.zeros((B, H, D, D), dtype=torch.float32, device=r.device)
        if state is None else state.to(torch.float32)
    )
    ys = []
    for t in range(T):
        kv = kf[:, :, t, :, None] * vf[:, :, t, None, :]
        ys.append(torch.einsum("bhi,bhij->bhj", rf[:, :, t], S + uf * kv))
        S = wf[:, :, t, :, None] * S + kv
    y = torch.stack(ys, dim=2) if ys else torch.zeros_like(rf)
    return y.to(r.dtype), S


def _check_wkv6_args(r, k, v, w, u, state) -> None:
    dev = r.device
    if dev.type != "cuda":
        raise ValueError(f"wkv6 kernel needs CUDA tensors, got {dev}")
    if r.dim() != 4:
        raise ValueError(f"wkv6 kernel takes r of shape (B, H, T, D), got {tuple(r.shape)}")
    B, H, T, D = r.shape
    if r.dtype not in _DTYPE_CODES:
        raise TypeError(f"wkv6 kernel takes float32 or bfloat16, got {r.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"wkv6 kernel takes head sizes {HEAD_DIMS}, got {D}")
    named = [("r", r, r.shape), ("k", k, r.shape), ("v", v, r.shape), ("w", w, r.shape),
             ("u", u, (H, D))]
    if state is not None:
        named.append(("state", state, (B, H, D, D)))
    for name, t, shape in named:
        if t.device != dev:
            raise ValueError(f"wkv6 kernel: {name} on {t.device}, r on {dev}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"wkv6 kernel: {name} has shape {tuple(t.shape)}, wants {tuple(shape)}")
    for name, t in (("k", k), ("v", v), ("w", w)):
        if t.dtype != r.dtype:
            raise TypeError(f"wkv6 kernel: {name} is {t.dtype}, r is {r.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"wkv6 kernel: {name} is not contiguous")
    if not r.is_contiguous():
        raise ValueError("wkv6 kernel: r is not contiguous")


def wkv6_cuda(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``wkv6_plain`` on the card, through the CUDA kernel."""
    _check_wkv6_args(r, k, v, w, u, state)
    B, H, T, D = r.shape
    uf = u.to(torch.float32).contiguous()
    s0 = None if state is None else state.to(torch.float32).contiguous()
    y = torch.empty_like(r)
    sout = torch.empty((B, H, D, D), dtype=torch.float32, device=r.device)
    if T == 0 or B * H == 0:
        return y, (sout.zero_() if s0 is None else sout.copy_(s0))
    fn = build.kernel("wkv6")
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = fn(
            _DTYPE_CODES[r.dtype], r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            uf.data_ptr(), None if s0 is None else s0.data_ptr(), y.data_ptr(),
            sout.data_ptr(), B, H, T, D, stream,
        )
        build.LAUNCHES["wkv6"] += 1
    build.check("wkv6", err)
    return y, sout
