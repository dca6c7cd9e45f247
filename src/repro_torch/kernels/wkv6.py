"""RWKV6 WKV recurrence (K5) with data-dependent per-channel decay.

    y_t = r_t · (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

``wkv6_cuda`` launches the hand-written kernel in ``csrc/wkv6.cu``, the
Hopper counterpart of the TPU kernel ``wkv6_pallas``; ``wkv6_plain`` is
the plain PyTorch version, the per-step recurrence of
``ref.wkv6_reference``.  ``kernels.ops.wkv6`` picks between them by the
tensor's device.  The state is carried in and out in float32, so two
calls chained through it equal one call over the whole sequence.

Both take the same contract:

* r/k/v/w are (B, H, T, D) with any strides (the kernel wants stride 1
  on D), so the model hands over a transpose of (B, T, H*D) uncopied;
* y is returned as the (B, H, T, D) view of a (B, T, H, D) tensor, which
  the model merges back into (B, T, H*D) without a copy;
* ``state_out``, where given, receives the final state and is returned
  as it; it may be ``state`` itself (the engine's buffer, updated in
  place).  Without it the function is pure: a new state tensor comes
  back and ``state`` is left as it was.

``wkv6_cuda`` checks each distinct call signature (shapes, dtypes,
strides, devices, which optional tensors are passed) once, in full, and
keeps the launch arguments it derives; a repeated signature (every layer
of every decode step) costs one dict lookup.  The float32 copy of a
non-float32 ``u`` is cached by its storage and version counter, so an
unchanged parameter is cast once and a changed one again.
"""
from __future__ import annotations

import ctypes
from collections import OrderedDict
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from . import build

#: input dtypes the kernel takes, with the C interface's dtype code
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: head sizes the kernel is instantiated for (one thread per state column)
HEAD_DIMS = (16, 32, 64, 128)


def _y_buffer(r: torch.Tensor) -> torch.Tensor:
    """A (B, T, H, D) tensor, returned as its (B, H, T, D) view."""
    B, H, T, D = r.shape
    return torch.empty_strided((B, H, T, D), (T * H * D, D, H * D, 1), dtype=r.dtype,
                               device=r.device)


def wkv6_plain(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    state: Optional[torch.Tensor] = None,
    *,
    state_out: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/w (B, H, T, D), u (H, D), state (B, H, D, D) or None.

    Returns (y (B, H, T, D) in r's dtype, final state (B, H, D, D) f32):
    the state is ``state_out``, written, where that is given."""
    B, H, T, D = r.shape
    rf, kf, vf, wf = (t.to(torch.float32) for t in (r, k, v, w))
    uf = u.to(torch.float32)[None, :, :, None]
    S = (
        torch.zeros((B, H, D, D), dtype=torch.float32, device=r.device)
        if state is None else state.to(torch.float32, copy=True)
    )
    y = _y_buffer(r)
    for t in range(T):
        kv = kf[:, :, t, :, None] * vf[:, :, t, None, :]
        y[:, :, t] = torch.einsum("bhi,bhij->bhj", rf[:, :, t], S + uf * kv)
        S = wf[:, :, t, :, None] * S + kv
    if state_out is not None:
        return y, state_out.copy_(S)
    return y, S


class _Plan(NamedTuple):
    """What a checked signature launches with."""
    dtype: int
    dims: ctypes.Array  # B, H, T, D, then the (batch, head, time) strides of r, k, v, w
    cast_state: bool  # state is not float32 contiguous: pass a converted copy
    empty: bool  # T == 0 or B * H == 0: no launch


_PLANS: Dict[tuple, _Plan] = {}
_U_F32: "OrderedDict[tuple, tuple]" = OrderedDict()
#: entries each cache keeps (a new prompt length is a new signature)
_CACHE_SIZE = 256


def _sig(t: Optional[torch.Tensor]):
    return None if t is None else (t.shape, t.dtype, t.stride(), t.device)


def _check_wkv6_args(r, k, v, w, u, state, state_out) -> _Plan:
    """Every check of what the kernel takes; raises on the first failure."""
    dev = r.device
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
    if state_out is not None:
        named.append(("state_out", state_out, (B, H, D, D)))
    for name, t, shape in named:
        if t.device != dev:
            raise ValueError(f"wkv6 kernel: {name} on {t.device}, r on {dev}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"wkv6 kernel: {name} has shape {tuple(t.shape)}, wants {tuple(shape)}")
    for name, t in (("k", k), ("v", v), ("w", w)):
        if t.dtype != r.dtype:
            raise TypeError(f"wkv6 kernel: {name} is {t.dtype}, r is {r.dtype}")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        if t.stride(3) != 1:
            raise ValueError(f"wkv6 kernel: {name} needs stride 1 on D, has strides {t.stride()}")
    if state_out is not None and (state_out.dtype != torch.float32
                                  or not state_out.is_contiguous()):
        raise ValueError("wkv6 kernel: state_out must be a contiguous float32 tensor")
    dims = [B, H, T, D]
    for t in (r, k, v, w):
        dims += t.stride()[:3]
    cast = state is not None and not (state.dtype == torch.float32 and state.is_contiguous())
    return _Plan(_DTYPE_CODES[r.dtype], (ctypes.c_longlong * 16)(*dims), cast, T == 0 or B * H == 0)


def wkv6_launch_plan(r, k, v, w, u, state=None, state_out=None) -> _Plan:
    """The checked launch arguments of this call's signature: looked up,
    or on a signature not seen before checked in full (raising on what
    the kernel does not take) and kept."""
    out_sig = "state" if state_out is state and state is not None else _sig(state_out)
    key = (_sig(r), _sig(k), _sig(v), _sig(w), _sig(u), _sig(state), out_sig)
    plan = _PLANS.get(key)
    if plan is None:
        plan = _check_wkv6_args(r, k, v, w, u, state, state_out)
        if len(_PLANS) >= _CACHE_SIZE:
            del _PLANS[next(iter(_PLANS))]  # the oldest
        _PLANS[key] = plan
    return plan


def _u_f32(u: torch.Tensor) -> torch.Tensor:
    """u as float32 and contiguous; a cast copy is cached by storage,
    layout and version counter (an in-place update bumps the version).
    The entry holds ``u`` itself, so its storage cannot be freed and
    reused by another tensor while the entry lives."""
    if u.dtype == torch.float32 and u.is_contiguous():
        return u
    key = (u.data_ptr(), u.dtype, u.shape, u.stride(), u.device)
    hit = _U_F32.get(key)
    if hit is not None and hit[1] == u._version:
        _U_F32.move_to_end(key)
        return hit[2]
    copy = u.to(torch.float32).contiguous()
    _U_F32[key] = (u, u._version, copy)
    if len(_U_F32) > _CACHE_SIZE:
        _U_F32.popitem(last=False)
    return copy


def _overlap(a: torch.Tensor, b: torch.Tensor) -> bool:
    a0, b0 = a.data_ptr(), b.data_ptr()
    return a0 < b0 + b.numel() * b.element_size() and b0 < a0 + a.numel() * a.element_size()


def wkv6_cuda(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    state: Optional[torch.Tensor] = None,
    *,
    state_out: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``wkv6_plain`` on the card, through the CUDA kernel."""
    dev = r.device
    if dev.type != "cuda":
        raise ValueError(f"wkv6 kernel needs CUDA tensors, got {dev}")
    plan = wkv6_launch_plan(r, k, v, w, u, state, state_out)
    s0 = state.to(torch.float32).contiguous() if plan.cast_state else state
    if state_out is None:
        B, H, _, D = r.shape
        sout = torch.empty((B, H, D, D), dtype=torch.float32, device=dev)
    else:
        sout = state_out
        if s0 is not None and s0.data_ptr() != sout.data_ptr() and _overlap(s0, sout):
            raise ValueError("wkv6 kernel: state_out overlaps state without being it")
    y = _y_buffer(r)
    if plan.empty:
        return y, (sout.zero_() if s0 is None else sout.copy_(s0))
    fn = build.kernel("wkv6")
    if dev.index == torch.cuda.current_device():
        err = _launch(fn, plan, r, k, v, w, u, s0, y, sout, dev)
    else:
        with torch.cuda.device(dev):
            err = _launch(fn, plan, r, k, v, w, u, s0, y, sout, dev)
    build.check("wkv6", err)
    return y, sout


def _launch(fn, plan, r, k, v, w, u, s0, y, sout, dev) -> int:
    err = fn(
        plan.dtype, r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        _u_f32(u).data_ptr(), None if s0 is None else s0.data_ptr(), y.data_ptr(),
        sout.data_ptr(), plan.dims, torch.cuda.current_stream(dev).cuda_stream,
    )
    build.LAUNCHES["wkv6"] += 1
    return err
