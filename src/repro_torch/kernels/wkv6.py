"""RWKV6 WKV recurrence (K5) with data-dependent per-channel decay.

    y_t = r_t · (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

``wkv6_cuda`` launches a hand-written kernel, the Hopper counterpart of
the TPU kernel ``wkv6_pallas``, in one of two forms that ``wkv6_form``
picks by the number of steps T alone: below ``CHUNKED_MIN_T`` the serial
kernel of ``csrc/wkv6.cu`` (launch name ``wkv6``: a block a head walks
the steps in order; the decode step, T 1), from it on the chunked kernel
of ``csrc/wkv6_chunked.cu`` (``wkv6_chunked``: chunks of CHUNK steps at
once on the tensor cores, then a scan over the chunks, then every chunk's
outputs at once; the training and prefill shapes), which takes a float32
scratch of ``chunked_scratch_size`` elements from the wrapper.
``wkv6_plain`` is the plain PyTorch version, the per-step recurrence of
``ref.wkv6_reference``.  ``kernels.ops.wkv6`` picks between kernel and
plain version by the tensor's device.  The state is carried in and out
in float32, so two calls chained through it equal one call over the
whole sequence.

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

The backward (training) has no TPU counterpart: the JAX package
differentiates through its XLA form.  ``Wkv6Fn`` is the autograd Function
of the card: the forward kernel, then the hand-written backward kernel
``csrc/wkv6_bwd.cu`` (``wkv6_bwd_cuda``), which gives the gradients of r,
k, v, w, u and the initial state chunk-parallel: the states at the
boundaries of chunks of BWD_CHUNK steps first, then the gradients of
every group of BWD_GROUP chunks at once (``bwd_scratch_sizes``);
``wkv6_bwd_plain`` is the reverse recurrence in plain PyTorch.
``wkv6_cuda`` itself raises on inputs that want a gradient: its outputs
would have none (and ``u`` reaches the kernel as a detached float32 copy).

``wkv6_cost`` and ``wkv6_bwd_cost`` give the bytes and operations of a
call (the bounds of ``chip_smoke.py`` and the dry run's counts);
``wkv6_fake`` and ``FakeWkv6Fn`` are the fake route for fake or meta
tensors: the outputs' shapes and dtypes, nothing launched, the cost
recorded in ``build.FAKE_COSTS``.
"""
from __future__ import annotations

import ctypes
from collections import OrderedDict
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from . import build

#: input dtypes the kernel takes, with the C interface's dtype code
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: head sizes the kernels are instantiated for
HEAD_DIMS = (16, 32, 64, 128)
#: steps of a chunk of the chunked forward kernel (kChunk in its source)
CHUNK = 64
#: the fewest steps the chunked forward takes: a shorter call runs the
#: serial kernel, whose time grows with T from 3 microseconds at T 1.  On
#: an H100 at RWKV6-7B's heads (``launch/wkv6_forms.py``) the chunked
#: form is as fast or faster from T 128 on at B 1 and 4, slower below
CHUNKED_MIN_T = 128
#: launch names of the two forward forms
FORWARD_FORMS = ("wkv6", "wkv6_chunked")


def wkv6_form(T: int) -> str:
    """The forward kernel that takes a call of T steps: ``"wkv6"`` (serial)
    below ``CHUNKED_MIN_T``, else ``"wkv6_chunked"``."""
    return "wkv6_chunked" if T >= CHUNKED_MIN_T else "wkv6"


def chunked_scratch_size(B: int, H: int, T: int, D: int) -> int:
    """float32 elements of the chunked kernel's scratch: each chunk's state
    (its increment, then its starting state) and its total decay."""
    return B * H * -(-T // CHUNK) * (D * D + D)


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
    """``wkv6_plain`` on the card, through the CUDA kernel of the form
    ``wkv6_form`` picks by the call's steps."""
    return _wkv6_launch(wkv6_form(r.shape[2]), r, k, v, w, u, state, state_out=state_out)


def _wkv6_launch(
    name: str,
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    state: Optional[torch.Tensor] = None,
    *,
    state_out: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``wkv6_cuda`` through the forward kernel ``name`` (one of
    ``FORWARD_FORMS``) at any T: the card's checks and timings hold each
    form on the same inputs."""
    dev = r.device
    if dev.type != "cuda":
        raise ValueError(f"wkv6 kernel needs CUDA tensors, got {dev}")
    if name not in FORWARD_FORMS:
        raise ValueError(f"wkv6 kernel forms are {FORWARD_FORMS}, got {name!r}")
    if build.wants_grad(r, k, v, w, u, state):
        raise RuntimeError(
            "wkv6_cuda: CUDA inputs that require a gradient go through ops.wkv6 (Wkv6Fn); "
            "the bare kernel's outputs would have no gradient"
        )
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
    fn = build.kernel(name)
    if dev.index == torch.cuda.current_device():
        err = _launch(fn, name, plan, r, k, v, w, u, s0, y, sout, dev)
    else:
        with torch.cuda.device(dev):
            err = _launch(fn, name, plan, r, k, v, w, u, s0, y, sout, dev)
    build.check(name, err)
    return y, sout


def _launch(fn, name, plan, r, k, v, w, u, s0, y, sout, dev) -> int:
    args = [plan.dtype, r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            _u_f32(u).data_ptr(), None if s0 is None else s0.data_ptr(), y.data_ptr(),
            sout.data_ptr()]
    if name == "wkv6_chunked":
        # freed right after the launch: the allocator hands the memory to
        # later work on the same stream only, which runs after the kernels
        scratch = torch.empty((chunked_scratch_size(*r.shape),), dtype=torch.float32,
                              device=dev)
        args.append(scratch.data_ptr())
    err = fn(*args, plan.dims, torch.cuda.current_stream(dev).cuda_stream)
    build.LAUNCHES[name] += 1
    return err


# ----------------------------------------------------------------------
# backward
# ----------------------------------------------------------------------
#: steps of a chunk of the backward kernel (kChunk in the source), and
#: chunks of a group (kGroup), which one block walks from the last
BWD_CHUNK = 16
BWD_GROUP = 4


def bwd_scratch_sizes(B: int, H: int, T: int, D: int) -> Tuple[int, int, int]:
    """float32 elements of the backward kernel's scratch: the forward state
    before each chunk, the state's gradient after each group of chunks,
    and each chunk's share of du."""
    chunks = -(-T // BWD_CHUNK)
    groups = -(-chunks // BWD_GROUP)
    return B * H * chunks * D * D, B * H * groups * D * D, B * H * chunks * D


def wkv6_bwd_plain(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    state: Optional[torch.Tensor],
    dy: torch.Tensor,
    dstate: Optional[torch.Tensor] = None,
):
    """The gradients of ``wkv6_plain``'s (y, final state) by the reverse
    recurrence, in float32: with P_t the state before step t and G_t the
    gradient of the state after it (G_{T-1} = ``dstate``, or 0),

        dr_t = P_t dy_t + u k_t (v_t . dy_t)
        dk_t = r_t u (v_t . dy_t) + G_t v_t
        dv_t = (sum r_t u k_t) dy_t + G_t^T k_t
        dw_t = rowsum(G_t * P_t)
        du   = sum_t r_t k_t (v_t . dy_t)
        G_{t-1} = diag(w_t) G_t + r_t dy_t^T

    Returns (dr, dk, dv, dw in r's dtype, (B, H, T, D); du in u's dtype;
    the initial state's gradient G_{-1}, float32 (B, H, D, D))."""
    B, H, T, D = r.shape
    rf, kf, vf, wf, gf = (t.to(torch.float32) for t in (r, k, v, w, dy))
    uf = u.to(torch.float32)
    S = (torch.zeros((B, H, D, D), dtype=torch.float32, device=r.device)
         if state is None else state.to(torch.float32))
    before = []
    for t in range(T):
        before.append(S)
        S = wf[:, :, t, :, None] * S + kf[:, :, t, :, None] * vf[:, :, t, None, :]
    G = (torch.zeros((B, H, D, D), dtype=torch.float32, device=r.device)
         if dstate is None else dstate.to(torch.float32))
    dr, dk, dv, dw = (torch.empty((B, H, T, D), dtype=torch.float32, device=r.device)
                      for _ in range(4))
    du = torch.zeros((B, H, D), dtype=torch.float32, device=r.device)
    for t in reversed(range(T)):
        P, g = before[t], gf[:, :, t]
        rt, kt, vt = rf[:, :, t], kf[:, :, t], vf[:, :, t]
        vdy = (vt * g).sum(-1, keepdim=True)
        dr[:, :, t] = torch.einsum("bhij,bhj->bhi", P, g) + uf * kt * vdy
        dk[:, :, t] = rt * uf * vdy + torch.einsum("bhij,bhj->bhi", G, vt)
        dv[:, :, t] = (rt * uf * kt).sum(-1, keepdim=True) * g + torch.einsum(
            "bhij,bhi->bhj", G, kt)
        dw[:, :, t] = (G * P).sum(-1)
        du += rt * kt * vdy
        G = wf[:, :, t, :, None] * G + rt[..., None] * g[:, :, None, :]
    out = tuple(x.to(r.dtype) for x in (dr, dk, dv, dw))
    return (*out, du.sum(0).to(u.dtype), G)


def wkv6_bwd_cuda(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    state: Optional[torch.Tensor],
    dy: torch.Tensor,
    dstate: Optional[torch.Tensor] = None,
):
    """``wkv6_bwd_plain`` on the card, through the CUDA kernel
    (``csrc/wkv6_bwd.cu``).  r, k, v, w and dy take any strides with stride
    1 on D; dr, dk, dv and dw come back as (B, H, T, D) views of (B, T, H, D)
    tensors, as y does.  The kernel keeps the states at the chunk
    boundaries in scratch (``bwd_scratch_sizes``) alive during the call."""
    dev = r.device
    if dev.type != "cuda":
        raise ValueError(f"wkv6 backward kernel needs CUDA tensors, got {dev}")
    plan = _check_wkv6_args(r, k, v, w, u, state, None)
    B, H, T, D = r.shape
    if dy.shape != r.shape or dy.dtype != r.dtype or dy.device != dev:
        raise ValueError(f"wkv6 backward: dy {tuple(dy.shape)} {dy.dtype} does not match r "
                         f"{tuple(r.shape)} {r.dtype}")
    if dy.stride(3) != 1:
        dy = dy.contiguous()
    if dstate is not None:
        if dstate.shape != (B, H, D, D) or dstate.device != dev:
            raise ValueError(f"wkv6 backward: dstate has shape {tuple(dstate.shape)}")
        dstate = dstate.to(torch.float32).contiguous()
    s0 = state.to(torch.float32).contiguous() if plan.cast_state else state
    dr, dk, dv, dw = (_y_buffer(r) for _ in range(4))
    du = torch.empty((B, H, D), dtype=torch.float32, device=dev)
    ds0 = torch.empty((B, H, D, D), dtype=torch.float32, device=dev)
    if plan.empty:
        for t in (dr, dk, dv, dw, du):
            t.zero_()
        return dr, dk, dv, dw, du.sum(0).to(u.dtype), (
            ds0.zero_() if dstate is None else ds0.copy_(dstate))
    pstates, gstates, du_part = (torch.empty((n,), dtype=torch.float32, device=dev)
                                 for n in bwd_scratch_sizes(B, H, T, D))
    dims = list(plan.dims)[:16] + list(dy.stride()[:3])
    fn = build.kernel("wkv6_bwd")
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        err = fn(
            plan.dtype, r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), dy.data_ptr(),
            _u_f32(u).data_ptr(), ptr(s0), ptr(dstate), dr.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), dw.data_ptr(), du.data_ptr(), ds0.data_ptr(), pstates.data_ptr(),
            gstates.data_ptr(), du_part.data_ptr(), (ctypes.c_longlong * 19)(*dims),
            torch.cuda.current_stream(dev).cuda_stream,
        )
        build.LAUNCHES["wkv6_bwd"] += 1
    build.check("wkv6_bwd", err)
    return dr, dk, dv, dw, du.sum(0).to(u.dtype), ds0


class Wkv6Fn(torch.autograd.Function):
    """K5 with a gradient on the card: the forward kernel, then the
    backward kernel, which gives the gradients of r, k, v, w, u and the
    initial state.  Only the inputs are kept for the backward: it
    recomputes the states itself."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state):
        y, s_out = wkv6_cuda(r, k, v, w, u, state)
        ctx.save_for_backward(r, k, v, w, u, state)
        ctx.set_materialize_grads(False)
        return y, s_out

    @staticmethod
    def backward(ctx, dy, dstate):
        r, k, v, w, u, state = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(r)
        dr, dk, dv, dw, du, ds0 = wkv6_bwd_cuda(r, k, v, w, u, state, dy, dstate)
        return dr, dk, dv, dw, du, (None if state is None else ds0.to(state.dtype))


# ----------------------------------------------------------------------
# cost formulas and the fake route
# ----------------------------------------------------------------------
def wkv6_cost(B: int, H: int, T: int, D: int, itemsize: int,
              u_itemsize: int) -> Tuple[int, int]:
    """(bytes, operations) of one forward call: r, k, v, w read and y
    written, u read, the float32 state read and written; 7 D^2 operations
    a head and step (the k v^T outer product, the u term, r's product,
    the decay and the state update)."""
    nbytes = 5 * B * H * T * D * itemsize + H * D * u_itemsize + 2 * B * H * D * D * 4
    return nbytes, 7 * B * H * T * D * D


def wkv6_bwd_cost(B: int, H: int, T: int, D: int, itemsize: int) -> Tuple[int, int]:
    """(bytes, operations) of one backward call: the forward recurrence
    again, G's recurrence, and dr, dk, dv, dw (3 + 3 + 4 * 2 = 14 D^2 a
    head and step); r, k, v, w, dy read and dr, dk, dv, dw written, u read
    and du written in float32."""
    n = B * H * T
    return 9 * n * D * itemsize + 2 * H * D * 4, 14 * n * D * D


def wkv6_fake(r, k, v, w, u, state=None, *, state_out=None):
    """The fake route of the forward kernel: y as ``_y_buffer`` gives it
    and the final state (``state_out`` where given), unwritten; the cost
    goes to ``build.FAKE_COSTS`` under the name of the form T takes."""
    B, H, T, D = r.shape
    build.record_fake(wkv6_form(T), *wkv6_cost(B, H, T, D, r.element_size(), u.element_size()))
    sout = (torch.empty((B, H, D, D), dtype=torch.float32, device=r.device)
            if state_out is None else state_out)
    return _y_buffer(r), sout


class FakeWkv6Fn(torch.autograd.Function):
    """``Wkv6Fn`` on fake or meta tensors: the same saved inputs and output
    shapes, both kernels' costs recorded, nothing computed."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state):
        y, s_out = wkv6_fake(r, k, v, w, u, state)
        ctx.save_for_backward(r, k, v, w, u, state)
        ctx.set_materialize_grads(False)
        return y, s_out

    @staticmethod
    def backward(ctx, dy, dstate):
        r, k, v, w, u, state = ctx.saved_tensors
        B, H, T, D = r.shape
        build.record_fake("wkv6_bwd", *wkv6_bwd_cost(B, H, T, D, r.element_size()))
        grads = tuple(_y_buffer(r) for _ in range(4))
        du = torch.empty(u.shape, dtype=u.dtype, device=u.device)
        ds0 = None if state is None else torch.empty(state.shape, dtype=state.dtype,
                                                     device=state.device)
        return (*grads, du, ds0)
