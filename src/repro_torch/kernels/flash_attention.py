"""Causal or full grouped-query attention (K4) with an online softmax.

``flash_attention_cuda`` is the Hopper counterpart of the TPU kernel
``flash_attention_pallas``, with one hand-written kernel per dtype, both
on the tensor cores (wgmma), K and V copied by TMA into a ring of
shared-memory stages:

* bfloat16 runs ``csrc/flash_attention_sm90.cu`` (``flash_attention_sm90``);
* float32 runs ``csrc/flash_attention_f32_sm90.cu``
  (``flash_attention_f32_sm90``) in split TF32: each operand x as
  hi = tf32(x) and lo = tf32(x - hi), each product a b as
  a_lo b_hi + a_hi b_lo + a_hi b_hi, which keeps about 22 bits of each
  operand and meets the float32 tolerance of 2e-5 (one TF32 product, 11
  bits, would not).  A split kernel (``csrc/split_tf32.cuh``, shared
  with the backward) writes the parts first, into one scratch buffer the
  wrapper allocates (its parts ``f32_scratch_shapes``), v's transposed
  with the keys of each group of 8 in ``KEY_ORDER``; ``f32_split_plain``
  is its plain version.

``flash_attention_plain`` is the plain PyTorch version (the softmax of
``ref.mha_reference``, computed in f32).  ``kernels.ops.flash_attention``
picks between the kernel and the plain version by the tensor's device.

q is (B, Hq, Sq, D) and k, v are (B, Hkv, Sk, D): query head h reads kv
head h // (Hq / Hkv).  The causal mask keeps key j for query i when
j <= i + (Sk - Sq).  Causal attention with Sq > Sk would leave rows with
no key at all, which the model never asks for; both versions raise on it.

The backward (training) has no TPU counterpart: the JAX package
differentiates through XLA attention.  ``FlashAttentionFn`` is the
autograd Function of the card: its forward launches the forward kernel
with a float32 log-sum-exp output (``flash_attention_fwd_cuda``), its
backward a hand-written one (``flash_attention_bwd_cuda``), split by
dtype as the forward is (``BWD_KERNELS``): bf16 in
``csrc/flash_attention_bwd_sm90.cu``, float32 in split TF32 in
``csrc/flash_attention_bwd_f32_sm90.cu``, both on the tensor cores;
``flash_attention_bwd_plain`` is the same arithmetic in plain PyTorch.
``flash_attention_cuda`` itself raises on inputs that want a gradient:
its output would have none.

``attention_cost`` and ``attention_bwd_cost`` give the bytes a call must
move and the operations it must do, the one definition the bounds in
``chip_smoke.py`` and the dry run's counts use.  ``flash_attention_fake``
(and ``FakeFlashAttentionFn`` with a gradient) is the fake route for
fake or meta tensors: outputs of the kernel's shapes and dtypes, nothing
launched, the call's cost recorded in ``build.FAKE_COSTS``.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Tuple

import torch

from . import build

#: head dims the kernel is instantiated for
HEAD_DIMS = tuple(range(16, 129, 16))
#: logit of a masked position, as in the TPU kernel
NEG_INF = -1e30
#: the forward kernel of each input dtype, both on the tensor cores
FWD_KERNELS = {torch.bfloat16: "flash_attention_sm90", torch.float32: "flash_attention_f32_sm90"}
#: the backward kernel of each input dtype, both on the tensor cores (f32
#: in split TF32)
BWD_KERNELS = {torch.bfloat16: "flash_attention_bwd_sm90",
               torch.float32: "flash_attention_bwd_f32_sm90"}
#: the backward's lse/Delta rows are Sq rounded up to this, by dtype
#: (kRowPad in each source: the bf16 kernel's query tiles are 64 and 192
#: rows, the f32 kernel's 16 and 64)
BWD_ROW_PAD = {torch.bfloat16: 192, torch.float32: 64}
#: the float32 kernels' split parts: the positions of each group of 8 keys
#: (or queries) in a transposed copy hold these, so that the accumulator
#: fragment (columns 2t, 2t + 1 of a quad's row) is wgmma's tf32 A
#: fragment (columns t, t + 4)
KEY_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"flash_attention takes q (B, Hq, Sq, D) and k, v (B, Hkv, Sk, D), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, Hq, Sq, D = q.shape
    Bk, Hkv, Sk, Dk = k.shape
    if Bk != B or Dk != D or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not fit k {tuple(k.shape)}")
    if Sk == 0 and Sq > 0:
        raise ValueError("flash_attention: no keys to attend to")
    if causal and Sq > Sk:
        raise ValueError(
            f"flash_attention: causal with Sq={Sq} > Sk={Sk} leaves queries with no key"
        )


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True
) -> torch.Tensor:
    """q (B, Hq, Sq, D); k, v (B, Hkv, Sk, D) -> (B, Hq, Sq, D) in q's dtype."""
    _check_shapes(q, k, v, causal)
    group = q.shape[1] // k.shape[1]
    Sq, Sk, D = q.shape[2], k.shape[2], q.shape[3]
    kk = k.to(torch.float32).repeat_interleave(group, dim=1)
    vv = v.to(torch.float32).repeat_interleave(group, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), kk) * float(1.0 / math.sqrt(D))
    if causal:
        qi = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
        ki = torch.arange(Sk, device=q.device)[None, :]
        logits = logits.masked_fill(ki > qi, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, vv).to(q.dtype)


def _check_kernel_args(q, k, v) -> None:
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(
            f"flash_attention kernel needs q, k, v on one CUDA device, got "
            f"{q.device}, {k.device}, {v.device}"
        )
    if q.dtype not in FWD_KERNELS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_attention kernel takes one dtype of float32/bfloat16, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head dims {HEAD_DIMS}, got {q.shape[3]}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention kernel: {name}'s last dim is not contiguous")


def _refuse_grad(fn: str, *tensors: torch.Tensor) -> None:
    """Raise where autograd would want a gradient of a kernel's output: the
    kernel writes it through a raw pointer, so it would have none."""
    if build.wants_grad(*tensors):
        raise RuntimeError(
            f"{fn}: CUDA inputs that require a gradient go through ops.flash_attention "
            "(FlashAttentionFn); the bare kernel's output would have no gradient"
        )


def _scratch(shapes: Tuple[Tuple[int, ...], ...], device) -> list:
    """One float32 buffer holding parts of these shapes one after the
    other (the kernel carves it up), in a list; none for no parts."""
    if not shapes:
        return []
    return [torch.empty(sum(math.prod(s) for s in shapes), dtype=torch.float32, device=device)]


def _launch(name: str, q, k, v, causal: bool, lse: bool = False,
            scratch: Tuple[Tuple[int, ...], ...] = ()):
    """Launch kernel ``name``, with one float32 buffer of the parts
    ``scratch`` passed after o and lse.  Returns o, and with ``lse`` also
    the float32 (B, Hq, Sq) log-sum-exp the kernel writes."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    o = torch.empty((B, Hq, Sq, D), dtype=q.dtype, device=q.device)
    m = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device) if lse else None
    if o.numel() == 0:
        return (o, m) if lse else o
    fn = build.kernel(name)
    bufs = _scratch(scratch, q.device)
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if m is None else m.data_ptr(), *(b.data_ptr() for b in bufs),
            B, Hq, Hkv, Sq, Sk, D, *strides, float(1.0 / math.sqrt(D)), int(causal), stream,
        )
        build.LAUNCHES[name] += 1
    build.check(name, err)
    return (o, m) if lse else o


def _tma_ready(t: torch.Tensor) -> torch.Tensor:
    """``t`` if the copy engine can describe it (base 16-byte aligned, the
    stride of every dim longer than 1 a multiple of 16 bytes), else a
    contiguous copy in a new allocation, which it can (``contiguous()``
    would keep a misaligned base that is already contiguous)."""
    ok = t.data_ptr() % 16 == 0 and all(
        s % 8 == 0 for n, s in zip(t.shape[:3], t.stride()[:3]) if n > 1
    )
    return t if ok else t.clone(memory_format=torch.contiguous_format)


# ----------------------------------------------------------------------
# the float32 kernels' split (split TF32)
# ----------------------------------------------------------------------
def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def f32_widths(D: int) -> Tuple[int, int]:
    """(DQ, DV): D rounded up to 32 (the columns of each split part of a
    row) and to 64 (the rows of a transposed copy, the N of its products)."""
    return _round_up(D, 32), _round_up(D, 64)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 as PTX ``cvt.rna.tf32.f32`` rounds it:
    10 mantissa bits, to nearest, ties away from zero (half an ulp added
    to the magnitude's bits, the low 13 bits then cleared)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) with hi = tf32(x) and lo = tf32(x - hi)."""
    hi = tf32_round(x)
    return hi, tf32_round(x.to(torch.float32) - hi)


def split_rows_plain(x: torch.Tensor) -> torch.Tensor:
    """(B, H, S, D) -> the split kernel's rows (B H, S, 2 DQ): hi in the
    first DQ columns, lo in the next, zeros past D."""
    B, H, S, D = x.shape
    DQ, _ = f32_widths(D)
    out = torch.zeros((B * H, S, 2, DQ), dtype=torch.float32, device=x.device)
    hi, lo = split_tf32(x.reshape(B * H, S, D))
    out[:, :, 0, :D], out[:, :, 1, :D] = hi, lo
    return out.reshape(B * H, S, 2 * DQ)


def split_cols_plain(x: torch.Tensor) -> torch.Tensor:
    """(B, H, S, D) -> the split kernel's transposed copy (B H, 2, DV, Sp),
    hi then lo, zeros past D and S (Sp = S rounded up to 32), position
    8 g + p holding row 8 g + KEY_ORDER[p]."""
    B, H, S, D = x.shape
    _, DV = f32_widths(D)
    Sp = _round_up(S, 32)
    xt = torch.zeros((B * H, DV, Sp), dtype=torch.float32, device=x.device)
    xt[:, :D, :S] = x.reshape(B * H, S, D).to(torch.float32).transpose(1, 2)
    order = (torch.arange(Sp) // 8 * 8 + torch.tensor(KEY_ORDER).repeat(Sp // 8)).to(x.device)
    return torch.stack(split_tf32(xt[:, :, order]), dim=1)


def f32_scratch_shapes(B: int, Hq: int, Hkv: int, Sq: int, Sk: int, D: int,
                       backward: bool = False):
    """Shapes of the parts of a float32 kernel's split scratch, in the
    order they lie in the one buffer the wrapper allocates and the kernel
    fills.  The forward's: q's and k's rows (B H, S, 2 DQ), v's transposed
    copy (B Hkv, 2, DV, Sk rounded up to 32).  The backward's: the rows of
    q, dO, k and v, then the transposed copies (B H, 2, DV, S rounded up to
    32) of q, dO and k."""
    DQ, DV = f32_widths(D)
    rows_q, rows_k = (B * Hq, Sq, 2 * DQ), (B * Hkv, Sk, 2 * DQ)
    cols_q = (B * Hq, 2, DV, _round_up(Sq, 32))
    cols_k = (B * Hkv, 2, DV, _round_up(Sk, 32))
    if not backward:
        return rows_q, rows_k, cols_k
    return rows_q, rows_q, rows_k, rows_k, cols_q, cols_q, cols_k


def f32_split_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    do: torch.Tensor = None):
    """What a float32 kernel's split kernel writes, in plain PyTorch (the
    parts of ``f32_scratch_shapes``): the forward's, or with ``do`` the
    backward's."""
    if do is None:
        return split_rows_plain(q), split_rows_plain(k), split_cols_plain(v)
    return (split_rows_plain(q), split_rows_plain(do), split_rows_plain(k), split_rows_plain(v),
            split_cols_plain(q), split_cols_plain(do), split_cols_plain(k))


def flash_attention_sm90(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True
) -> torch.Tensor:
    """The tensor-core kernel (``csrc/flash_attention_sm90.cu``), bf16 only.
    Takes any batch, head and sequence strides; the output is contiguous."""
    _refuse_grad("flash_attention_sm90", q, k, v)
    _check_shapes(q, k, v, causal)
    _check_kernel_args(q, k, v)
    if q.dtype != torch.bfloat16:
        raise TypeError(f"flash_attention_sm90 takes bfloat16, got {q.dtype}")
    q, k, v = (_tma_ready(t) for t in (q, k, v))
    return _launch("flash_attention_sm90", q, k, v, causal)


def _forward(q, k, v, causal: bool, lse: bool):
    """The forward kernel of q's dtype (``FWD_KERNELS``; any other dtype
    raises); with ``lse`` also the log-sum-exp."""
    _check_shapes(q, k, v, causal)
    _check_kernel_args(q, k, v)
    name = FWD_KERNELS[q.dtype]
    if q.dtype == torch.bfloat16:
        q, k, v = (_tma_ready(t) for t in (q, k, v))
        return _launch(name, q, k, v, causal, lse)
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    return _launch(name, q, k, v, causal, lse, f32_scratch_shapes(B, Hq, Hkv, Sq, Sk, D))


def flash_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True
) -> torch.Tensor:
    """``flash_attention_plain`` on the card, through the kernel of q's
    dtype (``FWD_KERNELS``: bf16 and, in split TF32, float32, both on the
    tensor cores); any other dtype raises."""
    _refuse_grad("flash_attention_cuda", q, k, v)
    return _forward(q, k, v, causal, lse=False)


# ----------------------------------------------------------------------
# backward
# ----------------------------------------------------------------------
def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """float32 scaled logits (B, Hq, Sq, Sk), masked positions at NEG_INF."""
    group = q.shape[1] // k.shape[1]
    Sq, Sk, D = q.shape[2], k.shape[2], q.shape[3]
    kk = k.to(torch.float32).repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), kk) * float(1.0 / math.sqrt(D))
    if causal:
        qi = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
        ki = torch.arange(Sk, device=q.device)[None, :]
        s = s.masked_fill(ki > qi, NEG_INF)
    return s


def attention_lse_plain(q: torch.Tensor, k: torch.Tensor, causal: bool = True) -> torch.Tensor:
    """The float32 (B, Hq, Sq) log-sum-exp of each row's scaled logits, as
    the forward kernels write it for the backward."""
    _check_shapes(q, k, k, causal)
    return torch.logsumexp(_scores(q, k, causal), dim=-1)


def flash_attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
    do: torch.Tensor, causal: bool = True,
):
    """dq, dk, dv (in q's dtype) from the forward's inputs, its output o,
    its log-sum-exp and the gradient ``do`` of o, by the backward kernel's
    formulas in float32: P = exp(S - lse), dV = P^T dO, dP = dO V^T,
    dS = P (dP - rowsum(dO o)), dQ = dS K / sqrt(D), dK = dS^T Q / sqrt(D);
    dk and dv summed over the query heads of each kv head."""
    _check_shapes(q, k, v, causal)
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale = float(1.0 / math.sqrt(D))
    f32 = lambda t: t.to(torch.float32)
    p = torch.exp(_scores(q, k, causal) - f32(lse)[..., None])  # 0 where masked
    g = f32(do)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, g)
    dp = torch.einsum("bhqd,bhkd->bhqk", g, f32(v).repeat_interleave(group, dim=1))
    delta = (g * f32(o)).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, f32(k).repeat_interleave(group, dim=1)) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, f32(q)) * scale
    fold = lambda t: t.reshape(B, Hkv, group, Sk, D).sum(2)  # the heads of a group
    return dq.to(q.dtype), fold(dk).to(k.dtype), fold(dv).to(v.dtype)


def flash_attention_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             causal: bool = True):
    """``flash_attention_cuda`` with the forward kernel's log-sum-exp too:
    (o, lse), for ``FlashAttentionFn``."""
    return _forward(q, k, v, causal, lse=True)


def bwd_ld_elements(B: int, Hq: int, Sq: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """float32 elements of the backward's lse/Delta buffer: (B Hq, 2, Sq
    rounded up to the kernel's BWD_ROW_PAD)."""
    return B * Hq * 2 * _round_up(Sq, BWD_ROW_PAD[dtype])


class BwdPlan(NamedTuple):
    """What the backward launches: the kernel, the float32 lse/Delta buffer
    it fills, the shapes of the parts of its float32 split scratch (none
    for bf16), and
    q, k, v, do as the kernel reads them."""
    name: str
    rows: Tuple[int, ...]
    scratch: Tuple[Tuple[int, ...], ...]
    q: torch.Tensor
    k: torch.Tensor
    v: torch.Tensor
    do: torch.Tensor


def bwd_launch_plan(q, k, v, do) -> BwdPlan:
    """The backward kernel of q's dtype (``BWD_KERNELS``) and its
    arguments; bf16 layouts the copy engine cannot describe are copied
    (the float32 kernel's copy engine reads only its own scratch)."""
    name = BWD_KERNELS[q.dtype]
    B, Hq, Sq, D = q.shape
    rows = (bwd_ld_elements(B, Hq, Sq, q.dtype),)
    if q.dtype == torch.bfloat16:
        q, k, v, do = (_tma_ready(t) for t in (q, k, v, do))
        return BwdPlan(name, rows, (), q, k, v, do)
    Hkv, Sk = k.shape[1], k.shape[2]
    return BwdPlan(name, rows, f32_scratch_shapes(B, Hq, Hkv, Sq, Sk, D, backward=True),
                   q, k, v, do)


def flash_attention_bwd_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
    do: torch.Tensor, causal: bool = True,
):
    """``flash_attention_bwd_plain`` on the card, through the backward
    kernel of q's dtype (``BWD_KERNELS``): dq (B, Hq, Sq, D) and dk, dv
    (B, Hkv, Sk, D), contiguous, in q's dtype.  q, k, v, o and do take any
    batch, head and sequence strides with a contiguous last dim (bf16
    layouts the copy engine cannot describe are copied first)."""
    _check_shapes(q, k, v, causal)
    _check_kernel_args(q, k, v)
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash_attention_bwd: {name} {tuple(t.shape)} {t.dtype} does not "
                             f"match q {tuple(q.shape)} {q.dtype}")
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention_bwd: {name}'s last dim is not contiguous")
    if (lse.shape != (B, Hq, Sq) or lse.dtype != torch.float32 or not lse.is_contiguous()
            or lse.device != q.device):
        raise ValueError("flash_attention_bwd: lse must be a contiguous float32 (B, Hq, Sq) "
                         "tensor on q's device")
    dq = torch.empty((B, Hq, Sq, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Hkv, Sk, D), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if dq.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    name, rows, scratch, q, k, v, do = bwd_launch_plan(q, k, v, do)
    rows = torch.empty(rows, dtype=torch.float32, device=q.device)
    bufs = _scratch(scratch, q.device)
    dims = [B, Hq, Hkv, Sq, Sk, D] + [s for t in (q, k, v, o, do) for s in t.stride()[:3]]
    fn = build.kernel(name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), rows.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *(b.data_ptr() for b in bufs),
            (ctypes.c_longlong * 21)(*dims), float(1.0 / math.sqrt(D)), int(causal), stream,
        )
        build.LAUNCHES[name] += 1
    build.check(name, err)
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """K4 with a gradient on the card: the forward kernel (which also writes
    the log-sum-exp), then the backward kernel.  q, k, v and o are kept for
    the backward; P is recomputed from the log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        o, lse = flash_attention_fwd_cuda(q, k, v, causal)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.stride(3) != 1:
            do = do.contiguous()
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, o, lse, do, ctx.causal)
        return dq, dk, dv, None


# ----------------------------------------------------------------------
# cost formulas and the fake route
# ----------------------------------------------------------------------
def attention_pairs(Sq: int, Sk: int, causal: bool) -> int:
    """(query, key) pairs the mask keeps: the work K4 must do.  Causal
    keeps key j for query i when j <= i + (Sk - Sq), so Sk - Sq + 1 + i
    keys for query i (Sq <= Sk)."""
    if not causal:
        return Sq * Sk
    return Sq * (Sk - Sq + 1) + Sq * (Sq - 1) // 2


def attention_cost(B: int, Hq: int, Hkv: int, Sq: int, Sk: int, D: int, causal: bool,
                   itemsize: int) -> Tuple[int, int]:
    """(bytes, operations) of one forward call: q, k, v read once and o
    written; a multiply and an add for each of the 2 D products of a kept
    (query, key) pair and query head (QK^T and PV)."""
    nbytes = itemsize * (2 * B * Hq * Sq * D + 2 * B * Hkv * Sk * D)
    return nbytes, 4 * D * attention_pairs(Sq, Sk, causal) * Hq * B


def attention_bwd_cost(B: int, Hq: int, Hkv: int, Sq: int, Sk: int, D: int, causal: bool,
                       itemsize: int) -> Tuple[int, int]:
    """(bytes, operations) of one backward call: q, o, dO read and dq
    written, k, v read and dk, dv written, the float32 lse read; five
    products of 2 D a kept pair and query head (S again, dP, dV, dQ, dK)."""
    nbytes = itemsize * (4 * B * Hq * Sq * D + 4 * B * Hkv * Sk * D) + 4 * B * Hq * Sq
    return nbytes, 5 * 2 * D * attention_pairs(Sq, Sk, causal) * Hq * B


def _fake_record(table, q, k, causal: bool, cost) -> str:
    if q.dtype not in table:
        raise TypeError(f"flash_attention kernel takes float32/bfloat16, got {q.dtype}")
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    name = table[q.dtype]
    build.record_fake(name, *cost(B, Hq, Hkv, Sq, Sk, D, causal, q.element_size()))
    return name


def flash_attention_fake(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, lse: bool = False):
    """The fake route of the forward kernel: ``_launch``'s outputs, o (B,
    Hq, Sq, D) in q's dtype (and with ``lse`` the float32 (B, Hq, Sq)
    log-sum-exp), unwritten; the call's cost goes to ``build.FAKE_COSTS``."""
    _check_shapes(q, k, v, causal)
    _fake_record(FWD_KERNELS, q, k, causal, attention_cost)
    B, Hq, Sq, D = q.shape
    o = torch.empty((B, Hq, Sq, D), dtype=q.dtype, device=q.device)
    if not lse:
        return o
    return o, torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)


class FakeFlashAttentionFn(torch.autograd.Function):
    """``FlashAttentionFn`` on fake or meta tensors: the same saved tensors
    and output shapes, both kernels' costs recorded, nothing computed."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        o, lse = flash_attention_fake(q, k, v, causal, lse=True)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, _, _ = ctx.saved_tensors
        _fake_record(BWD_KERNELS, q, k, ctx.causal, attention_bwd_cost)
        dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        return dq, torch.empty(k.shape, dtype=k.dtype, device=k.device), \
            torch.empty(v.shape, dtype=v.dtype, device=v.device), None
