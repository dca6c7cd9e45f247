"""Causal or full grouped-query attention (K4) with an online softmax.

``flash_attention_cuda`` is the Hopper counterpart of the TPU kernel
``flash_attention_pallas``, with one hand-written kernel per dtype:

* bfloat16 runs ``csrc/flash_attention_sm90.cu`` (``flash_attention_sm90``):
  the products on the tensor cores (wgmma), K and V copied by TMA into a
  ring of shared-memory stages;
* float32 runs ``csrc/flash_attention.cu`` (``flash_attention_cuda_cores``):
  everything in f32 on the CUDA cores, the only kernel that meets the
  f32 tolerance of 2e-5 (the tensor cores' TF32 would not).

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
backward the hand-written ``csrc/flash_attention_bwd.cu``
(``flash_attention_bwd_cuda``); ``flash_attention_bwd_plain`` is the
same arithmetic in plain PyTorch.  ``flash_attention_cuda`` itself
raises on inputs that want a gradient: its output would have none.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build

#: input dtypes the kernel takes, with the C interface's dtype code
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: head dims the kernel is instantiated for
HEAD_DIMS = tuple(range(16, 129, 16))
#: logit of a masked position, as in the TPU kernel
NEG_INF = -1e30


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
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
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


def _launch(name: str, lead: list, q, k, v, causal: bool, lse: bool = False):
    """Launch kernel ``name``; ``lead`` are the C arguments before the
    pointers (the CUDA-core kernel's dtype code).  Returns o, and with
    ``lse`` also the float32 (B, Hq, Sq) log-sum-exp the kernel writes."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    o = torch.empty((B, Hq, Sq, D), dtype=q.dtype, device=q.device)
    m = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device) if lse else None
    if o.numel() == 0:
        return (o, m) if lse else o
    fn = build.kernel(name)
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            *lead, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if m is None else m.data_ptr(),
            B, Hq, Hkv, Sq, Sk, D, *strides, float(1.0 / math.sqrt(D)), int(causal), stream,
        )
        build.LAUNCHES[name] += 1
    build.check(name, err)
    return (o, m) if lse else o


def flash_attention_cuda_cores(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True
) -> torch.Tensor:
    """The CUDA-core kernel (``csrc/flash_attention.cu``), f32 or bf16.
    Takes any batch, head and sequence strides; the output is contiguous."""
    _refuse_grad("flash_attention_cuda_cores", q, k, v)
    _check_shapes(q, k, v, causal)
    _check_kernel_args(q, k, v)
    return _launch("flash_attention", [_DTYPE_CODES[q.dtype]], q, k, v, causal)


def _tma_ready(t: torch.Tensor) -> torch.Tensor:
    """``t`` if the copy engine can describe it (base 16-byte aligned, the
    stride of every dim longer than 1 a multiple of 16 bytes), else a
    contiguous copy in a new allocation, which it can (``contiguous()``
    would keep a misaligned base that is already contiguous)."""
    ok = t.data_ptr() % 16 == 0 and all(
        s % 8 == 0 for n, s in zip(t.shape[:3], t.stride()[:3]) if n > 1
    )
    return t if ok else t.clone(memory_format=torch.contiguous_format)


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
    return _launch("flash_attention_sm90", [], q, k, v, causal)


def _forward(q, k, v, causal: bool, lse: bool):
    """bf16 through the tensor-core kernel, f32 through the CUDA-core one
    (any other dtype raises); with ``lse`` also the log-sum-exp."""
    _check_shapes(q, k, v, causal)
    _check_kernel_args(q, k, v)
    if q.dtype == torch.bfloat16:
        q, k, v = (_tma_ready(t) for t in (q, k, v))
        return _launch("flash_attention_sm90", [], q, k, v, causal, lse)
    return _launch("flash_attention", [_DTYPE_CODES[q.dtype]], q, k, v, causal, lse)


def flash_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True
) -> torch.Tensor:
    """``flash_attention_plain`` on the card: bf16 through the tensor-core
    kernel, f32 through the CUDA-core kernel, any other dtype raises."""
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


def flash_attention_bwd_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, lse: torch.Tensor,
    do: torch.Tensor, causal: bool = True,
):
    """``flash_attention_bwd_plain`` on the card, through the CUDA kernel
    (``csrc/flash_attention_bwd.cu``): dq (B, Hq, Sq, D) and dk, dv
    (B, Hkv, Sk, D), contiguous, in q's dtype.  q, k, v, o and do take any
    batch, head and sequence strides with a contiguous last dim."""
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
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    dims = [B, Hq, Hkv, Sq, Sk, D] + [s for t in (q, k, v, o, do) for s in t.stride()[:3]]
    fn = build.kernel("flash_attention_bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), (ctypes.c_longlong * 21)(*dims), float(1.0 / math.sqrt(D)),
            int(causal), stream,
        )
        build.LAUNCHES["flash_attention_bwd"] += 1
    build.check("flash_attention_bwd", err)
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
