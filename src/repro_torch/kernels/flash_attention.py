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
"""
from __future__ import annotations

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


def _launch(name: str, lead: list, q, k, v, causal: bool) -> torch.Tensor:
    """Launch kernel ``name``; ``lead`` are the C arguments before the
    pointers (the CUDA-core kernel's dtype code)."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    o = torch.empty((B, Hq, Sq, D), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    fn = build.kernel(name)
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            *lead, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            B, Hq, Hkv, Sq, Sk, D, *strides, float(1.0 / math.sqrt(D)), int(causal), stream,
        )
        build.LAUNCHES[name] += 1
    build.check(name, err)
    return o


def flash_attention_cuda_cores(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True
) -> torch.Tensor:
    """The CUDA-core kernel (``csrc/flash_attention.cu``), f32 or bf16.
    Takes any batch, head and sequence strides; the output is contiguous."""
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
    _check_shapes(q, k, v, causal)
    _check_kernel_args(q, k, v)
    if q.dtype != torch.bfloat16:
        raise TypeError(f"flash_attention_sm90 takes bfloat16, got {q.dtype}")
    q, k, v = (_tma_ready(t) for t in (q, k, v))
    return _launch("flash_attention_sm90", [], q, k, v, causal)


def flash_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True
) -> torch.Tensor:
    """``flash_attention_plain`` on the card: bf16 through the tensor-core
    kernel, f32 through the CUDA-core kernel, any other dtype raises."""
    if q.dtype == torch.bfloat16:
        return flash_attention_sm90(q, k, v, causal)
    if q.dtype == torch.float32:
        return flash_attention_cuda_cores(q, k, v, causal)
    raise TypeError(f"flash_attention kernel takes float32 or bfloat16, got {q.dtype}")
