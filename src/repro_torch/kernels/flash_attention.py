"""Causal or full grouped-query attention (K4) with an online softmax.

``flash_attention_cuda`` launches the hand-written kernel in
``csrc/flash_attention.cu``, the Hopper counterpart of the TPU kernel
``flash_attention_pallas``; ``flash_attention_plain`` is the plain
PyTorch version (the softmax of ``ref.mha_reference``, computed in f32).
``kernels.ops.flash_attention`` picks between them by the tensor's
device.

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


def flash_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True
) -> torch.Tensor:
    """``flash_attention_plain`` on the card, through the CUDA kernel.
    Takes any batch, head and sequence strides; the output is contiguous."""
    _check_shapes(q, k, v, causal)
    _check_kernel_args(q, k, v)
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    o = torch.empty((B, Hq, Sq, D), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    fn = build.kernel("flash_attention")
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            B, Hq, Hkv, Sq, Sk, D, *strides, float(1.0 / math.sqrt(D)), int(causal), stream,
        )
        build.LAUNCHES["flash_attention"] += 1
    build.check("flash_attention", err)
    return o
