"""Gradient compression: per-block int8 quantization + error feedback
(``repro/dist/compression.py``).

The training leg's answer to interconnect-bound data parallelism
(1-bit / error-feedback SGD lineage): each rank quantizes its local
gradient to int8 with one float32 scale per 256-element block, the
all-reduce runs over the dequantized tensors, and the quantization error
is *kept locally* as a residual to be added back into the next step's
gradient -- so the error feeds back instead of accumulating.

``quantize`` has the JAX package's arithmetic (block-wise absmax scales,
rounding half to even), so both give the same codes and scales.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .dframe import DataMesh, all_reduce

BLOCK = 256


def quantize(
    x: torch.Tensor, block: int = BLOCK, resid: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-block symmetric int8 quantization with error feedback.

    ``resid`` (the previous step's residual) is added to the 1-D ``x``
    before quantizing.  Returns ``(q, scales, residual)``:

    - ``q``: int8 codes, length padded up to a block multiple,
    - ``scales``: float32 ``(nblocks, 1)`` per-block scales
      (``dequantized = q.reshape(-1, block) * scales``),
    - ``residual``: ``x + resid - dequantized`` over the original
      (unpadded) length -- the error to feed back next step.
    """
    n = x.shape[0]
    if resid is not None:
        x = x + resid
    xb = F.pad(x, (0, (-n) % block)).reshape(-1, block)
    absmax = xb.abs().amax(dim=1, keepdim=True)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its rounded reciprocal, which is not always the
    # correctly rounded quotient the CPU (and the JAX package) give
    scales = torch.where(absmax > 0, absmax / torch.full_like(absmax, 127.0), 1.0)
    scales = scales.to(torch.float32)
    q = torch.clamp(torch.round(xb / scales), -127, 127).to(torch.int8)
    deq = (q.to(x.dtype) * scales).reshape(-1)[:n]
    return q.reshape(-1), scales, x - deq


def dequantize(q: torch.Tensor, scales: torch.Tensor, n: Optional[int] = None) -> torch.Tensor:
    """Invert ``quantize``: codes * per-block scales, cut back to ``n``."""
    out = (q.to(scales.dtype).reshape(scales.shape[0], -1) * scales).reshape(-1)
    return out if n is None else out[:n]


def compressed_mean(
    x: torch.Tensor, mesh: DataMesh, resid: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean of every rank's ``x`` over the mesh, communicating quantized
    values.

    Each rank quantizes its own ``x`` (after folding in ``resid``), the
    mean is taken over the dequantized tensors with one ``all_reduce``,
    and the local quantization error comes back as the residual for
    error feedback.
    """
    q, scales, residual = quantize(x, resid=resid)
    deq = dequantize(q, scales, x.shape[0]).to(x.dtype)
    return all_reduce(deq, mesh) / mesh.size, residual
