"""Two-lane 32-bit tuple hash over k integer columns (K3).

Each row of ``cols (n, k)`` (int32 or uint32) hashes to two uint32
lanes, seeded ``0x9E3779B9`` and ``0x7F4A7C15``: for each column j,
``h = fmix32(h ^ fmix32(col_j + j + 1))`` with the murmur3 finaliser
``fmix32`` and every add and multiply modulo 2^32.  int32 input is read
as its uint32 bits.  ``k == 0`` gives each row the two seeds.

``hash32x2_cuda`` launches the hand-written kernel in ``csrc/hash32x2.cu``,
the Hopper counterpart of the TPU kernel ``hash32x2_pallas``;
``hash32x2_plain`` is the plain PyTorch version, bit for bit the same.
``kernels.ops.hash32x2`` picks between them by the tensor's device.

The engine does not use this hash: its keys and its row routing hash
with splitmix64 (``core/hashing.py``), as the JAX engine's do.  This is
an op of its own, as ``repro.kernels.ops.hash32x2`` is.

PyTorch on the CPU has no ``>>`` for uint32, so the plain version holds
each 32-bit value in an int64 in [0, 2^32): shifts are then logical, and
``& 0xFFFFFFFF`` after each multiply and add keeps the low 32 bits (an
int64 product wraps, and its low 32 bits are the uint32 product's).
"""
from __future__ import annotations

import torch

from . import build

M1 = 0x85EBCA6B
M2 = 0xC2B2AE35
SEEDS = (0x9E3779B9, 0x7F4A7C15)
_MASK = 0xFFFFFFFF


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """The murmur3 finaliser on int64 values in [0, 2^32)."""
    h = h ^ (h >> 16)
    h = (h * M1) & _MASK
    h = h ^ (h >> 13)
    h = (h * M2) & _MASK
    return h ^ (h >> 16)


def hash32x2_plain(cols: torch.Tensor) -> torch.Tensor:
    """cols (n, k) int32/uint32 -> (n, 2) uint32 tuple hashes."""
    if cols.dim() != 2 or cols.dtype not in (torch.int32, torch.uint32):
        raise TypeError(
            f"hash32x2 takes (n, k) int32 or uint32, got {tuple(cols.shape)} {cols.dtype}"
        )
    n, k = cols.shape
    c = cols.to(torch.int64) & _MASK
    lanes = []
    for seed in SEEDS:
        h = torch.full((n,), seed, dtype=torch.int64, device=cols.device)
        for j in range(k):
            h = fmix32(h ^ fmix32((c[:, j] + (j + 1)) & _MASK))
        lanes.append(h)
    return torch.stack(lanes, dim=1).to(torch.uint32)


def _check_hash_args(cols: torch.Tensor) -> None:
    if cols.device.type != "cuda":
        raise ValueError(f"hash32x2 kernel needs a CUDA tensor, got {cols.device}")
    if cols.dtype not in (torch.int32, torch.uint32):
        raise TypeError(f"hash32x2 kernel takes int32 or uint32, got {cols.dtype}")
    if cols.dim() != 2:
        raise ValueError(f"hash32x2 kernel takes (n, k) columns, got {tuple(cols.shape)}")
    if not cols.is_contiguous():
        raise ValueError("hash32x2 kernel takes a contiguous tensor")


def hash32x2_cuda(cols: torch.Tensor) -> torch.Tensor:
    """``hash32x2_plain`` on the card, through the CUDA kernel."""
    _check_hash_args(cols)
    n, k = cols.shape
    out = torch.empty((n, 2), dtype=torch.uint32, device=cols.device)
    if n == 0:
        return out
    fn = build.kernel("hash32x2")
    with torch.cuda.device(cols.device):
        stream = torch.cuda.current_stream(cols.device).cuda_stream
        err = fn(cols.data_ptr(), n, k, out.data_ptr(), stream)
        build.LAUNCHES["hash32x2"] += 1
    build.check("hash32x2", err)
    return out
