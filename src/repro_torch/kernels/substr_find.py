"""Per-row first-occurrence substring search (K2) on a packed
``(n, L) uint8`` string tensor.

``substr_find_cuda`` launches the hand-written kernel in
``csrc/substr_find.cu``, the Hopper counterpart of the TPU kernel
``substr_find_pallas``; ``substr_find_plain`` is the plain PyTorch
version (a sliding-window compare, as the TPU kernel's oracle does).
``kernels.ops.substr_find`` picks between them by the tensor's device.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import build


def substr_find_plain(
    packed: torch.Tensor,
    lens: torch.Tensor,
    pattern: torch.Tensor,
    start: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """packed (n, L) uint8, pattern (m,) uint8 -> (n,) int32 first
    ``pos`` with ``pos + m <= len`` and ``pos >= start``, else -1."""
    n, L = packed.shape
    m = int(pattern.shape[0])
    if m == 0:
        return torch.zeros((n,), dtype=torch.int32, device=packed.device)
    if m > L:
        return torch.full((n,), -1, dtype=torch.int32, device=packed.device)
    npos = L - m + 1
    match = torch.ones((n, npos), dtype=torch.bool, device=packed.device)
    for j in range(m):
        match &= packed[:, j : j + npos] == pattern[j]
    pos = torch.arange(npos, dtype=torch.int32, device=packed.device)[None, :]
    ok = match & (pos + m <= lens[:, None].to(torch.int32))
    if start is not None:
        ok &= pos >= start[:, None].to(torch.int32)
    scores = torch.where(ok, pos, npos + 1)
    first = scores.min(dim=1).values
    return torch.where(first <= npos, first, -1).to(torch.int32)


def _check_find_args(packed, lens, pattern, start) -> None:
    dev = packed.device
    if dev.type != "cuda":
        raise ValueError(f"substr_find kernel needs CUDA tensors, got {dev}")
    named = [("packed", packed), ("lens", lens), ("pattern", pattern)]
    if start is not None:
        named.append(("start", start))
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"substr_find kernel: {name} on {t.device}, packed on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"substr_find kernel: {name} is not contiguous")
    if packed.dtype != torch.uint8 or packed.dim() != 2:
        raise TypeError(f"packed must be (n, L) uint8, got {packed.dtype} {tuple(packed.shape)}")
    if pattern.dtype != torch.uint8 or pattern.dim() != 1:
        raise TypeError(f"pattern must be (m,) uint8, got {pattern.dtype} {tuple(pattern.shape)}")
    n = packed.shape[0]
    for name, t in named[1:]:
        if name == "pattern":
            continue
        if t.dtype != torch.int32 or tuple(t.shape) != (n,):
            raise TypeError(f"{name} must be ({n},) int32, got {t.dtype} {tuple(t.shape)}")


def substr_find_cuda(
    packed: torch.Tensor,
    lens: torch.Tensor,
    pattern: torch.Tensor,
    start: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``substr_find_plain`` on the card, through the CUDA kernel."""
    _check_find_args(packed, lens, pattern, start)
    n, L = packed.shape
    m = int(pattern.shape[0])
    if m == 0:
        return torch.zeros((n,), dtype=torch.int32, device=packed.device)
    if m > L:
        return torch.full((n,), -1, dtype=torch.int32, device=packed.device)
    out = torch.empty((n,), dtype=torch.int32, device=packed.device)
    if n == 0:
        return out
    fn = build.kernel("substr_find")
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream(packed.device).cuda_stream
        err = fn(
            packed.data_ptr(), lens.data_ptr(), pattern.data_ptr(), m,
            None if start is None else start.data_ptr(), n, L, out.data_ptr(), stream,
        )
        build.LAUNCHES["substr_find"] += 1
    build.check("substr_find", err)
    return out
