"""Per-row first-occurrence substring search (K2) on a packed
``(n, L) uint8`` string tensor, and the two-pattern test built on it.

``substr_find_cuda`` and ``exists_before_cuda`` launch the hand-written
kernel in ``csrc/substr_find.cu``, the Hopper counterpart of the TPU
kernels ``substr_find_pallas`` and ``exists_before_pallas``: the find,
and the fused test in one launch that reads each row once.
``substr_find_plain`` (a sliding-window compare, as the TPU kernel's
oracle does) and ``exists_before_plain`` (two plain finds) are the plain
PyTorch versions.  ``kernels.ops`` picks between them by the tensor's
device.

Every launch of the kernel counts in ``build.LAUNCHES["substr_find"]``;
``MODE_LAUNCHES`` says which form ran (zeroed with the launch counts by
``ops.reset_launches``).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from . import build

#: the kernel's two forms, with the C interface's mode code
MODES = {"find": 0, "exists_before": 1}
#: launches of the kernel by form
MODE_LAUNCHES: Dict[str, int] = {name: 0 for name in MODES}


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


def exists_before_plain(
    packed: torch.Tensor, lens: torch.Tensor, pat_a: torch.Tensor, pat_b: torch.Tensor
) -> torch.Tensor:
    """(n,) bool: ``pat_a`` occurs, and ``pat_b`` occurs at or after the
    end of its first occurrence (two plain finds, as
    ``exists_before_pallas`` makes two kernel calls)."""
    fa = substr_find_plain(packed, lens, pat_a)
    start = torch.where(fa >= 0, fa + int(pat_a.shape[0]), 0).to(torch.int32)
    fb = substr_find_plain(packed, lens, pat_b, start=start)
    return (fa >= 0) & (fb >= 0)


def _check_args(fn: str, packed, lens, patterns, start=None) -> None:
    """Device, contiguity, dtype and shape of the kernel's inputs: plain
    attribute reads, no device work."""
    dev = packed.device
    if dev.type != "cuda":
        raise ValueError(f"{fn} kernel needs CUDA tensors, got {dev}")
    named = [("packed", packed), ("lens", lens), *patterns]
    if start is not None:
        named.append(("start", start))
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"{fn} kernel: {name} on {t.device}, packed on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{fn} kernel: {name} is not contiguous")
    if packed.dtype != torch.uint8 or packed.dim() != 2:
        raise TypeError(f"packed must be (n, L) uint8, got {packed.dtype} {tuple(packed.shape)}")
    for name, p in patterns:
        if p.dtype != torch.uint8 or p.dim() != 1:
            raise TypeError(f"{name} must be (m,) uint8, got {p.dtype} {tuple(p.shape)}")
    n = packed.shape[0]
    for name, t in (("lens", lens), ("start", start)):
        if t is not None and (t.dtype != torch.int32 or t.shape != (n,)):
            raise TypeError(f"{name} must be ({n},) int32, got {t.dtype} {tuple(t.shape)}")


def _launch(mode: str, packed, lens, start, pat_a, pat_b, out) -> None:
    fn = build.kernel("substr_find")
    dev = packed.device
    n, L = packed.shape
    args = (
        MODES[mode], packed.data_ptr(), lens.data_ptr(),
        None if start is None else start.data_ptr(), pat_a.data_ptr(), pat_a.shape[0],
        None if pat_b is None else pat_b.data_ptr(), 0 if pat_b is None else pat_b.shape[0],
        n, L, out.data_ptr(),
    )
    if dev.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    else:
        with torch.cuda.device(dev):
            err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    build.LAUNCHES["substr_find"] += 1
    MODE_LAUNCHES[mode] += 1
    build.check("substr_find", err)


def substr_find_cuda(
    packed: torch.Tensor,
    lens: torch.Tensor,
    pattern: torch.Tensor,
    start: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``substr_find_plain`` on the card, through the CUDA kernel."""
    _check_args("substr_find", packed, lens, [("pattern", pattern)], start)
    n, L = packed.shape
    m = pattern.shape[0]
    if m == 0:
        return torch.zeros((n,), dtype=torch.int32, device=packed.device)
    if m > L:
        return torch.full((n,), -1, dtype=torch.int32, device=packed.device)
    out = torch.empty((n,), dtype=torch.int32, device=packed.device)
    if n > 0:
        _launch("find", packed, lens, start, pattern, None, out)
    return out


def exists_before_cuda(
    packed: torch.Tensor, lens: torch.Tensor, pat_a: torch.Tensor, pat_b: torch.Tensor
) -> torch.Tensor:
    """``exists_before_plain`` on the card, in one launch of the CUDA
    kernel.  A pattern longer than L gives every row False without a
    launch; empty patterns are the kernel's to handle."""
    _check_args("exists_before", packed, lens, [("pat_a", pat_a), ("pat_b", pat_b)])
    n, L = packed.shape
    if pat_a.shape[0] > L or pat_b.shape[0] > L:
        return torch.zeros((n,), dtype=torch.bool, device=packed.device)
    out = torch.empty((n,), dtype=torch.bool, device=packed.device)
    if n > 0:
        _launch("exists_before", packed, lens, None, pat_a, pat_b, out)
    return out
