"""Entry points of the hand-written kernels, dispatched by device.

A CUDA tensor launches the kernel (and its wrapper counts the launch in
``LAUNCHES``); a CPU tensor takes the plain PyTorch version; any other
device raises.  Nothing falls back: a kernel that fails to build or
launch raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from .build import LAUNCHES, reset_launches  # noqa: F401  (re-exported)
from .segment_reduce import segment_sum_cuda, segment_sum_plain
from .substr_find import substr_find_cuda, substr_find_plain


def _route(t: torch.Tensor, fn: str) -> str:
    kind = t.device.type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"{fn}: no kernel or plain version for device {t.device}")
    return kind


def segment_sum(values: torch.Tensor, seg_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Per-segment sums over int64 ids in any order (K1)."""
    if _route(values, "segment_sum") == "cuda":
        return segment_sum_cuda(values, seg_ids, num_segments)
    return segment_sum_plain(values, seg_ids, num_segments)


def substr_find(
    packed: torch.Tensor,
    lens: torch.Tensor,
    pattern: torch.Tensor,
    start: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-row index of the first ``pattern`` at or after ``start``, or -1 (K2)."""
    if _route(packed, "substr_find") == "cuda":
        return substr_find_cuda(packed, lens, pattern, start)
    return substr_find_plain(packed, lens, pattern, start)


def exists_before(packed, lens, pat_a: torch.Tensor, pat_b: torch.Tensor) -> torch.Tensor:
    """True where ``pat_a`` occurs and ``pat_b`` occurs after it: two
    ``substr_find`` calls, as ``exists_before_pallas`` makes."""
    fa = substr_find(packed, lens, pat_a)
    start = torch.where(fa >= 0, fa + int(pat_a.shape[0]), 0).to(torch.int32)
    fb = substr_find(packed, lens, pat_b, start=start)
    return (fa >= 0) & (fb >= 0)
