"""Plain-PyTorch oracles for the ported kernels, under the names of the
JAX package's ``repro.kernels.ref``.  Each runs on any device."""
from __future__ import annotations

import torch

from .segment_reduce import segment_sum_plain
from .substr_find import substr_find_plain

substr_find = substr_find_plain


def exists_before(packed, lens, pat_a: torch.Tensor, pat_b: torch.Tensor) -> torch.Tensor:
    fa = substr_find(packed, lens, pat_a)
    start = torch.where(fa >= 0, fa + int(pat_a.shape[0]), 0).to(torch.int32)
    fb = substr_find(packed, lens, pat_b, start=start)
    return (fa >= 0) & (fb >= 0)


def segment_sum_sorted(values: torch.Tensor, seg_ids: torch.Tensor, num_segments: int):
    """Segment sum over sorted ids (K1's contract); the plain version
    takes ids in any order, so sorted ids are just a special case."""
    return segment_sum_plain(values, seg_ids.to(torch.int64), num_segments)
