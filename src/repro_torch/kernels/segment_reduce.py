"""Segment sum (K1) and the run-rank helper of the join's CSR expansion.

``segment_sum_cuda`` launches the hand-written kernel in
``csrc/segment_sum.cu``, the Hopper counterpart of the TPU kernel
``segment_sum_sorted_pallas``; ``segment_sum_plain`` is the plain
PyTorch version of the same function.  ``kernels.ops.segment_sum``
picks between them by the tensor's device.

The kernel has three paths by the number of segments m (see the
source's note): ``few`` (m <= ``FEW_SLOTS``, register accumulators),
``mid`` (m <= ``SMEM_SLOTS``, shared-memory partials) and ``many``
(global atomics after runs of equal ids are summed).  ``PATH_LAUNCHES``
counts the launches of each, beside the kernel's count in
``build.LAUNCHES``.
"""
from __future__ import annotations

from typing import Dict

import torch

from . import build

#: value dtypes the kernel takes, with the C interface's dtype code
_DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.int64: 2}
#: the kernel's paths, with the C interface's path code, and their limits
PATHS = {"few": 0, "mid": 1, "many": 2}
FEW_SLOTS = 16
SMEM_SLOTS = 4096
#: launches of the kernel by path; zeroed with the launch counts
PATH_LAUNCHES: Dict[str, int] = {name: 0 for name in PATHS}


def segment_path(num_segments: int) -> str:
    """The kernel path that sums into ``num_segments`` segments."""
    if num_segments <= FEW_SLOTS:
        return "few"
    return "mid" if num_segments <= SMEM_SLOTS else "many"


def segment_sum_plain(
    values: torch.Tensor, seg_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """Per-segment sums of ``values`` over int64 ``seg_ids`` in any
    order.  Ids outside ``[0, num_segments)`` are dropped, as
    ``jax.ops.segment_sum`` drops them."""
    out = torch.zeros((num_segments,), dtype=values.dtype, device=values.device)
    keep = (seg_ids >= 0) & (seg_ids < num_segments)
    return out.scatter_add_(0, seg_ids[keep], values[keep])


def _check_segment_args(values: torch.Tensor, seg_ids: torch.Tensor) -> None:
    if values.device.type != "cuda" or seg_ids.device != values.device:
        raise ValueError(
            f"segment_sum kernel needs both tensors on one CUDA device, got "
            f"{values.device} and {seg_ids.device}"
        )
    if values.dtype not in _DTYPE_CODES:
        raise TypeError(f"segment_sum kernel takes float32/float64/int64, got {values.dtype}")
    if seg_ids.dtype != torch.int64:
        raise TypeError(f"segment ids must be int64, got {seg_ids.dtype}")
    if values.dim() != 1 or seg_ids.shape != values.shape:
        raise ValueError(
            f"segment_sum kernel takes 1-D values and ids of one length, got "
            f"{tuple(values.shape)} and {tuple(seg_ids.shape)}"
        )
    if not (values.is_contiguous() and seg_ids.is_contiguous()):
        raise ValueError("segment_sum kernel takes contiguous tensors")


def segment_sum_cuda(
    values: torch.Tensor, seg_ids: torch.Tensor, num_segments: int
) -> torch.Tensor:
    """``segment_sum_plain`` on the card, through the CUDA kernel."""
    _check_segment_args(values, seg_ids)
    out = torch.zeros((num_segments,), dtype=values.dtype, device=values.device)
    n = values.shape[0]
    if n == 0 or num_segments == 0:
        return out
    fn = build.kernel("segment_sum")
    path = segment_path(num_segments)
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        err = fn(
            _DTYPE_CODES[values.dtype], PATHS[path], values.data_ptr(), seg_ids.data_ptr(),
            n, int(num_segments), out.data_ptr(), stream,
        )
        build.LAUNCHES["segment_sum"] += 1
        PATH_LAUNCHES[path] += 1
    build.check("segment_sum", err)
    return out


def run_ranks_sorted(ids: torch.Tensor) -> torch.Tensor:
    """Within-run rank (0-based) of each element of a *sorted* id vector:
    ``position - run_start``, with run starts recovered by a cumulative
    max over boundary positions.  On-device, no host sync."""
    n = ids.shape[0]
    if n == 0:
        return torch.zeros((0,), dtype=torch.int64, device=ids.device)
    idx = torch.arange(n, dtype=torch.int64, device=ids.device)
    boundary = torch.zeros((n,), dtype=torch.bool, device=ids.device)
    boundary[1:] = ids[1:] != ids[:-1]
    starts = torch.cummax(torch.where(boundary, idx, 0), dim=0).values
    return idx - starts
