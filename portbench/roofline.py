"""The yardstick's peaks of one NVIDIA H100 SXM (NVIDIA's data sheet,
dense rates, at the full 700 W power limit) and the bytes a kernel call
needs.

A roofline share is the least time the card could take for a call,
divided by the time the call took on the device.  The least time is the
larger of the call's bytes over ``HBM_BYTES_PER_S`` and its operations
over the peak rate of its number format.  Bytes and operations are those
the logical call needs, reckoned from its shapes alone, so the yardstick
reads the same work whatever implements the kernel.  Later kernels'
byte functions go beside this one, as files of their own.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
BF16_FLOP_PER_S = 989e12


def segment_sum_bytes(rows: int, segments: int, value_bytes: int, id_bytes: int = 8) -> int:
    """Bytes that one call of K1 (``segment_sum``: per-segment sums of
    ``rows`` values over int64 segment ids into ``segments`` sums) needs.

    Each value and each segment id is read once, and each sum is written
    once, in the values' type.  The additions (one a row) are far below
    any peak rate, so K1 is bound by these bytes.  Whatever the kernel
    reads or writes beyond them (scratch tables, a clear, a second pass
    over the values) is its own cost and shows as a lower share.
    """
    return rows * (value_bytes + id_bytes) + segments * value_bytes


def least_seconds(nbytes: float, nops: float = 0.0, peak_ops: float = FP32_FLOP_PER_S) -> float:
    """The least time on the card: bytes over the bandwidth or operations
    over ``peak_ops``, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, nops / peak_ops)
