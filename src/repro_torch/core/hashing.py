"""Composite-key construction (paper §IV-B).

The paper's insight — build the composite key **once per row** in
row-major (transposed) layout as an immutable tuple, instead of
incrementally per column with mutable keys — maps to tensors as:

- *exact packing*: factorized codes have known cardinalities, so a
  k-tuple packs into one int64 by Horner's rule when the domain product
  fits 63 bits.  The packed scalar IS the immutable tuple.
- *hash fallback*: when the domain overflows, a splitmix64-style mix
  combines the columns (collision odds ~ n^2 / 2^64).

Finding distinct keys then becomes sort + run-boundary detection, and
the per-group reduction a segment op.

PyTorch has no uint64 add, shift or searchsorted, so splitmix64 runs in
int64: multiplication and addition wrap exactly as uint64 does, a
logical right shift is an arithmetic one masked to the low bits, and
constants above 2^63 are written as their int64 bit patterns.  The
result equals the uint64 computation bit for bit.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from .frame import INT, TensorFrame


def _i64(c: int) -> int:
    """A uint64 constant as its int64 bit pattern."""
    return c - (1 << 64) if c >= (1 << 63) else c


_SPLIT_K1 = _i64(0x9E3779B97F4A7C15)
_SPLIT_K2 = _i64(0xBF58476D1CE4E5B9)
_SPLIT_K3 = _i64(0x94D049BB133111EB)

MAX_PACK = (1 << 62)


def _srl(z: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def splitmix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer on int64 bit patterns (uint64 semantics)."""
    z = x.to(INT) + _SPLIT_K1
    z = (z ^ _srl(z, 30)) * _SPLIT_K2
    z = (z ^ _srl(z, 27)) * _SPLIT_K3
    return z ^ _srl(z, 31)


def hash_combine(cols: Sequence[torch.Tensor]) -> torch.Tensor:
    """64-bit tuple hash of k integer columns (the Alg.2 hash step),
    shifted into non-negative int64 for sorting/searchsorted."""
    h = torch.zeros(cols[0].shape, dtype=INT, device=cols[0].device)
    for c in cols:
        h = splitmix64(h ^ splitmix64(c))
    return _srl(h, 1)


def key_codes(frame: TensorFrame, name: str) -> Tuple[torch.Tensor, int]:
    """Dense (codes, cardinality) for a grouping/join key column.

    dict/obj columns already have dense codes; integer-like columns are
    range-compressed (val - min) when the range is sane, else densified
    via a device unique (host-syncs the count).
    """
    m = frame.meta(name)
    if m.kind == "dict":
        return frame.col_values(name), int(m.dictionary.shape[0])
    if m.kind == "obj":
        codes, dictionary = frame.offloaded[name].codes()
        return codes, int(dictionary.shape[0])
    if m.kind == "float":
        # group-by on measures (e.g. TPC-H Q10's c_acctbal): bitcast to
        # integer lanes — bit equality == value equality for our data
        f = frame.col_values(name).contiguous()
        arr = f.view(torch.int64) if f.dtype == torch.float64 else f.view(torch.int32).to(INT)
        if arr.shape[0] == 0:
            return arr, 1
        uniq = torch.unique(arr, sorted=True)
        return torch.searchsorted(uniq, arr), int(uniq.shape[0])
    arr = frame.col_values(name)
    if arr.shape[0] == 0:
        return arr, 1
    lo, hi = frame.int_bounds(name)  # cached; one fused fetch on miss
    span = hi - lo + 1
    if span <= max(4 * arr.shape[0], 1 << 20):
        return arr - lo, span
    # sparse domain: densify
    uniq = torch.unique(arr, sorted=True)
    return torch.searchsorted(uniq, arr.contiguous()), int(uniq.shape[0])


def composite_key(
    frame: TensorFrame, keys: Sequence[str]
) -> Tuple[torch.Tensor, bool, Optional[int]]:
    """Single int64 composite key per row.

    Returns (key_array, exact, dense_domain) — exact=True when keys pack
    losslessly; dense_domain is the packed domain size when every packed
    value is additionally guaranteed non-negative (no dict/obj null
    sentinels), which lets ``distinct`` take its sort-free dense path.
    """
    cols: List[Tuple[torch.Tensor, int]] = [key_codes(frame, k) for k in keys]
    prod = 1
    for _, card in cols:
        prod *= max(1, card)
        if prod >= MAX_PACK:
            break
    if prod < MAX_PACK:
        packed = torch.zeros((frame.nrows,), dtype=INT, device=frame.device)
        for codes, card in cols:
            packed = packed * max(1, card) + codes.to(INT)
        dense_ok = all(
            not (frame.meta(k).kind in ("dict", "obj") and frame.has_nulls(k)) for k in keys
        )
        return packed, True, (prod if dense_ok else None)
    return hash_combine([c for c, _ in cols]), False, None


def distinct(
    packed: torch.Tensor, domain: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """(sorted_uniques, group_ids, n_groups).  Host-syncs n_groups.

    Dense path: when the packed values are dense non-negative codes over
    a small ``domain``, distinct-finding needs NO sort — scatter
    presence bits, prefix-sum them into ranks, gather.  O(n + domain).

    Sort path: one stable argsort + run boundaries + two scatters: group
    ids are the run ranks scattered back through the sort permutation,
    and the uniques compact by rank.
    """
    n = int(packed.shape[0])
    dev = packed.device
    if n == 0:
        return packed, packed, 0
    if domain is not None and 0 < domain <= 4 * n:  # O(n+domain) stays O(n)
        present = torch.zeros((domain,), dtype=INT, device=dev)
        present[packed] = 1
        ranks = torch.cumsum(present, dim=0) - 1  # value -> its sorted-unique id
        m = int(ranks[-1]) + 1  # the one host sync
        gids = ranks[packed]
        # absent values land in the trash slot m, dropped below
        dest = torch.where(present == 1, ranks, m)
        uniques = torch.zeros((m + 1,), dtype=packed.dtype, device=dev)
        uniques[dest] = torch.arange(domain, dtype=packed.dtype, device=dev)
        return uniques[:m], gids, m
    order = torch.argsort(packed, stable=True)
    sp = packed[order]
    boundary = torch.ones((n,), dtype=torch.bool, device=dev)
    boundary[1:] = sp[1:] != sp[:-1]
    ranks = torch.cumsum(boundary.to(INT), dim=0) - 1  # group id, sorted order
    m = int(ranks[-1]) + 1  # the one host sync
    uniques = torch.zeros((m,), dtype=packed.dtype, device=dev)
    uniques[ranks] = sp
    gids = torch.zeros((n,), dtype=INT, device=dev)
    gids[order] = ranks
    return uniques, gids, m
