"""Group-by aggregation (paper §IV-B), Alg. 2 (MojoFrame Transposed
Group-By):

1. gather the k key columns into row-major layout ("transpose"),
2. build one immutable composite key per row in a single pass (exact
   int64 packing; hash fallback) — ``hashing.composite_key``,
3. find distinct keys by sort + run boundaries (Mojo Dict replacement),
4. aggregate with segment ops (sums through the segment-sum kernel).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from . import hashing
from .agg import normalize_specs, segment_agg, segment_min
from .config import resolve_device
from .frame import INT, TensorFrame, host


class GroupBy:
    def __init__(self, frame: TensorFrame, keys: List[str]):
        self.frame = frame
        self.keys = keys
        packed, self.exact, dense_domain = hashing.composite_key(frame, keys)
        self.uniques, self.gids, self.m = hashing.distinct(packed, dense_domain)
        # representative (first-occurrence) row per group
        if frame.nrows:
            rows = torch.arange(frame.nrows, dtype=INT, device=frame.device)
            self.rep = segment_min(rows, self.gids, self.m)
        else:
            self.rep = torch.zeros((0,), dtype=INT, device=frame.device)

    @property
    def ngroups(self) -> int:
        return self.m

    def agg(self, specs) -> TensorFrame:
        specs = normalize_specs(specs)
        # key columns come from the representative rows, preserving
        # original values (and dictionaries) exactly
        out = self.frame.take(self.rep, stats="subset").select(self.keys)
        for out_name, fn, colname in specs:
            vals = segment_agg(self.frame, self.gids, self.m, fn, colname)
            if fn == "first":
                meta = self.frame.meta(colname)
                if meta.kind == "dict":
                    out = out._append_int_column(out_name, vals, "dict", meta.dictionary)
                    continue
                if meta.kind in ("date", "bool"):
                    out = out._append_int_column(out_name, vals, meta.kind)
                    continue
            if vals.is_floating_point():
                out = out._append_float_column(out_name, vals)
            else:
                out = out._append_int_column(out_name, vals)
        # the grouped output is unique by construction on its key
        # combination: seed the stats cache so a downstream
        # join(algorithm='auto') direct-addresses without a sort test.
        # Not when an aggregate output overwrote a key column.
        if not (set(self.keys) & {name for name, _, _ in specs}):
            out.set_stats(self.keys, unique=True, distinct=self.m)
            if len(self.keys) == 1:
                out.set_stats(self.keys[0], unique=True, distinct=self.m)
        return out

    def size(self, name: str = "size") -> TensorFrame:
        return self.agg([(name, "size", "")])

    def group_ids(self) -> torch.Tensor:
        return self.gids


def unique_rows(frame: TensorFrame, keys: List[str]) -> TensorFrame:
    gb = GroupBy(frame, keys)
    out = frame.take(gb.rep, stats="subset").select(keys)
    out.set_stats(keys, unique=True, distinct=gb.m)
    if len(keys) == 1:
        out.set_stats(keys[0], unique=True, distinct=gb.m)
    return out


def nunique_column(frame: TensorFrame, name: str) -> int:
    codes, _ = hashing.key_codes(frame, name)
    _, _, m = hashing.distinct(codes)
    # cache on the source frame: a later join build against this column
    # skips its uniqueness sort test
    if not frame.has_nulls(name):
        frame.set_stats(name, unique=(m == frame.nrows), distinct=m)
    return m


# ----------------------------------------------------------------------
# Fig. 11 ablation baselines (benchmark-only)
# ----------------------------------------------------------------------
def incremental_group_ids(cols: Sequence[np.ndarray]) -> np.ndarray:
    """Alg. 1: per-column incremental sparse-to-dense composite building
    (the Pandas strategy).  n re-densifications of the running key.
    Host numpy, as in the JAX package: the baseline the figure times."""
    n = cols[0].shape[0]
    ids = np.zeros(n, dtype=np.int64)
    for c in cols:
        _, cc = np.unique(c, return_inverse=True)
        card = cc.max() + 1 if n else 1
        pairs = ids * np.int64(card) + cc
        _, ids = np.unique(pairs, return_inverse=True)
    return ids


def pydict_group_ids(cols: Sequence[np.ndarray]) -> np.ndarray:
    """'PandasMojo' analog: row-by-row tuple keys through a Python dict
    (what Mojo's deep-copying Dict forces; Fig. 11 right).  Host Python,
    as in the JAX package."""
    n = cols[0].shape[0]
    ids = np.empty(n, dtype=np.int64)
    seen: Dict[tuple, int] = {}
    hosted = [np.asarray(c) for c in cols]
    for i in range(n):
        key = tuple(c[i] for c in hosted)
        gid = seen.get(key)
        if gid is None:
            gid = len(seen)
            seen[key] = gid
        ids[i] = gid
    return ids


def transposed_group_ids(cols: Sequence[np.ndarray], device=None) -> np.ndarray:
    """Alg. 2 key-building in isolation (for the operator benchmark):
    one-pass packed composite + sort-based distinct, on ``device``
    (default ``CONFIG.device``).  Returns the group ids as numpy."""
    dev = resolve_device(device)
    arrs = [torch.as_tensor(np.asarray(c).astype(np.int64), device=dev) for c in cols]
    packed = torch.zeros(arrs[0].shape, dtype=INT, device=dev)
    if arrs[0].shape[0]:
        # all k cardinalities in ONE device fetch
        cards = host(torch.stack([a.max() for a in arrs])) + 1
    else:
        cards = np.ones((len(arrs),), dtype=np.int64)
    for a, card in zip(arrs, cards):
        packed = packed * max(1, int(card)) + a
    _, gids, _ = hashing.distinct(packed)
    return host(gids)
