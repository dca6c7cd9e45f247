"""Helpers of the plain references: vectorised numpy over the generator's
host tables, in the precision a reference is built with."""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def days(s: str) -> int:
    return int(np.datetime64(s, "D").astype(np.int64))


def year_of(d: np.ndarray) -> np.ndarray:
    return d.astype("datetime64[D]").astype("datetime64[Y]").astype(np.int64) + 1970


def prepare(table: Dict[str, np.ndarray], ftype) -> Dict[str, np.ndarray]:
    """Dates as int64 days, floats in ``ftype``, the rest as they are."""
    out = {}
    for k, a in table.items():
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.datetime64):
            a = a.astype("datetime64[D]").astype(np.int64)
        elif a.dtype.kind == "f":
            a = a.astype(ftype, copy=False)
        out[k] = a
    return out


def str_mask(arr: np.ndarray, pred) -> np.ndarray:
    return np.fromiter((pred(s) for s in arr), dtype=bool, count=len(arr))


def like_between(s: str, a: str, b: str) -> bool:
    """SQL ``LIKE '%a%b%'``."""
    i = s.find(a)
    return i >= 0 and s.find(b, i + len(a)) >= 0


class Index:
    """Positions of unique int64 keys, by direct addressing."""

    def __init__(self, keys: np.ndarray):
        keys = np.asarray(keys, dtype=np.int64)
        self.lo = int(keys.min()) if len(keys) else 0
        span = int(keys.max()) - self.lo + 1 if len(keys) else 1
        self.pos = np.full(span, -1, dtype=np.int64)
        self.pos[keys - self.lo] = np.arange(len(keys))

    def __call__(self, probe: np.ndarray) -> np.ndarray:
        probe = np.asarray(probe, dtype=np.int64) - self.lo
        ok = (probe >= 0) & (probe < len(self.pos))
        out = np.full(len(probe), -1, dtype=np.int64)
        out[ok] = self.pos[probe[ok]]
        return out


def group(*cols: np.ndarray):
    """(group id of each row, one row of each group), groups in key order."""
    n = len(cols[0])
    if n == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    code = np.zeros(n, dtype=np.int64)
    for c in cols:
        _, inv = np.unique(c, return_inverse=True)
        code = code * (int(inv.max()) + 1) + inv
    _, first, gid = np.unique(code, return_index=True, return_inverse=True)
    return gid.astype(np.int64), first


def seg_sum(vals: np.ndarray, gid: np.ndarray, m: int) -> np.ndarray:
    """Per-group sums, accumulated in the values' own type."""
    vals = np.asarray(vals)
    if vals.dtype.kind in "iub":
        # whole numbers: exact in float64 up to 2**53
        return np.rint(np.bincount(gid, weights=vals.astype(np.float64), minlength=m)).astype(np.int64)
    if vals.dtype == np.float64:
        return np.bincount(gid, weights=vals, minlength=m)
    out = np.zeros(m, dtype=vals.dtype)
    np.add.at(out, gid, vals)
    return out


def count(gid: np.ndarray, m: int) -> np.ndarray:
    return np.bincount(gid, minlength=m).astype(np.int64)


def total(vals: np.ndarray):
    """A scalar SUM; NaN (SQL NULL) over no rows."""
    return vals.sum() if len(vals) else np.asarray(np.nan, dtype=vals.dtype)


def sort_rows(cols: Dict[str, np.ndarray], order: Sequence[Sequence[str]]) -> Dict[str, np.ndarray]:
    """Rows in ORDER BY order (``[[name, "asc"|"desc"], ...]``)."""
    if not order or not cols:
        return cols
    keys: List[np.ndarray] = []
    for name, direction in order:
        a = cols[name]
        if a.dtype == object:
            _, a = np.unique(a, return_inverse=True)
        a = a.astype(np.float64) if a.dtype.kind == "f" else a.astype(np.int64)
        keys.append(-a if direction == "desc" else a)
    idx = np.lexsort(keys[::-1])
    return {k: v[idx] for k, v in cols.items()}


def columns(**cols) -> Dict[str, np.ndarray]:
    return {k: np.asarray(v) for k, v in cols.items()}
