"""Independent reference engine for correctness testing.

Deliberately naive: Python dict/list row-at-a-time semantics, written
without reference to the TensorFrame implementation, so shared bugs are
unlikely.  Columns are plain Python lists; None is the null.  Numpy
only: ``frame_to_odf`` reads a port frame through its host accessors
(``column``, ``valid_array`` copied to the host), on any device.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

ODF = Dict[str, List[Any]]


def from_numpy(data: Dict[str, np.ndarray]) -> ODF:
    out: ODF = {}
    for name, arr in data.items():
        arr = np.asarray(arr)
        if np.issubdtype(arr.dtype, np.datetime64):
            out[name] = list(arr.astype("datetime64[D]").astype(np.int64))
        elif np.issubdtype(arr.dtype, np.floating):
            out[name] = [float(x) for x in arr]
        elif np.issubdtype(arr.dtype, np.integer):
            out[name] = [int(x) for x in arr]
        elif arr.dtype == np.bool_:
            out[name] = [bool(x) for x in arr]
        else:
            out[name] = [None if x is None else str(x) for x in arr]
    return out


def nrows(df: ODF) -> int:
    return len(next(iter(df.values()))) if df else 0


def o_filter(df: ODF, mask: Sequence[bool]) -> ODF:
    return {k: [v[i] for i in range(len(mask)) if mask[i]] for k, v in df.items()}


def o_take(df: ODF, rows: Sequence[int]) -> ODF:
    return {k: [v[i] for i in rows] for k, v in df.items()}


def _agg_one(vals: List[Any], fn: str):
    nn = [v for v in vals if v is not None and not (isinstance(v, float) and math.isnan(v))]
    if fn == "size":
        return len(vals)
    if fn == "count":
        return len(nn)
    if fn == "nunique":
        return len(set(nn))
    if fn == "first":
        return vals[0] if vals else None
    if not nn:
        return None
    if fn == "sum":
        return sum(nn)
    if fn == "mean":
        return sum(nn) / len(nn)
    if fn == "min":
        return min(nn)
    if fn == "max":
        return max(nn)
    raise ValueError(fn)


def o_groupby(df: ODF, keys: Sequence[str], specs: Sequence[Tuple[str, str, str]]) -> ODF:
    n = nrows(df)
    groups: Dict[tuple, List[int]] = {}
    for i in range(n):
        key = tuple(df[k][i] for k in keys)
        groups.setdefault(key, []).append(i)
    out: ODF = {k: [] for k in keys}
    for out_name, _, _ in specs:
        out[out_name] = []
    for key, rows in groups.items():
        for kname, kval in zip(keys, key):
            out[kname].append(kval)
        for out_name, fn, colname in specs:
            vals = [df[colname][i] for i in rows] if colname else [1] * len(rows)
            out[out_name].append(_agg_one(vals, fn))
    return out


def o_join(
    left: ODF,
    right: ODF,
    left_on: Sequence[str],
    right_on: Sequence[str],
    how: str = "inner",
    suffix: str = "_r",
) -> ODF:
    nl, nr = nrows(left), nrows(right)
    table: Dict[tuple, List[int]] = {}
    for j in range(nr):
        key = tuple(right[k][j] for k in right_on)
        if any(v is None for v in key):
            continue
        table.setdefault(key, []).append(j)
    drop_right = {rk for lk, rk in zip(left_on, right_on) if lk == rk}
    right_names = {
        name: (name + suffix if name in left else name)
        for name in right
        if name not in drop_right
    }
    if how in ("semi", "anti"):
        keep = []
        for i in range(nl):
            key = tuple(left[k][i] for k in left_on)
            hit = (not any(v is None for v in key)) and key in table
            if (how == "semi") == hit:
                keep.append(i)
        return o_take(left, keep)
    out: ODF = {k: [] for k in left}
    for _, new in right_names.items():
        out[new] = []
    for i in range(nl):
        key = tuple(left[k][i] for k in left_on)
        matches = [] if any(v is None for v in key) else table.get(key, [])
        if matches:
            for j in matches:
                for k in left:
                    out[k].append(left[k][i])
                for old, new in right_names.items():
                    out[new].append(right[old][j])
        elif how == "left":
            for k in left:
                out[k].append(left[k][i])
            for _, new in right_names.items():
                out[new].append(None)
    return out


def o_sort(df: ODF, by: Sequence[str], ascending: Sequence[bool]) -> ODF:
    n = nrows(df)

    def keyfn(i):
        parts = []
        for name, asc in zip(by, ascending):
            v = df[name][i]
            parts.append(v if asc else _neg(v))
        return tuple(parts)

    rows = sorted(range(n), key=keyfn)
    return o_take(df, rows)


class _RevStr:
    __slots__ = ("s",)

    def __init__(self, s):
        self.s = s

    def __lt__(self, other):
        return self.s > other.s

    def __eq__(self, other):
        return self.s == other.s


def _neg(v):
    if isinstance(v, str):
        return _RevStr(v)
    return -v


# ----------------------------------------------------------------------
# result comparison helpers
# ----------------------------------------------------------------------
def records(df: ODF) -> List[tuple]:
    names = sorted(df.keys())
    n = nrows(df)
    return [tuple(df[k][i] for k in names) for i in range(n)]


def frame_to_odf(frame) -> ODF:
    out: ODF = {}
    for name in frame.column_names:
        arr = frame.column(name)
        m = frame.meta(name)
        if m.kind == "date":
            out[name] = [None if v is None else int(np.asarray(v).astype("datetime64[D]").astype(np.int64)) for v in arr]
        elif m.kind == "float":
            out[name] = [None if (isinstance(v, float) and math.isnan(v)) else float(v) for v in arr]
        elif m.kind in ("int", "bool"):
            valid = frame.valid_array(name)
            vmask = valid.cpu().numpy() if valid is not None else None
            out[name] = [
                None if (vmask is not None and not vmask[i]) else (int(v) if m.kind == "int" else bool(v))
                for i, v in enumerate(arr)
            ]
        else:
            out[name] = [None if v is None else str(v) for v in arr]
    return out


def assert_odf_equal(a: ODF, b: ODF, sort: bool = True, rtol: float = 1e-9):
    assert set(a.keys()) == set(b.keys()), (sorted(a), sorted(b))
    ra, rb = records(a), records(b)
    assert len(ra) == len(rb), f"row count {len(ra)} != {len(rb)}"
    if sort:
        skey = lambda t: tuple((x is None, _sortable(x)) for x in t)
        ra, rb = sorted(ra, key=skey), sorted(rb, key=skey)
    for i, (ta, tb) in enumerate(zip(ra, rb)):
        for va, vb in zip(ta, tb):
            if va is None and vb is None:
                continue
            if isinstance(va, float) or isinstance(vb, float):
                assert va is not None and vb is not None, (i, ta, tb)
                denom = max(abs(va), abs(vb), 1.0)
                assert abs(va - vb) / denom <= rtol, (i, ta, tb)
            else:
                assert va == vb, (i, ta, tb)


def _sortable(x):
    if x is None:
        return ""
    if isinstance(x, float):
        return round(x, 6)
    return x
