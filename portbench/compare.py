"""The comparison that decides ``correct``: one query's result from the
program against the plain reference's, on the same inputs.

Rows are compared as a multiset, in a canonical order (every column that
is not a float, then the floats).  Keys, codes, counts, strings and
dates must be equal; each float within a relative error.  The program's
rows must also come in its ORDER BY order, read with the same relative
error on float keys (rows tied on every key may come in any order; see
``unsorted_rows``).

Two numbers come out of a comparison: the rows that differ (in count,
in an exact column, or out of order), held to 0, and the largest
relative error of a float, held to the configuration's limit.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

#: floor of the denominator of a relative error, for values at or near 0
REL_FLOOR = 1e-9


def _norm(a) -> np.ndarray:
    a = np.asarray(a)
    if np.issubdtype(a.dtype, np.datetime64):
        return a.astype("datetime64[D]").astype(np.int64)
    if a.dtype == np.bool_:
        return a.astype(np.int64)
    if a.dtype.kind in "OUS":
        return np.array([None if v is None else str(v) for v in a], dtype=object)
    return a


def _is_float(a: np.ndarray) -> bool:
    return a.dtype.kind == "f"


def rel_err(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    g = got.astype(np.float64)
    w = want.astype(np.float64)
    both_nan = np.isnan(g) & np.isnan(w)
    err = np.abs(g - w) / np.maximum(np.abs(w), REL_FLOOR)
    err[both_nan] = 0.0
    err[np.isnan(err)] = np.inf
    return err


def _codes(*arrays: np.ndarray) -> List[np.ndarray]:
    """Shared sortable integer codes for the same column of two results."""
    allv = np.concatenate(arrays)
    if allv.dtype == object:
        keys = np.array(["\x00" if v is None else "\x01" + v for v in allv], dtype=object)
        _, inv = np.unique(keys, return_inverse=True)
    else:
        _, inv = np.unique(allv, return_inverse=True)
    out, at = [], 0
    for a in arrays:
        out.append(inv[at:at + len(a)])
        at += len(a)
    return out


def unsorted_rows(cols: Dict[str, np.ndarray], order_by: Sequence[Sequence[str]],
                  tol: float) -> int:
    """Adjacent row pairs out of ``order_by`` order.  A pair whose float
    key is equal goes on to the next key; one whose float key differs by
    ``tol`` (relative) or less is in order either way, since rounding can
    swap two such sums; one that differs by more must follow the key."""
    n = len(next(iter(cols.values()))) if cols else 0
    if n < 2 or not order_by:
        return 0
    undecided = np.ones(n - 1, dtype=bool)
    bad = np.zeros(n - 1, dtype=bool)
    for name, direction in order_by:
        a = cols[name]
        x, y = a[:-1], a[1:]
        if _is_float(a):
            tied = (x == y) | (np.isnan(x) & np.isnan(y))
            close = rel_err(x, y) <= tol
            less = (x < y) & ~close
            greater = (x > y) & ~close
        else:
            if a.dtype == object:
                cx, cy = _codes(x, y)
                x, y = cx, cy
            tied = x == y
            less, greater = x < y, x > y
        wrong = greater if direction == "asc" else less
        bad |= undecided & wrong
        undecided &= tied
    return int(bad.sum())


def compare(got: Dict[str, object], want: Dict[str, object],
            order_by: Sequence[Sequence[str]], tol: float) -> Dict[str, float]:
    """``{"rows": rows that differ, "rel_err": largest float relative error}``."""
    want_n = {k: _norm(v) for k, v in want.items()}
    n_want = len(next(iter(want_n.values()))) if want_n else 0
    missing = [k for k in want_n if k not in got]
    if missing:
        return {"rows": max(n_want, 1), "rel_err": 0.0}
    got_n = {k: _norm(got[k]) for k in want_n}
    n_got = len(next(iter(got_n.values()))) if got_n else 0
    if n_got != n_want:
        return {"rows": abs(n_got - n_want) + min(n_got, n_want), "rel_err": 0.0}
    if n_want == 0:
        return {"rows": 0, "rel_err": 0.0}
    exact = [k for k in want_n if not _is_float(want_n[k])]
    floats = [k for k in want_n if _is_float(want_n[k])]
    keys_g, keys_w = [], []
    for k in exact:
        cg, cw = _codes(got_n[k], want_n[k])
        keys_g.append(cg)
        keys_w.append(cw)
    for k in floats:
        keys_g.append(got_n[k].astype(np.float64))
        keys_w.append(want_n[k].astype(np.float64))
    og = np.lexsort(keys_g[::-1])
    ow = np.lexsort(keys_w[::-1])
    bad = np.zeros(n_want, dtype=bool)
    for cg, cw in zip(keys_g[:len(exact)], keys_w[:len(exact)]):
        bad |= cg[og] != cw[ow]
    err = 0.0
    for k in floats:
        g = got_n[k]
        if not _is_float(g) and g.dtype.kind not in "iu":
            bad[:] = True
            continue
        e = rel_err(g[og], want_n[k][ow])
        bad |= ~np.isfinite(e)
        if np.isfinite(e).any():
            err = max(err, float(e[np.isfinite(e)].max()))
    rows = int(bad.sum()) + unsorted_rows(got_n, order_by, tol)
    return {"rows": rows, "rel_err": err}
