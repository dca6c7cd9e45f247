"""Predicate scans over chunked store tables (zone-map pushdown).

``scan(table, columns, predicates)`` is the store's read primitive:

1. every sargable conjunct is translated into the target column's
   *physical* domain (string constants become code bounds against the
   column's sorted dictionary — one ``searchsorted`` per predicate, not
   per row);
2. chunks whose zone maps prove the conjunct can never match are
   skipped before any payload is touched (lazy chunks stay on disk —
   Flare-style scan skipping: win the scan by not doing it);
3. surviving chunks are row-filtered exactly (numpy mask per chunk) and
   the projected columns are concatenated.

The result keeps dict columns as (codes, interned dictionary) so the
frame layer (``TensorFrame.from_store``) builds tensors without
re-factorizing — the store's second job after skipping I/O.

Predicates are conjuncts (implicit AND).  Supported ops:
``= <> < <= > >=`` against a scalar, ``between`` (inclusive pair),
``in`` (value tuple), ``isnull`` / ``notnull`` (float columns: NaN is
the store's null — chunks prune on the zone-map null counts), and
``like`` (prefix match, i.e. SQL ``LIKE 'prefix%'`` — dict columns
reduce it to a code range against the sorted dictionary, plain string
columns prune on the min/max string bounds).  Anything else stays a
residual filter above the scan (the SQL optimizer only pushes sargable
conjuncts).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .table import Column, Table, _empty_physical

_CMP_OPS = ("=", "<>", "<", "<=", ">", ">=")


@dataclasses.dataclass(frozen=True)
class Pred:
    """One sargable conjunct: ``column <op> value``.

    ``op`` is one of ``= <> < <= > >=`` (value: scalar), ``between``
    (value: inclusive ``(lo, hi)``), ``in`` (value: tuple), ``isnull``
    / ``notnull`` (value ignored) or ``like`` (value: the literal
    prefix of a ``LIKE 'prefix%'`` pattern).  Date values may be
    ``np.datetime64`` or int days since epoch.
    """

    column: str
    op: str
    value: object = None

    def __post_init__(self):
        if self.op not in _CMP_OPS + ("between", "in", "isnull", "notnull", "like"):
            raise ValueError(f"unknown predicate op {self.op!r}")


@dataclasses.dataclass(frozen=True)
class MaterializedColumn:
    """One scanned column: physical values (+ dictionary for dict).

    ``validity`` is a row-aligned bool array for columns whose chunks
    carry explicit null bitmaps (True = present); ``None`` when the
    column has no bitmaps (floats still encode nulls as NaN)."""

    ctype: str
    values: np.ndarray
    dictionary: Optional[np.ndarray] = None
    validity: Optional[np.ndarray] = None


@dataclasses.dataclass
class ScanResult:
    nrows: int
    columns: Dict[str, MaterializedColumn]
    chunks_total: int
    chunks_skipped: int
    rows_scanned: int  # rows materialized before the exact row filter


# ----------------------------------------------------------------------
# predicate normalization into the physical domain
# ----------------------------------------------------------------------
_ALL = "all"  # trivially true (drop)
_NONE = "none"  # trivially false (empty scan)


_INT_DOMAIN = ("int", "date", "bool")


def _as_days(v):
    if isinstance(v, np.datetime64):
        return int(v.astype("datetime64[D]").astype(np.int64))
    return v


def _normalize_value(col: Column, v):
    """Constant -> the column's physical domain.

    Integer-domain columns keep non-integral float constants as floats
    here; ``_to_physical`` rewrites the *predicate* instead (``k < 2.5``
    becomes ``k <= 2``) — truncating the constant would return wrong
    rows.
    """
    if col.ctype == "date":
        v = _as_days(v)
    if col.ctype == "float":
        return float(v)
    if col.ctype in _INT_DOMAIN:
        if isinstance(v, (bool, np.bool_)):
            return int(v)
        if isinstance(v, (int, np.integer)):
            return int(v)  # no float round-trip: 2**53+1 stays exact
        f = float(v)
        return int(f) if f == int(f) else f
    return str(v)


def _int_domain_scalar(op: str, v):
    """Rewrite ``col <op> v`` for an integer-domain column when ``v``
    is a non-integral float: no int equals 2.5, ``< 2.5`` means
    ``<= 2``, ``> 2.5`` means ``>= 3``."""
    if isinstance(v, int):
        return (op, v)
    import math

    if op == "=":
        return _NONE
    if op == "<>":
        return _ALL
    if op in ("<", "<="):
        return ("<=", math.floor(v))
    return (">=", math.ceil(v))  # '>' and '>='


def _to_physical(col: Column, p: Pred):
    """Translate ``p`` into physical-domain form: (op, value) | _ALL |
    _NONE.  For dict columns the value becomes a code (bound)."""
    import math

    if p.op in ("isnull", "notnull"):
        # float columns hold nulls as NaN; any ctype may carry explicit
        # validity bitmaps.  A bitmap-free non-float column decides
        # trivially.
        if col.ctype == "float" or col.has_validity():
            return (p.op, None)
        return _NONE if p.op == "isnull" else _ALL
    if p.op == "like":
        if col.ctype != "str":
            raise TypeError(
                f"LIKE predicate on non-string column {col.name!r}"
            )
        prefix = str(p.value)
        if col.encoding == "dict":
            # sorted dictionary: prefix matches are one contiguous code
            # range — one vectorized dictionary pass, zone maps then
            # prune on code bounds like any between
            lut = np.char.startswith(col.dictionary.astype("U"), prefix)
            idx = np.flatnonzero(lut)
            if idx.shape[0] == 0:
                return _NONE
            return ("between", (int(idx[0]), int(idx[-1])))
        return ("like", prefix)
    int_domain = col.ctype in _INT_DOMAIN and col.encoding != "dict"
    if p.op == "between":
        lo, hi = p.value
        lo, hi = _normalize_value(col, lo), _normalize_value(col, hi)
        if int_domain:
            lo, hi = math.ceil(lo), math.floor(hi)  # shrink to int bounds
            if lo > hi:
                return _NONE
        if col.encoding != "dict":
            return ("between", (lo, hi))
        d = col.dictionary
        a = int(np.searchsorted(d, lo, side="left"))
        b = int(np.searchsorted(d, hi, side="right")) - 1
        return ("between", (a, b)) if a <= b else _NONE
    if p.op == "in":
        vals = [_normalize_value(col, v) for v in p.value]
        if int_domain:
            vals = [v for v in vals if isinstance(v, int)]  # 2.5 in ints: never
            return ("in", tuple(vals)) if vals else _NONE
        if col.encoding != "dict":
            return ("in", tuple(vals))
        d = col.dictionary
        codes = []
        for v in vals:
            i = int(np.searchsorted(d, v))
            if i < d.shape[0] and d[i] == v:
                codes.append(i)
        return ("in", tuple(codes)) if codes else _NONE
    v = _normalize_value(col, p.value)
    if int_domain:
        return _int_domain_scalar(p.op, v)
    if col.encoding != "dict":
        return (p.op, v)
    # sorted dictionary: order-isomorphic codes, one searchsorted each
    d = col.dictionary
    left = int(np.searchsorted(d, v, side="left"))
    right = int(np.searchsorted(d, v, side="right"))
    present = right > left
    if p.op == "=":
        return ("=", left) if present else _NONE
    if p.op == "<>":
        return ("<>", left) if present else _ALL
    if p.op == "<":
        return ("<", left)  # codes [0, left) decode to strings < v
    if p.op == "<=":
        return ("<", right)
    if p.op == ">":
        return (">=", right)
    return (">=", left)  # '>='


# ----------------------------------------------------------------------
# zone-map chunk pruning
# ----------------------------------------------------------------------
def chunk_may_match(stats, phys) -> bool:
    """Can any row of a chunk with these zone maps satisfy ``phys``?"""
    if phys is _ALL:
        return True
    if phys is _NONE:
        return False
    lo, hi = stats.vmin, stats.vmax
    op, v = phys
    if op == "isnull":
        return stats.null_count > 0
    if op == "notnull":
        return lo is not None  # any non-null value in the chunk
    if op == "like":
        # prefix matches form the string interval [v, v_end); the chunk
        # range [lo, hi] intersects it iff hi >= v and lo < v_end
        # (lo < v_end  <=>  lo < v or lo startswith v)
        if lo is None:
            return False
        return str(hi) >= v and (str(lo) < v or str(lo).startswith(v))
    if lo is None:
        # all-null chunk: nothing compares true — except <>, where NaN
        # cells match under the engine's IEEE semantics
        return op == "<>"
    if op == "=":
        return lo <= v <= hi
    if op == "<>":
        # a chunk of all-v non-null values is skippable, but any NaN
        # null in it matches <> (IEEE), so nulls pin the chunk
        return stats.null_count > 0 or not (lo == hi == v)
    if op == "<":
        return lo < v
    if op == "<=":
        return lo <= v
    if op == ">":
        return hi > v
    if op == ">=":
        return hi >= v
    if op == "between":
        a, b = v
        return a <= hi and b >= lo
    # 'in'
    return any(lo <= x <= hi for x in v)


def _prune_mask(col: Column, ph) -> np.ndarray:
    """Vectorized keep-mask over the column's chunks for one physical
    predicate (the zone-map pass; one numpy op instead of a python call
    per chunk).  Falls back to exact per-chunk checks for plain-string
    stats and out-of-float64-range integer bounds."""
    n = len(col.chunks)
    if col.ctype == "str" and col.encoding != "dict":
        return np.fromiter(
            (chunk_may_match(c.stats, ph) for c in col.chunks), bool, count=n
        )
    mins, maxs, exact = col.zone_bounds()
    if not exact:
        return np.fromiter(
            (chunk_may_match(c.stats, ph) for c in col.chunks), bool, count=n
        )
    op, v = ph
    if op == "isnull":
        return np.fromiter(
            (c.stats.null_count > 0 for c in col.chunks), bool, count=n
        )
    if op == "notnull":
        return ~np.isnan(mins)  # NaN bound = all-null chunk
    if op == "=":
        return (mins <= v) & (v <= maxs)
    if op == "<>":
        # NaN cells match <> under IEEE semantics: all-null chunks
        # (NaN bounds give False inside, ~ keeps them) and chunks whose
        # non-null values are uniformly v but carry nulls both survive
        has_null = np.fromiter(
            (c.stats.null_count > 0 for c in col.chunks), bool, count=n
        )
        return has_null | ~((mins == maxs) & (maxs == v))
    if op == "<":
        return mins < v
    if op == "<=":
        return mins <= v
    if op == ">":
        return maxs > v
    if op == ">=":
        return maxs >= v
    if op == "between":
        a, b = v
        return (mins <= b) & (maxs >= a)
    out = np.zeros(n, dtype=bool)
    for x in v:
        out |= (mins <= x) & (x <= maxs)
    return out


def _eval_rows(
    values: np.ndarray, phys, valid: Optional[np.ndarray] = None
) -> np.ndarray:
    """Exact row mask of one chunk's physical values.

    ``valid`` is the chunk's explicit validity bitmap when it has one:
    null rows then match only ``isnull`` and ``<>`` (the engine's IEEE
    semantics — NaN satisfies ``<>``), never the ordered comparisons.
    """
    if valid is not None:
        op, _ = phys
        if op == "isnull":
            return ~valid
        if op == "notnull":
            return valid.copy()
        base = _eval_rows(values, phys)
        return (base | ~valid) if op == "<>" else (base & valid)
    op, v = phys
    if op == "isnull":
        return np.isnan(values.astype(np.float64))
    if op == "notnull":
        return ~np.isnan(values.astype(np.float64))
    if op == "like":
        return np.char.startswith(values.astype("U"), v)
    if op == "=":
        return values == v
    if op == "<>":
        # IEEE semantics, matching the engine's filter lowering: NaN
        # (null) cells DO satisfy <> — a pushed conjunct must select
        # exactly the rows the equivalent residual Filter would
        return values != v
    if op == "<":
        return values < v
    if op == "<=":
        return values <= v
    if op == ">":
        return values > v
    if op == ">=":
        return values >= v
    if op == "between":
        a, b = v
        return (values >= a) & (values <= b)
    mask = np.zeros(values.shape[0], dtype=bool)
    for x in v:
        mask |= values == x
    return mask


# ----------------------------------------------------------------------
# the scan
# ----------------------------------------------------------------------
def scan(
    table: Table,
    columns: Optional[Sequence[str]] = None,
    predicates: Sequence[Pred] = (),
) -> ScanResult:
    proj = list(columns) if columns is not None else table.column_names
    for name in proj:
        table.column(name)  # raises with a helpful message
    phys_preds: List[Tuple[Column, object]] = []
    trivially_empty = False
    for p in predicates:
        col = table.column(p.column)
        ph = _to_physical(col, p)
        if ph is _ALL:
            continue
        if ph is _NONE:
            trivially_empty = True
            continue
        phys_preds.append((col, ph))

    n_chunks = table.n_chunks
    survivors: List[int] = []
    if not trivially_empty:
        if phys_preds:
            keep = np.ones(n_chunks, dtype=bool)
            for col, ph in phys_preds:
                keep &= _prune_mask(col, ph)
            survivors = np.nonzero(keep)[0].tolist()
        else:
            survivors = list(range(n_chunks))

    parts: Dict[str, List[np.ndarray]] = {name: [] for name in proj}
    nullable = {
        name for name in proj if table.columns[name].has_validity()
    }
    vparts: Dict[str, List[np.ndarray]] = {name: [] for name in nullable}
    rows_scanned = 0
    nrows = 0
    any_col = next(iter(table.columns.values()), None)
    if len(survivors) == n_chunks:
        # nothing pruned: take the sequential bulk-read path instead of
        # paying a seek+read per chunk (the unpredicated read_tfb case)
        for name in proj:
            table.columns[name].ensure_loaded()
        for col, _ in phys_preds:
            col.ensure_loaded()
    for i in survivors:
        mask = None
        for col, ph in phys_preds:
            m = _eval_rows(col.chunk_physical(i), ph, col.chunk_validity(i))
            mask = m if mask is None else (mask & m)
        if mask is not None and bool(mask.all()):
            mask = None  # whole chunk passes: avoid the fancy-index copy
        chunk_n = any_col.chunks[i].n if any_col is not None else 0
        rows_scanned += chunk_n
        nrows += chunk_n if mask is None else int(mask.sum())
        for name in proj:
            col = table.columns[name]
            part = col.chunk_physical(i)
            parts[name].append(part if mask is None else part[mask])
            if name in nullable:
                v = col.chunk_validity(i)
                if v is None:
                    v = np.ones(col.chunks[i].n, dtype=bool)
                vparts[name].append(v if mask is None else v[mask])

    out: Dict[str, MaterializedColumn] = {}
    for name in proj:
        col = table.columns[name]
        if parts[name]:
            values = np.concatenate(parts[name])
        else:
            values = _empty_physical(col.ctype, col.encoding)
        valid = None
        if name in nullable:
            valid = (
                np.concatenate(vparts[name])
                if vparts[name]
                else np.ones(0, dtype=bool)
            )
        out[name] = MaterializedColumn(col.ctype, values, col.dictionary, valid)
    return ScanResult(
        nrows=nrows,
        columns=out,
        chunks_total=n_chunks,
        chunks_skipped=n_chunks - len(survivors),
        rows_scanned=rows_scanned,
    )


# ----------------------------------------------------------------------
# chunk-at-a-time scanning (the out-of-core pipeline's read primitive)
# ----------------------------------------------------------------------
def plan_scan(
    table: Table,
    columns: Optional[Sequence[str]] = None,
    predicates: Sequence[Pred] = (),
) -> Tuple[List[str], List[Tuple[Column, object]], np.ndarray]:
    """Plan a scan without materializing anything.

    Returns ``(projection, physical predicates, surviving chunk ids)``
    — the zone-map pruning half of ``scan``, split out so a streaming
    consumer (an out-of-core pipeline) can materialize the survivors
    one chunk at a time via ``scan_chunk`` instead of all at once.
    """
    proj = list(columns) if columns is not None else table.column_names
    for name in proj:
        table.column(name)  # raises with a helpful message
    phys_preds: List[Tuple[Column, object]] = []
    trivially_empty = False
    for p in predicates:
        col = table.column(p.column)
        ph = _to_physical(col, p)
        if ph is _ALL:
            continue
        if ph is _NONE:
            trivially_empty = True
            continue
        phys_preds.append((col, ph))
    n_chunks = table.n_chunks
    if trivially_empty:
        survivors = np.zeros(0, dtype=np.int64)
    elif phys_preds:
        keep = np.ones(n_chunks, dtype=bool)
        for col, ph in phys_preds:
            keep &= _prune_mask(col, ph)
        survivors = np.nonzero(keep)[0]
    else:
        survivors = np.arange(n_chunks, dtype=np.int64)
    return proj, phys_preds, survivors


def scan_chunk(
    table: Table,
    proj: Sequence[str],
    phys_preds: Sequence[Tuple[Column, object]],
    i: int,
) -> ScanResult:
    """Materialize ONE chunk of a planned scan (see ``plan_scan``).

    Pure host-side numpy — safe to run on a prefetch thread while the
    device processes the previous chunk.  Semantics per chunk are
    identical to ``scan``'s inner loop: exact row masks, validity
    bitmaps carried through, dictionary codes left encoded.
    """
    mask = None
    for col, ph in phys_preds:
        m = _eval_rows(col.chunk_physical(i), ph, col.chunk_validity(i))
        mask = m if mask is None else (mask & m)
    if mask is not None and bool(mask.all()):
        mask = None
    any_col = next(iter(table.columns.values()), None)
    chunk_n = any_col.chunks[i].n if any_col is not None else 0
    nrows = chunk_n if mask is None else int(mask.sum())
    out: Dict[str, MaterializedColumn] = {}
    for name in proj:
        col = table.columns[name]
        part = col.chunk_physical(i)
        if mask is not None:
            part = part[mask]
        valid = None
        if col.has_validity():
            v = col.chunk_validity(i)
            if v is None:
                v = np.ones(chunk_n, dtype=bool)
            valid = v if mask is None else v[mask]
        out[name] = MaterializedColumn(col.ctype, part, col.dictionary, valid)
    return ScanResult(
        nrows=nrows,
        columns=out,
        chunks_total=1,
        chunks_skipped=0,
        rows_scanned=chunk_n,
    )


# ----------------------------------------------------------------------
# shared multi-predicate scan (serving micro-batches)
# ----------------------------------------------------------------------
def shared_scan(
    table: Table,
    requests: Sequence[Tuple[Optional[Sequence[str]], Sequence[Pred]]],
) -> List[ScanResult]:
    """One zone-map pass answering many predicated scans of ``table``.

    ``requests`` is a sequence of ``(columns, predicates)`` pairs — the
    arguments ``scan`` takes, one per concurrent query.  Semantics per
    request are identical to calling ``scan`` (same pruning, same exact
    row filters, same accounting), but the pass over the table is
    shared:

    * each chunk's physical values are decoded **once** (rle runs
      expanded once, lazy chunks loaded once) no matter how many
      requests touch it;
    * identical physical conjuncts across requests share their exact
      row masks (16 dashboards asking ``ts >= today`` evaluate the
      comparison once per chunk, not 16 times);
    * zone-map pruning stays per-request, so each request still skips
      the chunks its own predicates disprove.

    This is the serving layer's admission-batching primitive:
    many sargable predicates against one store table collapse into one
    shared scan pass.
    """
    n_chunks = table.n_chunks
    normed = []  # (proj, [(col, ph)], per-request chunk keep mask)
    for columns, predicates in requests:
        proj = list(columns) if columns is not None else table.column_names
        for name in proj:
            table.column(name)  # raises with a helpful message
        phys_preds: List[Tuple[Column, object]] = []
        trivially_empty = False
        for p in predicates:
            col = table.column(p.column)
            ph = _to_physical(col, p)
            if ph is _ALL:
                continue
            if ph is _NONE:
                trivially_empty = True
                continue
            phys_preds.append((col, ph))
        if trivially_empty:
            keep = np.zeros(n_chunks, dtype=bool)
        elif phys_preds:
            keep = np.ones(n_chunks, dtype=bool)
            for col, ph in phys_preds:
                keep &= _prune_mask(col, ph)
        else:
            keep = np.ones(n_chunks, dtype=bool)
        normed.append((proj, phys_preds, keep))

    # chunks any request materializes, per column (projection + filter)
    union = np.zeros(n_chunks, dtype=bool)
    for _, _, keep in normed:
        union |= keep
    if bool(union.all()):
        # nothing pruned anywhere: prefer one sequential bulk read per
        # column over per-chunk seeks (mirrors the single-scan path)
        needed = set()
        for proj, phys_preds, _ in normed:
            needed.update(proj)
            needed.update(col.name for col, _ in phys_preds)
        for name in needed:
            table.columns[name].ensure_loaded()

    values_cache: Dict[Tuple[int, int], np.ndarray] = {}

    def chunk_values(col: Column, i: int) -> np.ndarray:
        key = (id(col), i)
        got = values_cache.get(key)
        if got is None:
            got = values_cache[key] = col.chunk_physical(i)
        return got

    # exact row masks shared across requests carrying the same conjunct
    mask_cache: Dict[Tuple[int, int, object], np.ndarray] = {}

    def pred_mask(col: Column, i: int, ph) -> np.ndarray:
        try:
            key = (id(col), i, ph)
            got = mask_cache.get(key)
        except TypeError:  # unhashable predicate value: evaluate fresh
            return _eval_rows(chunk_values(col, i), ph, col.chunk_validity(i))
        if got is None:
            got = mask_cache[key] = _eval_rows(
                chunk_values(col, i), ph, col.chunk_validity(i)
            )
        return got

    any_col = next(iter(table.columns.values()), None)
    results: List[ScanResult] = []
    for proj, phys_preds, keep in normed:
        survivors = np.nonzero(keep)[0].tolist()
        parts: Dict[str, List[np.ndarray]] = {name: [] for name in proj}
        nullable = {
            name for name in proj if table.columns[name].has_validity()
        }
        vparts: Dict[str, List[np.ndarray]] = {name: [] for name in nullable}
        rows_scanned = 0
        nrows = 0
        for i in survivors:
            mask = None
            for col, ph in phys_preds:
                m = pred_mask(col, i, ph)
                mask = m if mask is None else (mask & m)
            if mask is not None and bool(mask.all()):
                mask = None  # whole chunk passes: skip the fancy-index copy
            chunk_n = any_col.chunks[i].n if any_col is not None else 0
            rows_scanned += chunk_n
            nrows += chunk_n if mask is None else int(mask.sum())
            for name in proj:
                col = table.columns[name]
                part = chunk_values(col, i)
                parts[name].append(part if mask is None else part[mask])
                if name in nullable:
                    v = col.chunk_validity(i)
                    if v is None:
                        v = np.ones(col.chunks[i].n, dtype=bool)
                    vparts[name].append(v if mask is None else v[mask])
        out: Dict[str, MaterializedColumn] = {}
        for name in proj:
            col = table.columns[name]
            if parts[name]:
                values = np.concatenate(parts[name])
            else:
                values = _empty_physical(col.ctype, col.encoding)
            valid = None
            if name in nullable:
                valid = (
                    np.concatenate(vparts[name])
                    if vparts[name]
                    else np.ones(0, dtype=bool)
                )
            out[name] = MaterializedColumn(
                col.ctype, values, col.dictionary, valid
            )
        results.append(
            ScanResult(
                nrows=nrows,
                columns=out,
                chunks_total=n_chunks,
                chunks_skipped=n_chunks - len(survivors),
                rows_scanned=rows_scanned,
            )
        )
    return results
