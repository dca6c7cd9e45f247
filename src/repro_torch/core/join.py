"""Joins (paper §IV-C, Alg. 3: factorize-then-join).

Pipeline:

1. **Shared factorization** of each key pair into one dense integer
   space (dictionary merge for strings, device-side range compression
   for ints — one bounds fetch, no host unique — with a combined-domain
   densify fallback for sparse domains) — Alg. 3 line 5.
2. **Composite packing** of multi-column keys (Horner over shared
   cardinalities, densifying between steps so the packed domain stays
   O(n) — always exact).
3. **Build/probe**: the Mojo hash table becomes a *direct-address
   table* (dense codes are a perfect hash): scatter build positions,
   gather probes.  The build-side uniqueness decision is
   **stats-driven**: cached distinct/uniqueness stats are consulted
   first, and only an unknown build side pays the sort-based test.
   Non-unique build keys take sorted-probe (searchsorted + CSR
   expansion via ``kernels.segment_reduce.run_ranks_sorted``).
   ``sort_merge_join_rows`` is the paper's losing baseline (Fig. 12).
4. **Materialization**: *late* — matched row indices compose into the
   frames' ``RowView`` selection vectors and the two sides' payload
   blocks stack zero-copy.  The probe compaction runs on-device (cumsum
   + scatter) behind a single deferred count fetch per join.

Supported: inner, left (outer), semi, anti.

Null keys never match (SQL semantics): left nulls are coded -1, right
nulls -2, and both build and probe paths reject negatives.

Every argsort is stable: the build-side order decides the row order of
the join's output.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple, Union

import torch

from .. import obs
from ..kernels import ops
from ..kernels.segment_reduce import run_ranks_sorted
from . import encoding
from .config import CONFIG
from .frame import (
    INT,
    VALID_PREFIX,
    ColumnMeta,
    OffloadedColumn,
    TensorFrame,
    ViewBlock,
    _empty_tensor,
    _is_hidden,
    _valid_name,
    float_dtype,
    host,
)

_DENSIFY_LIMIT_FACTOR = 4

#: Observable decision counters (tests / benchmarks): how often the auto
#: algorithm pick was answered by the stats cache vs. paying the
#: sort-based uniqueness test.
STATS = {
    "stats_unique_hits": 0,
    "stats_nonunique_hits": 0,
    "uniqueness_sort_tests": 0,
}


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = 0


obs.metrics.register_group("core.join", lambda: dict(STATS), reset_stats)


def _as_list(x) -> List[str]:
    if x is None:
        return []
    return [x] if isinstance(x, str) else list(x)


# ----------------------------------------------------------------------
# shared factorization (Alg. 3 line 5)
# ----------------------------------------------------------------------
def shared_key_codes(
    left: TensorFrame, right: TensorFrame, lname: str, rname: str
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    lm, rm = left.meta(lname), right.meta(rname)
    string_kinds = ("dict", "obj")
    if lm.kind in string_kinds or rm.kind in string_kinds:
        if lm.kind not in string_kinds or rm.kind not in string_kinds:
            raise TypeError(
                f"join key type mismatch: {lname}({lm.kind}) vs {rname}({rm.kind})"
            )
        lc, ld = left.col_codes(lname)
        rc, rd = right.col_codes(rname)
        if ld is rd:
            return lc, rc, int(ld.shape[0])
        merged, ra, rb = encoding.merge_dictionaries(ld, rd)
        return (
            torch.as_tensor(ra, dtype=INT, device=lc.device)[lc],
            torch.as_tensor(rb, dtype=INT, device=rc.device)[rc],
            int(merged.shape[0]),
        )
    if lm.kind == "float" or rm.kind == "float":
        raise TypeError("cannot join on float columns")
    la = left.col_values(lname)
    ra = right.col_values(rname)
    nl, nr = int(la.shape[0]), int(ra.shape[0])
    if nl == 0 and nr == 0:
        return la.to(INT), ra.to(INT), 1
    # range compression from cached bounds: after the first touch of a
    # column the join issues NO bounds sync — just the one count fetch
    los, his = [], []
    if nl:
        b = left.int_bounds(lname)
        los.append(b[0])
        his.append(b[1])
    if nr:
        b = right.int_bounds(rname)
        los.append(b[0])
        his.append(b[1])
    lo, hi = min(los), max(his)
    span = hi - lo + 1
    if span <= max(1 << 20, _DENSIFY_LIMIT_FACTOR * (nl + nr)):
        return (la - lo).to(INT), (ra - lo).to(INT), span
    # sparse domain fallback: densify over the combined key set
    ca, cb, domain = encoding.shared_codes_numeric(host(la), host(ra))
    return (
        torch.as_tensor(ca, device=la.device),
        torch.as_tensor(cb, device=ra.device),
        domain,
    )


def _densify_pair(lp: torch.Tensor, rp: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, int]:
    uniq = torch.unique(torch.cat([lp, rp]), sorted=True)
    return (
        torch.searchsorted(uniq, lp.contiguous()),
        torch.searchsorted(uniq, rp.contiguous()),
        int(uniq.shape[0]),
    )


def composite_join_codes(
    left: TensorFrame,
    right: TensorFrame,
    left_on: Sequence[str],
    right_on: Sequence[str],
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Pack multi-column join keys into one shared dense space (exact)."""
    nl, nr = left.nrows, right.nrows
    if len(left_on) == 1:  # single key: no Horner packing round
        lc, rc, card = shared_key_codes(left, right, left_on[0], right_on[0])
        return lc.to(INT), rc.to(INT), max(1, int(card))
    limit = max(1 << 20, _DENSIFY_LIMIT_FACTOR * (nl + nr))
    lp = torch.zeros((nl,), dtype=INT, device=left.device)
    rp = torch.zeros((nr,), dtype=INT, device=right.device)
    domain = 1
    for lk, rk in zip(left_on, right_on):
        lc, rc, card = shared_key_codes(left, right, lk, rk)
        card = max(1, card)
        if domain * card >= (1 << 62):
            lp, rp, domain = _densify_pair(lp, rp)
        lp = lp * card + lc.to(INT)
        rp = rp * card + rc.to(INT)
        domain = domain * card
        if domain > limit:
            lp, rp, domain = _densify_pair(lp, rp)
    return lp, rp, int(domain)


# ----------------------------------------------------------------------
# row-pair computation
# ----------------------------------------------------------------------
def direct_address_rows(
    probe: torch.Tensor, build: torch.Tensor, domain: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Unique-build-key probe via perfect-hash (direct-address) table.

    Returns (matched mask over probe rows, probe_rows, build_rows).
    Negative codes (nulls) on either side never match: null build rows
    scatter into a trash slot (``domain``) that probes cannot reach, and
    null probe rows read slot ``domain + 1``, which is never written.
    The matched rows are compacted on-device (prefix sum + scatter)
    behind a single deferred count fetch.
    """
    dev = probe.device
    npr = int(probe.shape[0])
    nb = build.shape[0]
    tbl = torch.full((domain + 2,), -1, dtype=INT, device=dev)
    build_idx = torch.where(build >= 0, build, domain)
    tbl[build_idx] = torch.arange(nb, dtype=INT, device=dev)
    probe_idx = torch.where(probe >= 0, torch.clamp(probe, max=max(0, domain - 1)), domain + 1)
    pos = tbl[probe_idx]
    matched = pos >= 0
    if npr == 0:
        empty = torch.zeros((0,), dtype=INT, device=dev)
        return matched, empty, empty
    slots = torch.cumsum(matched.to(INT), dim=0)
    cnt = int(slots[-1])  # the one host sync of the probe
    dest = torch.where(matched, slots - 1, cnt)
    probe_rows = torch.zeros((cnt + 1,), dtype=INT, device=dev)
    probe_rows[dest] = torch.arange(npr, dtype=INT, device=dev)
    probe_rows = probe_rows[:cnt]
    return matched, probe_rows, pos[probe_rows]


def sorted_probe_rows(
    probe: torch.Tensor, build: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Many-to-many probe: sort build side once, binary-search ranges,
    expand via CSR arithmetic.  Returns (counts, probe_rows, build_rows).

    The expansion ranks each output row within its probe's match run
    with ``run_ranks_sorted``, replacing two of the three repeats with
    gathers.
    """
    dev = probe.device
    npr = int(probe.shape[0])
    order = torch.argsort(build, stable=True)
    sb = build[order].contiguous()
    probe = probe.contiguous()
    starts = torch.searchsorted(sb, probe, side="left")
    ends = torch.searchsorted(sb, probe, side="right")
    counts = (ends - starts).to(INT)
    total = int(counts.sum())  # the one host sync of the probe
    probe_rows = torch.repeat_interleave(
        torch.arange(npr, dtype=INT, device=dev), counts, output_size=total
    )
    within = run_ranks_sorted(probe_rows)
    build_rows = order[starts.to(INT)[probe_rows] + within]
    return counts, probe_rows, build_rows


def sort_merge_join_rows(
    lcodes: torch.Tensor, rcodes: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fig. 12 baseline: sort-merge join (sorts BOTH sides)."""
    lorder = torch.argsort(lcodes, stable=True)
    ls = lcodes[lorder]
    _, li_sorted, ri = sorted_probe_rows(ls, rcodes)
    return lorder[li_sorted], ri


def membership(probe: torch.Tensor, build: torch.Tensor) -> torch.Tensor:
    """exists(probe value in build) — for semi/anti joins."""
    if int(build.shape[0]) == 0:
        return torch.zeros(probe.shape, dtype=torch.bool, device=probe.device)
    sb = torch.sort(build, stable=True).values
    pos = torch.clamp(torch.searchsorted(sb, probe.contiguous()), 0, sb.shape[0] - 1)
    return (sb[pos] == probe) & (probe >= 0)


def _membership_routed(probe: torch.Tensor, build: torch.Tensor) -> torch.Tensor:
    """Membership with an optional sharded route: the probe side shards
    over a data mesh, the (small) build side is replicated on every rank
    (``repro_torch.dist.dframe.dist_semi_join_mask``)."""
    if CONFIG.distributed != "off" and int(build.shape[0]) > 0:
        from ..dist import dframe

        if dframe.dist_enabled(int(probe.shape[0])):
            return dframe.dist_semi_join_mask(dframe.data_mesh(), probe, build)
    return membership(probe, build)


# ----------------------------------------------------------------------
# frame stitching
# ----------------------------------------------------------------------
def _right_name_map(
    left: TensorFrame, right: TensorFrame, drop_right: Sequence[str], suffix: str
) -> Dict[str, str]:
    """Mapping right-column -> output name (suffix on collision)."""
    out: Dict[str, str] = {}
    dropset = set(drop_right)
    for name in right.column_names:
        if name in dropset:
            continue
        out[name] = name + suffix if name in left.columns else name
    return out


def _hstack(
    left: TensorFrame,
    right: TensorFrame,
    name_map: Dict[str, str],
) -> TensorFrame:
    """Horizontal stack of two equal-length frames; right columns are
    renamed per ``name_map`` (absent = dropped).

    Late path: both sides' view blocks stack zero-copy — no payload
    moves; the output is a ``RowView`` frame over every source block.
    """
    n = left.nrows
    assert right.nrows == n, (right.nrows, n)
    if CONFIG.late_materialization:
        lblocks, lmat = left._view_parts()
        rblocks, rmat = right._view_parts()
        ofs = len(lblocks)
        rbase = 0 if lmat is None else int(lmat.shape[0])
        blocks = list(lblocks) + [
            ViewBlock(b.itensor, b.ftensor, None if b.row_id is None else rbase + b.row_id)
            for b in rblocks
        ]
        if lmat is None:
            rowmat = rmat
        elif rmat is None:
            rowmat = lmat
        else:
            rowmat = torch.cat([lmat, rmat], dim=0)
        cols: Dict[str, ColumnMeta] = dict(left.columns)
        off: Dict[str, OffloadedColumn] = dict(left.offloaded)
        for name, m in right.columns.items():
            if _is_hidden(name):
                base = name[len(VALID_PREFIX):]
                if base not in name_map:
                    continue
                new = _valid_name(name_map[base])
            else:
                if name not in name_map:
                    continue
                new = name_map[name]
            if m.kind == "obj":
                off[new] = right.offloaded[name]
                cols[new] = ColumnMeta(new, "obj", -1)
            else:
                cols[new] = dataclasses.replace(m, name=new, block=ofs + m.block)
        out = TensorFrame._from_view(cols, off, n, blocks, rowmat)
        # value bounds survive the gather (rows repeat, never widen)
        left._inherit_stats(out, "bounds")
        right._inherit_stats(out, "bounds", mapping=name_map)
        return out
    it = (
        torch.cat([left.itensor, right.itensor], dim=1)
        if right.itensor.shape[1]
        else left.itensor
    )
    ft = (
        torch.cat([left.ftensor, right.ftensor], dim=1)
        if right.ftensor.shape[1]
        else left.ftensor
    )
    iofs, fofs = left.itensor.shape[1], left.ftensor.shape[1]
    cols = dict(left.columns)
    off = dict(left.offloaded)
    for name, m in right.columns.items():
        if _is_hidden(name):
            base = name[len(VALID_PREFIX):]
            if base not in name_map:
                continue
            new = _valid_name(name_map[base])
        else:
            if name not in name_map:
                continue
            new = name_map[name]
        if m.kind == "obj":
            off[new] = right.offloaded[name]
            cols[new] = ColumnMeta(new, "obj", -1)
        elif m.kind == "float":
            cols[new] = ColumnMeta(new, "float", fofs + m.slot, None)
        else:
            cols[new] = ColumnMeta(new, m.kind, iofs + m.slot, m.dictionary)
    return TensorFrame(it, ft, cols, off, n)


def _vconcat_same_schema(a: TensorFrame, b: TensorFrame) -> TensorFrame:
    """Vertical concat of two frames with identical column dicts.

    Pipeline exit: both sides materialize (one fused gather per base
    tensor each) and concatenate tensor-to-tensor; mismatched slot
    layouts fall back to per-column stitching.
    """
    assert list(a.columns.keys()) == list(b.columns.keys())
    a.materialize()
    b.materialize()
    same_layout = all(
        (m.kind, m.slot) == (b.columns[name].kind, b.columns[name].slot)
        for name, m in a.columns.items()
    )
    if same_layout:
        it = torch.cat([a.itensor, b.itensor], dim=0)
        ft = torch.cat([a.ftensor, b.ftensor], dim=0)
        off: Dict[str, OffloadedColumn] = {}
        for name, oa in a.offloaded.items():
            ob = b.offloaded[name]
            assert oa.values is ob.values, "vconcat requires shared physical storage"
            off[name] = OffloadedColumn(oa.values, torch.cat([oa.idx, ob.idx]), oa._cache)
        return TensorFrame(it, ft, dict(a.columns), off, a.nrows + b.nrows)
    n = a.nrows + b.nrows
    dev = a.device
    cols: Dict[str, ColumnMeta] = {}
    off = {}
    icols: List[torch.Tensor] = []
    fcols: List[torch.Tensor] = []
    for name, ma in a.columns.items():
        mb = b.columns[name]
        if ma.kind == "obj":
            oa, ob = a.offloaded[name], b.offloaded[name]
            assert oa.values is ob.values, "vconcat requires shared physical storage"
            off[name] = OffloadedColumn(oa.values, torch.cat([oa.idx, ob.idx]), oa._cache)
            cols[name] = ColumnMeta(name, "obj", -1)
        elif ma.kind == "float":
            cols[name] = ColumnMeta(name, "float", len(fcols))
            fcols.append(torch.cat([a._raw_values(ma), b._raw_values(mb)]))
        else:
            cols[name] = ColumnMeta(name, ma.kind, len(icols), ma.dictionary)
            icols.append(torch.cat([a._raw_values(ma), b._raw_values(mb)]))
    it = torch.stack(icols, dim=1) if icols else _empty_tensor(n, INT, dev)
    ft = torch.stack(fcols, dim=1) if fcols else _empty_tensor(n, float_dtype(), dev)
    return TensorFrame(it, ft, cols, off, n)


def _null_right_rows(right: TensorFrame, n: int) -> TensorFrame:
    """A frame with right's schema, n rows, all values null-ish.

    Existing validity columns land at 0 automatically (itensor zeros);
    offloaded indexers point at physical row 0 and are masked by
    validity downstream.  When ``right`` is a view the null frame
    mirrors its block structure so the metas stay valid.
    """
    dev = right.device
    off = {
        name: OffloadedColumn(oc.values, torch.zeros((n,), dtype=INT, device=dev), oc._cache)
        for name, oc in right.offloaded.items()
    }
    if right._view is not None:
        blocks = [
            ViewBlock(
                torch.zeros((n, b.itensor.shape[1]), dtype=INT, device=dev),
                torch.full((n, b.ftensor.shape[1]), float("nan"), dtype=b.ftensor.dtype, device=dev),
                None,
            )
            for b in right._view.blocks
        ]
        return TensorFrame._from_view(dict(right.columns), off, n, blocks, None)
    it = torch.zeros((n, right.itensor.shape[1]), dtype=INT, device=dev)
    ft = torch.full(
        (n, right.ftensor.shape[1]), float("nan"), dtype=right.ftensor.dtype, device=dev
    )
    return TensorFrame(it, ft, dict(right.columns), off, n)


# ----------------------------------------------------------------------
# public join
# ----------------------------------------------------------------------
def join(
    left: TensorFrame,
    right: TensorFrame,
    on: Union[str, Sequence[str], None] = None,
    left_on: Union[str, Sequence[str], None] = None,
    right_on: Union[str, Sequence[str], None] = None,
    how: str = "inner",
    suffix: str = "_r",
    algorithm: str = "auto",  # 'auto' | 'direct' | 'sorted' | 'sortmerge'
) -> TensorFrame:
    if on is not None:
        left_on = right_on = _as_list(on)
    else:
        left_on, right_on = _as_list(left_on), _as_list(right_on)
    if not left_on or len(left_on) != len(right_on):
        raise ValueError("join requires matching key lists")
    if left.device != right.device:
        raise ValueError(f"join of frames on {left.device} and {right.device}")
    lcodes, rcodes, domain = composite_join_codes(left, right, left_on, right_on)

    # null keys never match: -1 on the left, -2 on the right
    null_keys = False
    for lk in left_on:
        v = left.valid_array(lk)
        if v is not None:
            lcodes = torch.where(v, lcodes, -1)
    for rk in right_on:
        v = right.valid_array(rk)
        if v is not None:
            null_keys = True
            rcodes = torch.where(v, rcodes, -2)

    if how in ("semi", "anti"):
        with obs.span(
            "core.join",
            how=how,
            algorithm="membership",
            probe_rows=left.nrows,
            build_rows=right.nrows,
        ):
            exists = _membership_routed(lcodes, rcodes)
        return left.mask_rows(exists if how == "semi" else ~exists)
    if how not in ("inner", "left"):
        raise ValueError(f"unsupported join type {how!r}")

    drop_right = [rk for lk, rk in zip(left_on, right_on) if lk == rk]
    name_map = _right_name_map(left, right, drop_right, suffix)

    nb = right.nrows
    matched_counts = None
    if algorithm == "sortmerge":
        with obs.span(
            "core.join",
            how=how,
            algorithm="sort_merge",
            probe_rows=left.nrows,
            build_rows=nb,
        ):
            lrows, rrows = sort_merge_join_rows(lcodes, rcodes)
    else:
        unique_build = False
        if algorithm in ("auto", "direct") and nb > 0:
            hint = right.unique_hint(right_on)
            if hint is not None:
                unique_build = bool(hint)
                STATS["stats_unique_hits" if hint else "stats_nonunique_hits"] += 1
            else:
                # unknown build side: pay the sort-based test once and
                # cache the verdict on the frame (exact distinct count
                # of the key combination — unless null keys collapsed
                # codes, which would under-count)
                STATS["uniqueness_sort_tests"] += 1
                m_build = int((torch.diff(torch.sort(rcodes).values) != 0).sum()) + 1
                unique_build = m_build == nb
                if not null_keys:
                    right.set_stats(list(right_on), unique=unique_build, distinct=m_build)
        algo = "direct_address" if unique_build and algorithm != "sorted" else "sorted_probe"
        with obs.span(
            "core.join",
            how=how,
            algorithm=algo,
            probe_rows=left.nrows,
            build_rows=nb,
        ):
            if algo == "direct_address":
                matched, lrows, rrows = direct_address_rows(lcodes, rcodes, domain)
                matched_counts = matched.to(INT)
            else:
                matched_counts, lrows, rrows = sorted_probe_rows(lcodes, rcodes)

    inner = _hstack(left.take(lrows), right.take(rrows), name_map)
    if how == "inner":
        return inner

    # ---- left outer ----
    if matched_counts is None:  # sortmerge path
        ones = torch.ones(lrows.shape, dtype=INT, device=lrows.device)
        matched_counts = ops.segment_sum(ones, lrows.contiguous(), left.nrows)
    unmatched = matched_counts == 0
    n_un = int(unmatched.sum())
    outer_part = _hstack(left.mask_rows(unmatched), _null_right_rows(right, n_un), name_map)

    # every right output column must carry validity in both parts;
    # columns that already had a __v__ flow it through (zeros in the
    # null part); the rest get it appended here, in identical order
    need_valid = [
        out_name for rname, out_name in name_map.items() if not right.has_nulls(rname)
    ]
    for out_name in need_valid:
        inner = inner._append_int_column(
            _valid_name(out_name),
            torch.ones((inner.nrows,), dtype=INT, device=inner.device),
            "bool",
        )
        outer_part = outer_part._append_int_column(
            _valid_name(out_name),
            torch.zeros((outer_part.nrows,), dtype=INT, device=outer_part.device),
            "bool",
        )
    return _vconcat_same_schema(inner, outer_part)
