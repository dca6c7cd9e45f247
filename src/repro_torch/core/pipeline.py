"""Morsel-driven out-of-core execution over the store's chunk grid.

Instead of materializing a whole store scan into device tensors, the
pipeline streams it chunk by chunk:

- ``ChunkScan`` iterates the zone-map survivors of a planned store scan
  as small per-chunk ``TensorFrame`` s.  A prefetch thread
  (``CONFIG.ooc_prefetch`` deep) decodes chunk ``k+1`` host-side while
  the device processes chunk ``k`` — decode and compute overlap.  The
  thread runs numpy only (``store.scan_chunk``) and never touches CUDA:
  the host-to-device copy of a chunk runs on the consuming thread, so a
  CUDA graph capture on another thread (the compiled SQL path captures
  in global mode) never sees a foreign CUDA call.  Each chunk frame is
  seeded with its own zone-map bounds (``ColStats``), so chunk-level
  pruning stays available *downstream* of filters and joins.
- ``HashBuild`` is the build-once/probe-per-chunk join side: the build
  frame's key is coded once (dictionary identity for interned store
  dictionaries, range compression from the build's own bounds for
  ints), and every probe chunk reuses it — a direct-address table for
  provably-unique inner builds, sorted membership codes for semi/anti.
  Probe chunks whose key bounds miss the build's range are skipped
  outright (inner/semi) or passed through unprobed (anti).
- ``StreamAgg`` accumulates per-chunk partial aggregates (mean
  decomposes into sum+count) and re-aggregates the partials every
  ``CONFIG.ooc_merge_every`` chunks.  Each chunk's partial group-by and
  each merge run through ``groupby(...).agg`` (the segment-sum kernel
  on the card).  Partial blocks are host numpy dicts under the spill
  manager (``repro_torch.store.spill``), so a run under
  ``CONFIG.memory_budget_bytes`` keeps its working set bounded: cold
  partials go to ``.tfb`` chunk files and re-hydrate transparently.

Frames land on the device the caller names, else ``CONFIG.device``
(``resolve_device``: a CUDA device with no card raises).

``STATS`` makes the whole thing observable: chunks streamed/pruned,
rows streamed, pipeline and fallback counts, plus the spill manager's
bytes spilled/re-read, evictions and peak tracked bytes.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..resilience import checkpoint

from .config import CONFIG, resolve_device
from .frame import INT, TensorFrame
from .join import _hstack, _right_name_map

#: Observable pipeline counters.  The spill keys mirror
#: ``repro_torch.store.spill.SPILL.counters`` (synced after every pipeline).
STATS = {
    "pipelines": 0,
    "chunks_streamed": 0,
    "chunks_pruned": 0,
    "rows_streamed": 0,
    "partial_merges": 0,
    "generic_probes": 0,
    "fallbacks": 0,
    "bytes_spilled": 0,
    "bytes_reread": 0,
    "evictions": 0,
    "peak_tracked_bytes": 0,
}


def reset_stats() -> None:
    from ..store.spill import SPILL

    for k in STATS:
        STATS[k] = 0
    SPILL.reset_counters()


def sync_spill_stats() -> None:
    from ..store.spill import SPILL

    STATS.update(SPILL.counters)


def _stats_snapshot() -> Dict:
    sync_spill_stats()
    return dict(STATS)


from .. import obs as _obs  # noqa: E402

_obs.metrics.register_group("core.pipeline", _stats_snapshot, reset_stats)


_INT_DOMAIN = ("int", "date", "bool")


# ----------------------------------------------------------------------
# chunk-pipelined store scan
# ----------------------------------------------------------------------
class ChunkScan:
    """Iterate a predicated store scan as per-chunk TensorFrames on
    ``device`` (default ``CONFIG.device``).

    Chunk decode (numpy: rle expansion, row masks, validity) runs on a
    prefetch thread up to ``CONFIG.ooc_prefetch`` chunks ahead; the
    consuming thread only does the host->device transfer and compute.
    ``prefetch=0`` degrades to fully synchronous iteration.
    """

    def __init__(self, table, columns, predicates, device=None):
        from .. import store as _store

        self.table = table
        self.device = resolve_device(device)
        self.proj, self.phys_preds, self.survivors = _store.plan_scan(
            table, columns, predicates
        )
        STATS["chunks_pruned"] += table.n_chunks - len(self.survivors)

    def __len__(self) -> int:
        return len(self.survivors)

    def _results(self):
        from .. import store as _store

        depth = max(0, int(CONFIG.ooc_prefetch))
        if depth == 0 or len(self.survivors) <= 1:
            for i in self.survivors:
                with _obs.detailed_span(
                    "pipeline.chunk_decode", chunk=int(i)
                ):
                    res = _store.scan_chunk(
                        self.table, self.proj, self.phys_preds, int(i)
                    )
                yield int(i), res
            return
        q: "queue.Queue" = queue.Queue(maxsize=depth)
        DONE = object()
        stop = threading.Event()

        def put(item) -> bool:
            # never block forever: an abandoned consumer (exception in
            # the pipeline body closes this generator early) sets
            # ``stop`` and the producer bails out instead of deadlocking
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            # host numpy only: no CUDA call may run on this thread
            try:
                for i in self.survivors:
                    if stop.is_set():
                        return
                    with _obs.detailed_span(
                        "pipeline.chunk_decode", chunk=int(i)
                    ):
                        res = _store.scan_chunk(
                            self.table, self.proj, self.phys_preds, int(i)
                        )
                    if not put((int(i), res)):
                        return
            except BaseException as e:  # re-raised on the consumer side
                put(e)
            finally:
                put(DONE)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                with _obs.detailed_span("pipeline.prefetch_wait"):
                    item = q.get()
                if item is DONE:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            while True:  # unblock a producer stuck on a full queue
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join()

    def __iter__(self):
        for _, f in self.iter_indexed():
            yield f

    def iter_indexed(self):
        """Yield ``(chunk_index, frame)`` — the index lets callers build
        recompute closures that re-scan exactly this chunk."""
        for i, res in self._results():
            # deadline/cancel checkpoint: a streamed pipeline can abort
            # between chunks even when a single chunk's compute can't
            checkpoint("pipeline.chunk")
            STATS["chunks_streamed"] += 1
            STATS["rows_streamed"] += res.nrows
            f = TensorFrame.from_store(
                self.table, self.proj, [], result=res, device=self.device
            )
            # tighten the table-wide bounds from_store seeded down to
            # THIS chunk's zone map — downstream joins prune on them
            for name in self.proj:
                col = self.table.columns[name]
                if col.ctype in _INT_DOMAIN and col.encoding != "dict":
                    st = col.chunks[i].stats
                    if res.nrows and st.vmin is not None:
                        f.set_stats(
                            name, vmin=int(st.vmin), vmax=int(st.vmax)
                        )
            yield int(i), f


# ----------------------------------------------------------------------
# build-once / probe-per-chunk joins
# ----------------------------------------------------------------------
class HashBuild:
    """One join's build side, prepared once and probed per chunk.

    Single-column keys get a build-once fast path: int/date keys are
    range-compressed against the build's own bounds (out-of-range probe
    values can never match), interned dictionary keys share codes by
    identity.  Provably-unique inner builds scatter one direct-address
    table; semi/anti sort the build codes once.  Everything else —
    multi-column keys, non-unique inner builds, left outer, foreign
    dictionaries — probes through the engine's general join per chunk,
    which is still streaming-safe (each probe row is independent).
    Null keys are coded -1 and never match.
    """

    def __init__(
        self,
        probe_keys: Sequence[str],
        build: TensorFrame,
        build_keys: Sequence[str],
        how: str,
        suffix: str = "_r",
    ):
        self.probe_keys = list(probe_keys)
        self.build_keys = list(build_keys)
        self.build = build.materialize()
        self.how = how
        self.suffix = suffix
        self._fast = None  # (mode, kind, lo, hi, payload, domain)
        if len(self.build_keys) == 1 and how in ("inner", "semi", "anti"):
            self._prepare_fast()

    def _build_codes(self):
        """(codes, kind, lo, hi, domain) for the single build key, or
        None when the key shape has no build-once form."""
        bk = self.build_keys[0]
        m = self.build.meta(bk)
        if m.kind in _INT_DOMAIN:
            if self.build.nrows == 0:
                return None
            lo, hi = self.build.int_bounds(bk)
            codes = (self.build.col_values(bk) - lo).to(INT)
            domain = hi - lo + 1
            kind = "intrange"
        elif m.kind == "dict":
            codes = self.build.col_values(bk).to(INT)
            lo, hi = 0, max(0, int(m.dictionary.shape[0]) - 1)
            domain = int(m.dictionary.shape[0])
            kind = "dict"
        else:
            return None
        valid = self.build.valid_array(bk)
        if valid is not None:
            codes = torch.where(valid, codes, -1)
        return codes, kind, lo, hi, domain

    def _prepare_fast(self) -> None:
        got = self._build_codes()
        if got is None:
            return
        codes, kind, lo, hi, domain = got
        if self.how in ("semi", "anti"):
            sb = torch.sort(codes).values
            self._fast = ("member", kind, lo, hi, sb, domain)
            return
        # inner: need a provably-unique build side for direct addressing
        nb = self.build.nrows
        if domain > max(1 << 22, 16 * max(1, nb)):
            return  # direct-address table would dwarf the build side
        hint = self.build.unique_hint(self.build_keys)
        if hint is None:
            # pay the sort test ONCE at build time (not per chunk)
            m_build = int((torch.diff(torch.sort(codes).values) != 0).sum()) + 1
            hint = m_build == nb
            self.build.set_stats(
                self.build_keys[0], unique=bool(hint), distinct=m_build
            )
        if not hint:
            return
        tbl = torch.full((domain + 2,), -1, dtype=INT, device=codes.device)
        idx = torch.where(codes >= 0, codes, domain)
        tbl[idx] = torch.arange(nb, dtype=INT, device=codes.device)
        self._fast = ("dar", kind, lo, hi, tbl, domain)

    # -- chunk-level pruning -------------------------------------------
    def disjoint(self, f: TensorFrame) -> bool:
        """Can the chunk's key bounds prove zero matches?  (Callers may
        then skip the chunk for inner/semi, or pass it through unprobed
        for anti — never drop rows on an anti join.)"""
        if self._fast is None or self._fast[1] != "intrange":
            return False
        st = f.col_stats(self.probe_keys[0])
        if st is None or st.vmin is None:
            return False
        _, _, lo, hi, _, _ = self._fast
        return st.vmax < lo or st.vmin > hi

    def _probe_codes(self, f: TensorFrame) -> Optional[torch.Tensor]:
        pk = self.probe_keys[0]
        m = f.meta(pk)
        _, kind, lo, hi, _, _ = self._fast
        if kind == "intrange":
            if m.kind not in _INT_DOMAIN:
                return None
            pv = f.col_values(pk)
            codes = torch.where((pv < lo) | (pv > hi), -1, pv - lo).to(INT)
        else:  # dict: codes are shared only by dictionary identity
            if m.kind != "dict" or m.dictionary is not self.build.meta(
                self.build_keys[0]
            ).dictionary:
                return None
            codes = f.col_values(pk).to(INT)
        valid = f.valid_array(pk)
        if valid is not None:
            codes = torch.where(valid, codes, -1)
        return codes.contiguous()

    # -- the probe ------------------------------------------------------
    def apply(self, f: TensorFrame) -> TensorFrame:
        with _obs.detailed_span(
            "pipeline.probe_chunk", rows=f.nrows, how=self.how
        ):
            return self._apply(f)

    def _apply(self, f: TensorFrame) -> TensorFrame:
        if self._fast is not None:
            codes = self._probe_codes(f)
            if codes is not None:
                mode, _, _, _, payload, domain = self._fast
                if mode == "member":
                    sb = payload
                    if int(sb.shape[0]) == 0:
                        exists = torch.zeros(
                            codes.shape, dtype=torch.bool, device=codes.device
                        )
                    else:
                        pos = torch.clamp(
                            torch.searchsorted(sb, codes), 0, sb.shape[0] - 1
                        )
                        exists = (sb[pos] == codes) & (codes >= 0)
                    return f.mask_rows(
                        exists if self.how == "semi" else ~exists
                    )
                # direct-address inner probe against the prebuilt table
                probe_idx = torch.where(
                    codes >= 0,
                    torch.clamp(codes, max=max(0, domain - 1)),
                    domain + 1,
                )
                pos = payload[probe_idx]
                matched = pos >= 0
                # the one sync per chunk: the matched rows' count
                lrows = torch.nonzero(matched)[:, 0].to(INT)
                rrows = pos[lrows]
                name_map = _right_name_map(
                    f, self.build, self._drop_right(), self.suffix
                )
                return _hstack(
                    f.take(lrows), self.build.take(rrows), name_map
                )
        STATS["generic_probes"] += 1
        return f.join(
            self.build,
            left_on=self.probe_keys,
            right_on=self.build_keys,
            how=self.how,
            suffix=self.suffix,
        )

    def _drop_right(self) -> List[str]:
        return [
            rk
            for lk, rk in zip(self.probe_keys, self.build_keys)
            if lk == rk
        ]


# ----------------------------------------------------------------------
# streaming group-by aggregation
# ----------------------------------------------------------------------
_PARTIAL_MERGE = {"sum": "sum", "count": "sum", "size": "sum",
                  "min": "min", "max": "max"}

STREAMABLE_AGGS = frozenset(("sum", "count", "size", "min", "max", "mean"))


class StreamAgg:
    """Accumulate per-chunk partial aggregates; merge under the budget.

    ``specs`` are engine agg specs ``(out_name, fn, column)`` with
    ``fn`` in ``STREAMABLE_AGGS``.  Mean decomposes into sum+count
    partials and reassembles at finalize.  Keyed partials are host
    blocks registered with the spill manager — under a tight
    ``CONFIG.memory_budget_bytes`` they spill to ``.tfb`` and re-hydrate
    at each merge; keyless aggregates fold into python scalars.  Merged
    and final frames are built on ``device`` (default ``CONFIG.device``;
    the caller passes its chunk frames' device).
    """

    def __init__(self, key_names: List[str], specs, device=None):
        self.key_names = list(key_names)
        self.device = resolve_device(device)
        self.partials: List[Tuple[str, str, str]] = []
        self.finals: List[Tuple[str, str, Tuple[str, ...]]] = []
        for idx, (out_name, fn, colname) in enumerate(specs):
            if fn not in STREAMABLE_AGGS:
                raise ValueError(f"cannot stream aggregate {fn!r}")
            if fn == "mean":
                ps, pc = f"__p{idx}s", f"__p{idx}c"
                self.partials.append((ps, "sum", colname))
                self.partials.append((pc, "count", colname))
                self.finals.append((out_name, "mean", (ps, pc)))
            else:
                pn = f"__p{idx}"
                self.partials.append((pn, fn, colname))
                self.finals.append((out_name, fn, (pn,)))
        self._order = self.key_names + [p for p, _, _ in self.partials]
        self._merge_specs = [
            (pn, _PARTIAL_MERGE[fn], pn) for pn, fn, _ in self.partials
        ]
        self._pending: List = []  # Spillable partial blocks
        self._pending_rebuilds: List = []  # parallel recompute closures
        self._merged = None  # Spillable holding the running merge
        self._merged_rebuild = None
        # keyless accumulators
        self._scalars: Dict[str, object] = {}
        self._scalar_rows = 0

    # -- keyed path -----------------------------------------------------
    def _partial_block(self, part: TensorFrame) -> Dict[str, np.ndarray]:
        return {name: part.column(name) for name in self._order}

    def add(self, f: TensorFrame, rebuild=None) -> None:
        """Fold one chunk frame in.  ``rebuild`` (optional, zero-arg)
        re-produces the chunk frame from durable inputs; when given,
        the spilled partial carries a recompute closure, so a corrupt
        spill block repairs itself instead of failing the query."""
        if f.nrows == 0:
            return
        from ..store.spill import SPILL

        if not self.key_names:
            self._add_scalar(f)
            return
        with _obs.detailed_span("pipeline.partial_agg", rows=f.nrows):
            part = f.groupby(self.key_names).agg(self.partials)
        block_rebuild = None
        if rebuild is not None:
            def block_rebuild(_rb=rebuild):
                p = _rb().groupby(self.key_names).agg(self.partials)
                return self._partial_block(p), {}
        self._pending.append(
            SPILL.register(self._partial_block(part), recompute=block_rebuild)
        )
        self._pending_rebuilds.append(block_rebuild)
        if len(self._pending) >= max(2, int(CONFIG.ooc_merge_every)):
            self._merge()

    def _merge_blocks(self, blocks) -> TensorFrame:
        if len(blocks) == 1:
            cat = blocks[0]
        else:
            cat = {
                name: np.concatenate([b[name] for b in blocks])
                for name in self._order
            }
        mf = TensorFrame.from_arrays(dict(cat), device=self.device)
        return mf.groupby(self.key_names).agg(self._merge_specs)

    def _merge(self) -> None:
        if not self._pending and self._merged is None:
            return
        with _obs.span("pipeline.merge_partials") as sp:
            blocks = []
            handles = list(self._pending)
            rebuilds = list(self._pending_rebuilds)
            if self._merged is not None:
                handles.append(self._merged)
                rebuilds.append(self._merged_rebuild)
            sp.set(partials=len(handles))
            for h in handles:
                data, _ = h.get()
                blocks.append(data)
                h.release()
            merged = self._merge_blocks(blocks)
            merged_rebuild = None
            if rebuilds and all(rb is not None for rb in rebuilds):
                # a merged block rebuilds by recomputing every
                # contributing partial and re-merging
                def merged_rebuild(_rbs=tuple(rebuilds)):
                    parts = [rb()[0] for rb in _rbs]
                    return self._partial_block(self._merge_blocks(parts)), {}
            from ..store.spill import SPILL

            self._merged = SPILL.register(
                self._partial_block(merged), recompute=merged_rebuild
            )
            self._merged_rebuild = merged_rebuild
            self._pending = []
            self._pending_rebuilds = []
            STATS["partial_merges"] += 1

    # -- keyless path ---------------------------------------------------
    def _add_scalar(self, f: TensorFrame) -> None:
        got = f.agg(self.partials)
        self._scalar_rows += f.nrows
        for pn, fn, _ in self.partials:
            v = got[pn]
            if pn not in self._scalars:
                self._scalars[pn] = v
            elif fn in ("sum", "count", "size"):
                self._scalars[pn] = self._scalars[pn] + v
            elif fn == "min":
                self._scalars[pn] = min(self._scalars[pn], v)
            else:  # max
                self._scalars[pn] = max(self._scalars[pn], v)

    # -- finalize -------------------------------------------------------
    def finalize(self) -> Optional[TensorFrame]:
        from .expr import col

        if not self.key_names:
            if self._scalar_rows == 0:
                return None  # caller falls back to the eager empty path
            out: Dict[str, np.ndarray] = {}
            for out_name, fn, pns in self.finals:
                if fn == "mean":
                    s, c = self._scalars[pns[0]], self._scalars[pns[1]]
                    v = float(s) / c if c else float("nan")
                else:
                    v = self._scalars[pns[0]]
                out[out_name] = np.asarray([v])
            return TensorFrame.from_arrays(out, device=self.device)
        self._merge()
        if self._merged is None:
            return None
        data, _ = self._merged.get()
        self._merged.release()
        self._merged = None
        mf = TensorFrame.from_arrays(dict(data), device=self.device)
        rename: Dict[str, str] = {}
        for out_name, fn, pns in self.finals:
            if fn == "mean":
                mf = mf.with_column(out_name, col(pns[0]) / col(pns[1]))
            else:
                rename[pns[0]] = out_name
        mf = mf.rename(rename)
        return mf.select(
            self.key_names + [out_name for out_name, _, _ in self.finals]
        )
