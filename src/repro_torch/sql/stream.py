"""Chunk-streaming lowering for Aggregate-over-store-scan plans.

``try_stream_aggregate`` recognizes the morsel-friendly plan shape

    Aggregate
      └─ {Filter | Join(probe=left, build=right)}*
           └─ Scan(store-backed table)

and executes it through ``repro_torch.core.pipeline`` instead of the
eager lowering: the probe scan streams chunk by chunk (prefetching
decode while the device computes), each join's build side is lowered
eagerly ONCE and probed per chunk (``HashBuild``), and the aggregate
folds into spill-managed partials merged every ``CONFIG.ooc_merge_every``
chunks (``StreamAgg``).  Peak device memory is bounded by chunk size +
build sides + the partials, not by the scan's row count.

Gating (``CONFIG.out_of_core``): ``off`` never streams; ``auto``
streams when the probe table has at least ``CONFIG.ooc_min_rows`` rows;
``force`` streams whenever the plan shape allows — the mode the
memory-capped run (``repro_torch.launch.run_capped``) uses.  Returns
``None`` to fall back to the eager lowering when the shape doesn't
match: unsupported aggregate functions, probe columns carrying null
bitmaps (partial re-aggregation would need null-preserving key
transport), aggregate outputs shadowing group keys, or a non-store
probe source.

Chunk frames, build sides and the merged result land on ``device``
(the caller's, else ``CONFIG.device``).
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.core import TensorFrame
from repro_torch.core.config import CONFIG
from repro_torch.store import Table as StoreTable

from .plan import Aggregate, Filter, Join, Scan


def try_stream_aggregate(
    node: Aggregate, frames: Dict, _memo=None, device=None
) -> Optional[TensorFrame]:
    mode = CONFIG.out_of_core
    if mode == "off":
        return None
    # unsupported aggregate functions / key-shadowing outputs
    from repro_torch.core import pipeline

    for _, fn, _ in node.aggs:
        if fn not in pipeline.STREAMABLE_AGGS:
            return None
    key_names = [name for name, _ in node.keys]
    if set(key_names) & {name for name, _, _ in node.aggs}:
        return None

    # walk the probe chain: Filter/Join links down to a store Scan
    chain: List = []
    cur = node.child
    while True:
        if isinstance(cur, Filter):
            chain.append(cur)
            cur = cur.child
        elif isinstance(cur, Join) and cur.how in (
            "inner",
            "left",
            "semi",
            "anti",
        ):
            chain.append(cur)
            cur = cur.left
        elif isinstance(cur, Scan):
            break
        else:
            return None
    src = frames.get(cur.table)
    if not isinstance(src, StoreTable):
        return None
    if mode == "auto" and src.nrows < CONFIG.ooc_min_rows:
        return None
    # conservative null gate: partial blocks round-trip through host
    # dicts, which cannot carry key/value nulls faithfully yet
    for c in cur.columns:
        if src.columns[c].has_validity():
            return None

    from .lower import _scan_pred, lower_plan, prepare_aggregate_inputs, to_expr

    try:
        preds = [_scan_pred(c, cur.alias) for c in cur.predicates]
    except Exception:
        return None

    # build sides lower eagerly, ONCE, before any chunk streams
    ops: List = []  # bottom-up ("filter", expr) | ("join", HashBuild)
    for link in reversed(chain):
        if isinstance(link, Filter):
            ops.append(("filter", to_expr(link.pred)))
        else:
            build = lower_plan(link.right, frames, _memo, device=device)
            ops.append(
                (
                    "join",
                    pipeline.HashBuild(
                        list(link.left_keys),
                        build,
                        list(link.right_keys),
                        link.how,
                    ),
                )
            )

    from repro_torch import obs

    ren = {c: f"{cur.alias}.{c}" for c in cur.columns}
    cs = pipeline.ChunkScan(src, list(cur.columns), preds, device=device)
    sagg: Optional[pipeline.StreamAgg] = None

    def _make_rebuild(idx: int):
        """Recompute closure for one chunk's aggregate contribution:
        re-scan the chunk from the durable store and replay the op
        chain (``disjoint`` is only a fast path, so a plain replay is
        result-identical).  Carried by the chunk's spilled partial so
        a corrupt spill block repairs itself (``spill.corrupt_blocks``
        / ``spill.recomputes``)."""

        def rebuild() -> TensorFrame:
            from repro_torch import store as _store

            res = _store.scan_chunk(src, cs.proj, cs.phys_preds, int(idx))
            f = TensorFrame.from_store(
                src, cs.proj, [], result=res, device=cs.device
            ).rename(ren)
            for kind, op in ops:
                f = f.filter(op) if kind == "filter" else op.apply(f)
            return prepare_aggregate_inputs(node, f)[0]

        return rebuild

    with obs.span(
        "pipeline.stream_agg", table=cur.table, chunks=len(cs)
    ):
        for chunk_idx, f in cs.iter_indexed():
            f = f.rename(ren)
            for kind, op in ops:
                if kind == "filter":
                    f = f.filter(op)
                else:
                    hb = op
                    if hb.disjoint(f):
                        # zone-map bounds prove no key matches this chunk
                        if hb.how == "anti":
                            continue  # every row survives, unprobed
                        if hb.how in ("inner", "semi"):
                            pipeline.STATS["chunks_pruned"] += 1
                            f = None
                            break
                    f = hb.apply(f)
                if f.nrows == 0:
                    f = None
                    break
            if f is None:
                continue
            f, keys, specs = prepare_aggregate_inputs(node, f)
            if sagg is None:
                sagg = pipeline.StreamAgg(keys, specs, device=cs.device)
            sagg.add(f, rebuild=_make_rebuild(chunk_idx))
        pipeline.STATS["pipelines"] += 1
        pipeline.sync_spill_stats()
        if sagg is None:
            pipeline.STATS["fallbacks"] += 1
            return None  # nothing streamed (empty scan): eager path cheap
        out = sagg.finalize()
        if out is None:
            pipeline.STATS["fallbacks"] += 1
        return out
