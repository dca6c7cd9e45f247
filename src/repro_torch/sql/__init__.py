"""SQL front-end over the port's TensorFrame (framequery-style,
Petersohn et al.).

A declarative surface for the relational engine: ``SELECT`` text is
tokenized and parsed (``parser``), compiled to a logical plan of
dataclass nodes (``plan``), rewritten by a rule-based optimizer —
constant folding, decorrelation, filter and scan pushdown, projection
pruning (``optimize``) — and lowered op by op onto the TensorFrame
operators ``filter``/``join``/``groupby``/``sort_values``/``with_column``
(``lower``), or compiled whole into one captured CUDA graph per plan
(``compile``, under ``CONFIG.compiled``).  ``oracle_backend``
interprets the *unoptimized* plan row-at-a-time on
``repro_torch.core.oracle`` for differential testing.

Public API::

    from repro_torch import sql

    out = sql.execute("SELECT a, SUM(b) AS s FROM t GROUP BY a", {"t": frame})
    print(sql.explain("SELECT ...", {"t": frame}))

Queries run on the device of the frames in ``scope``; raw dict-of-numpy
entries and store tables materialize on ``device=`` (default
``CONFIG.device``, the card; ``device="cpu"`` asks for the CPU).
"""
from __future__ import annotations

from typing import Dict

from .parser import SqlError, parse
from .plan import build_plan, format_plan
from .optimize import decorrelate as _decorrelate
from .optimize import optimize as _optimize
from .lower import lower_plan, scope_catalog, scope_frames, store_table_names

__all__ = [
    "SqlError",
    "execute",
    "execute_plan",
    "explain",
    "parse",
    "plan_query",
]


def plan_query(query: str, scope: Dict, *, optimized: bool = True):
    """Parse + plan (+ optionally optimize) ``query`` against ``scope``.

    ``scope`` maps table name -> TensorFrame, ``repro_torch.store.Table``,
    or dict of numpy arrays; only column names are consulted here, so
    any of them works and nothing is built on a device.  Store-backed
    tables additionally enable the optimizer's scan-pushdown rule
    (sargable conjuncts move into the Scan and are answered with zone
    maps).
    """
    plan = build_plan(parse(query), scope_catalog(scope))
    if optimized:
        return _optimize(plan, store_tables=store_table_names(scope))
    return plan


def execute(
    query: str, scope: Dict, *, optimize: bool = True, explain=None, device=None
):
    """Run a SQL ``SELECT`` over a scope of TensorFrames/store tables.

    Returns a TensorFrame (aggregate-only queries yield one row).
    ``optimize=False`` skips constant folding, filter pushdown,
    scan pushdown and projection pruning, but still decorrelates
    subqueries — the TensorFrame backend has no interpreted-subquery
    path (only the oracle backend interprets markers, row at a time).
    ``device`` places raw dict entries and store scans (default
    ``CONFIG.device``); frames in ``scope`` stay where they are.

    ``explain="analyze"`` executes the optimized plan op-by-op with
    span tracing forced on and returns an ``analyze.AnalyzeResult``:
    the result frame plus the plan tree annotated with per-operator
    wall time, row counts, bytes materialized and — for joins — the
    algorithm the stats-driven picker chose.  Each node waits for the
    card before its clock stops, so analyzed timings attribute work
    but are not production latencies.
    """
    frames = scope_frames(scope, device)
    plan = plan_query(query, frames, optimized=False)
    if explain is not None:
        if explain != "analyze":
            raise SqlError(
                f"unsupported explain mode {explain!r} (expected 'analyze')"
            )
        from .analyze import run_analyze

        plan = _optimize(plan, store_tables=store_table_names(frames))
        return run_analyze(plan, frames, device=device)
    if optimize:
        plan = _optimize(plan, store_tables=store_table_names(frames))
        return execute_plan(plan, frames, device=device)
    plan = _decorrelate(plan)
    return lower_plan(plan, frames, device=device)


def execute_plan(plan, frames: Dict, *, scan_cache=None, device=None):
    """Execute an already-optimized plan against resolved frames.

    Under ``CONFIG.compiled`` (``auto`` by default) the plan first tries
    the compiled whole-plan path (``compile``: one captured CUDA graph
    per plan on the card), which declines store-backed scans, session
    UDFs, small inputs (``auto``) and plans it cannot trace; the rest
    run op by op (under ``CONFIG.out_of_core = "force"`` every plan
    does, so its store aggregates stream chunk by chunk).
    ``scan_cache`` maps ``lower.scan_cache_key`` ->
    pre-materialized TensorFrame of a store-backed Scan (a shared scan
    made once for several plans); the compiled path is skipped when a
    cache is supplied (it performs its own scans).  ``device`` places
    the other store scans (default ``CONFIG.device``).
    """
    from ..core.config import CONFIG

    # out_of_core=force must reach the chunk-streaming lowering: the
    # compiled path materializes whole scans inside its captured graph
    if (
        CONFIG.compiled != "off"
        and CONFIG.out_of_core != "force"
        and not scan_cache
    ):
        from . import compile as _compile

        out = _compile.maybe_execute_compiled(plan, frames)
        if out is not None:
            return out
    return lower_plan(plan, frames, scan_cache=scan_cache, device=device)


def explain(query: str, scope: Dict) -> str:
    """Pre- and post-optimization logical plans, as printable text."""
    naive = plan_query(query, scope, optimized=False)
    opt = _optimize(naive, store_tables=store_table_names(scope))
    return (
        "== logical plan ==\n"
        + format_plan(naive)
        + "\n== optimized plan ==\n"
        + format_plan(opt)
    )
