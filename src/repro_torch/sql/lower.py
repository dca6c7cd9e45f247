"""Lower the logical plan onto TensorFrame operators.

Plan nodes map 1:1 onto the engine: Scan -> select+rename, Filter ->
``filter``, Join -> ``join``, Aggregate -> ``with_column`` (expression
materialization) + ``groupby``/``agg``, Project -> ``with_column`` +
``select``/``rename``, Sort -> ``sort_values``, Limit -> ``head``.

SQL expressions translate to the core trait-based ``Expr`` combinators,
so evaluation inherits every engine fast path (dictionary LUTs, packed
string kernels, fused arithmetic).

Frames the lowering builds itself land on one device: raw dict-of-numpy
scope entries and store-backed Scans on ``device`` (the caller's, else
``CONFIG.device``; a CUDA device with no card raises), a global
aggregate's one-row result on its input frame's device.
"""
from __future__ import annotations

import contextvars
import dataclasses
import time
from typing import Dict, List

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import TensorFrame, col, if_else, lit
from repro_torch.resilience import checkpoint as _checkpoint
from repro_torch.resilience.faults import fault_point as _fault_point
from repro_torch.core.expr import DateLit, Expr
from repro_torch.store import Pred as StorePred, Table as StoreTable

from .parser import (
    Boxed,
    SqlError,
    SBetween,
    SBin,
    SCase,
    SCmp,
    SCol,
    SDate,
    SExtract,
    SFunc,
    SIn,
    SInterval,
    SIsNull,
    SLike,
    SLit,
    SNot,
    SOr,
    SAnd,
    format_expr,
    like_prefix,
)
from .plan import (
    Aggregate,
    AttachScalar,
    Distinct,
    Filter,
    Join,
    Limit,
    Project,
    SOuter,
    SUBQUERY_MARKERS,
    Scan,
    Shared,
    Sort,
)


def _check_entry(name: str, obj) -> None:
    if not isinstance(obj, (TensorFrame, StoreTable, dict)):
        raise SqlError(
            f"scope entry {name!r} must be a TensorFrame, a "
            f"repro_torch.store.Table, or a dict of numpy arrays, not "
            f"{type(obj).__name__}"
        )


def scope_frames(scope: Dict, device=None) -> Dict:
    """Accept TensorFrames, store tables, or raw dict-of-numpy tables.

    Raw dicts become frames on ``device`` (default ``CONFIG.device``).
    ``repro_torch.store.Table`` entries stay chunked: their Scans lower
    through ``TensorFrame.from_store`` with any pushed predicates, so
    zone-map chunk skipping happens before tensors materialize.
    """
    out = {}
    for name, obj in scope.items():
        _check_entry(name, obj)
        if isinstance(obj, dict):
            obj = TensorFrame.from_arrays(obj, device=device)
        out[name] = obj
    return out


def scope_catalog(scope: Dict) -> Dict[str, List[str]]:
    """Table name -> column names, without building any frame: planning
    reads names only, so it never touches a device."""
    out = {}
    for name, obj in scope.items():
        _check_entry(name, obj)
        out[name] = list(obj) if isinstance(obj, dict) else list(obj.column_names)
    return out


def store_table_names(scope: Dict) -> frozenset:
    """Scope entries backed by chunked store tables (scan pushdown
    targets for the optimizer)."""
    return frozenset(
        name for name, obj in scope.items() if isinstance(obj, StoreTable)
    )


def _active_udfs():
    from .udf import active_udfs

    return active_udfs()


def scan_cache_key(node) -> tuple:
    """Hashable identity of a store-backed Scan's physical read:
    (table, sorted projection, physical predicates).  Alias-agnostic —
    two queries scanning the same table through different aliases with
    equal predicates share one cache entry.  The serving layer builds
    shared-scan results under these keys; ``lower_plan`` consumes them
    through its ``scan_cache``."""
    preds = tuple(_scan_pred(c, node.alias) for c in node.predicates)
    return (node.table, tuple(sorted(node.columns)), preds)


# ----------------------------------------------------------------------
# expression translation
# ----------------------------------------------------------------------
_CMP_OPS = {
    "=": lambda a, b: a == b,
    "<>": lambda a, b: a != b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
}

_BIN_OPS = {
    "+": lambda a, b: a + b,
    "-": lambda a, b: a - b,
    "*": lambda a, b: a * b,
    "/": lambda a, b: a / b,
}

_SCALAR_FNS = ("abs", "sqrt", "floor", "exp", "log", "sin", "cos")


def _literal_value(e):
    if isinstance(e, SLit):
        return e.value
    if isinstance(e, SDate):
        return int(e.days)
    raise SqlError(f"IN list supports only literals, got {format_expr(e)}")


def to_expr(e) -> Expr:
    """SQL expression AST -> core trait Expr."""
    if hasattr(e, "to_core_expr"):
        # bound plan parameters (repro_torch.sql.compile) lower themselves:
        # their payload is a device scalar that must not reach lit()
        return e.to_core_expr()
    if isinstance(e, SCol):
        return col(e.internal)
    if isinstance(e, SLit):
        if e.value is None:
            raise SqlError("bare NULL literal is not supported here")
        return lit(e.value)
    if isinstance(e, SDate):
        return DateLit(e.days)
    if isinstance(e, SInterval):
        return lit(e.days)
    if isinstance(e, SBin):
        return _BIN_OPS[e.op](to_expr(e.a), to_expr(e.b))
    if isinstance(e, SCmp):
        return _CMP_OPS[e.op](to_expr(e.a), to_expr(e.b))
    if isinstance(e, SAnd):
        return to_expr(e.a) & to_expr(e.b)
    if isinstance(e, SOr):
        return to_expr(e.a) | to_expr(e.b)
    if isinstance(e, SNot):
        return ~to_expr(e.a)
    if isinstance(e, SIn):
        out = to_expr(e.e).isin([_literal_value(v) for v in e.values])
        return ~out if e.negated else out
    if isinstance(e, SBetween):
        out = to_expr(e.e).between(to_expr(e.lo), to_expr(e.hi))
        return ~out if e.negated else out
    if isinstance(e, SLike):
        out = to_expr(e.e).str.like(e.pattern)
        return ~out if e.negated else out
    if isinstance(e, SIsNull):
        out = to_expr(e.e).is_null()
        return ~out if e.negated else out
    if isinstance(e, SCase):
        if e.default == SLit(None):
            raise SqlError("CASE requires an ELSE branch")
        acc = to_expr(e.default)
        for cond, res in reversed(e.whens):
            acc = if_else(to_expr(cond), to_expr(res), acc)
        return acc
    if isinstance(e, SExtract):
        dt = to_expr(e.e).dt
        return {"year": dt.year, "month": dt.month, "day": dt.day}[e.field]()
    if isinstance(e, SFunc):
        if e.is_aggregate:
            raise SqlError(
                f"aggregate {e.name.upper()} outside GROUP BY context"
            )
        if e.name == "substring":
            return _lower_substring(e)
        if e.name in _SCALAR_FNS and len(e.args) == 1:
            return getattr(to_expr(e.args[0]), e.name)()
        udf = _active_udfs().get(e.name)
        if udf is not None:
            from .udf import UdfCall

            return UdfCall(udf, tuple(to_expr(a) for a in e.args))
        raise SqlError(f"unsupported function {e.name.upper()}")
    if isinstance(e, SUBQUERY_MARKERS):
        raise SqlError(
            f"subquery {e.name} was not decorrelated; the TensorFrame "
            f"backend cannot interpret subqueries — run with the "
            f"optimizer's decorrelation pass enabled"
        )
    if isinstance(e, SOuter):
        raise SqlError(
            f"unresolved correlated reference {e.internal}; the plan "
            f"was not decorrelated"
        )
    raise SqlError(f"cannot lower expression {format_expr(e)}")


_FLIP_CMP = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "=": "=", "<>": "<>"}


def _scan_pred(c, alias: str) -> StorePred:
    """One sargable SQL conjunct -> a store predicate.

    Store predicates use the table's unqualified column names and plain
    python constants (dates as int days)."""
    strip = alias + "."

    def name(e: SCol) -> str:
        return e.internal[len(strip):] if e.internal.startswith(strip) else e.internal

    def const(e):
        return int(e.days) if isinstance(e, SDate) else e.value

    if isinstance(c, SCmp):
        if isinstance(c.a, SCol):
            return StorePred(name(c.a), c.op, const(c.b))
        return StorePred(name(c.b), _FLIP_CMP[c.op], const(c.a))
    if isinstance(c, SBetween):
        return StorePred(name(c.e), "between", (const(c.lo), const(c.hi)))
    if isinstance(c, SIn):
        return StorePred(name(c.e), "in", tuple(const(v) for v in c.values))
    if isinstance(c, SIsNull):
        return StorePred(name(c.e), "notnull" if c.negated else "isnull")
    if isinstance(c, SLike):
        prefix = like_prefix(c.pattern)
        if prefix is None or c.negated:
            raise SqlError(
                f"cannot push non-prefix LIKE {format_expr(c)} into a scan"
            )
        return StorePred(name(c.e), "like", prefix)
    raise SqlError(f"cannot push predicate {format_expr(c)} into a scan")


def _lower_substring(e: SFunc) -> Expr:
    if len(e.args) != 3:
        raise SqlError("SUBSTRING takes (string, start, length)")
    _, start, length = e.args
    if not (isinstance(start, SLit) and isinstance(length, SLit)):
        raise SqlError("SUBSTRING start/length must be integer literals")
    lo = int(start.value) - 1  # SQL is 1-based
    return to_expr(e.args[0]).str.slice(lo, lo + int(length.value))


# ----------------------------------------------------------------------
# plan lowering
# ----------------------------------------------------------------------
#: EXPLAIN ANALYZE collector (repro_torch.sql.analyze) for the current
#: execution context; None = plain execution.
ANALYZE_COLLECTOR: contextvars.ContextVar = contextvars.ContextVar(
    "repro_sql_analyze", default=None
)


def lower_plan(
    node, frames: Dict[str, TensorFrame], _memo=None, scan_cache=None, device=None
) -> TensorFrame:
    """Execute ``node`` op-by-op.  With tracing on (``CONFIG.tracing``)
    every plan node records an ``sql.exec.<Node>`` span; with an
    EXPLAIN ANALYZE collector active it additionally records per-node
    wall time, output rows, and bytes (``repro_torch.sql.analyze``).
    Store-backed Scans materialize on ``device`` (default
    ``CONFIG.device``)."""
    if _memo is None:
        # Shared subplan -> frame (structural key); alias-free key of an
        # Aggregate -> (its node, its frame)
        _memo = {}
    # operator-granularity resilience hooks: a cancel/deadline fires
    # between plan nodes, and the chaos suite can crash any operator
    _checkpoint("sql.exec")
    _fault_point("exec.operator")
    coll = ANALYZE_COLLECTOR.get()
    if coll is None and not obs.enabled():
        return _lower_node(node, frames, _memo, scan_cache, device)
    rows_in = None
    if isinstance(node, Scan):
        rows_in = getattr(frames.get(node.table), "nrows", None)
    with obs.span("sql.exec." + type(node).__name__) as sp:
        t0 = time.perf_counter_ns()
        out = _lower_node(node, frames, _memo, scan_cache, device)
        if coll is not None:
            coll.block(out)  # settle async dispatch: honest wall time
        dt = time.perf_counter_ns() - t0
        rows = getattr(out, "nrows", None)
        if rows is not None:
            sp.set(rows=rows)
        if coll is not None:
            coll.record(node, dt, out, sp.span_id, rows_in=rows_in)
    return out


def _lower_node(
    node, frames: Dict[str, TensorFrame], _memo, scan_cache, device
) -> TensorFrame:
    if isinstance(node, Shared):
        if node not in _memo:
            _memo[node] = lower_plan(node.child, frames, _memo, scan_cache, device)
        return _memo[node]
    if isinstance(node, Scan):
        try:
            src = frames[node.table]
        except KeyError:
            raise SqlError(
                f"table {node.table!r} missing from scope; have "
                f"{sorted(frames)}"
            ) from None
        if isinstance(src, StoreTable):
            f = scan_cache.get(scan_cache_key(node)) if scan_cache else None
            if f is None:
                preds = [_scan_pred(c, node.alias) for c in node.predicates]
                f = TensorFrame.from_store(
                    src, list(node.columns), preds, device=device
                )
            else:
                # shared-scan result: materialized once per micro-batch
                # by the caller, projected down to this Scan's columns
                f = f.select(list(node.columns))
            return f.rename({c: f"{node.alias}.{c}" for c in node.columns})
        f = src.select(list(node.columns))
        f = f.rename({c: f"{node.alias}.{c}" for c in node.columns})
        if node.predicates:
            # defensive: predicates only land on store-backed scans,
            # but an in-memory frame can still apply them as a filter
            pred = node.predicates[0]
            for c in node.predicates[1:]:
                pred = SAnd(pred, c)
            f = f.filter(to_expr(pred))
        return f
    if isinstance(node, Filter):
        return lower_plan(node.child, frames, _memo, scan_cache, device).filter(to_expr(node.pred))
    if isinstance(node, Join):
        left = lower_plan(node.left, frames, _memo, scan_cache, device)
        right = lower_plan(node.right, frames, _memo, scan_cache, device)
        return left.join(
            right,
            left_on=list(node.left_keys),
            right_on=list(node.right_keys),
            how=node.how,
        )
    if isinstance(node, Aggregate):
        # An aggregate the query spells twice under other aliases (TPC-H
        # q15's revenue view, once as the FROM item and once in the
        # scalar subquery compared with it for equality) is computed
        # once: K1's float sums on the card add in an order that
        # changes from launch to launch, so two computations can differ
        # in their last bits.
        key = ("aggregate", alias_free_key(node))
        if key in _memo:
            first, f = _memo[key]
            return f.rename(dict(zip(_output_names(first), _output_names(node))))
        f = None
        if scan_cache is None:
            # out-of-core: group-by-aggregates over store-backed scan
            # chains can run chunk-streamed instead of materializing
            # the whole scan (repro_torch.sql.stream decides; returns
            # None when the plan shape or CONFIG gates it off)
            from . import stream as _stream

            f = _stream.try_stream_aggregate(node, frames, _memo, device)
        if f is None:
            f = _lower_aggregate(node, lower_plan(node.child, frames, _memo, scan_cache, device))
        _memo[key] = (node, f)
        return f
    if isinstance(node, Project):
        return _lower_project(node, lower_plan(node.child, frames, _memo, scan_cache, device))
    if isinstance(node, Sort):
        f = lower_plan(node.child, frames, _memo, scan_cache, device)
        return f.sort_values([n for n, _ in node.keys], [a for _, a in node.keys])
    if isinstance(node, Limit):
        return lower_plan(node.child, frames, _memo, scan_cache, device).head(node.n)
    if isinstance(node, Distinct):
        f = lower_plan(node.child, frames, _memo, scan_cache, device)
        cols = list(f.column_names)
        # keep first-occurrence row order (stable, like the oracle's
        # seen-set scan) so a later Sort+LIMIT breaks ties identically
        rep = torch.sort(f.groupby(cols).rep, stable=True).values
        return f.take(rep, stats="subset").select(cols)
    if isinstance(node, AttachScalar):
        f = lower_plan(node.child, frames, _memo, scan_cache, device)
        sub = lower_plan(node.sub.v, frames, _memo, scan_cache, device)
        if sub.nrows > 1:
            raise SqlError(
                f"scalar subquery {node.name} returned {sub.nrows} rows"
            )
        arr = np.asarray(sub.column(node.output))
        if sub.nrows == 0:
            if arr.dtype.kind in "OUS":
                # no NULL string literal exists in the engine
                raise SqlError(
                    f"string scalar subquery {node.name} returned no rows "
                    f"(NULL string constants are not supported)"
                )
            # zero rows -> NULL; NaN makes every comparison false,
            # matching the oracle's None semantics
            return f.with_column(node.name, lit(float("nan")))
        v = arr[0]
        if arr.dtype.kind == "f":
            v = float(v)
        elif arr.dtype.kind in "iu":
            v = int(v)
        elif arr.dtype.kind == "b":
            v = bool(v)
        else:  # string/object dictionary column
            v = str(v)
        return f.with_column(node.name, lit(v))
    raise TypeError(f"unknown plan node {type(node).__name__}")


_PLAN_NODES = (Scan, Filter, Join, Aggregate, Project, Sort, Limit, Distinct, AttachScalar, Shared)


def plan_nodes(node):
    """Every node of a plan tree, the subplans of attached scalars too."""
    yield node
    if isinstance(node, AttachScalar):
        yield from plan_nodes(node.sub.v)
    for attr in ("child", "left", "right"):
        child = getattr(node, attr, None)
        if child is not None:
            yield from plan_nodes(child)


def alias_free_key(root) -> tuple:
    """A hashable form of the subplan ``root`` in which each table and
    derived-table alias it binds is replaced by its rank of first
    appearance: subplans that differ only in their aliases get one key.

    Only names are rewritten: a Scan's alias, an SCol's qualifier and
    the qualified column names of plan nodes (keys, outputs, join and
    sort keys); literals, patterns and operators are compared as they
    are."""
    ranks: Dict[str, int] = {}
    for node in plan_nodes(root):
        if isinstance(node, Scan):
            ranks.setdefault(node.alias, len(ranks))
        elif isinstance(node, Project):
            for out, _ in node.outputs:
                head, dot, _ = out.partition(".")
                if dot:
                    ranks.setdefault(head, len(ranks))

    def name(s: str):
        head, dot, rest = s.partition(".")
        return ("$", ranks[head], rest) if dot and head in ranks else s

    def node_field(v):  # strings among a plan node's fields are column names
        if isinstance(v, str):
            return name(v)
        if isinstance(v, tuple):
            return tuple(node_field(x) for x in v)
        return canon(v)

    def canon(x):
        if isinstance(x, Scan):
            return ("Scan", x.table, ranks[x.alias], x.columns, canon(x.predicates))
        if isinstance(x, SCol):
            return ("SCol", ("$", ranks[x.table]) if x.table in ranks else x.table, x.name)
        if isinstance(x, Boxed):
            return ("Boxed", canon(x.v))
        if isinstance(x, _PLAN_NODES):
            return (type(x).__name__,) + tuple(
                node_field(getattr(x, f.name)) for f in dataclasses.fields(x))
        if dataclasses.is_dataclass(x):
            return (type(x).__name__,) + tuple(
                canon(getattr(x, f.name)) for f in dataclasses.fields(x))
        if isinstance(x, tuple):
            return tuple(canon(v) for v in x)
        return (type(x).__name__, x)  # 1, 1.0 and True stay apart

    return canon(root)


def _output_names(node: Aggregate) -> List[str]:
    return [name for name, _ in node.keys] + [name for name, _, _ in node.aggs]


def prepare_aggregate_inputs(node: Aggregate, f: TensorFrame):
    """Materialize an Aggregate's key and input expressions on ``f``.

    Returns ``(frame, key_names, specs)`` with ``specs`` in engine
    ``(out_name, fn, column)`` form.
    """
    key_names: List[str] = []
    for name, e in node.keys:
        if not (isinstance(e, SCol) and e.internal == name and f.has_column(name)):
            f = f.with_column(name, to_expr(e))
        key_names.append(name)
    specs = []
    for name, fn, e in node.aggs:
        if fn == "size":
            specs.append((name, "size", ""))
            continue
        if isinstance(e, SCol) and f.has_column(e.internal):
            colname = e.internal
        else:
            colname = f"__in.{name}"
            f = f.with_column(colname, to_expr(e))
        specs.append((name, fn, colname))
    return f, key_names, specs


def _lower_aggregate(node: Aggregate, f: TensorFrame) -> TensorFrame:
    f, key_names, specs = prepare_aggregate_inputs(node, f)
    if key_names:
        return f.groupby(key_names).agg(specs)
    scalars = f.agg(specs)
    return TensorFrame.from_arrays(
        {name: np.asarray([scalars[name]]) for name, _, _ in specs},
        device=f.device,
    )


def _lower_project(node: Project, f: TensorFrame) -> TensorFrame:
    srcs: List[str] = []
    mapping: Dict[str, str] = {}
    used = set()
    for i, (name, e) in enumerate(node.outputs):
        if (
            isinstance(e, SCol)
            and f.has_column(e.internal)
            and e.internal not in used
        ):
            src = e.internal
        else:
            src = f"__o.{i}.{name}"
            f = f.with_column(src, to_expr(e))
        used.add(src)
        srcs.append(src)
        mapping[src] = name
    return f.select(srcs).rename(mapping)
