"""Row-at-a-time plan interpreter over ``repro_torch.core.oracle``.

Runs the (by default unoptimized) logical plan on the independent
oracle engine: Python lists, per-row expression evaluation, None as
NULL.  Used by the differential tests as the third leg of the
SQL-vs-hand-written-vs-oracle comparison — it shares the parser/planner
with the TensorFrame path but none of the execution machinery, so a
lowering or optimizer bug shows up as a mismatch.

Subqueries are interpreted directly, nested-loop style: a planned
subquery marker re-executes its subplan for every outer row with the
row's values bound to the ``SOuter`` references — deliberately the
dumbest correct semantics, entirely independent of the optimizer's
decorrelation rewrites it cross-checks.  Executions are memoized per
distinct binding of the referenced outer columns so TPC-H-sized inputs
stay tractable.
"""
from __future__ import annotations

import datetime
import math
import re
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core import oracle as orc

from .parser import (
    SqlError,
    SAnd,
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
    conjoin,
    expr_columns,
    format_expr,
)
from .plan import (
    Aggregate,
    AttachScalar,
    Distinct,
    ExistsExpr,
    Filter,
    InSubExpr,
    Join,
    Limit,
    Project,
    SOuter,
    Scan,
    Sort,
    SubqueryExpr,
    plan_outer_refs,
)

_EPOCH = datetime.date(1970, 1, 1)


class _Ctx:
    """Interpreter context: the table scope, the outer-row binding for
    correlated subqueries, and caches shared across the whole query.

    ``in_sub`` marks execution inside a *correlated* subquery: there an
    empty SUM is NULL (standard SQL — an empty correlated group must
    fail its comparison, which is also what the decorrelated join
    rewrite produces).  The top level and uncorrelated subqueries keep
    the engine's pandas-style empty SUM = 0.0 so all three differential
    legs agree."""

    __slots__ = ("tables", "outer", "memo", "scans", "in_sub")

    def __init__(self, tables, outer=None, memo=None, scans=None, in_sub=False):
        self.tables = tables
        self.outer = outer or {}
        self.memo = memo if memo is not None else {}
        self.scans = scans if scans is not None else {}
        self.in_sub = in_sub

    def bound(self, row: dict, correlated: bool) -> "_Ctx":
        return _Ctx(
            self.tables,
            {**self.outer, **row},
            self.memo,
            self.scans,
            correlated,
        )


def _like_rx(pattern: str) -> "re.Pattern":
    parts = []
    for ch in pattern:
        if ch == "%":
            parts.append(".*")
        elif ch == "_":
            parts.append(".")
        else:
            parts.append(re.escape(ch))
    return re.compile("".join(parts), flags=re.S)


def _truthy(v) -> bool:
    return bool(v) if v is not None else False


def eval_row(e, row: dict, ctx: Optional[_Ctx] = None):
    """Evaluate a SQL expression on one row dict (None = NULL)."""
    if isinstance(e, SCol):
        return row[e.internal]
    if isinstance(e, SLit):
        return e.value
    if isinstance(e, (SDate, SInterval)):
        return e.days
    if isinstance(e, SOuter):
        if ctx is None or e.internal not in ctx.outer:
            raise SqlError(
                f"correlated reference {e.internal} has no outer binding"
            )
        return ctx.outer[e.internal]
    if isinstance(e, SubqueryExpr):
        sub = _run_subquery(e, row, ctx)
        n = orc.nrows(sub)
        if n == 0:
            return None
        if n > 1:
            raise SqlError(f"scalar subquery {e.name} returned {n} rows")
        return sub[e.output][0]
    if isinstance(e, InSubExpr):
        # join semantics, matching the semi/anti decorrelation (and the
        # engine's null-keys-never-match joins) rather than SQL's
        # three-valued NOT IN: NULLs on either side simply never match
        v = eval_row(e.e, row, ctx)
        if v is None:
            return e.negated
        hit = v in _run_subquery(e, row, ctx)[e.output]
        return hit != e.negated
    if isinstance(e, ExistsExpr):
        hit = orc.nrows(_run_subquery(e, row, ctx)) > 0
        return (not hit) if e.negated else hit
    if isinstance(e, SBin):
        a, b = eval_row(e.a, row, ctx), eval_row(e.b, row, ctx)
        if a is None or b is None:
            return None
        if e.op == "+":
            return a + b
        if e.op == "-":
            return a - b
        if e.op == "*":
            return a * b
        return a / b
    if isinstance(e, SCmp):
        a, b = eval_row(e.a, row, ctx), eval_row(e.b, row, ctx)
        if a is None or b is None:
            return None
        return {
            "=": a == b, "<>": a != b, "<": a < b,
            "<=": a <= b, ">": a > b, ">=": a >= b,
        }[e.op]
    if isinstance(e, SAnd):
        return _truthy(eval_row(e.a, row, ctx)) and _truthy(eval_row(e.b, row, ctx))
    if isinstance(e, SOr):
        return _truthy(eval_row(e.a, row, ctx)) or _truthy(eval_row(e.b, row, ctx))
    if isinstance(e, SNot):
        return not _truthy(eval_row(e.a, row, ctx))
    if isinstance(e, SIn):
        v = eval_row(e.e, row, ctx)
        if v is None:
            return None
        hit = v in tuple(eval_row(x, row, ctx) for x in e.values)
        return (not hit) if e.negated else hit
    if isinstance(e, SBetween):
        v = eval_row(e.e, row, ctx)
        lo, hi = eval_row(e.lo, row, ctx), eval_row(e.hi, row, ctx)
        if v is None or lo is None or hi is None:
            return None
        hit = lo <= v <= hi
        return (not hit) if e.negated else hit
    if isinstance(e, SLike):
        v = eval_row(e.e, row, ctx)
        if v is None:
            return None
        hit = bool(_like_rx(e.pattern).fullmatch(str(v)))
        return (not hit) if e.negated else hit
    if isinstance(e, SIsNull):
        v = eval_row(e.e, row, ctx)
        null = v is None or (isinstance(v, float) and math.isnan(v))
        return (not null) if e.negated else null
    if isinstance(e, SCase):
        for cond, res in e.whens:
            if _truthy(eval_row(cond, row, ctx)):
                return eval_row(res, row, ctx)
        return eval_row(e.default, row, ctx)
    if isinstance(e, SExtract):
        v = eval_row(e.e, row, ctx)
        if v is None:
            return None
        day = _EPOCH + datetime.timedelta(days=int(v))
        return {"year": day.year, "month": day.month, "day": day.day}[e.field]
    if isinstance(e, SFunc):
        if e.is_aggregate:
            raise SqlError("aggregate evaluated outside Aggregate node")
        if e.name == "substring":
            v = eval_row(e.args[0], row, ctx)
            if v is None:
                return None
            start = int(eval_row(e.args[1], row, ctx))
            length = int(eval_row(e.args[2], row, ctx))
            return str(v)[start - 1:start - 1 + length]
        v = eval_row(e.args[0], row, ctx)
        if v is None:
            return None
        fns = {
            "abs": abs, "sqrt": math.sqrt, "floor": math.floor,
            "exp": math.exp, "log": math.log, "sin": math.sin, "cos": math.cos,
        }
        if e.name not in fns:
            raise SqlError(f"unsupported function {e.name.upper()}")
        return fns[e.name](v)
    raise SqlError(f"oracle backend cannot evaluate {format_expr(e)}")


def _run_subquery(marker, row: dict, ctx: Optional[_Ctx]) -> orc.ODF:
    """Execute a planned subquery with the current row bound as the
    outer scope; memoized on the values of its outer references."""
    if ctx is None:
        raise SqlError("subquery evaluation needs an interpreter context")
    refs = ctx.memo.get(("refs", id(marker)))
    if refs is None:
        refs = plan_outer_refs(marker.plan.v)
        ctx.memo[("refs", id(marker))] = refs
    bound = ctx.bound(row, correlated=bool(refs))
    key = (id(marker),) + tuple(bound.outer.get(r) for r in refs)
    hit = ctx.memo.get(key)
    if hit is None:
        hit = _exec(marker.plan.v, bound)
        ctx.memo[key] = hit
    return hit


def _rows(df: orc.ODF) -> List[dict]:
    names = list(df)
    return [
        {k: df[k][i] for k in names} for i in range(orc.nrows(df))
    ]


def execute_oracle(plan, tables: Dict[str, Dict[str, np.ndarray]]) -> orc.ODF:
    """Interpret a logical plan on raw numpy tables via the oracle."""
    return _exec(plan, _Ctx(tables))


def _exec(plan, ctx: _Ctx) -> orc.ODF:
    if isinstance(plan, Scan):
        # correlated subqueries re-execute their subtree per outer
        # binding; the scan itself never depends on the binding, so
        # cache the converted table across executions
        cached = ctx.scans.get(id(plan))
        if cached is not None:
            return cached
        if plan.table not in ctx.tables:
            raise SqlError(f"table {plan.table!r} missing from scope")
        raw = ctx.tables[plan.table]
        df = orc.from_numpy({c: raw[c] for c in plan.columns})
        out = {f"{plan.alias}.{c}": v for c, v in df.items()}
        if plan.predicates:
            # predicates pushed into a (store-backed) scan left the
            # plan's Filters; interpreting them here keeps the oracle
            # usable on store-optimized plans too.  Pruning may have
            # narrowed the scan's output past the predicate columns, so
            # evaluate against a widened row view.
            need = {
                c.split(".", 1)[1]
                for p in plan.predicates
                for c in expr_columns(p)
            } - set(plan.columns)
            full = dict(out)
            if need:
                extra = orc.from_numpy({c: raw[c] for c in need})
                full.update(
                    {f"{plan.alias}.{c}": v for c, v in extra.items()}
                )
            pred = conjoin(list(plan.predicates))
            mask = [_truthy(eval_row(pred, r, ctx)) for r in _rows(full)]
            out = orc.o_filter(out, mask)
        ctx.scans[id(plan)] = out
        return out
    if isinstance(plan, Filter):
        df = _exec(plan.child, ctx)
        mask = [_truthy(eval_row(plan.pred, r, ctx)) for r in _rows(df)]
        return orc.o_filter(df, mask)
    if isinstance(plan, Join):
        left = _exec(plan.left, ctx)
        right = _exec(plan.right, ctx)
        return orc.o_join(
            left, right, list(plan.left_keys), list(plan.right_keys),
            how=plan.how,
        )
    if isinstance(plan, Aggregate):
        df = _exec(plan.child, ctx)
        rows = _rows(df)
        work: orc.ODF = {}
        for name, e in plan.keys:
            work[name] = [eval_row(e, r, ctx) for r in rows]
        specs = []
        for name, fn, e in plan.aggs:
            if fn == "size":
                specs.append((name, "size", ""))
                continue
            work[name + ".__in"] = [eval_row(e, r, ctx) for r in rows]
            specs.append((name, fn, name + ".__in"))
        keys = [n for n, _ in plan.keys]
        if keys:
            return orc.o_groupby(work, keys, specs)
        out: orc.ODF = {}
        for name, fn, cn in specs:
            v = orc._agg_one(work[cn] if cn else [1] * len(rows), fn)
            if v is None and fn == "sum" and not ctx.in_sub:
                v = 0.0  # engine (pandas) semantics for empty SUM
            out[name] = [v]
        return out
    if isinstance(plan, Project):
        df = _exec(plan.child, ctx)
        rows = _rows(df)
        return {
            name: [eval_row(e, r, ctx) for r in rows]
            for name, e in plan.outputs
        }
    if isinstance(plan, Sort):
        df = _exec(plan.child, ctx)
        return orc.o_sort(
            df, [n for n, _ in plan.keys], [a for _, a in plan.keys]
        )
    if isinstance(plan, Limit):
        df = _exec(plan.child, ctx)
        return orc.o_take(df, range(min(plan.n, orc.nrows(df))))
    if isinstance(plan, Distinct):
        df = _exec(plan.child, ctx)
        names = list(df)
        seen, keep = set(), []
        for i in range(orc.nrows(df)):
            key = tuple(df[k][i] for k in names)
            if key not in seen:
                seen.add(key)
                keep.append(i)
        return orc.o_take(df, keep)
    if isinstance(plan, AttachScalar):
        df = _exec(plan.child, ctx)
        sub = _exec(plan.sub.v, ctx)
        if orc.nrows(sub) > 1:
            raise SqlError(
                f"scalar subquery {plan.name} returned {orc.nrows(sub)} rows"
            )
        v = sub[plan.output][0] if orc.nrows(sub) == 1 else None  # 0 rows = NULL
        return {**df, plan.name: [v] * orc.nrows(df)}
    raise TypeError(f"unknown plan node {type(plan).__name__}")
