"""Rule-based plan optimizer.

Four rewrites, applied in order:

1. **Decorrelation** — planned subquery markers (the naive plan keeps
   them for the row-at-a-time oracle) are rewritten to relational
   operators: uncorrelated scalar subqueries become an attached
   constant (cross join with a one-row result), ``IN``/``NOT IN``
   become semi/anti joins on the subquery output, correlated
   ``EXISTS``/``NOT EXISTS`` become semi/anti joins on their equality
   correlation keys, and correlated scalar aggregates are re-keyed by
   the correlation columns into a group-by joined back to the outer
   query (HiFrames-style nested-query lowering).  A single ``<>``
   correlation residual under EXISTS is handled through a
   nunique/min aggregate (TPC-H Q21's shape).
2. **Constant folding** — literal arithmetic/comparisons and
   DATE +/- INTERVAL collapse at plan time, so e.g. TPC-H Q1's
   ``DATE '1998-12-01' - INTERVAL '90' DAY`` becomes one date literal
   and Q6's ``0.06 - 0.01`` bounds become plain numbers.
3. **Filter pushdown** — the planner leaves one big Filter above the
   join tree; this rule splits it into conjuncts and pushes each as far
   down as its columns allow: through inner joins to either side,
   through left joins to the left (probe) side only, and through
   aggregates when a conjunct touches only plain group-key columns.
   Single-table predicates end up directly above their Scan, shrinking
   every join build/probe input (Flare's plan-level pushdown).
4. **Projection pruning** — a top-down required-column pass narrows
   every Scan to the columns the query actually touches, so joins
   materialize fewer columns and offloaded strings stay offloaded.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Set

from .parser import (
    Boxed,
    SqlError,
    SAnd,
    SBetween,
    SBin,
    SCase,
    SCmp,
    SCol,
    SDate,
    SIn,
    SInterval,
    SIsNull,
    SLike,
    SLit,
    SNot,
    SOr,
    conjoin,
    expr_columns,
    like_prefix,
    split_conjuncts,
    transform,
    walk,
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
    Scan,
    Shared,
    Sort,
    SOuter,
    SubqueryExpr,
    _replace_subexpr,
    node_columns,
    subquery_markers,
)


def optimize(plan, store_tables=frozenset()):
    """decorrelate -> fold constants -> push filters (incl. through
    Projects) -> push sargable conjuncts into store scans -> prune.

    ``store_tables`` names the scope tables backed by ``repro_torch.store``
    chunked tables: only their Scans accept pushed predicates (zone-map
    chunk skipping happens in the scan, so the conjunct leaves the plan
    entirely).  In-memory scans keep explicit Filters so plans over
    plain frames are unchanged.
    """
    plan = decorrelate(plan)
    plan = fold_constants(plan)
    plan = push_filters(plan)
    if store_tables:
        plan = push_scan_predicates(plan, frozenset(store_tables))
    plan = prune_projections(plan)
    return plan


# ----------------------------------------------------------------------
# rule 0: decorrelation (subquery markers -> joins / attached scalars)
# ----------------------------------------------------------------------
def decorrelate(plan):
    """Rewrite every planned subquery marker into join form.

    The result contains no markers and no ``SOuter`` references, so it
    can be lowered onto TensorFrame; shapes outside the supported
    rewrites raise ``SqlError`` instead of silently interpreting."""
    node = plan
    if isinstance(node, Filter):
        child = decorrelate(node.child)
        remaining: List[object] = []
        for c in split_conjuncts(node.pred):
            child, res = _rewrite_conjunct(child, c)
            if res is not None:
                remaining.append(res)
        return Filter(child, conjoin(remaining)) if remaining else child
    if isinstance(node, Join):
        return dataclasses.replace(
            node, left=decorrelate(node.left), right=decorrelate(node.right)
        )
    if isinstance(node, Project):
        child = decorrelate(node.child)
        outputs = []
        for n, e in node.outputs:
            for m in subquery_markers(e):
                if not isinstance(m, SubqueryExpr):
                    raise SqlError(
                        "EXISTS/IN subqueries are not supported in the "
                        "SELECT list"
                    )
                child, repl = _rewrite_select_scalar(child, m)
                e = _replace_subexpr(e, m, repl)
            outputs.append((n, e))
        return Project(child, tuple(outputs))
    if isinstance(node, Aggregate):
        for e in [e for _, e in node.keys] + [
            e for _, _, e in node.aggs if e is not None
        ]:
            if subquery_markers(e):
                raise SqlError(
                    "subqueries inside GROUP BY keys or aggregate "
                    "arguments are not supported"
                )
        return dataclasses.replace(node, child=decorrelate(node.child))
    if isinstance(node, (Sort, Limit, Distinct, Shared)):
        return dataclasses.replace(node, child=decorrelate(node.child))
    if isinstance(node, AttachScalar):
        return dataclasses.replace(
            node,
            child=decorrelate(node.child),
            sub=Boxed(decorrelate(node.sub.v)),
        )
    return node


def _rewrite_select_scalar(child, m: SubqueryExpr):
    """Scalar subquery used as a SELECT-list value.

    Only the uncorrelated form is supported: it attaches the constant.
    A correlated one would need outer-join (keep-row-with-NULL)
    semantics that the inner-join rewrite cannot provide."""
    from .plan import plan_outer_refs

    if plan_outer_refs(m.plan.v):
        raise SqlError(
            "correlated scalar subqueries are only supported in "
            "WHERE/HAVING, not in the SELECT list"
        )
    return _rewrite_scalar(child, m)


def _rewrite_conjunct(child, c):
    """Rewrite one Filter conjunct; returns (new child, residual
    predicate or None)."""
    if isinstance(c, ExistsExpr):
        return _rewrite_exists(child, c)
    if isinstance(c, InSubExpr):
        return _rewrite_in(child, c)
    markers = subquery_markers(c)
    if not markers:
        return child, c
    for m in markers:
        if not isinstance(m, SubqueryExpr):
            raise SqlError(
                f"{type(m).__name__.replace('Expr', '').upper()} subqueries "
                f"are only supported as top-level AND conjuncts of "
                f"WHERE/HAVING, not nested inside other expressions"
            )
        child, repl = _rewrite_scalar(child, m)
        c = _replace_subexpr(c, m, repl)
    return child, c


def _strip_wrappers(p, what, drop_project=False, drop_distinct=False):
    """Peel semantics-free wrappers off a subquery plan.

    Sort never affects a subquery's value; Distinct is dropped only
    where duplicates cannot matter (EXISTS / IN membership).  LIMIT
    *does* change the result: an uncorrelated ``Limit(Sort(...))``
    subtree is kept intact and executed directly (deterministic thanks
    to the engine's stable tiebreak sort — LIMIT under sort ties picks
    the same rows as any stable reference); nothing below it may be
    stripped.  A correlated LIMIT has no join rewrite and is rejected.
    """
    while True:
        if isinstance(p, Sort):
            p = p.child
        elif isinstance(p, Distinct) and drop_distinct:
            p = p.child
        elif isinstance(p, Limit):
            from .plan import plan_outer_refs

            if plan_outer_refs(p):
                raise SqlError(
                    f"LIMIT inside correlated {what} subqueries is not "
                    f"supported (no join rewrite preserves the cutoff)"
                )
            return p
        elif isinstance(p, Distinct):
            raise SqlError(
                f"SELECT DISTINCT inside {what} subqueries is not supported"
            )
        else:
            break
    if drop_project and isinstance(p, Project):
        p = p.child
    return p


def _strip_correlation(node, under_agg=False):
    """Remove correlation conjuncts from a subquery plan.

    Returns ``(plan, eqs, neqs)`` with eqs/neqs lists of
    ``(outer_internal, inner_internal, under_aggregate)`` taken from
    ``inner = outer`` / ``inner <> outer`` Filter conjuncts.  Any other
    predicate that still references an enclosing scope is unsupported.
    """
    if isinstance(node, Filter):
        child, eqs, neqs = _strip_correlation(node.child, under_agg)
        keep = []
        for c in split_conjuncts(node.pred):
            kind, pair = _classify_correlation(c, under_agg)
            if kind == "eq":
                eqs.append(pair)
            elif kind == "neq":
                neqs.append(pair)
            else:
                keep.append(c)
        out = Filter(child, conjoin(keep)) if keep else child
        return out, eqs, neqs
    if isinstance(node, Join):
        left, e1, n1 = _strip_correlation(node.left, under_agg)
        right, e2, n2 = _strip_correlation(node.right, under_agg)
        return (
            dataclasses.replace(node, left=left, right=right),
            e1 + e2,
            n1 + n2,
        )
    if isinstance(node, Aggregate):
        child, eqs, neqs = _strip_correlation(node.child, True)
        return dataclasses.replace(node, child=child), eqs, neqs
    if isinstance(node, (Project, Sort, Limit, Distinct)):
        child, eqs, neqs = _strip_correlation(node.child, under_agg)
        return dataclasses.replace(node, child=child), eqs, neqs
    if isinstance(node, AttachScalar):
        child, eqs, neqs = _strip_correlation(node.child, under_agg)
        return dataclasses.replace(node, child=child), eqs, neqs
    return node, [], []


def _classify_correlation(c, under_agg):
    """One conjunct -> ('eq'|'neq', (outer, inner, under_agg)) or
    (None, None) for a plain local predicate."""
    if isinstance(c, SCmp) and c.op in ("=", "<>"):
        a, b = c.a, c.b
        if isinstance(a, SOuter) and not _has_outer(b):
            outer, inner = a, b
        elif isinstance(b, SOuter) and not _has_outer(a):
            outer, inner = b, a
        else:
            outer = None
        if outer is not None:
            if not isinstance(inner, SCol):
                raise SqlError(
                    f"correlated predicate must compare an outer column "
                    f"to a plain subquery column, got a computed "
                    f"expression on the inner side"
                )
            kind = "eq" if c.op == "=" else "neq"
            return kind, (outer.internal, inner.internal, under_agg)
    if _has_outer(c):
        raise SqlError(
            "unsupported correlated predicate shape (only "
            "inner = outer and inner <> outer conjuncts decorrelate)"
        )
    return None, None


def _has_outer(e) -> bool:
    return any(isinstance(n, SOuter) for n in walk(e))


def _check_outer_available(child, refs, what):
    cols = node_columns(child)
    for o in refs:
        if o not in cols:
            raise SqlError(
                f"correlated reference {o!r} in {what} is not available "
                f"in the immediately enclosing query (multi-level "
                f"correlation is not supported)"
            )


def _dedupe_pairs(pairs):
    seen, out = set(), []
    for o, i, _ in pairs:
        if (o, i) not in seen:
            seen.add((o, i))
            out.append((o, i))
    return out


def _rewrite_exists(child, m: ExistsExpr):
    sub = decorrelate(m.plan.v)
    # outputs (and dedup) are irrelevant to row existence
    sub = _strip_wrappers(sub, "EXISTS", drop_project=True, drop_distinct=True)
    sub, eqs, neqs = _strip_correlation(sub)
    if any(u for _, _, u in eqs + neqs):
        raise SqlError(
            "correlation below an aggregate inside EXISTS is not supported"
        )
    if not eqs and not neqs:
        # uncorrelated EXISTS: attach COUNT(*) of the subquery once
        n = f"{m.name}_n"
        agg = Project(
            Aggregate(sub, (), ((n, "size", None),)), ((n, SCol("", n)),)
        )
        out = AttachScalar(child, m.name, Boxed(agg), n)
        op = "=" if m.negated else ">"
        return out, SCmp(op, SCol("", m.name), SLit(0))
    if not eqs:
        raise SqlError(
            "EXISTS correlated only by <> is not supported; add an "
            "equality correlation"
        )
    eq = _dedupe_pairs(eqs)
    _check_outer_available(child, [o for o, _ in eq], "EXISTS subquery")
    if not neqs:
        how = "anti" if m.negated else "semi"
        return (
            Join(
                child,
                sub,
                tuple(o for o, _ in eq),
                tuple(i for _, i in eq),
                how,
            ),
            None,
        )
    # one <> residual: EXISTS(inner: key = outer_key AND c <> outer_c).
    # Group the inner rows by the equality keys with
    # n = NUNIQUE(c), m = MIN(c); then
    #   EXISTS      <=>  key has rows  AND NOT (n == 1 AND m == outer_c)
    #   NOT EXISTS  <=>  key has no rows OR (n == 1 AND m == outer_c)
    nq = _dedupe_pairs(neqs)
    if len(nq) != 1:
        raise SqlError(
            "at most one <> correlation is supported inside EXISTS"
        )
    (no, ni) = nq[0]
    _check_outer_available(child, [no], "EXISTS subquery")
    ncol, mcol = f"{m.name}_n", f"{m.name}_m"

    def make_group(inner):
        return Aggregate(
            inner,
            tuple((i, SCol("", i)) for _, i in eq),
            ((ncol, "nunique", SCol("", ni)), (mcol, "min", SCol("", ni))),
        )

    if not m.negated:
        # semi join on the equality keys, then anti join against the
        # single-value groups whose only value equals the outer column.
        # The inner relation feeds BOTH joins — wrap it in Shared so
        # lowering evaluates it once instead of scanning twice.
        inner = Shared(sub)
        semi = Join(
            child,
            inner,
            tuple(o for o, _ in eq),
            tuple(i for _, i in eq),
            "semi",
        )
        only_one = Filter(make_group(inner), SCmp("=", SCol("", ncol), SLit(1)))
        anti = Join(
            semi,
            only_one,
            tuple(o for o, _ in eq) + (no,),
            tuple(i for _, i in eq) + (mcol,),
            "anti",
        )
        return anti, None
    group = make_group(sub)
    # NOT EXISTS: left join the grouped inner, keep rows with no group
    # or whose single inner value is exactly the outer column's value
    left = Join(
        child,
        group,
        tuple(o for o, _ in eq),
        tuple(i for _, i in eq),
        "left",
    )
    residual = SOr(
        SIsNull(SCol("", ncol)),
        SAnd(
            SCmp("=", SCol("", ncol), SLit(1)),
            SCmp("=", SCol("", mcol), SCol("", no)),
        ),
    )
    return left, residual


def _rewrite_in(child, m: InSubExpr):
    if not isinstance(m.e, SCol):
        raise SqlError(
            "the left side of IN (SELECT ...) must be a plain column"
        )
    sub = decorrelate(m.plan.v)
    # keep the Project (its output is the key); IN is a membership
    # test, so dedup is also droppable
    sub = _strip_wrappers(sub, "IN", drop_distinct=True)
    sub, eqs, neqs = _strip_correlation(sub)
    if neqs:
        raise SqlError("<> correlation inside IN subqueries is not supported")
    if any(u for _, _, u in eqs):
        raise SqlError(
            "correlation below an aggregate inside IN is not supported"
        )
    eq = _dedupe_pairs(eqs)
    if eq:
        sub = _extend_project(sub, [i for _, i in eq])
    _check_outer_available(child, [o for o, _ in eq], "IN subquery")
    how = "anti" if m.negated else "semi"
    return (
        Join(
            child,
            sub,
            (m.e.internal,) + tuple(o for o, _ in eq),
            (m.output,) + tuple(i for _, i in eq),
            how,
        ),
        None,
    )


def _extend_project(plan, extra_cols):
    """Pass correlation key columns through a subquery's root Project."""
    if not isinstance(plan, Project):
        raise SqlError("correlated IN subquery has an unsupported shape")
    outs = plan.outputs + tuple(
        (c, SCol("", c)) for c in extra_cols if c not in {n for n, _ in plan.outputs}
    )
    return Project(plan.child, outs)


def _rewrite_scalar(child, m: SubqueryExpr):
    sub = decorrelate(m.plan.v)
    sub = _strip_wrappers(sub, "scalar")  # DISTINCT changes row counts: reject
    sub, eqs, neqs = _strip_correlation(sub)
    if neqs:
        raise SqlError(
            "<> correlation inside scalar subqueries is not supported"
        )
    if not eqs:
        return (
            AttachScalar(child, m.name, Boxed(sub), m.output),
            SCol("", m.name),
        )
    # correlated scalar aggregate: re-key the aggregate by the inner
    # correlation columns and join the grouped result back in.  Empty
    # groups vanish (inner join), which matches NULL-comparison
    # semantics for MIN/MAX/AVG/SUM predicates; COUNT (which would
    # need 0, not NULL) is rejected.
    if not all(u for _, _, u in eqs):
        raise SqlError(
            "correlated scalar subqueries must correlate inside an "
            "aggregate (SELECT AGG(...) ... WHERE inner = outer)"
        )
    if not (
        isinstance(sub, Project)
        and len(sub.outputs) == 1
        and isinstance(sub.child, Aggregate)
        and not sub.child.keys
    ):
        raise SqlError(
            "correlated scalar subquery must be a single ungrouped "
            "aggregate over the correlated table"
        )
    agg = sub.child
    if any(fn in ("size", "count") for _, fn, _ in agg.aggs):
        raise SqlError(
            "correlated COUNT subqueries are not supported (empty "
            "groups would need COUNT = 0, which the join rewrite drops)"
        )
    eq = _dedupe_pairs(eqs)
    _check_outer_available(child, [o for o, _ in eq], "scalar subquery")
    keyed = Aggregate(
        agg.child, tuple((i, SCol("", i)) for _, i in eq), agg.aggs
    )
    (_, vexpr), = sub.outputs
    proj = Project(
        keyed,
        tuple((i, SCol("", i)) for _, i in eq) + ((m.name, vexpr),),
    )
    joined = Join(
        child,
        proj,
        tuple(o for o, _ in eq),
        tuple(i for _, i in eq),
        "inner",
    )
    return joined, SCol("", m.name)


# ----------------------------------------------------------------------
# rule 1: constant folding
# ----------------------------------------------------------------------
_ARITH = {
    "+": lambda a, b: a + b,
    "-": lambda a, b: a - b,
    "*": lambda a, b: a * b,
    "/": lambda a, b: a / b,
}
_CMP = {
    "=": lambda a, b: a == b,
    "<>": lambda a, b: a != b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
}


def _is_num_lit(e) -> bool:
    return isinstance(e, SLit) and isinstance(e.value, (int, float)) and not isinstance(e.value, bool)


def _days(e) -> Optional[int]:
    if isinstance(e, (SDate, SInterval)):
        return e.days
    if isinstance(e, SLit) and isinstance(e.value, int) and not isinstance(e.value, bool):
        return e.value
    return None


def fold_expr_node(n):
    """One-step fold of a node whose children are already folded."""
    if isinstance(n, SBin):
        a, b = n.a, n.b
        if _is_num_lit(a) and _is_num_lit(b):
            if n.op == "/" and b.value == 0:
                return n
            return SLit(_ARITH[n.op](a.value, b.value))
        if isinstance(a, SDate) and n.op in ("+", "-"):
            nb = _days(b)
            if nb is not None and not isinstance(b, SDate):
                return SDate(a.days + nb if n.op == "+" else a.days - nb)
            if isinstance(b, SDate) and n.op == "-":
                return SLit(a.days - b.days)
        if isinstance(b, SDate) and n.op == "+":
            na = _days(a)
            if na is not None and not isinstance(a, SDate):
                return SDate(b.days + na)
        if isinstance(a, SInterval) and isinstance(b, SInterval):
            return SInterval(a.days + b.days if n.op == "+" else a.days - b.days)
    elif isinstance(n, SCmp):
        a, b = n.a, n.b
        if _is_num_lit(a) and _is_num_lit(b):
            return SLit(bool(_CMP[n.op](a.value, b.value)))
        if isinstance(a, SDate) and isinstance(b, SDate):
            return SLit(bool(_CMP[n.op](a.days, b.days)))
        if (
            isinstance(a, SLit) and isinstance(b, SLit)
            and isinstance(a.value, str) and isinstance(b.value, str)
        ):
            return SLit(bool(_CMP[n.op](a.value, b.value)))
    elif isinstance(n, SAnd):
        if n.a == SLit(True):
            return n.b
        if n.b == SLit(True):
            return n.a
        if SLit(False) in (n.a, n.b):
            return SLit(False)
    elif isinstance(n, SOr):
        if n.a == SLit(False):
            return n.b
        if n.b == SLit(False):
            return n.a
        if SLit(True) in (n.a, n.b):
            return SLit(True)
    elif isinstance(n, SNot):
        if isinstance(n.a, SLit) and isinstance(n.a.value, bool):
            return SLit(not n.a.value)
    elif isinstance(n, SCase):
        # drop WHEN branches with constant-false conditions
        whens = tuple((c, r) for c, r in n.whens if c != SLit(False))
        if whens != n.whens:
            if not whens:
                return n.default
            return SCase(whens, n.default)
    return n


def fold_expr(e):
    return transform(e, fold_expr_node)


def fold_constants(node):
    """Fold every expression embedded in the plan."""
    if isinstance(node, Filter):
        return Filter(fold_constants(node.child), fold_expr(node.pred))
    if isinstance(node, Project):
        return Project(
            fold_constants(node.child),
            tuple((n, fold_expr(e)) for n, e in node.outputs),
        )
    if isinstance(node, Aggregate):
        return Aggregate(
            fold_constants(node.child),
            tuple((n, fold_expr(e)) for n, e in node.keys),
            tuple(
                (n, fn, fold_expr(e) if e is not None else None)
                for n, fn, e in node.aggs
            ),
        )
    if isinstance(node, Join):
        return dataclasses.replace(
            node, left=fold_constants(node.left), right=fold_constants(node.right)
        )
    if isinstance(node, (Sort, Limit, Distinct, Shared)):
        return dataclasses.replace(node, child=fold_constants(node.child))
    if isinstance(node, AttachScalar):
        return dataclasses.replace(
            node,
            child=fold_constants(node.child),
            sub=Boxed(fold_constants(node.sub.v)),
        )
    return node


# ----------------------------------------------------------------------
# rule 2: filter pushdown
# ----------------------------------------------------------------------
def push_filters(node):
    if isinstance(node, Filter):
        conjuncts = split_conjuncts(node.pred)
        child = node.child
        # merge stacked filters before pushing
        while isinstance(child, Filter):
            conjuncts += split_conjuncts(child.pred)
            child = child.child
        conjuncts = [c for c in conjuncts if c != SLit(True)]
        if not conjuncts:
            return push_filters(child)
        return _push_into(child, conjuncts)
    if isinstance(node, Join):
        return dataclasses.replace(
            node, left=push_filters(node.left), right=push_filters(node.right)
        )
    if isinstance(node, (Project, Aggregate, Sort, Limit, Distinct, Shared)):
        return dataclasses.replace(node, child=push_filters(node.child))
    if isinstance(node, AttachScalar):
        return dataclasses.replace(
            node,
            child=push_filters(node.child),
            sub=Boxed(push_filters(node.sub.v)),
        )
    return node


def _push_into(child, conjuncts):
    """Push a list of conjuncts into ``child``; returns the new subtree
    (residual conjuncts wrap it in a Filter)."""
    if isinstance(child, Join):
        lcols, rcols = node_columns(child.left), node_columns(child.right)
        to_left, to_right, stay = [], [], []
        for c in conjuncts:
            cols = expr_columns(c)
            if cols <= lcols:
                to_left.append(c)
            elif cols <= rcols and child.how == "inner":
                to_right.append(c)
            else:
                stay.append(c)
        left = Filter(child.left, conjoin(to_left)) if to_left else child.left
        right = Filter(child.right, conjoin(to_right)) if to_right else child.right
        out = Join(
            push_filters(left),
            push_filters(right),
            child.left_keys,
            child.right_keys,
            child.how,
        )
        return Filter(out, conjoin(stay)) if stay else out
    if isinstance(child, Aggregate):
        # a conjunct over plain-column group keys commutes with grouping
        plain_keys = {
            n for n, e in child.keys if isinstance(e, SCol) and e.internal == n
        }
        below, stay = [], []
        for c in conjuncts:
            (below if expr_columns(c) <= plain_keys else stay).append(c)
        out = child
        if below:
            out = dataclasses.replace(
                child, child=Filter(child.child, conjoin(below))
            )
        out = dataclasses.replace(out, child=push_filters(out.child))
        return Filter(out, conjoin(stay)) if stay else out
    if isinstance(child, Distinct):
        # a filter over the deduped columns commutes with dedup
        return Distinct(_push_into(child.child, conjuncts))
    if isinstance(child, Project):
        # A conjunct over Project outputs rewrites to the defining
        # expressions and commutes with the projection — this is what
        # lets predicates keep sinking through derived tables (q15's
        # revenue filter used to stop at the qualifying Project and
        # re-scan the whole derived output).
        outmap = {n: e for n, e in child.outputs}
        below, stay = [], []
        for c in conjuncts:
            if subquery_markers(c) or not expr_columns(c) <= set(outmap):
                stay.append(c)
            else:
                below.append(_substitute_outputs(c, outmap))
        inner = (
            _push_into(child.child, below)
            if below
            else push_filters(child.child)
        )
        out = Project(inner, child.outputs)
        return Filter(out, conjoin(stay)) if stay else out
    if isinstance(child, AttachScalar):
        below, stay = [], []
        for c in conjuncts:
            (stay if child.name in expr_columns(c) else below).append(c)
        inner = (
            _push_into(child.child, below)
            if below
            else push_filters(child.child)
        )
        out = dataclasses.replace(
            child, child=inner, sub=Boxed(push_filters(child.sub.v))
        )
        return Filter(out, conjoin(stay)) if stay else out
    child = push_filters(child)
    return Filter(child, conjoin(conjuncts))


def _substitute_outputs(e, outmap):
    """Rewrite output-column references to their defining expressions."""
    return transform(
        e,
        lambda n: outmap[n.internal]
        if isinstance(n, SCol) and n.internal in outmap
        else n,
    )


# ----------------------------------------------------------------------
# rule 2b: sargable conjuncts into store-backed scans
# ----------------------------------------------------------------------
def push_scan_predicates(node, store_tables):
    """Move sargable Filter conjuncts into Scans of store-backed tables.

    A sargable conjunct compares one scanned column against constants
    (``col <op> literal``, ``BETWEEN``, ``IN (literals, ...)``,
    ``IS [NOT] NULL``, ``LIKE 'prefix%'``).  The store scan applies it
    exactly — zone maps skip whole chunks (null counts answer IS NULL,
    the sorted dictionary reduces a LIKE prefix to a code range), then
    a host-side row filter — so the conjunct is *removed* from the
    plan rather than duplicated.  Everything else (general LIKE,
    arithmetic over columns, OR trees) stays as a residual Filter
    above the scan.
    """
    if isinstance(node, Filter):
        child = push_scan_predicates(node.child, store_tables)
        if isinstance(child, Scan) and child.table in store_tables:
            push, keep = [], []
            for c in split_conjuncts(node.pred):
                (push if _sargable(c, child) else keep).append(c)
            if push:
                child = dataclasses.replace(
                    child, predicates=child.predicates + tuple(push)
                )
            return Filter(child, conjoin(keep)) if keep else child
        return Filter(child, node.pred)
    if isinstance(node, Join):
        return dataclasses.replace(
            node,
            left=push_scan_predicates(node.left, store_tables),
            right=push_scan_predicates(node.right, store_tables),
        )
    if isinstance(node, (Project, Aggregate, Sort, Limit, Distinct, Shared)):
        return dataclasses.replace(
            node, child=push_scan_predicates(node.child, store_tables)
        )
    if isinstance(node, AttachScalar):
        return dataclasses.replace(
            node,
            child=push_scan_predicates(node.child, store_tables),
            sub=Boxed(push_scan_predicates(node.sub.v, store_tables)),
        )
    return node


def _is_scan_const(e) -> bool:
    if isinstance(e, SDate):
        return True
    return (
        isinstance(e, SLit)
        and e.value is not None
        and not isinstance(e.value, bool)
    )


def _sargable(c, scan: Scan) -> bool:
    cols = {f"{scan.alias}.{col}" for col in scan.columns}

    def scan_col(e) -> bool:
        return isinstance(e, SCol) and e.internal in cols

    if isinstance(c, SCmp):
        return (scan_col(c.a) and _is_scan_const(c.b)) or (
            scan_col(c.b) and _is_scan_const(c.a)
        )
    if isinstance(c, SBetween) and not c.negated:
        return scan_col(c.e) and _is_scan_const(c.lo) and _is_scan_const(c.hi)
    if isinstance(c, SIn) and not c.negated:
        return scan_col(c.e) and all(_is_scan_const(v) for v in c.values)
    if isinstance(c, SIsNull):
        return scan_col(c.e)
    if isinstance(c, SLike) and not c.negated:
        return scan_col(c.e) and like_prefix(c.pattern) is not None
    return False


# ----------------------------------------------------------------------
# rule 3: projection pruning
# ----------------------------------------------------------------------
def prune_projections(node, required: Optional[Set[str]] = None):
    """Narrow Scans to the columns actually referenced above them.

    ``required=None`` means "everything" (the root, and below nodes that
    need their child intact).

    Runs in two passes so ``Shared`` subplans prune consistently: the
    first records the union of the column sets every consumer demands
    from each Shared node, the second rewrites using those unions, so
    equal Shared wrappers stay equal (and lowering still evaluates the
    shared subtree once)."""
    shared_req: dict = {}
    _prune(node, required, shared_req, record=True)
    return _prune(node, required, shared_req, record=False)


def _prune(node, required: Optional[Set[str]], shared_req: dict, record: bool):
    if isinstance(node, Project):
        outputs = node.outputs
        if required is not None:
            # Narrow the projection to what parents actually consume —
            # the decorrelated semi/anti-join right sides (IN-subquery
            # Projects, derived tables under joins) shrink to their
            # join keys before the build (ROADMAP open item).
            kept = tuple((n, e) for n, e in outputs if n in required)
            if kept:
                outputs = kept
        need = set()
        for _, e in outputs:
            need |= expr_columns(e)
        return Project(_prune(node.child, need, shared_req, record), outputs)
    if isinstance(node, Sort):
        # sort keys are consumed here even if no parent needs them
        need = (
            None if required is None
            else required | {n for n, _ in node.keys}
        )
        return dataclasses.replace(
            node, child=_prune(node.child, need, shared_req, record)
        )
    if isinstance(node, Limit):
        return dataclasses.replace(
            node, child=_prune(node.child, required, shared_req, record)
        )
    if isinstance(node, Distinct):
        # dedup semantics depend on every child column: keep them all
        return Distinct(_prune(node.child, None, shared_req, record))
    if isinstance(node, Shared):
        if record:
            have = shared_req.get(node, frozenset())
            if required is None or have is None:
                shared_req[node] = None
            else:
                shared_req[node] = frozenset(have) | frozenset(required)
            _prune(node.child, shared_req[node], shared_req, record)
            return node
        need = shared_req.get(node, None)
        return Shared(_prune(node.child, need, shared_req, record))
    if isinstance(node, AttachScalar):
        need = None if required is None else required - {node.name}
        return dataclasses.replace(
            node,
            child=_prune(node.child, need, shared_req, record),
            sub=Boxed(_prune(node.sub.v, None, shared_req, record)),
        )
    if isinstance(node, Filter):
        need = None if required is None else required | expr_columns(node.pred)
        return Filter(_prune(node.child, need, shared_req, record), node.pred)
    if isinstance(node, Aggregate):
        aggs = node.aggs
        if required is not None:
            # drop aggregate expressions no parent consumes — a Project
            # that keeps half the aggregates no longer computes them all
            # (group keys always stay: they define the grouping)
            kept = tuple(a for a in aggs if a[0] in required)
            if kept or not aggs:
                aggs = kept
        need = set()
        for _, e in node.keys:
            need |= expr_columns(e)
        for _, _, e in aggs:
            if e is not None:
                need |= expr_columns(e)
        return Aggregate(
            _prune(node.child, need, shared_req, record), node.keys, aggs
        )
    if isinstance(node, Join):
        need = (
            None
            if required is None
            else required | set(node.left_keys) | set(node.right_keys)
        )
        lcols, rcols = node_columns(node.left), node_columns(node.right)
        lneed = None if need is None else need & lcols
        rneed = None if need is None else need & rcols
        return Join(
            _prune(node.left, lneed, shared_req, record),
            _prune(node.right, rneed, shared_req, record),
            node.left_keys,
            node.right_keys,
            node.how,
        )
    if isinstance(node, Scan):
        if required is None:
            return node
        keep = tuple(
            c for c in node.columns if f"{node.alias}.{c}" in required
        )
        return dataclasses.replace(node, columns=keep)
    raise TypeError(f"unknown plan node {type(node).__name__}")
