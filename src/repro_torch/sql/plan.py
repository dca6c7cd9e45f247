"""Logical plan: dataclass nodes + the planner (AST -> naive plan).

The planner is deliberately naive — it resolves names, builds the join
tree from equi-join predicates, and stacks the remaining WHERE
conjuncts as ONE Filter above the joins.  All pushdown/pruning smarts
live in ``optimize``; ``explain()`` shows the difference.

Subqueries: a nested SELECT is planned recursively into its own plan
tree and embedded in the enclosing expression as a *marker* node
(``SubqueryExpr`` / ``InSubExpr`` / ``ExistsExpr``), with references to
enclosing-scope columns wrapped in ``SOuter``.  The naive plan keeps
the markers (the oracle backend interprets them per row, nested-loop
style); ``optimize.decorrelate`` rewrites them to semi/anti joins,
group-by + join, or attached scalar constants before lowering.

Internal column naming: every scanned column is qualified as
``alias.column`` so self-joins (``nation n1, nation n2``) never
collide.  Post-aggregate columns use reserved ``__agg_<i>`` /
``__key_<i>`` names, subquery results ``__sq_<i>``; ``SCol("", name)``
refers to such an internal output column verbatim.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from .parser import (
    AGG_FUNCS,
    Boxed,
    FromItem,
    SCALAR_FUNCS,
    SqlError,
    SCol,
    SExists,
    SFunc,
    SInSub,
    SNot,
    SSub,
    SStar,
    Select,
    conjoin,
    expr_columns,
    format_expr,
    split_conjuncts,
    transform,
    walk,
    SCmp,
)


# ----------------------------------------------------------------------
# plan nodes
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Scan:
    table: str
    alias: str
    columns: Tuple[str, ...]  # unqualified physical columns to load
    # Sargable conjuncts pushed INTO the scan (store-backed tables:
    # zone-map chunk skipping + host-side row filter before any tensor
    # materializes).  Internal (qualified) column references; applied
    # exactly, so they are not re-checked above the scan.
    predicates: Tuple[object, ...] = ()


@dataclasses.dataclass(frozen=True)
class Filter:
    child: object
    pred: object


@dataclasses.dataclass(frozen=True)
class Join:
    left: object
    right: object
    left_keys: Tuple[str, ...]  # internal (qualified) names
    right_keys: Tuple[str, ...]
    how: str = "inner"


@dataclasses.dataclass(frozen=True)
class Aggregate:
    child: object
    keys: Tuple[Tuple[str, object], ...]  # (out_name, expr)
    aggs: Tuple[Tuple[str, str, object], ...]  # (out_name, fn, expr|None)


@dataclasses.dataclass(frozen=True)
class Project:
    child: object
    outputs: Tuple[Tuple[str, object], ...]  # (out_name, expr)


@dataclasses.dataclass(frozen=True)
class Sort:
    child: object
    keys: Tuple[Tuple[str, bool], ...]  # (output column, ascending)


@dataclasses.dataclass(frozen=True)
class Limit:
    child: object
    n: int


@dataclasses.dataclass(frozen=True)
class Distinct:
    """Row deduplication over all of the child's columns (SELECT
    DISTINCT); lowered onto TensorFrame group-by."""

    child: object


@dataclasses.dataclass(frozen=True)
class AttachScalar:
    """Broadcast the single value produced by an uncorrelated scalar
    subquery onto every row of ``child`` as column ``name`` (the
    cross-join-a-constant decorrelation of uncorrelated subqueries)."""

    child: object
    name: str
    sub: Boxed  # Boxed[plan] producing exactly one row / one column
    output: str  # the subplan's output column name


@dataclasses.dataclass(frozen=True)
class Shared:
    """A common subplan referenced from several places in the plan.

    The optimizer wraps a subtree it reuses (e.g. the inner relation of
    an EXISTS-with-``<>`` rewrite feeds both the semi join and the
    grouped anti join) so lowering evaluates it once and reuses the
    result.  Equality is structural: optimizer passes may copy the
    wrapper, and as long as the copies stay equal the lowering memo
    still collapses them to a single evaluation."""

    child: object


# ----------------------------------------------------------------------
# subquery expression markers (embedded in Filter predicates)
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SOuter:
    """A correlated reference from inside a subquery to a column of an
    enclosing scope (``ref`` is the resolved outer SCol)."""

    ref: SCol

    @property
    def internal(self) -> str:
        return self.ref.internal

    def render(self) -> str:
        return f"outer({self.ref.internal})"


@dataclasses.dataclass(frozen=True)
class SubqueryExpr:
    """Planned scalar subquery used as an expression value."""

    plan: Boxed  # Boxed[plan]
    output: str  # single output column of the subplan
    name: str  # unique __sq_<i> tag

    def render(self) -> str:
        return f"scalar-subquery[{self.name}]"


@dataclasses.dataclass(frozen=True)
class InSubExpr:
    """Planned ``e [NOT] IN (SELECT ...)`` predicate."""

    e: object
    plan: Boxed
    output: str
    name: str
    negated: bool = False

    def render(self) -> str:
        neg = "NOT " if self.negated else ""
        return f"({format_expr(self.e)} {neg}IN subquery[{self.name}])"


@dataclasses.dataclass(frozen=True)
class ExistsExpr:
    """Planned ``[NOT] EXISTS (SELECT ...)`` predicate."""

    plan: Boxed
    name: str
    negated: bool = False

    def render(self) -> str:
        neg = "NOT " if self.negated else ""
        return f"({neg}EXISTS subquery[{self.name}])"


SUBQUERY_MARKERS = (SubqueryExpr, InSubExpr, ExistsExpr)


def subquery_markers(e):
    """All planned-subquery marker nodes inside an expression."""
    return [n for n in walk(e) if isinstance(n, SUBQUERY_MARKERS)]


def plan_outer_refs(plan) -> Tuple[str, ...]:
    """Sorted internal names of enclosing-scope columns a subquery plan
    (including nested subqueries) depends on."""
    refs = set()
    for e in iter_plan_exprs(plan):
        for n in walk(e):
            if isinstance(n, SOuter):
                refs.add(n.internal)
            elif isinstance(n, SUBQUERY_MARKERS):
                refs.update(plan_outer_refs(n.plan.v))
    return tuple(sorted(refs))


def iter_plan_exprs(node):
    """Yield every expression embedded in a plan tree (this node and
    its children, not crossing into Boxed subquery plans)."""
    if isinstance(node, Filter):
        yield node.pred
    elif isinstance(node, Project):
        for _, e in node.outputs:
            yield e
    elif isinstance(node, Aggregate):
        for _, e in node.keys:
            yield e
        for _, _, e in node.aggs:
            if e is not None:
                yield e
    for attr in ("child", "left", "right"):
        c = getattr(node, attr, None)
        if c is not None:
            yield from iter_plan_exprs(c)


def walk_scans(node):
    """Yield every Scan in a plan tree, including the subplans boxed
    inside AttachScalar markers (post-decorrelation plans keep scalar
    subqueries there).  Consumers: the compiled path's base-table
    discovery and the serving layer's shared-scan grouping."""
    if isinstance(node, Scan):
        yield node
        return
    if isinstance(node, AttachScalar):
        yield from walk_scans(node.child)
        yield from walk_scans(node.sub.v)
        return
    for attr in ("child", "left", "right"):
        c = getattr(node, attr, None)
        if c is not None:
            yield from walk_scans(c)


def node_columns(node) -> set:
    """Internal column names produced by a plan node."""
    if isinstance(node, Scan):
        return {f"{node.alias}.{c}" for c in node.columns}
    if isinstance(node, Join):
        if node.how in ("semi", "anti"):
            return node_columns(node.left)
        return node_columns(node.left) | node_columns(node.right)
    if isinstance(node, Aggregate):
        return {n for n, _ in node.keys} | {n for n, _, _ in node.aggs}
    if isinstance(node, Project):
        return {n for n, _ in node.outputs}
    if isinstance(node, (Filter, Sort, Limit, Distinct, Shared)):
        return node_columns(node.child)
    if isinstance(node, AttachScalar):
        return node_columns(node.child) | {node.name}
    raise TypeError(f"unknown plan node {type(node).__name__}")


# ----------------------------------------------------------------------
# name resolution
# ----------------------------------------------------------------------
class _Resolver:
    """Column/name resolution for one SELECT scope.

    ``outer`` chains to the enclosing subquery scope; a reference that
    only an enclosing scope can satisfy resolves to ``SOuter`` (a
    correlated reference).  ``plan_sub`` is the planner callback that
    compiles nested SELECT nodes found during resolution."""

    def __init__(
        self,
        aliases: Dict[str, str],
        catalog: Dict[str, List[str]],
        outer: Optional["_Resolver"] = None,
        plan_sub=None,
    ):
        self.aliases = aliases  # alias -> table name
        self.catalog = catalog
        self.outer = outer
        self.plan_sub = plan_sub

    def all_aliases(self) -> set:
        out = set(self.aliases)
        if self.outer is not None:
            out |= self.outer.all_aliases()
        return out

    def resolve_col(self, c: SCol):
        if c.table == "":  # already-internal reference
            return c
        if c.table is not None:
            if c.table not in self.aliases:
                if self.outer is not None:
                    return _as_outer(self.outer.resolve_col(c))
                raise SqlError(
                    f"unknown table or alias {c.table!r}; "
                    f"in scope: {sorted(self.aliases)}"
                )
            cols = self.catalog[self.aliases[c.table]]
            if c.name not in cols:
                raise SqlError(
                    f"unknown column {c.name!r} in table "
                    f"{self.aliases[c.table]!r} (alias {c.table!r}); "
                    f"it has: {cols}"
                )
            return c
        hits = [
            a for a, t in self.aliases.items() if c.name in self.catalog[t]
        ]
        if not hits:
            if self.outer is not None:
                return _as_outer(self.outer.resolve_col(c))
            raise SqlError(
                f"unknown column {c.name!r}; no table in scope has it "
                f"(tables: {sorted(set(self.aliases.values()))})"
            )
        if len(hits) > 1:
            raise SqlError(
                f"ambiguous column {c.name!r}: present in aliases {sorted(hits)}; "
                f"qualify it"
            )
        return SCol(hits[0], c.name)

    def _fn(self, n):
        if isinstance(n, SCol):
            return self.resolve_col(n)
        if isinstance(n, (SSub, SInSub, SExists)):
            if self.plan_sub is None:
                raise SqlError("subqueries are not allowed in this context")
            return self.plan_sub(n, self)
        if isinstance(n, SNot) and isinstance(n.a, ExistsExpr):
            return dataclasses.replace(n.a, negated=not n.a.negated)
        if isinstance(n, SNot) and isinstance(n.a, InSubExpr):
            return dataclasses.replace(n.a, negated=not n.a.negated)
        if isinstance(n, SFunc) and not (
            n.name in AGG_FUNCS or n.name in SCALAR_FUNCS
        ):
            from .udf import active_udfs

            if n.name not in active_udfs():
                raise SqlError(
                    f"unknown function {n.name.upper()!r}; supported "
                    f"aggregates: {[f.upper() for f in AGG_FUNCS]}, scalar "
                    f"functions: {[f.upper() for f in SCALAR_FUNCS]}, "
                    f"registered UDFs: {sorted(active_udfs())}"
                )
        return n

    def resolve(self, e):
        return transform(e, self._fn)


def _as_outer(resolved) -> SOuter:
    # flatten: a reference that resolved 2+ scopes up is still one
    # SOuter wrapper around the final column
    return resolved if isinstance(resolved, SOuter) else SOuter(resolved)


def _replace_subexpr(e, target, replacement):
    """Top-down replacement of a whole subexpression."""
    if e == target:
        return replacement
    if not dataclasses.is_dataclass(e):
        return e
    changes = {}
    for f in dataclasses.fields(e):
        v = getattr(e, f.name)
        if dataclasses.is_dataclass(v):
            nv = _replace_subexpr(v, target, replacement)
        elif isinstance(v, tuple):
            nv = tuple(
                _replace_subexpr(x, target, replacement)
                if dataclasses.is_dataclass(x)
                else (
                    tuple(
                        _replace_subexpr(s, target, replacement)
                        if dataclasses.is_dataclass(s)
                        else s
                        for s in x
                    )
                    if isinstance(x, tuple)
                    else x
                )
                for x in v
            )
        else:
            nv = v
        if nv != v:
            changes[f.name] = nv
    return dataclasses.replace(e, **changes) if changes else e


# ----------------------------------------------------------------------
# planner
# ----------------------------------------------------------------------
def build_plan(sel: Select, catalog: Dict[str, List[str]]):
    """Compile a parsed SELECT into the naive logical plan."""
    from repro_torch.resilience import checkpoint
    from repro_torch.resilience.faults import fault_point

    checkpoint("sql.plan")
    fault_point("plan")
    return _Planner(catalog).plan_select(sel, None)


def plan_output_names(plan) -> List[str]:
    """Ordered output column names of a planned SELECT."""
    node = plan
    while isinstance(node, (Sort, Limit, Distinct, Filter)):
        node = node.child
    if isinstance(node, Project):
        return [n for n, _ in node.outputs]
    raise TypeError(f"plan root {type(node).__name__} has no Project")


class _Planner:
    """Recursive SELECT planner; one instance per query so subquery
    result names (``__sq_<i>``) stay unique across all scopes."""

    def __init__(self, catalog: Dict[str, List[str]]):
        self.catalog = dict(catalog)
        self._sq = 0

    def _fresh(self) -> str:
        name = f"__sq_{self._sq}"
        self._sq += 1
        return name

    def _plan_marker(self, node, res: _Resolver):
        """Compile a nested SELECT found during expression resolution
        into a planned subquery marker."""
        if isinstance(node, SSub):
            p = self.plan_select(_auto_alias(node.select.v), res)
            out = _single_output(p, "scalar subquery")
            return SubqueryExpr(Boxed(p), out, self._fresh())
        if isinstance(node, SInSub):
            p = self.plan_select(_auto_alias(node.select.v), res)
            out = _single_output(p, "IN subquery")
            return InSubExpr(node.e, Boxed(p), out, self._fresh(), node.negated)
        p = self.plan_select(node.select.v, res)
        return ExistsExpr(Boxed(p), self._fresh(), node.negated)

    def _derived(self, item: FromItem, outer: Optional[_Resolver]):
        """Plan a derived table: its SELECT, wrapped in a Project that
        qualifies the outputs with the alias.  Returns (source plan,
        unqualified output names for the catalog)."""
        subplan = self.plan_select(item.sub.v, outer)
        outnames = plan_output_names(subplan)
        outs = tuple((f"{item.alias}.{n}", SCol("", n)) for n in outnames)
        return Project(subplan, outs), outnames

    def plan_select(self, sel: Select, outer: Optional[_Resolver]):
        items = list(sel.from_items) + [j.item for j in sel.joins]
        aliases: Dict[str, str] = {}
        sources: Dict[str, object] = {}  # alias -> planned FROM source
        catalog = dict(self.catalog)  # local copy: derived tables register here
        outer_aliases = outer.all_aliases() if outer is not None else set()
        for item in items:
            if item.alias in aliases:
                raise SqlError(f"duplicate table alias {item.alias!r}")
            if item.alias in outer_aliases:
                raise SqlError(
                    f"subquery alias {item.alias!r} shadows an enclosing "
                    f"query's alias; rename it so correlated references "
                    f"stay unambiguous"
                )
            if item.sub is not None:
                src, outnames = self._derived(item, outer)
                table_key = f"__derived:{item.alias}"
                catalog[table_key] = outnames
                aliases[item.alias] = table_key
                sources[item.alias] = src
                continue
            if item.table not in catalog:
                raise SqlError(
                    f"unknown table {item.table!r}; scope has "
                    f"{sorted(c for c in catalog if not c.startswith('__derived:'))}"
                )
            aliases[item.alias] = item.table
            sources[item.alias] = Scan(
                item.table, item.alias, tuple(catalog[item.table])
            )
        res = _Resolver(aliases, catalog, outer, self._plan_marker)

        # ---- classify WHERE conjuncts ----
        equi: List[SCmp] = []  # cross-alias equality -> join key candidates
        residual: List[object] = []
        if sel.where is not None:
            for c in split_conjuncts(res.resolve(sel.where)):
                if _is_equi(c):
                    equi.append(c)
                else:
                    residual.append(c)

        # ---- join tree: FROM list greedily, then explicit JOINs ----
        first = sel.from_items[0]
        plan, joined = sources[first.alias], {first.alias}
        pending = list(sel.from_items[1:])
        while pending:
            progress = False
            for item in list(pending):
                keys = _take_link_preds(equi, joined, item.alias)
                if keys:
                    plan = Join(
                        plan,
                        sources[item.alias],
                        tuple(k for k, _ in keys),
                        tuple(k for _, k in keys),
                        "inner",
                    )
                    joined.add(item.alias)
                    pending.remove(item)
                    progress = True
            if not progress:
                stuck = [i.alias for i in pending]
                raise SqlError(
                    f"no equi-join predicate connects table(s) {stuck} to the "
                    f"rest of the FROM list; cross joins are not supported"
                )
        for jc in sel.joins:
            on = res.resolve(jc.on)
            keys, extra = [], []
            for c in split_conjuncts(on):
                if _is_equi(c) and _links(c, joined, jc.item.alias):
                    keys.append(_orient(c, joined))
                else:
                    extra.append(c)
            if not keys:
                raise SqlError(
                    f"JOIN {jc.item.table} ON clause has no equi-join predicate "
                    f"linking it to the tables already joined"
                )
            right = sources[jc.item.alias]
            if jc.how == "left" and extra:
                # For LEFT JOIN, ON residuals restrict which right rows
                # MATCH (failed matches NULL-extend, they don't drop the
                # left row), so hoisting them into WHERE would silently
                # turn the join inner.  Right-side-only conjuncts are
                # equivalent to pre-filtering the right input; anything
                # touching the left side cannot be expressed that way.
                rcols = node_columns(right)
                bad = [c for c in extra if not expr_columns(c) <= rcols]
                if bad:
                    raise SqlError(
                        f"LEFT JOIN {jc.item.table} ON supports extra "
                        f"conditions only on the joined (right) table's "
                        f"columns; move {format_expr(bad[0])} to WHERE if "
                        f"inner-join semantics are intended"
                    )
                right = Filter(right, conjoin(extra))
                extra = []
            plan = Join(
                plan,
                right,
                tuple(k for k, _ in keys),
                tuple(k for _, k in keys),
                jc.how,
            )
            joined.add(jc.item.alias)
            residual.extend(extra)
        # leftover equi predicates link already-joined aliases (e.g.
        # TPC-H Q5's c_nationkey = s_nationkey): plain filters
        residual.extend(equi)
        if residual:
            plan = Filter(plan, conjoin(residual))

        # ---- projection / aggregation ----
        select_items: List[Tuple[object, Optional[str]]] = []
        for e, alias in sel.columns:
            if isinstance(e, SStar):
                for a in (i.alias for i in items):
                    for cname in catalog[aliases[a]]:
                        select_items.append((SCol(a, cname), cname))
            else:
                select_items.append((res.resolve(e), alias))
        sel_aliases = {a: e for e, a in select_items if a is not None}

        has_agg = bool(sel.group_by) or any(
            _has_aggregate(e) for e, _ in select_items
        ) or (sel.having is not None)

        order_rewrite = None
        if has_agg:
            plan, outputs, order_rewrite = _plan_aggregate(
                sel, res, plan, select_items, sel_aliases
            )
        else:
            if sel.having is not None:
                raise SqlError("HAVING requires GROUP BY or aggregates")
            outputs = []
            for e, alias in select_items:
                name = alias or (e.name if isinstance(e, SCol) else None)
                if name is None:
                    raise SqlError(
                        f"computed select column {format_expr(e)} needs an AS alias"
                    )
                outputs.append((name, e))
        names = [n for n, _ in outputs]
        dup = {n for n in names if names.count(n) > 1}
        if dup:
            raise SqlError(f"duplicate output column name(s) {sorted(dup)}")
        plan = Project(plan, tuple(outputs))
        if sel.distinct:
            plan = Distinct(plan)

        # ---- order by / limit over the OUTPUT columns ----
        if sel.order_by:
            skeys = []
            for e, asc in sel.order_by:
                skeys.append(
                    (_output_name_for(e, outputs, res, order_rewrite), asc)
                )
            plan = Sort(plan, tuple(skeys))
        if sel.limit is not None:
            plan = Limit(plan, sel.limit)
        return plan


def _auto_alias(sel: Select) -> Select:
    """Give the single computed column of a scalar/IN subquery an
    implicit alias (standard SQL needs none there)."""
    if len(sel.columns) == 1:
        e, alias = sel.columns[0]
        if alias is None and not isinstance(e, (SCol, SStar)):
            return dataclasses.replace(sel, columns=((e, "__scalar"),))
    return sel


def _single_output(plan, what: str) -> str:
    names = plan_output_names(plan)
    if len(names) != 1:
        raise SqlError(
            f"{what} must produce exactly one column, got {names}"
        )
    return names[0]


def _is_equi(c) -> bool:
    return (
        isinstance(c, SCmp)
        and c.op == "="
        and isinstance(c.a, SCol)
        and isinstance(c.b, SCol)
        and c.a.table != c.b.table
    )


def _links(c: SCmp, joined: set, new_alias: str) -> bool:
    sides = {c.a.table, c.b.table}
    return new_alias in sides and bool((sides - {new_alias}) & joined)


def _orient(c: SCmp, joined: set) -> Tuple[str, str]:
    """(left_key, right_key) with left on the already-joined side."""
    if c.a.table in joined:
        return (c.a.internal, c.b.internal)
    return (c.b.internal, c.a.internal)


def _take_link_preds(equi: List[SCmp], joined: set, new_alias: str):
    keys = []
    for c in list(equi):
        if _links(c, joined, new_alias):
            keys.append(_orient(c, joined))
            equi.remove(c)
    return keys


def _has_aggregate(e) -> bool:
    from .parser import walk

    return any(isinstance(n, SFunc) and n.is_aggregate for n in walk(e))


_AGG_FN = {"sum": "sum", "avg": "mean", "min": "min", "max": "max"}


def _plan_aggregate(sel, res, plan, select_items, sel_aliases):
    # group keys: bare select-alias refs expand to the aliased expression
    keys: List[Tuple[str, object]] = []
    for i, g in enumerate(sel.group_by):
        if isinstance(g, SCol) and g.table is None and g.name in sel_aliases:
            ge = sel_aliases[g.name]
        else:
            ge = res.resolve(g)
        name = ge.internal if isinstance(ge, SCol) else f"__key_{i}"
        keys.append((name, ge))

    aggs: List[Tuple[str, str, object]] = []
    agg_map: Dict[SFunc, str] = {}

    def lift_agg(fn_call: SFunc) -> SCol:
        if fn_call not in agg_map:
            name = f"__agg_{len(agg_map)}"
            agg_map[fn_call] = name
            if fn_call.name == "count":
                if len(fn_call.args) != 1:
                    raise SqlError("COUNT takes one argument")
                arg = fn_call.args[0]
                if isinstance(arg, SStar):
                    aggs.append((name, "size", None))
                elif fn_call.distinct:
                    aggs.append((name, "nunique", arg))
                else:
                    aggs.append((name, "count", arg))
            else:
                if fn_call.distinct:
                    raise SqlError(
                        f"DISTINCT is only supported inside COUNT, not "
                        f"{fn_call.name.upper()}"
                    )
                if len(fn_call.args) != 1:
                    raise SqlError(f"{fn_call.name.upper()} takes one argument")
                aggs.append((name, _AGG_FN[fn_call.name], fn_call.args[0]))
        return SCol("", agg_map[fn_call])

    def rewrite(e):
        # replace group-key subexpressions first (top-down), then lift
        # aggregate calls
        for kname, kexpr in keys:
            e = _replace_subexpr(e, kexpr, SCol("", kname))
        return transform(
            e,
            lambda n: lift_agg(n)
            if isinstance(n, SFunc) and n.is_aggregate
            else n,
        )

    outputs = []
    for e, alias in select_items:
        re_ = rewrite(e)
        name = alias or (
            e.name if isinstance(e, SCol) else None
        )
        if name is None:
            raise SqlError(
                f"computed select column {format_expr(e)} needs an AS alias"
            )
        _check_grouped(re_, keys, f"select column {name!r}")
        outputs.append((name, re_))

    having = None
    if sel.having is not None:
        hv = sel.having
        # HAVING may reference select aliases
        for a, ae in sel_aliases.items():
            hv = _replace_subexpr(hv, SCol(None, a), ae)
        having = rewrite(res.resolve(hv))
        _check_grouped(having, keys, "HAVING")

    plan = Aggregate(plan, tuple(keys), tuple(aggs))
    if having is not None:
        plan = Filter(plan, having)

    def order_rewrite(e):
        # Same key/agg substitution the select list got, for ORDER BY
        # matching — but the Aggregate node is already built, so an
        # aggregate call NOT in the select list cannot be added here.
        n_before = len(agg_map)
        out = rewrite(e)
        if len(agg_map) != n_before:
            raise SqlError(
                f"ORDER BY aggregate {format_expr(e)} must also appear "
                f"in the select list"
            )
        return out

    return plan, outputs, order_rewrite


def _check_grouped(e, keys, where: str):
    key_names = {n for n, _ in keys}
    for c in expr_columns(e):
        if c.startswith("__agg_") or c in key_names:
            continue
        raise SqlError(
            f"column {c!r} in {where} must appear in GROUP BY or inside "
            f"an aggregate function"
        )


def _output_name_for(e, outputs, res, rewrite=None) -> str:
    out_names = {n for n, _ in outputs}
    if isinstance(e, SCol) and e.table is None and e.name in out_names:
        return e.name
    re_ = res.resolve(e)
    if rewrite is not None:
        re_ = rewrite(re_)
    for name, oe in outputs:
        if oe == re_:
            return name
    raise SqlError(
        f"ORDER BY expression {format_expr(e)} must be a select-list "
        f"column or alias (have {sorted(out_names)})"
    )


# ----------------------------------------------------------------------
# explain formatting
# ----------------------------------------------------------------------
def node_label(node) -> str:
    """One-line header for a plan node (no indentation, no children).
    Shared between ``format_plan`` and the EXPLAIN ANALYZE renderer
    (``repro_torch.sql.analyze``)."""
    if isinstance(node, Scan):
        cols = ", ".join(node.columns)
        tag = node.table if node.alias == node.table else f"{node.table} {node.alias}"
        pushed = ""
        if node.predicates:
            pushed = " pushed=" + " AND ".join(
                format_expr(p) for p in node.predicates
            )
        return f"Scan {tag} [{cols}]{pushed}"
    if isinstance(node, Filter):
        return f"Filter {format_expr(node.pred)}"
    if isinstance(node, Join):
        on = ", ".join(
            f"{l} = {r}" for l, r in zip(node.left_keys, node.right_keys)
        )
        return f"Join {node.how} on [{on}]"
    if isinstance(node, Aggregate):
        keys = ", ".join(
            n if isinstance(e, SCol) else f"{n}={format_expr(e)}"
            for n, e in node.keys
        )
        aggs = ", ".join(
            f"{n}={fn.upper()}({format_expr(e) if e is not None else '*'})"
            for n, fn, e in node.aggs
        )
        return f"Aggregate keys=[{keys}] aggs=[{aggs}]"
    if isinstance(node, Project):
        outs = ", ".join(
            n
            if isinstance(e, SCol)
            and (e.internal == n or e.internal.endswith("." + n))
            else f"{n}={format_expr(e)}"
            for n, e in node.outputs
        )
        return f"Project [{outs}]"
    if isinstance(node, Sort):
        keys = ", ".join(f"{n} {'ASC' if a else 'DESC'}" for n, a in node.keys)
        return f"Sort [{keys}]"
    if isinstance(node, Limit):
        return f"Limit {node.n}"
    if isinstance(node, Distinct):
        return "Distinct"
    if isinstance(node, Shared):
        return "Shared"
    if isinstance(node, AttachScalar):
        return f"AttachScalar {node.name} = scalar of [{node.output}]"
    raise TypeError(f"unknown plan node {type(node).__name__}")


def format_plan(node, indent: int = 0) -> str:
    return _format_plan(node, indent, {})


def _format_plan(node, indent: int, shared: dict) -> str:
    pad = "  " * indent
    if isinstance(node, Scan):
        return pad + node_label(node)
    if isinstance(node, Filter):
        out = (
            f"{pad}{node_label(node)}\n"
            + _format_plan(node.child, indent + 1, shared)
        )
        for m in subquery_markers(node.pred):
            out += (
                f"\n{pad}  [{m.name}] subquery:\n"
                + _format_plan(m.plan.v, indent + 2, shared)
            )
        return out
    if isinstance(node, Join):
        return (
            f"{pad}{node_label(node)}\n"
            + _format_plan(node.left, indent + 1, shared)
            + "\n"
            + _format_plan(node.right, indent + 1, shared)
        )
    if isinstance(node, (Aggregate, Project, Sort, Limit, Distinct)):
        return f"{pad}{node_label(node)}\n" + _format_plan(
            node.child, indent + 1, shared
        )
    if isinstance(node, Shared):
        sid = shared.get(node)
        if sid is not None:
            return f"{pad}Shared #{sid} (reused, emitted once)"
        sid = len(shared) + 1
        shared[node] = sid
        return f"{pad}Shared #{sid}\n" + _format_plan(
            node.child, indent + 1, shared
        )
    if isinstance(node, AttachScalar):
        return (
            f"{pad}{node_label(node)}\n"
            + _format_plan(node.child, indent + 1, shared)
            + f"\n{pad}  [{node.name}] subquery:\n"
            + _format_plan(node.sub.v, indent + 2, shared)
        )
    raise TypeError(f"unknown plan node {type(node).__name__}")
