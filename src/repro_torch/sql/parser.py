"""SQL tokenizer, expression AST, and recursive-descent parser.

Covers the TPC-H SELECT dialect: projections with aliases, arithmetic,
comparisons, AND/OR/NOT, IN, BETWEEN, LIKE, IS [NOT] NULL, CASE WHEN,
EXTRACT(YEAR|MONTH|DAY FROM e), DATE/INTERVAL literals, aggregate calls
(COUNT/SUM/AVG/MIN/MAX, COUNT(*), COUNT(DISTINCT c)), SELECT DISTINCT,
comma-separated FROM lists with aliases, derived tables
(``FROM (SELECT ...) alias``), [INNER|LEFT] JOIN ... ON, WHERE,
GROUP BY, HAVING, ORDER BY [ASC|DESC], LIMIT, and subqueries: scalar
``(SELECT ...)`` in expressions, ``[NOT] IN (SELECT ...)`` and
``[NOT] EXISTS (SELECT ...)`` predicates (correlation is resolved by
the planner, decorrelation by the optimizer).

All AST nodes are frozen dataclasses: structural equality/hash are used
by the planner to deduplicate aggregate expressions and by tests for
plan comparison.  Nested SELECTs are wrapped in ``Boxed`` — a plain
(non-dataclass) holder with value equality — so the generic
``walk``/``transform`` helpers do not descend across scope boundaries.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional, Tuple

import numpy as np


class SqlError(ValueError):
    """Parse/plan/lowering error with a human-readable message."""


class Boxed:
    """Opaque holder for a nested SELECT (or a planned subquery tree).

    Not a dataclass on purpose: ``walk``/``transform``/``expr_columns``
    skip non-dataclass field values, so an outer-scope rewrite never
    descends into a subquery's own expressions.  Equality and hash
    delegate to the wrapped value so AST equality still works."""

    __slots__ = ("v",)

    def __init__(self, v):
        self.v = v

    def __eq__(self, other):
        return isinstance(other, Boxed) and self.v == other.v

    def __ne__(self, other):
        return not self.__eq__(other)

    def __hash__(self):
        return hash(self.v)

    def __repr__(self):
        return f"Boxed({self.v!r})"


# ----------------------------------------------------------------------
# expression AST
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SCol:
    table: Optional[str]  # alias qualifier; "" = resolved output-name ref
    name: str

    @property
    def internal(self) -> str:
        if self.table:
            return f"{self.table}.{self.name}"
        return self.name


@dataclasses.dataclass(frozen=True)
class SLit:
    value: object  # int | float | str | bool


@dataclasses.dataclass(frozen=True)
class SDate:
    days: int  # epoch days

    @property
    def text(self) -> str:
        return str(np.datetime64(self.days, "D"))


@dataclasses.dataclass(frozen=True)
class SInterval:
    days: int


@dataclasses.dataclass(frozen=True)
class SBin:
    op: str  # + - * /
    a: object
    b: object


@dataclasses.dataclass(frozen=True)
class SCmp:
    op: str  # = <> < <= > >=
    a: object
    b: object


@dataclasses.dataclass(frozen=True)
class SAnd:
    a: object
    b: object


@dataclasses.dataclass(frozen=True)
class SOr:
    a: object
    b: object


@dataclasses.dataclass(frozen=True)
class SNot:
    a: object


@dataclasses.dataclass(frozen=True)
class SIn:
    e: object
    values: Tuple[object, ...]  # literal nodes
    negated: bool = False


@dataclasses.dataclass(frozen=True)
class SBetween:
    e: object
    lo: object
    hi: object
    negated: bool = False


@dataclasses.dataclass(frozen=True)
class SLike:
    e: object
    pattern: str
    negated: bool = False


@dataclasses.dataclass(frozen=True)
class SIsNull:
    e: object
    negated: bool = False


def like_prefix(pattern: str) -> Optional[str]:
    """The literal prefix of a sargable ``LIKE 'prefix%'`` pattern, or
    None when the pattern is not a pure prefix match (wildcards other
    than one trailing ``%``)."""
    if not pattern.endswith("%"):
        return None
    body = pattern[:-1]
    if "%" in body or "_" in body:
        return None
    return body


@dataclasses.dataclass(frozen=True)
class SCase:
    whens: Tuple[Tuple[object, object], ...]
    default: object


@dataclasses.dataclass(frozen=True)
class SExtract:
    field: str  # year | month | day
    e: object


AGG_FUNCS = ("count", "sum", "avg", "min", "max")

# non-aggregate functions the engine and the oracle both implement
SCALAR_FUNCS = ("abs", "sqrt", "floor", "exp", "log", "sin", "cos", "substring")


@dataclasses.dataclass(frozen=True)
class SFunc:
    name: str  # lowercase
    args: Tuple[object, ...]
    distinct: bool = False

    @property
    def is_aggregate(self) -> bool:
        return self.name in AGG_FUNCS


@dataclasses.dataclass(frozen=True)
class SStar:
    pass


@dataclasses.dataclass(frozen=True)
class SSub:
    """Scalar subquery ``(SELECT ...)`` used as an expression."""

    select: Boxed  # Boxed[Select]


@dataclasses.dataclass(frozen=True)
class SInSub:
    """``e [NOT] IN (SELECT ...)``."""

    e: object
    select: Boxed  # Boxed[Select]
    negated: bool = False


@dataclasses.dataclass(frozen=True)
class SExists:
    """``[NOT] EXISTS (SELECT ...)``."""

    select: Boxed  # Boxed[Select]
    negated: bool = False


# ----------------------------------------------------------------------
# statement AST
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class FromItem:
    table: str  # "" for a derived table
    alias: str
    sub: Optional[Boxed] = None  # Boxed[Select] for derived tables


@dataclasses.dataclass(frozen=True)
class JoinClause:
    item: FromItem
    how: str  # inner | left
    on: object


@dataclasses.dataclass(frozen=True)
class Select:
    columns: Tuple[Tuple[object, Optional[str]], ...]  # (expr, alias)
    from_items: Tuple[FromItem, ...]
    joins: Tuple[JoinClause, ...]
    where: Optional[object]
    group_by: Tuple[object, ...]
    having: Optional[object]
    order_by: Tuple[Tuple[object, bool], ...]  # (expr, ascending)
    limit: Optional[int]
    distinct: bool = False


# ----------------------------------------------------------------------
# tokenizer
# ----------------------------------------------------------------------
_TOKEN_RE = re.compile(
    r"""
      (?P<ws>\s+|--[^\n]*)
    | (?P<num>\d+\.\d*|\.\d+|\d+)
    | (?P<str>'(?:[^']|'')*')
    | (?P<op><=|>=|<>|!=|[=<>+\-*/(),.])
    | (?P<name>[A-Za-z_][A-Za-z_0-9]*)
    """,
    re.VERBOSE,
)

# "year"/"month"/"day" are deliberately NOT reserved: they are common
# column aliases.  INTERVAL and EXTRACT match them contextually.
KEYWORDS = {
    "select", "from", "where", "group", "by", "having", "order", "limit",
    "as", "and", "or", "not", "in", "between", "like", "is", "null",
    "case", "when", "then", "else", "end", "extract", "date", "interval",
    "join", "inner", "left", "outer", "on", "exists",
    "asc", "desc", "distinct", "true", "false",
}

_DATE_UNITS = ("year", "month", "day")


@dataclasses.dataclass
class Token:
    kind: str  # num | str | op | name | kw | end
    text: str
    pos: int


def tokenize(sql: str):
    out = []
    i = 0
    while i < len(sql):
        m = _TOKEN_RE.match(sql, i)
        if not m:
            raise SqlError(f"unexpected character {sql[i]!r} at position {i}")
        i = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        text = m.group()
        if kind == "name" and text.lower() in KEYWORDS:
            out.append(Token("kw", text.lower(), m.start()))
        else:
            out.append(Token(kind, text, m.start()))
    out.append(Token("end", "", len(sql)))
    return out


# ----------------------------------------------------------------------
# parser
# ----------------------------------------------------------------------
class _Parser:
    def __init__(self, sql: str):
        self.sql = sql
        self.toks = tokenize(sql)
        self.i = 0

    # -------- token plumbing --------
    @property
    def cur(self) -> Token:
        return self.toks[self.i]

    def advance(self) -> Token:
        t = self.cur
        self.i += 1
        return t

    def at_kw(self, *kws: str) -> bool:
        return self.cur.kind == "kw" and self.cur.text in kws

    def accept_kw(self, *kws: str) -> bool:
        if self.at_kw(*kws):
            self.advance()
            return True
        return False

    def expect_kw(self, kw: str) -> None:
        if not self.accept_kw(kw):
            self.fail(f"expected {kw.upper()}")

    def accept_op(self, op: str) -> bool:
        if self.cur.kind == "op" and self.cur.text == op:
            self.advance()
            return True
        return False

    def expect_op(self, op: str) -> None:
        if not self.accept_op(op):
            self.fail(f"expected {op!r}")

    def fail(self, msg: str):
        t = self.cur
        got = t.text or "<end of input>"
        raise SqlError(f"{msg} at position {t.pos} (got {got!r})")

    # -------- grammar --------
    def parse(self) -> Select:
        self.expect_kw("select")
        sel = self.select_body()
        if self.cur.kind != "end":
            self.fail("trailing input after query")
        return sel

    def select_body(self) -> Select:
        distinct = self.accept_kw("distinct")
        columns = [self.select_item()]
        while self.accept_op(","):
            columns.append(self.select_item())
        self.expect_kw("from")
        from_items = [self.from_item()]
        joins = []
        while True:
            if self.accept_op(","):
                from_items.append(self.from_item())
            elif self.at_kw("join", "inner", "left"):
                joins.append(self.join_clause())
            else:
                break
        where = self.expr() if self.accept_kw("where") else None
        group_by: Tuple = ()
        if self.accept_kw("group"):
            self.expect_kw("by")
            keys = [self.expr()]
            while self.accept_op(","):
                keys.append(self.expr())
            group_by = tuple(keys)
        having = self.expr() if self.accept_kw("having") else None
        order_by = []
        if self.accept_kw("order"):
            self.expect_kw("by")
            order_by.append(self.order_item())
            while self.accept_op(","):
                order_by.append(self.order_item())
        limit = None
        if self.accept_kw("limit"):
            t = self.advance()
            if t.kind != "num" or "." in t.text:
                raise SqlError(f"LIMIT expects an integer at position {t.pos}")
            limit = int(t.text)
        return Select(
            tuple(columns), tuple(from_items), tuple(joins), where,
            group_by, having, tuple(order_by), limit, distinct,
        )

    def subselect(self) -> Boxed:
        """Parse ``SELECT ...`` (the opening keyword already expected by
        the caller) and box it against outer-scope tree rewrites."""
        self.expect_kw("select")
        return Boxed(self.select_body())

    def select_item(self):
        if self.accept_op("*"):
            return (SStar(), None)
        e = self.expr()
        alias = None
        if self.accept_kw("as"):
            alias = self.identifier("alias")
        elif self.cur.kind == "name":  # bare alias
            alias = self.advance().text
        return (e, alias)

    def identifier(self, what: str) -> str:
        if self.cur.kind != "name":
            self.fail(f"expected {what}")
        return self.advance().text

    def date_unit(self) -> str:
        if self.cur.kind == "name" and self.cur.text.lower() in _DATE_UNITS:
            return self.advance().text.lower()
        self.fail("expected YEAR, MONTH or DAY")

    def from_item(self) -> FromItem:
        if self.accept_op("("):  # derived table: (SELECT ...) alias
            sub = self.subselect()
            self.expect_op(")")
            self.accept_kw("as")
            alias = self.identifier("derived-table alias")
            return FromItem("", alias, sub)
        table = self.identifier("table name")
        alias = table
        if self.accept_kw("as"):
            alias = self.identifier("alias")
        elif self.cur.kind == "name":
            alias = self.advance().text
        return FromItem(table, alias)

    def join_clause(self) -> JoinClause:
        how = "inner"
        if self.accept_kw("left"):
            self.accept_kw("outer")
            how = "left"
        else:
            self.accept_kw("inner")
        self.expect_kw("join")
        item = self.from_item()
        self.expect_kw("on")
        return JoinClause(item, how, self.expr())

    def order_item(self):
        e = self.expr()
        asc = True
        if self.accept_kw("desc"):
            asc = False
        else:
            self.accept_kw("asc")
        return (e, asc)

    # -------- expressions (precedence climbing) --------
    def expr(self):
        return self.or_expr()

    def or_expr(self):
        e = self.and_expr()
        while self.accept_kw("or"):
            e = SOr(e, self.and_expr())
        return e

    def and_expr(self):
        e = self.not_expr()
        while self.accept_kw("and"):
            e = SAnd(e, self.not_expr())
        return e

    def not_expr(self):
        if self.accept_kw("not"):
            return SNot(self.not_expr())
        return self.predicate()

    def predicate(self):
        e = self.additive()
        negated = self.accept_kw("not")
        if self.accept_kw("in"):
            self.expect_op("(")
            if self.at_kw("select"):
                sub = self.subselect()
                self.expect_op(")")
                return SInSub(e, sub, negated)
            vals = [self.additive()]
            while self.accept_op(","):
                vals.append(self.additive())
            self.expect_op(")")
            return SIn(e, tuple(vals), negated)
        if self.accept_kw("between"):
            lo = self.additive()
            self.expect_kw("and")
            hi = self.additive()
            return SBetween(e, lo, hi, negated)
        if self.accept_kw("like"):
            t = self.advance()
            if t.kind != "str":
                raise SqlError(f"LIKE expects a string pattern at position {t.pos}")
            return SLike(e, _unquote(t.text), negated)
        if negated:
            self.fail("expected IN, BETWEEN or LIKE after NOT")
        if self.accept_kw("is"):
            neg = self.accept_kw("not")
            self.expect_kw("null")
            return SIsNull(e, neg)
        for op in ("<=", ">=", "<>", "!=", "=", "<", ">"):
            if self.accept_op(op):
                rhs = self.additive()
                return SCmp("<>" if op == "!=" else op, e, rhs)
        return e

    def additive(self):
        e = self.multiplicative()
        while True:
            if self.accept_op("+"):
                e = SBin("+", e, self.multiplicative())
            elif self.accept_op("-"):
                e = SBin("-", e, self.multiplicative())
            else:
                return e

    def multiplicative(self):
        e = self.unary()
        while True:
            if self.accept_op("*"):
                e = SBin("*", e, self.unary())
            elif self.accept_op("/"):
                e = SBin("/", e, self.unary())
            else:
                return e

    def unary(self):
        if self.accept_op("-"):
            inner = self.unary()
            if isinstance(inner, SLit) and isinstance(inner.value, (int, float)):
                return SLit(-inner.value)
            return SBin("-", SLit(0), inner)
        return self.primary()

    def primary(self):
        t = self.cur
        if self.accept_op("("):
            if self.at_kw("select"):  # scalar subquery
                sub = self.subselect()
                self.expect_op(")")
                return SSub(sub)
            e = self.expr()
            self.expect_op(")")
            return e
        if self.accept_kw("exists"):
            self.expect_op("(")
            sub = self.subselect()
            self.expect_op(")")
            return SExists(sub)
        if t.kind == "num":
            self.advance()
            return SLit(float(t.text) if "." in t.text else int(t.text))
        if t.kind == "str":
            self.advance()
            return SLit(_unquote(t.text))
        if self.accept_kw("true"):
            return SLit(True)
        if self.accept_kw("false"):
            return SLit(False)
        if self.accept_kw("date"):
            s = self.advance()
            if s.kind != "str":
                raise SqlError(f"DATE expects a 'YYYY-MM-DD' string at position {s.pos}")
            try:
                days = int(np.datetime64(_unquote(s.text), "D").astype(np.int64))
            except ValueError as e:
                raise SqlError(f"bad DATE literal {s.text} at position {s.pos}") from e
            return SDate(days)
        if self.accept_kw("interval"):
            s = self.advance()
            if s.kind != "str":
                raise SqlError(f"INTERVAL expects a quoted count at position {s.pos}")
            n = int(_unquote(s.text))
            unit = self.date_unit()
            if unit != "day":
                # calendar month/year arithmetic is NOT a fixed day
                # count; a 30/365-day approximation would give
                # plausible-but-wrong dates that every execution leg
                # agrees on, so refuse instead.
                raise SqlError(
                    f"INTERVAL ... {unit.upper()} is not supported (calendar "
                    f"arithmetic); use an explicit DATE literal or DAY units"
                )
            return SInterval(n)
        if self.accept_kw("case"):
            return self.case_expr()
        if self.accept_kw("extract"):
            self.expect_op("(")
            field = self.date_unit()
            if not (self.cur.kind == "kw" and self.cur.text == "from"):
                self.fail("expected FROM in EXTRACT")
            self.advance()
            e = self.expr()
            self.expect_op(")")
            return SExtract(field, e)
        if t.kind == "name":
            self.advance()
            if self.accept_op("("):  # function call
                return self.func_call(t.text.lower())
            if self.accept_op("."):
                name = self.identifier("column name")
                return SCol(t.text, name)
            return SCol(None, t.text)
        self.fail("expected an expression")

    def func_call(self, name: str):
        if self.accept_op("*"):
            self.expect_op(")")
            if name != "count":
                raise SqlError(f"{name.upper()}(*) is not supported")
            return SFunc("count", (SStar(),))
        distinct = self.accept_kw("distinct")
        args = []
        if not self.accept_op(")"):
            args.append(self.expr())
            while self.accept_op(","):
                args.append(self.expr())
            self.expect_op(")")
        return SFunc(name, tuple(args), distinct)

    def case_expr(self):
        whens = []
        while self.accept_kw("when"):
            cond = self.expr()
            self.expect_kw("then")
            whens.append((cond, self.expr()))
        if not whens:
            self.fail("CASE requires at least one WHEN")
        default = SLit(None)
        if self.accept_kw("else"):
            default = self.expr()
        self.expect_kw("end")
        return SCase(tuple(whens), default)


def _unquote(s: str) -> str:
    return s[1:-1].replace("''", "'")


def parse(sql: str) -> Select:
    """Parse a SELECT statement into the statement AST."""
    return _Parser(sql).parse()


# ----------------------------------------------------------------------
# expression utilities shared by planner/optimizer
# ----------------------------------------------------------------------
def split_conjuncts(e):
    """Flatten nested ANDs into a list of conjuncts."""
    if isinstance(e, SAnd):
        return split_conjuncts(e.a) + split_conjuncts(e.b)
    return [e]


def conjoin(parts):
    out = None
    for p in parts:
        out = p if out is None else SAnd(out, p)
    return out


def walk(e):
    """Yield every node of an expression tree (pre-order)."""
    yield e
    for f in dataclasses.fields(e):
        v = getattr(e, f.name)
        if dataclasses.is_dataclass(v):
            yield from walk(v)
        elif isinstance(v, tuple):
            for item in v:
                if dataclasses.is_dataclass(item):
                    yield from walk(item)
                elif isinstance(item, tuple):  # SCase whens
                    for sub in item:
                        if dataclasses.is_dataclass(sub):
                            yield from walk(sub)


def expr_columns(e):
    """Set of internal column names referenced by an expression."""
    return {n.internal for n in walk(e) if isinstance(n, SCol)}


def _transform_item(x, fn):
    if dataclasses.is_dataclass(x):
        return transform(x, fn)
    if isinstance(x, tuple):
        return tuple(_transform_item(s, fn) for s in x)
    return x


def transform(e, fn):
    """Bottom-up rewrite: apply ``fn`` to every node, children first."""
    if not dataclasses.is_dataclass(e):
        return e
    changes = {}
    for f in dataclasses.fields(e):
        v = getattr(e, f.name)
        nv = _transform_item(v, fn)
        if nv != v:
            changes[f.name] = nv
    if changes:
        e = dataclasses.replace(e, **changes)
    return fn(e)


def _sql_str(s: str) -> str:
    return "'" + s.replace("'", "''") + "'"


def format_expr(e) -> str:
    """SQL rendering for explain(); simple expressions re-parse to an
    equal AST (see the round-trip tests)."""
    if isinstance(e, SCol):
        return e.internal
    if isinstance(e, SLit):
        return _sql_str(e.value) if isinstance(e.value, str) else str(e.value)
    if isinstance(e, SDate):
        return f"DATE '{e.text}'"
    if isinstance(e, SInterval):
        return f"INTERVAL '{e.days}' DAY"
    if isinstance(e, SBin):
        return f"({format_expr(e.a)} {e.op} {format_expr(e.b)})"
    if isinstance(e, SCmp):
        return f"({format_expr(e.a)} {e.op} {format_expr(e.b)})"
    if isinstance(e, SAnd):
        return f"({format_expr(e.a)} AND {format_expr(e.b)})"
    if isinstance(e, SOr):
        return f"({format_expr(e.a)} OR {format_expr(e.b)})"
    if isinstance(e, SNot):
        return f"(NOT {format_expr(e.a)})"
    if isinstance(e, SIn):
        vals = ", ".join(format_expr(v) for v in e.values)
        return f"({format_expr(e.e)} {'NOT ' if e.negated else ''}IN ({vals}))"
    if isinstance(e, SBetween):
        return (
            f"({format_expr(e.e)} {'NOT ' if e.negated else ''}BETWEEN "
            f"{format_expr(e.lo)} AND {format_expr(e.hi)})"
        )
    if isinstance(e, SLike):
        pat = _sql_str(e.pattern)
        return f"({format_expr(e.e)} {'NOT ' if e.negated else ''}LIKE {pat})"
    if isinstance(e, SIsNull):
        return f"({format_expr(e.e)} IS {'NOT ' if e.negated else ''}NULL)"
    if isinstance(e, SCase):
        parts = " ".join(
            f"WHEN {format_expr(c)} THEN {format_expr(r)}" for c, r in e.whens
        )
        tail = "" if e.default == SLit(None) else f" ELSE {format_expr(e.default)}"
        return f"CASE {parts}{tail} END"
    if isinstance(e, SExtract):
        return f"EXTRACT({e.field.upper()} FROM {format_expr(e.e)})"
    if isinstance(e, SFunc):
        inner = ", ".join(
            "*" if isinstance(a, SStar) else format_expr(a) for a in e.args
        )
        d = "DISTINCT " if e.distinct else ""
        return f"{e.name.upper()}({d}{inner})"
    if isinstance(e, SStar):
        return "*"
    if isinstance(e, SSub):
        return f"({format_select(e.select.v)})"
    if isinstance(e, SInSub):
        neg = "NOT " if e.negated else ""
        return f"({format_expr(e.e)} {neg}IN ({format_select(e.select.v)}))"
    if isinstance(e, SExists):
        neg = "NOT " if e.negated else ""
        return f"({neg}EXISTS ({format_select(e.select.v)}))"
    if hasattr(e, "render"):  # planned subquery markers (plan.py)
        return e.render()
    return repr(e)


def format_select(sel: Select) -> str:
    """Render a statement AST back to SQL text (single line).

    The output re-parses to an equal AST, which the round-trip tests
    rely on; it is also used by explain() for unplanned subqueries."""
    cols = ", ".join(
        ("*" if isinstance(e, SStar) else format_expr(e))
        + (f" AS {a}" if a else "")
        for e, a in sel.columns
    )
    def item_sql(it: FromItem) -> str:
        if it.sub is not None:
            return f"({format_select(it.sub.v)}) AS {it.alias}"
        if it.alias != it.table:
            return f"{it.table} {it.alias}"
        return it.table

    items = ", ".join(item_sql(it) for it in sel.from_items)
    out = f"SELECT {'DISTINCT ' if sel.distinct else ''}{cols} FROM {items}"
    for jc in sel.joins:
        out += (
            f" {jc.how.upper()} JOIN {item_sql(jc.item)} "
            f"ON {format_expr(jc.on)}"
        )
    if sel.where is not None:
        out += f" WHERE {format_expr(sel.where)}"
    if sel.group_by:
        out += " GROUP BY " + ", ".join(format_expr(g) for g in sel.group_by)
    if sel.having is not None:
        out += f" HAVING {format_expr(sel.having)}"
    if sel.order_by:
        out += " ORDER BY " + ", ".join(
            f"{format_expr(e)} {'ASC' if asc else 'DESC'}" for e, asc in sel.order_by
        )
    if sel.limit is not None:
        out += f" LIMIT {sel.limit}"
    return out
