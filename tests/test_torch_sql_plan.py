"""The cases of tests/test_sql_plan.py on the port's SQL front end, each
held to the JAX package's answer on the same tiny ``emp``/``dept`` scope:
parsed statements by their ``repr`` and by ``format_select`` round
trips, plans by ``format_plan``/``explain`` text, results by
``frame_to_odf`` (and, for the subquery cases, by the port's oracle
backend on the naive plan), errors by type and message.  Pure
plan-level tests on tiny frames, no TPC data."""
import numpy as np
import pytest

import jax

from repro import sql as j_sql
from repro.core import TensorFrame as JFrame
from repro.sql import optimize as j_optimize
from repro.sql import parser as j_parser
from repro.sql import plan as j_plan
from repro_torch import queries, sql
from repro_torch.core import TensorFrame
from repro_torch.core import oracle as orc
from repro_torch.sql import optimize as O
from repro_torch.sql import parser as P
from repro_torch.sql import plan as PL
from repro_torch.sql.oracle_backend import execute_oracle

TABLES = {
    "emp": {
        "id": np.arange(6),
        "dept": np.array(list("abacba"), dtype=object),
        "sal": np.array([10.0, 20.0, 30.0, 40.0, 50.0, 60.0]),
        "hired": np.array(
            ["2020-01-01", "2021-06-01", "2020-03-01", "2022-01-01", "2021-01-01", "2020-06-15"],
            dtype="datetime64[D]",
        ),
    },
    "dept": {
        "name": np.array(list("abc"), dtype=object),
        "loc": np.array(["x", "y", "x"], dtype=object),
        "budget": np.array([100.0, 200.0, 300.0]),
    },
}

CATALOG = {
    "emp": ["id", "dept", "sal", "hired"],
    "dept": ["name", "loc", "budget"],
}


@pytest.fixture(autouse=True, scope="module")
def _x64_on(_x64_policy):
    # the conftest policy turns x64 off for this file's prefix; the
    # reference engine needs exact int64 keys
    jax.config.update("jax_enable_x64", True)
    yield


@pytest.fixture(scope="module")
def scopes():
    port = {n: TensorFrame.from_arrays(t, device="cpu") for n, t in TABLES.items()}
    ref = {n: JFrame.from_arrays(t) for n, t in TABLES.items()}
    return port, ref


# ----------------------------------------------------------------------
# tokenizer / parser
# ----------------------------------------------------------------------
PARSE_TEXTS = [
    "SELECT a, b AS bee FROM t WHERE a > 1 ORDER BY a DESC LIMIT 3",
    "SELECT a FROM t WHERE a = 1 OR b = 2 AND c = 3",
    "SELECT a + b * c AS x FROM t",
    "SELECT a FROM t WHERE a IN (1, 2) AND b NOT LIKE 'x%' "
    "AND c BETWEEN 1 AND 5 AND d IS NOT NULL AND NOT e = 1",
    "SELECT CASE WHEN a = 1 THEN 2 ELSE 0 END AS c, "
    "EXTRACT(YEAR FROM d) AS y, DATE '1994-01-01' AS t0 FROM t",
    "SELECT COUNT(*) AS n, COUNT(DISTINCT a) AS u, SUM(b) AS s FROM t",
    "SELECT a FROM t LEFT JOIN u ON t.k = u.k JOIN v ON v.j = t.j",
    "SELECT a FROM t -- trailing comment\nWHERE b = 'it''s'",
]


@pytest.mark.parametrize("text", PARSE_TEXTS)
def test_parse_matches_jax(text):
    """The same AST, node for node (dataclass reprs name every field)."""
    assert repr(P.parse(text)) == repr(j_parser.parse(text))


def test_parse_structure():
    ast = P.parse(PARSE_TEXTS[0])
    assert ast.columns == ((P.SCol(None, "a"), None), (P.SCol(None, "b"), "bee"))
    assert ast.where == P.SCmp(">", P.SCol(None, "a"), P.SLit(1))
    assert ast.order_by == ((P.SCol(None, "a"), False),) and ast.limit == 3
    parts = P.split_conjuncts(P.parse(PARSE_TEXTS[3]).where)
    assert parts[1] == P.SLike(P.SCol(None, "b"), "x%", negated=True)
    assert parts[4] == P.SNot(P.SCmp("=", P.SCol(None, "e"), P.SLit(1)))
    assert P.parse(PARSE_TEXTS[7]).where == P.SCmp("=", P.SCol(None, "b"), P.SLit("it's"))


@pytest.mark.parametrize(
    "bad, msg",
    [
        ("SELECT", "expected an expression"),
        ("SELECT a", "expected FROM"),
        ("SELECT a FROM t WHERE", "expected an expression"),
        ("SELECT a FROM t GROUP a", "expected BY"),
        ("SELECT a FROM t LIMIT x", "LIMIT expects an integer"),
        ("SELECT a FROM t; DROP TABLE t", "unexpected character"),
        ("SELECT a FROM t extra garbage (", "trailing input"),
        ("SELECT MAX(*) AS m FROM t", "MAX(*) is not supported"),
        (
            "SELECT a FROM t WHERE d < DATE '1993-10-01' + INTERVAL '3' MONTH",
            "INTERVAL ... MONTH is not supported",
        ),
        ("SELECT 'unterminated FROM t", "unexpected character"),
        ("SELECT a FROM t WHERE b = 'still open", "unexpected character"),
        ("SELECT id FROM emp WHERE sal IN (", "expected an expression"),
        ("SELECT id FROM emp WHERE EXISTS sal", "expected '('"),
        ("SELECT a FROM (SELECT b FROM t)", "derived-table alias"),
    ],
)
def test_parse_errors_match_jax(bad, msg):
    with pytest.raises(P.SqlError) as ei:
        P.parse(bad)
    with pytest.raises(j_parser.SqlError) as ej:
        j_parser.parse(bad)
    assert isinstance(ei.value, ValueError)
    assert str(ei.value) == str(ej.value) and msg in str(ei.value)


ROUNDTRIP_QUERIES = [
    "SELECT a, b AS bee FROM t WHERE a > 1 ORDER BY a DESC LIMIT 3",
    "SELECT a FROM t WHERE a IN (1, 2) AND b NOT LIKE 'x%' "
    "AND c BETWEEN 1 AND 5 AND d IS NOT NULL AND NOT e = 1",
    "SELECT CASE WHEN a = 1 THEN 2 ELSE 0 END AS c, "
    "EXTRACT(YEAR FROM d) AS y, DATE '1994-01-01' AS t0 FROM t",
    "SELECT COUNT(*) AS n, COUNT(DISTINCT a) AS u, SUM(b + 1) AS s FROM t "
    "GROUP BY g HAVING COUNT(*) > 2",
    "SELECT DISTINCT a FROM t WHERE s = 'it''s' OR a * 2 < b / 3",
    "SELECT a FROM t WHERE d < DATE '1995-06-01' - INTERVAL '90' DAY",
    "SELECT a FROM t LEFT JOIN u ON t.k = u.k WHERE u.v IS NULL",
    "SELECT a FROM t WHERE EXISTS (SELECT * FROM u WHERE u.k = t.a)",
    "SELECT a FROM t WHERE b NOT IN (SELECT k FROM u WHERE w > 0)",
    "SELECT a FROM t WHERE c > (SELECT MAX(k) FROM u)",
    "SELECT x, SUM(v) AS s FROM (SELECT a AS x, b AS v FROM t) d GROUP BY x",
    "SELECT SUBSTRING(p, 1, 2) AS cc FROM t WHERE CASE WHEN a = 1 THEN 2 END = 2",
    "SELECT a FROM t INNER JOIN (SELECT k FROM u) d ON t.a = d.k",
]


@pytest.mark.parametrize("q", ROUNDTRIP_QUERIES)
def test_format_select_round_trips(q):
    ast = P.parse(q)
    rendered = P.format_select(ast)
    assert rendered == j_parser.format_select(j_parser.parse(q))
    assert P.parse(rendered) == ast, rendered


def test_format_expr_round_trips_where_clause():
    q = (
        "SELECT a FROM t WHERE a IN (1, 2) AND b LIKE 'x%' AND "
        "c BETWEEN 1 AND 5 AND NOT d = DATE '1994-01-01' AND e + 1 > 2 * f"
    )
    where = P.parse(q).where
    rendered = P.format_expr(where)
    assert rendered == j_parser.format_expr(j_parser.parse(q).where)
    assert P.parse(f"SELECT a FROM t WHERE {rendered}").where == where


# ----------------------------------------------------------------------
# planner: resolution + errors
# ----------------------------------------------------------------------
@pytest.mark.parametrize(
    "text, catalog, msgs",
    [
        ("SELECT x FROM nosuch", CATALOG, ["unknown table 'nosuch'", "emp"]),
        ("SELECT wages FROM emp", CATALOG, ["unknown column 'wages'"]),
        ("SELECT e.wages FROM emp e", CATALOG, ["unknown column 'wages'", "'emp'"]),
        ("SELECT k FROM a, b WHERE v = w", {"a": ["k", "v"], "b": ["k", "w"]},
         ["ambiguous column 'k'"]),
        ("SELECT id FROM emp, dept", CATALOG, ["cross joins"]),
        ("SELECT sal, COUNT(*) AS n FROM emp GROUP BY dept", CATALOG,
         ["must appear in GROUP BY"]),
        ("SELECT dept FROM emp ORDER BY sal", CATALOG, ["ORDER BY"]),
        ("SELECT MEDIAN(sal) AS m FROM emp GROUP BY dept", CATALOG,
         ["unknown function 'MEDIAN'", "SUM"]),
        ("SELECT SUM(DISTINCT sal) AS s FROM emp GROUP BY dept", CATALOG,
         ["DISTINCT is only supported inside COUNT"]),
    ],
)
def test_plan_errors_match_jax(text, catalog, msgs):
    with pytest.raises(P.SqlError) as ei:
        PL.build_plan(P.parse(text), catalog)
    with pytest.raises(j_parser.SqlError) as ej:
        j_plan.build_plan(j_parser.parse(text), catalog)
    assert str(ei.value) == str(ej.value)
    for msg in msgs:
        assert msg in str(ei.value)


def test_self_join_aliases_resolve():
    text = "SELECT e1.id AS a, e2.id AS b FROM emp e1, emp e2 WHERE e1.dept = e2.dept"
    txt = PL.format_plan(PL.build_plan(P.parse(text), CATALOG))
    assert txt == j_plan.format_plan(j_plan.build_plan(j_parser.parse(text), CATALOG))
    assert "emp e1" in txt and "emp e2" in txt and "e1.dept = e2.dept" in txt


# ----------------------------------------------------------------------
# optimizer rule 1: constant folding
# ----------------------------------------------------------------------
def _day(s):
    return int(np.datetime64(s).astype(np.int64))


def _x(M):
    return M.SCmp("=", M.SCol("t", "a"), M.SLit(1))


FOLDS = {
    "add": (lambda M: M.SBin("+", M.SLit(5), M.SLit(10)), lambda M: M.SLit(15)),
    "mixed": (lambda M: M.SBin("*", M.SLit(2.0), M.SBin("-", M.SLit(1), M.SLit(0.5))),
              lambda M: M.SLit(1.0)),
    "cmp": (lambda M: M.SCmp("<", M.SLit(1), M.SLit(2)), lambda M: M.SLit(True)),
    "date-interval": (lambda M: M.SBin("-", M.SDate(_day("1998-12-01")), M.SInterval(90)),
                      lambda M: M.SDate(_day("1998-09-02"))),
    "date-date": (lambda M: M.SBin("-", M.SDate(_day("1998-12-01")),
                                   M.SDate(_day("1998-12-01") - 7)),
                  lambda M: M.SLit(7)),
    "and-true": (lambda M: M.SAnd(M.SLit(True), _x(M)), _x),
    "and-false": (lambda M: M.SAnd(M.SLit(False), _x(M)), lambda M: M.SLit(False)),
    "or-false": (lambda M: M.SOr(_x(M), M.SLit(False)), _x),
    "not": (lambda M: M.SNot(M.SLit(False)), lambda M: M.SLit(True)),
    "dead-case": (lambda M: M.SCase(((M.SCmp("<", M.SLit(2), M.SLit(1)), M.SLit(10)),),
                                    M.SLit(0)),
                  lambda M: M.SLit(0)),
}


@pytest.mark.parametrize("case", list(FOLDS))
def test_fold_expr_matches_jax(case):
    make, want = FOLDS[case]
    got = O.fold_expr(make(P))
    assert got == want(P)
    assert repr(got) == repr(j_optimize.fold_expr(make(j_parser)))


# ----------------------------------------------------------------------
# optimizer rules (folding, filter pushdown, projection pruning,
# decorrelation narrowing): the naive and the optimized plan of each
# ----------------------------------------------------------------------
PLANS = {
    "fold-in-plan": "SELECT id FROM emp WHERE hired < DATE '2021-01-01' + INTERVAL '31' DAY "
    "AND sal > 10 + 5",
    "pushdown-below-join": "SELECT id FROM emp, dept WHERE dept = name AND loc = 'x' AND sal > 15",
    "cross-table-pred-above": "SELECT id FROM emp, dept WHERE dept = name AND sal > budget",
    "not-below-left-join": "SELECT id FROM emp LEFT JOIN dept ON dept = name WHERE loc = 'x'",
    "having-on-key": "SELECT dept, COUNT(*) AS n FROM emp GROUP BY dept HAVING dept <> 'c'",
    "having-on-agg": "SELECT dept, SUM(sal) AS s FROM emp GROUP BY dept HAVING SUM(sal) > 50",
    "pruning": "SELECT loc, SUM(sal) AS s FROM emp, dept WHERE dept = name GROUP BY loc",
    "pruning-aggs": "SELECT dd, n FROM (SELECT dept AS dd, COUNT(*) AS n, "
    "SUM(sal) AS s, MIN(sal) AS m FROM emp GROUP BY dept) t",
    "snapshot": "SELECT loc, SUM(sal) AS total FROM emp, dept "
    "WHERE dept = name AND sal > 15 GROUP BY loc ORDER BY total DESC",
    "through-derived": "SELECT name FROM (SELECT name, budget FROM dept) d WHERE d.budget > 150",
    "computed-derived": "SELECT twice FROM (SELECT budget * 2 AS twice, loc FROM dept) d "
    "WHERE d.twice > 300",
    "aggregate-derived": "SELECT loc2 FROM (SELECT loc AS loc2, SUM(budget) AS tot "
    "FROM dept GROUP BY loc) d WHERE d.tot > 250",
    "derived-join-narrowed": "SELECT e.id FROM emp e, (SELECT name, loc, budget FROM dept) d "
    "WHERE e.dept = d.name",
    "in-subquery-narrowed": "SELECT id FROM emp WHERE dept IN "
    "(SELECT name FROM dept WHERE budget > 150)",
    "exists-neq-shared": "SELECT id FROM emp e1 WHERE EXISTS (SELECT * FROM emp e2 "
    "WHERE e2.dept = e1.dept AND e2.id <> e1.id) ORDER BY id",
}

SNAPSHOT = """\
== logical plan ==
Sort [total DESC]
  Project [loc, total=__agg_0]
    Aggregate keys=[dept.loc] aggs=[__agg_0=SUM(emp.sal)]
      Filter (emp.sal > 15)
        Join inner on [emp.dept = dept.name]
          Scan emp [id, dept, sal, hired]
          Scan dept [name, loc, budget]
== optimized plan ==
Sort [total DESC]
  Project [loc, total=__agg_0]
    Aggregate keys=[dept.loc] aggs=[__agg_0=SUM(emp.sal)]
      Join inner on [emp.dept = dept.name]
        Filter (emp.sal > 15)
          Scan emp [dept, sal]
        Scan dept [name, loc]"""


@pytest.mark.parametrize("case", list(PLANS))
def test_explain_matches_jax(scopes, case):
    port, ref = scopes
    txt = sql.explain(PLANS[case], port)
    assert txt == j_sql.explain(PLANS[case], ref)
    if case == "snapshot":
        assert txt == SNAPSHOT
    if case == "fold-in-plan":
        naive, opt = txt.split("== optimized plan ==")
        assert "DATE '2021-02-01'" in opt and "> 15" in opt
        assert "INTERVAL '31' DAY" in naive


# ----------------------------------------------------------------------
# execution on tiny frames: results against the JAX package's
# ----------------------------------------------------------------------
EXEC = {
    "order-limit": "SELECT id, sal FROM emp WHERE sal >= 30 ORDER BY sal DESC LIMIT 2",
    "case-extract": "SELECT id, CASE WHEN sal >= 40 THEN 1 ELSE 0 END AS senior, "
    "EXTRACT(YEAR FROM hired) AS y FROM emp ORDER BY id",
    "left-join-on-residual": "SELECT name, COUNT(id) AS n FROM dept "
    "LEFT JOIN emp ON dept = name AND sal >= 30 GROUP BY name ORDER BY name",
    "left-join-counts": "SELECT name, COUNT(id) AS n FROM dept LEFT JOIN emp ON dept = name "
    "GROUP BY name ORDER BY name",
    "select-star": "SELECT * FROM dept ORDER BY name",
    "global-aggregate": "SELECT COUNT(*) AS n, SUM(sal) AS s, MAX(sal) AS mx, "
    "COUNT(DISTINCT dept) AS u FROM emp",
    "computed-derived": "SELECT twice FROM (SELECT budget * 2 AS twice, loc FROM dept) d "
    "WHERE d.twice > 300 ORDER BY twice",
    "snapshot": PLANS["snapshot"],
    "limit-in-uncorrelated-in": "SELECT id FROM emp e WHERE dept IN "
    "(SELECT name FROM dept d ORDER BY name LIMIT 1)",
    "limit-in-uncorrelated-scalar": "SELECT id FROM emp e WHERE sal >= "
    "(SELECT sal FROM emp e2 ORDER BY sal DESC LIMIT 1)",
}

# the subquery cases of tests/test_sql_plan.py: also held to the port's
# oracle backend interpreting the naive plan, with the rows it expects
THREEWAY = {
    "exists-semi": ("SELECT id FROM emp e WHERE EXISTS (SELECT * FROM dept d "
                    "WHERE d.name = e.dept AND d.loc = 'x') ORDER BY id", {"id": [0, 2, 3, 5]}),
    "not-exists-anti": ("SELECT id FROM emp e WHERE NOT EXISTS (SELECT * FROM dept d "
                        "WHERE d.name = e.dept AND d.loc = 'x') ORDER BY id", {"id": [1, 4]}),
    "in-semi": ("SELECT id FROM emp e WHERE dept IN "
                "(SELECT name FROM dept d WHERE budget > 150) ORDER BY id", {"id": [1, 3, 4]}),
    "not-in-anti": ("SELECT id FROM emp e WHERE dept NOT IN "
                    "(SELECT name FROM dept d WHERE budget > 150) ORDER BY id", {"id": [0, 2, 5]}),
    "uncorrelated-scalar": ("SELECT id FROM emp e WHERE sal > (SELECT AVG(sal) FROM emp e2) "
                            "ORDER BY id", {"id": [3, 4, 5]}),
    "correlated-scalar": ("SELECT id FROM emp e, dept d WHERE dept = name AND "
                          "sal > (SELECT AVG(e2.sal) FROM emp e2 WHERE e2.dept = d.name) "
                          "ORDER BY id", {"id": [4, 5]}),
    "exists-neq": (PLANS["exists-neq-shared"], {"id": [0, 1, 2, 4, 5]}),
    "derived-table": ("SELECT loc, SUM(n) AS total FROM "
                      "(SELECT dept AS dd, COUNT(*) AS n FROM emp GROUP BY dept) t, dept "
                      "WHERE dd = name GROUP BY loc ORDER BY loc",
                      {"loc": ["x", "y"], "total": [4, 2]}),
    "distinct": ("SELECT DISTINCT dept FROM emp ORDER BY dept", {"dept": ["a", "b", "c"]}),
    "distinct-in-in": ("SELECT id FROM emp e WHERE dept IN "
                       "(SELECT DISTINCT name FROM dept d WHERE budget > 150) ORDER BY id",
                       {"id": [1, 3, 4]}),
    "empty-scalar": ("SELECT id FROM emp e WHERE sal > "
                     "(SELECT e2.sal FROM emp e2 WHERE e2.sal > 1000) ORDER BY id", {"id": []}),
    "string-scalar": ("SELECT id FROM emp e WHERE dept = "
                      "(SELECT d.name FROM dept d WHERE d.budget = 200) ORDER BY id",
                      {"id": [1, 4]}),
    "empty-sum": ("SELECT id FROM emp e WHERE sal > "
                  "(SELECT SUM(e2.sal) FROM emp e2 WHERE e2.sal > 1000) ORDER BY id",
                  {"id": [0, 1, 2, 3, 4, 5]}),
    "scalar-in-select": ("SELECT id, sal - (SELECT AVG(e2.sal) FROM emp e2) AS delta "
                         "FROM emp e ORDER BY id",
                         {"id": [0, 1, 2, 3, 4, 5],
                          "delta": [-25.0, -15.0, -5.0, 5.0, 15.0, 25.0]}),
    "not-in-null": ("SELECT name FROM dept WHERE name NOT IN "
                    "(SELECT dd FROM (SELECT d2.name AS nm, e2.dept AS dd "
                    " FROM dept d2 LEFT JOIN emp e2 ON d2.name = e2.dept "
                    "   AND e2.sal > 45) j) ORDER BY name", {"name": ["c"]}),
}


def _same_in_order(got, want):
    assert got.column_names == want.column_names
    orc.assert_odf_equal(orc.frame_to_odf(got), orc.frame_to_odf(want), sort=False, rtol=1e-12)


@pytest.mark.parametrize("optimize", [True, False], ids=["optimized", "unoptimized"])
@pytest.mark.parametrize("case", list(EXEC))
def test_execute_matches_jax(scopes, case, optimize):
    port, ref = scopes
    got = sql.execute(EXEC[case], port, optimize=optimize)
    _same_in_order(got, j_sql.execute(EXEC[case], ref, optimize=optimize))
    if case == "global-aggregate":
        assert got.nrows == 1 and got.column("s")[0] == 210.0 and got.column("u")[0] == 3


@pytest.mark.parametrize("case", list(THREEWAY))
def test_subqueries_three_way(scopes, case):
    port, ref = scopes
    q, rows = THREEWAY[case]
    got = sql.execute(q, port)
    _same_in_order(got, j_sql.execute(q, ref))
    ora = execute_oracle(sql.plan_query(q, port, optimized=False), TABLES)
    godf = orc.frame_to_odf(got)
    orc.assert_odf_equal(godf, ora, sort=True, rtol=1e-9)
    assert godf == rows


def test_limit_under_sort_ties_is_deterministic():
    """Stable sorts: equal keys keep input order, so LIMIT picks the rows
    of the JAX package and of the row-at-a-time oracle."""
    tables = {"t": {"k": np.array([2, 1, 2, 1, 1, 2]), "v": np.arange(6)}}
    port = {"t": TensorFrame.from_arrays(tables["t"], device="cpu")}
    ref = {"t": JFrame.from_arrays(tables["t"])}
    for q in ("SELECT k, v FROM t ORDER BY k LIMIT 4", "SELECT k, v FROM t ORDER BY k DESC LIMIT 3"):
        got = sql.execute(q, port)
        _same_in_order(got, j_sql.execute(q, ref))
        ora = execute_oracle(sql.plan_query(q, port, optimized=False), tables)
        assert list(got.column("v")) == list(ora["v"])
    assert list(got.column("v")) == [0, 2, 5]


def test_scope_accepts_raw_numpy_dicts():
    raw = {"t": {"k": np.array([1, 2, 1]), "v": np.array([1.0, 2.0, 3.0])}}
    q = "SELECT k, SUM(v) AS s FROM t GROUP BY k ORDER BY k"
    got = sql.execute(q, raw, device="cpu")
    _same_in_order(got, j_sql.execute(q, raw))
    assert list(got.column("s")) == [4.0, 2.0]


@pytest.mark.parametrize(
    "q, msg",
    [
        ("SELECT name FROM dept LEFT JOIN emp ON dept = name AND budget > 100", "LEFT JOIN"),
        ("SELECT id FROM emp e WHERE 1 < "
         "(SELECT COUNT(*) FROM emp e2 WHERE e2.dept = e.dept)", "COUNT"),
        ("SELECT id FROM emp WHERE EXISTS (SELECT * FROM emp WHERE sal > 10)", "shadows"),
        ("SELECT id FROM emp e WHERE sal > 50 OR EXISTS "
         "(SELECT * FROM dept d WHERE d.name = e.dept)", "top-level AND conjuncts"),
        ("SELECT id FROM emp e WHERE sal > (SELECT sal, id FROM emp e2)", "exactly one column"),
        ("SELECT id FROM emp e WHERE sal > (SELECT budget FROM dept d WHERE d.name = e.dept "
         "ORDER BY budget LIMIT 1)", "LIMIT inside correlated"),
        ("SELECT id FROM emp e WHERE sal > (SELECT DISTINCT sal FROM emp e2)",
         "DISTINCT inside scalar subqueries"),
        ("SELECT id, (SELECT AVG(e2.sal) FROM emp e2 WHERE e2.dept = e.dept) AS davg "
         "FROM emp e", "SELECT list"),
    ],
)
def test_execute_errors_match_jax(scopes, q, msg):
    port, ref = scopes
    with pytest.raises(sql.SqlError) as ei:
        sql.execute(q, port)
    with pytest.raises(j_sql.SqlError) as ej:
        j_sql.execute(q, ref)
    assert str(ei.value) == str(ej.value) and msg in str(ei.value)


def test_queries_scope_registry():
    from repro import queries as j_queries

    with pytest.raises(KeyError):
        queries.scope("nosuch")
    frames = queries.scope("tpch", sf=0.0005, seed=3, device="cpu")
    ref = j_queries.scope("tpch", sf=0.0005, seed=3)
    assert frames["lineitem"].nrows > 0
    assert {n: f.nrows for n, f in frames.items()} == {n: f.nrows for n, f in ref.items()}
    q = "SELECT l_returnflag, COUNT(*) AS n FROM lineitem GROUP BY l_returnflag"
    _same_in_order(sql.execute(q, frames), j_sql.execute(q, ref))
