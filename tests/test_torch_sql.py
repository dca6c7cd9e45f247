"""The port's SQL front end (``repro_torch.sql``) on the CPU, held to the
JAX package's ``repro.sql`` on the same TPC-H tables at SF 0.002.

- plans: ``format_plan`` of the naive and the optimized plan of all 22
  TPC-H texts, identical to the JAX package's;
- results: the port's ``sql.execute`` equal to the port's hand-written
  frame queries and to the port's ``oracle_backend`` interpreting the
  naive plan (ints, codes and row sets exact; floats rtol 1e-8), and to
  the JAX ``sql.execute``; the heaviest queries (``SLOW_SQL``, as in
  tests/test_sql.py) run in the slow lane;
- the rest of tests/test_sql.py (decorrelation, attached scalars,
  DISTINCT, optimizer on and off, pushdown, LIMIT) against the JAX
  package's output; EXPLAIN ANALYZE node for node; UDFs through
  ``udf_scope``; and where frames the front end builds itself land.
"""
import threading

import numpy as np
import pytest
import torch

import jax

from repro import sql as j_sql
from repro.core import TensorFrame as JFrame
from repro.core.config import CONFIG as J_CONFIG
from repro.queries import tpch_sql as j_tpch_sql
from repro.sql import udf as j_udf
from repro_torch import obs, sql, store
from repro_torch.core import TensorFrame
from repro_torch.core import oracle as orc
from repro_torch.core.config import CONFIG
from repro_torch.data import tpch
from repro_torch.queries import tpch_frames as QF
from repro_torch.queries.tpch_sql import SCALAR_SQL, TPCH_SQL, sql_text
from repro_torch.sql import lower, udf
from repro_torch.sql.oracle_backend import execute_oracle
from repro_torch.sql.plan import Aggregate, format_plan

SF = 0.002  # must match the shared tpch_small fixture (conftest.py)

# the split of tests/test_sql.py: multi-join plans and nested-loop
# oracle interpretation of correlated subqueries in the slow lane
SLOW_SQL = {
    "q2", "q3", "q4", "q5", "q7", "q8", "q9", "q10",
    "q11", "q13", "q17", "q18", "q20", "q21",
}

QNAMES = sorted(TPCH_SQL, key=lambda s: int(s[1:]))


@pytest.fixture(autouse=True, scope="module")
def _x64_on(_x64_policy):
    # the conftest policy turns x64 off for this file's prefix; the
    # reference engine needs exact int64 keys
    jax.config.update("jax_enable_x64", True)
    yield


@pytest.fixture(autouse=True)
def _port_slate():
    obs.metrics.reset()
    obs.clear_trace()
    yield


@pytest.fixture(scope="module")
def data(tpch_small):
    tables, jax_frames = tpch_small
    return tables, jax_frames, tpch.as_frames(tables, device="cpu")


def _params(qnames=QNAMES):
    return [
        pytest.param(q, marks=pytest.mark.slow) if q in SLOW_SQL else q
        for q in qnames
    ]


def _assert_same_result(got, want, rtol=1e-8):
    """Same column names in the same order; ints, codes and row sets
    exact, floats within ``rtol``."""
    assert got.column_names == want.column_names
    orc.assert_odf_equal(orc.frame_to_odf(got), orc.frame_to_odf(want), sort=True, rtol=rtol)


# ----------------------------------------------------------------------
# the 22 TPC-H texts
# ----------------------------------------------------------------------
@pytest.mark.parametrize("qname", QNAMES)
def test_plans_match_the_jax_package(data, qname):
    """Same text, same parser, planner and optimizer: the naive and the
    optimized plan render identically in both packages."""
    _, jax_frames, frames = data
    text = sql_text(qname, SF)
    assert text == j_tpch_sql.sql_text(qname, SF)
    for optimized in (False, True):
        got = format_plan(sql.plan_query(text, frames, optimized=optimized))
        want = j_sql.format_plan(j_sql.plan_query(text, jax_frames, optimized=optimized))
        assert got == want, (optimized, got, want)


@pytest.mark.parametrize("qname", _params())
def test_sql_three_way(data, qname):
    """The port's SQL against the port's hand-written frame query and the
    port's oracle backend on the naive plan."""
    tables, _, frames = data
    text = sql_text(qname, SF)
    got = sql.execute(text, frames)
    hand = QF.ALL[qname](frames, sf=SF, apply_limit=False)
    ora = execute_oracle(sql.plan_query(text, frames, optimized=False), tables)
    godf = orc.frame_to_odf(got)
    if qname in SCALAR_SQL:
        (name,) = godf.keys()
        v_hand = hand[name] if isinstance(hand, dict) else hand.scalar(name)
        assert godf[name][0] == pytest.approx(v_hand, rel=1e-8)
        assert godf[name][0] == pytest.approx(ora[name][0], rel=1e-8)
        return
    assert got.column_names == hand.column_names
    orc.assert_odf_equal(godf, orc.frame_to_odf(hand), sort=True, rtol=1e-8)
    orc.assert_odf_equal(godf, ora, sort=True, rtol=1e-8)


@pytest.mark.parametrize("qname", _params())
def test_sql_matches_the_jax_sql(data, qname):
    _, jax_frames, frames = data
    text = sql_text(qname, SF)
    _assert_same_result(sql.execute(text, frames), j_sql.execute(text, jax_frames))


def test_sql_covers_all_22_queries():
    assert QNAMES == [f"q{i}" for i in range(1, 23)]
    assert TPCH_SQL == j_tpch_sql.TPCH_SQL and SCALAR_SQL == j_tpch_sql.SCALAR_SQL


# ----------------------------------------------------------------------
# explain: decorrelation, attached scalars, pushdown
# ----------------------------------------------------------------------
def _explain_both(data, text):
    _, jax_frames, frames = data
    got = sql.explain(text, frames)
    assert got == j_sql.explain(text, jax_frames)
    naive, opt = got.split("== optimized plan ==")
    return naive, opt


@pytest.mark.parametrize("qname,needles", [
    ("q4", ["Join semi on [orders.o_orderkey = lineitem.l_orderkey]"]),
    ("q17", ["Aggregate keys=[l2.l_partkey]", "Join inner on [part.p_partkey = l2.l_partkey]"]),
    ("q21", ["Join semi on [l1.l_orderkey = l2.l_orderkey]", "Join anti on", "NUNIQUE"]),
])
def test_explain_decorrelates_q4_q17_q21(data, qname, needles):
    naive, opt = _explain_both(data, sql_text(qname, SF))
    assert "subquery" in naive
    assert "subquery[" not in opt and "scalar-subquery" not in opt
    assert "EXISTS" not in opt and "outer(" not in opt
    for needle in needles:
        assert needle in opt


def test_explain_attaches_uncorrelated_scalar_q11(data):
    _, opt = _explain_both(data, sql_text("q11", SF))
    assert "AttachScalar" in opt and "subquery[" not in opt


def test_explain_shows_pushdown_on_q3(data):
    naive, opt = _explain_both(data, TPCH_SQL["q3"])
    assert "Filter (customer.c_mktsegment = 'BUILDING')" in opt
    assert "Scan lineitem [l_orderkey, l_extendedprice, l_discount, l_shipdate]" in opt
    assert "Filter (customer.c_mktsegment" not in naive


# ----------------------------------------------------------------------
# execution: DISTINCT, optimizer on and off, LIMIT
# ----------------------------------------------------------------------
def test_sql_distinct_matches_jax_and_oracle(data):
    tables, jax_frames, frames = data
    text = "SELECT DISTINCT l_returnflag, l_linestatus FROM lineitem"
    got = sql.execute(text, frames)
    # first occurrence of each row, in row order, as in both references
    want = j_sql.execute(text, jax_frames)
    assert got.column_names == want.column_names
    orc.assert_odf_equal(orc.frame_to_odf(got), orc.frame_to_odf(want), sort=False)
    ora = execute_oracle(sql.plan_query(text, frames, optimized=False), tables)
    orc.assert_odf_equal(orc.frame_to_odf(got), ora, sort=False)
    rows = list(zip(got.column("l_returnflag"), got.column("l_linestatus")))
    assert len(rows) == len(set(rows))


def test_optimized_matches_unoptimized(data):
    _, jax_frames, frames = data
    a = sql.execute(TPCH_SQL["q1"], frames)
    b = sql.execute(TPCH_SQL["q1"], frames, optimize=False)
    _assert_same_result(a, b, rtol=1e-12)
    _assert_same_result(b, j_sql.execute(TPCH_SQL["q1"], jax_frames, optimize=False))


def test_sql_limit_matches_jax(data):
    _, jax_frames, frames = data
    text = "SELECT l_orderkey, l_quantity FROM lineitem ORDER BY l_orderkey LIMIT 5"
    got = sql.execute(text, frames)
    want = j_sql.execute(text, jax_frames)
    assert got.nrows == 5
    # a stable sort on both: the same five rows in the same order
    orc.assert_odf_equal(orc.frame_to_odf(got), orc.frame_to_odf(want), sort=False)


# ----------------------------------------------------------------------
# an aggregate spelled twice (q15's revenue view) is computed once
# ----------------------------------------------------------------------
def _aggregates(plan):
    return [n for n in lower.plan_nodes(plan) if isinstance(n, Aggregate)]


def test_q15_computes_its_revenue_view_once(data, monkeypatch):
    """On the card K1's float sums add in an order that changes from
    launch to launch, and q15 compares two spellings of one SUM for
    equality: the lowering evaluates the second from the first."""
    _, jax_frames, frames = data
    text = sql_text("q15", SF)
    revenue = [a for a in _aggregates(sql.plan_query(text, frames)) if a.keys]
    assert len(revenue) == 2 and revenue[0] != revenue[1]
    assert lower.alias_free_key(revenue[0]) == lower.alias_free_key(revenue[1])
    computed = []
    real = lower._lower_aggregate
    monkeypatch.setattr(lower, "_lower_aggregate",
                        lambda node, f: computed.append(node) or real(node, f))
    got = sql.execute(text, frames)
    assert len(computed) == 2  # the revenue view once, the MAX over it once
    _assert_same_result(got, j_sql.execute(text, jax_frames))
    _assert_same_result(got, QF.q15(frames, sf=SF, apply_limit=False))
    assert got.nrows == 1


@pytest.mark.parametrize("cond, other", [
    ("l_shipdate < DATE '1996-04-01'", "l_shipdate < DATE '1996-04-02'"),  # another literal
    ("l_shipdate < DATE '1996-04-01'", "l_shipdate <= DATE '1996-04-01'"),  # another operator
    ("l_linenumber < 3", "l_linenumber < 3.0"),  # another literal type
])
def test_alias_free_key_tells_different_aggregates_apart(data, cond, other):
    _, _, frames = data
    base = ("SELECT l_suppkey, SUM(l_extendedprice) AS s FROM lineitem {a} "
            "WHERE {c} GROUP BY l_suppkey")
    one = sql.plan_query(base.format(a="", c=cond), frames)
    same = sql.plan_query(base.format(a="l2", c="l2." + cond), frames)
    diff = sql.plan_query(base.format(a="l2", c="l2." + other), frames)
    key = [lower.alias_free_key(_aggregates(p)[0]) for p in (one, same, diff)]
    assert key[0] == key[1] != key[2]


# ----------------------------------------------------------------------
# EXPLAIN ANALYZE
# ----------------------------------------------------------------------
def _walk(node):
    yield node
    for c in node["children"]:
        yield from _walk(c)


JOIN_ALGORITHMS = {"direct_address", "sorted_probe", "membership", "sort_merge"}


@pytest.mark.parametrize("qname", _params(["q1", "q3", "q9", "q14"]))
def test_explain_analyze_matches_jax_node_for_node(data, qname):
    _, jax_frames, frames = data
    text = sql_text(qname, SF)
    res = sql.execute(text, frames, explain="analyze")
    jres = j_sql.execute(text, jax_frames, explain="analyze")
    assert CONFIG.tracing == "off" and J_CONFIG.tracing == "off"
    _assert_same_result(res.frame, jres.frame)
    rendered = str(res)
    assert "EXPLAIN ANALYZE" in rendered
    assert "time=" in rendered and "rows=" in rendered and "bytes=" in rendered
    nodes = list(_walk(res.to_dict()["plan"]))
    jnodes = list(_walk(jres.to_dict()["plan"]))
    assert [n["label"] for n in nodes] == [n["label"] for n in jnodes]
    assert [n.get("rows_out") for n in nodes] == [n.get("rows_out") for n in jnodes]
    assert all("wall_ms" in n and n["wall_ms"] >= 0 for n in nodes)
    assert nodes[0]["rows_out"] == res.frame.nrows
    algos = {n["algorithm"] for n in nodes if "algorithm" in n}
    assert algos == {n["algorithm"] for n in jnodes if "algorithm" in n}
    assert algos <= JOIN_ALGORITHMS
    if qname != "q1":
        assert algos and "algo=" in rendered


def test_explain_analyze_rejects_unknown_mode():
    t = TensorFrame.from_arrays({"a": np.arange(4)}, device="cpu")
    with pytest.raises(sql.SqlError):
        sql.execute("SELECT a FROM t", {"t": t}, explain="verbose")


# ----------------------------------------------------------------------
# UDFs
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def udf_tables():
    rng = np.random.default_rng(7)
    n = 500
    return {"t": {
        "k": rng.integers(0, 1000, n),
        "g": rng.integers(0, 5, n),
        "v": rng.normal(size=n) * 10,
        "s": np.array([f"s{i % 7}" for i in range(n)], dtype=object),
    }}


def _both_with_udfs(udf_tables, text, fns):
    """``text`` through both packages, each with the same lambdas
    registered in its own ``udf_scope``."""
    scope = {"t": TensorFrame.from_arrays(udf_tables["t"], device="cpu")}
    jscope = {"t": JFrame.from_arrays(udf_tables["t"])}
    with udf.udf_scope({name: udf.Udf(name, fn, ret) for name, (fn, ret) in fns.items()}):
        got = sql.execute(text, scope)
    with j_udf.udf_scope({name: j_udf.Udf(name, fn, ret) for name, (fn, ret) in fns.items()}):
        want = j_sql.execute(text, jscope)
    return got, want, scope


def test_udf_matches_jax_and_inline_expression(udf_tables):
    markup = (lambda v, g: v * (1.0 + 0.01 * g), "num")
    got, want, scope = _both_with_udfs(
        udf_tables, "SELECT g, SUM(markup(v, g)) AS s FROM t GROUP BY g ORDER BY g",
        {"markup": markup})
    _assert_same_result(got, want, rtol=1e-12)
    inline = sql.execute(
        "SELECT g, SUM(v * (1.0 + 0.01 * g)) AS s FROM t GROUP BY g ORDER BY g", scope)
    _assert_same_result(got, inline, rtol=1e-12)


def test_udf_in_where_returns_bool(udf_tables):
    hot = (lambda k: k < 100, "bool")
    got, want, scope = _both_with_udfs(
        udf_tables, "SELECT COUNT(*) AS c, SUM(v) AS s FROM t WHERE hot(k)", {"hot": hot})
    _assert_same_result(got, want, rtol=1e-12)
    ref = sql.execute("SELECT COUNT(*) AS c, SUM(v) AS s FROM t WHERE k < 100", scope)
    _assert_same_result(got, ref, rtol=1e-12)


def test_udf_integer_result_stays_integer(udf_tables):
    got, want, _ = _both_with_udfs(
        udf_tables, "SELECT k, bucket(k, g) AS b FROM t ORDER BY k, b",
        {"bucket": (lambda k, g: k * 10 + g, "num")})
    assert got.meta("b").kind == "int"
    _assert_same_result(got, want)


def test_udf_scopes_nest_and_stay_apart(udf_tables):
    scope = {"t": TensorFrame.from_arrays(udf_tables["t"], device="cpu")}
    text = "SELECT SUM(boost(v)) AS s FROM t"
    base = float(sql.execute("SELECT SUM(v) AS s FROM t", scope).column("s")[0])
    seen = {}
    with udf.udf_scope({"boost": udf.Udf("boost", lambda v: v * 2.0)}):
        with udf.udf_scope({"boost": udf.Udf("boost", lambda v: v * 3.0)}):
            seen["inner"] = float(sql.execute(text, scope).column("s")[0])

            # a thread starts with an empty context: no scope reaches it
            def other():
                try:
                    sql.execute(text, scope)
                except sql.SqlError as exc:
                    seen["thread"] = str(exc)

            th = threading.Thread(target=other)
            th.start()
            th.join()
        seen["outer"] = float(sql.execute(text, scope).column("s")[0])
    assert seen["inner"] == pytest.approx(3 * base, rel=1e-12)
    assert seen["outer"] == pytest.approx(2 * base, rel=1e-12)
    assert "unknown function 'BOOST'" in seen["thread"]
    assert udf.active_udfs() == {}
    with pytest.raises(sql.SqlError, match="unknown function 'BOOST'"):
        sql.execute(text, scope)


def test_udf_refuses_string_arguments(udf_tables):
    scope = {"t": TensorFrame.from_arrays(udf_tables["t"], device="cpu")}
    jscope = {"t": JFrame.from_arrays(udf_tables["t"])}
    text = "SELECT f(s) AS x FROM t"
    with udf.udf_scope({"f": udf.Udf("f", lambda s: s)}):
        with pytest.raises(sql.SqlError) as err:
            sql.execute(text, scope)
    with j_udf.udf_scope({"f": j_udf.Udf("f", lambda s: s)}):
        with pytest.raises(j_sql.SqlError) as jerr:
            j_sql.execute(text, jscope)
    assert str(err.value) == str(jerr.value) == "UDF 'f' cannot take string arguments"


def test_udf_plan_uses_udf(udf_tables):
    scope = {"t": TensorFrame.from_arrays(udf_tables["t"], device="cpu")}
    with udf.udf_scope({"hot": udf.Udf("hot", lambda k: k < 100, "bool")}):
        plan = sql.plan_query(
            "SELECT COUNT(*) AS c FROM t WHERE v > (SELECT MAX(v) FROM t t2 WHERE hot(t2.k))",
            scope)
    assert udf.plan_uses_udf(plan, {"hot"})
    assert not udf.plan_uses_udf(plan, {"cold"})
    with pytest.raises(ValueError, match="returns must be one of"):
        udf.Udf("x", abs, returns="str")


# ----------------------------------------------------------------------
# devices
# ----------------------------------------------------------------------
RAW = {"t": {"k": np.array([1, 2, 1]), "v": np.array([1.0, 2.0, 3.0])}}


def test_raw_scope_without_a_device_wants_the_card(monkeypatch):
    monkeypatch.setattr(CONFIG, "device", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        sql.execute("SELECT k FROM t", RAW)
    # planning reads names only: it never needs a device
    assert "Scan t [k, v]" in sql.explain("SELECT k, v FROM t", RAW)


def test_raw_scope_on_the_cpu(monkeypatch):
    monkeypatch.setattr(CONFIG, "device", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = sql.execute("SELECT k, SUM(v) AS s FROM t GROUP BY k ORDER BY k", RAW, device="cpu")
    assert out.device.type == "cpu"
    assert list(out.column("k")) == [1, 2] and list(out.column("s")) == [4.0, 2.0]


def test_global_aggregate_stays_on_its_inputs_device(monkeypatch):
    monkeypatch.setattr(CONFIG, "device", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t = TensorFrame.from_arrays(RAW["t"], device="cpu")
    out = sql.execute("SELECT COUNT(*) AS n, SUM(v) AS s FROM t", {"t": t})
    assert out.device.type == "cpu"
    assert out.column("n")[0] == 3 and out.column("s")[0] == 6.0
    # an AttachScalar reads its one value back the same way
    out = sql.execute("SELECT k FROM t WHERE v > (SELECT AVG(v) FROM t t2)", {"t": t})
    assert list(out.column("k")) == [1]


def test_store_scan_lands_on_the_asked_device(monkeypatch):
    monkeypatch.setattr(CONFIG, "device", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tab = store.Table.from_arrays(RAW["t"], chunk_rows=2)
    text = "SELECT k, v FROM t WHERE k = 1"
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        sql.execute(text, {"t": tab})
    out = sql.execute(text, {"t": tab}, device="cpu")
    assert out.device.type == "cpu" and list(out.column("v")) == [1.0, 3.0]
    res = sql.execute(text, {"t": tab}, device="cpu", explain="analyze")
    assert list(res.frame.column("v")) == [1.0, 3.0]
