"""TPC-H SQL over the port's store-backed tables on the CPU.

Every TPC-H query runs twice through ``repro_torch.sql``: over the
in-memory frames (held to the JAX package in tests/test_torch_sql.py)
and over a scope of chunked ``repro_torch.store`` tables (small chunks,
fact tables date-clustered, sargable predicates pushed into the scans).
Results must be identical: scan pushdown and chunk skipping are pure
access-path changes.  The plans that show pushed and residual
predicates are held to the JAX package's over its own store tables.
"""
import numpy as np
import pytest

import jax

from repro import sql as j_sql
from repro.data import tpch as j_tpch
from repro_torch import obs, sql, store
from repro_torch.core import TensorFrame
from repro_torch.core import oracle as orc
from repro_torch.data import tpch
from repro_torch.queries.tpch_sql import SCALAR_SQL, TPCH_SQL, sql_text
from repro_torch.sql.lower import _scan_pred, scan_cache_key
from repro_torch.sql.plan import walk_scans

SF = 0.002  # matches the shared tpch_small fixture

# same split as tests/test_store_sql.py
SLOW_SQL = {
    "q2", "q3", "q4", "q5", "q7", "q8", "q9", "q10",
    "q11", "q13", "q17", "q18", "q20", "q21",
}

QNAMES = sorted(TPCH_SQL, key=lambda s: int(s[1:]))


@pytest.fixture(autouse=True, scope="module")
def _x64_on(_x64_policy):
    jax.config.update("jax_enable_x64", True)
    yield


@pytest.fixture(autouse=True)
def _port_slate():
    obs.metrics.reset()
    obs.clear_trace()
    yield


@pytest.fixture(scope="module")
def scopes(tpch_small):
    tables, _ = tpch_small
    frames = tpch.as_frames(tables, device="cpu")
    stores = tpch.as_store(tables, chunk_rows=512, sort_fact_by_date=True)
    j_stores = j_tpch.as_store(tables, chunk_rows=512, sort_fact_by_date=True)
    return frames, stores, j_stores


def _params():
    return [
        pytest.param(q, marks=pytest.mark.slow) if q in SLOW_SQL else q
        for q in QNAMES
    ]


@pytest.mark.parametrize("qname", _params())
def test_store_backed_sql_matches_frames(scopes, qname):
    frames, stores, _ = scopes
    text = sql_text(qname, SF)
    want = sql.execute(text, frames)
    got = sql.execute(text, stores, device="cpu")
    assert got.device.type == "cpu"
    godf, wodf = orc.frame_to_odf(got), orc.frame_to_odf(want)
    if qname in SCALAR_SQL:
        (name,) = godf.keys()
        assert godf[name][0] == pytest.approx(wodf[name][0], rel=1e-8)
        return
    assert got.column_names == want.column_names
    orc.assert_odf_equal(godf, wodf, sort=True, rtol=1e-8)


def test_store_covers_all_22_queries():
    assert QNAMES == [f"q{i}" for i in range(1, 23)]


# ----------------------------------------------------------------------
# plan-level: the optimizer pushes into store scans, and only there
# ----------------------------------------------------------------------
@pytest.mark.parametrize("qname", QNAMES)
def test_store_plans_match_the_jax_package(scopes, qname):
    _, stores, j_stores = scopes
    text = sql_text(qname, SF)
    assert sql.explain(text, stores) == j_sql.explain(text, j_stores)


def test_explain_pushes_sargable_predicates_into_store_scan(scopes):
    frames, stores, j_stores = scopes
    text = sql_text("q6", SF)
    txt = sql.explain(text, stores)
    assert txt == j_sql.explain(text, j_stores)
    opt = txt.split("== optimized plan ==")[1]
    # one lineitem scan with date-range + discount-range + quantity
    # predicates: all sargable, all pushed, no residual Filter
    assert "pushed=" in opt and "l_shipdate" in opt.split("pushed=")[1]
    assert "Filter" not in opt
    # the same query over frames keeps the explicit Filter
    opt_f = sql.explain(text, frames).split("== optimized plan ==")[1]
    assert "pushed=" not in opt_f and "Filter" in opt_f


def test_explain_keeps_residual_filters_above_store_scan(scopes):
    _, stores, j_stores = scopes
    text = (
        "SELECT COUNT(*) AS n FROM orders "
        "WHERE o_orderdate >= DATE '1995-01-01' "
        "AND o_comment LIKE '%special%requests%'"
    )
    txt = sql.explain(text, stores)
    assert txt == j_sql.explain(text, j_stores)
    opt = txt.split("== optimized plan ==")[1]
    # LIKE is not sargable: it stays a residual Filter while the date
    # conjunct pushes
    assert "pushed=" in opt and "o_orderdate" in opt.split("pushed=")[1]
    assert "Filter" in opt and "LIKE" in opt


def test_store_scan_skips_chunks_on_clustered_dates(scopes):
    """A date predicate on the date-clustered lineitem store skips most
    chunks."""
    _, stores, _ = scopes
    li = stores["lineitem"]
    r = store.scan(
        li,
        ["l_extendedprice"],
        [store.Pred("l_shipdate", ">=", np.datetime64("1998-06-01"))],
    )
    assert r.chunks_skipped >= 0.8 * r.chunks_total
    assert r.nrows < store.scan(li, ["l_extendedprice"]).nrows


def test_q6_pushed_scan_skips_chunks_and_feeds_the_plan(scopes):
    """q6's optimized plan, its pushed lineitem scan read through the
    scan cache: chunks are skipped and the result is q6's."""
    frames, stores, _ = scopes
    text = sql_text("q6", SF)
    plan = sql.plan_query(text, stores)
    (scan,) = list(walk_scans(plan))
    preds = [_scan_pred(c, scan.alias) for c in scan.predicates]
    res = store.scan(stores[scan.table], list(scan.columns), preds)
    assert res.chunks_skipped > 0
    cache = {scan_cache_key(scan): TensorFrame.from_store(
        stores[scan.table], list(scan.columns), preds, result=res, device="cpu")}
    got = sql.execute_plan(plan, stores, scan_cache=cache)
    want = sql.execute(text, frames)
    orc.assert_odf_equal(orc.frame_to_odf(got), orc.frame_to_odf(want), rtol=1e-12)


def test_store_scope_unoptimized_still_correct(scopes):
    """optimize=False lowers store scans without pushdown — full
    materialization plus explicit Filters agree with pushdown."""
    _, stores, _ = scopes
    text = sql_text("q6", SF)
    a = sql.execute(text, stores, device="cpu")
    b = sql.execute(text, stores, optimize=False, device="cpu")
    orc.assert_odf_equal(orc.frame_to_odf(a), orc.frame_to_odf(b), sort=True, rtol=1e-12)
