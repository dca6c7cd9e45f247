"""The paper's five TPC-DS queries through ``repro_torch`` on the CPU:
held to the row-at-a-time reference (``tpcds_numpy``) and to the JAX
engine on the same tables; the generator, the ``scope`` registry and
the store path (``as_store`` + ``from_store``) against ``as_frames``.

The comparison is the reference suite's (tests/test_tpcds_queries.py):
scalar results at rel 1e-9, frames as sorted rows at rtol 1e-8."""
import numpy as np
import pytest

import jax

from repro.core import oracle as j_orc
from repro.data import tpcds as j_tpcds
from repro.queries import tpcds_frames as j_queries
from repro.queries import tpcds_numpy
from repro_torch import queries
from repro_torch import store
from repro_torch.core import TensorFrame
from repro_torch.core import oracle as orc
from repro_torch.data import tpcds
from repro_torch.kernels import ops
from repro_torch.queries import tpcds_frames as QF

SF = 0.005
SEED = 7
# at SF 0.005 q3's item filter (i_manufact_id = 128) keeps no item of seed
# 7's 90; seed 5 keeps some, so q3 is also held to both references there
SEED_Q3_ROWS = 5
# the JAX engine takes 6 to 16 s a query here: q3 and q96 in the default
# lane, the other three with the reference suite's `slow` marker
JAX_FAST = {"q3", "q96"}


@pytest.fixture(autouse=True, scope="module")
def _x64_on(_x64_policy):
    # the conftest policy turns x64 off for this file's prefix; the
    # reference engine needs exact int64 keys
    jax.config.update("jax_enable_x64", True)
    yield


@pytest.fixture(scope="module")
def data():
    out = {}
    for seed in (SEED, SEED_Q3_ROWS):
        tables = tpcds.generate(sf=SF, seed=seed)
        out[seed] = (tables, tpcds.as_frames(tables, device="cpu"))
    return out


def _rows_to_odf(rows):
    if not rows:
        return {}
    return {k: [r[k] for r in rows] for k in rows[0]}


def _assert_matches_reference(qname, got, expect):
    if qname in QF.SCALAR_QUERIES:
        assert set(got) == set(expect)
        for k in expect:
            assert got[k] == pytest.approx(expect[k], rel=1e-9), (qname, got, expect)
        return
    godf = orc.frame_to_odf(got)
    eodf = _rows_to_odf(expect)
    if not eodf:
        assert all(len(v) == 0 for v in godf.values()), f"{qname}: expected empty"
        return
    orc.assert_odf_equal(godf, eodf, sort=True, rtol=1e-8)


def test_generator_matches_reference():
    mine, ref = tpcds.generate(sf=SF, seed=SEED), j_tpcds.generate(sf=SF, seed=SEED)
    assert list(mine) == list(ref)
    for name in ref:
        assert list(mine[name]) == list(ref[name]), name
        for c in ref[name]:
            a, b = mine[name][c], ref[name][c]
            assert a.dtype == b.dtype, (name, c)
            np.testing.assert_array_equal(a, b, err_msg=f"{name}.{c}")


@pytest.mark.parametrize(
    "qname,seed",
    [(q, SEED) for q in sorted(QF.ALL)] + [("q3", SEED_Q3_ROWS)],
)
def test_query_matches_reference(data, qname, seed):
    tables, frames = data[seed]
    ops.reset_launches()
    got = QF.ALL[qname](frames, sf=SF, apply_limit=False)
    assert sum(ops.LAUNCHES.values()) == 0  # CPU tensors: plain versions only
    _assert_matches_reference(qname, got, tpcds_numpy.ALL[qname](tables, sf=SF))
    if seed == SEED_Q3_ROWS:
        assert got.nrows > 0


@pytest.mark.parametrize(
    "qname",
    [q if q in JAX_FAST else pytest.param(q, marks=pytest.mark.slow) for q in sorted(QF.ALL)],
)
def test_query_matches_jax_engine(data, qname):
    tables, frames = data[SEED_Q3_ROWS]
    got = QF.ALL[qname](frames, sf=SF, apply_limit=False)
    want = j_queries.ALL[qname](j_tpcds.as_frames(tables), sf=SF, apply_limit=False)
    if qname in QF.SCALAR_QUERIES:
        assert got == want
        return
    assert got.column_names == want.column_names
    assert got.nrows == want.nrows
    j_orc.assert_odf_equal(orc.frame_to_odf(got), j_orc.frame_to_odf(want), sort=True, rtol=1e-8)


def test_limit_applies(data):
    _, frames = data[SEED_Q3_ROWS]
    full = QF.q7(frames, sf=SF, apply_limit=False)
    capped = QF.q7(frames, sf=SF)
    assert capped.nrows == min(100, full.nrows)
    np.testing.assert_array_equal(capped.column("i_item_id"), full.column("i_item_id")[:100])


def _assert_frames_equal(got, want):
    assert got.column_names == want.column_names
    for c in want.column_names:
        assert got.meta(c).kind == want.meta(c).kind, c
        np.testing.assert_array_equal(got.column(c), want.column(c), err_msg=c)


def test_scope_registry_builds_the_frames_of_as_frames(data):
    tables, frames = data[SEED]
    got = queries.scope("tpcds", sf=SF, seed=SEED, device="cpu")
    assert list(got) == list(frames)
    for name in frames:
        assert got[name].device.type == "cpu"
        _assert_frames_equal(got[name], frames[name])
    with pytest.raises(KeyError):
        queries.scope("tpcx")


def test_store_frames_run_q3_like_array_frames(data):
    """q3 over frames loaded from date-sorted stores equals q3 over
    ``from_arrays`` frames (sorted rows); a predicate-pushed load of one
    year of sales skips chunks and keeps the filtered rows in order."""
    tables, frames = data[SEED_Q3_ROWS]
    stores = tpcds.as_store(tables, chunk_rows=1024, sort_fact_by_date=True)
    assert stores["store_sales"].n_chunks == -(-len(tables["store_sales"]["ss_item_sk"]) // 1024)
    from_stores = {name: TensorFrame.from_store(t, device="cpu") for name, t in stores.items()}
    got = QF.q3(from_stores, sf=SF, apply_limit=False)
    want = QF.q3(frames, sf=SF, apply_limit=False)
    assert got.nrows == want.nrows > 0
    orc.assert_odf_equal(orc.frame_to_odf(got), orc.frame_to_odf(want), sort=True, rtol=1e-8)

    dd = tables["date_dim"]
    year = dd["d_date_sk"][dd["d_year"] == 2000]
    lo, hi = int(year.min()), int(year.max())
    cols = ["ss_sold_date_sk", "ss_item_sk", "ss_ext_sales_price"]
    res = store.scan(stores["store_sales"], cols, [store.Pred("ss_sold_date_sk", "between", (lo, hi))])
    assert res.chunks_skipped > 0
    pushed = TensorFrame.from_store(
        stores["store_sales"], cols, [store.Pred("ss_sold_date_sk", "between", (lo, hi))], device="cpu"
    )
    ss = tables["store_sales"]
    order = np.argsort(ss["ss_sold_date_sk"], kind="stable")
    keep = order[(ss["ss_sold_date_sk"][order] >= lo) & (ss["ss_sold_date_sk"][order] <= hi)]
    want_ss = TensorFrame.from_arrays({c: ss[c][keep] for c in cols}, device="cpu")
    _assert_frames_equal(pushed, want_ss)
