"""Out-of-core execution of the port (``core/pipeline.py``,
``sql/stream.py``, ``launch/run_capped.py``) on the CPU, held to the
JAX package.

After ``tests/test_store_spill.py`` and the pipeline cases of
``tests/test_resilience.py``: force-mode streaming under a tiny spill
budget against the JAX ``sql.execute`` (seeded sweep) and against the
port's own eager path (hypothesis), zone-map pruning through filter
chains, the capped-budget TPC-H differential, and counter parity: for
each TPC-H text at SF 0.002 with chunks of 4,096 rows the port's
``pipeline.STATS`` equal the JAX package's, which shows that the port
streams exactly the plans the reference streams.  Then ``ChunkScan``'s
prefetch thread, ``HashBuild``'s probes, ``StreamAgg``'s recompute of a
corrupt spill block, and a run of the capped runner.

Every test sets the port's ``CONFIG`` and the JAX package's side by side
(the ``both`` fixture) and restores both.  The port runs on the CPU
because each call asks for it (``device="cpu"``).
"""
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax

from repro import sql as j_sql
from repro import store as j_store
from repro.core import TensorFrame as JFrame
from repro.core import pipeline as j_pipeline
from repro.core.config import CONFIG as J_CONFIG
from repro.data import tpch as j_tpch
from repro_torch import obs, sql, store
from repro_torch.core import TensorFrame, pipeline
from repro_torch.core import oracle as orc
from repro_torch.core.config import CONFIG
from repro_torch.data import tpch
from repro_torch.launch import run_capped
from repro_torch.queries.tpch_sql import SCALAR_SQL, TPCH_SQL, sql_text
from repro_torch.resilience import QueryTimeout, deadline_scope
from repro_torch.store.spill import SPILL

SF = 0.002
QNAMES = sorted(TPCH_SQL, key=lambda s: int(s[1:]))
FAST_TPCH = ["q1", "q6", "q14", "q15"]
COUNTERS = (
    "pipelines", "fallbacks", "chunks_streamed", "chunks_pruned",
    "rows_streamed", "partial_merges", "generic_probes",
)
#: q15's revenue view, spelled once: the second spelling of q15 is
#: answered by the port's aggregate memo (``lower.alias_free_key``)
Q15_REVENUE = (
    "SELECT l_suppkey, SUM(l_extendedprice * (1 - l_discount)) AS r "
    "FROM lineitem WHERE l_shipdate >= DATE '1996-01-01' "
    "AND l_shipdate < DATE '1996-04-01' GROUP BY l_suppkey"
)
KNOBS = (
    "out_of_core", "ooc_min_rows", "memory_budget_bytes", "spill_dir",
    "ooc_merge_every", "ooc_prefetch", "io_retry_base_s",
)


@pytest.fixture(autouse=True, scope="module")
def _x64_on(_x64_policy):
    jax.config.update("jax_enable_x64", True)
    yield


@pytest.fixture(autouse=True)
def _port_slate():
    obs.metrics.reset()
    obs.clear_trace()
    yield


@pytest.fixture
def both(tmp_path):
    """Set a knob on the port's CONFIG and the JAX package's at once;
    both are restored after the test."""
    saved = [(cfg, {k: getattr(cfg, k) for k in KNOBS}) for cfg in (CONFIG, J_CONFIG)]

    def setter(**knobs):
        for cfg in (CONFIG, J_CONFIG):
            for k, v in knobs.items():
                setattr(cfg, k, v)

    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    CONFIG.spill_dir = str(tmp_path / "port")
    J_CONFIG.spill_dir = str(tmp_path / "jax")
    yield setter
    for cfg, knobs in saved:
        for k, v in knobs.items():
            setattr(cfg, k, v)


@pytest.fixture
def ooc(both):
    """force + tiny budget + merges every 2 chunks, in both packages."""
    both(out_of_core="force", memory_budget_bytes=1 << 14, ooc_merge_every=2)
    return both


def _port(query, scope, mode=None):
    if mode is None:
        return sql.execute(query, scope, device="cpu")
    saved = CONFIG.out_of_core
    CONFIG.out_of_core = mode
    try:
        return sql.execute(query, scope, device="cpu")
    finally:
        CONFIG.out_of_core = saved


def _odf(frame):
    """A port or JAX frame's columns as the oracle's lists."""
    if isinstance(frame, TensorFrame):
        return orc.frame_to_odf(frame)
    from repro.core import oracle as j_orc

    return j_orc.frame_to_odf(frame)


def _assert_same(got, want, rtol=1e-9):
    """Port frame against a port frame or a JAX frame: the same columns,
    the same rows as sets, ints exact and floats within ``rtol``."""
    godf, wodf = _odf(got), _odf(want)
    assert set(godf) == set(wodf)
    orc.assert_odf_equal(godf, wodf, sort=True, rtol=rtol)


def _counters(stats):
    return {k: stats[k] for k in COUNTERS}


def _reset_both():
    pipeline.reset_stats()
    j_pipeline.reset_stats()


# ----------------------------------------------------------------------
# seeded random sweep: force under a tiny budget against the JAX engine
# ----------------------------------------------------------------------
def _random_arrays(rng, nrows):
    return {
        "k": rng.integers(0, max(2, nrows // 8), nrows),
        "g": rng.integers(-5, 5, nrows),
        "v": rng.integers(-1000, 1000, nrows),
        "w": np.round(rng.standard_normal(nrows), 3),
    }


QUERIES = [
    "SELECT g, SUM(v) AS sv, COUNT(*) AS n FROM t GROUP BY g",
    "SELECT g, MIN(v) AS lo, MAX(v) AS hi, AVG(w) AS aw FROM t GROUP BY g",
    "SELECT k, SUM(w) AS sw FROM t WHERE v > 0 GROUP BY k",
    "SELECT g, COUNT(*) AS n FROM t WHERE v > -500 AND v < 500 GROUP BY g",
    "SELECT SUM(v) AS sv, MAX(w) AS mw FROM t WHERE g >= 0",
]


# the JAX engine takes about 40 s for each seed (its streamed group-by
# over ``k`` recompiles per chunk shape): seeds 1 and 2 run as slow
@pytest.mark.parametrize(
    "seed", [0] + [pytest.param(s, marks=pytest.mark.slow) for s in (1, 2)])
def test_force_tiny_budget_matches_jax_random(ooc, seed):
    rng = np.random.default_rng(seed)
    nrows = int(rng.integers(300, 3000))
    chunk_rows = int(rng.integers(64, 512))
    cols = _random_arrays(rng, nrows)
    scope = {"t": store.Table.from_arrays(cols, chunk_rows=chunk_rows)}
    j_scope = {"t": j_store.Table.from_arrays(cols, chunk_rows=chunk_rows)}
    for query in QUERIES:
        _reset_both()
        got = _port(query, scope)
        want = j_sql.execute(query, j_scope)
        _assert_same(got, want)
        assert _counters(pipeline.STATS) == _counters(j_pipeline.STATS), query
        assert pipeline.STATS["chunks_streamed"] > 0
        _assert_same(got, _port(query, scope, "off"))
        assert got.device.type == "cpu"


def test_spilling_run_changes_no_result(ooc):
    """A budget of one byte spills every partial and re-reads it at each
    merge: the results stay those of the eager path."""
    ooc(memory_budget_bytes=1)
    cols = _random_arrays(np.random.default_rng(3), 2000)
    scope = {"t": store.Table.from_arrays(cols, chunk_rows=128)}
    for query in QUERIES[:3]:
        _reset_both()
        got = _port(query, scope)
        pipeline.sync_spill_stats()
        assert pipeline.STATS["bytes_spilled"] > 0, query
        assert pipeline.STATS["bytes_reread"] > 0, query
        _assert_same(got, _port(query, scope, "off"))


def test_hypothesis_force_matches_eager(ooc):
    hyp = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")

    @hyp.settings(max_examples=25, deadline=None)
    @hyp.given(
        seed=st.integers(0, 2**31 - 1),
        nrows=st.integers(64, 2000),
        chunk_rows=st.integers(32, 256),
        budget=st.integers(1 << 10, 1 << 16),
        query=st.sampled_from(QUERIES),
    )
    def inner(seed, nrows, chunk_rows, budget, query):
        ooc(memory_budget_bytes=budget)
        cols = _random_arrays(np.random.default_rng(seed), nrows)
        scope = {"t": store.Table.from_arrays(cols, chunk_rows=chunk_rows)}
        _assert_same(_port(query, scope), _port(query, scope, "off"))

    inner()


# ----------------------------------------------------------------------
# zone-map pruning monotonicity through filter chains
# ----------------------------------------------------------------------
def test_pruning_counters_monotone_through_filter_chain(ooc):
    n = 4096
    cols = {"d": np.arange(n), "v": np.arange(n) % 7}  # clustered: tight zone maps
    scope = {"t": store.Table.from_arrays(cols, chunk_rows=256)}
    j_scope = {"t": j_store.Table.from_arrays(cols, chunk_rows=256)}
    base = "SELECT SUM(v) AS sv FROM t"
    preds = [" WHERE d >= 1024", " WHERE d >= 1024 AND d < 2048"]
    pruned, streamed = [], []
    for extra in [""] + preds:
        _reset_both()
        got = _port(base + extra, scope)
        _assert_same(got, j_sql.execute(base + extra, j_scope))
        assert _counters(pipeline.STATS) == _counters(j_pipeline.STATS)
        _assert_same(got, _port(base + extra, scope, "off"))
        pruned.append(pipeline.STATS["chunks_pruned"])
        streamed.append(pipeline.STATS["chunks_streamed"])
    # each extra conjunct can only prune MORE chunks, never fewer
    assert pruned[0] <= pruned[1] <= pruned[2]
    assert streamed[0] >= streamed[1] >= streamed[2]
    assert pruned[2] > 0  # the range predicate provably skips chunks


# ----------------------------------------------------------------------
# TPC-H: the capped-budget differential and counter parity
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def tpch_scopes(tpch_small):
    tables, _ = tpch_small
    frames = tpch.as_frames(tables, device="cpu")
    stores = tpch.as_store(tables, chunk_rows=512, sort_fact_by_date=True)
    return frames, stores


def _check_capped(tpch_scopes, qname):
    frames, stores = tpch_scopes
    text = sql_text(qname, SF)
    want = _port(text, frames, "off")
    got = _port(text, stores)
    godf, wodf = _odf(got), _odf(want)
    if qname in SCALAR_SQL:
        (name,) = godf.keys()
        assert godf[name][0] == pytest.approx(wodf[name][0], rel=1e-8)
        return got
    assert set(godf) == set(wodf)
    orc.assert_odf_equal(godf, wodf, sort=True, rtol=1e-8)
    return got


@pytest.mark.parametrize("qname", FAST_TPCH)
def test_capped_tpch_matches_eager(tpch_scopes, ooc, qname):
    got = _check_capped(tpch_scopes, qname)
    assert pipeline.STATS["pipelines"] >= 1
    if qname == "q15":
        assert got.nrows >= 1  # the revenue maximum finds its supplier


@pytest.mark.slow
@pytest.mark.parametrize("qname", QNAMES)
def test_capped_tpch_full_sweep(tpch_scopes, ooc, qname):
    _check_capped(tpch_scopes, qname)


@pytest.fixture(scope="module")
def parity_stores(tpch_small):
    tables, _ = tpch_small
    return (
        tpch.as_store(tables, chunk_rows=4096, sort_fact_by_date=True),
        j_tpch.as_store(tables, chunk_rows=4096, sort_fact_by_date=True),
    )


def _counter_params():
    return [q if q in FAST_TPCH else pytest.param(q, marks=pytest.mark.slow)
            for q in QNAMES]


@pytest.mark.parametrize("qname", _counter_params())
def test_counters_match_jax_under_force(parity_stores, both, qname):
    stores, j_stores = parity_stores
    both(out_of_core="force")
    text = sql_text(qname, SF)
    _reset_both()
    got = _port(text, stores)
    port = _counters(pipeline.STATS)
    _reset_both()
    want = j_sql.execute(text, j_stores)
    ref = _counters(j_pipeline.STATS)
    godf, wodf = _odf(got), _odf(want)
    assert list(godf) == list(wodf)
    orc.assert_odf_equal(godf, wodf, sort=True, rtol=1e-9)
    if qname != "q15":
        assert port == ref
        return
    # q15 spells its revenue view twice: the reference streams it twice,
    # the port streams it once and its aggregate memo answers the second
    # spelling with the same frame
    _reset_both()
    j_sql.execute(Q15_REVENUE, j_stores)
    once = _counters(j_pipeline.STATS)
    assert port == once
    assert ref == {k: 2 * v for k, v in once.items()}
    assert port["pipelines"] == 1 and got.nrows >= 1


# ----------------------------------------------------------------------
# ChunkScan: prefetch, early close, checkpoint
# ----------------------------------------------------------------------
def _scan_table():
    n = 1000
    cols = {"a": np.arange(n), "b": np.arange(n) % 7, "c": np.arange(n) * 0.5}
    return cols, store.Table.from_arrays(cols, chunk_rows=100)


def _alive_producers(before):
    return [t for t in threading.enumerate() if t not in before and t.is_alive()]


@pytest.mark.parametrize("prefetch", [0, 2])
def test_chunk_scan_prefetch_and_early_close(both, prefetch):
    both(ooc_prefetch=prefetch)
    cols, table = _scan_table()
    j_table = j_store.Table.from_arrays(cols, chunk_rows=100)
    preds = [store.Pred("a", ">=", 250)]
    before = set(threading.enumerate())
    _reset_both()
    cs = pipeline.ChunkScan(table, ["a", "b", "c"], preds, device="cpu")
    j_cs = j_pipeline.ChunkScan(j_table, ["a", "b", "c"], [j_store.Pred("a", ">=", 250)])
    got = list(cs.iter_indexed())
    want = list(j_cs.iter_indexed())
    assert [i for i, _ in got] == [i for i, _ in want] == list(range(2, 10))
    for (_, f), (_, jf) in zip(got, want):
        assert f.device.type == "cpu"
        for name in ("a", "b", "c"):
            np.testing.assert_array_equal(f.column(name), np.asarray(jf.column(name)))
        # each chunk's bounds are its own zone map's, as in the reference
        assert f.col_stats("a").vmin == jf.col_stats("a").vmin
        assert f.col_stats("a").vmax == jf.col_stats("a").vmax
    assert _counters(pipeline.STATS) == _counters(j_pipeline.STATS)
    assert pipeline.STATS["chunks_pruned"] == 2
    assert not _alive_producers(before)
    # a consumer that stops early leaves no producer thread behind
    gen = cs.iter_indexed()
    next(gen)
    gen.close()
    assert not _alive_producers(before)
    # nor does one that fails mid-stream
    with pytest.raises(ZeroDivisionError):
        for _ in cs:
            1 / 0
    assert not _alive_producers(before)


def test_chunk_scan_checkpoint_raises_typed_timeout(both):
    _, table = _scan_table()
    cs = pipeline.ChunkScan(table, ["a", "b"], [], device="cpu")
    with deadline_scope(at=time.monotonic() - 1.0):
        with pytest.raises(QueryTimeout):
            list(cs)


# ----------------------------------------------------------------------
# HashBuild: the direct-address, membership and generic probes
# ----------------------------------------------------------------------
def _probe_frames(frame_cls, **kwargs):
    rng = np.random.default_rng(5)
    probe = {"k": rng.integers(-3, 60, 400), "x": np.arange(400)}
    build = {"k": np.arange(0, 50, 2), "y": np.arange(25) * 1.5}
    dup = {"k": np.repeat(np.arange(0, 50, 5), 2), "y": np.arange(20) * 1.0}
    return (frame_cls.from_arrays(probe, **kwargs), frame_cls.from_arrays(build, **kwargs),
            frame_cls.from_arrays(dup, **kwargs))


@pytest.mark.parametrize("how", ["inner", "semi", "anti"])
def test_hash_build_matches_jax_and_the_join(both, how):
    probe, build, dup = _probe_frames(TensorFrame, device="cpu")
    j_probe, j_build, j_dup = _probe_frames(JFrame)
    _reset_both()
    for b, jb in ((build, j_build), (dup, j_dup)):
        hb = pipeline.HashBuild(["k"], b, ["k"], how)
        j_hb = j_pipeline.HashBuild(["k"], jb, ["k"], how)
        got = hb.apply(probe)
        _assert_same(got, j_hb.apply(j_probe))
        _assert_same(got, probe.join(b, left_on=["k"], right_on=["k"], how=how))
        assert hb.disjoint(probe) is j_hb.disjoint(j_probe) is False
    # the non-unique inner build probes through the general join
    assert _counters(pipeline.STATS) == _counters(j_pipeline.STATS)
    assert pipeline.STATS["generic_probes"] == (1 if how == "inner" else 0)


def test_hash_build_null_keys_never_match(both):
    probe = store.Table.from_arrays(
        {"k": np.array([1, 2, 3, 4]), "x": np.arange(4)}, chunk_rows=4,
        validity={"k": np.array([True, False, True, True])})
    f = TensorFrame.from_store(probe, device="cpu")
    build = TensorFrame.from_arrays({"k": np.array([1, 2, 3]), "y": np.arange(3) * 1.0},
                                    device="cpu")
    got = pipeline.HashBuild(["k"], build, ["k"], "inner").apply(f)
    assert sorted(got.column("x").tolist()) == [0, 2]  # the null key 2 matches nothing
    anti = pipeline.HashBuild(["k"], build, ["k"], "anti").apply(f)
    assert sorted(anti.column("x").tolist()) == [1, 3]


# ----------------------------------------------------------------------
# StreamAgg: a corrupt spilled partial recomputes through its closure
# ----------------------------------------------------------------------
def test_streamagg_partial_recompute(both):
    both(io_retry_base_s=1e-4)
    chunks = [
        TensorFrame.from_arrays(
            {"g": np.arange(100) % 5, "v": np.arange(100) + 100.0 * i}, device="cpu")
        for i in range(3)
    ]
    sagg = pipeline.StreamAgg(["g"], [("s", "sum", "v"), ("c", "count", "v")], device="cpu")
    for f in chunks:
        sagg.add(f, rebuild=lambda f=f: f)
    assert sagg._pending, "partials should be registered"
    h = sagg._pending[0]
    h._do_spill()
    assert h.spilled
    with open(f"{h._path}/manifest.json", "w") as fh:
        fh.write("not json")
    out = sagg.finalize()
    assert SPILL.counters["recomputes"] == 1
    assert out.device.type == "cpu"
    all_g = np.concatenate([np.arange(100) % 5] * 3)
    all_v = np.concatenate([np.arange(100) + 100.0 * i for i in range(3)])
    got = {int(g): (float(s), int(c)) for g, s, c in
           zip(out.column("g"), out.column("s"), out.column("c"))}
    for g in range(5):
        mask = all_g == g
        assert got[g][0] == pytest.approx(float(all_v[mask].sum()))
        assert got[g][1] == int(mask.sum())


def test_stream_entry_points_want_the_card_unless_asked(both):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default device is valid")
    _, table = _scan_table()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.ChunkScan(table, ["a"], [])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.StreamAgg(["g"], [("s", "sum", "v")])


# ----------------------------------------------------------------------
# the capped runner: an uncapped ooc run on the CPU matches its prepare
# ----------------------------------------------------------------------
def test_run_capped_ooc_matches_prepare(tpch_small, both, tmp_path):
    tables, _ = tpch_small
    stores = tpch.as_store(tables, chunk_rows=run_capped.CHUNK_ROWS, sort_fact_by_date=True)
    workdir = str(tmp_path / "capped")
    expected = run_capped.prepare_stores(stores, workdir, SF, "cpu")
    assert set(expected) == set(run_capped.QUERIES)
    env = dict(os.environ, PYTHONPATH=str(run_capped.SRC))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.run_capped", "run", "--mode", "ooc",
         "--cap-mb", "0", "--workdir", workdir, "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    (line,) = [ln for ln in out.stdout.splitlines() if ln.startswith('{"run"')]
    report = json.loads(line)["run"]
    assert report["ok"] and report["oom"] is None
    # q1, q6 and q14 each streamed one pipeline
    assert report["pipeline"]["pipelines"] == 3
    assert "RESULT PASS" in out.stdout
