"""The port's whole-plan compilation (``repro_torch.sql.compile``) on the
CPU, held to the JAX package's ``repro.sql.compile`` case by case (the
cases of tests/test_sql_compile.py).

On the CPU a compiled plan is its traced function run eagerly (no CUDA
graph), under the same fingerprints, cache and ``STATS`` as on the card:

- the 22 TPC-H texts at SF 0.002 under ``CONFIG.compiled = "force"``,
  each equal to the port's op-by-op result with one compile and no
  fallback; and equal to the JAX package's compiled result (the six texts
  the reference keeps out of its slow lane in tier-1, the rest slow);
- the plan cache: the same call sequences as the reference's cache tests
  through both packages, with equal ``STATS`` counters;
- fixed-capacity semantics: random filter-join-aggregate pipelines
  against both the JAX package's compiled result and the port op by op;
- the trace guard: traced code that reads a device value on the host
  falls back and is negative-cached.
"""
import numpy as np
import pytest
import torch

import jax

from repro import sql as j_sql
from repro.core import TensorFrame as JFrame
from repro.core.config import CONFIG as J_CONFIG
from repro.serve.engine import PreparedStatement as JPreparedStatement
from repro.sql import compile as j_compile
from repro_torch import obs, sql
from repro_torch.core import TensorFrame
from repro_torch.core import oracle as orc
from repro_torch.core.config import CONFIG
from repro_torch.data import tpch
from repro_torch.queries.tpch_sql import SCALAR_SQL, TPCH_SQL, sql_text
from repro_torch.serve.engine import PreparedStatement
from repro_torch.sql import compile as plan_compile

SF = 0.002  # must match the shared tpch_small fixture (conftest.py)

# the reference's slow lane (tests/test_sql_compile.py): each of these
# compiles a multi-join XLA program in the JAX package
SLOW_SQL = {
    "q2", "q3", "q4", "q5", "q7", "q8", "q9", "q10",
    "q11", "q13", "q15", "q16", "q17", "q18", "q20", "q21",
}

QNAMES = sorted(TPCH_SQL, key=lambda s: int(s[1:]))

#: the counters of STATS (``plans`` holds timings)
COUNTERS = ("hits", "misses", "evictions", "compiles", "fallbacks", "compile_failures",
            "skipped_small")


@pytest.fixture(autouse=True, scope="module")
def _x64_on(_x64_policy):
    # the conftest policy turns x64 off for this file's prefix; the
    # reference engine needs exact int64 keys
    jax.config.update("jax_enable_x64", True)
    yield


@pytest.fixture(autouse=True)
def compiled_mode():
    """Both packages force-compile inside the test, with empty caches and
    zeroed counters; defaults come back after."""
    obs.metrics.reset()
    obs.clear_trace()
    for mod in (plan_compile, j_compile):
        mod.clear_cache()
        mod.reset_stats()
    CONFIG.compiled = J_CONFIG.compiled = "force"
    try:
        yield plan_compile.STATS
    finally:
        for cfg in (CONFIG, J_CONFIG):
            cfg.compiled = "auto"
            cfg.compiled_min_rows = 1 << 15
        plan_compile.clear_cache()
        j_compile.clear_cache()


@pytest.fixture(scope="module")
def data(tpch_small):
    tables, jax_frames = tpch_small
    return tables, jax_frames, tpch.as_frames(tables, device="cpu")


def _counters(stats) -> dict:
    return {k: stats[k] for k in COUNTERS}


def _assert_same_result(got, want, rtol=1e-8, qname=None):
    """Same column names in the same order; ints, codes and row sets
    exact, floats within ``rtol`` (a scalar query by value)."""
    assert got.column_names == want.column_names
    godf, wodf = orc.frame_to_odf(got), orc.frame_to_odf(want)
    if qname in SCALAR_SQL:
        for name in wodf:
            assert godf[name][0] == pytest.approx(wodf[name][0], rel=rtol)
        return
    orc.assert_odf_equal(godf, wodf, sort=True, rtol=rtol)


def _run_both(text, frames):
    """(compiled, op by op) results of ``text`` in the port."""
    CONFIG.compiled = "off"
    ref = sql.execute(text, frames)
    CONFIG.compiled = "force"
    return sql.execute(text, frames), ref


# ----------------------------------------------------------------------
# the 22 TPC-H texts
# ----------------------------------------------------------------------
@pytest.mark.parametrize("qname", QNAMES)
def test_tpch_compiled_matches_dispatch(data, compiled_mode, qname):
    _, _, frames = data
    out, ref = _run_both(sql_text(qname, SF), frames)
    _assert_same_result(out, ref, qname=qname)
    # the whole query really ran as one compiled program
    assert compiled_mode["compiles"] == 1
    assert compiled_mode["fallbacks"] == 0
    assert not plan_compile._NEGATIVE


def _jax_params():
    return [pytest.param(q, marks=pytest.mark.slow) if q in SLOW_SQL else q for q in QNAMES]


@pytest.mark.parametrize("qname", _jax_params())
def test_tpch_compiled_matches_the_jax_compiled(data, compiled_mode, qname):
    _, jax_frames, frames = data
    text = sql_text(qname, SF)
    got = sql.execute(text, frames)
    want = j_sql.execute(text, jax_frames)
    _assert_same_result(got, want, qname=qname)
    assert compiled_mode["compiles"] == j_compile.STATS["compiles"] == 1
    assert compiled_mode["fallbacks"] == j_compile.STATS["fallbacks"] == 0


def test_tpch_auto_mode_compiles_large_inputs(data, compiled_mode):
    """auto = compile iff the scanned base tables clear the size gate;
    either way the results match dispatch, and both packages count the
    same."""
    _, jax_frames, frames = data
    text = sql_text("q1", SF)
    CONFIG.compiled = J_CONFIG.compiled = "off"
    ref = sql.execute(text, frames)
    for cfg in (CONFIG, J_CONFIG):
        cfg.compiled = "auto"
        cfg.compiled_min_rows = 1 << 60  # unreachable -> dispatch
    _assert_same_result(sql.execute(text, frames), ref, qname="q1")
    j_sql.execute(text, jax_frames)
    assert compiled_mode["skipped_small"] == 1 and compiled_mode["compiles"] == 0
    for cfg in (CONFIG, J_CONFIG):
        cfg.compiled_min_rows = 0  # everything clears the gate
    _assert_same_result(sql.execute(text, frames), ref, qname="q1")
    j_sql.execute(text, jax_frames)
    assert compiled_mode["compiles"] == 1
    assert _counters(compiled_mode) == _counters(j_compile.STATS)


# ----------------------------------------------------------------------
# plan cache keying: the same call sequence through both packages
# ----------------------------------------------------------------------
def _arrays(n, float_b=False, seed=0):
    rng = np.random.default_rng(seed)
    b = rng.random(n) * 10 if float_b else rng.integers(0, 50, n)
    return {"a": rng.integers(0, 9, n), "b": b, "w": rng.random(n)}


def _scopes(n, float_b=False, seed=0):
    arrays = _arrays(n, float_b, seed)
    return ({"t": TensorFrame.from_arrays(arrays, device="cpu")},
            {"t": JFrame.from_arrays(arrays)})


Q = "SELECT a, SUM(w) AS s, COUNT(*) AS c FROM t WHERE b > {k} GROUP BY a"


def _sequence(calls):
    """Each (text, port scope, jax scope) through both packages; the port's
    results, held to the JAX package's, and its counters, held to the JAX
    package's after every call."""
    out = []
    for text, scope, jscope in calls:
        got = sql.execute(text, scope)
        _assert_same_result(got, j_sql.execute(text, jscope))
        assert _counters(plan_compile.STATS) == _counters(j_compile.STATS)
        out.append(got)
    return out


def test_repeat_query_compiles_once(compiled_mode):
    p, j = _scopes(100)
    r1, r2 = _sequence([(Q.format(k=10), p, j)] * 2)
    assert (compiled_mode["compiles"], compiled_mode["misses"], compiled_mode["hits"]) == (1, 1, 1)
    orc.assert_odf_equal(orc.frame_to_odf(r1), orc.frame_to_odf(r2), sort=True)


def test_changed_literal_hits_cache(compiled_mode):
    """The serving case: same plan shape, different parameter -- no new
    trace, the literal travels in the parameter buffers."""
    p, j = _scopes(100)
    _sequence([(Q.format(k=10), p, j)])
    for k in (20, 30, 5, 45):
        (out,) = _sequence([(Q.format(k=k), p, j)])
        CONFIG.compiled = "off"
        ref = sql.execute(Q.format(k=k), p)
        CONFIG.compiled = "force"
        _assert_same_result(out, ref)
    assert compiled_mode["compiles"] == 1
    assert compiled_mode["hits"] == 4


def test_same_bucket_size_hits_cache(compiled_mode):
    # 100 and 120 rows both pad to the 128 bucket -> one entry; the padded
    # copy of t is refilled with the second frame's rows
    (p1, j1), (p2, j2) = _scopes(100), _scopes(120, seed=1)
    _sequence([(Q.format(k=10), p1, j1), (Q.format(k=10), p2, j2), (Q.format(k=10), p1, j1)])
    assert compiled_mode["compiles"] == 1
    assert compiled_mode["hits"] == 2


def test_bucket_change_recompiles(compiled_mode):
    (p1, j1), (p2, j2) = _scopes(100), _scopes(200)
    _sequence([(Q.format(k=10), p1, j1), (Q.format(k=10), p2, j2)])  # bucket 128 -> 256
    assert compiled_mode["compiles"] == 2
    assert compiled_mode["hits"] == 0


def test_dtype_change_recompiles(compiled_mode):
    (p1, j1), (p2, j2) = _scopes(100), _scopes(100, float_b=True)
    _sequence([(Q.format(k=10), p1, j1), (Q.format(k=10), p2, j2)])
    assert compiled_mode["compiles"] == 2
    assert compiled_mode["hits"] == 0


def test_stats_record_per_plan_timings(compiled_mode):
    p, j = _scopes(100)
    _sequence([(Q.format(k=10), p, j), (Q.format(k=11), p, j)])
    (rec,) = compiled_mode["plans"].values()
    assert rec["calls"] == 2
    assert rec["trace_s"] > 0 and rec["compile_s"] >= 0
    assert rec["exec_s"] > 0 and rec["tables"] == ["t"]
    (jrec,) = j_compile.STATS["plans"].values()
    assert (rec["calls"], rec["tables"]) == (jrec["calls"], jrec["tables"])


def test_unsupported_plan_falls_back_and_is_negative_cached(compiled_mode):
    # many-to-many self join: neither side is unique on the key
    arrays = {"k": np.array([1, 1, 2, 2]), "v": np.arange(4.0)}
    p = {"t": TensorFrame.from_arrays(arrays, device="cpu")}
    j = {"t": JFrame.from_arrays(arrays)}
    q = "SELECT a.v AS x, b.v AS y FROM t a, t b WHERE a.k = b.k"
    CONFIG.compiled = "off"
    ref = sql.execute(q, p)
    CONFIG.compiled = "force"
    (out,) = _sequence([(q, p, j)])
    _assert_same_result(out, ref)
    assert compiled_mode["fallbacks"] == 1
    assert compiled_mode["compiles"] == 0
    _sequence([(q, p, j)])  # negative-cached: no second trace attempt
    assert compiled_mode["fallbacks"] == 2
    assert compiled_mode["misses"] == 1


def test_prepared_statement_zero_recompiles(compiled_mode):
    p, j = _scopes(100)
    ps, jps = PreparedStatement(Q, p), JPreparedStatement(Q, j)
    for k in (10, 15, 25, 35):
        _assert_same_result(ps.execute(k=k), jps.execute(k=k))
    assert ps.calls == jps.calls == 4
    assert compiled_mode["compiles"] == 1
    assert compiled_mode["hits"] == 3
    assert _counters(compiled_mode) == _counters(j_compile.STATS)


def test_prepared_statement_scope_of_raw_arrays():
    """Raw arrays go to the device the statement names."""
    ps = PreparedStatement(Q, {"t": _arrays(50)}, device="cpu")
    assert ps.frames["t"].device.type == "cpu"
    assert ps.execute(k=10).device.type == "cpu"


def test_udf_and_store_scans_decline(compiled_mode, tmp_path):
    """Session UDFs and store-backed scans run op by op and count as
    fallbacks (the reference's checks)."""
    from repro_torch import store
    from repro_torch.sql import udf

    p, _ = _scopes(100)
    with udf.udf_scope({"twice": udf.Udf("twice", lambda x: 2 * x, "num")}):
        out = sql.execute("SELECT a, SUM(twice(w)) AS s FROM t GROUP BY a", p)
    assert out.nrows > 0
    tbl = store.Table.from_arrays(_arrays(100))
    sql.execute(Q.format(k=10), {"t": tbl}, device="cpu")
    assert compiled_mode["fallbacks"] == 2 and compiled_mode["compiles"] == 0


# ----------------------------------------------------------------------
# the trace guard
# ----------------------------------------------------------------------
@pytest.mark.parametrize("read", ["item", "tolist", "bool", "nonzero", "mask_index"])
def test_host_read_in_traced_code_falls_back(compiled_mode, monkeypatch, read):
    """A traced function that reads an input-derived value on the host (or
    asks for a data-dependent shape) raises the trace guard's error: the
    plan falls back and is negative-cached, like a JAX concretization
    error in the reference."""
    real = plan_compile._c_filter

    def reading(node, ct, ctx):
        out = real(node, ct, ctx)
        if read == "item":
            out.n.item()
        elif read == "tolist":
            out.mask.tolist()
        elif read == "bool":
            bool(out.mask.any())
        elif read == "nonzero":
            torch.nonzero(out.mask)
        else:
            ct.frame.itensor[out.mask]
        return out

    monkeypatch.setattr(plan_compile, "_c_filter", reading)
    p, _ = _scopes(100)
    CONFIG.compiled = "off"
    ref = sql.execute(Q.format(k=10), p)
    CONFIG.compiled = "force"
    for _ in range(2):
        _assert_same_result(sql.execute(Q.format(k=10), p), ref)
    assert compiled_mode["compiles"] == 0 and compiled_mode["misses"] == 1
    assert compiled_mode["fallbacks"] == 2
    (reason,) = plan_compile._NEGATIVE.values()
    assert reason.startswith("TraceGuardError")
    # the guard is gone once the trace is over
    assert torch.arange(3).tolist() == [0, 1, 2]


def test_trace_guard_is_scoped_to_the_trace():
    """The guard refuses host reads inside its scope only, and its method
    patches are gone after it."""
    assert torch.Tensor.tolist.__name__ == "tolist"
    with plan_compile._TraceGuard(None, record=True):
        with pytest.raises(plan_compile.TraceGuardError):
            torch.ones(2).sum().item()
    assert float(torch.ones(2).sum()) == 2.0


# ----------------------------------------------------------------------
# fixed-capacity semantics: the JAX package's compiled result and the
# port op by op
# ----------------------------------------------------------------------
def _pipeline_arrays(rng, n, xs=None):
    t = {
        "k": rng.integers(0, 12, n),
        "x": rng.integers(-20, 20, n) if xs is None else np.asarray(xs, dtype=np.int64),
        "y": rng.random(n) * 100,
    }
    u = {"k": np.arange(12), "w": rng.random(12)}  # unique build side
    return t, u


PIPE = (
    "SELECT t.k AS k, SUM(t.y + u.w) AS s, COUNT(*) AS c, MIN(t.x) AS m "
    "FROM t, u WHERE t.k = u.k AND t.x > {thr} GROUP BY t.k"
)


def _check_pipeline(t, u, thr):
    p = {name: TensorFrame.from_arrays(a, device="cpu") for name, a in (("t", t), ("u", u))}
    j = {"t": JFrame.from_arrays(t), "u": JFrame.from_arrays(u)}
    out, ref = _run_both(PIPE.format(thr=thr), p)
    _assert_same_result(out, ref)
    _assert_same_result(out, j_sql.execute(PIPE.format(thr=thr), j))


def test_random_filter_join_agg_matches_eager(compiled_mode):
    rng = np.random.default_rng(7)
    for _ in range(8):
        t, u = _pipeline_arrays(rng, int(rng.integers(1, 90)))
        _check_pipeline(t, u, int(rng.integers(-25, 25)))  # sometimes filters out all rows
    assert compiled_mode["fallbacks"] == 0 and j_compile.STATS["fallbacks"] == 0


def test_hypothesis_filter_join_agg_matches_eager(compiled_mode):
    hyp = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")

    @hyp.settings(max_examples=25, deadline=None)
    @hyp.given(
        xs=st.lists(st.integers(-20, 20), min_size=1, max_size=60),
        thr=st.integers(-25, 25),
        seed=st.integers(0, 2**16),
    )
    def check(xs, thr, seed):
        t, u = _pipeline_arrays(np.random.default_rng(seed), len(xs), xs)
        _check_pipeline(t, u, thr)

    check()
    assert compiled_mode["fallbacks"] == 0


def test_compiled_q15_equals_its_two_spellings(data, compiled_mode):
    """q15 compares two separately written copies of one float SUM for
    equality: the compiled route returns its row (K1's sums are the same
    bits each time, and the plain version's on the CPU)."""
    _, _, frames = data
    for _ in range(2):
        assert sql.execute(sql_text("q15", SF), frames).nrows == 1


def test_parameterize_collects_literals_in_order(data):
    """Numeric and date literals become parameter slots in a fixed order;
    IN lists, LIKE patterns and SUBSTRING bounds stay in the plan."""
    _, jax_frames, frames = data
    plan = sql.plan_query(sql_text("q6", SF), frames)
    pplan, values = plan_compile.parameterize(plan)
    _, jvalues = j_compile.parameterize(j_sql.plan_query(sql_text("q6", SF), jax_frames))
    assert values == jvalues
    assert [k for k, _ in values] == ["date", "date", "float", "float", "int"]
    pplan2, values2 = plan_compile.parameterize(
        sql.plan_query(sql_text("q6", SF).replace("< 24", "< 25"), frames))
    assert repr(pplan2) == repr(pplan) and values2[-1] == ("int", 25)


def test_concurrent_executions_share_one_entry_per_plan(compiled_mode):
    """Threads executing two plan shapes at once, with other literals:
    one trace a shape (the other threads reuse its entry), every result
    equal to op by op.  The trace guard is scoped to the tracing thread,
    so host reads in the other threads go through."""
    import sys
    import threading

    p, _ = _scopes(100)
    shapes = [Q, "SELECT a, MAX(w) AS s, COUNT(*) AS c FROM t WHERE b > {k} GROUP BY a"]
    CONFIG.compiled = "off"
    want = {(i, k): orc.frame_to_odf(sql.execute(q.format(k=k), p))
            for i, q in enumerate(shapes) for k in (5, 25)}
    CONFIG.compiled = "force"
    errors = []

    def worker(seed):
        rng = np.random.default_rng(seed)
        for _ in range(6):
            i, k = int(rng.integers(0, 2)), int(rng.choice([5, 25]))
            try:
                got = orc.frame_to_odf(sql.execute(shapes[i].format(k=k), p))
                orc.assert_odf_equal(got, want[(i, k)], sort=True, rtol=1e-12)
            except Exception as e:  # reported below, with every other thread's
                errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(s,)) for s in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors[:3]
    assert compiled_mode["compiles"] == 2 and compiled_mode["fallbacks"] == 0
    assert compiled_mode["hits"] + compiled_mode["misses"] == 8 * 6
    assert torch.Tensor.tolist.__name__ == "tolist" and not plan_compile._TRACE_LOCKS


def test_entry_keeps_its_padded_tables(compiled_mode):
    """A captured graph reads its padded base tables by address: once the
    frame that filled them is gone and the shared copy is dropped, the
    entry still holds its own and refills it for the next frame."""
    import gc

    p1, _ = _scopes(100)
    sql.execute(Q.format(k=10), p1)
    (entry,) = plan_compile._CACHE.values()
    pad = entry.pads["t"]
    del p1
    gc.collect()
    p2, _ = _scopes(120, seed=1)
    sql.execute("SELECT a, MIN(w) AS s FROM t GROUP BY a", p2)  # compiles; drops the dead copy
    assert all(p is not pad for p in plan_compile._PADS.values())
    out = sql.execute(Q.format(k=10), p2)
    assert entry.pads["t"] is pad and compiled_mode["hits"] == 1
    CONFIG.compiled = "off"
    _assert_same_result(out, sql.execute(Q.format(k=10), p2))
