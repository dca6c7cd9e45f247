"""Concurrent SQL serving of the port (``serve/sql.py``,
``serve/admission.py``, ``serve/stats.py``) on the CPU, held to the JAX
package's ``repro.serve.sql.Executor``.

After ``tests/test_serve_sql.py`` and the executor cases of
``tests/test_resilience.py``: staged micro-batches (``auto_start=False``
and ``drain_once()``, so batch counts do not depend on timing) run
through both executors over the same scope, and each result and each
``serve.STATS`` counter of the port must equal the reference's.  Then
the surface the reference tests alone: sessions and UDF isolation,
``Prepared`` riding the plan cache, the thread safety of the compile
cache and the string pool, deadlines, cancels (queued and mid-flight),
the two shed policies, the in-flight cap, ``close()`` with work
pending, the worker's restart after a crash, and a short chaos storm.
Every error that reaches a caller must be a typed ``QueryError``.

Every test sets the port's ``CONFIG`` and the JAX package's side by side
(the ``both`` fixture) and restores both.  The port runs on the CPU
because each executor asks for it (``device="cpu"``).
"""
import random
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax

from repro import serve as j_serve
from repro import store as j_store
from repro.core.config import CONFIG as J_CONFIG
from repro.core.frame import TensorFrame as JFrame
from repro.resilience import faults as j_faults
from repro.serve.stats import STATS as J_STATS
from repro_torch import obs, resilience, serve, sql, store
from repro_torch.core import TensorFrame
from repro_torch.core import oracle as orc
from repro_torch.core.config import CONFIG
from repro_torch.kernels.build import KernelError
from repro_torch.resilience import (
    ExecutionError,
    QueryCancelled,
    QueryError,
    QueryTimeout,
    ResourceExhausted,
    faults,
)
from repro_torch.serve.stats import STATS
from repro_torch.sql import compile as plan_compile

THREADS = 4
ROUNDS = 2
KNOBS = (
    "serve_max_batch", "serve_batch_window_ms", "serve_shared_scans",
    "serve_coalesce", "serve_default_timeout_s", "serve_queue_depth",
    "serve_shed_policy", "serve_session_inflight", "compiled",
    "compiled_min_rows", "out_of_core", "ooc_min_rows", "memory_budget_bytes",
    "io_retry_base_s",
)
#: the batcher's counters (``serve.stats._fresh``) compared key for key
COUNTS = (
    "admitted", "batches", "batched_queries", "shared_scan_groups",
    "shared_scan_queries", "shared_scan_errors", "plan_cache_hits",
    "coalesced", "prepared", "udf_queries", "shed_requests",
    "worker_restarts",
)


@pytest.fixture(autouse=True, scope="module")
def _x64_on(_x64_policy):
    jax.config.update("jax_enable_x64", True)
    yield


@pytest.fixture(autouse=True)
def _slate():
    obs.metrics.reset()
    obs.clear_trace()
    STATS.reset()
    J_STATS.reset()
    faults.clear()
    j_faults.clear()
    yield
    faults.clear()
    j_faults.clear()


@pytest.fixture
def both():
    """Set a knob on the port's CONFIG and the JAX package's at once;
    both are restored after the test."""
    saved = [(cfg, {k: getattr(cfg, k) for k in KNOBS}) for cfg in (CONFIG, J_CONFIG)]

    def setter(**knobs):
        for cfg in (CONFIG, J_CONFIG):
            for k, v in knobs.items():
                setattr(cfg, k, v)

    yield setter
    for cfg, knobs in saved:
        for k, v in knobs.items():
            setattr(cfg, k, v)
    plan_compile.clear_cache()


def _store_arrays():
    rng = np.random.default_rng(7)
    n = 4000
    return {
        "g": np.repeat(rng.integers(0, 40, n // 50), 50),
        "k": np.sort(rng.integers(0, 500, n)),
        "v": rng.random(n),
    }


@pytest.fixture()
def stores():
    """A store-backed table with rle-friendly clustered values, in both
    packages."""
    cols = _store_arrays()
    return (store.Table.from_arrays(cols, chunk_rows=256),
            j_store.Table.from_arrays(cols, chunk_rows=256))


@pytest.fixture()
def small_scope():
    n = 64
    return {"t": {"k": np.arange(n) % 8, "v": np.arange(n, dtype=np.float64)}}


def _odf(frame):
    if isinstance(frame, TensorFrame):
        return orc.frame_to_odf(frame)
    from repro.core import oracle as j_orc

    return j_orc.frame_to_odf(frame)


def _assert_same(out, ref, rtol=1e-9):
    godf, wodf = _odf(out), _odf(ref)
    assert list(godf) == list(wodf)
    orc.assert_odf_equal(godf, wodf, sort=True, rtol=rtol)


def _counts(stats):
    snap = stats.snapshot()
    return {k: snap[k] for k in COUNTS}, snap["errors"], snap["shed"]


def _staged(scope, j_scope, texts, *, session=False):
    """One micro-batch of ``texts`` through each executor; returns both
    futures lists (the executors are closed)."""
    ex = serve.Executor(scope, auto_start=False, device="cpu")
    jex = j_serve.Executor(j_scope, auto_start=False)
    try:
        outs = []
        for e in (ex, jex):
            sub = e.session() if session else e
            futs = [sub.submit(q) for q in texts]
            assert e.drain_once() == len(texts)
            outs.append(futs)
    finally:
        ex.close()
        jex.close()
    return outs


def _assert_batch_matches_jax(futs, j_futs):
    for f, jf in zip(futs, j_futs):
        _assert_same(f.result(timeout=5), jf.result(timeout=5))
    assert _counts(STATS) == _counts(J_STATS)


# ----------------------------------------------------------------------
# executor surface
# ----------------------------------------------------------------------
def test_executor_over_frames_and_store(both, stores):
    t, jt = stores
    f_arr = {"a": np.arange(10), "b": np.arange(10) * 0.5}
    q1 = "SELECT g, SUM(v) AS s FROM t WHERE k < 200 GROUP BY g"
    q2 = "SELECT a, b FROM f WHERE a >= 5"
    with serve.Executor({"t": t, "f": TensorFrame.from_arrays(f_arr, device="cpu")},
                        device="cpu") as ex, \
            j_serve.Executor({"t": jt, "f": JFrame.from_arrays(f_arr)}) as jex:
        for q in (q1, q2):
            out = ex.execute(q)
            assert out.device.type == "cpu"
            _assert_same(out, jex.execute(q))
        _assert_same(ex.execute(q1), sql.execute(q1, {"t": t}, device="cpu"))
    assert (STATS["admitted"], J_STATS["admitted"]) == (3, 2)


def test_executor_wants_the_card_unless_asked(both, stores):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.Executor({"t": stores[0]})


def test_executor_scope_update(both, stores):
    with serve.Executor({"t": stores[0]}, device="cpu") as ex:
        ex.update(u={"x": np.array([1, 2, 3])})
        out = ex.execute("SELECT COUNT(*) AS c FROM u WHERE x > 1")
        assert out.device.type == "cpu"
        assert int(out.column("c")[0]) == 2


def test_executor_bad_query_raises_plan_error(both, stores):
    t, jt = stores
    from repro.resilience import PlanError as JPlanError

    for ex, err in ((serve.Executor({"t": t}, device="cpu"), resilience.PlanError),
                    (j_serve.Executor({"t": jt}), JPlanError)):
        with ex:
            with pytest.raises(err):
                ex.execute("SELECT nope FROM t")
            # the worker survives a failed query
            assert ex.execute("SELECT COUNT(*) AS c FROM t").nrows == 1
    assert STATS.snapshot()["errors"] == J_STATS.snapshot()["errors"] == {"plan_error": 1}


def test_closed_executor_rejects(both, stores):
    ex = serve.Executor({"t": stores[0]}, device="cpu")
    ex.close()
    with pytest.raises(QueryCancelled):
        ex.submit("SELECT COUNT(*) AS c FROM t")


# ----------------------------------------------------------------------
# UDFs
# ----------------------------------------------------------------------
def test_udf_matches_inline_expression_and_jax(both, stores):
    t, jt = stores
    q = "SELECT g, SUM(markup(v, g)) AS s FROM t GROUP BY g"
    with serve.Executor({"t": t}, device="cpu") as ex, j_serve.Executor({"t": jt}) as jex:
        for e in (ex, jex):
            e.add_function("markup", lambda v, g: v * (1.0 + 0.01 * g))
        out = ex.execute(q)
        _assert_same(out, jex.execute(q))
        ref = sql.execute("SELECT g, SUM(v * (1.0 + 0.01 * g)) AS s FROM t GROUP BY g",
                          {"t": t}, device="cpu")
        _assert_same(out, ref)
    assert STATS["udf_queries"] == J_STATS["udf_queries"] == 1


def test_udf_in_where(both, stores):
    t, _ = stores
    with serve.Executor({"t": t}, device="cpu") as ex:
        ex.add_function("hot", lambda k: k < 100, returns="bool")
        out = ex.execute("SELECT COUNT(*) AS c FROM t WHERE hot(k)")
    _assert_same(out, sql.execute("SELECT COUNT(*) AS c FROM t WHERE k < 100", {"t": t},
                                  device="cpu"))


def test_udf_session_isolation(both, stores):
    t, _ = stores
    with serve.Executor({"t": t}, device="cpu") as ex:
        s1, s2 = ex.session(), ex.session()
        s1.add_function("boost", lambda v: v * 2.0)
        s2.add_function("boost", lambda v: v * 3.0)
        o1 = s1.execute("SELECT SUM(boost(v)) AS s FROM t")
        o2 = s2.execute("SELECT SUM(boost(v)) AS s FROM t")
        b = float(sql.execute("SELECT SUM(v) AS s FROM t", {"t": t}, device="cpu").column("s")[0])
        assert float(o1.column("s")[0]) == pytest.approx(2 * b)
        assert float(o2.column("s")[0]) == pytest.approx(3 * b)
        # neither session leaked into the executor scope
        with pytest.raises(resilience.PlanError):
            ex.execute("SELECT SUM(boost(v)) AS s FROM t")


def test_udf_declines_compiled_path(both, stores):
    plan_compile.reset_stats()
    plan_compile.clear_cache()
    both(compiled="force")
    with serve.Executor({"t": stores[0]}, device="cpu") as ex:
        ex.add_function("twice", lambda v: v * 2.0)
        ex.execute("SELECT g, SUM(twice(v)) AS s FROM t GROUP BY g")
    assert plan_compile.STATS["compiles"] == 0
    assert STATS["udf_queries"] == 1


# ----------------------------------------------------------------------
# prepared statements
# ----------------------------------------------------------------------
def test_prepared_rides_plan_cache_as_the_reference(both):
    from repro.sql import compile as j_compile

    rng = np.random.default_rng(3)
    n = 1 << 12
    arr = {"a": rng.integers(0, 16, n), "w": rng.random(n), "b": rng.integers(0, 100, n)}
    template = "SELECT a, SUM(w) AS s FROM t WHERE b > {k} GROUP BY a"
    plan_compile.reset_stats()
    plan_compile.clear_cache()
    j_compile.reset_stats()
    j_compile.clear_cache()
    both(compiled="force")
    ks = (10, 20, 30, 40)
    try:
        with serve.Executor({"t": TensorFrame.from_arrays(arr, device="cpu")},
                            device="cpu") as ex, \
                j_serve.Executor({"t": JFrame.from_arrays(arr)}) as jex:
            outs = [ex.prepare(template).execute(k=k) for k in ks]
            jps = jex.prepare(template)
            j_outs = [jps.execute(k=k) for k in ks]
    finally:
        j_compile.clear_cache()
    for stats in (plan_compile.STATS, j_compile.STATS):
        assert (stats["compiles"], stats["hits"]) == (1, 3)
    assert STATS["prepared"] == 4 and STATS["plan_cache_hits"] == 3
    assert _counts(STATS) == _counts(J_STATS)
    both(compiled="off")
    for k, out, jout in zip(ks, outs, j_outs):
        _assert_same(out, jout)
        _assert_same(out, sql.execute(template.format(k=k),
                                      {"t": TensorFrame.from_arrays(arr, device="cpu")},
                                      device="cpu"))


# ----------------------------------------------------------------------
# micro-batching (deterministic: staged queue, one drain), against JAX
# ----------------------------------------------------------------------
def test_microbatch_shares_store_scans(both, stores):
    texts = [f"SELECT g, SUM(v) AS s FROM t WHERE k < {200 + i} GROUP BY g" for i in range(5)]
    futs, j_futs = _staged({"t": stores[0]}, {"t": stores[1]}, texts)
    _assert_batch_matches_jax(futs, j_futs)
    snap = STATS.snapshot()
    assert (snap["batches"], snap["batched_queries"]) == (1, 5)
    assert (snap["shared_scan_groups"], snap["shared_scan_queries"]) == (1, 5)


def test_microbatch_coalesces_duplicates(both, stores):
    q = "SELECT g, SUM(v) AS s FROM t GROUP BY g"
    futs, j_futs = _staged({"t": stores[0]}, {"t": stores[1]}, [q] * 4, session=True)
    _assert_batch_matches_jax(futs, j_futs)
    assert STATS["coalesced"] == 3
    outs = [f.result() for f in futs]
    assert all(o is outs[0] for o in outs[1:])  # one shared result frame


def test_microbatch_respects_cap(both, stores):
    both(serve_max_batch=3)
    for Ex, t, kw in ((serve.Executor, stores[0], {"device": "cpu"}),
                      (j_serve.Executor, stores[1], {})):
        ex = Ex({"t": t}, auto_start=False, **kw)
        futs = [ex.submit(f"SELECT COUNT(*) AS c FROM t WHERE k < {i}") for i in range(5)]
        assert ex.drain_once() == 3
        assert ex.drain_once() == 2
        assert all(f.result().nrows == 1 for f in futs)
        ex.close()
    assert _counts(STATS) == _counts(J_STATS)


def test_shared_scans_can_be_disabled(both, stores):
    both(serve_shared_scans=False)
    texts = [f"SELECT COUNT(*) AS c FROM t WHERE k < {100 + i}" for i in range(3)]
    futs, j_futs = _staged({"t": stores[0]}, {"t": stores[1]}, texts)
    _assert_batch_matches_jax(futs, j_futs)
    assert STATS["shared_scan_groups"] == 0


def test_shared_scan_failure_falls_back(both, monkeypatch):
    n = 512
    cols = {"a": np.arange(n), "b": np.arange(n) % 7}
    import repro.store as j_store_pkg
    import repro_torch.store as store_pkg

    def broken(*a, **k):
        raise OSError("scan pass down")

    monkeypatch.setattr(store_pkg, "shared_scan", broken)
    monkeypatch.setattr(j_store_pkg, "shared_scan", broken)
    texts = ["SELECT SUM(a) AS s FROM t WHERE b > 2", "SELECT COUNT(*) AS c FROM t WHERE b > 2"]
    futs, j_futs = _staged({"t": store.Table.from_arrays(cols, chunk_rows=128)},
                           {"t": j_store.Table.from_arrays(cols, chunk_rows=128)}, texts)
    _assert_batch_matches_jax(futs, j_futs)
    mask = np.arange(n) % 7 > 2
    assert float(futs[0].result().column("s")[0]) == float(np.arange(n)[mask].sum())
    assert STATS["shared_scan_errors"] == 1
    assert STATS.snapshot()["errors_total"] == 0  # degraded, not failed


@pytest.mark.parametrize("fault", [torch.OutOfMemoryError, KernelError])
def test_shared_scan_device_fault_is_not_degraded(both, monkeypatch, fault):
    """A device out-of-memory or a kernel failure during the shared scan
    reaches every caller as an ``ExecutionError``: no quiet per-query
    scan hides it."""
    import repro_torch.store as store_pkg

    def broken(*a, **k):
        raise fault("the card failed")

    monkeypatch.setattr(store_pkg, "shared_scan", broken)
    cols = {"a": np.arange(512), "b": np.arange(512) % 7}
    ex = serve.Executor({"t": store.Table.from_arrays(cols, chunk_rows=128)},
                        auto_start=False, device="cpu")
    futs = [ex.submit(f"SELECT COUNT(*) AS c FROM t WHERE b > {i}") for i in range(2)]
    ex.drain_once()
    for f in futs:
        with pytest.raises(ExecutionError) as info:
            f.result(timeout=1)
        assert isinstance(info.value.__cause__, fault)
    assert STATS["shared_scan_errors"] == 0
    assert STATS.snapshot()["errors"] == {"execution_error": 2}
    ex.close()


def test_cuda_error_in_execution_is_an_execution_error(both, small_scope):
    with serve.Executor(small_scope, device="cpu") as ex:
        with faults.inject("exec.operator", torch.OutOfMemoryError, limit=1):
            with pytest.raises(ExecutionError):
                ex.execute("SELECT SUM(v) AS s FROM t")
        # no retry elsewhere: the next query runs normally on the same device
        assert ex.execute("SELECT SUM(v) AS s FROM t").device.type == "cpu"
    assert STATS.snapshot()["errors"] == {"execution_error": 1}


# ----------------------------------------------------------------------
# thread safety
# ----------------------------------------------------------------------
def test_compile_cache_thread_safe(both):
    """Concurrent first-compiles and hits against one shared LRU: no
    lost updates, consistent stats, correct results."""
    rng = np.random.default_rng(11)
    n = 1 << 11
    frames = {"t": TensorFrame.from_arrays(
        {"a": rng.integers(0, 8, n), "w": rng.random(n), "b": rng.integers(0, 50, n)},
        device="cpu")}
    text = "SELECT a, SUM(w) AS s FROM t WHERE b > {k} GROUP BY a"
    both(compiled="off")
    refs = {k: sql.execute(text.format(k=k), frames) for k in range(THREADS)}
    plan_compile.reset_stats()
    plan_compile.clear_cache()
    both(compiled="force")

    def work(seed):
        r = random.Random(seed)
        for _ in range(6 * ROUNDS):
            k = r.randrange(THREADS)
            _assert_same(sql.execute(text.format(k=k), frames), refs[k])

    with ThreadPoolExecutor(THREADS) as tp:
        list(tp.map(work, range(THREADS)))
    s = plan_compile.STATS
    # literals parameterize away: exactly one graph, every other call a hit
    assert (s["compiles"], s["fallbacks"], s["misses"]) == (1, 0, 1)
    assert s["hits"] + s["misses"] == THREADS * 6 * ROUNDS


def test_string_pool_thread_safe(both):
    """POOL.intern from many threads: equal dictionaries must resolve
    to one object and the pool must not corrupt its buckets."""
    dicts = [np.array([f"v{j}_{i}" for j in range(20)], dtype=object) for i in range(8)]
    pool = store.StringPool(max_entries=64)
    out: dict = {}
    lock = threading.Lock()

    def work(seed):
        r = random.Random(seed)
        for _ in range(200 * ROUNDS):
            i = r.randrange(len(dicts))
            got = pool.intern(dicts[i].copy())
            with lock:
                prev = out.setdefault(i, got)
            assert prev is got  # same content -> same interned object
            assert list(got) == list(dicts[i])

    with ThreadPoolExecutor(THREADS) as tp:
        list(tp.map(work, range(THREADS)))
    assert len(out) == len(dicts)


# ----------------------------------------------------------------------
# concurrent == serial (TPC-H lineitem as a store)
# ----------------------------------------------------------------------
_TPCH_TEMPLATES = [
    "SELECT l_returnflag, l_linestatus, SUM(l_quantity) AS sum_qty, "
    "COUNT(*) AS cnt FROM lineitem WHERE l_quantity < {q} "
    "GROUP BY l_returnflag, l_linestatus",
    "SELECT SUM(l_extendedprice * l_discount) AS rev FROM lineitem "
    "WHERE l_shipdate >= DATE '1994-01-01' AND l_shipdate < DATE '1995-01-01' "
    "AND l_discount BETWEEN {lo} AND {hi} AND l_quantity < {q}",
    "SELECT l_shipmode, COUNT(*) AS c FROM lineitem "
    "WHERE l_quantity < {q} GROUP BY l_shipmode ORDER BY l_shipmode",
]


def _draw(rng):
    t = rng.randrange(len(_TPCH_TEMPLATES))
    lo = round(0.02 + 0.01 * rng.randrange(5), 2)
    return _TPCH_TEMPLATES[t].format(q=rng.randrange(10, 40), lo=lo, hi=round(lo + 0.02, 2))


@pytest.fixture(scope="module")
def lineitem_scopes(tpch_small):
    tables, _ = tpch_small
    return ({"lineitem": store.Table.from_arrays(tables["lineitem"], chunk_rows=1024)},
            {"lineitem": j_store.Table.from_arrays(tables["lineitem"], chunk_rows=1024)})


def test_concurrent_sessions_match_serial(both, lineitem_scopes):
    """Sessions hammering randomized parameterized TPC-H queries
    concurrently get exactly the serial answers, and the admission
    queue demonstrably micro-batched."""
    scope, _ = lineitem_scopes
    rng = random.Random(1234)
    texts = [_draw(rng) for _ in range(THREADS * 4 * ROUNDS)]
    serial = {q: sql.execute(q, scope, device="cpu") for q in set(texts)}
    with serve.Executor(scope, device="cpu") as ex:
        sessions = [ex.session() for _ in range(THREADS)]

        def work(i):
            return [(q, sessions[i].execute(q)) for q in texts[i::THREADS]]

        with ThreadPoolExecutor(THREADS) as tp:
            results = [p for chunk in tp.map(work, range(THREADS)) for p in chunk]
    assert len(results) == len(texts)
    for q, out in results:
        _assert_same(out, serial[q])
    snap = STATS.snapshot()
    assert snap["admitted"] == len(texts)
    assert snap["errors_total"] == 0
    assert snap["batches"] < snap["admitted"]
    assert snap["batched_queries"] >= 2


def test_randomized_batches_match_jax(both, lineitem_scopes):
    """Randomized staged batches: batched execution (shared scans and
    coalescing on) equals serial execution, and equals the reference's
    batch result for result and counter for counter."""
    scope, j_scope = lineitem_scopes
    for trial in range(2):
        rng = random.Random(100 + trial)
        texts = [_draw(rng) for _ in range(rng.randrange(4, 9))]
        STATS.reset()
        J_STATS.reset()
        futs, j_futs = _staged(scope, j_scope, texts)
        _assert_batch_matches_jax(futs, j_futs)
        for q, f in zip(texts, futs):
            _assert_same(f.result(), sql.execute(q, scope, device="cpu"))
        snap = STATS.snapshot()
        assert snap["batches"] == 1 and snap["batched_queries"] == len(texts)
        assert snap["shared_scan_queries"] + snap["coalesced"] >= 2


# ----------------------------------------------------------------------
# deadlines and cancels
# ----------------------------------------------------------------------
def test_executor_timeout_mid_execution(both, small_scope):
    with serve.Executor(small_scope, device="cpu") as ex:
        with faults.inject("exec.operator", delay_s=0.1):
            with pytest.raises(QueryTimeout):
                ex.execute("SELECT SUM(v) AS s FROM t", timeout_s=0.03)
    assert STATS.snapshot()["errors"] == {"timeout": 1}


def test_executor_default_timeout_config(both, small_scope):
    both(serve_default_timeout_s=0.03)
    with serve.Executor(small_scope, device="cpu") as ex:
        with faults.inject("exec.operator", delay_s=0.1):
            with pytest.raises(QueryTimeout):
                ex.execute("SELECT SUM(v) AS s FROM t")


def test_expired_in_queue_is_shed(both, small_scope):
    ex = serve.Executor(small_scope, auto_start=False, device="cpu")
    fut = ex.submit("SELECT SUM(v) AS s FROM t", timeout_s=0.01)
    time.sleep(0.03)  # expire while queued; nothing is draining
    assert ex.drain_once() == 1
    with pytest.raises(QueryTimeout):
        fut.result(timeout=1)
    snap = STATS.snapshot()
    assert snap["shed"] == {"deadline": 1} and snap["shed_requests"] == 1


def test_cancel_queued_request(both, small_scope):
    ex = serve.Executor(small_scope, auto_start=False, device="cpu")
    fut = ex.submit("SELECT SUM(v) AS s FROM t")
    assert ex.cancel(fut.request_id) is True
    assert ex.cancel(987654) is False  # unknown id
    ex.drain_once()
    with pytest.raises(QueryCancelled):
        fut.result(timeout=1)
    assert STATS.snapshot()["shed"] == {"cancelled": 1}
    assert ex.cancel(fut.request_id) is False  # resolved ids no longer cancel


def test_session_cancel_api(both, small_scope):
    ex = serve.Executor(small_scope, auto_start=False, device="cpu")
    s = ex.session()
    fut = s.submit("SELECT COUNT(*) AS c FROM t")
    assert s.cancel(fut.request_id) is True
    ex.drain_once()
    with pytest.raises(QueryCancelled):
        fut.result(timeout=1)


def test_cancel_mid_flight(both, small_scope):
    """A request cancelled while it executes aborts at its next
    operator checkpoint with ``QueryCancelled``."""
    with serve.Executor(small_scope, device="cpu") as ex:
        started = threading.Event()
        real = ex._run_group

        def run_group(group, frames, scan_cache):
            started.set()
            return real(group, frames, scan_cache)

        ex._run_group = run_group
        with faults.inject("exec.operator", delay_s=0.05):
            fut = ex.submit("SELECT k, SUM(v) AS s FROM t GROUP BY k")
            assert started.wait(10)
            assert ex.cancel(fut.request_id)
            with pytest.raises(QueryCancelled):
                fut.result(timeout=30)
        assert STATS.snapshot()["shed"] == {}  # it executed; it was not shed


def test_timeout_does_not_starve_other_sessions(both, small_scope):
    with serve.Executor(small_scope, device="cpu") as ex:
        s1, s2 = ex.session(), ex.session()
        with faults.inject("exec.operator", delay_s=0.06):
            slow = s1.submit("SELECT SUM(v) AS s FROM t", timeout_s=0.02)
            queued = [s2.submit(f"SELECT COUNT(*) AS c FROM t WHERE k > {i}") for i in range(3)]
            with pytest.raises(QueryTimeout):
                slow.result(timeout=30)
            for i, q in enumerate(queued):
                assert int(q.result(timeout=30).column("c")[0]) == int((np.arange(64) % 8 > i).sum())
    snap = STATS.snapshot()
    assert snap["errors"].get("timeout") == 1 and snap["errors_total"] == 1


def test_coalesced_group_uses_loosest_deadline(both, small_scope):
    ex = serve.Executor(small_scope, auto_start=False, device="cpu")
    impatient = ex.submit("SELECT SUM(v) AS s FROM t", timeout_s=0.01)
    patient = ex.submit("SELECT SUM(v) AS s FROM t")
    time.sleep(0.03)
    ex.drain_once()
    with pytest.raises(QueryTimeout):
        impatient.result(timeout=1)
    assert float(patient.result(timeout=1).column("s")[0]) == float(np.arange(64.0).sum())


def test_cancelled_member_of_coalesced_group(both, small_scope):
    ex = serve.Executor(small_scope, auto_start=False, device="cpu")
    a = ex.submit("SELECT COUNT(*) AS c FROM t")
    b = ex.submit("SELECT COUNT(*) AS c FROM t")
    ex.cancel(a.request_id)
    ex.drain_once()
    with pytest.raises(QueryCancelled):
        a.result(timeout=1)
    assert int(b.result(timeout=1).column("c")[0]) == 64


# ----------------------------------------------------------------------
# admission control, shutdown, crash recovery
# ----------------------------------------------------------------------
def test_queue_depth_reject_new(both, small_scope):
    both(serve_queue_depth=1, serve_shed_policy="reject-new")
    ex = serve.Executor(small_scope, auto_start=False, device="cpu")
    first = ex.submit("SELECT COUNT(*) AS c FROM t")
    with pytest.raises(ResourceExhausted):
        ex.submit("SELECT SUM(v) AS s FROM t")
    ex.drain_once()
    assert first.result(timeout=1).nrows == 1


def test_queue_depth_drop_oldest(both, small_scope):
    both(serve_queue_depth=1, serve_shed_policy="drop-oldest")
    ex = serve.Executor(small_scope, auto_start=False, device="cpu")
    oldest = ex.submit("SELECT COUNT(*) AS c FROM t")
    newest = ex.submit("SELECT SUM(v) AS s FROM t")
    with pytest.raises(ResourceExhausted):
        oldest.result(timeout=1)  # shed to admit the newcomer
    ex.drain_once()
    assert newest.result(timeout=1).nrows == 1
    snap = STATS.snapshot()
    assert snap["shed"] == {"queue_full": 1}
    assert snap["errors"].get("resource_exhausted") == 1


def test_session_inflight_cap(both, small_scope):
    both(serve_session_inflight=2)
    ex = serve.Executor(small_scope, auto_start=False, device="cpu")
    s = ex.session()
    futs = [s.submit("SELECT COUNT(*) AS c FROM t") for _ in range(2)]
    with pytest.raises(ResourceExhausted):
        s.submit("SELECT SUM(v) AS s FROM t")
    other = ex.session().submit("SELECT COUNT(*) AS c FROM t")  # per session
    ex.drain_once()
    for f in futs + [other]:
        assert f.result(timeout=1).nrows == 1
    s.submit("SELECT COUNT(*) AS c FROM t")  # resolution released the budget
    ex.close()


def test_close_drains_pending_with_typed_error(both, small_scope):
    ex = serve.Executor(small_scope, auto_start=False, device="cpu")
    futs = [ex.submit("SELECT COUNT(*) AS c FROM t") for _ in range(3)]
    ex.close()
    for f in futs:
        with pytest.raises(QueryCancelled):
            f.result(timeout=1)
    snap = STATS.snapshot()
    assert snap["shed"] == {"closed": 3} and snap["errors"].get("cancelled") == 3


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_worker_crash_restarts(both, small_scope):
    ex = serve.Executor(small_scope, device="cpu")
    q = ex._queue
    real = q._run_batch
    try:
        q._run_batch = lambda batch: (_ for _ in ()).throw(SystemExit(1))
        crashed = ex.submit("SELECT COUNT(*) AS c FROM t")
        with pytest.raises(QueryError):
            crashed.result(timeout=10)
        deadline = time.monotonic() + 10
        while q._worker.is_alive() and time.monotonic() < deadline:
            time.sleep(0.01)
        assert not q._worker.is_alive()  # SystemExit killed the worker
        q._run_batch = real
        # the next submit finds the dead worker and restarts it
        assert int(ex.execute("SELECT COUNT(*) AS c FROM t").column("c")[0]) == 64
        assert STATS["worker_restarts"] == 1
    finally:
        q._run_batch = real
        ex.close()


# ----------------------------------------------------------------------
# a short chaos storm (after tests/test_chaos.py, a few dozen requests)
# ----------------------------------------------------------------------
_CHAOS_QUERIES = [
    "SELECT g, SUM(v) AS s, COUNT(*) AS c FROM t WHERE f > {q} GROUP BY g",
    "SELECT SUM(v * f) AS sv FROM t WHERE g < {g}",
    "SELECT g, MIN(v) AS lo, MAX(v) AS hi FROM t GROUP BY g",
    "SELECT g, SUM(v) AS s FROM m WHERE f > {q} GROUP BY g",
    "SELECT COUNT(*) AS c FROM m WHERE g >= {g}",
]


def _chaos_arrays(n):
    rng = np.random.default_rng(99)
    return {"g": rng.integers(0, 8, n), "f": rng.integers(0, 10, n),
            "v": np.round(rng.standard_normal(n) * 100).astype(np.int64)}


def test_chaos_storm_correct_or_typed(both):
    """8 threads, seeded queries, faults at the spill, compile and store
    boundaries: every request resolves to the clean answer or a typed
    ``QueryError``, never a hang or a wrong result."""
    seed = 7
    scope = {"t": store.Table.from_arrays(_chaos_arrays(8_000), chunk_rows=1024),
             "m": TensorFrame.from_arrays(_chaos_arrays(2_000), device="cpu")}
    rng = random.Random(seed)
    texts = sorted({_CHAOS_QUERIES[rng.randrange(len(_CHAOS_QUERIES))].format(
        q=rng.randrange(2, 9), g=rng.randrange(1, 7)) for _ in range(16)})
    assert any(" m " in q for q in texts) and any(" t " in q for q in texts)
    clean = {q: sql.execute(q, scope, device="cpu") for q in texts}
    # store scans stream out of core and every partial spills; frame
    # scans take the compiled path; shared scans off so the streams run
    both(out_of_core="auto", ooc_min_rows=1, memory_budget_bytes=1, compiled="force",
         io_retry_base_s=1e-4, serve_shared_scans=False)
    outcomes = []
    lock = threading.Lock()
    with serve.Executor(scope, device="cpu") as ex, \
            faults.inject("spill.write", OSError, rate=0.3, seed=seed), \
            faults.inject("compile", RuntimeError, rate=1.0, seed=seed + 1), \
            faults.inject("store.read", OSError, rate=0.02, seed=seed + 2):
        sessions = [ex.session() for _ in range(8)]

        def work(i):
            r = random.Random(seed * 1000 + i)
            mine = list(texts[i::8]) + [texts[r.randrange(len(texts))] for _ in range(3)]
            got = []
            for q in mine:
                try:
                    got.append((q, sessions[i].execute(q, timeout_s=60), None))
                except QueryError as e:
                    got.append((q, None, e))
            with lock:
                outcomes.extend(got)

        threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive(), "chaos worker hung"
    assert len(outcomes) == len(texts) + 8 * 3
    errs = 0
    for q, out, err in outcomes:
        if err is not None:
            errs += 1
            continue
        _assert_same(out, clean[q])  # any result must be the clean one
    hit = faults.sites_hit()
    assert hit.get("compile", 0) >= 1 and hit.get("spill.write", 0) >= 1
    snap = STATS.snapshot()
    assert snap["admitted"] == len(outcomes)
    assert snap["errors_total"] == errs
    assert plan_compile.STATS["compile_failures"] >= 1
    assert plan_compile.STATS["compiles"] == 0
