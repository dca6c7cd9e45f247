"""The port's loaders (``repro_torch.core.io``), observability
(``repro_torch.obs``), resilience layer (``repro_torch.resilience``),
spill manager (``repro_torch.store.spill``) and row-at-a-time oracle
(``repro_torch.core.oracle``) on the CPU, each held to the JAX package's
for the same calls on the same inputs (made from a seed with numpy).

The CSV tests of tests/test_io.py, the tracer, metrics and export tests
of tests/test_obs.py, and the errors, faults, retry, deadline and
spill-only tests of tests/test_resilience.py run on the port as well.
"""
import importlib
import json
import threading
import time

import numpy as np
import pytest

import jax

from repro import obs as j_obs
from repro import resilience as j_res
from repro.core import TensorFrame as JFrame
from repro.core import io as j_io
from repro.core import oracle as j_orc
from repro.core.config import CONFIG as J_CONFIG
from repro_torch import obs
from repro_torch import resilience as res
from repro_torch.core import TensorFrame
from repro_torch.core import io as tio
from repro_torch.core import oracle as orc
from repro_torch.core.config import CONFIG
from repro_torch.obs import metrics
from repro_torch.resilience import (
    ExecutionError,
    PlanError,
    QueryCancelled,
    QueryError,
    QueryTimeout,
    ResourceExhausted,
    TransientIOError,
    checkpoint,
    classify,
    deadline_scope,
    faults,
    retry,
)
from repro_torch.store import spill as spill_mod
from repro_torch.store.spill import SPILL

t_join = importlib.import_module("repro_torch.core.join")


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
    faults.clear()
    yield
    faults.clear()


@pytest.fixture()
def tracing_on():
    saved, jsaved = CONFIG.tracing, J_CONFIG.tracing
    CONFIG.tracing = J_CONFIG.tracing = "on"
    obs.clear_trace()
    j_obs.clear_trace()
    try:
        yield
    finally:
        CONFIG.tracing, J_CONFIG.tracing = saved, jsaved


def _write(tmp_path, text, name="t.csv"):
    p = str(tmp_path / name)
    with open(p, "w") as f:
        f.write(text)
    return p


def _same_arrays(a, b):
    assert list(a) == list(b)
    for k in b:
        assert a[k].dtype == b[k].dtype, k
        if a[k].dtype.kind == "f":
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k].tolist() == b[k].tolist(), k


# ----------------------------------------------------------------------
# CSV: the reference's arrays and frames
# ----------------------------------------------------------------------
_CSV_CASES = {
    "sniffed": ("a|b|c|d|s\n1|2.5|1994-01-01|x|001\n2||1995-06-01|y|002\n3|4|None|z|010\n", None),
    "hinted": ("a|b|c|d|s\n1|2.5|1994-01-01|x|001\n2||1995-06-01|y|002\n3|4|None|z|010\n",
               {"a": "float", "b": "float", "c": "date", "s": "str"}),
    "nulls": ("x|y\nNone|NULL\nnan|\nNaN|7\n", {"y": "int"}),
    "words": ("s|t\nNone|hello\nworld|NaN\n", None),
}


@pytest.mark.parametrize("case", sorted(_CSV_CASES))
def test_read_csv_matches_reference(tmp_path, case):
    text, hints = _CSV_CASES[case]
    p = _write(tmp_path, text)
    _same_arrays(tio.read_csv_arrays(p, dtypes=hints), j_io.read_csv_arrays(p, dtypes=hints))
    got, want = tio.read_csv(p, dtypes=hints, device="cpu"), j_io.read_csv(p, dtypes=hints)
    assert list(got.columns) == list(want.columns)  # __v__ validity columns too
    assert got.device.type == "cpu"
    j_orc.assert_odf_equal(orc.frame_to_odf(got), j_orc.frame_to_odf(want), sort=False)


def test_csv_round_trip_matches_reference(tmp_path):
    rng = np.random.default_rng(3)
    n = 200
    data = {
        "k": rng.integers(0, 1000, n),
        "v": np.round(rng.uniform(-5, 5, n), 4),
        "d": np.datetime64("1995-01-01", "D") + rng.integers(0, 300, n).astype("timedelta64[D]"),
        "s": np.array(["ab", "cd", "ef"], dtype=object)[rng.integers(0, 3, n)],
    }
    tio.write_csv(str(tmp_path / "port.csv"), data)
    j_io.write_csv(str(tmp_path / "ref.csv"), data)
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "ref.csv").read_bytes()
    back = tio.read_csv_arrays(str(tmp_path / "port.csv"))
    _same_arrays(back, j_io.read_csv_arrays(str(tmp_path / "ref.csv")))
    np.testing.assert_array_equal(back["d"], data["d"])
    np.testing.assert_array_equal(back["v"], data["v"])


def test_str_hint_beats_numeric_sniffing(tmp_path):
    p = _write(tmp_path, "code\n001\n002\n010\n")
    assert list(tio.read_csv_arrays(p, sep=",", dtypes={"code": "str"})["code"]) == ["001", "002", "010"]


def test_float_hint_beats_int_sniffing(tmp_path):
    p = _write(tmp_path, "x\n1\n2\n3\n")
    out = tio.read_csv_arrays(p, sep=",", dtypes={"x": "float"})
    assert out["x"].dtype == np.float64
    np.testing.assert_array_equal(out["x"], [1.0, 2.0, 3.0])
    assert tio.read_csv_arrays(p, sep=",")["x"].dtype == np.int64


def test_unknown_hint_raises_and_int_hint_rejects_malformed(tmp_path):
    p = _write(tmp_path, "x\n1\n")
    with pytest.raises(ValueError, match="int32"):
        tio.read_csv_arrays(p, sep=",", dtypes={"x": "int32"})
    p = _write(tmp_path, "x\n1\n2.5\n", "u.csv")
    with pytest.raises(ValueError):
        tio.read_csv_arrays(p, sep=",", dtypes={"x": "int"})


def test_null_tokens_promote_int_to_float_nan(tmp_path):
    p = _write(tmp_path, "a|b\n1|\n2|3\n")
    out = tio.read_csv_arrays(p)
    assert out["a"].dtype == np.int64 and out["b"].dtype == np.float64
    assert np.isnan(out["b"][0]) and out["b"][1] == 3.0
    out = tio.read_csv_arrays(p, dtypes={"b": "int"})
    assert out["b"].dtype == np.float64 and np.isnan(out["b"][0])


def test_date_nulls_parse_as_nat_and_carry_validity(tmp_path):
    p = _write(tmp_path, "d\n1994-01-01\nNone\n1995-06-01\n")
    out = tio.read_csv_arrays(p, sep=",", dtypes={"d": "date"})
    assert np.isnat(out["d"][1]) and out["d"][0] == np.datetime64("1994-01-01")
    f = tio.read_csv(p, sep=",", dtypes={"d": "date"}, device="cpu")
    assert f.valid_array("d").tolist() == [True, False, True]


def test_all_null_column_round_trips_through_io(tmp_path):
    left = TensorFrame.from_arrays(
        {"k": np.array(["a", "b", "c"], dtype=object), "v": np.array([1.0, 2.0, 3.0])}, device="cpu")
    right = TensorFrame.from_arrays(
        {"k": np.array(["x", "y"], dtype=object), "w": np.array([10.0, 20.0])}, device="cpu")
    joined = left.join(right, on="k", how="left")
    p = str(tmp_path / "j.csv")
    tio.write_csv(p, {n: joined.column(n) for n in ("k", "v", "w")})
    back = tio.read_csv(p, device="cpu")
    w = back.column("w")
    assert w.dtype == np.float64 and np.isnan(w.astype(float)).all()
    agg = back.groupby("k").agg([("n", "count", "w"), ("s", "sum", "w")])
    assert list(agg.column("n")) == [0, 0, 0]
    assert list(agg.column("s")) == [0.0, 0.0, 0.0]


def test_string_columns_keep_null_tokens_verbatim(tmp_path):
    p = _write(tmp_path, "s\nNone\nhello\n")
    assert list(tio.read_csv_arrays(p, sep=",", dtypes={"s": "str"})["s"]) == ["None", "hello"]
    assert list(tio.read_csv_arrays(p, sep=",")["s"]) == ["None", "hello"]


def test_loaders_need_a_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    import torch

    p = _write(tmp_path, "x\n1\n")
    tio.write_tfb(str(tmp_path / "t"), {"x": np.arange(3)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tio.read_csv(p)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tio.read_tfb(str(tmp_path / "t"))


# ----------------------------------------------------------------------
# oracle: the reference's outputs for the same calls
# ----------------------------------------------------------------------
def _oracle_data(n=60, seed=2):
    rng = np.random.default_rng(seed)
    return {
        "k": rng.integers(0, 6, n),
        "g": np.array(["u", "v", "w"], dtype=object)[rng.integers(0, 3, n)],
        "x": np.round(rng.uniform(-3, 3, n), 3),
        "d": np.datetime64("1990-01-01", "D") + rng.integers(0, 40, n).astype("timedelta64[D]"),
        "b": rng.integers(0, 2, n).astype(bool),
    }


def test_oracle_matches_reference():
    data = _oracle_data()
    a, b = orc.from_numpy(data), j_orc.from_numpy(data)
    assert a == b
    mask = [x > 0 for x in a["x"]]
    assert orc.o_filter(a, mask) == j_orc.o_filter(b, mask)
    assert orc.o_take(a, [5, 1, 1, 0]) == j_orc.o_take(b, [5, 1, 1, 0])
    specs = [("s", "sum", "x"), ("m", "mean", "x"), ("n", "size", ""), ("c", "count", "x"),
             ("u", "nunique", "g"), ("lo", "min", "x"), ("hi", "max", "d"), ("f", "first", "g")]
    assert orc.o_groupby(a, ["k", "g"], specs) == j_orc.o_groupby(b, ["k", "g"], specs)
    right = orc.from_numpy({"k": np.arange(4), "w": np.arange(4) * 1.5, "g": np.array(list("uvvz"), dtype=object)})
    for how in ("inner", "left", "semi", "anti"):
        assert orc.o_join(a, right, ["k"], ["k"], how) == j_orc.o_join(b, right, ["k"], ["k"], how), how
    by, asc = ["g", "x", "k"], [False, True, True]
    assert orc.o_sort(a, by, asc) == j_orc.o_sort(b, by, asc)
    assert orc.records(a) == j_orc.records(b)
    orc.assert_odf_equal(a, orc.o_sort(a, by, asc))
    with pytest.raises(AssertionError):
        orc.assert_odf_equal(a, orc.o_filter(a, mask))


def test_frame_to_odf_matches_reference_over_frames_with_nulls():
    data = _oracle_data()
    dim = {"k": np.arange(3), "w": np.array([1.5, -2.0, 4.25]), "h": np.array(list("pqr"), dtype=object)}
    got = TensorFrame.from_arrays(data, device="cpu").join(
        TensorFrame.from_arrays(dim, device="cpu"), on="k", how="left")
    want = JFrame.from_arrays(data).join(JFrame.from_arrays(dim), on="k", how="left")
    a, b = orc.frame_to_odf(got), j_orc.frame_to_odf(want)
    assert a == b
    assert any(v is None for v in a["w"]) and any(v is None for v in a["h"])


# ----------------------------------------------------------------------
# span tracer
# ----------------------------------------------------------------------
def test_disabled_tracing_is_noop():
    assert CONFIG.tracing == "off"
    assert not obs.enabled()
    assert obs.span("a") is obs.span("b", rows=1)  # one shared sentinel
    with obs.span("outer") as sp:
        sp.set(rows=5)
        assert obs.current_span_id() == 0
    assert obs.spans() == []


def test_span_nesting_and_attrs(tracing_on):
    with obs.span("outer", depth=0):
        with obs.span("inner") as sp:
            sp.set(rows=7)
            obs.annotate(tag="x")
    recs = obs.spans()
    assert [r.name for r in recs] == ["outer", "inner"]
    by_name = {r.name: r for r in recs}
    inner, outer = by_name["inner"], by_name["outer"]
    assert inner.parent_id == outer.span_id and outer.parent_id == 0
    assert inner.attrs == {"rows": 7, "tag": "x"} and outer.attrs == {"depth": 0}
    assert 0 < inner.dur_ns <= outer.dur_ns and outer.start_ns <= inner.start_ns


def test_detailed_span_gated_and_since_mark(tracing_on):
    with obs.detailed_span("chunk"):
        pass
    assert obs.spans() == []
    CONFIG.tracing = "detailed"
    with obs.detailed_span("chunk"):
        pass
    mark = obs.mark_ns()
    with obs.span("after"):
        pass
    assert [r.name for r in obs.spans()] == ["chunk", "after"]
    assert [r.name for r in obs.spans(since_ns=mark)] == ["after"]


def _span_tree(records):
    """(name, attrs, parent name) per span, in start order."""
    names = {r.span_id: r.name for r in records}
    return [(r.name, r.attrs, names.get(r.parent_id)) for r in records]


@pytest.mark.parametrize("how,algorithm", [("inner", "auto"), ("left", "sorted"),
                                           ("inner", "sortmerge"), ("anti", "auto")])
def test_traced_join_records_the_reference_span_tree(tracing_on, how, algorithm):
    rng = np.random.default_rng(4)
    fact = {"fk": rng.integers(0, 40, 200), "x": rng.normal(size=200)}
    dim = {"pk": np.arange(30), "w": rng.normal(size=30)}
    trees = []
    for Frame, o, kw in ((TensorFrame, obs, {"device": "cpu"}), (JFrame, j_obs, {})):
        f, d = Frame.from_arrays(fact, **kw), Frame.from_arrays(dim, **kw)
        with o.span("query", label="q"):
            f.join(d, left_on="fk", right_on="pk", how=how, algorithm=algorithm)
            f.join(f, on="fk", how="semi")
        trees.append(_span_tree(o.spans()))
    assert trees[0] == trees[1]
    assert [t[0] for t in trees[0]] == ["query", "core.join", "core.join"]
    ops_ = obs.aggregate_operators(obs.spans())
    assert ops_["core.join"]["count"] == 2


def test_join_spans_cost_nothing_when_off():
    f = TensorFrame.from_arrays({"k": np.arange(10)}, device="cpu")
    f.join(f, on="k")
    assert obs.spans() == []


# ----------------------------------------------------------------------
# metrics registry
# ----------------------------------------------------------------------
def test_counter_gauge_histogram_snapshot_diff_reset():
    c, g, h = metrics.counter("t.count"), metrics.gauge("t.gauge"), metrics.histogram("t.hist")
    jc, jg, jh = (j_obs.metrics.counter("t.count"), j_obs.metrics.gauge("t.gauge"),
                  j_obs.metrics.histogram("t.hist"))
    for cc, gg, hh in ((c, g, h), (jc, jg, jh)):
        cc.inc()
        cc.inc(2)
        gg.set(42)
        for v in (1.0, 2.0, 3.0, 4.0, 10.0):
            hh.observe(v)
    snap = metrics.snapshot()

    # this test's metrics: a registry also holds the ones earlier tests of
    # the process registered (tests/test_obs.py's "race.count" in the
    # reference's)
    def own(s):
        return {name: s["obs"][name] for name in ("t.count", "t.gauge", "t.hist")}

    assert own(snap) == own(j_obs.metrics.snapshot())
    assert snap["obs"]["t.count"] == 3 and snap["obs"]["t.gauge"] == 42
    assert snap["obs"]["t.hist"]["count"] == 5 and snap["obs"]["t.hist"]["max"] == 10.0
    before = metrics.snapshot()
    c.inc(5)
    d = metrics.diff(before, metrics.snapshot())
    assert d["obs"]["t.count"] == 5 and "t.gauge" not in d.get("obs", {})
    assert d == j_obs.metrics.diff(before, metrics.snapshot())
    metrics.reset()
    assert metrics.snapshot()["obs"]["t.count"] == 0
    with pytest.raises(TypeError):
        metrics.gauge("t.count")


def test_engine_groups_registered_and_share_state():
    assert set(metrics.load_engine_groups()) >= {
        "core.join", "sql.compile", "store.pool", "store.spill", "resilience"}
    t_join.STATS["stats_unique_hits"] += 3
    assert metrics.snapshot()["core.join"]["stats_unique_hits"] == 3
    metrics.reset()
    assert t_join.STATS["stats_unique_hits"] == 0


def test_join_populates_the_join_group():
    rng = np.random.default_rng(0)
    t = TensorFrame.from_arrays({"k": rng.integers(0, 50, 300), "v": rng.normal(size=300)}, device="cpu")
    d = TensorFrame.from_arrays({"k": np.arange(50), "w": rng.normal(size=50)}, device="cpu")
    before = metrics.snapshot()
    t.join(d, on="k")
    delta = metrics.diff(before, metrics.snapshot()).get("core.join", {})
    assert delta == {"uniqueness_sort_tests": 1}


def test_registry_and_rings_race_free(tracing_on):
    N_THREADS, N_ITER = 8, 400
    c = metrics.counter("race.count")
    errs = []
    barrier = threading.Barrier(N_THREADS)

    def work(tid):
        try:
            barrier.wait(timeout=30)
            for _ in range(N_ITER):
                c.inc()
                with obs.span("outer", tid=tid):
                    with obs.span("inner"):
                        pass
        except Exception as e:  # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(N_THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert not errs and c.value == N_THREADS * N_ITER
    recs = obs.spans()
    assert obs.dropped() == 0 and len(recs) == N_THREADS * N_ITER * 2
    by_thread = {}
    for r in recs:
        by_thread.setdefault(r.tid, []).append(r)
    assert len(by_thread) == N_THREADS
    for rs in by_thread.values():
        ids = {r.span_id: r for r in rs}
        for r in (r for r in rs if r.name == "inner"):
            assert ids[r.parent_id].name == "outer" and ids[r.parent_id].tid == r.tid


# ----------------------------------------------------------------------
# exporters
# ----------------------------------------------------------------------
def test_chrome_trace_schema(tracing_on, tmp_path):
    with obs.span("parent", rows=3, obj=object()):
        with obs.span("child"):
            pass
    out = tmp_path / "trace.json"
    n = obs.export_chrome_trace(str(out))
    doc = json.loads(out.read_text())
    assert set(doc) == {"traceEvents", "displayTimeUnit"}
    evs = doc["traceEvents"]
    assert n == len(evs)
    xs = [e for e in evs if e["ph"] == "X"]
    metas = [e for e in evs if e["ph"] == "M"]
    assert {e["name"] for e in xs} == {"parent", "child"}
    assert metas and metas[0]["name"] == "thread_name"
    parent = next(e for e in xs if e["name"] == "parent")
    assert parent["args"]["rows"] == 3 and parent["args"]["obj"].startswith("<object")


def test_export_json_operators_match_reference_aggregation(tracing_on):
    with obs.span("op.a"):
        with obs.span("op.b"):
            pass
    doc = obs.export_json()
    assert doc["schema"] == "repro-obs/v1" and doc["spans_recorded"] == 2
    ops_ = doc["operators"]
    assert ops_["op.a"]["count"] == 1 and ops_["op.a"]["self_ms"] <= ops_["op.a"]["total_ms"]
    assert "metrics" in doc
    recs = obs.spans()
    assert obs.aggregate_operators(recs) == j_obs.aggregate_operators(recs)


# ----------------------------------------------------------------------
# errors, faults, retry, deadlines
# ----------------------------------------------------------------------
def test_classify_mapping_matches_reference():
    class SqlError(Exception):
        pass

    cases = [(SqlError("boom"), "execute"), (OSError("disk"), "execute"), (EOFError(), "execute"),
             (MemoryError(), "execute"), (RuntimeError("RESOURCE_EXHAUSTED: oom"), "execute"),
             (ValueError("x"), "execute"), (ValueError("x"), "plan")]
    for exc, phase in cases:
        a, b = classify(exc, phase), j_res.classify(exc, phase)
        assert (type(a).__name__, a.code, a.retryable, str(a)) == (
            type(b).__name__, b.code, b.retryable, str(b))
        assert a.__cause__ is exc
    assert isinstance(classify(SqlError("boom")), PlanError)
    assert isinstance(classify(OSError("disk")), TransientIOError)
    assert isinstance(classify(MemoryError()), ResourceExhausted)
    assert isinstance(classify(ValueError("x")), ExecutionError)
    orig = QueryTimeout("late")
    assert classify(orig) is orig
    for cls in (QueryTimeout, QueryCancelled, PlanError):
        assert issubclass(cls, QueryError)
    assert QueryCancelled.code == "cancelled" and TransientIOError.retryable


def test_fault_injection_fires_the_reference_subsequence():
    def run(fm, seed):
        fired = []
        with fm.inject("x", OSError, rate=0.5, seed=seed):
            for i in range(40):
                try:
                    fm.fault_point("x")
                except OSError:
                    fired.append(i)
        return fired

    a = run(faults, 7)
    assert a and a == run(faults, 7) == run(j_res.faults, 7)
    assert run(faults, 8) != a
    j_res.faults.reset_stats()


def test_fault_injection_limit_delay_and_metrics():
    with faults.inject("y", ValueError, limit=2) as rule:
        hits = 0
        for _ in range(5):
            try:
                faults.fault_point("y")
            except ValueError:
                hits += 1
        assert hits == 2 and rule.triggered == 2 and rule.hits == 5
    faults.fault_point("y")  # disarmed: no raise
    with faults.inject("z", delay_s=0.05):
        t0 = time.perf_counter()
        faults.fault_point("z")
        assert time.perf_counter() - t0 >= 0.04
    assert faults.sites_hit() == {"y": 2, "z": 1}
    assert metrics.snapshot()["resilience"]["faults"] == {"injected": {"y": 2}, "delayed": {"z": 1}}


def test_retry_recovers_gives_up_and_passes_semantic_errors():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] <= 2:
            raise OSError("transient")
        return "ok"

    assert retry.call(flaky, site="test", base_s=1e-4) == "ok"
    assert calls["n"] == 3 and retry.STATS["retries"] == 2
    with pytest.raises(OSError):
        retry.call(lambda: (_ for _ in ()).throw(OSError("always")), retries=2, base_s=1e-4)
    assert retry.STATS["giveups"] == 1
    calls["n"] = 0

    def bad():
        calls["n"] += 1
        raise ValueError("semantic")

    with pytest.raises(ValueError):
        retry.call(bad, base_s=1e-4)
    assert calls["n"] == 1
    snap = metrics.snapshot()["resilience"]
    assert (snap["retries"], snap["retry_giveups"]) == (4, 1)


def test_retry_reads_its_budget_from_the_config(monkeypatch):
    monkeypatch.setattr(CONFIG, "io_retries", 1)
    monkeypatch.setattr(CONFIG, "io_retry_base_s", 1e-4)
    calls = {"n": 0}

    def always():
        calls["n"] += 1
        raise OSError("x")

    with pytest.raises(OSError):
        retry.call(always)
    assert calls["n"] == 2


def test_deadline_scope_timeout_and_cancel():
    checkpoint("anywhere")  # no scope: free and silent
    with deadline_scope(timeout_s=0.01):
        checkpoint("early")
        time.sleep(0.03)
        with pytest.raises(QueryTimeout):
            checkpoint("late")
    with deadline_scope(timeout_s=None) as d:
        checkpoint("unbounded")
        assert d.remaining() is None
        d.token.cancel()
        with pytest.raises(QueryCancelled):
            checkpoint("after-cancel")
    assert res.current() is None


# ----------------------------------------------------------------------
# spill: write failures, retries, corrupt blocks
# ----------------------------------------------------------------------
def _block(seed, n=2000):
    rng = np.random.default_rng(seed)
    return {"g": rng.integers(0, 10, n), "x": rng.standard_normal(n)}


def _spill_out(handle):
    wrote = handle._do_spill()
    assert handle.spilled
    return wrote


def test_spill_round_trip_under_budget(monkeypatch, tmp_path):
    monkeypatch.setattr(CONFIG, "memory_budget_bytes", 1)
    monkeypatch.setattr(CONFIG, "spill_dir", str(tmp_path / "spill"))
    b1, b2 = _block(1), _block(2)
    h1, h2 = SPILL.register(dict(b1)), SPILL.register(dict(b2))  # h1 evicted
    try:
        assert h1.spilled and SPILL.counters["evictions"] >= 1
        assert h1._path.startswith(str(tmp_path / "spill"))
        data1, _ = h1.get()
        np.testing.assert_array_equal(data1["x"], b1["x"])
        assert SPILL.counters["bytes_reread"] > 0
        assert metrics.snapshot()["store.spill"]["bytes_spilled"] > 0
    finally:
        h1.release()
        h2.release()


def test_spill_write_failure_retains_in_memory(monkeypatch):
    monkeypatch.setattr(CONFIG, "memory_budget_bytes", 1)
    monkeypatch.setattr(CONFIG, "io_retry_base_s", 1e-4)
    b1, b2 = _block(1), _block(2)
    with faults.inject("spill.write", OSError, rate=1.0):
        h1 = SPILL.register(dict(b1))
        h2 = SPILL.register(dict(b2))  # tries (and fails) to evict h1
        data1, _ = h1.get()
        data2, _ = h2.get()
    try:
        np.testing.assert_array_equal(data1["x"], b1["x"])
        np.testing.assert_array_equal(data2["x"], b2["x"])
        assert SPILL.counters["write_failures"] >= 1
        assert SPILL.counters["retained_bytes"] > 0
        assert retry.STATS["giveups"] >= 1
    finally:
        h1.release()
        h2.release()


def test_spill_write_retry_recovers(monkeypatch):
    monkeypatch.setattr(CONFIG, "memory_budget_bytes", 1)
    monkeypatch.setattr(CONFIG, "io_retry_base_s", 1e-4)
    b1, b2 = _block(3), _block(4)
    with faults.inject("spill.write", OSError, limit=1):
        h1 = SPILL.register(dict(b1))
        h2 = SPILL.register(dict(b2))
    try:
        assert SPILL.counters["write_failures"] == 0
        assert retry.STATS["retries"] >= 1
        data1, _ = h1.get()
        np.testing.assert_array_equal(data1["g"], b1["g"])
    finally:
        h1.release()
        h2.release()


def test_corrupt_spill_block_recomputes(monkeypatch):
    monkeypatch.setattr(CONFIG, "io_retry_base_s", 1e-4)
    src = _block(5)
    h = SPILL.register(dict(src), recompute=lambda: (dict(src), {}))
    try:
        _spill_out(h)
        with open(f"{h._path}/manifest.json", "w") as f:
            f.write("{")
        data, _ = h.get()
        np.testing.assert_array_equal(data["x"], src["x"])
        assert SPILL.counters["corrupt_blocks"] == 1 and SPILL.counters["recomputes"] == 1
        assert h._path is None
    finally:
        h.release()


def test_truncated_spill_block_detected(monkeypatch):
    monkeypatch.setattr(CONFIG, "io_retry_base_s", 1e-4)
    src = _block(6)
    h = SPILL.register(dict(src))
    try:
        _spill_out(h)
        from repro_torch.store import format as storefmt

        storefmt.write_arrays(h._path, {k: v[: len(v) // 2] for k, v in src.items()}, chunk_rows=1024)
        with pytest.raises(TransientIOError):
            h.get()
        assert SPILL.counters["corrupt_blocks"] == 1
    finally:
        h.release()


def test_spill_delete_failure_counted(monkeypatch):
    def broken_rmtree(path, ignore_errors=False):
        if not ignore_errors:
            raise OSError("EBUSY")

    monkeypatch.setattr(spill_mod.shutil, "rmtree", broken_rmtree)
    before = SPILL.counters["delete_failures"]
    spill_mod._delete_dir(spill_mod._process_spill_root())  # must not raise
    assert SPILL.counters["delete_failures"] == before + 1


def test_store_read_retries_through_transient_faults(tmp_path, monkeypatch):
    monkeypatch.setattr(CONFIG, "io_retry_base_s", 1e-4)
    from repro_torch.store import format as storefmt

    src = {"a": np.arange(500), "b": (np.arange(500) % 3).astype(np.int64)}
    path = str(tmp_path / "t.tfb")
    storefmt.write_arrays(path, src, chunk_rows=128)
    with faults.inject("store.read", OSError, limit=2):
        got = storefmt.open_store(path).to_arrays()
    np.testing.assert_array_equal(got["a"], src["a"])
    np.testing.assert_array_equal(got["b"], src["b"])
    assert faults.sites_hit().get("store.read") == 2
    assert retry.STATS["retries"] >= 2
