"""The harness's own check, driven through a whole run on the CPU at a
small scale (the look for a card skipped), with the timed path broken
underneath: ``correct`` has to come out false for each fault a query
cell can have (an answer altered where it is produced, half of its rows
left out, a query that never answers).  A sound run checks one execution
of every query of the mix."""
import json
from pathlib import Path

import numpy as np
import pytest

from portbench import run as harness
from portbench.datasets import tpch as tpch_gen
from portbench.reference.tpch import Reference

SEED = 2 ** 31 + 101
SCALE = 0.01
CELL = "tpch-sf1.compiled"
HERE = Path(__file__).resolve().parents[1]
LIMIT = json.loads((HERE / "configs" / "tpch-sf1.json").read_text())["limits"]["rel_err"]
MIX = json.loads((HERE / "workloads" / f"{CELL}.json").read_text())["queries"]


def cpu_run(hook=None, per_query=None, trace=0):
    argv = ["--workload", CELL, "--seed", str(SEED), "--seconds", "3", "--trace", str(trace)]
    return harness.run(argv, device="cpu", scale=SCALE, client_hook=hook, per_query=per_query)


def altered(run):
    def go(name, params):
        out = {k: np.array(v, copy=True) for k, v in run(name, params).items()}
        for k, v in out.items():
            if len(v) and v.dtype.kind == "f":
                v[0] *= 1 + 1e-6
                return out
        for k, v in out.items():
            if len(v) and v.dtype.kind in "iu":
                v[0] += 1
                return out
        return out
    return go


def half_left_out(run):
    def go(name, params):
        out = run(name, params)
        n = len(next(iter(out.values())))
        return {k: np.asarray(v)[: n // 2] for k, v in out.items()}
    return go


def never_answers(run):
    """Set-up's warm-up rounds (at most 2 x 22 queries) answer, the
    window's queries do not."""
    calls = []

    def go(name, params):
        calls.append(name)
        if len(calls) > 44:
            raise RuntimeError("no answer")
        return run(name, params)
    return go


def checks(result):
    return {k: v["value"] for k, v in result["checks"].items()}


@pytest.fixture(scope="module")
def sound():
    per_query = []
    return cpu_run(per_query=per_query), per_query


def test_a_sound_run_checks_every_query(sound):
    r, per_query = sound
    assert r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {"setup_s", "queries_per_s", "query_ms_p95"}
    assert list(r["checks"])[-1] == "rel_err"
    c = checks(r)
    assert c["unchecked_queries"] == 0 and c["rel_err"] <= LIMIT
    assert sorted(q["query"] for q in per_query) == sorted(MIX)
    # at SF 0.01 only the known empty-SUM difference (PERF.md, Open
    # questions) may differ: SQL's NULL, where the port gives 0.0
    ref = Reference(tpch_gen.generate(SCALE, SEED))
    for q in per_query:
        if q["rows"]:
            (_, want), = ref.run(q["query"], q["params"]).items()
            assert len(want) == 1 and np.isnan(want[0]), q
    assert r["correct"] is (c["rows_that_differ"] == 0)


def test_a_traced_run_reports_its_layers():
    """Without a card the device-trace metrics are left out; the others,
    the compiled layer's through its reader's recorder, are there."""
    r = cpu_run(trace=1)
    assert set(r["metrics"]) == {"setup.load_s", "setup.capture_s", "compiled.hit_pct"}
    assert 0 <= r["metrics"]["compiled.hit_pct"]["value"] <= 100
    assert r["metrics"]["setup.load_s"]["value"] > 0


@pytest.mark.parametrize("fault", [altered, half_left_out, never_answers])
def test_each_fault_makes_the_run_incorrect(sound, fault):
    r = cpu_run(fault)
    assert r["correct"] is False
    got, base = checks(r), checks(sound[0])
    if fault is never_answers:
        assert got["failed_queries"] > 0
    elif fault is altered:
        assert got["rel_err"] > LIMIT or got["rows_that_differ"] > base["rows_that_differ"]
    else:
        assert got["rows_that_differ"] > base["rows_that_differ"]
