"""The readers of the program's own spans and counters, on whole runs on
the CPU at a small scale (the look for a card skipped): a traced run
reads each of them, with the program's tracing on inside the window
alone; an untraced run never turns it on."""
import pytest

from portbench import run as harness
from portbench import spans

SEED = 2 ** 31 + 7
NEW = ("sql.front_ms_per_query", "sql.compile.prepare_ms_per_query",
       "frame.to_host_ms_per_query", "frame.d2h_copies_per_query", "setup.factorize_s")


def cpu_run(trace):
    """The result line and the tracer's mode at each query's issue."""
    from repro_torch.core.config import CONFIG

    modes = []

    def hook(run):
        def go(name, params):
            modes.append(CONFIG.tracing)
            return run(name, params)
        return go

    argv = ["--workload", "tpch-sf1.compiled", "--seed", str(SEED), "--seconds", "2",
            "--trace", str(trace)]
    result = harness.run(argv, device="cpu", scale=0.01, client_hook=hook)
    assert CONFIG.tracing == "off" and not spans._OPEN
    return result, modes


@pytest.fixture(scope="module")
def traced():
    return cpu_run(1)


@pytest.mark.parametrize("metric", NEW)
def test_a_traced_run_reads_each_new_metric(traced, metric):
    r, _ = traced
    assert r["correct"] is not None and r["metrics"][metric]["value"] > 0


def test_a_traced_run_traces_inside_its_window_alone(traced):
    r, modes = traced
    warm = 2 * 22  # two warm rounds of the 22 queries, before the window
    assert set(modes[:warm]) == {"off"} and set(modes[warm:]) == {"on"}
    assert len(modes) == warm + r["attempted"]


def test_an_untraced_run_never_turns_tracing_on():
    r, modes = cpu_run(0)
    assert set(modes) == {"off"} and not set(r["metrics"]) & set(NEW)
