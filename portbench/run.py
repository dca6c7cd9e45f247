"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A run makes its tables from the seed, hands them to the workload's
client, which loads them onto the card through ``repro_torch``, warms up
every query of the cell's traffic, then drives the workload's loop for
``--seconds``, each query's latency running from its issue until its
result's columns are on the host.  After the window it checks one
execution of every query of the mix, drawn from the seed, against the
plain numpy reference, and prints one JSON line: with ``--trace 0`` the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics,
read under ``torch.profiler``.

Everything a cell needs is found by name: ``configs/<config>.json``,
``workloads/<traffic>.json``, the configuration's dataset
(``datasets/``) and reference (``reference/``), the workload's client
(``clients/``) and loop (``loops/``), and each metric's reader
``metrics/<metric>.py``.  A reader's ``read(ctx)`` takes its number
from what the run hands every reader (see ``readings``); one that also
defines ``recorder()`` gets an object made just before the window,
stopped just after it, as ``ctx["recorded"]``.  A reader that finds
nothing to read returns ``None``, and the metric is left out.

A run needs a CUDA card and the port's sources beside this folder; it
exits non-zero and prints no result without either.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level module names that may not be loaded in a run
BANNED = ("jax", "jaxlib", "flax", "repro")


def _paths() -> None:
    """Import ``portbench`` from the checkout and the port from its
    ``src``; drop this folder itself from the path."""
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(name: str) -> dict:
    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[name]

    def applies(metric):
        return name in metric.get("workloads", [name])

    return {
        "cell": cell,
        "config": load_json(HERE / "configs" / f"{cell['config']}.json"),
        "workload": load_json(HERE / "workloads" / f"{cell['traffic']}.json"),
        "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
        "per_layer": [m for m in bench["per_layer"] if applies(m)],
    }


def metric_module(metric: str):
    """``metrics/<metric>.py``: its ``read(ctx)`` and, optionally, its
    ``recorder()``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def card_name_power() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "unknown"


def run(argv=None, *, device: str = "cuda", scale: float = None, client_hook=None,
        per_query: list = None) -> dict:
    """One run; returns the result line as a dict.  ``device``, ``scale``,
    ``client_hook`` and ``per_query`` are for the CPU tests of the
    harness: a CPU device, a smaller scale factor, a function that wraps
    the client's ``run``, and a list that takes the check's readings of
    each query."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    args.seed %= 2 ** 64  # numpy's generators take seeds of up to 64 bits, not below 0

    import numpy as np
    import torch

    spec = cell_spec(args.workload)
    cell, config, workload = spec["cell"], spec["config"], spec["workload"]
    on_card = device == "cuda"
    if on_card:
        need = int(cell["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < need:
            raise SystemExit(f"this cell needs {need} CUDA device(s); "
                             f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    if not (ROOT / "src" / "repro_torch").is_dir():
        raise SystemExit(f"the port's sources are not at {ROOT / 'src' / 'repro_torch'}")

    import repro_torch  # noqa: F401  (the port's import counts in set-up)

    from portbench import traffic

    sf = float(scale if scale is not None else config["scale_factor"])
    dataset = importlib.import_module(f"portbench.datasets.{config['dataset']}")
    loop = importlib.import_module(f"portbench.loops.{workload['loop']}")
    stages = {"imports_s": time.perf_counter() - T_START}
    t0 = time.perf_counter()
    tables = dataset.generate(sf=sf, seed=args.seed)
    stages["generate_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    client = importlib.import_module(f"portbench.clients.{workload['client']}").Client(
        workload, tables, device)
    stages["client_s"] = time.perf_counter() - t0
    run_query = client.run if client_hook is None else client_hook(client.run)
    queries = workload["queries"]

    def execute(name, params):
        out = run_query(name, params)
        if on_card:
            torch.cuda.synchronize()
        return out

    # warm-up: every query of the mix, with parameters of its own draw
    warm = traffic.stream(queries, np.random.default_rng([args.seed, 1]), sf)
    stages["first_executions_s"] = 0.0
    for r in range(int(workload["warm_rounds"])):
        for _ in range(len(queries)):
            name, params = next(warm)
            t0 = time.perf_counter()
            execute(name, params)
            if r == 0:
                stages["first_executions_s"] += time.perf_counter() - t0
    setup_s = time.perf_counter() - T_START
    log(f"set-up {setup_s:.3f} s: " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
        + f"; client {client.stats}")

    metrics = spec["per_layer"] if args.trace else spec["end_to_end"]
    readers = {m["name"]: metric_module(m["name"]) for m in metrics}
    tracer = None
    if args.trace and on_card:
        from portbench.tracing import Tracer

        tracer = Tracer(torch)
        tracer.start()
    recorded = {k: mod.recorder() for k, mod in readers.items() if hasattr(mod, "recorder")}

    # the measured window
    stream = traffic.stream(queries, np.random.default_rng([args.seed, 2]), sf)
    if tracer:
        with tracer.span("portbench.window"):
            window = loop.drive(execute, stream, args.seconds, tracer.span)
    else:
        window = loop.drive(execute, stream, args.seconds)
    for rec in recorded.values():
        rec.stop()
    peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
    trace = None
    if tracer:
        tracer.stop()
        trace = tracer.reduce()
    done, failures = window["done"], window["failures"]
    log(f"window {window['window_s']:.3f} s: {window['attempted']} queries attempted, "
        f"{len(done)} completed, {len(failures)} failed; "
        f"latency samples {len(window['latencies_ms'])}")
    for f in failures[:5]:
        log(f"failed: {f}")
    quarter = args.seconds / 4
    log("queries a second in each quarter of the window: " + " ".join(
        f"{sum(1 for t in window['ends'] if i * quarter < t <= (i + 1) * quarter) / quarter:.3f}"
        for i in range(4)))
    finite = [x for x in window["latencies_ms"] if x is not None]
    if finite:
        log(f"latency ms: median {statistics.median(finite)}, "
            f"p95 {metric_module('query_ms_p95').p95(finite)} over {len(finite)} completed queries")

    ctx = readings(setup_s, stages, client.stats, window, trace)
    metrics_out = {}
    for m in metrics:
        if m["source"] == "device_trace" and not on_card:
            continue
        value = readers[m["name"]].read({**ctx, "recorded": recorded.get(m["name"])})
        if value is not None:
            metrics_out[m["name"]] = {"value": value, "unit": m["unit"]}

    # the program's state goes before the reference runs
    del client, run_query
    if on_card:
        torch.cuda.empty_cache()
    checks, readings_by_query = check(args.seed, config, workload, tables, done, len(failures))
    if per_query is not None:
        per_query.extend(readings_by_query)

    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))
    if loaded:
        raise SystemExit(f"modules that a run may not load are loaded: {loaded}")

    result = {
        "correct": passes(checks),
        "attempted": window["attempted"],
        "failed": len(failures),
        "metrics": metrics_out,
        "device": {
            "platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
            "count": int(cell["chips"]) if on_card else 0,
            "memory_peak_bytes": peak,
        },
    }
    if trace is not None:
        result["device"]["busy_s"] = trace["busy_s"]
        result["device"]["window_s"] = trace["window_s"]
        result["breakdown"] = {"device_ops": trace["device_ops"], "idle_gaps": trace["idle_gaps"]}
    if on_card:
        result["card"] = card_name_power()
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        log(f"check {k}: {v!r} limit {lim!r}")
    return result


def readings(setup_s: float, stages: dict, client_stats: dict, window: dict, trace) -> dict:
    """What every reader gets: ``setup_s`` and its ``stages``, the client's
    own ``stats`` from set-up (``client``), the window's length, queries
    attempted and completed, each query's latency in ms (``None`` where
    it failed), and the reduced trace (``None`` without ``--trace 1``)."""
    return {
        "setup_s": setup_s, "stages": stages, "client": client_stats,
        "window_s": window["window_s"], "attempted": window["attempted"],
        "completed": len(window["done"]), "latencies_ms": window["latencies_ms"],
        "trace": trace,
    }


def client_order(workload: dict) -> dict:
    """The ORDER BY of each query of the workload, from its templates file."""
    import tomllib

    with open(HERE / "queries" / workload["templates"], "rb") as f:
        t = tomllib.load(f)
    return {q: t[q]["order_by"] for q in t}


def passes(checks: dict) -> bool:
    return all(v <= lim for v, lim in checks.values())


def check(seed: int, config: dict, workload: dict, tables: dict, done: list,
          failed: int) -> tuple:
    """Compare one execution of every query of the mix among ``done``
    (name, parameters, result), drawn from the seed, with the plain
    reference.  Returns ``({name: (value, limit)}, per_query)``, where
    ``per_query`` lists each comparison's readings."""
    import numpy as np

    from portbench.compare import compare

    limits = config["limits"]
    order_by = client_order(workload)
    ref = importlib.import_module(f"portbench.reference.{config['reference']}").Reference(tables)
    picked = sample(done, np.random.default_rng([seed, 3]))
    unchecked = len(set(workload["queries"]) - {done[i][0] for i in picked})
    rows, err, per_query = 0, 0.0, []
    t_all = time.perf_counter()
    for i in picked:
        name, params, got = done[i]
        t0 = time.perf_counter()
        c = compare(got, ref.run(name, params), order_by[name], limits["rel_err"])
        per_query.append({"query": name, "params": params, **c,
                          "seconds": time.perf_counter() - t0})
        log(f"checked {name} {params}: rows that differ {c['rows']}, "
            f"largest relative error {c['rel_err']!r} ({per_query[-1]['seconds']:.3f} s)")
        rows += c["rows"]
        err = max(err, c["rel_err"])
    log(f"reference: {len(picked)} results in {time.perf_counter() - t_all:.3f} s")
    checks = {
        "failed_queries": (failed, 0),
        "unchecked_queries": (unchecked, 0),
        "rows_that_differ": (rows, 0),
        "rel_err": (err, limits["rel_err"]),
    }
    return checks, per_query


def sample(done: list, rng) -> list:
    """Indices of one completed execution of each query in ``done``,
    drawn from ``rng``."""
    by_name = {}
    for i, (name, _, _) in enumerate(done):
        by_name.setdefault(name, []).append(i)
    return sorted(int(rng.choice(by_name[n])) for n in sorted(by_name))


def main() -> int:
    _paths()
    result = run(sys.argv[1:])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
