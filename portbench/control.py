"""The control of ``correct``: the plain reference in float32, the
precision below the configurations' float64, put in the program's place.

    python3 portbench/control.py --workload <cell> --seeds 11 12 13

For each seed it makes the cell's tables, answers one round of the run's
own drawn stream with the float32 reference, and hands those answers to
the harness's own check (``run.check``), which compares them with the
float64 reference as it does a run's.  It prints, for each seed, the
check's ``correct`` and its numbers beside their limits, and each
query's readings.  The control has to come out not correct: a limit it
passes is too loose.  Needs no card.
"""
from __future__ import annotations

import argparse
import importlib
import itertools
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
sys.path.insert(0, str(HERE.parent))

import numpy as np  # noqa: E402

from portbench import run as harness  # noqa: E402
from portbench import traffic  # noqa: E402


def readings(workload_name: str, seed: int, scale: float = None) -> dict:
    spec = harness.cell_spec(workload_name)
    config, workload = spec["config"], spec["workload"]
    sf = float(scale if scale is not None else config["scale_factor"])
    tables = importlib.import_module(f"portbench.datasets.{config['dataset']}").generate(
        sf=sf, seed=seed)
    ref32 = importlib.import_module(f"portbench.reference.{config['reference']}").Reference(
        tables, np.float32)
    queries = workload["queries"]
    stream = traffic.stream(queries, np.random.default_rng([seed, 2]), sf)
    done = [(name, params, ref32.run(name, params))
            for name, params in itertools.islice(stream, len(queries))]
    checks, per_query = harness.check(seed, config, workload, tables, done, 0)
    return {"seed": seed, "correct": harness.passes(checks),
            "checks": {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()},
            "per_query": per_query}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = readings(args.workload, seed)
        r["seconds"] = time.perf_counter() - t0
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
