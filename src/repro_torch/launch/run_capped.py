"""Memory-capped out-of-core TPC-H runner for the port.

Shows the out-of-core claim end to end: under a memory cap where the
eager engine cannot materialize the store-backed TPC-H working set,
``CONFIG.out_of_core = "force"`` completes the same queries (q1, q6 and
q14 at SF 1, chunks of 65,536 rows) with identical results.

The cap depends on the device.  On a CUDA device it is
``torch.cuda.set_per_process_memory_fraction(cap / total)``, set before
any tensor exists: it caps what the caching allocator may reserve, and
every kernel takes its scratch from that allocator, so it covers all
the path allocates; going over it raises ``torch.OutOfMemoryError``.
On the CPU it is ``RLIMIT_AS``, set before torch is imported.

Three subcommands::

    python -m repro_torch.launch.run_capped prepare --workdir DIR
    python -m repro_torch.launch.run_capped run --mode {eager,ooc} --cap-mb N --workdir DIR
    python -m repro_torch.launch.run_capped sweep --workdir DIR

``prepare``
    Generate TPC-H, write each table as a tfb v2 store under
    ``--workdir`` and record each query's result fingerprint, uncapped
    and eager (``expected.json``).

``run --mode {eager,ooc} --cap-mb N``
    Cap the memory (``--cap-mb 0``: no cap), open the stores from disk,
    run the queries in the requested mode and compare fingerprints.
    Prints one JSON line (``{"run": ...}``: peaks, seconds, pipeline
    counters).  Exits 0 on a full match, 3 on an out-of-memory error.

``sweep``
    ``prepare`` (unless ``--prepared``: the workdir already holds its
    output), then four ``run`` children, two at a time (each child's cap
    and peaks are its own process's; its seconds are taken while the
    other child runs).  On a CUDA device the cap is
    measured, not guessed: an uncapped eager child and an uncapped ooc
    child report their peaks (``torch.cuda.max_memory_reserved`` and
    ``max_memory_allocated``), and the cap goes halfway between ooc's
    reserved peak and the bytes eager must hold at once (its allocated
    peak); the sweep fails when ooc's peak is not below half of that.
    On the CPU the cap is ``--cap-mb``.  Then the eager child under the
    cap MUST die of an out-of-memory error (a cap that catches nothing
    proves nothing) and the ooc child under the same cap must match the
    uncapped fingerprints.  There is no skip path: every early-out is a
    failure.  Prints one JSON line (``{"sweep": ...}``) before its
    verdict.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

QUERIES = ("q1", "q6", "q14")  # group-by, scalar filter-agg, join-agg
TABLES = ("lineitem", "orders", "customer", "part", "partsupp", "supplier",
          "nation", "region")
CHUNK_ROWS = 1 << 16
SRC = Path(__file__).resolve().parents[2]
WORKDIR = SRC.parent / "build" / "run_capped"
#: exit code of a ``run`` child that died of an out-of-memory error
OOM_EXIT = 3


# ----------------------------------------------------------------------
# fingerprints: order-insensitive, dtype-aware result digests
# ----------------------------------------------------------------------
def fingerprint(frame) -> dict:
    import numpy as np

    out = {}
    for name in frame.column_names:
        arr = frame.column(name)
        if arr.dtype.kind == "f":
            out[name] = ["f", int(arr.shape[0]), float(np.nansum(arr))]
        elif arr.dtype.kind in "iub":
            out[name] = ["i", int(arr.shape[0]), int(arr.sum())]
        else:
            digest = hashlib.sha256(
                "\n".join(sorted(str(v) for v in arr)).encode()
            ).hexdigest()
            out[name] = ["s", int(arr.shape[0]), digest]
    return out


def compare(got: dict, want: dict, query: str) -> bool:
    ok = True
    for name, w in want.items():
        g = got.get(name)
        if g is None or g[0] != w[0] or g[1] != w[1]:
            print(f"FAIL {query}.{name}: shape/kind {g} != {w}")
            ok = False
            continue
        if w[0] == "f":
            tol = 1e-6 * max(1.0, abs(w[2]))
            if abs(g[2] - w[2]) > tol:
                print(f"FAIL {query}.{name}: {g[2]} != {w[2]}")
                ok = False
        elif g[2] != w[2]:
            print(f"FAIL {query}.{name}: {g[2]} != {w[2]}")
            ok = False
    return ok


def _store_paths(workdir: str) -> dict:
    return {name: os.path.join(workdir, f"{name}.tfb") for name in TABLES}


def _open_scope(workdir: str) -> dict:
    from repro_torch.store import open_store

    return {
        name: open_store(path) for name, path in _store_paths(workdir).items()
    }


def _run_sweep(scope: dict, sf: float, device) -> dict:
    from repro_torch import sql
    from repro_torch.queries.tpch_sql import sql_text

    return {
        q: fingerprint(sql.execute(sql_text(q, sf), scope, device=device))
        for q in QUERIES
    }


# ----------------------------------------------------------------------
# subcommands
# ----------------------------------------------------------------------
def prepare_stores(stores: dict, workdir: str, sf: float, device) -> dict:
    """Write each TPC-H table of ``stores`` under ``workdir``, run the
    queries eagerly over the written stores on ``device`` and record
    their fingerprints in ``expected.json``.  Returns the fingerprints."""
    from repro_torch.core.config import CONFIG
    from repro_torch.store import write_store

    os.makedirs(workdir, exist_ok=True)
    for name, path in _store_paths(workdir).items():
        write_store(path, stores[name])
    saved = CONFIG.out_of_core
    CONFIG.out_of_core = "off"
    try:
        expected = _run_sweep(_open_scope(workdir), sf, device)
    finally:
        CONFIG.out_of_core = saved
    with open(os.path.join(workdir, "expected.json"), "w") as fh:
        json.dump({"sf": sf, "fingerprints": expected}, fh)
    return expected


def cmd_prepare(args) -> int:
    from repro_torch.data import tpch

    tables = tpch.generate(sf=args.sf, seed=args.seed)
    stores = tpch.as_store(tables, chunk_rows=CHUNK_ROWS, sort_fact_by_date=True)
    prepare_stores(stores, args.workdir, args.sf, args.device)
    print(f"prepared sf={args.sf} seed={args.seed} queries={QUERIES} "
          f"under {args.workdir}")
    return 0


def _is_cuda(device: str) -> bool:
    return device.startswith("cuda")


def cmd_run(args) -> int:
    cap = args.cap_mb << 20
    if cap and not _is_cuda(args.device):
        # cap the address space BEFORE numpy/torch exist
        import resource

        resource.setrlimit(resource.RLIMIT_AS, (cap, cap))
    import torch

    if _is_cuda(args.device):
        if not torch.cuda.is_available():
            print("run_capped: no CUDA device is available", file=sys.stderr)
            return 2
        if cap:
            total = torch.cuda.get_device_properties(0).total_memory
            torch.cuda.set_per_process_memory_fraction(min(1.0, cap / total), 0)

    from repro_torch.core import pipeline
    from repro_torch.core.config import CONFIG

    CONFIG.out_of_core = "force" if args.mode == "ooc" else "off"
    scope = _open_scope(args.workdir)
    with open(os.path.join(args.workdir, "expected.json")) as fh:
        prepared = json.load(fh)
    expected = prepared["fingerprints"]
    pipeline.reset_stats()
    t0 = time.perf_counter()
    oom = None
    try:
        got = _run_sweep(scope, prepared["sf"], args.device)
    except (torch.OutOfMemoryError, MemoryError) as exc:
        # the allocator's first two sentences: what it tried to allocate
        oom, got = f"{type(exc).__name__}: {'. '.join(str(exc).split('. ')[:2])}", None
    seconds = time.perf_counter() - t0
    ok = oom is None and all(compare(got[q], expected[q], q) for q in QUERIES)
    report = {
        "mode": args.mode, "device": args.device, "cap_mb": args.cap_mb,
        "ok": ok, "oom": oom, "seconds": seconds,
        "pipeline": {k: v for k, v in pipeline.STATS.items() if v},
    }
    if _is_cuda(args.device):
        report["max_memory_reserved"] = torch.cuda.max_memory_reserved()
        report["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    print(json.dumps({"run": report}))
    if oom is not None:
        print("RESULT OOM", oom)
        return OOM_EXIT
    print("RESULT", "PASS" if ok else "FAIL")
    return 0 if ok else 1


def _spawn_pair(args, runs) -> list:
    """Run two ``run`` children, ``runs`` = ((mode, cap MB), (mode, cap MB)),
    at once; returns (exit code, its report, its output) of each."""
    procs = [_start(args, mode, cap_mb) for mode, cap_mb in runs]
    out = []
    for proc in procs:
        stdout, stderr = proc.communicate()
        report = None
        for line in stdout.splitlines():
            if line.startswith('{"run"'):
                report = json.loads(line)["run"]
        out.append((proc.returncode, report, stdout + stderr[-4000:]))
    return out


def _start(args, mode: str, cap_mb: int) -> subprocess.Popen:
    """Start one ``run`` child."""
    cmd = [
        sys.executable, "-m", "repro_torch.launch.run_capped", "run",
        "--mode", mode, "--cap-mb", str(cap_mb), "--workdir", args.workdir,
        "--device", args.device,
    ]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(SRC), env.get("PYTHONPATH")) if p
    )
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env)


def cmd_sweep(args) -> int:
    if not args.prepared:
        rc = cmd_prepare(args)
        if rc:
            return rc
    summary = {"device": args.device}
    if _is_cuda(args.device):
        # measure both paths uncapped, then cap between their peaks
        peaks = {}
        for mode, (rc, report, out) in zip(("eager", "ooc"),
                                           _spawn_pair(args, (("eager", 0), ("ooc", 0)))):
            if rc != 0 or report is None or not report["ok"]:
                print(out)
                print(f"::error::uncapped {mode} run failed (exit {rc})")
                return 1
            peaks[mode] = report
        need = peaks["eager"]["max_memory_allocated"]
        ooc_peak = peaks["ooc"]["max_memory_reserved"]
        if 2 * ooc_peak > need:
            print(f"::error::ooc's peak {ooc_peak} B is not clearly below the "
                  f"{need} B eager holds at once")
            return 1
        cap_mb = ((ooc_peak + need) // 2) >> 20
        summary.update(
            eager_max_memory_reserved=peaks["eager"]["max_memory_reserved"],
            eager_max_memory_allocated=need,
            ooc_max_memory_reserved=ooc_peak,
            ooc_max_memory_allocated=peaks["ooc"]["max_memory_allocated"],
            uncapped_eager_seconds=peaks["eager"]["seconds"],
            uncapped_ooc_seconds=peaks["ooc"]["seconds"],
        )
    else:
        cap_mb = args.cap_mb
    summary["cap_mb"] = cap_mb

    (rc, report, out), ooc = _spawn_pair(args, (("eager", cap_mb), ("ooc", cap_mb)))
    summary["eager_exit"] = rc
    if rc != OOM_EXIT:
        print(out)
        print(f"::error::eager under the {cap_mb} MB cap did not die of an "
              f"out-of-memory error (exit {rc}): the cap proves nothing")
        return 1
    summary["eager_oom"] = report["oom"]
    rc, report, out = ooc
    summary["ooc_exit"] = rc
    if rc != 0 or report is None or not report["ok"]:
        print(out)
        print(f"::error::out_of_core=force failed under the {cap_mb} MB cap "
              f"(exit {rc})")
        return 1
    summary["ooc_seconds"] = report["seconds"]
    summary["ooc_pipeline"] = report["pipeline"]
    if "max_memory_reserved" in report:
        summary["capped_ooc_max_memory_reserved"] = report["max_memory_reserved"]
    print(json.dumps({"sweep": summary}))
    print(f"sweep PASS: eager died under the {cap_mb} MB cap; the ooc run "
          f"matched the uncapped results under it")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in ("prepare", "run", "sweep"):
        p = sub.add_parser(name)
        p.add_argument("--workdir", default=str(WORKDIR))
        p.add_argument("--device", default="cuda",
                       help="device of the runs (cuda, or cpu)")
        if name != "run":
            p.add_argument("--sf", type=float, default=1.0)
            p.add_argument("--seed", type=int, default=11)
        if name == "run":
            p.add_argument("--mode", choices=("eager", "ooc"), required=True)
            p.add_argument("--cap-mb", type=int, required=True,
                           help="memory cap in MiB; 0 runs uncapped")
        if name == "sweep":
            p.add_argument("--prepared", action="store_true",
                           help="the workdir already holds prepare's output")
            # the CPU's address-space cap (RLIMIT_AS), the JAX package's
            # lane's; on a CUDA device the cap is measured instead
            p.add_argument("--cap-mb", type=int, default=1700)
    args = ap.parse_args(argv)
    return {"prepare": cmd_prepare, "run": cmd_run, "sweep": cmd_sweep}[
        args.cmd
    ](args)


if __name__ == "__main__":
    sys.exit(main())
