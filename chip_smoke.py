#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # TPC-H SF 1, all 22 queries
    python3 chip_smoke.py --sf 0.05  # a quicker main path

Phases, each of which fails the run (non-zero exit) on any error:

1. the card's name and power limit, then the build of every CUDA kernel
   from ``src/repro_torch/kernels/csrc`` with ``nvcc``;
2. each kernel against its plain PyTorch version on the card, at edge
   shapes and at the shapes the main path gives it (TPC-H q1 and q18
   group sums, the q13 ``o_comment`` dictionary), with times;
3. the main path: TPC-H generated from ``--seed`` at ``--sf``, frames
   built on the card, the 22 queries run twice through the dataframe
   API; every kernel's launch count must rise during that run; then a
   third pass under ``torch.profiler`` for the device's busy share, and
   the three slowest warm queries once more under ``cProfile``;
4. the card against the CPU plain path on all 22 queries at SF 0.01:
   ints, codes and row order exactly, floats within rtol 1e-8;
5. one JSON line describing every kernel, the card's name and power
   limit, and as the last line ``{"ok": true, "device": {...}}``.

Needs a CUDA device; imports nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# Published H100 SXM peaks (NVIDIA data sheet) for the bound each kernel
# is held to: device-memory bandwidth, and the non-tensor-core float32
# rate (the data sheet's table has no float64 or int64 entry; both
# kernels are bounded by bytes by orders of magnitude either way).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

# Tolerances of kernel vs plain version on one call.  Float atomics add
# in an order that changes from run to run: float64 agrees to rtol 1e-12,
# float32 (24-bit mantissa, up to millions of terms) to rtol 1e-4.
RTOL = {"float64": 1e-12, "float32": 1e-4}
QUERY_RTOL = 1e-8
# Scale factor of the card-vs-CPU check (phase 4), and timed repetitions
# of each kernel at each main-path shape (phase 2b).
CHECK_SF = 0.01
REPS = 20
# Wall-time budget of the profiled pass (phase 3b).
PROFILE_BUDGET_S = 60.0


def log(*parts) -> None:
    print(*parts, flush=True)


def gpu_name_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` on the card (CUDA events, warm)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, nops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(torch, got, want) -> float:
    if got.numel() == 0:
        return 0.0
    return float((got.to(torch.float64) - want.to(torch.float64)).abs().max())


# ----------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ----------------------------------------------------------------------
def check_segment_sum(torch, seg, values, ids, m, label):
    got = seg.segment_sum_cuda(values, ids, m)
    want = seg.segment_sum_plain(values, ids, m)
    torch.cuda.synchronize()
    err = max_abs_err(torch, got, want)
    if values.dtype == torch.int64:
        ok = torch.equal(got, want)
        tol = "exact"
    else:
        rtol = RTOL[str(values.dtype).replace("torch.", "")]
        scale = float(want.abs().max()) if want.numel() else 0.0
        ok = err <= rtol * max(scale, 1.0)
        tol = f"rtol {rtol}"
    log(f"  segment_sum {label}: n={values.numel()} m={m} {values.dtype} "
        f"max_abs_err={err!r} ({tol}) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"segment_sum kernel disagrees with its plain version at {label}")
    return err


def check_substr_find(torch, sf, packed, lens, pat, start, label):
    got = sf.substr_find_cuda(packed, lens, pat, start)
    want = sf.substr_find_plain(packed, lens, pat, start)
    torch.cuda.synchronize()
    ok = torch.equal(got, want)
    log(f"  substr_find {label}: n={packed.shape[0]} L={packed.shape[1]} m={pat.numel()} "
        f"start={'yes' if start is not None else 'no'} exact {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"substr_find kernel disagrees with its plain version at {label}")
    return got


def edge_phase(torch, seg, sf, dev) -> None:
    log("phase 2a: edge shapes")
    rng = np.random.default_rng(7)
    for dtype in (torch.float32, torch.float64, torch.int64):
        for n, m in [(1, 1), (1000, 7), (3 * 4096 + 5, 4096), (3 * 4096 + 5, 4097), (50_000, 100_000)]:
            for order in ("sorted", "unsorted"):
                ids = rng.integers(-1, m + 1, n)  # -1 and m are dropped
                if order == "sorted":
                    ids = np.sort(ids)
                if dtype == torch.int64:
                    vals = rng.integers(-(1 << 40), 1 << 40, n)
                else:
                    vals = rng.normal(size=n) * 1e3
                v = torch.as_tensor(vals, device=dev).to(dtype)
                g = torch.as_tensor(ids, dtype=torch.int64, device=dev)
                check_segment_sum(torch, seg, v, g, m, f"edge {order}")
    empty = seg.segment_sum_cuda(
        torch.zeros(0, dtype=torch.float64, device=dev), torch.zeros(0, dtype=torch.int64, device=dev), 5
    )
    if not torch.equal(empty, torch.zeros(5, dtype=torch.float64, device=dev)):
        raise AssertionError("segment_sum of no rows must be zeros")

    alphabet = np.frombuffer(b"abspecialx yz", dtype=np.uint8)
    for n, L in [(1, 16), (1003, 16), (1003, 128), (4099, 37)]:
        packed = torch.as_tensor(alphabet[rng.integers(0, alphabet.size, (n, L))], device=dev)
        lens = torch.as_tensor(rng.integers(0, L + 1, n).astype(np.int32), device=dev)
        start = torch.as_tensor(rng.integers(-2, L, n).astype(np.int32), device=dev)
        for pat in (b"", b"a", b"ab", b"special", b"x" * (L + 1)):
            p = torch.tensor(list(pat), dtype=torch.uint8, device=dev)
            for st in (None, start):
                check_substr_find(torch, sf, packed, lens, p, st, "edge")


def main_shape_phase(torch, seg, sf, frames, dev) -> dict:
    """Each kernel at the shapes the main path gives it, with times."""
    from repro_torch.core import col, d, strings
    from repro_torch.core.config import CONFIG
    from repro_torch.core.groupby import GroupBy

    log("phase 2b: main-path shapes")
    out = {}

    # K1: q18 (lineitem into orders) and q1 (filtered lineitem into 4 groups)
    li = frames["lineitem"]
    cases = []
    gb = GroupBy(li, ["l_orderkey"])
    cases.append(("q18 sum l_quantity by l_orderkey",
                  li.col_values("l_quantity").contiguous(), gb.gids.contiguous(), gb.m))
    li1 = li.filter(col("l_shipdate") <= d("1998-12-01") - 90)
    gb1 = GroupBy(li1, ["l_returnflag", "l_linestatus"])
    cases.append(("q1 sum l_quantity by flag,status",
                  li1.col_values("l_quantity").contiguous(), gb1.gids.contiguous(), gb1.m))
    cases.append(("q1 size by flag,status",
                  torch.ones(li1.nrows, dtype=torch.int64, device=dev), gb1.gids.contiguous(), gb1.m))
    seg_rows = []
    for label, v, g, m in cases:
        err = check_segment_sum(torch, seg, v, g, m, label)
        k_ms = cuda_ms(torch, lambda: seg.segment_sum_cuda(v, g, m), REPS)
        p_ms = cuda_ms(torch, lambda: seg.segment_sum_plain(v, g, m), REPS)
        l_ms = cuda_ms(
            torch, lambda: torch.zeros(m, dtype=v.dtype, device=dev).index_add_(0, g, v), REPS
        )
        nbytes = v.numel() * (v.element_size() + 8) + m * v.element_size()
        b_ms, b_by = bound_ms(nbytes, v.numel())
        row = dict(label=label, n=v.numel(), m=m, dtype=str(v.dtype), max_abs_err=err,
                   ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms, bound_by=b_by)
        log("   ", json.dumps(row))
        seg_rows.append(row)
    out["segment_sum"] = seg_rows

    # K2: q13's o_comment dictionary, packed as the dictionary-LUT path packs it
    dic = frames["orders"].offloaded["o_comment"].phys_factorize()[1]
    packed, lens = strings.pack_strings_cached(dic, CONFIG.max_packed_len, dev)
    pat_a = torch.tensor(list(b"special"), dtype=torch.uint8, device=dev)
    pat_b = torch.tensor(list(b"requests"), dtype=torch.uint8, device=dev)
    fa = check_substr_find(torch, sf, packed, lens, pat_a, None, "q13 'special'")
    start = torch.where(fa >= 0, fa + pat_a.numel(), 0).to(torch.int32)
    check_substr_find(torch, sf, packed, lens, pat_b, start, "q13 'requests' after it")
    find_rows = []
    for label, p, st, res in [("q13 o_comment dictionary 'special'", pat_a, None, fa)]:
        k_ms = cuda_ms(torch, lambda: sf.substr_find_cuda(packed, lens, p, st), REPS)
        p_ms = cuda_ms(torch, lambda: sf.substr_find_plain(packed, lens, p, st), REPS)
        # bytes this run's data needs: each row up to the end of its
        # first match (or its length), plus lens read and results written
        L, m = packed.shape[1], p.numel()
        scan_end = torch.where(res >= 0, res + m, torch.clamp(lens, max=L)).to(torch.int64)
        scanned = int(scan_end.sum())
        nbytes = scanned + packed.shape[0] * (4 + 4)
        b_ms, b_by = bound_ms(nbytes, scanned)
        row = dict(label=label, n=packed.shape[0], L=L, max_abs_err=0.0, ms=k_ms,
                   plain_ms=p_ms, library_ms=None, bound_ms=b_ms, bound_by=b_by)
        log("   ", json.dumps(row))
        find_rows.append(row)
    out["substr_find"] = find_rows
    return out


# ----------------------------------------------------------------------
# phases 3 and 4: the main path, and the card against the CPU
# ----------------------------------------------------------------------
def run_queries(torch, QF, frames, sf: float):
    results, ms = {}, {}
    for q in sorted(QF.ALL, key=lambda s: int(s[1:])):
        t = time.perf_counter()
        res = QF.ALL[q](frames, sf=sf, apply_limit=False)
        if not isinstance(res, dict):
            res = res.to_dict()
        torch.cuda.synchronize()
        ms[q] = (time.perf_counter() - t) * 1e3
        results[q] = res
    return results, ms


def profile_pass(torch, QF, frames, sf: float) -> None:
    """One more warm pass of the 22 queries, each under its own
    ``torch.profiler`` context: per query the wall time and the device
    busy time (the sum of the self time of every device-side event:
    kernels, copies, memsets), then the device ops that take most of it
    over the pass.  The profiler adds host cost of its own, so these wall
    times are not the warm times of phase 3."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    log("phase 3b: profiled warm pass (per query: traced wall, device busy)")
    per_op: dict = {}
    walls, busies = [], []
    t0 = time.perf_counter()
    for q in sorted(QF.ALL, key=lambda s: int(s[1:])):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            QF.ALL[q](frames, sf=sf, apply_limit=False)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
        busy = 0.0
        for e in prof.key_averages():
            # device-side events only: a host op's entry repeats the
            # device time of the kernels it launched
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
                ms = e.self_device_time_total / 1e3
                busy += ms
                acc = per_op.setdefault(e.key, [0.0, 0])
                acc[0] += ms
                acc[1] += e.count
        walls.append(wall)
        busies.append(busy)
        log(f"  {q}: wall {wall:.3f} ms, device busy {busy:.3f} ms ({100 * busy / wall:.3f} %)")
        if time.perf_counter() - t0 > PROFILE_BUDGET_S:
            log(f"  stopped after {q}: profiling budget of {PROFILE_BUDGET_S} s spent")
            break
    wall, busy = sum(walls), sum(busies)
    ported = {
        name: sum(ms for key, (ms, _) in per_op.items() if name in key)
        for name in ("segment_sum", "substr_find")
    }
    log(f"  all profiled queries: wall {wall:.3f} ms, device busy {busy:.3f} ms "
        f"({100 * busy / wall:.3f} %; idle share {100 - 100 * busy / wall:.3f} %)")
    log(f"  ported kernels' device ms: {json.dumps(ported)}")
    for key, (ms, count) in sorted(per_op.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"  {ms:.3f} ms  {count} x {key[:100]}")


def host_profile(torch, QF, frames, sf: float, queries) -> None:
    """The host side of the slowest warm queries: each once more under
    ``cProfile``, with the functions that spend the most time of their
    own (a device wait shows as the call that synchronises)."""
    import cProfile
    import io
    import pstats

    for q in queries:
        prof = cProfile.Profile()
        prof.enable()
        QF.ALL[q](frames, sf=sf, apply_limit=False)
        torch.cuda.synchronize()
        prof.disable()
        out = io.StringIO()
        pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(10)
        lines = [ln for ln in out.getvalue().splitlines() if ln.strip()]
        log(f"phase 3c: host profile of {q} (cProfile, top 10 by own time)")
        for ln in lines[-11:]:
            log(f"  {ln.strip()[:150]}")


def check_finite(q: str, res: dict) -> None:
    for name, arr in res.items():
        arr = np.asarray(arr)
        if arr.dtype.kind == "f" and not np.isfinite(arr).all():
            raise AssertionError(f"{q}.{name}: non-finite values")


def compare_results(q: str, got: dict, want: dict) -> None:
    if set(got) != set(want):
        raise AssertionError(f"{q}: columns {sorted(got)} != {sorted(want)}")
    for name in want:
        a, b = np.asarray(got[name]), np.asarray(want[name])
        if a.shape != b.shape:
            raise AssertionError(f"{q}.{name}: shape {a.shape} != {b.shape}")
        if a.dtype.kind == "f" or b.dtype.kind == "f":
            if not np.allclose(a, b, rtol=QUERY_RTOL, atol=0.0, equal_nan=True):
                raise AssertionError(f"{q}.{name}: floats differ beyond rtol {QUERY_RTOL}")
        elif not (a == b).all():
            raise AssertionError(f"{q}.{name}: values or row order differ")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=1.0, help="TPC-H scale factor of the main path")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke.py: src/repro_torch not found beside this script", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.data import tpch
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import segment_reduce as seg
    from repro_torch.kernels import substr_find as sf
    from repro_torch.queries import tpch_frames as QF

    t_all = time.perf_counter()
    dev = torch.device("cuda", 0)
    log("device:", gpu_name_power())
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    # phase 1: build
    t = time.perf_counter()
    build.build_all()
    log(f"phase 1: built {sorted(build.SIGNATURES)} in {time.perf_counter() - t:.3f} s")
    for name, text in build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"  nvcc[{name}]: {line.strip()}")

    # phase 2a: edge shapes (a broken kernel fails here, fast)
    edge_phase(torch, seg, sf, dev)

    # main-path data
    t = time.perf_counter()
    tables = tpch.generate(sf=args.sf, seed=args.seed)
    t_gen = time.perf_counter() - t
    t = time.perf_counter()
    frames = tpch.as_frames(tables, device=dev)
    torch.cuda.synchronize()
    t_frames = time.perf_counter() - t
    log(f"main path data: SF {args.sf} seed {args.seed}: generate {t_gen:.3f} s, "
        f"frames on {dev} {t_frames:.3f} s, lineitem {frames['lineitem'].nrows} rows, "
        f"device memory {torch.cuda.memory_allocated() / 1e9:.3f} GB")

    # phase 2b: main-path shapes
    shapes = main_shape_phase(torch, seg, sf, frames, dev)

    # phase 3: the main path
    log("phase 3: main path, 22 queries twice")
    ops.reset_launches()
    res1, ms1 = run_queries(torch, QF, frames, args.sf)
    pass1 = dict(ops.LAUNCHES)
    res2, ms2 = run_queries(torch, QF, frames, args.sf)
    launches = dict(ops.LAUNCHES)
    log(f"  launches after pass 1: {pass1}; after both passes: {launches}")
    for q in ms1:
        first = next(iter(res2[q].values()))
        rows = 1 if np.ndim(first) == 0 else len(first)
        log(f"  {q}: cold {ms1[q]:.3f} ms, warm {ms2[q]:.3f} ms, rows {rows}")
        check_finite(q, res2[q])
        compare_results(q, res2[q], res1[q])
    log(f"  total: cold {sum(ms1.values()):.3f} ms, warm {sum(ms2.values()):.3f} ms")
    missing = [name for name, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
    profile_pass(torch, QF, frames, args.sf)
    host_profile(torch, QF, frames, args.sf, sorted(ms2, key=ms2.get, reverse=True)[:3])
    del frames, tables, res1, res2
    torch.cuda.empty_cache()

    # phase 4: card vs CPU plain path
    log(f"phase 4: card vs CPU at SF {CHECK_SF}")
    small = tpch.generate(sf=CHECK_SF, seed=args.seed)
    on_card, _ = run_queries(torch, QF, tpch.as_frames(small, device=dev), CHECK_SF)
    on_cpu, _ = run_queries(torch, QF, tpch.as_frames(small, device="cpu"), CHECK_SF)
    for q in on_cpu:
        compare_results(q, on_card[q], on_cpu[q])
    log(f"  22 queries agree (ints/codes/order exact, floats rtol {QUERY_RTOL})")

    # phase 5: report
    sources = {
        "segment_sum": ("src/repro_torch/kernels/csrc/segment_sum.cu",
                        "src/repro/kernels/segment_reduce.py:36"),
        "substr_find": ("src/repro_torch/kernels/csrc/substr_find.cu",
                        "src/repro/kernels/substr_find.py:43"),
    }
    kernels = []
    for name, rows in shapes.items():
        row = rows[0]  # the largest main-path shape of each kernel
        src, replaces = sources[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"], "shape": row["label"],
        })
    log(f"wall time {time.perf_counter() - t_all:.3f} s")
    log(json.dumps({"kernels": kernels}))
    log(gpu_name_power())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
