"""Compare variants of one K4 float32 kernel source on the card: build each
with ``nvcc`` by hand, swap it in for the kernel of that launch name,
hold it to the plain version at edge shapes, then time them in turns at
Qwen3-14B's training shape and print each one's device time by kernel.

    PYTHONPATH=src python3 src/repro_torch/launch/kernel_variants.py \\
        flash_attention_f32_sm90 \\
        '{"a": ["a.cu", "-Isrc/repro_torch/kernels/csrc"], "b": ["b.cu", "-I..."]}'

The first argument is a launch name of ``build.SIGNATURES`` (the
float32 forward or backward of K4); the second maps a label to a source
with the same C interface and any extra ``nvcc`` flags (the headers of
``csrc/`` need ``-I``).  Libraries go to ``build/kernel_variants/``.
Times: CUDA events, ms a call, over the labels in the order a b .. b a
twice.  Needs a CUDA device.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa

#: (B, Hq, Hkv, Sq, Sk, D): ragged tiles, groups 1 to 5, D 16 to 128,
#: Sq < Sk and Sq > Sk, several tiles of Qwen3-14B's heads
EDGE_SHAPES = [(2, 2, 2, 100, 100, 16), (1, 4, 2, 37, 200, 64), (1, 10, 2, 130, 130, 96),
               (1, 5, 1, 1, 77, 128), (1, 2, 2, 127, 127, 80), (1, 4, 2, 129, 129, 112),
               (2, 5, 1, 200, 200, 48), (1, 4, 4, 129, 200, 32), (1, 8, 1, 300, 130, 128),
               (1, 40, 8, 257, 513, 128), (1, 5, 1, 600, 600, 64)]


def event_ms(fn, reps: int) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_variants.py: no CUDA device is available", file=sys.stderr)
        return 2
    name, variants = sys.argv[1], json.loads(sys.argv[2])
    out_dir = build.BUILD_DIR.parent / "kernel_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for label, (src, *flags) in variants.items():
        lib = out_dir / f"{label}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, *flags, "-o", str(lib), src]
        procs.append((label, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                   stderr=subprocess.STDOUT, text=True)))
    fns = {}
    for label, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(log, file=sys.stderr)
            return 1
        print(label, "registers", re.findall(r"Used (\d+) registers", log), flush=True)
        symbol, argtypes = build.SIGNATURES[name]
        fn = getattr(ctypes.CDLL(str(lib)), symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[label] = fn

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    mk = lambda *s: torch.as_tensor(rng.normal(size=s), device=dev).float()
    backward = "bwd" in name
    fails = 0
    for label, fn in fns.items():
        build._FNS[name] = fn
        worst = 0.0
        for B, Hq, Hkv, Sq, Sk, D in EDGE_SHAPES:
            q = mk(B, Sq, Hq, D).transpose(1, 2)
            k, v = mk(B, Hkv, Sk, D), mk(B, Hkv, Sk, D)
            for causal in ((True, False) if Sq <= Sk else (False,)):
                o, lse = fa.flash_attention_fwd_cuda(q, k, v, causal)
                if backward:
                    do = mk(B, Hq, Sq, D)
                    got = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal)
                    again = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal)
                    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
                    scale = max(float(w.abs().max()) for w in want) or 1.0
                    err = max(float((g - w).abs().max()) / scale for g, w in zip(got, want))
                    ok = err <= 1e-4 and all(torch.equal(a, b) for a, b in zip(got, again))
                else:
                    want = fa.flash_attention_plain(q, k, v, causal)
                    err = float((o - want).abs().max())
                    ok = bool(((o - want).abs() <= 2e-5 + 2e-5 * want.abs()).all())
                    ok = ok and float((lse - fa.attention_lse_plain(q, k, causal))
                                      .abs().max()) <= 1e-4
                worst = max(worst, err)
                if not ok:
                    fails += 1
                    print(label, "FAIL", (B, Hq, Hkv, Sq, Sk, D), causal, err, flush=True)
        print(label, "worst error", worst, flush=True)

    q = mk(1, 4096, 40, 128).transpose(1, 2)
    k, v = mk(1, 8, 4096, 128), mk(1, 8, 4096, 128)
    o, lse = fa.flash_attention_fwd_cuda(q, k, v, True)
    do = mk(1, 40, 4096, 128)
    call = ((lambda: fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, True)) if backward
            else (lambda: fa.flash_attention_fwd_cuda(q, k, v, True)))
    labels = list(fns)
    times = {label: [] for label in labels}
    for label in (labels + labels[::-1]) * 2:
        build._FNS[name] = fns[label]
        times[label].append(event_ms(call, 10))
    print(json.dumps({"ms": times}))
    from torch.profiler import ProfilerActivity, profile

    for label in labels:
        build._FNS[name] = fns[label]
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                call()
            torch.cuda.synchronize()
        res = {}
        for e in prof.key_averages():
            total = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
            if e.count and total and "fa_" in e.key:
                key = re.sub(r"^void |\(anonymous namespace\)::", "", e.key).split("(")[0]
                res[key] = total / e.count / 1e3
        print(label, json.dumps({"device_ms": res}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    print("FAILS", fails)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
