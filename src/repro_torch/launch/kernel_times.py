"""Time K1, K2, K5, RWKV6-7B's decode step and Qwen3-14B's prefill and
decode step on the card through the public API, and print one JSON line.

    PYTHONPATH=src python3 src/repro_torch/launch/kernel_times.py
    PYTHONPATH=<other checkout>/src python3 src/repro_torch/launch/kernel_times.py

The second form times another checkout of the port with this script, so
two versions can be compared in turns on one card (A, B, B, A).  It uses
only what every version of the port has: ``ops.segment_sum``,
``ops.substr_find``, ``ops.exists_before``, ``strings.pack_strings``,
the TPC-H generator's word salad, ``ops.wkv6`` (contiguous inputs, state
passed) and ``ServeEngine``; where
``ops.wkv6`` takes ``state_out`` it also times the decode step's own
call (strided views, the state written over itself).

* K1 at two synthetic shapes of TPC-H SF 1: q1's (5,916,712 rows into 6
  groups at random, float64) and q18's (6,001,303 rows into 1,500,000
  groups in runs of 1 to 7 equal ids, float64);
* K2 on a q13-like ``o_comment`` dictionary: 1,500,000 comments from
  the generator's ``_rand_words``, 1 % with "special ... requests"
  injected by its ``_inject_pattern`` (seed 0), packed to 128 bytes a
  row; the find of "special" and the whole ``exists_before("special",
  "requests")`` (one fused launch, or two finds and their glue, as the
  version has it);
* K5 at RWKV6-7B's decode shape (B 4, H 64, T 1, D 64, bf16 inputs and
  u, float32 state);
* RWKV6-7B at full width with random bf16 weights: 16 requests over 4
  slots, the median decode step (host clock; each step ends in the
  argmax's copy to the host);
* Qwen3-14B at full width with random bf16 weights: the median of 3
  warm 4096-token prefills at B 1 and the median decode step of 8
  requests over 4 slots;
* for both models, the host work of one ``lm.decode_step`` at 4 slots:
  the ATen ops it dispatches and the Python calls it makes, which do not
  vary from run to run as the step's host time does.

Times: CUDA events over warm calls, ms per call.  Needs a CUDA device.
"""
from __future__ import annotations

import inspect
import json
import subprocess
import sys
import time

import numpy as np
import torch

REPS = 200


def event_ms(fn, reps: int = REPS) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def serve_step_ms(cfg, params, n_requests: int, Request, ServeEngine) -> list:
    """Host ms of each decode step of ``n_requests`` requests over 4 slots
    (prompts of 3 to 12 tokens, 8 new tokens each); the second of two
    runs, as the first warms the allocator."""
    for _ in range(2):
        eng = ServeEngine(cfg, params, batch_slots=4, max_len=256)
        step_ms = []
        step = eng.step

        def timed_step():
            t = time.perf_counter()
            step()
            step_ms.append((time.perf_counter() - t) * 1e3)

        eng.step = timed_step
        req_rng = np.random.default_rng(0)
        reqs = [Request(rid=i, prompt=req_rng.integers(0, cfg.vocab, req_rng.integers(3, 13))
                        .astype(np.int32), max_new=8) for i in range(n_requests)]
        eng.run(reqs)
    return step_ms


def step_host_work(lm, cfg, params, dev) -> tuple:
    """(ATen ops dispatched, Python calls made) by one decode step at 4
    slots, after a first step."""
    import cProfile
    import pstats

    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    state = lm.init_decode_state(cfg, 4, 256, device=dev)
    batch = {"tokens": torch.zeros((4, 1), dtype=torch.long, device=dev),
             "kv_start": torch.zeros(4, dtype=torch.int32, device=dev)}
    _, state = lm.decode_step(cfg, params, state, batch)
    with Count():
        _, state = lm.decode_step(cfg, params, state, batch)
    prof = cProfile.Profile()
    prof.enable()
    lm.decode_step(cfg, params, state, batch)
    prof.disable()
    return Count.n, sum(stat[1] for stat in pstats.Stats(prof).stats.values())


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_times.py: no CUDA device is available", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.configs import get
    from repro_torch.core import strings
    from repro_torch.data import tpch
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.serve.engine import Request, ServeEngine

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    out = {"package": repro_torch.__file__,
           "device": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
               capture_output=True, text=True, check=True, timeout=60).stdout.strip()}

    # K1
    n1 = 5_916_712
    v1 = torch.as_tensor(rng.integers(1, 51, n1).astype(np.float64), device=dev)
    g1 = torch.as_tensor(rng.integers(0, 6, n1), device=dev)
    starts = np.arange(1_500_000)
    ids = np.repeat(starts, rng.integers(1, 8, starts.size))[:6_001_303]
    g18 = torch.as_tensor(ids, device=dev)
    v18 = torch.as_tensor(rng.integers(1, 51, ids.size).astype(np.float64), device=dev)
    out["segment_sum_q1_ms"] = event_ms(lambda: ops.segment_sum(v1, g1, 6))
    out["segment_sum_q18_ms"] = event_ms(lambda: ops.segment_sum(v18, g18, 1_500_000))

    # K2
    words = np.random.default_rng(0)
    comments = tpch._inject_pattern(
        words, tpch._rand_words(words, 1_500_000), "special", "requests", 0.01)
    packed, lens = strings.pack_strings(comments, 128, dev)
    pa = torch.tensor(list(b"special"), dtype=torch.uint8, device=dev)
    pb = torch.tensor(list(b"requests"), dtype=torch.uint8, device=dev)
    out["substr_find_q13_ms"] = event_ms(lambda: ops.substr_find(packed, lens, pa))
    out["exists_before_q13_ms"] = event_ms(lambda: ops.exists_before(packed, lens, pa, pb))
    del packed, lens

    # K5
    B, H, D = 4, 64, 64
    mk = lambda *s: torch.as_tensor(rng.normal(size=s) * 0.5, device=dev).to(torch.bfloat16)
    r, k, v = mk(B, H, 1, D), mk(B, H, 1, D), mk(B, H, 1, D)
    w = torch.as_tensor(rng.uniform(0.7, 0.999, (B, H, 1, D)), device=dev).to(torch.bfloat16)
    u = mk(H, D)
    S = torch.as_tensor(rng.normal(size=(B, H, D, D)), device=dev).float()
    out["wkv6_decode_ms"] = event_ms(lambda: ops.wkv6(r, k, v, w, u, S))
    if "state_out" in inspect.signature(ops.wkv6).parameters:
        rs, ks, vs, ws = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (r, k, v, w))
        out["wkv6_decode_in_place_ms"] = event_ms(
            lambda: ops.wkv6(rs, ks, vs, ws, u, S, state_out=S))
    del v1, g1, g18, v18

    # RWKV6-7B decode
    cfg = get("rwkv6-7b")
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(0), device=dev)
    step_ms = serve_step_ms(cfg, params, 16, Request, ServeEngine)
    out["rwkv6_steps"] = len(step_ms)
    out["rwkv6_step_ms_median"] = float(np.median(step_ms))
    out["rwkv6_step_ms_min"] = float(np.min(step_ms))
    out["rwkv6_step_aten_ops"], out["rwkv6_step_python_calls"] = step_host_work(
        lm, cfg, params, dev)
    del params

    # Qwen3-14B prefill and decode
    cfg = get("qwen3-14b")
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(0), device=dev)
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab, (1, 4096)), device=dev)
    prefill_ms = []
    for _ in range(4):  # the first is cold
        t = time.perf_counter()
        lm.prefill(cfg, params, {"tokens": toks})
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t) * 1e3)
    out["qwen3_prefill_ms_median"] = float(np.median(prefill_ms[1:]))
    step_ms = serve_step_ms(cfg, params, 8, Request, ServeEngine)
    out["qwen3_steps"] = len(step_ms)
    out["qwen3_step_ms_median"] = float(np.median(step_ms))
    out["qwen3_step_aten_ops"], out["qwen3_step_python_calls"] = step_host_work(
        lm, cfg, params, dev)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
