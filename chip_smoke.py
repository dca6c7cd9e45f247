#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # TPC-H SF 1, all 22 queries, then the LM path
    python3 chip_smoke.py --sf 0.05  # a quicker TPC-H main path

Phases, each of which fails the run (non-zero exit) on any error:

1. the card's name and power limit, then the build of every CUDA kernel
   from ``src/repro_torch/kernels/csrc`` with ``nvcc``;
2. each kernel against its plain PyTorch version on the card, at edge
   shapes (2a: the segment sum at the bounds of its three paths, with
   runs, unaligned lengths and offset pointers; the substring find and
   its fused exists_before at row widths 1 to 128, base pointers 0 to 15
   bytes off alignment and pattern lengths 0 to L + 1; the WKV recurrence
   on strided inputs with its state written in place; the backward
   kernels of K4 (bf16, and float32 in split TF32, on the tensor cores)
   and K5, from the forward kernels' log-sum-exp, at head dims 16 to 128,
   groups 1, 5 and 8, ragged, causal-offset and non-causal shapes, K4's
   float32 pair also over 32768 keys, T 1 to 300 with and without a state and w down to 1e-12, each twice to show
   it repeats bit for bit, and the autograd Functions against the CPU's
   autograd) and at the shapes
   the main paths give it (2b: TPC-H q1 and q18 group sums, the q13
   ``o_comment`` dictionary's find and exists_before, q9's ``p_name``
   and q16's ``s_comment`` dictionaries, the tuple hash of lineitem's
   (l_orderkey, l_linenumber), Qwen3-14B's prefill attention on the bf16
   tensor-core kernel and, on float32 copies, the split-TF32 kernel, the
   bf16 attention of the later families' prefills (Kimi-K2: GQA group 8
   at head dim 112; Zamba2's shared block: group 1 at 80; the vision
   model's cross-attention: non-causal, 4096 queries over 1600 keys;
   MusicGen: head dim 64), RWKV6-7B's decode recurrence and its prefill
   shape, the backward kernels at the training shapes of phase 8b, their
   device times summed over every kernel of a call), with times and
   bounds;
3. the TPC-H main path: tables generated from ``--seed`` at ``--sf``,
   frames built on the card, the 22 queries run twice through the
   dataframe API; the segment-sum and substring kernels' launch counts
   must rise during that run (the first pass's launches are printed by
   path for the segment sum and by form for the substring search, whose
   fused exists_before must have run), and the segment sum's mid path
   timed at the inputs of the query that launches it most; then a third
   pass under ``torch.profiler`` for the device's busy share, each ported
   kernel's launches counted in it and its device time read from it (a
   query is profiled again, up to ``PROFILE_TRIES`` sessions, while a
   kernel it launched shows no device time), and the three slowest warm
   queries once more under ``cProfile``;
4. the card against the CPU plain path on all 22 queries at SF 0.01:
   ints, codes and row order exactly, floats within rtol 1e-8;
6. the LM path at full width with random weights from ``--seed``:
   Qwen3-14B prefilled at B=1, S=4096 (exactly one launch of the bf16
   tensor-core attention kernel per layer, none of the f32 one) and
   served (8 requests over 4 slots), then RWKV6-7B served (16 requests
   over 4 slots, exactly one WKV launch per layer and decode step), then
   the four families that came later, at their published widths with
   depth cut to fit one card where it must (``NEW_LM``): DBRX-132B and
   Kimi-K2 (MoE FFN), Zamba2-2.7B (Mamba2 hybrid), Llama-3.2-Vision-90B
   (cross-attention over 1600 image tokens) and MusicGen-medium (frame
   embeddings in), each prefilled at S=4096 with exactly one
   tensor-core attention launch per attention layer and nothing else,
   then served through ``ServeEngine`` (MusicGen, which takes no tokens:
   16 ``decode_step``s at B=4) with no kernel launched in decode;
   prefill and decode-step times, tokens per second, peak device
   memory, and the device's busy share of a profiled prefill and decode
   pass;
7. the card against the CPU on the LM path: every family at a reduced
   float32 config (attention through the f32 split-TF32 kernel, once per
   attention layer and nothing else; the vision model's cross-attention
   gates opened to 0.5) with the same weights on both devices, prefill
   logits within 1e-4 and served tokens equal (MusicGen: four
   ``decode_step``s' logits);
8. training: (a) the reduced float32 config of each of the ten
   registered families from the same weights on the card and the CPU,
   the loss and every gradient leaf of a microbatch (the forward kernels
   twice and the backward kernels once a layer, under
   ``remat="nothing"``), the weights after a train step, and after one
   more step from the card's checkpoint restored on the CPU; (b)
   Qwen3-14B (4 layers) and RWKV6-7B (8 layers) at their published
   widths, 3 adamw steps of 4 x 4096 and 8 x 4096 tokens curated on the
   card (K2's find and K1 in ``curate``), K4's and K5's forward and
   backward launches of a step asserted, step time, tokens per second,
   peak memory and a profiled step;
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

# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W) for the
# bound each kernel is held to: device-memory bandwidth; the
# non-tensor-core float32 rate, for the segment sum, the substring search,
# the tuple hash and the WKV recurrence (the table has no integer, float64
# or int64 entry; those kernels are bounded by bytes either way); the
# bf16 tensor-core rate, for attention on bf16 inputs; and the TF32
# tensor-core rate, for attention on float32 inputs, which takes three
# TF32 products for each float32-accurate one (split TF32: a_lo b_hi +
# a_hi b_lo + a_hi b_hi), an effective 165 TFLOP/s (the CUDA cores' 67
# TFLOP/s bound is reported beside it).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
PEAK_BF16_OPS_PER_S = 989e12
PEAK_TF32_OPS_PER_S = 495e12
TF32_PRODUCTS = 3

# Tolerances of kernel vs plain version on one call.  Float atomics add
# in an order that changes from run to run: float64 agrees to rtol 1e-12,
# float32 (24-bit mantissa, up to millions of terms) to rtol 1e-4, of the
# largest result; for values of both signs (the edge shapes), of the
# largest sum of |value| over a segment, the scale of a sum's rounding
# in any order (a sum that cancels can be far smaller than its terms).
RTOL = {"float64": 1e-12, "float32": 1e-4}
QUERY_RTOL = 1e-8
# Scale factor of the card-vs-CPU check (phase 4), and timed repetitions
# of each kernel at each main-path shape (phase 2b).
CHECK_SF = 0.01
REPS = 20
# Profiler sessions tried for one kernel's device time (phases 2b and 3b),
# and the short kernels (torch.cuda._sleep, whose device kernel is named
# spin_kernel) that open each session of phases 3b and 6 before the work
# it measures, to take the loss of a session's first device events
PROFILE_TRIES = 3
PAD_KERNELS, PAD_CYCLES, PAD_KEY = 64, 2000, "spin_kernel"
# K2's edge checks: rows, row widths, pattern lengths (and L itself), and the
# bytes rows and patterns are drawn from (NUL and bytes >= 0x80 among them)
SUBSTR_EDGE_ROWS = 1001
SUBSTR_EDGE_L = (1, 15, 16, 17, 37, 100, 128)
SUBSTR_EDGE_M = (1, 2, 7, 8, 15, 16, 17, 33)
SUBSTR_ALPHABET = np.frombuffer(b"aab\x00\x80\xffspecial", dtype=np.uint8)
# K4 and K5 against their plain versions: (rtol = atol) per input dtype,
# those of tests/test_kernels.py (f32 sums in another order; bf16 output
# rounding), and timed repetitions at their main-path shapes.
WKV6_TOL = {"float32": 1e-4, "bfloat16": 4e-2}
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
LM_REPS = 10
# The LM path (phase 6): prompt length of the prefill, and the serving
# runs' requests, slots, cache length and new tokens per request.
PREFILL_LEN = 4096
SERVE = {"qwen3-14b": 8, "rwkv6-7b": 16, "dbrx-132b": 8, "kimi-k2-1t-a32b": 8,
         "zamba2-2.7b": 8, "llama-3.2-vision-90b": 8}
SLOTS, MAX_LEN, MAX_NEW = 4, 256, 8
# The families served after Qwen3-14B and RWKV6-7B, at their published
# widths; the depth each keeps where its bf16 weights would not fit one
# 80 GB card (PERF.md section 4 has the arithmetic), else None
NEW_LM = {"dbrx-132b": 10, "kimi-k2-1t-a32b": 2, "zamba2-2.7b": None,
          "llama-3.2-vision-90b": 40, "musicgen-medium": None}
# MusicGen takes frame embeddings, which no engine feeds: decode steps at
# this batch instead
EMBED_STEPS, EMBED_BATCH = 16, 4
# the cross-attention gate opened in phases 7 and 8a (it starts at 0: closed)
CROSS_GATE = 0.5
# Training (phase 8b): the configurations at their published widths with
# depth cut to fit one card (PERF.md section 4), (layers, batch), each
# trained TRAIN_STEPS steps of batch x TRAIN_SEQ tokens; the curation
# mixture of the training launcher
TRAIN = {"qwen3-14b": (4, 4), "rwkv6-7b": (8, 8)}
TRAIN_SEQ, TRAIN_STEPS = 4096, 3
MIXTURE = {"web": 1.0, "books": 2.0, "wiki": 1.5, "code": 1.0}
# Card vs CPU in training (phase 8a), float32: the loss (rtol) and each
# gradient leaf (rtol, and atol relative to the leaf's largest |value|;
# float32 sums in another order), a step's grad norm (rtol).  The Mamba2
# hybrid's gradients get 5e-4: its SSD (plain PyTorch on both devices, no
# kernel of this repository) takes exp of float32 cumulative sums of
# log-decays, which the card and the CPU accumulate in another order
# (its gradients drift to 1.1e-4 of a leaf's largest value after a step;
# its logits drift most of the seven families in phase 7, too)
TRAIN_TOL = {"loss": 1e-5, "grad": 1e-4, "grad_ssd": 5e-4}
# Card vs CPU on the LM path (phase 7): float32 logits within 1e-4.
LM_CHECK_TOL = 1e-4
#: the kernels of training's backward (no TPU counterpart)
BACKWARD_KERNELS = ("flash_attention_bwd_sm90", "flash_attention_bwd_f32_sm90", "wkv6_bwd")


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


def device_ms(torch, fn, kernel_key: str, reps: int, per_call: bool = False) -> float:
    """Mean device time of one launch of the kernel whose name holds
    ``kernel_key``, from ``torch.profiler`` over ``reps`` calls of ``fn``:
    the kernel alone, where ``cuda_ms`` also sees the host time of a
    wrapper that cannot keep the card busy.  With ``per_call``, the time of
    one call of a wrapper that launches several such kernels, once each:
    the sum of each kernel's mean launch, which a session that loses a
    first device event (section 7 of PERF.md) does not skew."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # A profiler session now and then records no device events at all;
    # the measurement is taken again, up to PROFILE_TRIES sessions.
    for attempt in range(1, PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        hits = [(ms, n) for key, (ms, n) in device_busy(prof)[1].items() if kernel_key in key]
        if hits and per_call:
            return sum(ms / n for ms, n in hits)
        if hits:
            return sum(ms for ms, _ in hits) / sum(n for _, n in hits)
        log(f"  profiler session {attempt} of {PROFILE_TRIES} saw no {kernel_key} kernel")
    raise AssertionError(f"the profiler saw no {kernel_key} kernel in {PROFILE_TRIES} sessions")


def bound_ms(nbytes: float, nops: float, peak_ops: float = PEAK_OPS_PER_S):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = nops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(torch, got, want) -> float:
    if got.numel() == 0:
        return 0.0
    return float((got.to(torch.float64) - want.to(torch.float64)).abs().max())


# ----------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ----------------------------------------------------------------------
def check_segment_sum(torch, seg, values, ids, m, label, quiet: bool = False,
                      signed: bool = False):
    got = seg.segment_sum_cuda(values, ids, m)
    want = seg.segment_sum_plain(values, ids, m)
    torch.cuda.synchronize()
    err = max_abs_err(torch, got, want)
    if values.dtype == torch.int64:
        ok = torch.equal(got, want)
        tol = "exact"
    else:
        rtol = RTOL[str(values.dtype).replace("torch.", "")]
        terms = seg.segment_sum_plain(values.abs(), ids, m) if signed else want
        scale = float(terms.abs().max()) if want.numel() else 0.0
        ok = err <= rtol * max(scale, 1.0)
        tol = f"rtol {rtol} of {'sum |value|' if signed else 'the result'}"
    if not quiet or not ok:
        log(f"  segment_sum {label}: n={values.numel()} m={m} {values.dtype} "
            f"path {seg.segment_path(m)} max_abs_err={err!r} ({tol}) "
            f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"segment_sum kernel disagrees with its plain version at {label}")
    return err


def segment_ids(rng, n: int, m: int, order: str) -> np.ndarray:
    """n ids for m segments, -1 and m among them (both dropped): at random,
    sorted, or in runs of 1 to 7 equal ids (as lineitem's order keys)."""
    if order == "runs":
        starts = np.sort(rng.integers(-1, m + 1, n // 2 + 2))  # 2n ids on average
        return np.repeat(starts, rng.integers(1, 8, starts.size))[:n]
    ids = rng.integers(-1, m + 1, n)
    return np.sort(ids) if order == "sorted" else ids


def check_substr_find(torch, sf, packed, lens, pat, start, label, quiet: bool = False):
    got = sf.substr_find_cuda(packed, lens, pat, start)
    want = sf.substr_find_plain(packed, lens, pat, start)
    torch.cuda.synchronize()
    ok = torch.equal(got, want)
    if not quiet or not ok:
        log(f"  substr_find {label}: n={packed.shape[0]} L={packed.shape[1]} m={pat.numel()} "
            f"start={'yes' if start is not None else 'no'} exact {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"substr_find kernel disagrees with its plain version at {label}")
    return got


def check_exists_before(torch, sf, packed, lens, pat_a, pat_b, label):
    got = sf.exists_before_cuda(packed, lens, pat_a, pat_b)
    want = sf.exists_before_plain(packed, lens, pat_a, pat_b)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(
            f"exists_before kernel disagrees with its plain version at {label}: n={packed.shape[0]} "
            f"L={packed.shape[1]} m_a={pat_a.numel()} m_b={pat_b.numel()}")
    return got


def substr_rows(torch, rng, dev, n: int, L: int, offset: int, pat_a: bytes, pat_b: bytes):
    """n rows of L bytes whose first byte lies ``offset`` bytes past the
    start of a fresh allocation (so past a 16-byte boundary), from an
    alphabet with NUL and bytes >= 0x80; lengths 0 to L with -1, 0, L and
    L + 3 among them; bytes past a row's length random, or NUL as packing
    leaves them.  Some rows hold ``pat_a`` at the very end of their length,
    or ``pat_a`` first and ``pat_b`` at the end, or "aaab"."""
    flat = SUBSTR_ALPHABET[rng.integers(0, SUBSTR_ALPHABET.size, offset + n * L)]
    rows = flat[offset:].reshape(n, L)
    lens = rng.integers(0, L + 1, n).astype(np.int32)
    lens[:4] = (-1, 0, L, L + 3)[: min(4, n)]
    a, b = np.frombuffer(pat_a, np.uint8), np.frombuffer(pat_b, np.uint8)
    for r in range(n):
        e = int(min(max(lens[r], 0), L))
        kind = r % 5
        if kind == 1 and a.size <= e:
            rows[r, e - a.size:e] = a
        elif kind == 2 and a.size + b.size <= e:
            rows[r, :a.size] = a
            rows[r, e - b.size:e] = b
        elif kind == 3 and e >= 4:
            rows[r, :4] = np.frombuffer(b"aaab", np.uint8)
        elif kind == 4:
            rows[r, e:] = 0
    buf = torch.as_tensor(flat, device=dev)
    return buf[offset:].view(n, L), torch.as_tensor(lens, device=dev)


def substr_edge_phase(torch, sf, dev) -> None:
    """K2's find (without and with per-row starts from -3 to L + 3) and
    fused exists_before against their plain versions, exactly, at each L
    of SUBSTR_EDGE_L, base pointers 0 to 15 bytes past a 16-byte boundary
    and pattern lengths SUBSTR_EDGE_M (and L): random patterns, a
    self-overlapping one ("aa...ab"), a == b, b before a, empty patterns
    and patterns longer than L."""
    log("phase 2a: edge shapes of substr_find and exists_before (K2)")
    rng = np.random.default_rng(11)

    def pat(raw: bytes):
        return torch.tensor(list(raw), dtype=torch.uint8, device=dev)

    def rand_pat(m: int) -> bytes:
        return SUBSTR_ALPHABET[rng.integers(0, SUBSTR_ALPHABET.size, m)].tobytes()

    n = SUBSTR_EDGE_ROWS
    for L in SUBSTR_EDGE_L:
        cases = 0
        for offset in range(16):
            for m in sorted({m for m in SUBSTR_EDGE_M if m <= L} | {L}):
                raw_a, raw_b = rand_pat(m), rand_pat(max(1, m // 2))
                packed, lens = substr_rows(torch, rng, dev, n, L, offset, raw_a, raw_b)
                start = torch.as_tensor(rng.integers(-3, L + 4, n).astype(np.int32), device=dev)
                a, b, ovl = pat(raw_a), pat(raw_b), pat(b"a" * (m - 1) + b"b")
                label = f"edge L={L} offset={offset} m={m}"
                for p in (a, ovl):
                    for st in (None, start):
                        check_substr_find(torch, sf, packed, lens, p, st, label, quiet=True)
                for x, y in ((a, b), (a, a), (ovl, b), (b, a)):
                    check_exists_before(torch, sf, packed, lens, x, y, label)
                cases += 8
            empty, long_ = pat(b""), pat(b"x" * (L + 1))
            label = f"edge L={L} offset={offset} empty or longer than L"
            for p in (empty, long_):
                check_substr_find(torch, sf, packed, lens, p, start, label, quiet=True)
            for x, y in ((empty, b), (a, empty), (empty, empty), (long_, b), (a, long_), (empty, long_)):
                check_exists_before(torch, sf, packed, lens, x, y, label)
            cases += 8
        log(f"  L={L}: {cases} cases over offsets 0..15 exact ok")
    # many rows a warp: the persistent loop over several steps
    packed, lens = substr_rows(torch, rng, dev, 300_007, 37, 5, b"special", b"requests")
    start = torch.as_tensor(rng.integers(-3, 41, packed.shape[0]).astype(np.int32), device=dev)
    for st in (None, start):
        check_substr_find(torch, sf, packed, lens, pat(b"special"), st, "300,007 rows, L=37, offset 5")
    check_exists_before(torch, sf, packed, lens, pat(b"special"), pat(b"requests"),
                        "300,007 rows, L=37, offset 5")
    log("  exists_before 300,007 rows, L=37, offset 5: exact ok")


def edge_phase(torch, seg, sf, dev) -> None:
    log("phase 2a: edge shapes (segment_sum: each (dtype, m) over lengths, id orders "
        "and offsets of the two pointers)")
    rng = np.random.default_rng(7)
    for dtype in (torch.float32, torch.float64, torch.int64):
        # the bounds of the few (<= 16), mid (<= 4096) and many paths
        for m in (1, 2, 6, 15, 16, 17, 4096, 4097, 1_500_000):
            lengths = [1, 2, 31, 33, 1001, 3 * 4096 + 5, 200_003]
            if m == 1_500_000:
                lengths.append(3_000_001)
            worst, cases = 0.0, 0
            for n in lengths:
                for order in ("unsorted", "sorted", "runs"):
                    ids = segment_ids(rng, n + 1, m, order)
                    n_ids = ids.size
                    if dtype == torch.int64:
                        vals = rng.integers(-(1 << 40), 1 << 40, n_ids)
                    else:
                        vals = rng.normal(size=n_ids) * 1e3
                    v = torch.as_tensor(vals, device=dev).to(dtype)
                    g = torch.as_tensor(ids, dtype=torch.int64, device=dev)
                    # aligned, both pointers one row on, only the values one row on
                    for vs, gs in ((slice(0, n_ids - 1), slice(0, n_ids - 1)),
                                   (slice(1, None), slice(1, None)),
                                   (slice(1, None), slice(0, n_ids - 1))):
                        if v[vs].numel() == 0:
                            continue
                        err = check_segment_sum(torch, seg, v[vs], g[gs], m,
                                                f"edge n={n} {order}", quiet=True,
                                                signed=True)
                        worst, cases = max(worst, err), cases + 1
            log(f"  segment_sum {dtype} m={m} path {seg.segment_path(m)}: {cases} cases, "
                f"max_abs_err={worst!r} ok")
    empty = seg.segment_sum_cuda(
        torch.zeros(0, dtype=torch.float64, device=dev), torch.zeros(0, dtype=torch.int64, device=dev), 5
    )
    if not torch.equal(empty, torch.zeros(5, dtype=torch.float64, device=dev)):
        raise AssertionError("segment_sum of no rows must be zeros")

    substr_edge_phase(torch, sf, dev)


def check_hash32x2(torch, cols, label):
    from repro_torch.kernels.hash32x2 import hash32x2_cuda, hash32x2_plain

    got = hash32x2_cuda(cols)
    want = hash32x2_plain(cols)
    torch.cuda.synchronize()
    # uint32 has few operators on the card: compare the bits as int32
    ok = got.shape == want.shape and torch.equal(got.view(torch.int32), want.view(torch.int32))
    log(f"  hash32x2 {label}: cols {tuple(cols.shape)} {cols.dtype} bit for bit "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"hash32x2 kernel disagrees with its plain version at {label}")


def hash_edge_phase(torch, dev) -> None:
    log("phase 2a: edge shapes of hash32x2 (K3)")
    rng = np.random.default_rng(13)
    # the JAX test's shapes, no rows, no columns, a length that is no
    # multiple of any block, rows too wide to stage in shared memory
    shapes = [(n, k) for n in (1, 7, 1024, 3000) for k in (1, 2, 5)]
    shapes += [(0, 2), (5, 0), (1_000_003, 2), (999, 40)]
    for n, k in shapes:
        cols = torch.as_tensor(rng.integers(0, 2**31, (n, k)).astype(np.int32), device=dev)
        check_hash32x2(torch, cols, "edge")
    bits = rng.integers(2**31, 2**32, (4099, 3), dtype=np.uint64).astype(np.uint32)
    for dtype in (torch.uint32, torch.int32):  # >= 2^31 as uint32; negative as int32
        check_hash32x2(torch, torch.as_tensor(bits.view(np.int32), device=dev).view(dtype),
                       "high bit set")


def substr_row(torch, sf, label, packed, lens, pat_a, pat_b=None) -> dict:
    """K2 at one main-path shape: the find of ``pat_a``, or with ``pat_b``
    the fused exists_before, checked exactly against its plain version and
    timed; the bound counts each row's bytes up to its scan end (the end
    of the first match, or its length; for exists_before the later of the
    two searches' ends), its length read and its result written."""
    n, L = packed.shape
    ma = pat_a.numel()
    end = torch.clamp(lens, 0, L).to(torch.int64)
    if pat_b is None:
        got = check_substr_find(torch, sf, packed, lens, pat_a, None, label)
        scan_end = torch.where(got >= 0, got.to(torch.int64) + ma, end)
        nbytes = int(scan_end.sum()) + n * (4 + 4)
        call = lambda: sf.substr_find_cuda(packed, lens, pat_a)
        plain = lambda: sf.substr_find_plain(packed, lens, pat_a)
        key = "substr_find_rows"
    else:
        check_exists_before(torch, sf, packed, lens, pat_a, pat_b, label)
        fa = sf.substr_find_plain(packed, lens, pat_a)
        start = torch.where(fa >= 0, fa + ma, 0).to(torch.int32)
        fb = sf.substr_find_plain(packed, lens, pat_b, start)
        scan_end = torch.where((fa >= 0) & (fb >= 0), fb.to(torch.int64) + pat_b.numel(), end)
        nbytes = int(scan_end.sum()) + n * (4 + 1)
        call = lambda: sf.exists_before_cuda(packed, lens, pat_a, pat_b)
        plain = lambda: sf.exists_before_plain(packed, lens, pat_a, pat_b)
        key = "exists_before_rows"
    b_ms, b_by = bound_ms(nbytes, int(scan_end.sum()))
    row = dict(label=label, n=n, L=L, max_abs_err=0.0, ms=cuda_ms(torch, call, REPS),
               device_ms=device_ms(torch, call, key, REPS), plain_ms=cuda_ms(torch, plain, REPS),
               library_ms=None, bound_ms=b_ms, bound_by=b_by)
    log("   ", json.dumps(row))
    return row


def segment_row(torch, seg, dev, label, v, g, m) -> dict:
    """K1 at one main-path shape: checked against its plain version and
    timed, beside ``index_add_``; the bound reads each value and id once
    and writes each sum once."""
    err = check_segment_sum(torch, seg, v, g, m, label)
    k_ms = cuda_ms(torch, lambda: seg.segment_sum_cuda(v, g, m), REPS)
    d_ms = device_ms(torch, lambda: seg.segment_sum_cuda(v, g, m), "segment_sum_", REPS)
    p_ms = cuda_ms(torch, lambda: seg.segment_sum_plain(v, g, m), REPS)
    l_ms = cuda_ms(
        torch, lambda: torch.zeros(m, dtype=v.dtype, device=dev).index_add_(0, g, v), REPS
    )
    nbytes = v.numel() * (v.element_size() + 8) + m * v.element_size()
    b_ms, b_by = bound_ms(nbytes, v.numel())
    row = dict(label=label, n=v.numel(), m=m, dtype=str(v.dtype), path=seg.segment_path(m),
               max_abs_err=err, ms=k_ms, device_ms=d_ms, plain_ms=p_ms, library_ms=l_ms,
               bound_ms=b_ms, bound_by=b_by)
    log("   ", json.dumps(row))
    return row


def mid_path_rows(torch, seg, ops, QF, frames, sf: float, dev) -> list:
    """K1's mid path (17 to 4096 groups) at main-path shapes: one pass of
    the queries records the inputs of every mid-path call by query; the
    largest call of the query with the most of them is timed, and the
    largest call of the pass where that is another."""
    calls: dict = {}
    real = ops.segment_sum_cuda
    current = [None]

    def recording(values, ids, m):
        if seg.segment_path(m) == "mid":
            calls.setdefault(current[0], []).append((values.clone(), ids.clone(), m))
        return real(values, ids, m)

    ops.segment_sum_cuda = recording
    try:
        for q in sorted(QF.ALL, key=lambda s: int(s[1:])):
            current[0] = q
            QF.ALL[q](frames, sf=sf, apply_limit=False)
    finally:
        ops.segment_sum_cuda = real
    torch.cuda.synchronize()
    log(f"  segment_sum mid-path calls by query: "
        f"{json.dumps({q: [(c[0].numel(), c[2]) for c in cs] for q, cs in calls.items()})}")
    if not calls:
        raise AssertionError("no query took the segment sum's mid path")
    most = max(calls, key=lambda q: (len(calls[q]), max(c[0].numel() for c in calls[q])))
    largest = max(calls, key=lambda q: max(c[0].numel() for c in calls[q]))
    rows = []
    for q in dict.fromkeys((most, largest)):
        v, g, m = max(calls[q], key=lambda c: c[0].numel())
        rows.append(segment_row(torch, seg, dev, f"{q}: its largest mid-path sum ({v.dtype})",
                                v, g, m))
    return rows


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
    seg_rows = [segment_row(torch, seg, dev, label, v, g, m) for label, v, g, m in cases]
    out["segment_sum"] = seg_rows

    # K2: each string predicate of the main path on the dictionary it
    # runs on, packed as the dictionary-LUT path packs it: q13's find of
    # "special" (K2's main row) and its whole exists_before, q9's
    # contains("green"), q16's exists_before
    def packed_dictionary(table, column):
        dic = col(column).eval(frames[table]).dictionary
        return strings.pack_strings_cached(dic, CONFIG.max_packed_len, dev)

    def pat(raw: bytes):
        return torch.tensor(list(raw), dtype=torch.uint8, device=dev)

    q13 = packed_dictionary("orders", "o_comment")
    q9 = packed_dictionary("part", "p_name")
    q16 = packed_dictionary("supplier", "s_comment")
    fa = check_substr_find(torch, sf, *q13, pat(b"special"), None, "q13 'special'")
    start = torch.where(fa >= 0, fa + len(b"special"), 0).to(torch.int32)
    check_substr_find(torch, sf, *q13, pat(b"requests"), start, "q13 'requests' after it")
    find_rows = [
        substr_row(torch, sf, "q13 o_comment dictionary find 'special'", *q13, pat(b"special")),
        substr_row(torch, sf, "q13 o_comment dictionary exists_before('special', 'requests')",
                   *q13, pat(b"special"), pat(b"requests")),
        substr_row(torch, sf, "q9 p_name dictionary find 'green'", *q9, pat(b"green")),
        substr_row(torch, sf, "q16 s_comment dictionary exists_before('Customer', 'Complaints')",
                   *q16, pat(b"Customer"), pat(b"Complaints")),
    ]
    out["substr_find"] = find_rows

    # K3: lineitem's composite key, the tuple a hash partition of it hashes.
    # No path of the engine calls K3 (it routes rows with splitmix64), so
    # its launches are those of one call of the op, ops.hash32x2.
    from repro_torch.kernels import ops
    from repro_torch.kernels.hash32x2 import hash32x2_cuda, hash32x2_plain

    keys = torch.stack([li.col_values(c).to(torch.int32)
                        for c in ("l_orderkey", "l_linenumber")], dim=1).contiguous()
    label = "lineitem (l_orderkey, l_linenumber) as int32"
    check_hash32x2(torch, keys, label)
    ops.reset_launches()
    ops.hash32x2(keys)
    launches = ops.LAUNCHES["hash32x2"]
    k_ms = cuda_ms(torch, lambda: hash32x2_cuda(keys), REPS)
    d_ms = device_ms(torch, lambda: hash32x2_cuda(keys), "hash32x2_kernel", REPS)
    p_ms = cuda_ms(torch, lambda: hash32x2_plain(keys), REPS)
    n, k = keys.shape
    nbytes = 4 * n * k + 8 * n  # columns read once, two uint32 lanes written
    b_ms, b_by = bound_ms(nbytes, 2 * n * k * 20)  # about 20 integer ops per column and lane
    row = dict(label=f"{label}: {n} x {k}", max_abs_err=0.0, ms=k_ms, device_ms=d_ms,
               plain_ms=p_ms, library_ms=None, bound_ms=b_ms, bound_by=b_by,
               launches=launches)
    log("   ", json.dumps(row))
    out["hash32x2"] = [row]
    return out


# ----------------------------------------------------------------------
# phase 2, K4 and K5: edge shapes, and the LM path's shapes
# ----------------------------------------------------------------------
def allclose_err(torch, got, want, tol: float):
    """(max abs error, whether |got - want| <= tol + tol * |want|)."""
    g, w = got.to(torch.float64), want.to(torch.float64)
    return max_abs_err(torch, g, w), bool(((g - w).abs() <= tol + tol * w.abs()).all())


def check_attention(torch, q, k, v, causal: bool, label: str) -> float:
    """``flash_attention_cuda`` (the tensor-core kernel of q's dtype: bf16,
    or float32 in split TF32) against the plain version; the launch counts
    must show which kernel ran."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import (
        FWD_KERNELS, flash_attention_cuda, flash_attention_plain,
    )

    name = FWD_KERNELS[q.dtype]
    before = dict(build.LAUNCHES)
    got = flash_attention_cuda(q, k, v, causal)
    ran = [n for n in build.LAUNCHES if build.LAUNCHES[n] != before[n]]
    want = flash_attention_plain(q, k, v, causal)
    torch.cuda.synchronize()
    tol = ATTN_TOL[str(q.dtype).replace("torch.", "")]
    err, ok = allclose_err(torch, got, want, tol)
    log(f"  {name} {label}: q {tuple(q.shape)} k {tuple(k.shape)} {q.dtype} "
        f"causal={causal} max_abs_err={err!r} (tol {tol}) {'ok' if ok else 'MISMATCH'}")
    if ran != [name]:
        raise AssertionError(f"{label}: {q.dtype} attention launched {ran}, wants [{name}]")
    if not ok:
        raise AssertionError(f"{name} kernel disagrees with its plain version at {label}")
    return err


def check_wkv6(torch, args, label: str) -> float:
    from repro_torch.kernels.wkv6 import wkv6_cuda, wkv6_plain

    y, s = wkv6_cuda(*args)
    y_want, s_want = wkv6_plain(*args)
    torch.cuda.synchronize()
    tol = WKV6_TOL[str(args[0].dtype).replace("torch.", "")]
    err_y, ok_y = allclose_err(torch, y, y_want, tol)
    err_s, ok_s = allclose_err(torch, s, s_want, tol)
    log(f"  wkv6 {label}: r {tuple(args[0].shape)} {args[0].dtype} "
        f"state={'yes' if args[5] is not None else 'no'} max_abs_err y={err_y!r} "
        f"state={err_s!r} (tol {tol}) {'ok' if ok_y and ok_s else 'MISMATCH'}")
    if not (ok_y and ok_s):
        raise AssertionError(f"wkv6 kernel disagrees with its plain version at {label}")
    return max(err_y, err_s)


def wkv6_inputs(torch, rng, dev, dtype, B, H, T, D, with_state: bool, strided: bool = False,
                w_low=None):
    """r, k, v, w (B, H, T, D), u, and a float32 state or None; with
    ``strided`` r/k/v/w are (B, H, T, D) views of (B, T, H, D) tensors, as
    the model hands them over; w uniform in [0.7, 0.999), or with ``w_low``
    log-uniform in [w_low, 0.999)."""
    def normal(*shape, scale=1.0):
        return torch.as_tensor(rng.normal(size=shape) * scale, device=dev)

    def heads(x):
        return x.transpose(1, 2) if strided else x

    shape = (B, T, H, D) if strided else (B, H, T, D)
    r, k, v = (heads(normal(*shape, scale=0.5).to(dtype)) for _ in range(3))
    w = (rng.uniform(0.7, 0.999, shape) if w_low is None
         else np.exp(rng.uniform(np.log(w_low), np.log(0.999), shape)))
    w = heads(torch.as_tensor(w, device=dev).to(dtype))
    u = normal(H, D, scale=0.1).to(dtype)
    s0 = normal(B, H, D, D).float() if with_state else None
    return [r, k, v, w, u, s0]


def check_wkv6_in_place(torch, rng, dev, dtype, B, H, T, D) -> float:
    """K5 on strided inputs with ``state_out``: aliased to the state (the
    decode step's form) and a separate buffer, against the plain version
    on the same inputs; the state passed without ``state_out`` is left
    as it was."""
    from repro_torch.kernels.wkv6 import wkv6_cuda, wkv6_plain

    r, k, v, w, u, s0 = wkv6_inputs(torch, rng, dev, dtype, B, H, T, D, True, strided=True)
    tol = WKV6_TOL[str(dtype).replace("torch.", "")]
    y_want, s_want = wkv6_plain(r, k, v, w, u, s0)
    kept = s0.clone()
    y_pure, s_pure = wkv6_cuda(r, k, v, w, u, s0)
    alias = s0.clone()
    y_alias, s_alias = wkv6_cuda(r, k, v, w, u, alias, state_out=alias)
    other = torch.full_like(s0, float("nan"))
    _, s_other = wkv6_cuda(r, k, v, w, u, s0, state_out=other)
    torch.cuda.synchronize()
    errs, ok = [], torch.equal(s0, kept) and s_alias is alias and s_other is other
    for got, want in ((y_pure, y_want), (s_pure, s_want), (y_alias, y_want),
                      (s_alias, s_want), (s_other, s_want)):
        err, fine = allclose_err(torch, got, want, tol)
        errs.append(err)
        ok = ok and fine
    log(f"  wkv6 strided, state_out aliased and apart: r {tuple(r.shape)} strides "
        f"{r.stride()} {dtype} max_abs_err={max(errs)!r} (tol {tol}) "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError("wkv6 kernel with strided inputs or state_out disagrees")
    return max(errs)


def lm_edge_phase(torch, dev) -> None:
    from repro_torch.kernels.wkv6 import wkv6_cuda

    log("phase 2a: edge shapes of flash_attention (K4: bf16, and f32 in split TF32, on the "
        "tensor cores) and wkv6 (K5)")
    rng = np.random.default_rng(11)
    for dtype in (torch.float32, torch.bfloat16):
        # (B, Hq, Hkv, Sq, Sk, D): ragged lengths around the 64- and 128-row
        # tiles, Sq < Sk, D 16..128 (D < 64 and D % 64 != 0 are padded by
        # the tensor-core kernel), groups 1, 2, 5; q strided as the model
        # hands it over
        for B, Hq, Hkv, Sq, Sk, D in [(2, 2, 2, 100, 100, 16), (1, 4, 2, 37, 200, 64),
                                      (1, 10, 2, 130, 130, 96), (1, 5, 1, 1, 77, 128),
                                      (2, 40, 8, 64, 64, 128), (1, 4, 4, 257, 300, 64),
                                      (1, 2, 2, 127, 127, 80), (1, 4, 2, 129, 129, 112),
                                      (2, 5, 1, 200, 200, 48), (1, 10, 2, 37, 129, 128),
                                      (1, 2, 1, 1, 1, 16), (1, 4, 4, 129, 200, 32),
                                      (1, 5, 5, 127, 300, 96),
                                      # non-causal Sq > Sk (cross-attention), and
                                      # kimi-k2's (group 8, D 112) and zamba2's
                                      # (group 1, D 80) heads at ragged lengths
                                      (1, 8, 1, 300, 130, 128), (1, 4, 4, 129, 37, 112),
                                      (1, 16, 2, 131, 131, 112), (2, 8, 1, 77, 200, 112),
                                      (1, 3, 3, 257, 257, 80), (1, 4, 4, 65, 190, 80)]:
            q = torch.as_tensor(rng.normal(size=(B, Sq, Hq, D)), device=dev).to(dtype)
            k = torch.as_tensor(rng.normal(size=(B, Hkv, Sk, D)), device=dev).to(dtype)
            v = torch.as_tensor(rng.normal(size=(B, Hkv, Sk, D)), device=dev).to(dtype)
            for causal in ((True, False) if Sq <= Sk else (False,)):
                check_attention(torch, q.transpose(1, 2), k, v, causal, "edge")
        for B, H, T, D in [(1, 2, 1, 16), (3, 5, 7, 64), (2, 4, 64, 64), (1, 2, 7, 128)]:
            for with_state in (False, True):
                args = wkv6_inputs(torch, rng, dev, dtype, B, H, T, D, with_state)
                check_wkv6(torch, args, "edge")
        # the model's form: strided (B, H, T, D) views of (B, T, H, D), the
        # final state written over the initial one, and into another buffer
        for B, H, T, D in [(1, 2, 1, 16), (4, 64, 1, 64), (3, 5, 7, 64), (2, 4, 64, 64),
                           (1, 2, 7, 128)]:
            check_wkv6_in_place(torch, rng, dev, dtype, B, H, T, D)
        # state chaining: two calls through the carried state equal one
        r, k, v, w, u, _ = wkv6_inputs(torch, rng, dev, dtype, 2, 4, 64, 64, False)
        y, s = wkv6_cuda(r, k, v, w, u)
        h = 23
        part = lambda t, sl: t[:, :, sl].contiguous()
        y1, s1 = wkv6_cuda(*(part(t, slice(0, h)) for t in (r, k, v, w)), u)
        y2, s2 = wkv6_cuda(*(part(t, slice(h, None)) for t in (r, k, v, w)), u, s1)
        tol = WKV6_TOL[str(dtype).replace("torch.", "")]
        err_y, ok_y = allclose_err(torch, torch.cat([y1, y2], 2), y, tol)
        err_s, ok_s = allclose_err(torch, s2, s, tol)
        log(f"  wkv6 chained 23 + 41 steps vs 64 in one call, {dtype}: max_abs_err "
            f"y={err_y!r} state={err_s!r} {'ok' if ok_y and ok_s else 'MISMATCH'}")
        if not (ok_y and ok_s):
            raise AssertionError("wkv6 kernel: two chained calls differ from one")


# The backward kernels against their plain versions on the same inputs:
# the largest error of each gradient relative to the largest |plain
# gradient| (K4: the largest of dq, dk and dv, whose terms share one scale:
# with one key dq and dk are 0 up to rounding; float32: sums in another
# order; bf16: the gradients' own rounding to bf16), and the forward kernels' log-sum-exp within LSE_TOL
# (abs and rel: float32 sums in another order, ex2.approx on the tensor
# cores).  The card's autograd against the CPU's: float32, FN_TOL.
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
#: (B, Hq, Hkv, Sq, Sk, D) of the float32 kernels' long-key check
LONG_KEYS = (1, 5, 1, 192, 32768, 128)
LSE_TOL = 1e-4
FN_TOL = 1e-4


def rel_err(torch, got, want) -> float:
    """Largest |got - want| over the largest |want|."""
    scale = float(want.to(torch.float64).abs().max()) if want.numel() else 0.0
    return max_abs_err(torch, got, want) / (scale or 1.0)


def check_attention_bwd(torch, rng, q, k, v, causal: bool, label: str) -> float:
    """K4's backward kernel of q's dtype (bf16: ``flash_attention_bwd_sm90``;
    float32: ``flash_attention_bwd_f32_sm90``, split TF32; both on the
    tensor cores) on the forward kernel's o and log-sum-exp and
    a random dO, against the plain backward on the same inputs; twice, to
    show the result repeats bit for bit (no atomics), and only that
    kernel launched."""
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import (
        BWD_KERNELS, attention_lse_plain, flash_attention_bwd_cuda, flash_attention_bwd_plain,
        flash_attention_fwd_cuda,
    )

    name = BWD_KERNELS[q.dtype]
    o, lse = flash_attention_fwd_cuda(q, k, v, causal)
    lse_err, lse_ok = allclose_err(torch, lse, attention_lse_plain(q, k, causal), LSE_TOL)
    do = torch.as_tensor(rng.normal(size=tuple(o.shape)), device=q.device).to(q.dtype)
    before = dict(build.LAUNCHES)
    got = flash_attention_bwd_cuda(q, k, v, o, lse, do, causal)
    again = flash_attention_bwd_cuda(q, k, v, o, lse, do, causal)
    launched = {n: c - before[n] for n, c in build.LAUNCHES.items() if c != before[n]}
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    tol = BWD_TOL[str(q.dtype).replace("torch.", "")]
    scale = max(float(w.to(torch.float64).abs().max()) for w in want) or 1.0
    errs = [max_abs_err(torch, g, w) / scale for g, w in zip(got, want)]
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    ok = max(errs) <= tol and lse_ok and same and launched == {name: 2}
    log(f"  {name} {label}: q {tuple(q.shape)} k {tuple(k.shape)} {q.dtype} "
        f"causal={causal} rel err dq/dk/dv {errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e} (tol {tol}), "
        f"lse max_abs_err {lse_err:.3e} (tol {LSE_TOL}), repeats={same} "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"{name} kernel disagrees with its plain version at {label} "
                             f"(launches {launched})")
    return max(errs)


def check_wkv6_bwd(torch, rng, args, label: str, with_dstate: bool) -> float:
    """K5's backward kernel against the plain reverse recurrence on the same
    inputs and a random dy (and gradient of the final state): all six
    gradients; twice, to show the result repeats bit for bit."""
    from repro_torch.kernels.wkv6 import wkv6_bwd_cuda, wkv6_bwd_plain

    r, k, v, w, u, s0 = args
    dev = r.device
    dy = torch.as_tensor(rng.normal(size=tuple(r.shape)), device=dev).to(r.dtype)
    B, H, _, D = r.shape
    dst = (torch.as_tensor(rng.normal(size=(B, H, D, D)), device=dev).float()
           if with_dstate else None)
    got = wkv6_bwd_cuda(r, k, v, w, u, s0, dy, dst)
    again = wkv6_bwd_cuda(r, k, v, w, u, s0, dy, dst)
    want = wkv6_bwd_plain(r, k, v, w, u, s0, dy, dst)
    torch.cuda.synchronize()
    tol = BWD_TOL[str(r.dtype).replace("torch.", "")]
    names = ("dr", "dk", "dv", "dw", "du", "ds0")
    errs = [rel_err(torch, g, w_) for g, w_ in zip(got, want)]
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    ok = max(errs) <= tol and same
    log(f"  wkv6_bwd {label}: r {tuple(r.shape)} strides {r.stride()} {r.dtype} "
        f"min w {float(w.min()):.3g} state={'yes' if s0 is not None else 'no'} "
        f"dstate={'yes' if with_dstate else 'no'} "
        + " ".join(f"{n} {e:.3e}" for n, e in zip(names, errs))
        + f" (rel, tol {tol}) repeats={same} {'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError(f"wkv6_bwd kernel disagrees with its plain version at {label}")
    return max(errs)


def check_autograd_functions(torch, rng, dev) -> None:
    """ops.flash_attention and ops.wkv6 on CUDA inputs that require a
    gradient: one forward and one backward launch each, gradients equal to
    the CPU's autograd of the plain versions within FN_TOL (float32); and
    the bare kernel wrappers refuse such inputs."""
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.wkv6 import wkv6_cuda

    def both(*shape, low=None):
        a = rng.uniform(low, 0.999, shape) if low is not None else rng.normal(size=shape) * 0.5
        cpu = torch.as_tensor(a, dtype=torch.float32).requires_grad_()
        return cpu, cpu.detach().to(dev).requires_grad_()

    def compare(name, fn, inputs, kernels):
        cpu_in, dev_in = zip(*inputs)
        ops.reset_launches()
        outs = fn(*dev_in)
        outs = outs if isinstance(outs, tuple) else (outs,)
        grads_out = [torch.as_tensor(rng.normal(size=tuple(o.shape)), dtype=torch.float32)
                     for o in outs]
        got = torch.autograd.grad(outs, dev_in, [g.to(dev) for g in grads_out])
        launched = {n: build.LAUNCHES[n] for n in kernels}
        want = torch.autograd.grad(fn(*cpu_in), cpu_in, grads_out)
        errs = [rel_err(torch, g.cpu(), w) for g, w in zip(got, want)]
        ok = max(errs) <= FN_TOL and all(n == 1 for n in launched.values())
        log(f"  {name} on the card with autograd: launches {launched}, gradients rel err "
            f"{max(errs):.3e} (tol {FN_TOL}) {'ok' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"{name}: the card's gradients disagree with the CPU's")

    q, k, v = both(2, 10, 77, 64), both(2, 2, 77, 64), both(2, 2, 77, 64)
    compare("ops.flash_attention", lambda *t: ops.flash_attention(*t, causal=True), [q, k, v],
            ("flash_attention_f32_sm90", "flash_attention_bwd_f32_sm90"))
    r, kk, vv = (both(2, 3, 21, 32) for _ in range(3))
    w, u, s0 = both(2, 3, 21, 32, low=0.7), both(3, 32), both(2, 3, 32, 32)
    compare("ops.wkv6", ops.wkv6, [r, kk, vv, w, u, s0], ("wkv6", "wkv6_bwd"))
    for name, call in (
        ("flash_attention_cuda", lambda: flash_attention_cuda(q[1], k[1], v[1], True)),
        ("wkv6_cuda", lambda: wkv6_cuda(r[1], kk[1], vv[1], w[1], u[1], s0[1])),
        ("ops.wkv6 with state_out", lambda: ops.wkv6(r[1], kk[1], vv[1], w[1], u[1], s0[1],
                                                       state_out=torch.empty_like(s0[1]))),
    ):
        try:
            call()
        except (RuntimeError, ValueError) as e:
            log(f"  {name} refuses inputs that want a gradient: {str(e)[:80]}")
            continue
        raise AssertionError(f"{name} took inputs that want a gradient")


def bwd_edge_phase(torch, dev) -> None:
    log("phase 2a: edge shapes of the backward kernels (K4: flash_attention_bwd_sm90 for bf16, "
        "flash_attention_bwd_f32_sm90 for f32, on the forward kernels' log-sum-exp; K5: "
        "wkv6_bwd), and the autograd Functions")
    rng = np.random.default_rng(13)
    for dtype in (torch.float32, torch.bfloat16):
        # (B, Hq, Hkv, Sq, Sk, D): head dims 16 to 128, groups 1, 5 and 8,
        # Sq != Sk, ragged tiles, q strided as the model hands it over
        for B, Hq, Hkv, Sq, Sk, D in [(1, 5, 1, 100, 100, 16), (2, 8, 1, 37, 200, 64),
                                      (1, 10, 2, 130, 130, 128), (1, 4, 4, 65, 190, 80),
                                      (1, 5, 5, 127, 300, 96), (1, 8, 8, 129, 129, 112),
                                      (1, 16, 2, 300, 130, 128), (1, 2, 2, 1, 1, 32),
                                      (2, 5, 1, 64, 64, 48), (1, 8, 1, 200, 77, 112),
                                      # several key and query tiles, the causal
                                      # offset across them, Qwen3-14B's heads
                                      (1, 40, 8, 257, 513, 128), (1, 5, 1, 600, 600, 64)]:
            q = torch.as_tensor(rng.normal(size=(B, Sq, Hq, D)), device=dev).to(dtype)
            k = torch.as_tensor(rng.normal(size=(B, Hkv, Sk, D)), device=dev).to(dtype)
            v = torch.as_tensor(rng.normal(size=(B, Hkv, Sk, D)), device=dev).to(dtype)
            for causal in ((True, False) if Sq <= Sk else (False,)):
                check_attention_bwd(torch, rng, q.transpose(1, 2), k, v, causal, "edge")
        # T 1, T not a multiple of the 16-step chunk, T past several of the
        # boundary kernel's stages; every third case with w down to 1e-12
        for i, (B, H, T, D) in enumerate([(1, 2, 1, 16), (3, 5, 7, 64), (2, 4, 64, 64),
                                          (1, 2, 7, 128), (2, 3, 33, 32), (1, 4, 17, 64),
                                          (1, 3, 300, 64), (1, 2, 129, 128), (1, 3, 257, 16)]):
            for with_state in (False, True):
                args = wkv6_inputs(torch, rng, dev, dtype, B, H, T, D, with_state,
                                   strided=bool((i + with_state) % 2),
                                   w_low=1e-12 if i % 3 == 1 else None)
                check_wkv6_bwd(torch, rng, args, "edge", with_dstate=with_state)
    # float32 over long key runs: O and dQ sum 32768 keys, 12288 products a
    # row, which without promotion the tensor cores' float32 accumulation
    # would take alone
    B, Hq, Hkv, Sq, Sk, D = LONG_KEYS
    q = torch.as_tensor(rng.normal(size=(B, Sq, Hq, D)), device=dev).float().transpose(1, 2)
    k, v = (torch.as_tensor(rng.normal(size=(B, Hkv, Sk, D)), device=dev).float()
            for _ in range(2))
    for causal in (True, False):
        check_attention(torch, q, k, v, causal, "long keys")
        check_attention_bwd(torch, rng, q, k, v, causal, "long keys")
    del q, k, v
    check_autograd_functions(torch, rng, dev)


def attention_pairs(Sq: int, Sk: int, causal: bool) -> int:
    """(query, key) pairs the mask keeps: the work K4 must do."""
    if not causal:
        return Sq * Sk
    return sum(min(Sk, i + (Sk - Sq) + 1) for i in range(Sq))


def attention_inputs(torch, rng, dev, B, Hq, Hkv, Sq, Sk, D):
    """bf16 q, k, v of one prefill attention call, q strided as the model
    hands it over."""
    q = torch.as_tensor(rng.normal(size=(B, Sq, Hq, D)), device=dev).to(torch.bfloat16)
    k = torch.as_tensor(rng.normal(size=(B, Hkv, Sk, D)), device=dev).to(torch.bfloat16)
    v = torch.as_tensor(rng.normal(size=(B, Hkv, Sk, D)), device=dev).to(torch.bfloat16)
    return q.transpose(1, 2), k, v


def attention_row(torch, q, k, v, causal: bool, label: str) -> dict:
    """The tensor-core kernel (the models' bf16 path) at one shape, with
    the plain version and scaled_dot_product_attention on the same bf16
    inputs; its bound at the bf16 tensor-core rate."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import flash_attention_plain, flash_attention_sm90

    B, Hq, Sq, D = q.shape
    Sk = k.shape[2]
    qd = q.contiguous()
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())  # q, k, v read; o written
    nops = 4 * D * attention_pairs(Sq, Sk, causal) * Hq * B
    b_ms, b_by = bound_ms(nbytes, nops, PEAK_BF16_OPS_PER_S)
    p_ms = cuda_ms(torch, lambda: flash_attention_plain(q, k, v, causal), LM_REPS)
    l_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        qd, k, v, is_causal=causal, enable_gqa=True), LM_REPS)
    err = check_attention(torch, q, k, v, causal, label)
    k_ms = cuda_ms(torch, lambda: flash_attention_sm90(q, k, v, causal), LM_REPS * 5)
    d_ms = device_ms(torch, lambda: flash_attention_sm90(q, k, v, causal),
                     "flash_attention_sm90_kernel", LM_REPS * 5)
    row = dict(label=label, kernel="flash_attention_sm90", max_abs_err=err, ms=k_ms,
               device_ms=d_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms, bound_by=b_by,
               bytes=nbytes, ops=nops)
    log("   ", json.dumps(row))
    return row


def lm_main_shape_phase(torch, dev) -> dict:
    """K4 at the prefill shapes of the served models (Qwen3-14B's first,
    then the later families') and K5 at RWKV6-7B's decode shape, bf16 as
    the models run them, with times and bounds."""
    import torch.nn.functional as F

    from repro_torch.configs import get
    from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_plain
    from repro_torch.kernels.wkv6 import wkv6_cuda, wkv6_plain

    log("phase 2b: LM main-path shapes")
    rng = np.random.default_rng(12)
    out = {}
    qc = get("qwen3-14b")
    B, Hq, Hkv, S, D = 1, qc.n_heads, qc.n_kv_heads, PREFILL_LEN, qc.hd
    q, k, v = attention_inputs(torch, rng, dev, B, Hq, Hkv, S, S, D)
    label = f"qwen3-14b prefill: B={B} Hq={Hq} Hkv={Hkv} S={S} D={D} bf16 causal"
    rows = [attention_row(torch, q, k, v, True, label)]
    nops = rows[0]["ops"]
    qd = q.contiguous()
    # the float32 kernel (split TF32 on the tensor cores), whose model path
    # is float32 (phases 7 and 8a): float32 copies of the same inputs, its
    # bound at three TF32 products for each (and, beside it, at the CUDA
    # cores' float32 rate) and scaled_dot_product_attention on the same
    # float32 inputs
    q, qd, k, v = (t.float() for t in (q, qd, k, v))  # q keeps the model's strides
    label = label.replace("bf16", "float32")
    nbytes = 4 * (2 * q.numel() + k.numel() + v.numel())
    b_ms, b_by = bound_ms(nbytes, TF32_PRODUCTS * nops, PEAK_TF32_OPS_PER_S)
    cc_ms, _ = bound_ms(nbytes, nops, PEAK_OPS_PER_S)
    p_ms = cuda_ms(torch, lambda: flash_attention_plain(q, k, v, True), 2)
    l_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        qd, k, v, is_causal=True, enable_gqa=True), LM_REPS)
    err = check_attention(torch, q, k, v, True, label)
    k_ms = cuda_ms(torch, lambda: flash_attention_cuda(q, k, v, True), LM_REPS * 2)
    # fa_f32_sm90_split_kernel and fa_f32_sm90_kernel, each once a call
    d_ms = device_ms(torch, lambda: flash_attention_cuda(q, k, v, True), "fa_f32_sm90_",
                     LM_REPS, per_call=True)
    row = dict(label=label, kernel="flash_attention_f32_sm90", max_abs_err=err, ms=k_ms,
               device_ms=d_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms, bound_by=b_by,
               bound_cuda_cores_ms=cc_ms,
               bytes=nbytes, ops=nops)
    log("   ", json.dumps(row))
    out["flash_attention_f32_sm90"] = [row]
    del q, qd, k, v
    # the later families' prefill attention: each layer of kimi-k2 and of
    # musicgen, zamba2's shared block, the vision model's cross-attention
    # layers (its and dbrx's self-attention layers differ from Qwen3-14B's
    # shape only in the number of query heads)
    for arch, what in (("kimi-k2-1t-a32b", "prefill"), ("zamba2-2.7b", "shared block prefill"),
                       ("llama-3.2-vision-90b", "cross-attention prefill"),
                       ("musicgen-medium", "prefill")):
        c = get(arch)
        cross = bool(c.cross_attn_every)
        Sk = c.n_img_tokens if cross else PREFILL_LEN
        q, k, v = attention_inputs(torch, rng, dev, 1, c.n_heads, c.n_kv_heads, PREFILL_LEN,
                                   Sk, c.hd)
        label = (f"{arch} {what}: B=1 Hq={c.n_heads} Hkv={c.n_kv_heads} Sq={PREFILL_LEN} "
                 f"Sk={Sk} D={c.hd} bf16 {'non-causal' if cross else 'causal'}")
        rows.append(attention_row(torch, q, k, v, not cross, label))
        del q, k, v
    out["flash_attention_sm90"] = rows

    # K5 as the model calls it: strided views of (B, T, H, D), bf16 u (its
    # float32 copy cached), the state written over itself; at RWKV6-7B's
    # decode shape (the main path), then its prefill shape (which serving
    # does not take: it feeds prompts through the decode step)
    rc = get("rwkv6-7b")
    rows = []
    for B, T, reps, what in ((SLOTS, 1, LM_REPS * 10, "decode"),
                             (1, PREFILL_LEN, LM_REPS, "prefill")):
        H, D = rc.n_heads, rc.d_model // rc.n_heads
        args = wkv6_inputs(torch, rng, dev, torch.bfloat16, B, H, T, D, True, strided=True)
        label = (f"rwkv6-7b {what}: B={B} H={H} T={T} D={D} bf16, strided, "
                 f"state f32 written in place")
        err = check_wkv6(torch, args, label)
        r, k, v, w, u, s0 = args
        state = s0.clone()
        step = lambda: wkv6_cuda(r, k, v, w, u, state, state_out=state)
        k_ms = cuda_ms(torch, step, reps)
        d_ms = device_ms(torch, step, "wkv6_kernel", reps)
        p_ms = cuda_ms(torch, lambda: wkv6_plain(*args), reps if T == 1 else 1)
        nbytes = (5 * B * H * T * D * 2 + H * D * 2  # r, k, v, w read, y written; u
                  + 2 * B * H * D * D * 4)  # state read and written
        nops = 7 * B * H * T * D * D
        b_ms, b_by = bound_ms(nbytes, nops)
        row = dict(label=label, max_abs_err=err, ms=k_ms, device_ms=d_ms, plain_ms=p_ms,
                   library_ms=None, bound_ms=b_ms, bound_by=b_by, bytes=nbytes, ops=nops)
        log("   ", json.dumps(row))
        rows.append(row)
        del args, r, k, v, w, state
    out["wkv6"] = rows
    return out


def bwd_main_shape_phase(torch, dev) -> dict:
    """The backward kernels at the training shapes of phase 8(b), with the
    plain backward on the same inputs and the library's backward: K4's at
    Qwen3-14B's (bf16, then float32 copies in split TF32, both on the
    tensor cores), K5's at RWKV6-7B's.  Device times sum every kernel of
    one call (each kernel's mean launch, by name prefix)."""
    import torch.nn.functional as F

    from repro_torch.configs import get
    from repro_torch.kernels.flash_attention import (
        BWD_KERNELS, flash_attention_bwd_cuda, flash_attention_bwd_plain,
        flash_attention_fwd_cuda,
    )
    from repro_torch.kernels.wkv6 import wkv6_bwd_cuda, wkv6_bwd_plain

    log("phase 2b: backward kernels at the training shapes")
    rng = np.random.default_rng(14)
    qc = get("qwen3-14b")
    B, Hq, Hkv, S, D = 1, qc.n_heads, qc.n_kv_heads, TRAIN_SEQ, qc.hd
    q, k, v = attention_inputs(torch, rng, dev, B, Hq, Hkv, S, S, D)
    out = {}
    # the kernels of one call: fa_bwd_sm90_{delta,dkdv,dq}_kernel (bf16),
    # fa_bwd_f32_sm90_{split,delta,dkdv,dq}_kernel (float32, bounded at
    # three TF32 products a product)
    for dtype, peak, prefix in ((torch.bfloat16, PEAK_BF16_OPS_PER_S, "fa_bwd_sm90_"),
                                (torch.float32, PEAK_TF32_OPS_PER_S / TF32_PRODUCTS,
                                 "fa_bwd_f32_sm90_")):
        q, k, v = (t.to(dtype) for t in (q, k, v))  # q keeps the model's strides
        o, lse = flash_attention_fwd_cuda(q, k, v, True)
        do = torch.as_tensor(rng.normal(size=tuple(o.shape)), device=dev).to(dtype)
        name = str(dtype).replace("torch.", "")
        label = f"qwen3-14b training: B={B} Hq={Hq} Hkv={Hkv} S={S} D={D} {name} causal"
        err = check_attention_bwd(torch, rng, q, k, v, True, label)
        # five products of 2 D a kept (query, key) pair and head; q, k, v,
        # o, dO and lse read, dq, dk, dv written
        nops = 5 * 2 * D * attention_pairs(S, S, True) * Hq * B
        nbytes = q.element_size() * (4 * q.numel() + 2 * k.numel() + 2 * v.numel()) + 4 * lse.numel()
        b_ms, b_by = bound_ms(nbytes, nops, peak)
        bwd = lambda: flash_attention_bwd_cuda(q, k, v, o, lse, do, True)
        k_ms = cuda_ms(torch, bwd, LM_REPS)
        d_ms = device_ms(torch, bwd, prefix, 3, per_call=True)
        p_ms = cuda_ms(torch, lambda: flash_attention_bwd_plain(q, k, v, o, lse, do, True), 2)
        # the library: scaled_dot_product_attention's backward alone, on the same inputs
        qd, kd, vd = (t.detach().contiguous().requires_grad_() for t in (q, k, v))
        y = F.scaled_dot_product_attention(qd, kd, vd, is_causal=True, enable_gqa=True)
        l_ms = cuda_ms(torch, lambda: torch.autograd.grad(y, (qd, kd, vd), do,
                                                          retain_graph=True), 3)
        del y, qd, kd, vd
        row = dict(label=label, kernel=BWD_KERNELS[dtype], max_abs_err=err, ms=k_ms,
                   device_ms=d_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms, bound_by=b_by,
                   bytes=nbytes, ops=nops)
        if dtype == torch.float32:
            row["bound_cuda_cores_ms"] = bound_ms(nbytes, nops, PEAK_OPS_PER_S)[0]
        log("   ", json.dumps(row))
        out[BWD_KERNELS[dtype]] = [row]
        del o, lse, do
    del q, k, v
    torch.cuda.empty_cache()

    rc = get("rwkv6-7b")
    H, D = rc.n_heads, rc.d_model // rc.n_heads
    args = wkv6_inputs(torch, rng, dev, torch.bfloat16, 1, H, TRAIN_SEQ, D, False, strided=True)
    label = (f"rwkv6-7b training: B=1 H={H} T={TRAIN_SEQ} D={D} bf16, strided, no initial "
             f"state (the model's call)")
    err = check_wkv6_bwd(torch, rng, args, label, with_dstate=False)
    dy = torch.as_tensor(rng.normal(size=tuple(args[0].shape)), device=dev).to(torch.bfloat16)
    bwd = lambda: wkv6_bwd_cuda(*args, dy)
    k_ms = cuda_ms(torch, bwd, 3)
    # wkv6_bwd_{states,rows,cols,du}_kernel
    d_ms = device_ms(torch, bwd, "wkv6_bwd_", 3, per_call=True)
    p_ms = cuda_ms(torch, lambda: wkv6_bwd_plain(*args, dy), 1)
    n = 1 * H * TRAIN_SEQ
    # the forward recurrence again (P_t), G's recurrence, and dr, dk, dv,
    # dw: 3 + 3 + 4 * 2 = 14 D^2 a head and step; r, k, v, w, dy read, dr,
    # dk, dv, dw written, u read and du written
    nops = 14 * n * D * D
    nbytes = 9 * n * D * 2 + 2 * H * D * 4
    b_ms, b_by = bound_ms(nbytes, nops)
    row = dict(label=label, max_abs_err=err, ms=k_ms, device_ms=d_ms, plain_ms=p_ms,
               library_ms=None, bound_ms=b_ms, bound_by=b_by, bytes=nbytes, ops=nops)
    log("   ", json.dumps(row))
    out["wkv6_bwd"] = [row]
    del args, dy
    torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------------
# phases 6 and 7: the LM path at full width, and the card against the CPU
# ----------------------------------------------------------------------
def device_busy(prof):
    """Device busy ms of a ``torch.profiler`` run (the self time of every
    device-side event: kernels, copies, memsets), and ms and count by op."""
    from torch.autograd import DeviceType

    busy, per_op = 0.0, {}
    for e in prof.key_averages():
        # device-side events only: a host op's entry repeats the device
        # time of the kernels it launched
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            ms = e.self_device_time_total / 1e3
            busy += ms
            acc = per_op.setdefault(e.key, [0.0, 0])
            acc[0] += ms
            acc[1] += e.count
    return busy, per_op


def session(torch, fn):
    """Run ``fn`` once under ``torch.profiler``, after PAD_KERNELS short
    kernels and a synchronisation: a session can lose the first device
    events it should record (PERF.md section 7), and these take the loss.
    Returns fn's wall ms, then the device busy ms and ms and count by op
    of the events after the pad, and how many pad kernels were recorded."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PAD_KERNELS):
            torch.cuda._sleep(PAD_CYCLES)
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    busy, per_op = device_busy(prof)
    pad = 0
    for key in [key for key in per_op if PAD_KEY in key]:
        ms, count = per_op.pop(key)
        busy -= ms
        pad += count
    return wall, busy, per_op, pad


def profiled(torch, label: str, fn) -> None:
    """Run ``fn`` once under ``torch.profiler``: wall, device busy and
    idle share, and the device ops that take most of the time."""
    wall, busy, per_op, _ = session(torch, fn)
    log(f"  profiled {label}: wall {wall:.3f} ms, device busy {busy:.3f} ms "
        f"({100 * busy / wall:.3f} %; idle share {100 - 100 * busy / wall:.3f} %)")
    for key, (ms, count) in sorted(per_op.items(), key=lambda kv: -kv[1][0])[:10]:
        log(f"    {ms:.3f} ms  {count} x {key[:100]}")


def serve_requests(cfg, n: int, seed: int):
    from repro_torch.serve.engine import Request

    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab, rng.integers(3, 13)).astype(np.int32),
                    max_new=MAX_NEW) for i in range(n)]


def timed_engine(torch, cfg, params):
    """A ``ServeEngine`` that records the host time of each decode step
    (each ends in the argmax's copy to the host, so it waits for the card)."""
    from repro_torch.serve.engine import ServeEngine

    class TimedEngine(ServeEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.step_ms = []

        def step(self):
            t = time.perf_counter()
            super().step()
            self.step_ms.append((time.perf_counter() - t) * 1e3)

    return TimedEngine(cfg, params, batch_slots=SLOTS, max_len=MAX_LEN)


def serve_run(torch, ops, cfg, params, seed: int) -> dict:
    """Serve ``SERVE[cfg.name]`` requests through ``ServeEngine.run``; the
    launch counts are zeroed just before and read just after."""
    eng = timed_engine(torch, cfg, params)
    reqs = serve_requests(cfg, SERVE[cfg.name], seed)
    ops.reset_launches()
    t = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(ops.LAUNCHES)
    for r in reqs:
        if not (r.done and len(r.out) == MAX_NEW and all(0 <= x < cfg.vocab for x in r.out)):
            raise AssertionError(f"{cfg.name}: request {r.rid} not served: {r.out}")
    tokens = sum(len(r.out) for r in reqs)
    res = dict(requests=len(reqs), slots=SLOTS, steps=eng.steps, tokens=tokens,
               wall_s=wall, tokens_per_s=tokens / wall,
               step_ms_median=float(np.median(eng.step_ms)),
               step_ms_min=float(np.min(eng.step_ms)), step_ms_max=float(np.max(eng.step_ms)),
               launches=launches)
    log(f"  {cfg.name} served: {json.dumps(res)}")
    # one more short run under the profiler, for the device's busy share
    more = serve_requests(cfg, SLOTS, seed + 1)
    profiled(torch, f"{cfg.name} decode ({SLOTS} requests)", lambda: eng.run(more))
    return res


def load_model(torch, cfg, dev, seed: int):
    """Random weights of ``cfg`` drawn on the card from ``seed``."""
    from repro_torch.models import lm

    t = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(seed), device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"  {cfg.name} ({cfg.n_layers} layers): {n_params} parameters ({cfg.param_dtype}) drawn "
        f"on the card in {time.perf_counter() - t:.3f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB")
    return params, n_params


def model_inputs(torch, cfg, dev, B: int, S: int, seed: int) -> dict:
    """A batch of ``cfg``'s inputs from ``seed``: tokens, or frame
    embeddings where the model takes no tokens, and the image embeddings
    of a cross-attention model."""
    rng = np.random.default_rng(seed)
    dt = getattr(torch, cfg.compute_dtype)
    batch = {}
    if cfg.embed_inputs:
        batch["tokens"] = torch.as_tensor(rng.integers(0, cfg.vocab, (B, S)), device=dev)
    else:
        batch["embeddings"] = torch.as_tensor(rng.normal(size=(B, S, cfg.d_model)),
                                              device=dev).to(dt)
    if cfg.cross_attn_every:
        batch["img_embed"] = torch.as_tensor(rng.normal(size=(B, cfg.n_img_tokens, cfg.d_model)),
                                             device=dev).to(dt)
    return batch


def attention_layers(cfg) -> int:
    """Layers with attention: all but the Mamba2 hybrid's, whose one shared
    block runs once every ``attn_every`` layers."""
    return cfg.n_layers // cfg.attn_every if cfg.family == "mamba_hybrid" else cfg.n_layers


def prefill_run(torch, ops, cfg, params, batch) -> dict:
    """A cold prefill whose launches must be exactly one tensor-core
    attention launch per attention layer, three warm ones, one profiled."""
    from repro_torch.models import lm

    want = attention_layers(cfg)
    ops.reset_launches()
    t = time.perf_counter()
    logits = lm.prefill(cfg, params, batch)
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t) * 1e3
    launches = dict(ops.LAUNCHES)
    if launches["flash_attention_sm90"] != want or sum(launches.values()) != want:
        raise AssertionError(f"{cfg.name} prefill launched {launches}; wants "
                             f"{want} flash_attention_sm90 and nothing else")
    if logits.shape != (1, cfg.vocab) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{cfg.name} prefill logits: {tuple(logits.shape)}, not all finite")
    warm = []
    for _ in range(3):
        t = time.perf_counter()
        lm.prefill(cfg, params, batch)
        torch.cuda.synchronize()
        warm.append((time.perf_counter() - t) * 1e3)
    seq = next(iter(batch.values())).shape[1]
    res = dict(seq=seq, cold_ms=cold_ms, warm_ms_median=float(np.median(warm)), warm_ms=warm,
               tokens_per_s=seq / (np.median(warm) / 1e3), launches=launches)
    log(f"  {cfg.name} prefill: {json.dumps(res)}")
    profiled(torch, f"{cfg.name} prefill S={seq}", lambda: lm.prefill(cfg, params, batch))
    return res


def embed_decode_run(torch, ops, cfg, params, dev, seed: int) -> dict:
    """A model that takes frame embeddings, which no engine feeds:
    ``EMBED_STEPS`` decode steps at ``EMBED_BATCH`` through
    ``lm.decode_step`` (each ends in the argmax's copy to the host, as an
    engine step does), with the launch counts zeroed just before."""
    from repro_torch.models import lm

    state = lm.init_decode_state(cfg, EMBED_BATCH, MAX_LEN, device=dev)
    frames = model_inputs(torch, cfg, dev, EMBED_BATCH, EMBED_STEPS + 4, seed)["embeddings"]

    def steps(lo: int, hi: int, step_ms: list):
        nonlocal state
        for i in range(lo, hi):
            t = time.perf_counter()
            logits, state = lm.decode_step(cfg, params, state, {"embeddings": frames[:, i:i + 1]})
            nxt = torch.argmax(logits, dim=-1).cpu()
            step_ms.append((time.perf_counter() - t) * 1e3)
            if not (bool(torch.isfinite(logits).all()) and ((nxt >= 0) & (nxt < cfg.vocab)).all()):
                raise AssertionError(f"{cfg.name}: decode step {i} logits not finite")

    step_ms = []
    ops.reset_launches()
    t = time.perf_counter()
    steps(0, EMBED_STEPS, step_ms)
    wall = time.perf_counter() - t
    launches = dict(ops.LAUNCHES)
    tokens = EMBED_STEPS * EMBED_BATCH
    res = dict(batch=EMBED_BATCH, steps=EMBED_STEPS, tokens=tokens, wall_s=wall,
               tokens_per_s=tokens / wall, step_ms_median=float(np.median(step_ms)),
               step_ms_min=float(np.min(step_ms)), step_ms_max=float(np.max(step_ms)),
               launches=launches)
    log(f"  {cfg.name} decode steps: {json.dumps(res)}")
    profiled(torch, f"{cfg.name} decode (4 steps at B={EMBED_BATCH})",
             lambda: steps(EMBED_STEPS, EMBED_STEPS + 4, []))
    return res


def lm_phase(torch, ops, dev, seed: int) -> dict:
    """Each served configuration in turn: Qwen3-14B and RWKV6-7B whole,
    then NEW_LM at its depth; a prefill (none for RWKV6-7B, whose serving
    feeds prompts through decode), then serving, or decode steps for a
    model without token inputs."""
    import dataclasses
    import gc

    from repro_torch.configs import get

    log("phase 6: LM path at full width (random weights)")
    out = {}
    for arch, depth in {"qwen3-14b": None, "rwkv6-7b": None, **NEW_LM}.items():
        cfg = get(arch)
        if depth is not None:
            cfg = dataclasses.replace(cfg, n_layers=depth)
        torch.cuda.reset_peak_memory_stats()
        params, n_params = load_model(torch, cfg, dev, seed)
        run = dict(params=n_params, layers=cfg.n_layers)
        if cfg.family != "rwkv6":
            run["prefill"] = prefill_run(torch, ops, cfg, params,
                                         model_inputs(torch, cfg, dev, 1, PREFILL_LEN, seed))
        if cfg.embed_inputs:
            run["serve"] = serve_run(torch, ops, cfg, params, seed)
        else:
            run["serve"] = embed_decode_run(torch, ops, cfg, params, dev, seed)
        launches = run["serve"]["launches"]
        # decode attention is the plain masked one; only RWKV6's WKV is a kernel
        want = cfg.n_layers * run["serve"]["steps"] if cfg.family == "rwkv6" else 0
        if launches["wkv6"] != want or sum(launches.values()) != want:
            raise AssertionError(f"{arch} decode launched {launches}; wants {want} wkv6 "
                                 "and nothing else")
        run["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        log(f"  {cfg.name} ({cfg.n_layers} layers): peak device memory {run['peak_gb']:.3f} GB")
        out[arch] = run
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return out


def lm_check_phase(torch, ops, dev) -> dict:
    """Reduced float32 configs with the same weights on the card and the
    CPU (the vision model's cross-attention gates opened to CROSS_GATE in
    both): prefill logits within LM_CHECK_TOL, served tokens equal (a
    model without token inputs: four decode steps' logits).  Each card
    prefill must launch its model's f32 kernel (split TF32) once per attention layer
    (K5 once per layer) and nothing else; returns those launch counts by
    arch."""
    import copy

    from repro_torch.configs import get
    from repro_torch.models import lm
    from repro_torch.models.config import reduced
    from repro_torch.serve.engine import Request, ServeEngine

    log(f"phase 7: LM path, card vs CPU (reduced float32 configs, logits within {LM_CHECK_TOL})")
    out = {}
    for arch, over in (("qwen3-14b", {"n_kv_heads": 2}), ("rwkv6-7b", {}), ("dbrx-132b", {}),
                       ("kimi-k2-1t-a32b", {}), ("zamba2-2.7b", {}),
                       ("llama-3.2-vision-90b", {}), ("musicgen-medium", {})):
        cfg = reduced(get(arch), **over)
        kernel, want_launches = (("wkv6", cfg.n_layers) if cfg.family == "rwkv6"
                                 else ("flash_attention_f32_sm90", attention_layers(cfg)))
        cpu = lm.init_params(cfg, torch.Generator("cpu").manual_seed(1), device="cpu")
        for block in (cpu["cross_blocks"] if "cross_blocks" in cpu else []):
            block["attn"]["gate"].fill_(CROSS_GATE)
        card = copy.deepcopy(cpu).to(dev)  # Module.to moves in place
        batch = model_inputs(torch, cfg, "cpu", 2, 128, 2)
        ops.reset_launches()
        got = lm.prefill(cfg, card, {name: t.to(dev) for name, t in batch.items()}).cpu()
        launched = dict(ops.LAUNCHES)
        want = lm.prefill(cfg, cpu, batch)
        errs = [max_abs_err(torch, got, want)]
        ok = bool(torch.allclose(got, want, rtol=LM_CHECK_TOL, atol=LM_CHECK_TOL))
        outs = []
        for params in (card, cpu):
            if cfg.embed_inputs:
                reqs = [Request(rid=i, prompt=np.random.default_rng(i).integers(0, cfg.vocab, 3 + i)
                                .astype(np.int32), max_new=6) for i in range(5)]
                ServeEngine(cfg, params, batch_slots=2, max_len=32).run(reqs)
                outs.append([r.out for r in reqs])
            else:  # four decode steps on frame embeddings
                pdev = params["lm_head"].device
                state = lm.init_decode_state(cfg, 2, 32, device=pdev)
                frames = batch["embeddings"].to(pdev)
                logits = []
                for i in range(4):
                    lo, state = lm.decode_step(cfg, params, state,
                                               {"embeddings": frames[:, i:i + 1]})
                    logits.append(lo.cpu())
                outs.append(logits)
        if cfg.embed_inputs:
            same, what = outs[0] == outs[1], "served tokens"
        else:
            errs += [max_abs_err(torch, a, b) for a, b in zip(*outs)]
            same = all(torch.allclose(a, b, rtol=LM_CHECK_TOL, atol=LM_CHECK_TOL)
                       for a, b in zip(*outs))
            what = "decode-step logits"
        log(f"  {cfg.name} reduced: prefill launches {launched}, logits max_abs_err {max(errs)!r} "
            f"{'ok' if ok else 'MISMATCH'}; {what} {'equal' if same else 'DIFFER'}")
        if not (ok and same):
            raise AssertionError(f"{cfg.name}: the card disagrees with the CPU on the LM path")
        if launched[kernel] != want_launches or sum(launched.values()) != want_launches:
            raise AssertionError(f"{cfg.name} reduced f32 prefill launched {launched}; wants "
                                 f"{want_launches} {kernel}")
        out[arch] = launched
    return out


# ----------------------------------------------------------------------
# phase 8: training
# ----------------------------------------------------------------------
def train_launches(cfg) -> dict:
    """Kernel launches of one microbatch's forward and backward under
    ``remat="nothing"``: a checkpointed block runs its forward twice (once
    more in the backward), the hybrid's shared attention block, which is
    not checkpointed, once; one backward launch per layer (K4's of the
    compute dtype, both on the tensor cores: bf16, or float32 in split TF32)."""
    if cfg.family == "rwkv6":
        return {"wkv6": 2 * cfg.n_layers, "wkv6_bwd": cfg.n_layers}
    bf16 = cfg.compute_dtype == "bfloat16"
    fwd = "flash_attention_sm90" if bf16 else "flash_attention_f32_sm90"
    bwd = "flash_attention_bwd_sm90" if bf16 else "flash_attention_bwd_f32_sm90"
    n = attention_layers(cfg)
    return {fwd: n if cfg.family == "mamba_hybrid" else 2 * n, bwd: n}


def train_batch(torch, cfg, dev, B: int, S: int, seed: int) -> dict:
    """``model_inputs`` of ``cfg`` with next-token labels."""
    batch = model_inputs(torch, cfg, dev, B, S, seed)
    batch["labels"] = torch.as_tensor(
        np.random.default_rng(seed + 1).integers(0, cfg.vocab, (B, S)), device=dev)
    return batch


def loss_and_grads(torch, lm, cfg, params, batch):
    """Loss and each parameter's gradient of one microbatch, on the host."""
    names, leaves = zip(*params.named_parameters())
    loss, _ = lm.loss_fn(cfg, params, batch)
    grads = torch.autograd.grad(loss, leaves)
    return loss.item(), {n: g.cpu() for n, g in zip(names, grads)}


def close_leaves(torch, got: dict, want: dict, rtol: float, atol_rel: float) -> float:
    """The largest error of any leaf relative to its own largest |value|;
    raises if a leaf is outside rtol |want| + atol_rel max|want|."""
    worst = 0.0
    for name, w in want.items():
        g = got[name].to(torch.float64)
        w = w.to(torch.float64)
        scale = float(w.abs().max()) if w.numel() else 0.0
        err = (g - w).abs()
        if bool((err > rtol * w.abs() + atol_rel * scale).any()):
            raise AssertionError(f"{name}: max error {float(err.max())!r} over max |value| {scale!r}")
        worst = max(worst, float(err.max()) / (scale or 1.0))
    return worst


def train_check_phase(torch, ops, dev) -> None:
    """Phase 8(a): the reduced float32 config of each registered family
    from the same weights on the card and the CPU (cross-attention gates
    opened to CROSS_GATE): the loss and every gradient leaf of one
    microbatch, with the card's launches, and one train step's metrics;
    then the card's checkpoint restored on the CPU, which must equal the
    card's state bit for bit, and from it again the loss and every
    gradient leaf of the next microbatch and one more step's metrics.
    The weights after a step are not compared element by element: Adam's
    first steps divide each gradient by its own magnitude, so a weight
    whose gradient is at rounding level may move by up to lr either way.
    Returns each family's launches in its first microbatch."""
    import copy
    import shutil

    from repro_torch.configs import ARCHS, get
    from repro_torch.models import lm
    from repro_torch.models.config import reduced
    from repro_torch.train import checkpoint
    from repro_torch.train.train_step import init_train_state, make_train_step

    log(f"phase 8a: training, card vs CPU (reduced float32 configs of all {len(ARCHS)} families: "
        f"loss rtol {TRAIN_TOL['loss']}, each gradient leaf within {TRAIN_TOL['grad']} of its "
        f"largest |value|, step metrics)")
    ckpt_dir = ROOT / "build" / "chip_smoke_ckpt"
    host = lambda st: {n: p.detach().cpu() for n, p in st["params"].named_parameters()}

    def agree(what, card_s, cpu_s, batch):
        ops.reset_launches()
        loss_c, grads_c = loss_and_grads(torch, lm, cfg, card_s["params"],
                                         {n: t.to(dev) for n, t in batch.items()})
        launched = {n: c for n, c in ops.LAUNCHES.items() if c}
        loss_h, grads_h = loss_and_grads(torch, lm, cfg, cpu_s["params"], batch)
        if abs(loss_c - loss_h) > TRAIN_TOL["loss"] * abs(loss_h):
            raise AssertionError(f"{arch} {what}: card loss {loss_c!r}, CPU loss {loss_h!r}")
        tol = TRAIN_TOL["grad_ssd" if cfg.family == "mamba_hybrid" else "grad"]
        err = close_leaves(torch, grads_c, grads_h, tol, tol)
        if launched != train_launches(cfg):
            raise AssertionError(f"{arch}: a microbatch launched {launched}, wants "
                                 f"{train_launches(cfg)}")
        return loss_c, loss_h, err, launched

    def step_both(card_s, cpu_s, batch):
        card_s, m_c = step(card_s, {n: t.to(dev) for n, t in batch.items()})
        cpu_s, m_h = step(cpu_s, batch)
        for key, tol in (("loss", TRAIN_TOL["loss"]), ("grad_norm", TRAIN_TOL["grad"])):
            a, b = float(m_c[key]), float(m_h[key])
            if abs(a - b) > tol * abs(b):
                raise AssertionError(f"{arch}: step {key} {a!r} on the card, {b!r} on the CPU")
        return card_s, cpu_s

    microbatch_launches = {}
    for arch in ARCHS:
        cfg = reduced(get(arch), **({"n_kv_heads": 2} if arch == "qwen3-14b" else {}))
        cpu = lm.init_params(cfg, torch.Generator("cpu").manual_seed(3), device="cpu")
        for block in (cpu["cross_blocks"] if "cross_blocks" in cpu else []):
            block["attn"]["gate"].fill_(CROSS_GATE)
        card = copy.deepcopy(cpu).to(dev)
        cpu_s, card_s = init_train_state(cfg, params=cpu), init_train_state(cfg, params=card)
        batches = [train_batch(torch, cfg, "cpu", 2, 64, seed) for seed in (0, 1)]
        step = make_train_step(cfg)
        loss_c, loss_h, err1, launched = agree("from the same weights", card_s, cpu_s, batches[0])
        microbatch_launches[arch] = launched
        card_s, cpu_s = step_both(card_s, cpu_s, batches[0])
        # the card's checkpoint, restored on the CPU, is the card's state
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        checkpoint.save(card_s, str(ckpt_dir), card_s["step"])
        moved = checkpoint.restore(str(ckpt_dir), cpu_s, device="cpu")
        shutil.rmtree(ckpt_dir)
        same = all(torch.equal(a, b) for a, b in zip(host(moved).values(), host(card_s).values()))
        if not (same and moved["step"] == 1 and moved["opt"]["step"] == 1):
            raise AssertionError(f"{arch}: the restored checkpoint differs from the card's state")
        _, _, err2, _ = agree("from the checkpoint", card_s, moved, batches[1])
        step_both(card_s, moved, batches[1])
        log(f"  {cfg.name} reduced ({cfg.optimizer}, gradients in {cfg.grad_dtype}): microbatch "
            f"launches {launched}; loss {loss_c:.6f} (CPU {loss_h:.6f}); gradients rel err "
            f"{err1:.3e}, and {err2:.3e} from the card's checkpoint restored on the CPU "
            f"(bit-equal); both steps' loss and grad norm agree ok")
    return microbatch_launches


def train_run(torch, ops, arch: str, depth: int, batch: int, seed: int, dev) -> dict:
    """Phase 8(b): ``arch`` at its published widths and ``depth`` layers,
    trained TRAIN_STEPS steps of ``batch`` x TRAIN_SEQ tokens from
    ``curate`` and ``token_batches`` on the card; the launch counts of the
    first step (zeroed just before it) asserted; then one profiled step."""
    import dataclasses
    import gc

    from repro_torch.configs import get
    from repro_torch.data import tokens as tok
    from repro_torch.train.train_step import init_train_state, make_train_step

    cfg = dataclasses.replace(get(arch), n_layers=depth)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    ops.reset_launches()
    doc_ids, weights = tok.curate(tok.synthetic_corpus(2000, seed=seed), mixture=MIXTURE,
                                  device=dev)
    curate_launches = {n: c for n, c in ops.LAUNCHES.items() if c}
    data = [{name: torch.as_tensor(a, dtype=torch.int64, device=dev) for name, a in b.items()}
            for b in tok.token_batches(doc_ids, weights, cfg.vocab, batch, TRAIN_SEQ, seed=seed,
                                       steps=TRAIN_STEPS + 1)]
    log(f"  {arch}: curated {len(doc_ids)} docs on the card (launches {curate_launches}), "
        f"{TRAIN_STEPS + 1} batches of {batch} x {TRAIN_SEQ} tokens in "
        f"{time.perf_counter() - t:.3f} s")
    if not {"segment_sum", "substr_find"} <= set(curate_launches):
        raise AssertionError(f"curate on the card launched {curate_launches}; wants K1 and K2")
    t = time.perf_counter()
    state = init_train_state(cfg, torch.Generator(dev).manual_seed(seed), device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in state["params"].parameters())
    log(f"  {arch} ({depth} layers, {cfg.optimizer}, {cfg.microbatches} microbatches): "
        f"{n_params} parameters ({cfg.param_dtype}) and optimizer state on the card in "
        f"{time.perf_counter() - t:.3f} s, {torch.cuda.memory_allocated() / 1e9:.3f} GB")
    step = make_train_step(cfg)
    want = {n: c * cfg.microbatches for n, c in train_launches(cfg).items()}
    step_ms, losses, launches = [], [], None
    for i in range(TRAIN_STEPS):
        ops.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, data[i])
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        if launches is None:
            launches = {n: c for n, c in ops.LAUNCHES.items() if c}
        if not (np.isfinite(loss) and np.isfinite(gnorm)):
            raise AssertionError(f"{arch} step {i}: loss {loss}, grad norm {gnorm}")
        losses.append(loss)
        log(f"  {arch} step {i + 1}: loss {loss:.6f} grad_norm {gnorm:.6f} {step_ms[-1]:.3f} ms")
    if launches != want:
        raise AssertionError(f"{arch}: a train step launched {launches}; wants {want}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    warm = float(np.median(step_ms[1:]))
    res = dict(layers=depth, params=n_params, batch=batch, seq=TRAIN_SEQ,
               microbatches=cfg.microbatches, step_ms=step_ms, step_ms_median_warm=warm,
               tokens_per_s=batch * TRAIN_SEQ / (warm / 1e3), peak_gb=peak, losses=losses,
               launches=launches)
    log(f"  {arch} trained: {json.dumps(res)}")
    profiled(torch, f"{arch} train step ({batch} x {TRAIN_SEQ} tokens)",
             lambda: step(state, data[TRAIN_STEPS]))
    del state, data
    gc.collect()
    torch.cuda.empty_cache()
    return res


def train_phase(torch, ops, dev, seed: int) -> dict:
    log("phase 8b: training at full width (random weights; tokens curated on the card)")
    return {arch: train_run(torch, ops, arch, depth, batch, seed, dev)
            for arch, (depth, batch) in TRAIN.items()}


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


#: device-side names of the ported kernels that the TPC-H path launches
PASS_KERNELS = {"segment_sum": ("segment_sum_",),
                "substr_find": ("substr_find_rows", "exists_before_rows")}


def profile_pass(torch, ops, QF, frames, sf: float) -> dict:
    """One more warm pass of the 22 queries, each under its own
    ``torch.profiler`` context: per query the wall time, the device busy
    time (the sum of the self time of every device-side event: kernels,
    copies, memsets), and each ported kernel's launches (the ``LAUNCHES``
    delta) and device time; then the device ops that take most of it over
    the pass.  Each session opens with the pad kernels of ``session``; one
    in which a kernel the query launched still shows no device time is
    taken again, up to PROFILE_TRIES sessions, and the phase fails if none
    shows it.  The profiler adds host cost of its own, so these wall times
    are not the warm times of phase 3."""
    log("phase 3b: profiled warm pass (per query: traced wall, device busy, ported kernels)")
    per_op: dict = {}
    walls, busies = [], []
    launched = {name: 0 for name in PASS_KERNELS}
    kernel_ms = {name: 0.0 for name in PASS_KERNELS}
    retried, pad_lost = 0, []
    for q in sorted(QF.ALL, key=lambda s: int(s[1:])):
        for attempt in range(1, PROFILE_TRIES + 1):
            before = dict(ops.LAUNCHES)
            t_session = time.perf_counter()
            wall, busy, ops_here, pad = session(
                torch, lambda: QF.ALL[q](frames, sf=sf, apply_limit=False))
            session_s = time.perf_counter() - t_session
            if pad < PAD_KERNELS:
                pad_lost.append(f"{q}: {PAD_KERNELS - pad}")
            here = {name: ops.LAUNCHES[name] - before[name] for name in PASS_KERNELS}
            ms_here = {name: sum(ms for key, (ms, _) in ops_here.items()
                                 if any(k in key for k in keys))
                       for name, keys in PASS_KERNELS.items()}
            missing = [name for name in PASS_KERNELS if here[name] and not ms_here[name]]
            if not missing:
                break
            retried += 1
            log(f"  {q}: profiler session {attempt} of {PROFILE_TRIES} recorded no device time "
                f"for {missing}, launched {here} (device busy {busy:.3f} ms over "
                f"{len(ops_here)} device ops)")
        else:
            raise AssertionError(f"{q}: {PROFILE_TRIES} profiler sessions recorded no device time "
                                 f"for {missing}, which it launched")
        for key, (ms, count) in ops_here.items():
            acc = per_op.setdefault(key, [0.0, 0])
            acc[0] += ms
            acc[1] += count
        for name in PASS_KERNELS:
            launched[name] += here[name]
            kernel_ms[name] += ms_here[name]
        walls.append(wall)
        busies.append(busy)
        log(f"  {q}: wall {wall:.3f} ms, device busy {busy:.3f} ms ({100 * busy / wall:.3f} %); "
            f"ported launches {json.dumps(here)}, their device ms {json.dumps(ms_here)}; "
            f"session {session_s:.3f} s")
    wall, busy = sum(walls), sum(busies)
    idle = [name for name, n in launched.items() if n == 0]
    if idle:
        raise AssertionError(f"the profiled pass launched no {idle}")
    log(f"  all profiled queries: wall {wall:.3f} ms, device busy {busy:.3f} ms "
        f"({100 * busy / wall:.3f} %; idle share {100 - 100 * busy / wall:.3f} %); "
        f"sessions taken again: {retried}; sessions that lost pad kernels (of "
        f"{PAD_KERNELS}): {len(pad_lost)} {json.dumps(pad_lost)}")
    share = {name: 100 * ms / busy for name, ms in kernel_ms.items()}
    log(f"  ported kernels in the pass: launches {json.dumps(launched)}, device ms "
        f"{json.dumps(kernel_ms)}, % of device busy {json.dumps(share)}")
    for key, (ms, count) in sorted(per_op.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"  {ms:.3f} ms  {count} x {key[:100]}")
    return dict(wall_ms=wall, busy_ms=busy, launches=launched, device_ms=kernel_ms,
                retried=retried, pad_lost=pad_lost)


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
    # float32 products in full float32 on the card, as on the CPU, so the
    # LM card-vs-CPU check (phase 7) compares like with like
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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

    # phase 2a: edge shapes (a broken kernel fails here, fast), then the
    # LM kernels at their main-path shapes (before any model is loaded)
    edge_phase(torch, seg, sf, dev)
    hash_edge_phase(torch, dev)
    lm_edge_phase(torch, dev)
    bwd_edge_phase(torch, dev)
    lm_shapes = lm_main_shape_phase(torch, dev)
    lm_shapes.update(bwd_main_shape_phase(torch, dev))

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
    log(f"  segment_sum launches of pass 1 by path (m <= {seg.FEW_SLOTS}, "
        f"<= {seg.SMEM_SLOTS}, above): {json.dumps(ops.PATH_LAUNCHES)}")
    substr_modes = dict(sf.MODE_LAUNCHES)
    log(f"  substr_find launches of pass 1 by form: {json.dumps(substr_modes)}")
    if substr_modes["exists_before"] == 0:
        raise AssertionError("the main path never launched exists_before's fused form")
    if sum(substr_modes.values()) != pass1["substr_find"]:
        raise AssertionError(f"substr_find launches by form {substr_modes} do not add up to "
                             f"{pass1['substr_find']}")
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
    missing = [name for name in ("segment_sum", "substr_find") if launches[name] == 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
    shapes["segment_sum"] += mid_path_rows(torch, seg, ops, QF, frames, args.sf, dev)
    profile_pass(torch, ops, QF, frames, args.sf)
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
    del small, on_card, on_cpu

    # phases 6 and 7: the LM path at full width, then card vs CPU
    lm_runs = lm_phase(torch, ops, dev, args.seed)
    f32_runs = lm_check_phase(torch, ops, dev)
    # phase 8: training, card vs CPU, then at full width
    train_f32 = train_check_phase(torch, ops, dev)
    train_runs = train_phase(torch, ops, dev, args.seed)
    # launches of each kernel in its main-path run: K4's bf16 kernel in
    # Qwen3-14B's prefill, its f32 kernel in the reduced f32 Qwen3-14B
    # prefill of phase 7, K5 in RWKV6-7B's serving run, K3 in its one call
    # of ops.hash32x2 (no path of the engine calls it)
    launches["flash_attention_sm90"] = (
        lm_runs["qwen3-14b"]["prefill"]["launches"]["flash_attention_sm90"])
    launches["flash_attention_f32_sm90"] = f32_runs["qwen3-14b"]["flash_attention_f32_sm90"]
    launches["wkv6"] = lm_runs["rwkv6-7b"]["serve"]["launches"]["wkv6"]
    launches["hash32x2"] = shapes["hash32x2"][0]["launches"]
    # the backward kernels: bf16 K4 and K5 in one train step of phase 8b,
    # float32 K4 in one reduced float32 Qwen3-14B microbatch of phase 8a
    launches["flash_attention_bwd_sm90"] = (
        train_runs["qwen3-14b"]["launches"]["flash_attention_bwd_sm90"])
    launches["flash_attention_bwd_f32_sm90"] = (
        train_f32["qwen3-14b"]["flash_attention_bwd_f32_sm90"])
    launches["wkv6_bwd"] = train_runs["rwkv6-7b"]["launches"]["wkv6_bwd"]
    shapes.update(lm_shapes)
    for arch, run in lm_runs.items():
        if "prefill" in run:
            log(f"flash_attention_sm90 launches in one {arch} prefill ({run['layers']} "
                f"layers): {run['prefill']['launches']['flash_attention_sm90']}")

    # phase 5: report
    sources = {
        "segment_sum": ("src/repro_torch/kernels/csrc/segment_sum.cu",
                        "src/repro/kernels/segment_reduce.py:36"),
        "substr_find": ("src/repro_torch/kernels/csrc/substr_find.cu",
                        "src/repro/kernels/substr_find.py:43"),
        "hash32x2": ("src/repro_torch/kernels/csrc/hash32x2.cu",
                     "src/repro/kernels/hash32x2.py:38"),
        "flash_attention_sm90": ("src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
                                 "src/repro/kernels/flash_attention.py:65"),
        "flash_attention_f32_sm90": ("src/repro_torch/kernels/csrc/flash_attention_f32_sm90.cu",
                                     "src/repro/kernels/flash_attention.py:65"),
        "wkv6": ("src/repro_torch/kernels/csrc/wkv6.cu", "src/repro/kernels/wkv6.py:51"),
        # the backward kernels have no TPU counterpart (the JAX package
        # differentiates through XLA): "replaces" names the TPU kernel
        # whose function they differentiate
        "flash_attention_bwd_sm90": ("src/repro_torch/kernels/csrc/flash_attention_bwd_sm90.cu",
                                     "src/repro/kernels/flash_attention.py:65"),
        "flash_attention_bwd_f32_sm90": (
            "src/repro_torch/kernels/csrc/flash_attention_bwd_f32_sm90.cu",
            "src/repro/kernels/flash_attention.py:65"),
        "wkv6_bwd": ("src/repro_torch/kernels/csrc/wkv6_bwd.cu", "src/repro/kernels/wkv6.py:51"),
    }
    kernels = []
    timed = ("label", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for name, rows in shapes.items():
        row = rows[0]  # the main-path shape of each kernel (K1: q18's)
        src, replaces = sources[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "device_ms": row["device_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"], "shape": row["label"],
            "backward": name in BACKWARD_KERNELS,
            # K1's q1 shapes and its mid path, K4's later families' shapes,
            # K5's prefill shape (0 launches on the serving path)
            "other_shapes": [{key: r[key] for key in timed} for r in rows[1:]],
        })
    idle = [k["name"] for k in kernels if k["launches"] == 0]
    if idle:
        raise AssertionError(f"kernels never launched on their paths: {idle}")
    log(f"wall time {time.perf_counter() - t_all:.3f} s")
    log(json.dumps({"kernels": kernels}))
    log(gpu_name_power())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
