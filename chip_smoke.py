#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # TPC-H SF 1 (22 queries), TPC-DS SF 1, then the LM path
    python3 chip_smoke.py --sf 0.05  # a quicker TPC-H main path

Phases, each of which fails the run (non-zero exit) on any error:

1. the card's name and power limit, then the build of every CUDA kernel
   from ``src/repro_torch/kernels/csrc`` with ``nvcc``;
2. each kernel against its plain PyTorch version on the card, at edge
   shapes (2a: the segment sum at the bounds of its three paths, with
   runs, unaligned lengths and offset pointers, and on each path and
   float dtype five launches on one input returning the same bits, also
   where segments differ in magnitude by 2^100; the substring find and
   its fused exists_before at row widths 1 to 128, base pointers 0 to 15
   bytes off alignment and pattern lengths 0 to L + 1; the WKV recurrence
   on strided inputs with its state written in place, in both forms (the
   serial kernel and the chunked one, forced at T 1 to 200 across its
   chunks, w down to 1e-12, each launched twice to repeat bit for bit,
   and chained over 2 chunks and a remainder against one call); the backward
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
   MusicGen: head dim 64), RWKV6-7B's decode recurrence (the serial
   form) and its training and prefill shape, T 4096 (the chunked form,
   and the serial one beside it), the backward kernels at the training shapes of phase 8b, their
   device times summed over every kernel of a call), with times and
   bounds;
3. the TPC-H main path: tables generated from ``--seed`` at ``--sf``,
   frames built on the card, the 22 queries run twice through the
   dataframe API; the segment-sum and substring kernels' launch counts
   must rise during that run (the first pass's launches are printed by
   path for the segment sum and by form for the substring search, whose
   fused exists_before must have run), and the segment sum's mid path
   timed at the inputs of the query that launches it most (each K1 row
   beside ``index_add_`` and ``index_add_`` under
   ``torch.use_deterministic_algorithms``); then a third
   pass under ``torch.profiler`` for the device's busy share, each ported
   kernel's launches counted in it and its device time read from it (a
   query is profiled again, up to ``PROFILE_TRIES`` sessions, while a
   kernel it launched shows no device time), and the three slowest warm
   queries once more under ``cProfile``; then (3d) the SQL front end on
   the same frames, op by op (``CONFIG.compiled = "off"``): the 22 TPC-H
   SQL texts through ``repro_torch.sql`` twice (plan time, then cold and
   warm execution), each result held to
   its frame query (the same column names, the same rows, floats within
   rtol 1e-8) and pass 2 to pass 1; K1 must launch in every text whose
   plan groups through it and K2's find in q9, q13 and q16 (launches
   printed by path and by form), q15's revenue SUM run twice (none of
   its sums may differ in its bits); then the 22 texts over store tables
   built from the same arrays (``as_store``, fact tables sorted by
   date, chunks of 65,536 rows), each equal to the in-memory SQL
   result (under the default ``out_of_core = "auto"`` the aggregates
   over lineitem and orders stream chunk by chunk: the texts that
   streamed are printed), and q6's pushed ``l_shipdate`` scan, whose
   skipped chunks the store's scan counts, run through the plan; then
   (3e) the same
   texts compiled (``CONFIG.compiled = "force"``), one CUDA graph per
   plan: a cold run (trace, warm-up, capture, replay; K1 and K2 calls
   in the graph counted through their wrappers), two warm replays, each
   result equal to 3d's op-by-op result (where the text has ORDER BY,
   its key columns row by row; rows tied on every key may swap) and to
   its frame query, 22 captures and no fallback; a
   literal of each text that has one changed: a cache hit without a
   capture, equal to op by op for that literal; q15 four times, its row
   each time; q1 under ``auto``; one profiled warm pass (the kernels
   inside the graphs by device name: K1 and K2 calls must equal the
   captured ones; busy and idle share); a PreparedStatement over q6, 1
   capture and 3 hits; trace, capture, cold and warm ms per text beside
   op by op's, and the peak allocated GB;
10. out of core, on 3d's stores: the 22 texts under
   ``out_of_core = "force"``, each equal to 3d's in-memory result (q1,
   q6 and q14 must stream, q15 must return its row; the texts that
   streamed and ``pipeline.STATS`` printed), every K1 call of the
   streamed q1 and q14 held to its plain version (the largest chunk and
   merge calls timed beside ``index_add_``), the streamed texts again
   under a 1 KiB spill budget (bytes spilled and re-read, results
   unchanged), a profiled forced q1 (idle share), then
   ``python -m repro_torch.launch.run_capped sweep`` in child processes
   over the eight tables written to disk: the cap goes between the
   measured peaks of an uncapped eager and an uncapped streamed child,
   the eager child must die of ``torch.OutOfMemoryError`` under it and
   the streamed child must match the uncapped results;
11. SQL serving: one ``Executor`` over the TPC-H scope (lineitem and
   orders as stores, the rest as frames), 4 client threads each
   submitting the 22 texts in an order shuffled from ``--seed`` and only
   waiting on their futures, each result equal to 3d's; batches,
   coalesced requests and shared scans counted, none failing; p50 and
   p99 latency and queries per second; a ``Prepared`` q6 over frames
   with 8 literals (1 capture, 7 hits, each equal to op by op), a
   session UDF equal to its inline expression, q21 under a 1 ms
   deadline (``QueryTimeout``), a request cancelled while queued
   (``QueryCancelled``) and a session over its in-flight cap
   (``ResourceExhausted``); K1 and K2 must launch;
12. the distributed layer (``repro_torch.dist``) on the same frames and
   stores: (a) in a one-rank NCCL group (``dframe.init_local``; its CUDA
   backend must be NCCL) the 22 frame queries twice, the 22 SQL texts
   op by op and a forced out-of-core q1 under ``CONFIG.distributed =
   "force"``, each equal to its local result (ints, codes and order
   exactly, floats within rtol 1e-12; whether every bit held is
   printed), K1's launches in a routed pass equal to a local pass's,
   one ``all_reduce`` a routed group sum and every semi/anti probe
   through the gathered mask; the local passes under ``auto`` with the
   group up call no collective; lineitem's (l_orderkey,
   l_extendedprice) repartitioned from 3d's store chunks (dropped 0,
   every row present, per-key sums equal to the local group-by); (b) a
   simulated world of 4: each op's shard-local function for ranks 0 to
   3 on the card, combined in rank order, the group sums within rtol
   1e-12 of the local ones, the semi mask and the repartition slots
   exactly the CPU's; (c) ``quantize`` of a 5120 x 17408 float32 tensor,
   codes and scales equal to the CPU's, ``compressed_mean`` over the
   group, a one-stage ``pipeline_forward`` equal to the sequential loop,
   and a reduced config's weights placed by their partition specs on a
   (1, 1) device mesh, checkpointed and restored with ``shardings=``,
   bit-equal; routed against local times beside the card's name and
   power limit;
4. the card against the CPU plain path on all 22 queries and the 22 SQL
   texts at SF 0.01 (60,000 lineitem rows: the texts take the compiled
   route under ``auto`` on both devices): ints, codes and row order
   exactly, floats within rtol 1e-8;
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
   backward launches of a step asserted (K5's forward in the form of its
   T: at 4096 the chunked one), step time, tokens per second,
   peak memory and a profiled step;
13. (run after phase 8) the sharded dry run and the step on DTensors:
   (a) ``python -m repro_torch.launch.dryrun`` in child processes for
   Qwen3-14B ``train_4k`` (depth cut to 16 layers through
   ``--override n_layers=``, the cut printed) and RWKV6-7B
   ``prefill_32k`` on the 16 x 16 fake mesh at full width, each ``ok``,
   one JSON line each with its seconds; (b) on a one-rank NCCL group and
   a (1, 1) mesh, every weight, optimizer leaf and batch a DTensor placed
   by its spec, at full width and 2 layers: a Qwen3-14B train step of 4 x
   4096 tokens and a prefill, and an RWKV6-7B prefill, each bit-equal to
   the unsharded step's with equal K4, K4-bwd and K5 launches (K4 and K5,
   at T 4096 K5's chunked form, run on the local shards through
   ``local_map``); (c) ``run_cell(...,
   mesh=)`` predicts the sharded train step's peak, printed beside
   ``torch.cuda.max_memory_allocated`` and their ratio, which must lie
   in [0.8, 1.25];
14. (run after phase 13) the six example twins (``repro_torch.examples``)
   on the card at their scripts' own sizes, each beside a run on the
   CPU: ``quickstart`` (its filtered count and revenue table),
   ``sql_quickstart`` (its three results) and ``tpch_analytics`` (the 22
   queries at SF 0.01) equal to the CPU's (ints, codes and order exactly,
   floats within rtol 1e-8); ``serve_lm`` serving 12 of 12 requests,
   each to its ``max_new``, on both (tokens equal to the CPU's counted);
   ``train_lm`` (about 100 M parameters, ``EXAMPLE_TRAIN_STEPS`` of the
   script's 300 steps)
   with its loss falling and a checkpoint written; ``distributed_groupby``
   at world 1 (a one-rank NCCL group, then a gloo one on the CPU): the
   semi join's count and the shuffle exactly the CPU's, the float32
   group sums within 1e-3 of ``np.add.at``'s and of the CPU's; K1 and K2
   must launch in ``quickstart`` and ``tpch_analytics``, K1 in
   ``distributed_groupby``, K4 forward and backward in ``train_lm``; one
   JSON line of each twin's wall seconds and kernel launches;
9. (run after phase 4) TPC-DS and storage: the five TPC-DS queries at SF
   1 from ``--seed`` on frames on the card, twice (cold and warm; each
   query that groups must launch the segment sum; pass 2 held to pass 1),
   every segment sum of pass 1 held to its plain version on its own
   inputs (the largest on each path also timed), pass 1 against the five
   queries on the CPU over the same tables (none may be empty), a
   profiled warm pass; the store path: ``as_store`` date-sorted into
   chunks of 65,536 rows, one year of ``store_sales`` loaded through
   ``from_store`` with its predicate pushed (chunks must be skipped; the
   frame equals ``from_arrays`` plus the same filter, row for row), q3
   over frames from the stores equal to q3 over ``from_arrays`` frames;
   the loaders: ``store_sales`` through ``write_tfb`` / ``read_tfb`` onto
   the card, exact, also with a projection and a predicate, and
   ``customer`` through ``write_csv`` / ``read_csv``; one traced q3 with
   its join spans;
5. one JSON line of the compiled pass (phase 3e), one of phase 10, one
   of phase 11, one of phase 12, one of phase 14, one of phase 13 (each kernel's launches
   on DTensors also in the kernels line, ``launches_sharded``), one of
   the SQL pass's launches (phase
   3d), one JSON line describing every kernel (its launches those of its
   main path; K1's and K2's launches in phases 10 and 11, and K1's in
   phase 12, beside them), the
   card's name and power limit, and as the last line
   ``{"ok": true, "device": {...}}``.

Needs a CUDA device; imports nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W) for the
# bound each kernel is held to: device-memory bandwidth; the
# non-tensor-core float32 rate, for the segment sum, the substring search
# and the tuple hash (the table has no integer, float64 or int64 entry;
# those kernels are bounded by bytes either way); the bf16 tensor-core
# rate, for attention on bf16 inputs; and the TF32 tensor-core rate, for
# the WKV recurrence on bf16 inputs, forward and backward (its products
# of bf16 operands and float32 decays run on the tensor cores in TF32, as
# the chunked forward runs them: bound by bytes at RWKV6-7B's shapes),
# and for attention on float32 inputs, which takes three TF32 products for
# each float32-accurate one (split TF32: a_lo b_hi + a_hi b_lo + a_hi
# b_hi), an effective 165 TFLOP/s.  Where the rate is a tensor-core one
# (K5, K4 on float32 inputs), the bound at the CUDA cores' 67 TFLOP/s is
# reported beside it (``bound_cuda_cores_ms``).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
PEAK_BF16_OPS_PER_S = 989e12
PEAK_TF32_OPS_PER_S = 495e12
TF32_PRODUCTS = 3

# Tolerances of kernel vs plain version on one call.  The kernel's float
# sums are exact integer sums on each segment's own grid, the same bits
# on every launch (phase 2a checks that), and the plain version adds in
# row order: float64 agrees to rtol 1e-12, float32 (24-bit mantissa, up
# to millions of terms) to rtol 1e-4, of the largest result; for values
# of both signs (the edge shapes), of the largest sum of |value| over a
# segment, the scale of a sum's rounding in any order (a sum that cancels
# can be far smaller than its terms).  The 2^100-spread shape holds each
# segment to its own sum of |value|.
RTOL = {"float64": 1e-12, "float32": 1e-4}
# Launches of one K1 input that must return the same bits (phase 2a).
K1_REPEATS = 5
QUERY_RTOL = 1e-8
# Scale factor of the card-vs-CPU check (phase 4), and timed repetitions
# of each kernel at each main-path shape (phase 2b).
CHECK_SF = 0.01
REPS = 20
# Profiler sessions tried for one kernel's device time (phases 2b, 3b and
# 9), and the short kernels (torch.cuda._sleep, whose device kernel is
# named spin_kernel) that open each session of phases 3b and 6 and of
# ``device_ms`` before the work it measures, to take the loss of a
# session's first device events (three sessions in a row of one phase 9
# row once recorded no kernel)
PROFILE_TRIES = 5
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
# TPC-DS and the store (phase 9): the scale factor (2,880,000 store_sales
# rows), the store's chunk rows, the queries that group (each launches K1),
# the year of sales the store path loads, and the rows of customer
# written to CSV and read back
TPCDS_SF = 1.0
STORE_CHUNK_ROWS = 1 << 16
TPCDS_GROUPING = ("q3", "q6", "q7", "q42")
# The capped runner's sweep (phase 10): its four child processes together
CAPPED_TIMEOUT_S = 900
STORE_YEAR = 2000
#: the kernels of training's backward (no TPU counterpart)
BACKWARD_KERNELS = ("flash_attention_bwd_sm90", "flash_attention_bwd_f32_sm90", "wkv6_bwd")
#: phase 14: the phase's budget in seconds, and ``train_lm``'s steps: 100
#: of the script's 300, since its eager step is host-bound (about 230 to
#: 385 ms on the card) and 300 steps alone took 115 s
EXAMPLES_BUDGET_S = 90.0
EXAMPLE_TRAIN_STEPS = 100
SCRIPT_TRAIN_STEPS = 300
#: phase 14: the kernels each twin must launch on the card (a tuple: any
#: one of its forms)
EXAMPLE_KERNELS = {
    "quickstart": (("segment_sum",), ("substr_find",)),
    "tpch_analytics": (("segment_sum",), ("substr_find",)),
    "distributed_groupby": (("segment_sum",),),
    "train_lm": (("flash_attention_sm90", "flash_attention_f32_sm90"),
                 ("flash_attention_bwd_sm90", "flash_attention_bwd_f32_sm90")),
}
#: phase 14: the float32 group sums of ``distributed_groupby`` against
#: ``np.add.at``'s and the CPU's (the script's own ``max_err`` check)
EXAMPLE_SUM_TOL = 1e-3


#: the script's start, which each phase's header line counts from
T_START = time.perf_counter()


def log(*parts) -> None:
    if parts and str(parts[0]).startswith("phase "):
        parts = (*parts, f"[at {time.perf_counter() - T_START:.1f} s]")
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


def device_ms(torch, fn, kernel_key: str, reps: int, per_call: bool = False,
              breakdown=None) -> float:
    """Mean device time of one launch of the kernel whose name holds
    ``kernel_key``, from ``torch.profiler`` over ``reps`` calls of ``fn``:
    the kernel alone, where ``cuda_ms`` also sees the host time of a
    wrapper that cannot keep the card busy.  With ``per_call``, the time of
    one call of a wrapper that launches several such kernels, once each:
    the sum of each kernel's mean launch, which a session that loses a
    first device event (section 7 of PERF.md) does not skew; a dict
    passed as ``breakdown`` receives each kernel's mean launch by name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # A profiler session now and then records no device events at all;
    # the measurement is taken again, up to PROFILE_TRIES sessions.
    for attempt in range(1, PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(PAD_KERNELS):
                torch.cuda._sleep(PAD_CYCLES)
            torch.cuda.synchronize()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        hits = [(ms, n) for key, (ms, n) in device_busy(prof)[1].items() if kernel_key in key]
        if hits and breakdown is not None:
            breakdown.update({key: ms / n for key, (ms, n) in device_busy(prof)[1].items()
                              if kernel_key in key})
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
    segment_repeat_phase(torch, seg, dev, rng)

    substr_edge_phase(torch, sf, dev)


def segment_repeat_phase(torch, seg, dev, rng) -> None:
    """K1 is deterministic: on each path and value dtype, K1_REPEATS
    launches on one input (ids at random, so rows of a segment meet in
    any order) return the same bits, and agree with the plain version;
    then the 2^100-spread shape: segments of about 1e15 beside segments of
    about 1e-15 in one call, each held to its own sum of |value|."""
    n = 3_000_001
    for dtype in (torch.float32, torch.float64):
        for m in (6, 1000, 1_500_000):
            g = torch.as_tensor(segment_ids(rng, n, m, "unsorted"), device=dev)
            v = torch.as_tensor(rng.normal(size=n) * 1e3, device=dev).to(dtype)
            outs = [seg.segment_sum_cuda(v, g, m) for _ in range(K1_REPEATS)]
            if not all(torch.equal(outs[0], o) for o in outs[1:]):
                raise AssertionError(f"segment_sum {dtype} m={m}: {K1_REPEATS} launches on one "
                                     "input returned different bits")
            check_segment_sum(torch, seg, v, g, m, f"repeat n={n}", quiet=True, signed=True)
            log(f"  segment_sum {dtype} m={m} path {seg.segment_path(m)}: {K1_REPEATS} launches "
                f"on one input of {n} rows bit-identical, within tolerance of the plain version")
    for dtype in (torch.float32, torch.float64):
        for m in (8, 1000, 1_500_000):
            g = torch.as_tensor(rng.integers(0, m, n), device=dev)
            # even segments near 1e15, odd ones near 1e-15: a spread of 2^100
            mag = torch.where(g % 2 == 0, 1e15, 1e-15).to(torch.float64)
            v = (torch.as_tensor(rng.normal(size=n), device=dev) * mag).to(dtype)
            outs = [seg.segment_sum_cuda(v, g, m) for _ in range(K1_REPEATS)]
            if not all(torch.equal(outs[0], o) for o in outs[1:]):
                raise AssertionError(f"segment_sum spread {dtype} m={m}: launches differ in bits")
            want = seg.segment_sum_plain(v.to(torch.float64), g, m)
            scale = seg.segment_sum_plain(v.to(torch.float64).abs(), g, m)
            rtol = RTOL[str(dtype).replace("torch.", "")]
            err = ((outs[0].to(torch.float64) - want).abs() / scale.clamp(min=1e-300)).max()
            small = (scale > 0) & (scale < 1e-6)
            if not bool(small.any()) or float(err) > rtol:
                raise AssertionError(f"segment_sum spread {dtype} m={m}: error {float(err)!r} of "
                                     f"a segment's own sum of |value| (rtol {rtol})")
            log(f"  segment_sum spread 2^100 {dtype} m={m} path {seg.segment_path(m)}: "
                f"bit-identical over {K1_REPEATS} launches, largest error "
                f"{float(err)!r} of a segment's own sum of |value| (rtol {rtol})")


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
    # a float call launches four kernels (clear, exponents, limbs, finish):
    # the device time of a call is the sum of their mean launches
    d_ms = device_ms(torch, lambda: seg.segment_sum_cuda(v, g, m), "segment_sum_", REPS,
                     per_call=True)
    p_ms = cuda_ms(torch, lambda: seg.segment_sum_plain(v, g, m), REPS)

    def library():
        return torch.zeros(m, dtype=v.dtype, device=dev).index_add_(0, g, v)

    l_ms = cuda_ms(torch, library, REPS)
    # the library's deterministic route: the yardstick of a deterministic sum
    torch.use_deterministic_algorithms(True)
    try:
        det_ms = cuda_ms(torch, library, REPS)
    finally:
        torch.use_deterministic_algorithms(False)
    nbytes = v.numel() * (v.element_size() + 8) + m * v.element_size()
    b_ms, b_by = bound_ms(nbytes, v.numel())
    row = dict(label=label, n=v.numel(), m=m, dtype=str(v.dtype), path=seg.segment_path(m),
               max_abs_err=err, ms=k_ms, device_ms=d_ms, plain_ms=p_ms, library_ms=l_ms,
               library_deterministic_ms=det_ms, bound_ms=b_ms, bound_by=b_by)
    log("   ", json.dumps(row))
    return row


def record_segment_sums(ops, seg, calls: dict, current: list, paths=("few", "mid", "many")):
    """Wrap ``ops.segment_sum_cuda`` so that each call on one of ``paths``
    also keeps a copy of its inputs in ``calls``, under the query named in
    ``current[0]``.  Returns the function it wrapped, to put back after."""
    real = ops.segment_sum_cuda

    def recording(values, ids, m):
        if seg.segment_path(m) in paths:
            calls.setdefault(current[0], []).append((values.clone(), ids.clone(), m))
        return real(values, ids, m)

    ops.segment_sum_cuda = recording
    return real


def mid_path_rows(torch, seg, ops, QF, frames, sf: float, dev) -> list:
    """K1's mid path (17 to 4096 groups) at main-path shapes: one pass of
    the queries records the inputs of every mid-path call by query; the
    largest call of the query with the most of them is timed, and the
    largest call of the pass where that is another."""
    calls: dict = {}
    current = [None]
    real = record_segment_sums(ops, seg, calls, current, paths=("mid",))
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


def wkv6_call(form=None):
    """K5's wrapper (the form of the call's T), or the launcher of the
    forward form ``form`` at any T."""
    from repro_torch.kernels.wkv6 import _wkv6_launch, wkv6_cuda

    return wkv6_cuda if form is None else functools.partial(_wkv6_launch, form)


def check_wkv6(torch, args, label: str, form=None) -> float:
    """K5 (the form ``wkv6_form`` picks by T, or ``form``) against its plain
    version on the same inputs, launched twice: the second launch must
    give the same bits."""
    from repro_torch.kernels.wkv6 import wkv6_form, wkv6_plain

    call = wkv6_call(form)
    y, s = call(*args)
    y2, s2 = call(*args)
    y_want, s_want = wkv6_plain(*args)
    torch.cuda.synchronize()
    tol = WKV6_TOL[str(args[0].dtype).replace("torch.", "")]
    err_y, ok_y = allclose_err(torch, y, y_want, tol)
    err_s, ok_s = allclose_err(torch, s, s_want, tol)
    again = torch.equal(y, y2) and torch.equal(s, s2)
    log(f"  {form or wkv6_form(args[0].shape[2])} {label}: r {tuple(args[0].shape)} "
        f"{args[0].dtype} state={'yes' if args[5] is not None else 'no'} max_abs_err "
        f"y={err_y!r} state={err_s!r} (tol {tol}) {'ok' if ok_y and ok_s else 'MISMATCH'}, "
        f"second launch {'bit-equal' if again else 'DIFFERS'}")
    if not (ok_y and ok_s and again):
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


def check_wkv6_in_place(torch, rng, dev, dtype, B, H, T, D, form=None, w_low=None) -> float:
    """K5 (the form of T, or ``form``) on strided inputs with ``state_out``:
    aliased to the state (the decode step's form) and a separate buffer,
    against the plain version on the same inputs; the state passed
    without ``state_out`` is left as it was."""
    from repro_torch.kernels.wkv6 import wkv6_plain

    call = wkv6_call(form)
    r, k, v, w, u, s0 = wkv6_inputs(torch, rng, dev, dtype, B, H, T, D, True, strided=True,
                                    w_low=w_low)
    tol = WKV6_TOL[str(dtype).replace("torch.", "")]
    y_want, s_want = wkv6_plain(r, k, v, w, u, s0)
    kept = s0.clone()
    y_pure, s_pure = call(r, k, v, w, u, s0)
    alias = s0.clone()
    y_alias, s_alias = call(r, k, v, w, u, alias, state_out=alias)
    other = torch.full_like(s0, float("nan"))
    _, s_other = call(r, k, v, w, u, s0, state_out=other)
    torch.cuda.synchronize()
    errs, ok = [], torch.equal(s0, kept) and s_alias is alias and s_other is other
    for got, want in ((y_pure, y_want), (s_pure, s_want), (y_alias, y_want),
                      (s_alias, s_want), (s_other, s_want)):
        err, fine = allclose_err(torch, got, want, tol)
        errs.append(err)
        ok = ok and fine
    log(f"  {form or 'wkv6'} strided, state_out aliased and apart: r {tuple(r.shape)} strides "
        f"{r.stride()} {dtype} w from {w_low or 0.7} max_abs_err={max(errs)!r} (tol {tol}) "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        raise AssertionError("wkv6 kernel with strided inputs or state_out disagrees")
    return max(errs)


def lm_edge_phase(torch, dev) -> None:
    from repro_torch.kernels.wkv6 import CHUNK, wkv6_cuda

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
        # the chunked form (csrc/wkv6_chunked.cu), forced at any T: one
        # step, ragged across its chunks of 64 and sub-chunks of 16 steps,
        # D 16 to 128, w down to 1e-12, with and without a state; strided
        # with state_out aliased and apart; 2 chunks and a remainder chained
        # through the state against one call
        for B, H, T, D in [(1, 2, 1, 16), (2, 3, 63, 32), (1, 2, 65, 64), (2, 2, 200, 128),
                           (1, 3, 129, 16), (3, 5, 7, 64)]:
            for with_state in (False, True):
                args = wkv6_inputs(torch, rng, dev, dtype, B, H, T, D, with_state, w_low=1e-12)
                check_wkv6(torch, args, "edge, w from 1e-12", form="wkv6_chunked")
        for B, H, T, D in [(1, 2, 1, 16), (4, 64, 70, 64), (2, 4, 131, 64), (1, 2, 200, 128)]:
            check_wkv6_in_place(torch, rng, dev, dtype, B, H, T, D, form="wkv6_chunked",
                                w_low=1e-12)
        # a state 4 bytes off 16-byte alignment (the scan's one-element path)
        args = wkv6_inputs(torch, rng, dev, dtype, 2, 3, 150, 32, True, w_low=1e-12)
        buf = torch.zeros(args[5].numel() + 1, device=dev)
        args[5] = buf[1:].view_as(args[5]).copy_(args[5])
        check_wkv6(torch, args, "edge, state off alignment", form="wkv6_chunked")
        T = 2 * CHUNK + 37
        r, k, v, w, u, s0 = wkv6_inputs(torch, rng, dev, dtype, 2, 4, T, 64, True, strided=True,
                                        w_low=1e-12)
        chunked = wkv6_call("wkv6_chunked")
        y, s = chunked(r, k, v, w, u, s0)
        state, ys = s0, []
        for a, b in ((0, CHUNK), (CHUNK, 2 * CHUNK), (2 * CHUNK, T)):
            y_p, state = chunked(*(t[:, :, a:b] for t in (r, k, v, w)), u, state)
            ys.append(y_p)
        err_y, ok_y = allclose_err(torch, torch.cat(ys, 2), y, tol)
        err_s, ok_s = allclose_err(torch, state, s, tol)
        log(f"  wkv6_chunked chained {CHUNK} + {CHUNK} + {T - 2 * CHUNK} steps vs {T} in one "
            f"call, {dtype}: max_abs_err y={err_y!r} state={err_s!r} "
            f"{'ok' if ok_y and ok_s else 'MISMATCH'}")
        if not (ok_y and ok_s):
            raise AssertionError("wkv6_chunked kernel: three chained calls differ from one")


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
    from repro_torch.kernels.wkv6 import CHUNKED_MIN_T, wkv6_cuda

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
    # the chunked forward under Wkv6Fn (T past CHUNKED_MIN_T)
    T = CHUNKED_MIN_T + 22
    args = [both(2, 3, T, 32) for _ in range(3)] + [both(2, 3, T, 32, low=0.7), both(3, 32),
                                                    both(2, 3, 32, 32)]
    compare("ops.wkv6 (chunked form)", ops.wkv6, args, ("wkv6_chunked", "wkv6_bwd"))
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

    from repro_torch.kernels.flash_attention import (
        attention_cost, flash_attention_plain, flash_attention_sm90,
    )

    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    qd = q.contiguous()
    nbytes, nops = attention_cost(B, Hq, Hkv, Sq, Sk, D, causal, q.element_size())
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
    from repro_torch.kernels.flash_attention import (
        attention_cost, flash_attention_cuda, flash_attention_plain,
    )
    from repro_torch.kernels.wkv6 import wkv6_cost, wkv6_plain

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
    nbytes, _ = attention_cost(B, Hq, Hkv, S, S, D, True, q.element_size())
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
    # decode shape (the serial form's main path), then at T 4096, the
    # training and prefill shape (serving does not prefill: it feeds
    # prompts through the decode step), in the chunked form (its main
    # path) and, beside it, in the serial form on the same inputs; device
    # time by name prefix: the serial kernel's, or the sum of the chunked
    # form's three kernels (wkv6c_chunk_kernel twice, wkv6c_scan_kernel)
    rc = get("rwkv6-7b")
    H, D = rc.n_heads, rc.d_model // rc.n_heads
    rows = {"wkv6": [], "wkv6_chunked": []}
    plain = {}
    for B, T, reps, what, form, key in (
            (SLOTS, 1, LM_REPS * 10, "decode", "wkv6", "wkv6_kernel"),
            (1, PREFILL_LEN, LM_REPS, "training", "wkv6_chunked", "wkv6c_"),
            (1, PREFILL_LEN, LM_REPS, "training", "wkv6", "wkv6_kernel")):
        if T not in plain:
            args = wkv6_inputs(torch, rng, dev, torch.bfloat16, B, H, T, D, True, strided=True)
            plain[T] = cuda_ms(torch, lambda: wkv6_plain(*args), reps if T == 1 else 1)
        label = (f"rwkv6-7b {what}: B={B} H={H} T={T} D={D} bf16, strided, "
                 f"state f32 written in place, {form}")
        err = check_wkv6(torch, args, label, form=form)
        r, k, v, w, u, s0 = args
        state = s0.clone()
        step = lambda: wkv6_call(form)(r, k, v, w, u, state, state_out=state)
        k_ms = cuda_ms(torch, step, reps)
        parts = {}
        d_ms = device_ms(torch, step, key, reps, per_call=True, breakdown=parts)
        nbytes, nops = wkv6_cost(B, H, T, D, r.element_size(), u.element_size())
        b_ms, b_by = bound_ms(nbytes, nops, PEAK_TF32_OPS_PER_S)
        row = dict(label=label, max_abs_err=err, ms=k_ms, device_ms=d_ms, plain_ms=plain[T],
                   library_ms=None, bound_ms=b_ms, bound_by=b_by, bytes=nbytes, ops=nops,
                   bound_cuda_cores_ms=bound_ms(nbytes, nops)[0], device_ms_by_kernel=parts)
        log("   ", json.dumps(row))
        rows[form].append(row)
        del r, k, v, w, state
    out.update(rows)
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
        BWD_KERNELS, attention_bwd_cost, flash_attention_bwd_cuda, flash_attention_bwd_plain,
        flash_attention_fwd_cuda,
    )
    from repro_torch.kernels.wkv6 import wkv6_bwd_cost, wkv6_bwd_cuda, wkv6_bwd_plain

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
        nbytes, nops = attention_bwd_cost(B, Hq, Hkv, S, S, D, True, q.element_size())
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
    nbytes, nops = wkv6_bwd_cost(1, H, TRAIN_SEQ, D, args[0].element_size())
    b_ms, b_by = bound_ms(nbytes, nops, PEAK_TF32_OPS_PER_S)
    row = dict(label=label, max_abs_err=err, ms=k_ms, device_ms=d_ms, plain_ms=p_ms,
               library_ms=None, bound_ms=b_ms, bound_by=b_by, bytes=nbytes, ops=nops,
               bound_cuda_cores_ms=bound_ms(nbytes, nops)[0])
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
    from repro_torch.kernels.wkv6 import wkv6_form
    from repro_torch.models.config import reduced
    from repro_torch.serve.engine import Request, ServeEngine

    log(f"phase 7: LM path, card vs CPU (reduced float32 configs, logits within {LM_CHECK_TOL})")
    out = {}
    for arch, over in (("qwen3-14b", {"n_kv_heads": 2}), ("rwkv6-7b", {}), ("dbrx-132b", {}),
                       ("kimi-k2-1t-a32b", {}), ("zamba2-2.7b", {}),
                       ("llama-3.2-vision-90b", {}), ("musicgen-medium", {})):
        cfg = reduced(get(arch), **over)
        kernel, want_launches = ((wkv6_form(128), cfg.n_layers) if cfg.family == "rwkv6"
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
def train_launches(cfg, seq: int) -> dict:
    """Kernel launches of one microbatch's forward and backward of ``seq``
    steps under ``remat="nothing"``: a checkpointed block runs its forward
    twice (once more in the backward), the hybrid's shared attention block,
    which is not checkpointed, once; one backward launch per layer (K4's
    of the compute dtype, both on the tensor cores: bf16, or float32 in
    split TF32; K5's forward in the form ``wkv6_form`` picks by ``seq``)."""
    if cfg.family == "rwkv6":
        from repro_torch.kernels.wkv6 import wkv6_form

        return {wkv6_form(seq): 2 * cfg.n_layers, "wkv6_bwd": cfg.n_layers}
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
        want = train_launches(cfg, batch["labels"].shape[1])
        if launched != want:
            raise AssertionError(f"{arch}: a microbatch launched {launched}, wants {want}")
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
    want = {n: c * cfg.microbatches for n, c in train_launches(cfg, TRAIN_SEQ).items()}
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
def run_queries(torch, QF, frames, sf: float, names=None):
    results, ms = {}, {}
    for q in names or sorted(QF.ALL, key=lambda s: int(s[1:])):
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


def compare_exact(label: str, got: dict, want: dict) -> None:
    """Every column bit for bit (NaN equal to NaN), in the same order."""
    if list(got) != list(want):
        raise AssertionError(f"{label}: columns {list(got)} != {list(want)}")
    for name in want:
        a, b = np.asarray(got[name]), np.asarray(want[name])
        same = a.shape == b.shape and (
            np.array_equal(a, b, equal_nan=True) if a.dtype.kind == "f" else (a == b).all())
        if not same:
            raise AssertionError(f"{label}.{name}: not equal, row for row")


def run_counted(torch, ops, QF, frames, sf: float, current=None):
    """``run_queries``, with each query's segment-sum launches; the query
    running is named in ``current[0]`` where a list is given."""
    results, ms, k1 = {}, {}, {}
    for q in sorted(QF.ALL, key=lambda s: int(s[1:])):
        if current is not None:
            current[0] = q
        before = ops.LAUNCHES["segment_sum"]
        res, t = run_queries(torch, QF, frames, sf, [q])
        results[q], ms[q] = res[q], t[q]
        k1[q] = ops.LAUNCHES["segment_sum"] - before
    return results, ms, k1


# ----------------------------------------------------------------------
# phase 3d: the SQL front end
# ----------------------------------------------------------------------
#: the aggregates that reach K1 (a grouped min or max does not)
K1_AGGS = ("size", "count", "nunique", "sum", "mean")
#: the TPC-H texts whose LIKE runs on a dictionary of at least 2048
#: entries, which the packed path evaluates with K2's find
SQL_K2_QUERIES = ("q9", "q13", "q16")
#: q15's revenue view (its FROM item), a float SUM over 10,000 groups at SF 1
Q15_REVENUE = (
    "SELECT l_suppkey, SUM(l_extendedprice * (1 - l_discount)) AS r FROM lineitem "
    "WHERE l_shipdate >= DATE '1996-01-01' AND l_shipdate < DATE '1996-04-01' "
    "GROUP BY l_suppkey")


def groups_through_k1(plan) -> bool:
    from repro_torch.sql.lower import plan_nodes
    from repro_torch.sql.plan import Aggregate

    return any(isinstance(n, Aggregate) and n.keys and any(fn in K1_AGGS for _, fn, _ in n.aggs)
               for n in plan_nodes(plan))


def result_odf(res: dict) -> dict:
    """A result's host columns as the oracle's lists (None for NaN and
    missing strings, dates as days), the form ``assert_odf_equal``
    compares as sorted rows."""
    out = {}
    for name, arr in res.items():
        arr = np.asarray(arr)
        if arr.dtype.kind == "M":
            out[name] = arr.astype("datetime64[D]").astype(np.int64).tolist()
        elif arr.dtype.kind == "f":
            out[name] = [None if v != v else v for v in arr.tolist()]
        elif arr.dtype.kind in "iub":
            out[name] = arr.tolist()
        else:
            out[name] = [None if v is None else str(v) for v in arr.tolist()]
    return out


def compare_sets(orc, label: str, got: dict, want: dict) -> None:
    """The same column names in the same order, and the same rows as sets
    (ints and strings exact, floats within QUERY_RTOL); a scalar frame
    query's ``{name: value}`` against a one-row SQL result by value."""
    if list(got) != list(want):
        raise AssertionError(f"{label}: columns {list(got)} != {list(want)}")
    if all(np.ndim(v) == 0 for v in want.values()):
        for name, v in want.items():
            a = np.asarray(got[name])
            if a.shape != (1,) or not np.isclose(a[0], v, rtol=QUERY_RTOL, atol=0.0):
                raise AssertionError(f"{label}.{name}: {a} != {v}")
        return
    try:
        orc.assert_odf_equal(result_odf(got), result_odf(want), sort=True, rtol=QUERY_RTOL)
    except AssertionError as exc:
        raise AssertionError(f"{label}: rows differ: {exc}") from None


def sql_pass(torch, ops, sql, scope, texts: dict, device=None, streams=None):
    """Each text through ``sql.execute`` once (host clock ending in a
    synchronisation, the result read back included, as in
    ``run_queries``), with each query's K1 and K2 launches.  With a dict
    ``streams``, each query's chunk-streamed pipelines and fallbacks
    (``pipeline.STATS``) go there."""
    from repro_torch.core import pipeline

    results, ms, k1, k2 = {}, {}, {}, {}
    for q, text in texts.items():
        before = dict(ops.LAUNCHES)
        piped = (pipeline.STATS["pipelines"], pipeline.STATS["fallbacks"])
        t = time.perf_counter()
        res = sql.execute(text, scope, device=device).to_dict()
        torch.cuda.synchronize()
        ms[q] = (time.perf_counter() - t) * 1e3
        results[q] = res
        k1[q] = ops.LAUNCHES["segment_sum"] - before["segment_sum"]
        k2[q] = ops.LAUNCHES["substr_find"] - before["substr_find"]
        if streams is not None:
            streams[q] = (pipeline.STATS["pipelines"] - piped[0],
                          pipeline.STATS["fallbacks"] - piped[1])
    return results, ms, k1, k2


def sql_phase(torch, ops, sfk, frames, tables, sf: float, dev, frame_results: dict) -> dict:
    """Phase 3d: the 22 TPC-H texts through ``repro_torch.sql`` op by op
    (``CONFIG.compiled = "off"``; phase 3e compiles them) on phase 3's
    frames, twice, each held to its frame query; then over store tables
    built from the same arrays.  Returns the SQL pass's launches and its
    second pass's results and times."""
    from repro_torch import sql, store
    from repro_torch.core import TensorFrame
    from repro_torch.core import oracle as orc
    from repro_torch.core.config import CONFIG
    from repro_torch.data import tpch
    from repro_torch.queries.tpch_sql import TPCH_SQL, sql_text
    from repro_torch.sql.lower import _scan_pred, scan_cache_key
    from repro_torch.sql.plan import walk_scans

    log("phase 3d: the SQL front end op by op: the 22 TPC-H texts twice on phase 3's frames, "
        "then over store tables")
    t_phase = time.perf_counter()
    CONFIG.compiled = "off"
    names = sorted(TPCH_SQL, key=lambda s: int(s[1:]))
    texts = {q: sql_text(q, sf) for q in names}
    plan_ms, plans = {}, {}
    for q in names:
        t = time.perf_counter()
        plans[q] = sql.plan_query(texts[q], frames)
        plan_ms[q] = (time.perf_counter() - t) * 1e3

    ops.reset_launches()
    res1, ms1, k1, k2 = sql_pass(torch, ops, sql, frames, texts)
    by_path, by_form = dict(ops.PATH_LAUNCHES), dict(sfk.MODE_LAUNCHES)
    res2, ms2, _, _ = sql_pass(torch, ops, sql, frames, texts)
    launched = {name: ops.LAUNCHES[name] for name in ("segment_sum", "substr_find")}
    for q in names:
        first = next(iter(res2[q].values()))
        log(f"  {q}: plan {plan_ms[q]:.3f} ms, cold {ms1[q]:.3f} ms, warm {ms2[q]:.3f} ms, "
            f"rows {len(first)}; launches of pass 1: segment_sum {k1[q]}, substr_find {k2[q]}")
        check_finite(q, res2[q])
        compare_results(f"SQL {q}, pass 2 against pass 1", res2[q], res1[q])
        compare_sets(orc, f"SQL {q} against its frame query", res1[q], frame_results[q])
    log(f"  total: plan {sum(plan_ms.values()):.3f} ms, cold {sum(ms1.values()):.3f} ms, "
        f"warm {sum(ms2.values()):.3f} ms (execute includes its own planning); every result "
        f"equals its frame query (sorted rows, floats rtol {QUERY_RTOL}) and pass 2 pass 1")
    log(f"  segment_sum launches of pass 1 by path: {json.dumps(by_path)}; substr_find by "
        f"form: {json.dumps(by_form)}")
    grouped = [q for q in names if groups_through_k1(plans[q])]
    silent = [q for q in grouped if k1[q] == 0] + [q for q in SQL_K2_QUERIES if k2[q] == 0]
    if silent:
        raise AssertionError(f"SQL queries that launched no kernel of their path: {silent}")
    if by_form["find"] == 0:
        raise AssertionError("the SQL pass never launched substr_find's find form")
    if sum(by_form.values()) != sum(k2.values()):
        raise AssertionError(f"substr_find launches by form {by_form} do not add up to {k2}")
    log(f"  K1 launched in each of the {len(grouped)} queries whose plan groups through it "
        f"({', '.join(grouped)}); K2 in {', '.join(SQL_K2_QUERIES)}")

    # K1's float sums are deterministic: q15's revenue SUM run twice gives
    # the same bits (q15 compares two spellings of it for equality)
    rev = [sql.execute(Q15_REVENUE, frames).column("r") for _ in range(2)]
    differ = int(np.count_nonzero(rev[0] != rev[1]))
    log(f"  q15's revenue SUM run twice: {differ} of {len(rev[0])} sums differ in their bits")
    if differ:
        raise AssertionError(f"q15's revenue SUM: {differ} sums differ between two runs")

    # the same texts over store tables of the same arrays (tpch.as_store,
    # one table at a time for its time)
    stores, t_tables = {}, {}
    for name, cols in tables.items():
        t = time.perf_counter()
        stores.update(tpch.as_store({name: cols}, chunk_rows=STORE_CHUNK_ROWS,
                                    sort_fact_by_date=True))
        t_tables[name] = time.perf_counter() - t
    t_store = sum(t_tables.values())
    pushing = [q for q in names
               if any(s.predicates for s in walk_scans(sql.plan_query(texts[q], stores)))]
    # under the default out_of_core = "auto" the aggregates over lineitem
    # and orders (at least ooc_min_rows rows) stream chunk by chunk
    streams = {}
    t = time.perf_counter()
    res_s, ms_s, _, _ = sql_pass(torch, ops, sql, stores, texts, device=dev, streams=streams)
    t_pass = time.perf_counter() - t
    for q in names:
        compare_sets(orc, f"store SQL {q} against in-memory SQL", res_s[q], res2[q])
    streamed = [q for q in names if streams[q][0]]
    log(f"  store pass under out_of_core={CONFIG.out_of_core!r} (ooc_min_rows "
        f"{CONFIG.ooc_min_rows}): {len(streamed)} texts streamed ({', '.join(streamed)}); "
        f"pipelines and fallbacks by text: "
        f"{json.dumps({q: list(v) for q, v in streams.items() if any(v)})}")
    q6 = sql.plan_query(texts["q6"], stores)
    (scan,) = [s for s in walk_scans(q6) if s.predicates]
    preds = [_scan_pred(c, scan.alias) for c in scan.predicates]
    t = time.perf_counter()
    scanned = store.scan(stores[scan.table], list(scan.columns), preds)
    t_scan = time.perf_counter() - t
    if scanned.chunks_skipped == 0:
        raise AssertionError(f"q6's pushed scan of {scan.table} skipped no chunk")
    cache = {scan_cache_key(scan): TensorFrame.from_store(
        stores[scan.table], list(scan.columns), preds, result=scanned, device=dev)}
    compare_results("store SQL q6 through its counted scan",
                    sql.execute_plan(q6, stores, scan_cache=cache, device=dev).to_dict(),
                    res_s["q6"])
    slowest = sorted(ms_s, key=ms_s.get, reverse=True)[:3]
    log(f"  store: as_store {t_store:.3f} s ({len(stores)} tables, chunks of "
        f"{STORE_CHUNK_ROWS} rows, fact tables sorted by date; by table, s: "
        f"{json.dumps({k: round(v, 3) for k, v in t_tables.items()})}); the 22 texts over them "
        f"{t_pass:.3f} s (slowest {', '.join(f'{q} {ms_s[q]:.1f} ms' for q in slowest)}), each "
        f"equal to the in-memory SQL result; {len(pushing)} texts push a predicate into a "
        f"scan ({', '.join(pushing)})")
    log(f"  q6's pushed scan of {scan.table}: {scanned.chunks_skipped} of {scanned.chunks_total} "
        f"chunks skipped, {scanned.nrows} rows kept, scan {1e3 * t_scan:.3f} ms; q6 through it "
        f"equals the store pass's q6")
    del cache
    log(f"  phase 3d wall {time.perf_counter() - t_phase:.3f} s")
    CONFIG.compiled = "auto"
    # the stores go on to phases 10 and 11
    return dict(launches=launched, by_path=by_path, by_form=by_form, results=res2, ms=ms2,
                stores=stores, store_pass_s=t_pass, streamed=streamed)


# ----------------------------------------------------------------------
# phase 3e: compiled SQL, one CUDA graph per plan
# ----------------------------------------------------------------------
#: a literal of each text without a DATE literal, changed for phase 3e's
#: third run (the first DATE literal of the others moves on a day): a
#: pattern and what its first match becomes
TEXT_LITERAL_CHANGES = {
    "q2": (r"p_size = 15", "p_size = 16"),
    "q9": (r"\(1 - l_discount\)", "(2 - l_discount)"),
    "q11": (r"\* 0\.[0-9]+", "* 0.5"),  # the fraction, 0.0001 / SF
    "q17": (r"0\.2 \* AVG", "0.3 * AVG"),
    "q18": (r"> 300", "> 312"),
    "q19": (r"BETWEEN 1 AND 11", "BETWEEN 2 AND 11"),
    "q22": (r"> 0\.00", "> 1.00"),
}
#: the device-side names of a K1 call's first kernel (one per wrapper
#: call: int64 sums are one kernel, float sums start with their exponent
#: pass) and of a K2 call's kernel
GRAPH_K1_KEYS = ("IntSum", "ExpFlags")
GRAPH_K2_KEYS = ("substr_find_rows", "exists_before_rows")


def changed_text(q: str, text: str):
    """``text`` with one literal changed (every copy of it), or None for a
    text without a numeric or date literal."""
    import re

    m = re.search(r"DATE '(\d{4}-\d{2}-\d{2})'", text)
    if m:
        day = np.datetime64(m.group(1)) + np.timedelta64(1, "D")
        return text.replace(m.group(0), f"DATE '{day}'")
    if q in TEXT_LITERAL_CHANGES:
        pattern, new = TEXT_LITERAL_CHANGES[q]
        out, count = re.subn(pattern, new, text, count=1)
        if count != 1:
            raise AssertionError(f"{q}: no {pattern!r} in its text")
        return out
    return None


def order_keys(plan):
    """The ORDER BY columns of a plan (its top Sort, under any LIMIT),
    or None."""
    from repro_torch.sql.plan import Limit, Sort

    while isinstance(plan, Limit):
        plan = plan.child
    return [name for name, _ in plan.keys] if isinstance(plan, Sort) else None


def compare_ordered(orc, label: str, got: dict, want: dict, keys) -> None:
    """Results of a text with ORDER BY: the same rows (``compare_sets``),
    and the ORDER BY columns the same value by value down the rows (ints
    and strings exactly, floats within QUERY_RTOL); rows that tie on
    every ORDER BY column may come in either order, as SQL leaves them."""
    compare_sets(orc, label, got, want)
    if not keys or not set(keys) <= set(want):
        compare_results(label, got, want)
        return
    compare_results(f"{label}, ORDER BY {keys}", {k: got[k] for k in keys},
                    {k: want[k] for k in keys})


def graph_launches(per_op: dict, keys) -> tuple:
    """(launches, device ms) of the device kernels whose names hold ``keys``
    (any of them) in a profiler session's ops."""
    hits = [(ms, n) for key, (ms, n) in per_op.items() if any(k in key for k in keys)]
    return sum(n for _, n in hits), sum(ms for ms, _ in hits)


def compiled_phase(torch, ops, frames, sf: float, sql_run: dict, frame_results: dict) -> dict:
    """Phase 3e: the 22 TPC-H texts compiled (``CONFIG.compiled =
    "force"``), one captured CUDA graph each: a cold run (trace, warm-up,
    capture, replay), two warm runs (replays), each result equal to phase
    3d's op-by-op result (where the text has ORDER BY, its key columns row
    by row: rows tied on every key may swap) and
    to its frame query; a third run with a literal changed, a cache hit
    without a capture that equals op by op for that literal; q15 four
    times; q1 under ``auto``; one profiled warm pass (the kernels inside
    the graphs by their device names); a PreparedStatement."""
    from repro_torch import sql
    from repro_torch.core import oracle as orc
    from repro_torch.core.config import CONFIG
    from repro_torch.queries.tpch_sql import TPCH_SQL, sql_text
    from repro_torch.serve.engine import PreparedStatement
    from repro_torch.sql import compile as plan_compile

    log("phase 3e: compiled SQL, one CUDA graph per plan, on phase 3's frames")
    t_phase = time.perf_counter()
    names = sorted(TPCH_SQL, key=lambda s: int(s[1:]))
    texts = {q: sql_text(q, sf) for q in names}
    stats = plan_compile.STATS
    plan_compile.clear_cache()
    plan_compile.reset_stats()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    CONFIG.compiled = "force"

    def counters():
        return json.dumps({k: v for k, v in stats.items() if k != "plans"})

    def run(text):
        t = time.perf_counter()
        res = sql.execute(text, frames).to_dict()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t) * 1e3

    res, cold, warm, trace_ms, capture_ms, k1, k2 = {}, {}, {}, {}, {}, {}, {}
    for q in names:
        before, known = dict(ops.LAUNCHES), set(stats["plans"])
        res[q], cold[q] = run(texts[q])
        new = set(stats["plans"]) - known
        if len(new) != 1:
            raise AssertionError(f"compiled {q} captured no graph: {counters()}, "
                                 f"{list(plan_compile._NEGATIVE.values())}")
        (digest,) = new
        trace_ms[q] = 1e3 * stats["plans"][digest]["trace_s"]
        capture_ms[q] = 1e3 * stats["plans"][digest]["compile_s"]
        # the trace, the warm-up and the capture each call the wrappers once
        for counts, name in ((k1, "segment_sum"), (k2, "substr_find")):
            delta = ops.LAUNCHES[name] - before[name]
            if delta % 3:
                raise AssertionError(f"compiled {q}: {delta} {name} launches, not 3 a call")
            counts[q] = delta // 3
        for _ in range(2):
            before = dict(ops.LAUNCHES)
            again, warm[q] = run(texts[q])
            if dict(ops.LAUNCHES) != before:
                raise AssertionError(f"compiled {q}: a replay launched through a wrapper")
            compare_results(f"compiled {q}, warm run against cold", again, res[q])
    for q in names:
        check_finite(q, res[q])
        keys = order_keys(sql.plan_query(texts[q], frames))
        compare_ordered(orc, f"compiled {q} against op by op", res[q], sql_run["results"][q], keys)
        compare_sets(orc, f"compiled {q} against its frame query", res[q], frame_results[q])
        log(f"  {q}: trace {trace_ms[q]:.3f} ms, capture {capture_ms[q]:.3f} ms, cold "
            f"{cold[q]:.3f} ms, warm replay {warm[q]:.3f} ms (op by op warm "
            f"{sql_run['ms'][q]:.3f} ms), rows {len(next(iter(res[q].values())))}; K1 calls "
            f"{k1[q]}, K2 calls {k2[q]} in the graph")
    if stats["compiles"] != len(names) or stats["fallbacks"] or stats["hits"] != 2 * len(names):
        raise AssertionError(f"compiled pass: {counters()}")
    grouped = [q for q in names if groups_through_k1(sql.plan_query(texts[q], frames))]
    silent = [q for q in grouped if k1[q] == 0] + [q for q in SQL_K2_QUERIES if k2[q] == 0]
    if silent:
        raise AssertionError(f"compiled texts whose graph holds no kernel of their path: {silent}")
    op_ms = sum(sql_run["ms"].values())
    log(f"  total: trace {sum(trace_ms.values()):.3f} ms, capture {sum(capture_ms.values()):.3f} "
        f"ms, cold {sum(cold.values()):.3f} ms, warm replay {sum(warm.values()):.3f} ms against "
        f"op by op warm {op_ms:.3f} ms; {stats['compiles']} captures, 0 fallbacks; every result "
        f"equals op by op (ORDER BY keys row by row) and its frame query")

    # one literal changed: a hit, no capture, equal to op by op
    changed = {q: changed_text(q, texts[q]) for q in names}
    changed = {q: t for q, t in changed.items() if t is not None}
    for q, text in changed.items():
        compiles, hits = stats["compiles"], stats["hits"]
        got, _ = run(text)
        if stats["compiles"] != compiles or stats["hits"] != hits + 1:
            raise AssertionError(f"compiled {q} with a literal changed was not a cache hit")
        CONFIG.compiled = "off"
        want, _ = run(text)
        CONFIG.compiled = "force"
        compare_ordered(orc, f"compiled {q}, literal changed, against op by op", got, want,
                        order_keys(sql.plan_query(text, frames)))
    log(f"  a literal changed in {len(changed)} texts ({', '.join(changed)}): each a cache hit "
        f"with no capture, equal to op by op")

    rows15 = []
    for _ in range(4):
        got, _ = run(texts["q15"])
        rows15.append(len(next(iter(got.values()))))
        compare_results("compiled q15, again", got, res["q15"])
    if min(rows15) < 1:
        raise AssertionError(f"compiled q15 rows over 4 runs: {rows15}")
    log(f"  q15 four times: rows {rows15}, the same row each time")

    CONFIG.compiled = "auto"
    hits, skipped = stats["hits"], stats["skipped_small"]
    got, _ = run(texts["q1"])
    if stats["hits"] != hits + 1 or stats["skipped_small"] != skipped:
        raise AssertionError("q1 under compiled='auto' did not take its graph")
    compare_results("compiled q1 under auto", got, res["q1"])
    CONFIG.compiled = "force"
    log(f"  q1 under compiled='auto' ({frames['lineitem'].nrows} lineitem rows >= "
        f"{CONFIG.compiled_min_rows}): the same graph")

    # one profiled warm pass: the kernels inside the graphs by device name
    want_k1, want_k2 = sum(k1.values()), sum(k2.values())
    for attempt in range(1, PROFILE_TRIES + 1):
        wall, busy, per_op, pad = session(torch, lambda: [run(texts[q]) for q in names])
        got_k1, ms_k1 = graph_launches(per_op, ("segment_sum_",))
        calls_k1, _ = graph_launches(per_op, GRAPH_K1_KEYS)
        calls_k2, ms_k2 = graph_launches(per_op, GRAPH_K2_KEYS)
        if (calls_k1, calls_k2) == (want_k1, want_k2):
            break
        log(f"  profiler session {attempt} of {PROFILE_TRIES}: K1 calls {calls_k1} (want "
            f"{want_k1}), K2 {calls_k2} (want {want_k2}); pad kernels {pad}")
    else:
        raise AssertionError("the profiled compiled pass did not show every kernel call")
    log(f"  profiled warm pass: wall {wall:.3f} ms, device busy {busy:.3f} ms "
        f"({100 * busy / wall:.3f} %; idle share {100 - 100 * busy / wall:.3f} %); K1 {calls_k1} "
        f"calls ({got_k1} kernels) {ms_k1:.3f} ms, K2 {calls_k2} calls {ms_k2:.3f} ms; pad "
        f"kernels recorded {pad} of {PAD_KERNELS}")
    for key, (ms, count) in sorted(per_op.items(), key=lambda kv: -kv[1][0])[:10]:
        log(f"    {ms:.3f} ms  {count} x {key[:100]}")
    peak = torch.cuda.max_memory_allocated() / 1e9

    # a PreparedStatement: one capture, then hits
    plan_compile.clear_cache()
    plan_compile.reset_stats()
    ps = PreparedStatement(texts["q6"].replace("l_quantity < 24", "l_quantity < {qty}"), frames)
    for qty in (24, 25, 23, 30):
        got = ps.execute(qty=qty).to_dict()
        if qty == 24:
            compare_results("PreparedStatement q6", got, res["q6"])
    if (ps.calls, stats["compiles"], stats["hits"]) != (4, 1, 3):
        raise AssertionError(f"PreparedStatement: calls {ps.calls}, compiles {stats['compiles']}, "
                             f"hits {stats['hits']}")
    log("  PreparedStatement over q6, l_quantity < {qty} for 4 values: 1 capture, 3 hits")
    plan_compile.clear_cache()
    CONFIG.compiled = "auto"
    torch.cuda.empty_cache()
    log(f"  peak allocated after the compiled pass {peak:.3f} GB; phase 3e wall "
        f"{time.perf_counter() - t_phase:.3f} s")
    return dict(trace_ms=sum(trace_ms.values()), capture_ms=sum(capture_ms.values()),
                warm_ms=sum(warm.values()), op_warm_ms=op_ms, busy_ms=busy, wall_ms=wall,
                k1_calls=want_k1, k2_calls=want_k2, k1_device_ms=ms_k1, k2_device_ms=ms_k2,
                peak_gb=peak)


def tpcds_segment_rows(torch, seg, dev, calls: dict, launched: int) -> list:
    """Every segment sum of one TPC-DS pass held to its plain version on
    its own inputs; the largest call on each path is timed (a row of K1's
    other shapes)."""
    n_calls = sum(len(cs) for cs in calls.values())
    if n_calls != launched:
        raise AssertionError(f"recorded {n_calls} segment sums of {launched} launched")
    largest: dict = {}
    for q, cs in calls.items():
        errs = [check_segment_sum(torch, seg, v, g, m, f"TPC-DS {q}", quiet=True)
                for v, g, m in cs]
        seen = [[v.numel(), m, seg.segment_path(m), str(v.dtype)[6:], e]
                for (v, _, m), e in zip(cs, errs)]
        log(f"  {q}: each segment sum of pass 1 against its plain version "
            f"[n, m, path, dtype, max_abs_err]: {json.dumps(seen)}")
        for v, g, m in cs:
            path = seg.segment_path(m)
            if path not in largest or v.numel() > largest[path][1].numel():
                largest[path] = (q, v, g, m)
    return [segment_row(torch, seg, dev, f"TPC-DS {q}: its largest {path}-path sum ({v.dtype})",
                        v, g, m)
            for path, (q, v, g, m) in sorted(largest.items())]


def tpcds_phase(torch, ops, seg, dev, seed: int) -> list:
    """Phase 9: TPC-DS at SF 1 on the card, the store path, the loaders,
    the card against the CPU, and a traced query (see the docstring).
    Returns K1's rows at the largest TPC-DS call on each of its paths."""
    import tempfile

    from repro_torch import obs, store
    from repro_torch.core import TensorFrame, col
    from repro_torch.core import io as tio
    from repro_torch.core import oracle as orc
    from repro_torch.core.config import CONFIG
    from repro_torch.data import tpcds
    from repro_torch.queries import tpcds_frames as QD

    log(f"phase 9: TPC-DS SF {TPCDS_SF}, the store path and the loaders")
    t_phase = time.perf_counter()
    t = time.perf_counter()
    tables = tpcds.generate(sf=TPCDS_SF, seed=seed)
    t_gen = time.perf_counter() - t
    mem = torch.cuda.memory_allocated()
    t = time.perf_counter()
    frames = tpcds.as_frames(tables, device=dev)
    torch.cuda.synchronize()
    t_frames = time.perf_counter() - t
    frames_gb = (torch.cuda.memory_allocated() - mem) / 1e9
    ss = tables["store_sales"]
    n_ss = len(ss["ss_item_sk"])
    host_mb = sum(a.nbytes for cols in tables.values() for a in cols.values()) / 1e6
    log(f"  data: seed {seed}: generate {t_gen:.3f} s, frames on {dev} {t_frames:.3f} s, "
        f"store_sales {n_ss} rows, host arrays {host_mb:.3f} MB (object columns at 8 bytes "
        f"a cell), the frames take {frames_gb:.3f} GB of device memory")

    # the five queries twice; pass 1 keeps a copy of each segment sum's inputs
    ops.reset_launches()
    calls, current = {}, [None]
    real = record_segment_sums(ops, seg, calls, current)
    try:
        res1, ms1, k1_1 = run_counted(torch, ops, QD, frames, TPCDS_SF, current)
    finally:
        ops.segment_sum_cuda = real
    res2, ms2, k1_2 = run_counted(torch, ops, QD, frames, TPCDS_SF)
    log(f"  segment_sum launches of both passes by path: {json.dumps(ops.PATH_LAUNCHES)}")
    for q in ms1:
        first = next(iter(res2[q].values()))
        rows = 1 if np.ndim(first) == 0 else len(first)
        floats = [c for c in res1[q] if np.asarray(res1[q][c]).dtype.kind == "f"]
        bits = all(np.array_equal(res2[q][c], res1[q][c], equal_nan=True) for c in floats)
        log(f"  {q}: cold {ms1[q]:.3f} ms, warm {ms2[q]:.3f} ms, rows {rows}, segment_sum "
            f"launches {k1_1[q]} + {k1_2[q]}, floats of pass 2 bit-equal to pass 1: {bits}")
        check_finite(q, res2[q])
        compare_results(q, res2[q], res1[q])
    log(f"  total: cold {sum(ms1.values()):.3f} ms, warm {sum(ms2.values()):.3f} ms")
    idle = [q for q in TPCDS_GROUPING if not (k1_1[q] and k1_2[q])]
    if idle:
        raise AssertionError(f"TPC-DS queries that group but launched no segment_sum: {idle}")
    k1_rows = tpcds_segment_rows(torch, seg, dev, calls, sum(k1_1.values()))
    del calls

    # the card against the CPU on the same tables: pass 1's results
    t = time.perf_counter()
    on_cpu, _ = run_queries(torch, QD, tpcds.as_frames(tables, device="cpu"), TPCDS_SF)
    t_cpu = time.perf_counter() - t
    for q in on_cpu:
        first = next(iter(on_cpu[q].values()))
        if np.ndim(first) and len(first) == 0:
            raise AssertionError(f"{q} is empty on the CPU at SF {TPCDS_SF}: nothing to compare")
        compare_results(q, res1[q], on_cpu[q])
    log(f"  card vs CPU at SF {TPCDS_SF}: 5 queries agree, none empty (ints/codes/order "
        f"exact, floats rtol {QUERY_RTOL}; the CPU's pass {t_cpu:.3f} s)")
    del on_cpu
    wall, busy, per_op, _ = session(torch, lambda: run_queries(torch, QD, frames, TPCDS_SF))
    log(f"  profiled warm pass: wall {wall:.3f} ms, device busy {busy:.3f} ms "
        f"({100 * busy / wall:.3f} %; idle share {100 - 100 * busy / wall:.3f} %)")
    for key, (ms, count) in sorted(per_op.items(), key=lambda kv: -kv[1][0])[:8]:
        log(f"    {ms:.3f} ms  {count} x {key[:100]}")

    # the store path: date-sorted chunks, one year of sales pushed down
    t = time.perf_counter()
    stores = tpcds.as_store(tables, chunk_rows=STORE_CHUNK_ROWS, sort_fact_by_date=True)
    t_store = time.perf_counter() - t
    ss_store = stores["store_sales"]
    if ss_store.n_chunks != -(-n_ss // STORE_CHUNK_ROWS):
        raise AssertionError(f"store_sales in {ss_store.n_chunks} chunks")
    dd = tables["date_dim"]
    year = dd["d_date_sk"][dd["d_year"] == STORE_YEAR]
    lo, hi = int(year.min()), int(year.max())
    cols = ["ss_sold_date_sk", "ss_item_sk", "ss_customer_sk", "ss_quantity",
            "ss_ext_sales_price"]
    preds = [store.Pred("ss_sold_date_sk", "between", (lo, hi))]
    t = time.perf_counter()
    scanned = store.scan(ss_store, cols, preds)
    t_scan = time.perf_counter() - t
    t = time.perf_counter()
    pushed = TensorFrame.from_store(ss_store, cols, preds, result=scanned, device=dev)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t
    log(f"  store: as_store {t_store:.3f} s ({ss_store.n_chunks} chunks of {STORE_CHUNK_ROWS} "
        f"rows); from_store of {STORE_YEAR}'s sales: scan {1e3 * t_scan:.3f} ms, to the card "
        f"{1e3 * t_load:.3f} ms, {pushed.nrows} rows, chunks_skipped {scanned.chunks_skipped} "
        f"of {scanned.chunks_total}, rows_scanned {scanned.rows_scanned}")
    if scanned.chunks_skipped == 0:
        raise AssertionError("the pushed predicate skipped no chunk")
    order = np.argsort(ss["ss_sold_date_sk"], kind="stable")
    by_date = TensorFrame.from_arrays({c: ss[c][order] for c in cols}, device=dev)
    filtered = by_date.filter((col("ss_sold_date_sk") >= lo) & (col("ss_sold_date_sk") <= hi))
    compare_exact("from_store vs from_arrays + filter", pushed.to_dict(), filtered.to_dict())
    t = time.perf_counter()
    store_frames = {name: TensorFrame.from_store(tb, device=dev) for name, tb in stores.items()}
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t
    got = QD.q3(store_frames, sf=TPCDS_SF, apply_limit=False)
    want = QD.q3(frames, sf=TPCDS_SF, apply_limit=False)
    orc.assert_odf_equal(orc.frame_to_odf(got), orc.frame_to_odf(want), sort=True, rtol=QUERY_RTOL)
    log(f"  store: every table through from_store {t_all:.3f} s; q3 over them equals q3 over "
        f"from_arrays frames ({got.nrows} rows, sorted rows, floats rtol {QUERY_RTOL})")
    del store_frames, by_date, filtered, pushed

    # the loaders: tfb v2 and CSV, onto the card
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/store_sales.tfb"
        t = time.perf_counter()
        tio.write_tfb(path, ss)
        t_write = time.perf_counter() - t
        t = time.perf_counter()
        back = tio.read_tfb(path, device=dev)
        torch.cuda.synchronize()
        t_read = time.perf_counter() - t
        compare_exact("read_tfb", back.to_dict(), ss)
        few = ss["ss_quantity"] < 10
        part = tio.read_tfb(path, ["ss_item_sk", "ss_ext_sales_price"],
                            [store.Pred("ss_quantity", "<", 10)], device=dev)
        compare_exact("read_tfb (projection, predicate)", part.to_dict(),
                      {c: ss[c][few] for c in ("ss_item_sk", "ss_ext_sales_price")})
        cust = tables["customer"]
        t = time.perf_counter()
        tio.write_csv(f"{tmp}/customer.csv", cust)
        t_csv_w = time.perf_counter() - t
        t = time.perf_counter()
        cback = tio.read_csv(f"{tmp}/customer.csv", device=dev)
        torch.cuda.synchronize()
        t_csv_r = time.perf_counter() - t
        compare_exact("read_csv", cback.to_dict(), cust)
    log(f"  loaders: write_tfb (v2) {1e3 * t_write:.3f} ms, read_tfb to the card "
        f"{1e3 * t_read:.3f} ms ({n_ss} rows, {len(ss)} columns, exact; projection and "
        f"predicate: {part.nrows} rows, exact); customer ({len(cust['c_customer_sk'])} rows) "
        f"write_csv {1e3 * t_csv_w:.3f} ms, read_csv to the card {1e3 * t_csv_r:.3f} ms, exact")
    del back, part, cback

    # one traced query
    CONFIG.tracing = "on"
    obs.clear_trace()
    try:
        QD.q3(frames, sf=TPCDS_SF, apply_limit=False).to_dict()
        torch.cuda.synchronize()
        spans = obs.aggregate_operators(obs.spans())
    finally:
        CONFIG.tracing = "off"
    log(f"  traced q3, operators: {json.dumps(spans)}")
    if spans.get("core.join", {}).get("count") != 2:
        raise AssertionError(f"traced q3 recorded no two join spans: {spans}")
    log(f"  phase 9 wall {time.perf_counter() - t_phase:.3f} s")
    return k1_rows


# ----------------------------------------------------------------------
# phase 10: out of core
# ----------------------------------------------------------------------
#: the texts phase 10 requires to stream (the capped runner's queries)
OOC_MUST_STREAM = ("q1", "q6", "q14")
#: the texts whose every K1 call phase 10 records and holds to its plain
#: version (q1 groups, q14 is keyless)
OOC_K1_QUERIES = ("q1", "q14")
#: the spill budget of phase 10's second forced pass: below one partial
#: block of any grouped text, so every partial spills and is read back
SPILL_BUDGET = 1 << 10
#: the pipeline counters phase 10 prints
OOC_COUNTERS = ("pipelines", "chunks_streamed", "chunks_pruned", "rows_streamed",
                "partial_merges", "generic_probes", "fallbacks")


def forced_pass(torch, ops, seg, sql, stores, texts: dict, dev, calls=None):
    """Each text over the stores (``out_of_core`` as set by the caller),
    with its pipelines and fallbacks; with ``calls``, every K1 call of the
    texts in OOC_K1_QUERIES keeps a copy of its inputs there, under the
    text's name, or under "<text> merge" inside ``StreamAgg``'s merges."""
    from repro_torch.core import pipeline

    streams, results, ms = {}, {}, {}
    current = [None]
    real_merge = pipeline.StreamAgg._merge_blocks

    def merge_blocks(self, blocks):
        saved = current[0]
        current[0] = f"{saved} merge"
        try:
            return real_merge(self, blocks)
        finally:
            current[0] = saved

    for q, text in texts.items():
        rec = calls is not None and q in OOC_K1_QUERIES
        if rec:
            current[0] = q
            real = record_segment_sums(ops, seg, calls, current)
            pipeline.StreamAgg._merge_blocks = merge_blocks
        try:
            r, m, _, _ = sql_pass(torch, ops, sql, stores, {q: text}, device=dev,
                                  streams=streams)
        finally:
            if rec:
                ops.segment_sum_cuda = real
                pipeline.StreamAgg._merge_blocks = real_merge
        results.update(r)
        ms.update(m)
    return results, ms, streams


def ooc_phase(torch, ops, seg, stores, sql_run: dict, sf: float, dev):
    """Phase 10: the 22 TPC-H texts over phase 3d's stores under
    ``out_of_core = "force"``, each equal to 3d's in-memory result; every
    K1 call of the streamed q1 and q14 held to its plain version; the pass
    again under a spill budget; a profiled forced q1; then the capped
    runner's sweep in child processes.  Returns the phase's summary,
    K1's rows at the streamed shapes and the forced q1's result."""
    import os
    import shutil

    from repro_torch import sql
    from repro_torch.core import oracle as orc
    from repro_torch.core import pipeline
    from repro_torch.core.config import CONFIG
    from repro_torch.launch import run_capped
    from repro_torch.queries.tpch_sql import TPCH_SQL, sql_text

    log("phase 10: out of core: the 22 TPC-H texts over phase 3d's stores under "
        "out_of_core='force', chunk by chunk")
    t_phase = time.perf_counter()
    names = sorted(TPCH_SQL, key=lambda s: int(s[1:]))
    texts = {q: sql_text(q, sf) for q in names}
    want = sql_run["results"]
    CONFIG.out_of_core = "force"
    ops.reset_launches()
    pipeline.reset_stats()
    calls: dict = {}
    t = time.perf_counter()
    results, ms, streams = forced_pass(torch, ops, seg, sql, stores, texts, dev, calls)
    t_pass = time.perf_counter() - t
    launched = {name: ops.LAUNCHES[name] for name in ("segment_sum", "substr_find")}
    by_path = dict(ops.PATH_LAUNCHES)
    counters = {k: pipeline.STATS[k] for k in OOC_COUNTERS}
    for q in names:
        compare_sets(orc, f"forced {q} against 3d's in-memory SQL", results[q], want[q])
    streamed = [q for q in names if streams[q][0]]
    log(f"  forced pass {t_pass:.3f} s against 3d's store pass (auto) "
        f"{sql_run['store_pass_s']:.3f} s; each text equals 3d's in-memory result (sorted "
        f"rows, floats rtol {QUERY_RTOL})")
    log(f"  {len(streamed)} texts streamed ({', '.join(streamed)}); pipelines and fallbacks "
        f"by text: {json.dumps({q: list(v) for q, v in streams.items() if any(v)})}")
    log(f"  pipeline.STATS: {json.dumps(counters)}")
    slowest = sorted(ms, key=ms.get, reverse=True)[:4]
    log(f"  slowest forced texts: {', '.join(f'{q} {ms[q]:.1f} ms' for q in slowest)}")
    missing = [q for q in OOC_MUST_STREAM if not streams[q][0]]
    if missing:
        raise AssertionError(f"texts that did not stream under force: {missing}")
    q15_rows = len(next(iter(results["q15"].values())))
    if q15_rows < 1:
        raise AssertionError("forced q15 returned no row")

    # K1 on the streamed path: every call of q1 and q14 against its plain
    # version; the largest chunk call and the largest merge call timed
    log(f"  launches of the forced pass: {json.dumps(launched)}, segment_sum by path "
        f"{json.dumps(by_path)}; K1 calls recorded: "
        f"{json.dumps({k: len(v) for k, v in calls.items()})}")
    held = 0
    for key, cs in calls.items():
        for v, g, m in cs:
            check_segment_sum(torch, seg, v, g, m, key, quiet=True)
            held += 1
    rows = []
    for kind in ("chunk", "merge"):
        kcs = [(k, c) for k, cs in calls.items() if k.endswith(" merge") == (kind == "merge")
               for c in cs]
        if not kcs:
            raise AssertionError(f"no K1 call recorded in a streamed {kind}")
        key, (v, g, m) = max(kcs, key=lambda kc: kc[1][0].numel())
        rows.append(segment_row(torch, seg, dev, f"forced {key}: the largest streamed {kind} "
                                f"call ({v.dtype})", v, g, m))
    log(f"  all {held} K1 calls of the forced q1 and q14 equal their plain versions")
    del calls

    # the pass again under a spill budget: every partial block spills
    CONFIG.memory_budget_bytes = SPILL_BUDGET
    pipeline.reset_stats()
    t = time.perf_counter()
    spilled, _, _ = forced_pass(torch, ops, seg, sql, stores,
                                {q: texts[q] for q in streamed}, dev)
    t_spill = time.perf_counter() - t
    CONFIG.memory_budget_bytes = None
    pipeline.sync_spill_stats()
    spill = {k: pipeline.STATS[k] for k in ("bytes_spilled", "bytes_reread", "evictions",
                                            "peak_tracked_bytes")}
    for q in streamed:
        compare_sets(orc, f"spilled {q} against the forced pass", spilled[q], results[q])
    log(f"  spilling pass (memory_budget_bytes={SPILL_BUDGET}) over the {len(streamed)} "
        f"streamed texts: {t_spill:.3f} s, {json.dumps(spill)}; results unchanged")
    if spill["bytes_spilled"] <= 0 or spill["bytes_reread"] <= 0:
        raise AssertionError(f"the spilling pass spilled or re-read nothing: {spill}")

    # the device's idle share of one forced q1
    wall, busy, per_op, _ = session(
        torch, lambda: sql.execute(texts["q1"], stores, device=dev).to_dict())
    idle = 100 - 100 * busy / wall
    log(f"  profiled forced q1: wall {wall:.3f} ms, device busy {busy:.3f} ms (idle share "
        f"{idle:.3f} %)")
    for key, (op_ms, count) in sorted(per_op.items(), key=lambda kv: -kv[1][0])[:6]:
        log(f"    {op_ms:.3f} ms  {count} x {key[:100]}")
    CONFIG.out_of_core = "auto"

    # the capped runner: stores written to disk, then four child processes
    if STORE_CHUNK_ROWS != run_capped.CHUNK_ROWS:
        raise AssertionError("phase 3d's chunks are not the capped runner's")
    workdir = ROOT / "build" / "run_capped"
    shutil.rmtree(workdir, ignore_errors=True)
    t = time.perf_counter()
    run_capped.prepare_stores(stores, str(workdir), sf, dev)
    t_prep = time.perf_counter() - t
    torch.cuda.empty_cache()
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.run_capped", "sweep", "--prepared",
         "--workdir", str(workdir), "--device", "cuda"],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), capture_output=True, text=True,
        timeout=CAPPED_TIMEOUT_S)
    t_sweep = time.perf_counter() - t
    shutil.rmtree(workdir, ignore_errors=True)
    for line in proc.stdout.splitlines():
        log(f"  run_capped: {line[:2000]}")
    if proc.returncode != 0:
        log(proc.stderr[-4000:])
        raise AssertionError(f"run_capped sweep exited {proc.returncode}")
    (line,) = [ln for ln in proc.stdout.splitlines() if ln.startswith('{"sweep"')]
    sweep = json.loads(line)["sweep"]
    gb = {k: sweep[k] / 1e9 for k in sweep if k.endswith(("_reserved", "_allocated"))}
    log(f"  capped sweep (q1, q6, q14 at SF {sf}): cap {sweep['cap_mb']} MiB; uncapped peaks "
        f"eager {gb['eager_max_memory_reserved']:.3f} GB reserved "
        f"({gb['eager_max_memory_allocated']:.3f} allocated), ooc "
        f"{gb['ooc_max_memory_reserved']:.3f} GB reserved; eager under the cap: "
        f"{sweep['eager_oom']}; ooc under the cap {sweep['ooc_seconds']:.3f} s, matched; "
        f"stores written in {t_prep:.3f} s, sweep {t_sweep:.3f} s")
    log(f"  phase 10 wall {time.perf_counter() - t_phase:.3f} s")
    summary = dict(forced_pass_s=t_pass, store_pass_auto_s=sql_run["store_pass_s"],
                   streamed=streamed, streamed_auto=sql_run["streamed"], counters=counters,
                   launches=launched, segment_sum_by_path=by_path, k1_calls_held=held,
                   spill_pass_s=t_spill, spill=spill, forced_q1_idle_pct=idle,
                   capped=dict(sweep, prepare_s=t_prep, sweep_s=t_sweep))
    return summary, rows, results["q1"]


# ----------------------------------------------------------------------
# phase 11: SQL serving
# ----------------------------------------------------------------------
#: client threads of phase 11, each submitting the 22 texts
SERVE_CLIENTS = 4
#: q6's l_quantity literal, eight values through one Prepared statement
PREPARED_QTYS = (24, 25, 23, 30, 12, 40, 18, 33)


def serve_phase(torch, ops, frames, stores, sql_run: dict, sf: float, dev, seed: int) -> dict:
    """Phase 11: an ``Executor`` over the TPC-H scope on the card (lineitem
    and orders as stores, the rest as frames): 4 client threads each
    submit the 22 texts in a shuffled order and only wait on their
    futures (the admission worker is the one thread on the card); each
    result equals 3d's; then a Prepared q6, a session UDF, a timeout, a
    cancel and the in-flight cap."""
    import random
    import threading

    from repro_torch import serve, sql
    from repro_torch.core import oracle as orc
    from repro_torch.core.config import CONFIG
    from repro_torch.queries.tpch_sql import TPCH_SQL, sql_text
    from repro_torch.resilience import QueryCancelled, QueryTimeout, ResourceExhausted
    from repro_torch.sql import compile as plan_compile

    log(f"phase 11: SQL serving: {SERVE_CLIENTS} client threads x 22 TPC-H texts through one "
        f"Executor (lineitem and orders as stores, the rest as frames)")
    t_phase = time.perf_counter()
    names = sorted(TPCH_SQL, key=lambda s: int(s[1:]))
    texts = {q: sql_text(q, sf) for q in names}
    want = sql_run["results"]
    scope = {name: f for name, f in frames.items() if name not in ("lineitem", "orders")}
    scope.update(lineitem=stores["lineitem"], orders=stores["orders"])
    ops.reset_launches()
    serve.STATS.reset()
    plan_compile.clear_cache()
    plan_compile.reset_stats()
    rng = random.Random(seed)
    order = [rng.sample(names, len(names)) for _ in range(SERVE_CLIENTS)]
    futures: list = [None] * SERVE_CLIENTS

    with serve.Executor(scope, device=dev) as ex:
        sessions = [ex.session() for _ in range(SERVE_CLIENTS)]

        def client(i):
            # enqueue and wait only: no CUDA call runs on a client thread
            futs = [(q, sessions[i].submit(texts[q])) for q in order[i]]
            for _, fut in futs:
                fut.exception()
            futures[i] = futs

        threads = [threading.Thread(target=client, args=(i,)) for i in range(SERVE_CLIENTS)]
        t = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall = time.perf_counter() - t
        snap = serve.STATS.snapshot()
        n_req = sum(len(f) for f in futures)
        for i, futs in enumerate(futures):
            for q, fut in futs:
                compare_sets(orc, f"served {q} (client {i}) against 3d", fut.result().to_dict(),
                             want[q])
        # q21 under a 1 ms deadline
        try:
            ex.execute(texts["q21"], timeout_s=1e-3)
            raise AssertionError("q21 under a 1 ms deadline did not time out")
        except QueryTimeout as exc:
            timed_out = str(exc)
    counts = {k: snap[k] for k in ("admitted", "batches", "batched_queries", "coalesced",
                                   "shared_scan_groups", "shared_scan_queries",
                                   "shared_scan_errors", "plan_cache_hits", "errors_total")}
    qps = n_req / wall
    log(f"  {n_req} requests in {wall:.3f} s ({qps:.3f} queries/s); latency p50 "
        f"{snap['p50_ms']:.3f} ms, p99 {snap['p99_ms']:.3f} ms; each result equals 3d's")
    log(f"  serve.STATS: {json.dumps(counts)}; phases (ms): "
        f"{json.dumps({p: {k: round(v, 3) for k, v in d.items()} for p, d in snap['phases'].items()})}")
    bad = [k for k in ("batches", "coalesced", "shared_scan_groups") if counts[k] <= 0]
    if bad or counts["shared_scan_errors"] or counts["errors_total"]:
        raise AssertionError(f"serving counters: {counts}")
    log(f"  q21 with timeout_s=0.001: QueryTimeout ({timed_out})")

    # a Prepared q6 over frames: one capture, then hits
    template = texts["q6"].replace("l_quantity < 24", "l_quantity < {qty}")
    plan_compile.clear_cache()
    plan_compile.reset_stats()
    with serve.Executor(frames, device=dev) as ex2:
        ps = ex2.prepare(template)
        outs = [ps.execute(qty=qty) for qty in PREPARED_QTYS]
        stats = dict(plan_compile.STATS)
        ex2.add_function("disc_price", lambda p, d: p * (1 - d))
        udf = ex2.execute("SELECT SUM(disc_price(l_extendedprice, l_discount)) AS r "
                          "FROM lineitem WHERE l_shipdate >= DATE '1995-01-01'")
        inline = ex2.execute("SELECT SUM(l_extendedprice * (1 - l_discount)) AS r "
                             "FROM lineitem WHERE l_shipdate >= DATE '1995-01-01'")
    if (stats["compiles"], stats["hits"]) != (1, len(PREPARED_QTYS) - 1):
        raise AssertionError(f"Prepared q6: compiles {stats['compiles']}, hits {stats['hits']}")
    CONFIG.compiled = "off"
    for qty, out in zip(PREPARED_QTYS, outs):
        compare_results(f"Prepared q6 qty {qty}", out.to_dict(),
                        sql.execute(template.format(qty=qty), frames).to_dict())
    CONFIG.compiled = "auto"
    compare_results("session UDF against its inline expression", udf.to_dict(), inline.to_dict())
    log(f"  Prepared q6 over frames, {len(PREPARED_QTYS)} literals: 1 capture, "
        f"{stats['hits']} hits, each equal to op by op; the session UDF equals its inline "
        f"expression")

    # a request cancelled while queued; the in-flight cap of a session
    ex3 = serve.Executor(frames, auto_start=False, device=dev)
    fut = ex3.submit(texts["q6"])
    ex3.cancel(fut.request_id)
    ex3.drain_once()
    try:
        fut.result()
        raise AssertionError("a request cancelled while queued returned a result")
    except QueryCancelled:
        pass
    CONFIG.serve_session_inflight = 2
    try:
        s = ex3.session()
        held = [s.submit(texts["q6"]) for _ in range(2)]
        try:
            s.submit(texts["q6"])
            raise AssertionError("a session over serve_session_inflight was admitted")
        except ResourceExhausted:
            pass
    finally:
        CONFIG.serve_session_inflight = None
    ex3.drain_once()
    for f in held:
        compare_sets(orc, "q6 under the in-flight cap", f.result().to_dict(), want["q6"])
    ex3.close()
    log("  cancelled while queued: QueryCancelled; a third request of a session capped at "
        "2 in flight: ResourceExhausted")
    launched = {name: ops.LAUNCHES[name] for name in ("segment_sum", "substr_find")}
    log(f"  launches during the phase: {json.dumps(launched)}, segment_sum by path "
        f"{json.dumps(dict(ops.PATH_LAUNCHES))}")
    silent = [name for name, n in launched.items() if n == 0]
    if silent:
        raise AssertionError(f"serving launched no {silent}")
    plan_compile.clear_cache()
    torch.cuda.empty_cache()
    log(f"  phase 11 wall {time.perf_counter() - t_phase:.3f} s")
    return dict(requests=n_req, wall_s=wall, qps=qps, p50_ms=snap["p50_ms"],
                p99_ms=snap["p99_ms"], counters=counts, launches=launched,
                prepared=dict(compiles=stats["compiles"], hits=stats["hits"]))


# ----------------------------------------------------------------------
# phase 12: the distributed layer on one card
# ----------------------------------------------------------------------
#: routed results against local ones: K1's sums are exact per segment and
#: a one-rank all_reduce adds nothing, so equality is expected; floats are
#: held to DIST_RTOL (and whether every bit held is printed)
DIST_RTOL = 1e-12
#: the simulated world of phase 12b
SIM_WORLD = 4
#: phase 12c's quantized tensor: a Qwen3-14B MLP weight's shape (D, F)
QUANT_SHAPE = (5120, 17408)


def exchange(sends) -> "np.ndarray":
    """What the all-to-all makes of each rank's ``(world, bucket)`` send
    buffer, gathered in rank order: rank ``d`` receives row ``d`` of every
    source in source order."""
    world = len(sends)
    return np.concatenate([np.concatenate([np.asarray(s[d]) for s in sends])
                           for d in range(world)])


def dist_phase(torch, ops, QF, frames, stores, sql_run: dict, ooc_q1: dict,
               local_results: dict, sf: float, dev) -> dict:
    """Phase 12: the distributed layer (``repro_torch.dist``) on the card.
    (a) a one-rank NCCL group: the 22 frame queries, the 22 SQL texts op
    by op and a forced out-of-core q1 routed (``CONFIG.distributed =
    "force"``), each equal to its local result, K1's launches equal to a
    local pass's, collectives counted; the local passes run under
    ``auto`` with the group up and call no collective; the repartition of
    lineitem from its store chunks, lossless.  (b) a simulated world of
    four: each op's shard-local function for ranks 0 to 3 on the card,
    combined in rank order, equal to the local result (sums) and to the
    same on the CPU (mask, slots).  (c) quantize on the card against the
    CPU, compressed_mean over the group, a one-stage pipeline, and a
    checkpoint restored onto a (1, 1) device mesh by its partition specs."""
    import tempfile

    import torch.distributed as dist

    from repro_torch import sql
    from repro_torch.configs import get
    from repro_torch.core.config import CONFIG
    from repro_torch.core.join import membership
    from repro_torch.dist import compression, dframe, pipeline as dpipe
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm, partition
    from repro_torch.models.config import reduced
    from repro_torch.queries.tpch_sql import TPCH_SQL, sql_text
    from repro_torch.train import checkpoint

    log(f"phase 12: distributed, a one-rank NCCL group and a simulated world of {SIM_WORLD} "
        f"(on {gpu_name_power()})")
    t_phase = time.perf_counter()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    mesh = dframe.init_local(dev)
    backend = dist.get_backend()
    log(f"  group: world {mesh.size}, backend {backend!r}")
    if dev.type == "cuda" and "nccl" not in backend:
        raise AssertionError(f"the group's CUDA backend is not NCCL: {backend!r}")
    saved = CONFIG.distributed, CONFIG.compiled, CONFIG.out_of_core
    k1_before = ops.LAUNCHES["segment_sum"]
    out = {}
    try:
        # (a) the frame queries: local under auto (no collective), routed twice
        names = sorted(QF.ALL, key=lambda s: int(s[1:]))
        CONFIG.distributed = "auto"
        dframe.reset_counts()
        before = ops.LAUNCHES["segment_sum"]
        local, ms_local = run_queries(torch, QF, frames, sf)
        k1_local = ops.LAUNCHES["segment_sum"] - before
        for q in names:
            compare_results(f"auto {q}", local[q], local_results[q], DIST_RTOL)
        if sum(dframe.COLLECTIVES.values()) or sum(dframe.ROUTED.values()):
            raise AssertionError(f"auto with one rank called collectives: {dframe.COLLECTIVES}")
        CONFIG.distributed = "force"
        passes, bit_equal = [], True
        for i in range(2):
            dframe.reset_counts()
            before = ops.LAUNCHES["segment_sum"]
            routed, ms_routed = run_queries(torch, QF, frames, sf)
            k1 = ops.LAUNCHES["segment_sum"] - before
            counts, colls = dict(dframe.ROUTED), dict(dframe.COLLECTIVES)
            passes.append(dict(ms=sum(ms_routed.values()), k1=k1, routed=counts,
                               collectives=colls))
            for q in names:
                bit_equal &= compare_results(f"routed {q} (pass {i + 1})", routed[q],
                                           local_results[q], DIST_RTOL)
            if k1 != k1_local:
                raise AssertionError(f"routed pass {i + 1} launched K1 {k1} times, a local "
                                     f"pass {k1_local}")
            if colls["all_reduce"] != counts["groupby_sum"] or counts["groupby_sum"] == 0:
                raise AssertionError(f"all_reduce {colls} against routed group sums {counts}")
            if counts["semi_join"] == 0 or colls["all_gather"] != counts["semi_join"]:
                raise AssertionError(f"no semi or anti probe went through the mask: {counts}")
            if len(next(iter(routed["q15"].values()))) == 0:
                raise AssertionError("routed q15 returned no row")
        # local again, after the routed passes: compare neighbours
        CONFIG.distributed = "auto"
        dframe.reset_counts()
        _, ms_local2 = run_queries(torch, QF, frames, sf)
        if sum(dframe.COLLECTIVES.values()):
            raise AssertionError(f"auto with one rank called collectives: {dframe.COLLECTIVES}")
        CONFIG.distributed = "force"
        ms_local_total = sum(ms_local2.values())
        log(f"  22 frame queries routed twice, each equal to phase 3's local result (ints, codes "
            f"and order exact, floats rtol {DIST_RTOL}; every bit: {bit_equal}); K1 {k1_local} "
            f"launches a pass, local and routed; routed ops {passes[1]['routed']}, collectives "
            f"{passes[1]['collectives']}")
        log(f"  passes in turn: local (auto) {sum(ms_local.values()):.3f} ms, routed "
            f"{passes[0]['ms']:.3f} ms and {passes[1]['ms']:.3f} ms, local (auto) "
            f"{ms_local_total:.3f} ms ({gpu_name_power()})")
        out.update(frame_local_first_ms=sum(ms_local.values()),
                   frame_local_ms=ms_local_total, frame_routed_ms=passes[1]["ms"],
                   frame_routed_cold_ms=passes[0]["ms"], frame_bit_equal=bit_equal,
                   k1_launches_a_pass=k1_local, routed_ops=passes[1]["routed"],
                   collectives=passes[1]["collectives"])

        # the SQL texts op by op: local under auto, then routed
        CONFIG.compiled = "off"
        texts = {q: sql_text(q, sf) for q in sorted(TPCH_SQL, key=lambda s: int(s[1:]))}
        CONFIG.distributed = "auto"
        dframe.reset_counts()
        _, ms_sql_local, _, _ = sql_pass(torch, ops, sql, frames, texts, device=dev)
        if sum(dframe.COLLECTIVES.values()):
            raise AssertionError(f"auto SQL called collectives: {dframe.COLLECTIVES}")
        CONFIG.distributed = "force"
        dframe.reset_counts()
        sql_routed, ms_sql_routed, _, _ = sql_pass(torch, ops, sql, frames, texts, device=dev)
        sql_counts = dict(dframe.ROUTED)
        CONFIG.distributed = "auto"
        _, ms_sql_local2, _, _ = sql_pass(torch, ops, sql, frames, texts, device=dev)
        CONFIG.distributed = "force"
        sql_bits = True
        for q in texts:
            sql_bits &= compare_results(f"routed SQL {q}", sql_routed[q], sql_run["results"][q],
                                      DIST_RTOL)
        log(f"  22 SQL texts op by op routed, each equal to 3d's (every bit: {sql_bits}); "
            f"in turn: local (auto) {sum(ms_sql_local.values()):.3f} ms, routed "
            f"{sum(ms_sql_routed.values()):.3f} ms, local (auto) "
            f"{sum(ms_sql_local2.values()):.3f} ms; routed ops {sql_counts}")
        out.update(sql_local_ms=sum(ms_sql_local.values()),
                   sql_local2_ms=sum(ms_sql_local2.values()),
                   sql_routed_ms=sum(ms_sql_routed.values()), sql_bit_equal=sql_bits,
                   sql_routed_ops=sql_counts)

        # a forced out-of-core q1: each chunk's partial sums and merges routed
        CONFIG.out_of_core = "force"
        q1 = {"q1": sql_text("q1", sf)}
        CONFIG.distributed = "auto"
        dframe.reset_counts()
        _, ms_ooc_local, _, _ = sql_pass(torch, ops, sql, stores, q1, device=dev)
        if sum(dframe.COLLECTIVES.values()):
            raise AssertionError(f"auto out of core called collectives: {dframe.COLLECTIVES}")
        CONFIG.distributed = "force"
        dframe.reset_counts()
        ooc, ms_ooc, _, _ = sql_pass(torch, ops, sql, stores, q1, device=dev)
        ooc_bits = compare_results("routed forced q1", ooc["q1"], ooc_q1, DIST_RTOL)
        if dframe.ROUTED["groupby_sum"] == 0:
            raise AssertionError("the forced q1's chunk partials were not routed")
        log(f"  forced out-of-core q1 routed ({dframe.ROUTED['groupby_sum']} group sums), equal "
            f"to phase 10's (every bit: {ooc_bits}); {ms_ooc['q1']:.3f} ms against local "
            f"{ms_ooc_local['q1']:.3f} ms")
        out.update(ooc_q1_routed_ms=ms_ooc["q1"], ooc_q1_local_ms=ms_ooc_local["q1"],
                   ooc_q1_group_sums=dframe.ROUTED["groupby_sum"], ooc_bit_equal=ooc_bits)
        CONFIG.out_of_core, CONFIG.compiled = saved[2], saved[1]

        # the repartition of lineitem from its store chunks, over the group
        li = stores["lineitem"]
        kc = [li.column("l_orderkey").chunk_physical(i) for i in range(li.n_chunks)]
        vc = [li.column("l_extendedprice").chunk_physical(i) for i in range(li.n_chunks)]
        n = sum(len(c) for c in kc)
        dframe.reset_counts()
        sync()
        t = time.perf_counter()
        k2, v2, valid, dropped = dframe.dist_repartition_by_key(mesh, kc, vc, capacity=n,
                                                                device=dev)
        sync()
        rep_ms = (time.perf_counter() - t) * 1e3
        keys = torch.from_numpy(np.concatenate(kc)).to(dev)
        vals = torch.from_numpy(np.concatenate(vc)).to(dev)
        if int(dropped) != 0 or int(valid.sum()) != n:
            raise AssertionError(f"repartition dropped {int(dropped)} rows, kept "
                                 f"{int(valid.sum())} of {n}")
        if not torch.equal(torch.sort(k2[valid]).values, torch.sort(keys).values):
            raise AssertionError("repartition lost or changed a key")
        domain = int(keys.max()) + 1
        by_key = ops.segment_sum(v2[valid], k2[valid], domain)
        if not torch.equal(by_key, ops.segment_sum(vals, keys, domain)):
            raise AssertionError("per-key sums after the repartition differ from before it")
        grouped = frames["lineitem"].groupby("l_orderkey").agg([("s", "sum", "l_extendedprice")])
        gk = torch.as_tensor(np.asarray(grouped.column("l_orderkey")), device=dev)
        if not np.allclose(by_key[gk].cpu().numpy(), np.asarray(grouped.column("s")),
                           rtol=DIST_RTOL, atol=0.0):
            raise AssertionError("per-key sums after the repartition differ from the group-by")
        slots = int(k2.shape[0])
        wire = 2 * slots * 8  # the all-to-all's key and value buffers (int64, float64)
        log(f"  repartition of lineitem (l_orderkey, l_extendedprice) from {li.n_chunks} store "
            f"chunks over the group ({backend}): {n} rows, {slots} slots, dropped 0, every row "
            f"present, per-key sums equal to the local group-by; {rep_ms:.3f} ms, {wire} bytes "
            f"through the all-to-all, collectives {dict(dframe.COLLECTIVES)} "
            f"({gpu_name_power()})")
        out.update(repartition_ms=rep_ms, repartition_rows=n, repartition_slots=slots,
                   repartition_bytes=wire)

        del k2, v2, valid, keys, vals

        # (b) a simulated world of four on the card, against the local result
        # and against the same combination on the CPU
        lineitem = frames["lineitem"]
        sk, keys = lineitem.col_values("l_suppkey"), lineitem.col_values("l_orderkey")
        vals = lineitem.col_values("l_extendedprice")
        domain_s = int(sk.max()) + 1
        combined = sum(dframe.groupby_sum_shard(sk, vals, domain_s, r, SIM_WORLD).cpu()
                       for r in range(SIM_WORLD))
        whole = dframe.local_dense_sum(sk, vals, domain_s).cpu()
        if not torch.allclose(combined, whole, rtol=DIST_RTOL, atol=0.0):
            raise AssertionError("the simulated world's group sums differ from the local ones")
        orders = frames["orders"]
        ok, price = orders.col_values("o_orderkey"), orders.col_values("o_totalprice")
        build = ok[price > price.median()]
        mask = torch.cat([dframe.semi_join_shard(keys, build, r, SIM_WORLD)
                          for r in range(SIM_WORLD)])[:n]
        mask_cpu = torch.cat([dframe.semi_join_shard(keys.cpu(), build.cpu(), r, SIM_WORLD)
                              for r in range(SIM_WORLD)])[:n]
        if not (torch.equal(mask.cpu(), mask_cpu)
                and torch.equal(mask, membership(keys, build))):
            raise AssertionError("the simulated world's semi mask differs")
        sends = [dframe.repartition_shard(keys, vals, n, r, SIM_WORLD) for r in range(SIM_WORLD)]
        sends_cpu = [dframe.repartition_shard(keys.cpu(), vals.cpu(), n, r, SIM_WORLD)
                     for r in range(SIM_WORLD)]
        for part in (0, 1):
            a = exchange([s[part].cpu() for s in sends])
            b = exchange([s[part] for s in sends_cpu])
            if not np.array_equal(a, b):
                raise AssertionError(f"the simulated world's repartition slots differ ({part})")
        if sum(int(s[2]) for s in sends) != 0:
            raise AssertionError("the simulated world's repartition dropped rows")
        # what routing adds to one group sum: the call against K1 alone,
        # and a bare all_reduce of a q1-sized partial (6 float64 sums)
        if dev.type == "cuda":
            dframe.reset_counts()
            sk, vals = sk.contiguous(), vals.contiguous()  # K1 takes contiguous tensors
            out.update(
                routed_sum_ms=cuda_ms(torch, lambda: dframe.dist_groupby_sum(
                    mesh, sk, vals, domain_s), REPS),
                local_sum_ms=cuda_ms(torch, lambda: ops.segment_sum(vals, sk, domain_s), REPS),
                all_reduce_ms=cuda_ms(torch, lambda: dframe.all_reduce(
                    torch.zeros(6, dtype=torch.float64, device=dev), mesh), REPS))
            log(f"  one group sum over l_suppkey ({sk.numel()} rows): routed "
                f"{out['routed_sum_ms']:.4f} ms against K1 alone {out['local_sum_ms']:.4f} ms; "
                f"an all_reduce of 6 float64 {out['all_reduce_ms']:.4f} ms ({gpu_name_power()})")
        log(f"  simulated world of {SIM_WORLD}: group sums over l_suppkey ({domain_s} groups) "
            f"within rtol {DIST_RTOL} of the local ones, the semi mask of l_orderkey against "
            f"{int(build.numel())} orders and the repartition slots exactly the CPU's")
        del sends, sends_cpu, mask, mask_cpu

        # (c) quantize on the card against the CPU
        gen = torch.Generator("cpu").manual_seed(12)
        x = torch.randn(QUANT_SHAPE, generator=gen).reshape(-1)
        xd = x.to(dev)
        q, s, r = compression.quantize(xd)
        qc, sc, rc = compression.quantize(x)
        if not (torch.equal(q.cpu(), qc) and torch.equal(s.cpu(), sc)):
            raise AssertionError(
                f"quantize differs between card and CPU: {int((s.cpu() != sc).sum())} of "
                f"{sc.numel()} scales, {int((q.cpu() != qc).sum())} of {qc.numel()} codes")
        resid_err = float((xd - compression.dequantize(q, s, x.numel()) - r).abs().max())
        if resid_err > 1e-6:
            raise AssertionError(f"quantize's residual identity off by {resid_err}")
        q_ms = cuda_ms(torch, lambda: compression.quantize(xd), 5) if dev.type == "cuda" else 0.0
        dframe.reset_counts()
        mean, resid = compression.compressed_mean(xd, mesh)
        mean_err = float((mean + resid - xd).abs().max())
        if mean_err > 1e-6 or dframe.COLLECTIVES["all_reduce"] != 1:
            raise AssertionError(f"compressed_mean off by {mean_err}")
        log(f"  quantize of a {QUANT_SHAPE[0]} x {QUANT_SHAPE[1]} float32 tensor: codes and "
            f"scales equal the CPU's, residual identity within {resid_err:.3g}; {q_ms:.3f} ms "
            f"({gpu_name_power()}); compressed_mean over the group within {mean_err:.3g}")
        out.update(quantize_ms=q_ms)
        del x, xd, q, s, r, qc, sc, rc, mean, resid

        # a one-stage pipeline against the sequential loop
        w = torch.randn((8, 256, 256), generator=gen).to(dev) * 0.05
        h = torch.randn((6, 4, 256), generator=gen).to(dev)
        got = dpipe.pipeline_forward(dframe.data_mesh(axis="pipe"),
                                     lambda wl, hl: torch.tanh(hl @ wl), w, h, n_layers=8)
        want = []
        for hm in h:  # microbatch by microbatch: products of the pipeline's shapes
            for wl in w:
                hm = torch.tanh(hm @ wl)
            want.append(hm)
        if not torch.equal(got, torch.stack(want)):
            raise AssertionError("the one-stage pipeline differs from the sequential loop")

        # a reduced float32 config's weights placed by their partition
        # specs on a (1, 1) device mesh, checkpointed, restored resharded
        cfg = reduced(get("qwen3-14b"))
        params = lm.init_params(cfg, torch.Generator(dev).manual_seed(3), device=dev)
        dmesh = make_host_mesh(1, device_type=dev.type)
        sh = partition.shardings_from_specs(dmesh, {"params": partition.param_specs(params)})
        named = {k: p.detach() for k, p in params.named_parameters()}
        placed = partition.distribute_tree(named, sh["params"])
        with tempfile.TemporaryDirectory() as d:
            checkpoint.save({"params": params}, d, 1)
            back = checkpoint.restore(d, {"params": params}, shardings=sh)
        for k, p in back["params"].named_parameters():
            if not (torch.equal(p.full_tensor(), named[k])
                    and torch.equal(placed[k].to_local(), named[k])):
                raise AssertionError(f"checkpoint leaf {k} not bit-equal after resharding")
        log(f"  one-stage pipeline equal to the sequential loop; {len(named)} weights of a "
            f"reduced Qwen3-14B placed by their specs on a {tuple(dmesh.mesh.shape)} "
            f"{dev.type} mesh, checkpointed and restored with shardings=, bit-equal")
    finally:
        CONFIG.distributed, CONFIG.compiled, CONFIG.out_of_core = saved
        dist.destroy_process_group()
    out["k1_launches"] = ops.LAUNCHES["segment_sum"] - k1_before
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"  phase 12 wall {out['wall_s']:.3f} s")
    return out


# ----------------------------------------------------------------------
# phase 13: the sharded dry run, and the step on DTensors on the card
# ----------------------------------------------------------------------
#: the dry-run cells of phase 13(a), each in a child process on the 16 x
#: 16 fake mesh at full width, with the depth it is cut to (through
#: ``--override n_layers=``; None: every layer).  On the card machine's
#: host the Qwen3-14B child took 14.7 s for 16 of its 40 layers and 35.4
#: s for all 40, which held the whole script 20 s longer against its
#: time limit; the RWKV6-7B child takes 6 s for all 32
DRYRUN_CELLS = (("qwen3-14b", "train_4k", 16), ("rwkv6-7b", "prefill_32k", None))
DRYRUN_TIMEOUT_S = 600
#: phase 13(b): the layers each model keeps at full width on the (1, 1)
#: mesh, Qwen3-14B's train batch (4 microbatches of 1 x 4096), the
#: prefills' batch and length
SHARDED_LAYERS, SHARDED_TRAIN_BATCH, SHARDED_SEQ = 2, 4, 4096
#: the band the predicted peak of the sharded train step must fall in, as
#: a share of the card's measured peak (phase 13(c))
PEAK_BAND = (0.8, 1.25)


def dryrun_children(out_dir: Path) -> list:
    """Start phase 13(a)'s children, one ``repro_torch.launch.dryrun`` each."""
    import os

    out = []
    for arch, shape, layers in DRYRUN_CELLS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
               "--out", str(out_dir)]
        if layers:
            cmd += ["--override", f"n_layers={layers}"]
        proc = subprocess.Popen(cmd, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                                cwd=str(ROOT), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        out.append((arch, shape, layers, proc))
    return out


def dryrun_results(children: list, out_dir: Path) -> list:
    """Wait for phase 13(a)'s children; each cell must report ``ok``."""
    cells = []
    for arch, shape, layers, proc in children:
        try:
            text = proc.communicate(timeout=DRYRUN_TIMEOUT_S)[0]
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        # the child's own time (it is collected after phase 13(b))
        done = [ln for ln in text.splitlines() if ln.startswith("done:")]
        seconds = float(done[-1].split(" in ")[-1].rstrip(" s")) if done else None
        path = out_dir / f"{arch}__{shape}__16x16.json"
        if proc.returncode != 0 or not path.exists():
            log(text[-4000:])
            raise AssertionError(f"dry run of {arch} {shape} exited {proc.returncode}")
        cell = json.loads(path.read_text())
        if cell["status"] != "ok":
            raise AssertionError(f"dry run of {arch} {shape}: {cell.get('error')}")
        keep = ("arch", "shape", "mesh", "chips", "status", "trace_s", "flops_per_device",
                "bytes_per_device", "collective_bytes_total", "collectives", "memory",
                "kernels", "roofline", "tokens", "model_flops")
        line = {k: cell[k] for k in keep}
        line.update(child_s=seconds, layers=layers or "all")
        log(json.dumps({"dryrun_cell": line}))
        if layers:
            log(f"  {arch} {shape}: depth cut to {layers} layers (--override n_layers={layers}) "
                f"to keep the script inside its time limit")
        cells.append(line)
    return cells


def distribute_params(lm, partition, params, mesh, specs):
    """``params`` as a ``Params`` of DTensors placed by ``specs`` on ``mesh``."""
    shardings = partition.shardings_from_specs(mesh, specs)
    return lm.Params(lm.tree_from_names({
        name: partition.distribute(p.detach(), shardings[name])
        for name, p in params.named_parameters()}))


def sharded_phase(torch, ops, dev, seed: int) -> dict:
    """Phase 13: (a) the dry run's children on the fake 16 x 16 mesh, run
    beside (b) the step on DTensors on the card: a one-rank NCCL group and
    a (1, 1) mesh, every weight, optimizer leaf and batch a DTensor placed
    by its spec, at full width and SHARDED_LAYERS layers: a Qwen3-14B train
    step and prefill and an RWKV6-7B prefill, each equal to the unsharded
    step's, bit for bit, with equal K4, K4-bwd and K5 launches; (c) the
    dry run's prediction of the sharded train step's peak on the same
    mesh against the card's measured peak."""
    log(f"phase 13: the sharded dry run (children on the fake 16 x 16 mesh) and the step on "
        f"DTensors on a (1, 1) mesh ({SHARDED_LAYERS} layers at full width)")
    t_phase = time.perf_counter()
    out_dir = ROOT / "artifacts" / "dryrun_torch"
    out_dir.mkdir(parents=True, exist_ok=True)
    children = dryrun_children(out_dir)
    try:
        out = sharded_steps(torch, ops, dev, seed)
        out["dryrun"] = dryrun_results(children, out_dir)
    finally:
        for *_, proc in children:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"  phase 13 wall {out['wall_s']:.3f} s")
    return out


def sharded_steps(torch, ops, dev, seed: int) -> dict:
    """Phase 13 (b) and (c), on a one-rank NCCL group and a (1, 1) mesh."""
    import dataclasses
    import gc

    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get
    from repro_torch.dist import dframe
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.shapes import ShapeSpec
    from repro_torch.models import lm, partition
    from repro_torch.train.optimizer import get_optimizer
    from repro_torch.train.train_step import init_train_state, make_train_step

    kernels = ("flash_attention_sm90", "flash_attention_bwd_sm90", "wkv6_chunked")
    out = {"launches_sharded": {}}

    def counted(fn):
        ops.reset_launches()
        res = fn()
        torch.cuda.synchronize()
        return res, {n: c for n, c in ops.LAUNCHES.items() if c}

    def add(launches):
        for n, c in launches.items():
            out["launches_sharded"][n] = out["launches_sharded"].get(n, 0) + c

    def same(label, got, want, launches, want_launches):
        equal = torch.equal(got, want)
        err = float((got.double() - want.double()).abs().max())
        log(f"  {label}: sharded equal to unsharded bit for bit: {equal} (max abs diff {err}); "
            f"launches sharded {launches}, unsharded {want_launches}")
        if not equal:
            raise AssertionError(f"{label}: the sharded result differs from the unsharded")
        if {n: launches.get(n, 0) for n in kernels} != {n: want_launches.get(n, 0)
                                                       for n in kernels}:
            raise AssertionError(f"{label}: launches {launches} against {want_launches}")

    dframe.init_local(dev)
    try:
        mesh = make_host_mesh(1, device_type="cuda")
        rng = np.random.default_rng(seed + 13)
        qc = dataclasses.replace(get("qwen3-14b"), n_layers=SHARDED_LAYERS)
        opt = get_optimizer(qc.optimizer)
        step = make_train_step(qc)
        tokens = rng.integers(0, qc.vocab, (SHARDED_TRAIN_BATCH, SHARDED_SEQ + 1))
        batch = {"tokens": torch.as_tensor(tokens[:, :-1], device=dev),
                 "labels": torch.as_tensor(tokens[:, 1:], device=dev)}
        gen = lambda: torch.Generator(dev).manual_seed(seed)

        # (b) the train step, sharded first: its peak is the one predicted
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        state = init_train_state(qc, gen(), device=dev)
        pspecs = partition.param_specs(state["params"], qc)
        specs = {"params": pspecs, "opt": opt.state_specs(pspecs, state["params"]),
                 "step": partition.P()}
        dparams = distribute_params(lm, partition, state["params"], mesh, pspecs)
        dopt = partition.distribute_tree(
            state["opt"], partition.shardings_from_specs(mesh, specs["opt"]))
        del state
        dparams.requires_grad_(True)
        dstate = {"params": dparams, "opt": dopt, "step": 0}
        dbatch = partition.distribute_tree(
            batch, partition.shardings_from_specs(mesh, partition.batch_specs(mesh, batch)))
        gc.collect()
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated() - base
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        with implicit_replication():
            (dstate, dm), launches = counted(lambda: step(dstate, dbatch))
        step_ms = (time.perf_counter() - t) * 1e3
        measured = torch.cuda.max_memory_allocated() - base
        add(launches)
        placements = {n: [repr(pl) for pl in p.placements]
                      for n, p in list(dparams.named_parameters())[:4]}
        got = {"loss": dm["loss"].full_tensor(), "grad_norm": dm["grad_norm"].full_tensor(),
               **{n: p.full_tensor().detach().cpu() for n, p in dparams.named_parameters()}}
        log(f"  qwen3-14b sharded train step ({SHARDED_TRAIN_BATCH} x {SHARDED_SEQ}, "
            f"{qc.microbatches} microbatches): {step_ms:.3f} ms, loss {float(got['loss']):.6f}, "
            f"resident {resident / 1e9:.3f} GB, peak {measured / 1e9:.3f} GB; placements "
            f"{json.dumps(placements)}")
        del dstate, dparams, dopt, dm, dbatch
        gc.collect()
        torch.cuda.empty_cache()
        state = init_train_state(qc, gen(), device=dev)
        (state, m), want_launches = counted(lambda: step(state, batch))
        for key in ("loss", "grad_norm"):
            same(f"qwen3-14b train step {key}", got.pop(key), m[key], launches, want_launches)
        for name, p in state["params"].named_parameters():
            if not torch.equal(got[name], p.detach().cpu()):
                raise AssertionError(f"qwen3-14b train step: weight {name} differs")
        log(f"  qwen3-14b train step: all {len(got)} updated weights equal bit for bit")
        del state, m, got
        gc.collect()
        torch.cuda.empty_cache()

        # (c) the dry run's prediction of that step's peak on this mesh
        t = time.perf_counter()
        cell = dryrun.run_cell(
            "qwen3-14b", ShapeSpec("train_4k_b4", SHARDED_SEQ, SHARDED_TRAIN_BATCH, "train"),
            False, {"n_layers": SHARDED_LAYERS}, mesh=mesh)
        predicted = cell["memory"]["peak_bytes"]
        ratio = predicted / measured
        out["peak"] = {"predicted_bytes": predicted, "measured_bytes": measured,
                       "ratio": ratio, "argument_bytes": cell["memory"]["argument_bytes"],
                       "resident_bytes": resident, "trace_s": time.perf_counter() - t}
        log(f"  predicted peak of the sharded train step {predicted / 1e9:.3f} GB (arguments "
            f"{cell['memory']['argument_bytes'] / 1e9:.3f} GB), measured "
            f"max_memory_allocated {measured / 1e9:.3f} GB (resident {resident / 1e9:.3f} "
            f"GB): ratio {ratio:.4f}")
        if not PEAK_BAND[0] <= ratio <= PEAK_BAND[1]:
            raise AssertionError(f"predicted peak / measured {ratio:.4f} outside {PEAK_BAND}")

        # (b) the prefills: Qwen3-14B, then RWKV6-7B
        for arch in ("qwen3-14b", "rwkv6-7b"):
            cfg = dataclasses.replace(get(arch), n_layers=SHARDED_LAYERS)
            params = lm.init_params(cfg, gen(), device=dev)
            pb = model_inputs(torch, cfg, dev, 1, SHARDED_SEQ, seed)
            t = time.perf_counter()
            want, want_launches = counted(lambda: lm.prefill(cfg, params, pb))
            plain_ms = (time.perf_counter() - t) * 1e3
            dparams = distribute_params(lm, partition, params, mesh,
                                        partition.param_specs(params, cfg))
            dpb = partition.distribute_tree(
                pb, partition.shardings_from_specs(mesh, partition.batch_specs(mesh, pb)))
            t = time.perf_counter()
            with implicit_replication():
                dlogits, launches = counted(lambda: lm.prefill(cfg, dparams, dpb))
            sharded_ms = (time.perf_counter() - t) * 1e3
            log(f"  {arch} prefill (1 x {SHARDED_SEQ}, {SHARDED_LAYERS} layers, each the first "
                f"call of its form): {sharded_ms:.3f} ms on DTensors, {plain_ms:.3f} ms unsharded")
            out.setdefault("prefill_ms", {})[arch] = {"sharded": sharded_ms, "unsharded": plain_ms}
            add(launches)
            same(f"{arch} prefill (1 x {SHARDED_SEQ})", dlogits.full_tensor(), want, launches,
                 want_launches)
            del params, dparams, want, dlogits
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    for name in kernels:
        if not out["launches_sharded"].get(name):
            raise AssertionError(f"{name} never launched on DTensors")
    return out


def examples_phase(torch, ops, dev) -> dict:
    """Phase 14: the six example twins on the card, each held to a run on
    the CPU (see the module docstring)."""
    import shutil

    import torch.distributed as dist

    from repro_torch.dist import dframe
    from repro_torch.examples import (
        distributed_groupby, quickstart, serve_lm, sql_quickstart, tpch_analytics, train_lm,
    )

    log(f"phase 14: the six example twins on the card, each held to a CPU run "
        f"(train_lm cut to {EXAMPLE_TRAIN_STEPS} of the script's {SCRIPT_TRAIN_STEPS} steps "
        f"to fit the phase's {EXAMPLES_BUDGET_S:.0f} s)")
    t_phase = time.perf_counter()
    runs = {}

    def on_card(name, fn):
        ops.reset_launches()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        runs[name] = {"wall_s": time.perf_counter() - t,
                      "launches": {k: v for k, v in ops.LAUNCHES.items() if v}}
        for forms in EXAMPLE_KERNELS.get(name, ()):
            if not any(runs[name]["launches"].get(k) for k in forms):
                raise AssertionError(f"{name} launched none of {forms} on the card")
        log(f"  {name}: {runs[name]['wall_s']:.3f} s on the card, launches "
            f"{json.dumps(runs[name]['launches'])}")
        return res

    card = on_card("quickstart", lambda: quickstart.run(dev))
    cpu = quickstart.run("cpu")
    if card["results"]["filtered"] != cpu["results"]["filtered"]:
        raise AssertionError("quickstart: filtered rows differ from the CPU's")
    compare_results("quickstart top", card["results"]["top"], cpu["results"]["top"])

    card = on_card("sql_quickstart", lambda: sql_quickstart.run(dev))
    cpu = sql_quickstart.run("cpu")
    for key, want in cpu["results"].items():
        compare_results(f"sql_quickstart {key}", card["results"][key], want)

    card = on_card("tpch_analytics", lambda: tpch_analytics.run(device=dev))
    cpu = tpch_analytics.run(device="cpu")
    for q, want in cpu["results"].items():
        compare_results(f"tpch_analytics {q}", card["results"][q], want)
    runs["tpch_analytics"]["query_ms"] = card["ms"]

    card = on_card("serve_lm", lambda: serve_lm.run(dev))
    cpu = serve_lm.run("cpu")
    for label, out in (("card", card), ("CPU", cpu)):
        reqs = out["requests"]
        if not all(r.done and len(r.out) == r.max_new for r in reqs) or len(reqs) != 12:
            raise AssertionError(f"serve_lm on the {label}: not every request served to its "
                                 f"max_new: {out['lines'][0]}")
    runs["serve_lm"]["tokens_equal_cpu"] = sum(
        a == b for r, c in zip(card["requests"], cpu["requests"]) for a, b in zip(r.out, c.out))
    runs["serve_lm"]["tokens"] = sum(len(r.out) for r in cpu["requests"])

    ckpt = ROOT / "build" / "examples_train_lm"
    shutil.rmtree(ckpt, ignore_errors=True)
    card = on_card("train_lm", lambda: train_lm.run(EXAMPLE_TRAIN_STEPS, str(ckpt), dev))
    losses = card["losses"]
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train_lm: loss {losses[0]} -> {losses[-1]} did not fall")
    if not (ckpt / f"step_{EXAMPLE_TRAIN_STEPS:08d}").is_dir():
        raise AssertionError(f"train_lm wrote no checkpoint of step {EXAMPLE_TRAIN_STEPS}")
    runs["train_lm"].update(steps=EXAMPLE_TRAIN_STEPS, first_loss=losses[0],
                            last_loss=losses[-1], loop_s=card["seconds"])
    for line in card["lines"]:
        log(f"    {line}")
    shutil.rmtree(ckpt, ignore_errors=True)

    def groupby_run(device):
        mesh = dframe.init_local(device, timeout=distributed_groupby.TIMEOUT)
        try:
            return distributed_groupby.run(mesh, device)
        finally:
            dist.destroy_process_group()

    card = on_card("distributed_groupby", lambda: groupby_run(dev))
    cpu = groupby_run("cpu")
    for key in ("matched", "expected_matched", "preserved", "dropped"):
        if card[key] != cpu[key]:
            raise AssertionError(f"distributed_groupby: {key} {card[key]} != the CPU's {cpu[key]}")
    if card["matched"] != card["expected_matched"] or card["dropped"] != 0:
        raise AssertionError(f"distributed_groupby: {card['lines']}")
    cpu_err = float(np.abs(card["sums"] - cpu["sums"]).max())
    if card["max_err"] > EXAMPLE_SUM_TOL or cpu_err > EXAMPLE_SUM_TOL:
        raise AssertionError(f"distributed_groupby: sums off by {card['max_err']} from "
                             f"np.add.at, {cpu_err} from the CPU's")
    runs["distributed_groupby"].update(max_err=card["max_err"], max_err_vs_cpu=cpu_err)

    wall = time.perf_counter() - t_phase
    log(f"  phase 14 wall {wall:.3f} s (budget {EXAMPLES_BUDGET_S:.0f} s"
        f"{'' if wall <= EXAMPLES_BUDGET_S else ': over it'})")
    return {"twins": runs, "train_steps": EXAMPLE_TRAIN_STEPS, "wall_s": wall,
            "device": gpu_name_power()}


def compare_results(q: str, got: dict, want: dict, rtol: float = QUERY_RTOL) -> bool:
    """The same columns, ints, codes and rows exact, floats within ``rtol``
    (NaN equal to NaN); returns whether every bit held."""
    if set(got) != set(want):
        raise AssertionError(f"{q}: columns {sorted(got)} != {sorted(want)}")
    bits = True
    for name in want:
        a, b = np.asarray(got[name]), np.asarray(want[name])
        if a.shape != b.shape:
            raise AssertionError(f"{q}.{name}: shape {a.shape} != {b.shape}")
        if a.dtype.kind == "f" or b.dtype.kind == "f":
            if not np.allclose(a, b, rtol=rtol, atol=0.0, equal_nan=True):
                raise AssertionError(f"{q}.{name}: floats differ beyond rtol {rtol}")
            bits = bits and np.array_equal(a, b, equal_nan=True)
        elif not (a == b).all():
            raise AssertionError(f"{q}.{name}: values or row order differ")
    return bits


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
    # phase 3d: the SQL front end on the same frames and tables
    sql_run = sql_phase(torch, ops, sf, frames, tables, args.sf, dev, res2)
    # phase 3e: the same texts compiled, one CUDA graph per plan
    compiled_run = compiled_phase(torch, ops, frames, args.sf, sql_run, res2)
    # phases 10 and 11: out of core and SQL serving over 3d's stores
    stores = sql_run.pop("stores")
    ooc_run, ooc_rows, ooc_q1 = ooc_phase(torch, ops, seg, stores, sql_run, args.sf, dev)
    shapes["segment_sum"] += ooc_rows
    serve_run = serve_phase(torch, ops, frames, stores, sql_run, args.sf, dev, args.seed)
    # phase 12: the distributed layer, on the same frames and stores
    dist_run = dist_phase(torch, ops, QF, frames, stores, sql_run, ooc_q1, res2, args.sf, dev)
    del frames, tables, res1, res2, stores, ooc_q1
    torch.cuda.empty_cache()

    # phase 4: card vs CPU plain path, the frame queries and the SQL texts
    from repro_torch import sql
    from repro_torch.queries.tpch_sql import sql_text

    log(f"phase 4: card vs CPU at SF {CHECK_SF}")
    small = tpch.generate(sf=CHECK_SF, seed=args.seed)
    card_frames = tpch.as_frames(small, device=dev)
    cpu_frames = tpch.as_frames(small, device="cpu")
    on_card, _ = run_queries(torch, QF, card_frames, CHECK_SF)
    on_cpu, _ = run_queries(torch, QF, cpu_frames, CHECK_SF)
    for q in on_cpu:
        compare_results(q, on_card[q], on_cpu[q])
    log(f"  22 queries agree (ints/codes/order exact, floats rtol {QUERY_RTOL})")
    texts = {q: sql_text(q, CHECK_SF) for q in on_cpu}
    sql_card, _, _, _ = sql_pass(torch, ops, sql, card_frames, texts)
    sql_cpu, _, _, _ = sql_pass(torch, ops, sql, cpu_frames, texts)
    for q in texts:
        compare_results(f"SQL {q}", sql_card[q], sql_cpu[q])
    log(f"  22 SQL texts agree (ints/codes/order exact, floats rtol {QUERY_RTOL})")
    del small, card_frames, cpu_frames, on_card, on_cpu, sql_card, sql_cpu
    # phase 4's texts took the compiled route (auto, SF 0.01): free its graphs
    from repro_torch.sql import compile as plan_compile

    plan_compile.clear_cache()
    torch.cuda.empty_cache()

    # phase 9: TPC-DS, the store and the loaders
    shapes["segment_sum"] += tpcds_phase(torch, ops, seg, dev, args.seed)
    torch.cuda.empty_cache()

    # phases 6 and 7: the LM path at full width, then card vs CPU
    lm_runs = lm_phase(torch, ops, dev, args.seed)
    f32_runs = lm_check_phase(torch, ops, dev)
    # phase 8: training, card vs CPU, then at full width
    train_f32 = train_check_phase(torch, ops, dev)
    train_runs = train_phase(torch, ops, dev, args.seed)
    # phase 13: the sharded dry run, and K4 and K5 under DTensor
    sharded_run = sharded_phase(torch, ops, dev, args.seed)
    # phase 14: the example twins on the card
    examples_run = examples_phase(torch, ops, dev)
    # launches of each kernel in its main-path run: K4's bf16 kernel in
    # Qwen3-14B's prefill, its f32 kernel in the reduced f32 Qwen3-14B
    # prefill of phase 7, K5 in RWKV6-7B's serving run, K3 in its one call
    # of ops.hash32x2 (no path of the engine calls it)
    launches["flash_attention_sm90"] = (
        lm_runs["qwen3-14b"]["prefill"]["launches"]["flash_attention_sm90"])
    launches["flash_attention_f32_sm90"] = f32_runs["qwen3-14b"]["flash_attention_f32_sm90"]
    launches["wkv6"] = lm_runs["rwkv6-7b"]["serve"]["launches"]["wkv6"]
    # K5's chunked form: one RWKV6-7B train step of phase 8b (T 4096)
    launches["wkv6_chunked"] = train_runs["rwkv6-7b"]["launches"]["wkv6_chunked"]
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
        "wkv6_chunked": ("src/repro_torch/kernels/csrc/wkv6_chunked.cu",
                         "src/repro/kernels/wkv6.py:51"),
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
            # the bound at the CUDA cores' float32 rate, where the row's
            # takes a tensor-core one
            **({"bound_cuda_cores_ms": row["bound_cuda_cores_ms"]}
               if "bound_cuda_cores_ms" in row else {}),
            "backward": name in BACKWARD_KERNELS,
            # K1's float sums give the same bits on every launch (phase 2a)
            **({"deterministic": True,
                "library_deterministic_ms": row["library_deterministic_ms"]}
               if name == "segment_sum" else {}),
            # K1's and K2's launches on the out-of-core pass (phase 10) and
            # in serving (phase 11), apart from the main path's
            **({"launches_out_of_core": ooc_run["launches"][name],
                "launches_serving": serve_run["launches"][name]}
               if name in ooc_run["launches"] else {}),
            # K1's launches in phase 12 (the distributed layer)
            **({"launches_distributed": dist_run["k1_launches"]}
               if name == "segment_sum" else {}),
            # launches on DTensors in phase 13 (the step on the (1, 1) mesh)
            "launches_sharded": sharded_run["launches_sharded"].get(name, 0),
            # K1's q1 shapes, its mid path and TPC-DS's largest call on
            # each path, K4's later families' shapes,
            # K5's prefill shape (0 launches on the serving path)
            "other_shapes": [{key: r[key] for key in timed} for r in rows[1:]],
        })
    idle = [k["name"] for k in kernels if k["launches"] == 0]
    if idle:
        raise AssertionError(f"kernels never launched on their paths: {idle}")
    log(f"wall time {time.perf_counter() - t_all:.3f} s")
    # the SQL pass's launches (phase 3d, two passes of the 22 texts), apart
    # from each kernel's main-path launches in the kernels line
    log(json.dumps({"compiled_sql": compiled_run}))
    log(json.dumps({"out_of_core": ooc_run}))
    log(json.dumps({"sql_serving": serve_run}))
    log(json.dumps({"distributed": dist_run}))
    log(json.dumps({"sharded": sharded_run}))
    log(json.dumps({"examples": examples_run}))
    log(json.dumps({"sql_launches": sql_run["launches"],
                    "segment_sum_by_path_pass1": sql_run["by_path"],
                    "substr_find_by_form_pass1": sql_run["by_form"]}))
    log(json.dumps({"kernels": kernels}))
    log(gpu_name_power())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
