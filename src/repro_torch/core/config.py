"""Engine-wide configuration of the port (the knobs the dataframe path
reads), and the device policy of its entry points."""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch


@dataclasses.dataclass
class EngineConfig:
    # Columns with (n_distinct / n_rows) <= card_threshold are
    # dictionary-encoded into the int tensor; above it they are offloaded
    # (paper §III-c/d uses 50%).
    card_threshold: float = 0.5
    # Measure tensor dtype: float64 keeps the reference's exact analytics
    # on the card too.
    float_dtype: str = "float64"
    # When True, string predicates on offloaded columns run on the packed
    # (n, maxlen) uint8 tensor of the physical rows (the substring kernel
    # on the card) instead of the dictionary-LUT path.
    use_device_strings: bool = False
    # Maximum packed string width for the packed string paths.
    max_packed_len: int = 128
    # Distributed execution route (repro_torch.dist): 'off' never shards,
    # 'force' always takes the sharded route (tests exercise it on a
    # one-rank group; it raises when no process group is initialised),
    # 'auto' shards group-by reduction sums and semi/anti-join probes
    # when a process group of more than one rank is up and the input has
    # at least dist_min_rows rows.
    distributed: str = "auto"
    dist_min_rows: int = 1 << 16
    # Late materialization: row-subsetting ops return RowView frames that
    # compose gather indices; payloads materialize at pipeline exits.
    # False gives the eager copy-per-op engine.
    late_materialization: bool = True
    # Whole-plan compilation (repro_torch.sql.compile): 'off' never
    # compiles, 'force' compiles every supported plan regardless of size,
    # 'auto' compiles when the scanned base tables total at least
    # compiled_min_rows rows (small interactive queries skip the trace
    # cost; repeated large ones amortize it through the plan cache).
    # Plans with untraceable constructs fall back to op-by-op dispatch
    # in every mode.
    compiled: str = "auto"
    compiled_min_rows: int = 1 << 15
    # Concurrent SQL serving (repro_torch.serve.sql): the admission queue
    # drains up to serve_max_batch requests per micro-batch, waiting at
    # most serve_batch_window_ms after the first request for stragglers
    # to accumulate.  serve_shared_scans=False disables the shared
    # zone-map scan pass (every query scans its store tables alone --
    # the baseline for the sharing win); serve_coalesce=False disables
    # duplicate-query coalescing within a batch.
    serve_max_batch: int = 32
    serve_batch_window_ms: float = 2.0
    serve_shared_scans: bool = True
    serve_coalesce: bool = True
    # Resilient serving (repro_torch.resilience): default per-request
    # deadline (None = unbounded; Executor.execute(timeout_s=...)
    # overrides per call), admission-queue depth bound (None =
    # unbounded) with the load-shedding policy applied when it fills
    # ('reject-new' fails the incoming request, 'drop-oldest' sheds the
    # head of the queue), and a per-session in-flight request cap (None
    # = uncapped).  Shed and rejected requests resolve with typed
    # QueryErrors and are counted in serve.STATS.
    serve_default_timeout_s: Optional[float] = None
    serve_queue_depth: Optional[int] = None
    serve_shed_policy: str = "reject-new"
    serve_session_inflight: Optional[int] = None
    # Device of new frames when the caller names none.
    device: str = "cuda"
    # Transient-I/O retry budget (repro_torch.resilience.retry): spill and
    # store reads and writes retry OSError-class failures up to io_retries
    # times with exponential backoff starting at io_retry_base_s.
    io_retries: int = 3
    io_retry_base_s: float = 0.005
    # Out-of-core execution (repro_torch.core.pipeline /
    # repro_torch.sql.stream): 'off' never streams, 'force' streams every
    # supported store-backed aggregate/join pipeline chunk-by-chunk,
    # 'auto' streams when the probe-side store table has at least
    # ooc_min_rows rows (mirrors compiled).  Unsupported plan shapes fall
    # back to the eager path in every mode (counted in
    # pipeline.STATS['fallbacks']).
    out_of_core: str = "auto"
    ooc_min_rows: int = 1 << 20
    # Byte budget for host-side intermediates held by the out-of-core
    # layer (partial aggregates, spillable frames; repro_torch.store.spill).
    # None = unbounded (never spill); small budgets force LRU spills to
    # .tfb v2 chunk files with transparent re-hydration on access.
    memory_budget_bytes: Optional[int] = None
    # Directory for spill files; None = a per-process temp dir cleaned
    # at exit (spilled frames are additionally deleted on GC).
    spill_dir: Optional[str] = None
    # Host-side chunk prefetch depth of the streaming scan: chunk k+1
    # decodes/filters on a worker thread while chunk k runs on the
    # device.  0 disables the overlap.
    ooc_prefetch: int = 2
    # Merge accumulated per-chunk partial aggregates every N chunks
    # (bounds the partial pool even when the budget is unbounded).
    ooc_merge_every: int = 8
    # Span tracing (repro_torch.obs): 'off' = no spans (one branch, no
    # allocation on every instrumented path), 'on' = operator-level spans
    # (join algorithm picks, spill events), 'detailed' = additionally
    # per-chunk spans (retry backoffs).
    tracing: str = "off"


CONFIG = EngineConfig()


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: ``device`` or ``CONFIG.device``.

    Raises when that is a CUDA device and no card is visible: the engine
    never carries on silently on the CPU.
    """
    dev = torch.device(CONFIG.device if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
