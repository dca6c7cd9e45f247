"""Admission control: a bounded queue forming micro-batches of requests.

Clients (any thread) submit work and get a ``concurrent.futures.Future``
back.  A single worker drains the queue, waits out a short straggler
window (``CONFIG.serve_batch_window_ms``) so concurrent submitters land
in the same batch, caps the batch at ``CONFIG.serve_max_batch``, and
hands the whole group to the executor's batch runner.  One worker
serializes engine entry, and so every use of the card: a captured
CUDA graph's replay is not reentrant, and no other thread may call
into CUDA while the worker captures a plan (global capture mode).  The
concurrency win comes from *work sharing across the batch* (shared
store scans, coalesced duplicates, compiled-plan cache adjacency), not
from parallel kernels.  Client threads only enqueue and wait on their
futures.

Resilience:

- **bounded depth** — ``CONFIG.serve_queue_depth`` caps queued
  requests; overflow applies ``CONFIG.serve_shed_policy``:
  ``'reject-new'`` raises ``ResourceExhausted`` at the submitter,
  ``'drop-oldest'`` sheds the queue head (its future resolves with
  ``ResourceExhausted``) to admit the newcomer;
- **worker-crash recovery** — a worker thread found dead at submit
  time is restarted (``serve.STATS['worker_restarts']``); requests
  still queued when it died are simply drained by the replacement.  A
  batch-runner exception never kills the worker: unresolved futures in
  the failed batch get a classified error and the loop continues;
- **typed shutdown** — ``close()`` joins the worker, then resolves
  every still-pending request with ``QueryCancelled`` instead of
  dropping its future (``join(timeout=30)`` can return with requests
  queued, whose futures would otherwise never fire).

Requests must carry ``future`` and a ``fail(exc, shed_reason=)``
callable (the executor's ``_Request`` provides both; ``fail`` keeps
the executor's in-flight registry and error counters coherent).

``auto_start=False`` keeps the worker off so tests can stage a precise
set of requests and run exactly one batch with ``drain_once()``.
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, List, Optional

from repro_torch.core.config import CONFIG
from repro_torch.resilience import QueryCancelled, ResourceExhausted, classify

__all__ = ["AdmissionQueue"]


class _Closed:
    pass


_CLOSED = _Closed()


def _fail(item, exc, shed_reason: Optional[str] = None) -> None:
    """Resolve a request with ``exc`` through its own bookkeeping hook
    when it has one, its bare future otherwise."""
    fail = getattr(item, "fail", None)
    if fail is not None:
        fail(exc, shed_reason=shed_reason)
    elif not item.future.done():
        item.future.set_exception(exc)


class AdmissionQueue:
    """Single-worker micro-batching queue with admission control.

    ``run_batch(requests)`` receives the drained list and must resolve
    every request's future (it gets the full objects the executor
    enqueued; this class only bounds, groups and times them).
    """

    def __init__(
        self,
        run_batch: Callable[[List], None],
        *,
        auto_start: bool = True,
        name: str = "repro-serve",
    ) -> None:
        self._run_batch = run_batch
        self._q: "queue.Queue" = queue.Queue()
        self._closed = False
        self._lock = threading.Lock()
        self._name = name
        self._worker: Optional[threading.Thread] = None
        if auto_start:
            self.start(name=name)

    # -- client side ----------------------------------------------------
    def submit(self, request) -> Future:
        """Enqueue ``request`` (must carry ``future``/``fail``).

        Raises ``QueryCancelled`` after ``close()`` and
        ``ResourceExhausted`` when the queue is full under the
        ``reject-new`` policy.
        """
        from .stats import STATS

        dropped = None
        with self._lock:
            if self._closed:
                raise QueryCancelled("admission queue is closed")
            self._restart_if_dead()
            depth = CONFIG.serve_queue_depth
            if depth is not None and self._q.qsize() >= int(depth):
                if CONFIG.serve_shed_policy == "drop-oldest":
                    try:
                        dropped = self._q.get_nowait()
                    except queue.Empty:
                        dropped = None
                    if dropped is _CLOSED:  # never shed the sentinel
                        self._q.put(_CLOSED)
                        dropped = None
                else:  # reject-new
                    raise ResourceExhausted(
                        f"admission queue full (depth={depth}, "
                        f"policy=reject-new)"
                    )
            self._q.put(request)
        if dropped is not None:
            _fail(
                dropped,
                ResourceExhausted(
                    "shed by drop-oldest admission policy"
                ),
                shed_reason="queue_full",
            )
        STATS.bump(admitted=1)
        return request.future

    def _restart_if_dead(self) -> None:
        """Under ``self._lock``: revive a worker thread that died (a
        non-Exception escape like SystemExit).  The queue object — and
        thus every still-queued request — survives the old thread, so
        the replacement simply resumes draining them."""
        w = self._worker
        if w is None or w.is_alive() or self._closed:
            return
        from .stats import STATS

        STATS.bump(worker_restarts=1)
        self._worker = threading.Thread(
            target=self._loop, name=self._name, daemon=True
        )
        self._worker.start()

    # -- worker side ----------------------------------------------------
    def _drain(self, block: bool) -> List:
        """Pull one micro-batch: first item (optionally blocking), then
        whatever lands inside the straggler window, up to the cap."""
        from repro_torch import obs

        batch: List = []
        try:
            first = self._q.get(block=block, timeout=0.2 if block else None)
        except queue.Empty:
            return batch
        if first is _CLOSED:
            raise StopIteration
        batch.append(first)
        cap = max(1, int(CONFIG.serve_max_batch))
        # the straggler wait is deliberate batching latency, not work —
        # its own span keeps it distinguishable in traces
        with obs.span("serve.batch_assembly") as sp:
            deadline = time.monotonic() + CONFIG.serve_batch_window_ms / 1e3
            while len(batch) < cap:
                remaining = deadline - time.monotonic()
                try:
                    item = self._q.get(
                        block=remaining > 0, timeout=max(remaining, 0) or None
                    )
                except queue.Empty:
                    break
                if item is _CLOSED:
                    self._q.put(_CLOSED)  # leave the sentinel for the loop
                    break
                batch.append(item)
            sp.set(batch=len(batch))
        return batch

    def drain_once(self) -> int:
        """Synchronously run one micro-batch from whatever is queued.
        Test/bench hook (requires ``auto_start=False``).  Returns the
        batch size."""
        batch = self._drain(block=False)
        if batch:
            self._run_batch(batch)
        return len(batch)

    def _loop(self) -> None:
        while True:
            try:
                batch = self._drain(block=True)
            except StopIteration:
                return
            if not batch:
                continue
            try:
                self._run_batch(batch)
            except BaseException as e:
                # the batch runner resolves futures itself; anything
                # escaping it is a harness bug or an injected crash —
                # fail what it left unresolved so no caller hangs
                err = classify(e)
                for item in batch:
                    if not item.future.done():
                        _fail(item, err)
                if not isinstance(e, Exception):
                    raise  # SystemExit/KeyboardInterrupt: thread dies,
                    # _restart_if_dead revives it on the next submit

    def start(self, name: str = "repro-serve") -> None:
        with self._lock:
            if self._worker is not None or self._closed:
                return
            self._name = name
            self._worker = threading.Thread(
                target=self._loop, name=name, daemon=True
            )
            self._worker.start()

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            worker = self._worker
        self._q.put(_CLOSED)
        if worker is not None:
            worker.join(timeout=30)
        # drain everything still queued — racers past the closed check
        # AND requests a wedged/dead worker never got to — with a typed
        # cancellation instead of silently dropping their futures
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not _CLOSED and not item.future.done():
                _fail(
                    item,
                    QueryCancelled("executor closed with request pending"),
                    shed_reason="closed",
                )
