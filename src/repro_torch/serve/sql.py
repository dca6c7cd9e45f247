"""Concurrent SQL serving: sessions, prepared statements, micro-batches.

``Executor`` is the framequery-style entry point: a scope of tables
(TensorFrames, ``repro_torch.store`` chunked tables, or raw
dict-of-numpy), ``execute``/``submit`` for queries, ``add_function``
for scalar UDFs (lowered through ``torch.func.vmap``), ``prepare`` for
parameterized statements, and ``session()`` for isolated per-client UDF
registries over the shared scope.  Raw dicts and store scans land on
the executor's ``device`` (default ``CONFIG.device``, the card;
``device="cpu"`` asks for the CPU); frames stay where they are.

All execution funnels through one ``AdmissionQueue`` worker, the only
thread that touches the card (a captured graph's replay is not
reentrant, and executions serialize on the compiled path's run lock);
client threads only enqueue and wait on futures.  Queries submitted
concurrently land in the same micro-batch and share work:

- **shared store scans** — every store-backed Scan in the batch is
  grouped by ``(table, columns, predicates)``; each table with two or
  more participating scans is answered by *one*
  ``store.shared_scan`` pass (chunk decodes and predicate row-masks
  computed once), and the per-query plans consume the pre-materialized
  frames through ``lower_plan``'s scan cache;
- **coalescing** — textually identical queries under the same UDF
  environment execute once and share the result frame;
- **plan-cache adjacency** — batch members are dispatched grouped by
  parameterized plan shape, so prepared-statement traffic with varying
  literals runs as consecutive zero-retrace compiled-cache hits.

Resilience (``repro_torch.resilience``):

- every failure reaching a caller is a typed ``QueryError`` —
  ``PlanError`` for parse/plan rejections, ``QueryTimeout`` /
  ``QueryCancelled`` / ``ResourceExhausted`` for policy, classified
  ``ExecutionError``/``TransientIOError`` otherwise (a CUDA error, a
  device out-of-memory or a kernel's build or launch failure is an
  ``ExecutionError``, never retried on another device) — counted
  per-class in ``serve.STATS.snapshot()["errors"]``;
- ``submit``/``execute`` take ``timeout_s`` (default
  ``CONFIG.serve_default_timeout_s``); the deadline is enforced at
  admission dequeue (an expired-in-queue request is shed, not
  executed) and cooperatively at operator/chunk checkpoints during
  execution.  ``cancel(request_id)`` — the id rides on the returned
  future — aborts a queued request immediately and an executing one at
  its next checkpoint.  Coalesced groups execute under the *loosest*
  member deadline and only abort when every member is cancelled;
  members cancelled mid-flight get ``QueryCancelled`` at resolution;
- per-session in-flight caps (``CONFIG.serve_session_inflight``)
  reject floods with ``ResourceExhausted`` before they queue.

Results come back through ``concurrent.futures.Future``; ``execute``
is ``submit().result()``.  ``serve.STATS`` counts what the batcher
actually did.
"""
from __future__ import annotations

import itertools
import threading
import time
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.core.config import CONFIG, resolve_device
from repro_torch.kernels.build import KernelError
from repro_torch.resilience import (
    QueryCancelled,
    QueryTimeout,
    ResourceExhausted,
    classify,
    deadline_scope,
)
from repro_torch.resilience.deadline import CancelToken

from .admission import AdmissionQueue
from .stats import STATS

__all__ = ["Executor", "Prepared", "Session"]

_REQUEST_IDS = itertools.count(1)


def _device_fault(exc: BaseException) -> bool:
    """A failure of the card or of a kernel (a CUDA error, a device
    out-of-memory, a kernel that failed to build, load or launch): it
    reaches the caller, and no fallback may hide it."""
    if isinstance(exc, (torch.OutOfMemoryError, KernelError)):
        return True
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(exc, accel):
        return True
    return isinstance(exc, RuntimeError) and "CUDA" in str(exc)


class _Request:
    __slots__ = (
        "text",
        "udfs",
        "prepared",
        "future",
        "t_submit",
        "plan",
        "scan_keys",
        "shape_key",
        "request_id",
        "expires_at",
        "token",
        "session_key",
        "_owner",
    )

    def __init__(
        self,
        owner: "Executor",
        text: str,
        udfs: Dict,
        prepared: bool,
        timeout_s: Optional[float],
        session_key: Optional[int],
    ) -> None:
        self.text = text
        self.udfs = udfs
        self.prepared = prepared
        self.future: Future = Future()
        self.t_submit = time.perf_counter()
        self.plan = None
        self.scan_keys: List[tuple] = []
        self.shape_key = text
        self.request_id = next(_REQUEST_IDS)
        self.future.request_id = self.request_id
        if timeout_s is None:
            timeout_s = CONFIG.serve_default_timeout_s
        self.expires_at = (
            None if timeout_s is None else time.monotonic() + float(timeout_s)
        )
        self.token = CancelToken()
        self.session_key = session_key
        self._owner = owner

    @property
    def expired(self) -> bool:
        return (
            self.expires_at is not None
            and time.monotonic() > self.expires_at
        )

    # bookkeeping hooks (the admission queue calls ``fail`` for sheds)
    def fail(self, exc, shed_reason: Optional[str] = None) -> None:
        self._owner._fail(self, exc, shed_reason=shed_reason)

    def finish(self, out) -> None:
        self._owner._resolve(self, out)


class _GroupToken:
    """Cancel view of a coalesced group: cancelled only when *every*
    member asked to cancel — one client must not kill a result other
    members still want."""

    __slots__ = ("_tokens",)

    def __init__(self, tokens: List[CancelToken]) -> None:
        self._tokens = tokens

    @property
    def cancelled(self) -> bool:
        return all(t.cancelled for t in self._tokens)


class Prepared:
    """A parameterized statement bound to an executor or session.

    ``{name}`` placeholders are formatted per call; the formatted text
    re-plans (cheap host work — optimizer constant folding makes plan
    *structure* depend on literal values, so substituting into a saved
    plan would be unsafe) and rides the compiled-plan cache, which
    abstracts literals into parameter slots: after the first call,
    every parameter set replays one captured CUDA graph (on the card)."""

    def __init__(self, owner, template: str) -> None:
        self._owner = owner
        self.template = template
        self.calls = 0

    def submit(self, *, timeout_s: Optional[float] = None, **params) -> Future:
        self.calls += 1
        return self._owner._submit(
            self.template.format(**params),
            prepared=True,
            timeout_s=timeout_s,
        )

    def execute(self, *, timeout_s: Optional[float] = None, **params):
        return self.submit(timeout_s=timeout_s, **params).result()


class Session:
    """Per-client view of an executor: shared tables, isolated UDFs,
    its own in-flight budget."""

    def __init__(self, executor: "Executor") -> None:
        self._executor = executor
        self._udfs: Dict[str, object] = {}

    def add_function(self, name: str, fn: Callable, *, returns: str = "num"):
        from repro_torch.sql.udf import Udf

        u = Udf(name, fn, returns=returns)
        self._udfs[u.name] = u
        return u

    def _active(self) -> Dict:
        # session registrations shadow executor-level ones
        return {**self._executor._udfs, **self._udfs}

    def _submit(
        self,
        text: str,
        prepared: bool = False,
        timeout_s: Optional[float] = None,
    ) -> Future:
        return self._executor._enqueue(
            text,
            self._active(),
            prepared,
            timeout_s=timeout_s,
            session_key=id(self),
        )

    def submit(self, query: str, *, timeout_s: Optional[float] = None) -> Future:
        return self._submit(query, timeout_s=timeout_s)

    def execute(self, query: str, *, timeout_s: Optional[float] = None):
        return self._submit(query, timeout_s=timeout_s).result()

    def cancel(self, request_id: int) -> bool:
        """Cancel one of this session's in-flight requests (see
        ``Executor.cancel``)."""
        return self._executor.cancel(request_id)

    def prepare(self, template: str) -> Prepared:
        return Prepared(self, template)


class Executor:
    """Serve SQL queries over a fixed scope, batching concurrent work.

    ``auto_start=False`` leaves the admission worker off; tests then
    stage submissions and run exactly one micro-batch with
    ``drain_once()``.  ``device`` (default ``CONFIG.device``; a CUDA
    device with no card raises) receives the scope's raw dicts and
    every store scan, shared or not.
    """

    def __init__(
        self, scope: Dict, *, auto_start: bool = True, device=None
    ) -> None:
        from repro_torch.sql.lower import scope_frames

        self._device = resolve_device(device)
        self._frames = scope_frames(scope, self._device)
        self._udfs: Dict[str, object] = {}
        self._inflight: Dict[int, _Request] = {}
        self._session_load: Dict[int, int] = {}
        self._reg_lock = threading.Lock()
        self._queue = AdmissionQueue(self._run_batch, auto_start=auto_start)

    # -- scope / registry -----------------------------------------------
    def update(self, **tables) -> None:
        """Add or replace scope entries (copy-on-write: in-flight
        batches keep the scope they were planned against)."""
        from repro_torch.sql.lower import scope_frames

        self._frames = {
            **self._frames,
            **scope_frames(tables, self._device),
        }

    def add_function(self, name: str, fn: Callable, *, returns: str = "num"):
        """Register a scalar python UDF, visible to every session."""
        from repro_torch.sql.udf import Udf

        u = Udf(name, fn, returns=returns)
        self._udfs[u.name] = u
        return u

    def session(self) -> Session:
        return Session(self)

    # -- submission ------------------------------------------------------
    def _enqueue(
        self,
        text: str,
        udfs: Dict,
        prepared: bool,
        timeout_s: Optional[float] = None,
        session_key: Optional[int] = None,
    ) -> Future:
        cap = CONFIG.serve_session_inflight
        with self._reg_lock:
            if (
                cap is not None
                and session_key is not None
                and self._session_load.get(session_key, 0) >= int(cap)
            ):
                STATS.bump_shed("session_cap")
                STATS.bump_error("resource_exhausted")
                raise ResourceExhausted(
                    f"session has {cap} requests in flight "
                    f"(CONFIG.serve_session_inflight)"
                )
            req = _Request(self, text, udfs, prepared, timeout_s, session_key)
            self._inflight[req.request_id] = req
            if session_key is not None:
                self._session_load[session_key] = (
                    self._session_load.get(session_key, 0) + 1
                )
        try:
            return self._queue.submit(req)
        except Exception:
            self._unregister(req)
            raise

    def _submit(
        self,
        text: str,
        prepared: bool = False,
        timeout_s: Optional[float] = None,
    ) -> Future:
        return self._enqueue(
            text, dict(self._udfs), prepared, timeout_s=timeout_s
        )

    def submit(self, query: str, *, timeout_s: Optional[float] = None) -> Future:
        return self._submit(query, timeout_s=timeout_s)

    def execute(self, query: str, *, timeout_s: Optional[float] = None):
        return self._submit(query, timeout_s=timeout_s).result()

    def cancel(self, request_id: int) -> bool:
        """Request cooperative cancellation of an in-flight query.

        A still-queued request is shed with ``QueryCancelled`` before
        it executes; an executing one aborts at its next checkpoint
        (unless it shares a coalesced execution with members that did
        not cancel — then only this member's future gets
        ``QueryCancelled``).  Returns False when the id is unknown or
        already resolved.
        """
        with self._reg_lock:
            req = self._inflight.get(request_id)
        if req is None:
            return False
        req.token.cancel()
        return True

    def prepare(self, template: str) -> Prepared:
        return Prepared(self, template)

    def drain_once(self) -> int:
        """Run one micro-batch synchronously (``auto_start=False``)."""
        return self._queue.drain_once()

    def close(self) -> None:
        self._queue.close()

    def __enter__(self) -> "Executor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- resolution bookkeeping ------------------------------------------
    def _unregister(self, req: _Request) -> None:
        with self._reg_lock:
            self._inflight.pop(req.request_id, None)
            if req.session_key is not None:
                n = self._session_load.get(req.session_key, 0) - 1
                if n > 0:
                    self._session_load[req.session_key] = n
                else:
                    self._session_load.pop(req.session_key, None)

    def _fail(
        self, req: _Request, exc, shed_reason: Optional[str] = None
    ) -> None:
        self._unregister(req)
        err = classify(exc)
        STATS.bump_error(err.code)
        if shed_reason is not None:
            STATS.bump_shed(shed_reason)
        if not req.future.done():
            req.future.set_exception(err)

    def _resolve(self, req: _Request, out) -> None:
        self._unregister(req)
        STATS.record_latency(time.perf_counter() - req.t_submit)
        if not req.future.done():
            req.future.set_result(out)

    # -- batch execution (admission worker thread) -----------------------
    def _shed_stale(self, batch: List[_Request]) -> List[_Request]:
        """Admission-dequeue deadline/cancel enforcement: a request
        whose deadline passed (or that was cancelled) while queued is
        shed with a typed error, never executed."""
        live: List[_Request] = []
        for req in batch:
            if req.token.cancelled:
                self._fail(
                    req,
                    QueryCancelled("cancelled while queued"),
                    shed_reason="cancelled",
                )
            elif req.expired:
                waited = time.perf_counter() - req.t_submit
                self._fail(
                    req,
                    QueryTimeout(
                        f"deadline exceeded after {waited * 1e3:.1f}ms in "
                        f"admission queue"
                    ),
                    shed_reason="deadline",
                )
            else:
                live.append(req)
        return live

    def _run_batch(self, batch: List[_Request]) -> None:
        from repro_torch import obs
        from repro_torch.sql import compile as _compile

        batch = self._shed_stale(batch)
        if not batch:
            return
        t_start = time.perf_counter()
        for req in batch:  # queue phase: submit -> batch start
            STATS.record_phase("queue", t_start - req.t_submit)

        with obs.span("serve.batch", size=len(batch)):
            frames = self._frames  # one snapshot for the whole batch
            groups = self._coalesce(batch)
            live = self._plan_batch(groups, frames)
            with obs.span("serve.shared_scan"):
                try:
                    scan_cache = self._share_scans(live, frames)
                except Exception as e:
                    # a device fault (``_device_fault``): every member
                    # gets it, typed, and none runs on its own scan
                    err = classify(e)
                    for group in live:
                        for member in group:
                            self._fail(member, err)
                    return

            STATS.bump(batches=1)
            if len(batch) >= 2:
                STATS.bump(batched_queries=len(batch))

            # dispatch grouped by parameterized plan shape: same-shape
            # members run back-to-back as compiled-cache hits
            live.sort(key=lambda g: g[0].shape_key)
            hits_before = _compile.STATS["hits"]
            for group in live:
                self._run_group(group, frames, scan_cache)
            with_hits = _compile.STATS["hits"] - hits_before
            if with_hits > 0:
                STATS.bump(plan_cache_hits=with_hits)

    def _coalesce(self, batch: List[_Request]) -> List[List[_Request]]:
        """Group identical (text, UDF environment) requests: each group
        parses, plans, and executes once, sharing one result frame."""
        if not CONFIG.serve_coalesce:
            return [[req] for req in batch]
        groups: Dict[tuple, List[_Request]] = {}
        for req in batch:
            ckey = (
                req.text,
                tuple(sorted((n, id(u)) for n, u in req.udfs.items())),
            )
            groups.setdefault(ckey, []).append(req)
        for members in groups.values():
            if len(members) > 1:
                STATS.bump(coalesced=len(members) - 1)
        return list(groups.values())

    def _plan_batch(
        self, groups: List[List[_Request]], frames: Dict
    ) -> List[List[_Request]]:
        """Plan each group's representative; planning failures resolve
        every member of that group with a typed (usually ``PlanError``)
        exception."""
        from repro_torch import sql
        from repro_torch.sql import compile as _compile
        from repro_torch.sql.lower import scan_cache_key
        from repro_torch.sql.plan import walk_scans
        from repro_torch.sql.udf import udf_scope
        from repro_torch.store import Table as StoreTable

        from repro_torch import obs

        live: List[List[_Request]] = []
        for group in groups:
            req = group[0]
            t0 = time.perf_counter()
            try:
                with obs.span("serve.plan"), udf_scope(req.udfs):
                    req.plan = sql.plan_query(
                        req.text, frames, optimized=True
                    )
                for node in walk_scans(req.plan):
                    if isinstance(frames.get(node.table), StoreTable):
                        req.scan_keys.append(scan_cache_key(node))
                try:
                    req.shape_key = repr(_compile.parameterize(req.plan)[0])
                except Exception:
                    req.shape_key = req.text
            except Exception as e:  # parse/plan error -> the caller(s)
                err = classify(e, phase="plan")
                for member in group:
                    self._fail(member, err)
                continue
            finally:
                STATS.record_phase("plan", time.perf_counter() - t0)
            live.append(group)
        return live

    def _share_scans(
        self, live: List[List[_Request]], frames: Dict
    ) -> Dict:
        """One ``store.shared_scan`` pass per table that two or more
        executed queries scan; returns the lower-layer scan cache."""
        from repro_torch import store
        from repro_torch.core import TensorFrame

        scan_cache: Dict[tuple, object] = {}
        if not CONFIG.serve_shared_scans:
            return scan_cache

        by_table: Dict[str, Dict[tuple, int]] = {}
        for group in live:
            for key in group[0].scan_keys:
                by_table.setdefault(key[0], {})
                by_table[key[0]][key] = by_table[key[0]].get(key, 0) + 1

        for tname, keys in by_table.items():
            participants = sum(keys.values())
            if participants < 2:
                continue  # nothing to share for this table
            table = frames[tname]
            specs = list(keys)  # unique (table, cols, preds) identities
            try:
                results = store.shared_scan(
                    table,
                    [(list(k[1]), list(k[2])) for k in specs],
                )
                for k, res in zip(specs, results):
                    scan_cache[k] = TensorFrame.from_store(
                        table,
                        list(k[1]),
                        list(k[2]),
                        result=res,
                        device=self._device,
                    )
            except Exception as exc:
                if _device_fault(exc):
                    raise  # the card or a kernel failed: no quiet fallback
                # graceful degradation: every member falls back to its
                # own scan — observable, never silent
                STATS.bump(shared_scan_errors=1)
                continue
            STATS.bump(
                shared_scan_groups=1, shared_scan_queries=participants
            )
        return scan_cache

    @staticmethod
    def _compile_seconds() -> float:
        """Cumulative trace+capture seconds the compiled path has spent
        (deltas around a group attribute its compile cost)."""
        from repro_torch.sql import compile as _compile

        # the port's plan records carry ``trace_s`` (the traced run) and
        # ``compile_s`` (warm-up and CUDA graph capture), not XLA
        # compile times: together they are the "compile" phase here
        with _compile._LOCK:
            return sum(
                r["trace_s"] + r["compile_s"]
                for r in _compile.STATS["plans"].values()
            )

    @staticmethod
    def _group_deadline(group: List[_Request]) -> Optional[float]:
        """The loosest member deadline (None if any member is
        unbounded): a shared execution must not be aborted by its most
        impatient member while others still want the result."""
        expiries = [m.expires_at for m in group]
        if any(e is None for e in expiries):
            return None
        return max(expiries)

    def _run_group(
        self, group: List[_Request], frames: Dict, scan_cache: Dict
    ) -> None:
        from repro_torch import obs, sql
        from repro_torch.sql.udf import udf_scope

        group = self._shed_stale(group)
        if not group:
            return
        req = group[0]
        cache = (
            scan_cache
            if scan_cache and any(k in scan_cache for k in req.scan_keys)
            else None
        )
        t0 = time.perf_counter()
        c0 = self._compile_seconds()
        try:
            with obs.span("serve.execute", queries=len(group)), udf_scope(
                req.udfs
            ), deadline_scope(
                at=self._group_deadline(group),
                token=_GroupToken([m.token for m in group]),
            ):
                out = sql.execute_plan(
                    req.plan, frames, scan_cache=cache, device=self._device
                )
        except Exception as e:
            err = classify(e)
            for member in group:
                self._fail(member, err)
            return
        finally:
            compile_s = max(self._compile_seconds() - c0, 0.0)
            STATS.record_phase("compile", compile_s)
            STATS.record_phase(
                "execute",
                max(time.perf_counter() - t0 - compile_s, 0.0),
            )
        if req.udfs:
            STATS.bump(udf_queries=1)
        for member in group:
            if member.token.cancelled:
                # cancelled mid-flight but the shared execution carried
                # on for the other members
                self._fail(
                    member, QueryCancelled("cancelled during execution")
                )
                continue
            if member.prepared:
                STATS.bump(prepared=1)
            self._resolve(member, out)
