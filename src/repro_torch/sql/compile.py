"""Whole-plan compilation: one captured CUDA graph per query plan.

The op-by-op engine dispatches each plan node separately and host-syncs
between several of them (join uniqueness probes, group counts, scalar
subqueries).  This module instead lowers the *whole* optimized logical
plan into a single traced function over the base-table tensors and, on
the card, captures it as one ``torch.cuda.CUDAGraph``, so a repeated
query is one graph replay.

Capture needs what tracing needs: no host sync and static shapes.  So
every relation inside the program is a fixed-capacity ``CTable``:
payload tensors padded to a power-of-two row capacity plus a device
valid-row count ``n`` (rows ``[0, n)`` are live, in their original
order).  Host-computed base-table value bounds travel with each
relation as trace-time constants, so composite keys pack into single
int64 codes with *static* spans: joins direct-address a dense table
when the code space fits (sort + ``searchsorted`` otherwise), small
group-by key spaces segment without sorting at all, and ORDER BY
scatters a rank bijection instead of sorting several keys.  Group sums
and counts go through ``kernels.ops.segment_sum`` (K1, deterministic,
so two copies of one SUM agree bit for bit), LIKE over a large
dictionary through the substring kernel (K2): both launch on the
current stream and allocate through the caching allocator, so a graph
captures them as they are.

A cache miss runs the traced function once eagerly (the "trace"),
under a guard that raises ``TraceGuardError`` where the traced code
reads a device value on the host or asks for a data-dependent shape --
the counterpart of JAX's concretization errors.  On the card it then
warms the function up on a side stream and captures it (``compile_s``);
host-to-device copies made by the traced code (dictionary lookup
tables, string patterns) are hoisted out of the graph: the trace keeps
each one, and the capture reads the kept tensor.  Every graph of the
cache captures into one memory pool.  A hit copies the literals into
the entry's parameter buffers and the base tables into their padded
copies where they changed, replays, reads ``n`` back once and copies
the first ``n`` rows out.  On the CPU there is no graph: an entry keeps
the traced function and runs it eagerly on each call.

Entries are keyed by a fingerprint of (plan structure with literals
replaced by parameter markers, per-table schema + dtypes + bucketed
capacities + value bounds + the key-uniqueness verdicts the plan asks
for -- only those, so a plan's fingerprint does not change when other
plans have asked a table for more verdicts), so repeated
parameterized queries -- same shape, different literals -- reuse the
graph with zero new captures.  Anything the tracer cannot express
(non-unique-side inner joins, float group keys, store-backed scans)
raises ``Unsupported`` and falls back to the op-by-op engine, as do
``SqlError`` and ``TraceGuardError``; the verdict is negative-cached.
An error raised during warm-up or capture is a fault of this module,
not a verdict on the plan: it propagates.  ``CONFIG.compiled`` picks
the route: ``off`` | ``auto`` (size-gated) | ``force``.

Concurrency (for the serving layer): a graph's parameter buffers, the
padded base tables and the shared memory pool make a replay
non-reentrant.  Two threads first-compiling the same fingerprint
serialize on that fingerprint's lock (one traces, the other reuses the
entry); every trace, capture and replay -- with its copy-out -- runs
under one module lock, so executions of distinct fingerprints
serialize too, and a later graph never overwrites a result before it
is copied out.

Observability: ``STATS`` counts cache hits/misses/evictions/fallbacks
and records each plan's trace and compile seconds and its calls.  The
``sql.compile.prepare`` span covers an execution's host work up to the
cache lookup (scans, table prep, unique requests, parameters, the
fingerprint), ``sql.compile.execute`` the replay and its copy-out;
``run_compiled`` tells its caller whether the graph was cached, and the
plan's digest.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
import weakref
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .. import obs
from ..core.config import CONFIG
from ..core import strings
from ..core.expr import Expr, Value
from ..core.frame import (
    INT,
    ColumnMeta,
    TensorFrame,
    _empty_tensor,
    _valid_name,
    count_d2h,
    float_dtype,
    host,
)
from ..kernels import ops

from .parser import (
    Boxed,
    SBin,
    SCol,
    SDate,
    SExtract,
    SFunc,
    SIn,
    SLike,
    SLit,
    SqlError,
    transform,
)
from .plan import (
    Aggregate,
    AttachScalar,
    Distinct,
    Filter,
    Join,
    Limit,
    Project,
    Scan,
    Shared,
    Sort,
    node_columns,
    walk_scans,
)
from .lower import to_expr
from .udf import active_udfs, plan_uses_udf

__all__ = [
    "STATS",
    "TraceGuardError",
    "Unsupported",
    "clear_cache",
    "maybe_execute_compiled",
    "run_compiled",
    "reset_stats",
]

CACHE_CAPACITY = 32

_BIG = int(np.iinfo(np.int64).max // 4)
_IMAX = int(np.iinfo(np.int64).max)
_IMIN = int(np.iinfo(np.int64).min)


class Unsupported(Exception):
    """Plan construct the traced path cannot express; fall back to the
    op-by-op engine."""


class TraceGuardError(RuntimeError):
    """Traced code read a device value on the host, or asked for a shape
    that depends on the data: what a CUDA graph cannot capture (the
    counterpart of ``jax.errors.Tracer*Error``)."""


class CaptureError(RuntimeError):
    """Warm-up or capture of a traced plan failed: a fault of the port,
    never a fallback verdict."""


# ----------------------------------------------------------------------
# observability
# ----------------------------------------------------------------------
def _fresh_stats() -> Dict:
    return {
        "hits": 0,  # graph reused from the plan cache
        "misses": 0,  # fingerprint not cached -> trace+capture attempt
        "evictions": 0,  # LRU capacity evictions
        "compiles": 0,  # successful trace+capture
        "fallbacks": 0,  # unsupported plan -> op-by-op engine
        "compile_failures": 0,  # unexpected trace crashes (injected faults)
        "skipped_small": 0,  # auto mode: input under compiled_min_rows
        "plans": {},  # digest -> per-plan timing/shape record
    }


STATS = _fresh_stats()

_CACHE: "OrderedDict[str, _Entry]" = OrderedDict()
_NEGATIVE: Dict[str, str] = {}  # fingerprint -> unsupported reason

# _LOCK guards every shared structure here -- _CACHE / _NEGATIVE /
# STATS / _PREP -- while _TRACE_LOCKS holds one lock per in-flight
# fingerprint; _RUN_LOCK serializes everything that touches the padded
# base tables, the parameter buffers or the shared graph pool (trace,
# capture, replay and copy-out).
_LOCK = threading.RLock()
_TRACE_LOCKS: Dict[str, threading.Lock] = {}
_RUN_LOCK = threading.RLock()


def reset_stats() -> None:
    with _LOCK:
        STATS.clear()
        STATS.update(_fresh_stats())


def _stats_snapshot() -> Dict:
    with _LOCK:
        out = {k: v for k, v in STATS.items() if k != "plans"}
        out["plans"] = {d: dict(r) for d, r in STATS["plans"].items()}
    return out


obs.metrics.register_group("sql.compile", _stats_snapshot, reset_stats)


def clear_cache() -> None:
    with _LOCK:
        _CACHE.clear()
        _NEGATIVE.clear()
        _TRACE_LOCKS.clear()
    with _RUN_LOCK:
        _PADS.clear()


def _pow2(n: int) -> int:
    n = max(int(n), 1)
    return 1 << (n - 1).bit_length()


# ----------------------------------------------------------------------
# the trace guard (and the hoisting of host-to-device copies)
# ----------------------------------------------------------------------
_aten = torch.ops.aten
#: ops whose result is a host value read from the device
_HOST_READS = {
    _aten._local_scalar_dense.default,
    _aten.is_nonzero.default,
    _aten.equal.default,
}
#: ops whose output shape depends on the data (a host sync for its size)
_DATA_SHAPED = {
    _aten.nonzero.default,
    _aten.masked_select.default,
    _aten._unique2.default,
    _aten.unique_dim.default,
    _aten.unique_consecutive.default,
    _aten.bincount.default,
    _aten.repeat_interleave.Tensor,
}
#: Tensor methods that read values on the host without a dispatched op
#: on a CPU tensor; refused while a guard is active in this thread
_GUARDED_METHODS = ("tolist", "numpy", "cpu")
_GUARD_TLS = threading.local()
_PATCH_LOCK = threading.Lock()
_PATCH_DEPTH = 0
_ORIG_METHODS: Dict[str, object] = {}


def _guarded_method(name: str, orig):
    def method(self, *args, **kwargs):
        if getattr(_GUARD_TLS, "active", False):
            raise TraceGuardError(
                f"Tensor.{name}() in traced code reads a device value on the host"
            )
        return orig(self, *args, **kwargs)

    method.__name__ = name
    return method


def _install_method_guards() -> None:
    global _PATCH_DEPTH
    with _PATCH_LOCK:
        if _PATCH_DEPTH == 0:
            for name in _GUARDED_METHODS:
                orig = getattr(torch.Tensor, name)
                _ORIG_METHODS[name] = orig
                setattr(torch.Tensor, name, _guarded_method(name, orig))
        _PATCH_DEPTH += 1


def _remove_method_guards() -> None:
    global _PATCH_DEPTH
    with _PATCH_LOCK:
        _PATCH_DEPTH -= 1
        if _PATCH_DEPTH == 0:
            for name, orig in _ORIG_METHODS.items():
                setattr(torch.Tensor, name, orig)
            _ORIG_METHODS.clear()


def _const_key(t: torch.Tensor) -> Tuple:
    data = _ORIG_METHODS.get("numpy", torch.Tensor.numpy)(t.contiguous())
    return (str(t.dtype), tuple(t.shape), hashlib.sha1(data.tobytes()).hexdigest())


def _is_bool_index(x) -> bool:
    return isinstance(x, torch.Tensor) and x.dtype in (torch.bool, torch.uint8)


class _TraceGuard(TorchDispatchMode):
    """Dispatch mode of a traced run: refuses host reads and
    data-dependent shapes (``TraceGuardError``), and routes each
    host-to-device copy through ``consts`` -- recorded (``record``: the
    trace) or read back (warm-up and capture, where a copy from host
    memory cannot be captured)."""

    def __init__(self, consts: Optional[Dict], record: bool):
        super().__init__()
        self.consts = consts
        self.record = record

    def __enter__(self):
        self._was_active = getattr(_GUARD_TLS, "active", False)
        _install_method_guards()
        _GUARD_TLS.active = True
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _GUARD_TLS.active = self._was_active
            _remove_method_guards()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _HOST_READS:
            raise TraceGuardError(f"{func} in traced code reads a device value on the host")
        if func in _DATA_SHAPED:
            raise TraceGuardError(f"{func} in traced code has a data-dependent shape")
        if func in (_aten.index.Tensor, _aten.index_put.default, _aten.index_put_.default):
            if any(_is_bool_index(i) for i in args[1] if i is not None):
                raise TraceGuardError(
                    "boolean-mask indexing in traced code has a data-dependent shape"
                )
        if func is _aten._to_copy.default:
            src = args[0]
            dst = torch.device(kwargs.get("device") or src.device)
            if src.device.type == "cuda" and dst.type == "cpu":
                raise TraceGuardError("a device-to-host copy in traced code")
            if src.device.type == "cpu" and dst.type == "cuda" and self.consts is not None:
                return self._hoisted(src, lambda: func(*args, **kwargs))
        if func is _aten.copy_.default:
            dst, src = args[0], args[1]
            if src.device.type == "cuda" and dst.device.type == "cpu":
                raise TraceGuardError("a device-to-host copy in traced code")
            if src.device.type == "cpu" and dst.device.type == "cuda" and self.consts is not None:
                dev_src = self._hoisted(src, lambda: src.to(dst.device))
                return func(dst, dev_src, *args[2:], **kwargs)
        return func(*args, **kwargs)

    def _hoisted(self, src: torch.Tensor, make):
        key = _const_key(src)
        got = self.consts.get(key)
        if got is not None:
            return got
        if not self.record:
            raise CaptureError(
                f"a host-to-device copy ({src.dtype}, {tuple(src.shape)}) that the trace "
                "did not make"
            )
        got = make()
        self.consts[key] = got
        return got


# ----------------------------------------------------------------------
# literal parameterization
# ----------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SParam:
    """Placeholder for a numeric/date literal in a parameterized plan.

    The plan fingerprint is computed over the *parameterized* tree, so
    two runs of the same query shape with different literals share one
    captured graph; the literal values travel in its parameter buffers."""

    index: int
    kind: str  # 'int' | 'float' | 'date'

    def render(self) -> str:
        return f"?{self.index}:{self.kind}"


@dataclasses.dataclass(eq=False)
class _ParamLit(Expr):
    """Core expression broadcasting one parameter scalar (a 0-dim view
    of the entry's parameter buffer)."""

    scalar: object
    kind: str

    def eval(self, frame: TensorFrame) -> Value:
        n = frame.nrows
        if self.kind == "float":
            return Value("num", self.scalar.to(float_dtype()).expand(n).contiguous())
        arr = self.scalar.to(INT).expand(n).contiguous()
        return Value("date" if self.kind == "date" else "num", arr)


class _BoundParam:
    """SQL-AST-side wrapper binding an SParam to a parameter scalar;
    ``lower.to_expr`` dispatches on the ``to_core_expr`` hook."""

    __slots__ = ("scalar", "kind")

    def __init__(self, scalar, kind: str):
        self.scalar = scalar
        self.kind = kind

    def to_core_expr(self) -> Expr:
        return _ParamLit(self.scalar, self.kind)

    def render(self) -> str:
        return f"?bound:{self.kind}"


def _param_item(v, out):
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return _param_expr(v, out)
    if isinstance(v, tuple):
        return tuple(_param_item(x, out) for x in v)
    return v


def _param_expr(e, out: List[Tuple[str, object]]):
    """Replace numeric/date literals with SParam markers, collecting
    their values.  IN lists, LIKE patterns, and SUBSTRING bounds stay
    literal -- the engine needs them static (LUTs, slices)."""
    if isinstance(e, SLit):
        v = e.value
        if isinstance(v, bool) or not isinstance(
            v, (int, float, np.integer, np.floating)
        ):
            return e
        kind = "float" if isinstance(v, (float, np.floating)) else "int"
        out.append((kind, v))
        return SParam(len(out) - 1, kind)
    if isinstance(e, SDate):
        out.append(("date", int(e.days)))
        return SParam(len(out) - 1, "date")
    if isinstance(e, (SIn, SLike)) or (
        isinstance(e, SFunc) and e.name == "substring"
    ):
        return e
    if not dataclasses.is_dataclass(e):
        return e
    changes = {}
    for f in dataclasses.fields(e):
        v = getattr(e, f.name)
        nv = _param_item(v, out)
        if nv != v:
            changes[f.name] = nv
    return dataclasses.replace(e, **changes) if changes else e


def parameterize(node):
    """plan -> (plan with SParam markers, [(kind, value), ...]).

    Traversal order is deterministic, so re-running on a fresh plan of
    the same shape yields values aligned with the cached graph's
    parameter slots."""
    out: List[Tuple[str, object]] = []
    shared: Dict[Shared, Shared] = {}
    return _param_plan(node, out, shared), out


def _param_plan(node, out, shared):
    if isinstance(node, Scan):
        return node
    if isinstance(node, Shared):
        # equal copies must stay equal (and collect their literals
        # once), so parameterize the subtree a single time
        got = shared.get(node)
        if got is None:
            got = Shared(_param_plan(node.child, out, shared))
            shared[node] = got
        return got
    if isinstance(node, Filter):
        return Filter(
            _param_plan(node.child, out, shared), _param_expr(node.pred, out)
        )
    if isinstance(node, Project):
        return Project(
            _param_plan(node.child, out, shared),
            tuple((n, _param_expr(e, out)) for n, e in node.outputs),
        )
    if isinstance(node, Aggregate):
        return Aggregate(
            _param_plan(node.child, out, shared),
            tuple((n, _param_expr(e, out)) for n, e in node.keys),
            tuple(
                (n, fn, None if e is None else _param_expr(e, out))
                for n, fn, e in node.aggs
            ),
        )
    if isinstance(node, Join):
        return dataclasses.replace(
            node,
            left=_param_plan(node.left, out, shared),
            right=_param_plan(node.right, out, shared),
        )
    if isinstance(node, (Sort, Limit, Distinct)):
        return dataclasses.replace(
            node, child=_param_plan(node.child, out, shared)
        )
    if isinstance(node, AttachScalar):
        return dataclasses.replace(
            node,
            child=_param_plan(node.child, out, shared),
            sub=Boxed(_param_plan(node.sub.v, out, shared)),
        )
    raise Unsupported(f"plan node {type(node).__name__}")


# ----------------------------------------------------------------------
# base-table preparation (host side, cached per frame)
# ----------------------------------------------------------------------
class _PrepTable:
    __slots__ = ("frame", "cap", "combos", "bounds")

    def __init__(self, frame: TensorFrame):
        self.frame = frame
        self.cap = _pow2(frame.nrows)
        # tuple(sorted cols) -> bool uniqueness verdict (host-computed
        # once; part of the fingerprint since it drives join strategy)
        self.combos: Dict[Tuple[str, ...], bool] = {}
        # name -> (lo, hi) static value bounds for int/date columns,
        # span rounded up to a power of two so nearby datasets share a
        # fingerprint.  These are trace-time constants: they turn join
        # builds into direct addressing and group codes into dense
        # segment ids (dict/bool columns get bounds from their metadata
        # instead).  Part of the fingerprint -- they shape the program.
        self.bounds: Dict[str, Tuple[int, int]] = {}
        if frame.nrows:
            for name, m in frame.columns.items():
                if m.kind not in ("int", "date") or name.startswith(
                    _valid_name("")
                ):
                    continue
                lo, hi = frame.int_bounds(name)
                self.bounds[name] = (lo, lo + _pow2(hi - lo + 1) - 1)


_PREP: "weakref.WeakKeyDictionary[TensorFrame, _PrepTable]" = (
    weakref.WeakKeyDictionary()
)


def _prep_table(src: TensorFrame) -> _PrepTable:
    with _LOCK:
        return _prep_table_locked(src)


def _prep_table_locked(src: TensorFrame) -> _PrepTable:
    got = _PREP.get(src)
    if got is not None:
        return got
    f = src.materialize()
    # a new frame over the same tensors: a cached value that held ``src``
    # itself would keep its weak key alive, and the frame with it
    f = TensorFrame(f.itensor, f.ftensor, dict(f.columns), dict(f.offloaded), f.nrows)
    src._inherit_stats(f, "columns")
    for name in list(f.offloaded):
        # offloaded strings become dictionary-code int columns so the
        # traced program never touches host arrays; codes/dictionary
        # are cached on the physical column, so this is cheap to redo
        codes, dictionary = f.offloaded[name].codes()
        f = f._append_int_column(name, codes, "dict", dictionary)
    f.materialize()
    got = _PrepTable(f)
    _PREP[src] = got
    return got


def _ensure_unique(prep: _PrepTable, cols: Tuple[str, ...]) -> bool:
    with _LOCK:
        return _ensure_unique_locked(prep, cols)


def _ensure_unique_locked(prep: _PrepTable, cols: Tuple[str, ...]) -> bool:
    key = tuple(sorted(cols))
    if key in prep.combos:
        return prep.combos[key]
    f = prep.frame
    ok = all(
        c in f.columns
        and f.columns[c].kind not in ("float", "obj")
        and _valid_name(c) not in f.columns
        for c in key
    )
    verdict = False
    if ok:
        hint = f.unique_hint(list(key))
        if hint is None:
            if f.nrows == 0:
                hint = True
            else:
                arrs = [host(f.col_values(c)) for c in key]
                if len(arrs) == 1:
                    hint = int(np.unique(arrs[0]).size) == f.nrows
                else:
                    hint = (
                        np.unique(np.stack(arrs, axis=1), axis=0).shape[0]
                        == f.nrows
                    )
            f.set_stats(list(key), unique=bool(hint))
        verdict = bool(hint)
    prep.combos[key] = verdict
    return verdict


def _plan_combos(prep: _PrepTable, requested) -> Dict[Tuple[str, ...], bool]:
    """The uniqueness verdicts a plan asked of one table: the ones its
    traced program reads (``_c_scan``) and its fingerprint holds.  Not
    every verdict the table has collected: those depend on which plans
    ran before, and would change the fingerprint of a plan that has not
    changed."""
    with _LOCK:
        return {k: prep.combos[k] for k in sorted(tuple(sorted(c)) for c in requested)}


def _table_sig(name: str, prep: _PrepTable, combos) -> str:
    f = prep.frame
    cols = ",".join(
        f"{n}:{m.kind}:{m.slot}:"
        f"{0 if m.dictionary is None else id(m.dictionary)}"
        for n, m in f.columns.items()
    )
    combos = ";".join(
        f"{'+'.join(k)}={int(v)}" for k, v in sorted(combos.items())
    )
    bounds = ";".join(
        f"{n}={lo}:{hi}" for n, (lo, hi) in sorted(prep.bounds.items())
    )
    return (
        f"{name}[cap={prep.cap},iw={f.itensor.shape[1]},"
        f"fw={f.ftensor.shape[1]},dev={f.device}]({cols})u({combos})b({bounds})"
    )


# ----------------------------------------------------------------------
# uniqueness requests: which base-column combos drive join strategy
# ----------------------------------------------------------------------
def _base_cols(node, names: List[str]):
    """Map qualified column names through rename-only chains back to
    one Scan's (table, base columns); None when not resolvable."""
    if isinstance(node, Scan):
        strip = node.alias + "."
        out = []
        for n in names:
            if not n.startswith(strip):
                return None
            out.append(n[len(strip):])
        return node.table, tuple(out)
    if isinstance(node, (Filter, Sort, Limit, Distinct, Shared)):
        return _base_cols(node.child, names)
    if isinstance(node, AttachScalar):
        if node.name in names:
            return None
        return _base_cols(node.child, names)
    if isinstance(node, Project):
        m = {n: e for n, e in node.outputs}
        mapped = []
        for n in names:
            e = m.get(n)
            if not isinstance(e, SCol):
                return None
            mapped.append(e.internal)
        return _base_cols(node.child, mapped)
    if isinstance(node, Join):
        want = set(names)
        if want <= node_columns(node.left):
            return _base_cols(node.left, names)
        if node.how not in ("semi", "anti") and want <= node_columns(
            node.right
        ):
            return _base_cols(node.right, names)
        return None
    return None


def _collect_unique_requests(node, reqs: Dict[str, set]):
    if isinstance(node, Join):
        if node.how in ("inner", "left"):
            for side, keys in (
                (node.left, node.left_keys),
                (node.right, node.right_keys),
            ):
                got = _base_cols(side, list(keys))
                if got is not None:
                    reqs.setdefault(got[0], set()).add(got[1])
        _collect_unique_requests(node.left, reqs)
        _collect_unique_requests(node.right, reqs)
        return
    if isinstance(node, AttachScalar):
        _collect_unique_requests(node.child, reqs)
        _collect_unique_requests(node.sub.v, reqs)
        return
    child = getattr(node, "child", None)
    if child is not None:
        _collect_unique_requests(child, reqs)


# ----------------------------------------------------------------------
# traced relations
# ----------------------------------------------------------------------
class CTable:
    """Fixed-capacity traced relation: an eager in-trace TensorFrame
    whose first ``n`` rows (a device count) are live, in original order.

    ``unique`` holds column combos known unique over the live rows;
    ``bounds`` holds *static* per-column (lo, hi) value bounds seeded
    from host-computed base-table stats -- they make key spans known at
    trace time, which turns sort-based joins into direct addressing
    and multi-key group codes into single packed integers."""

    __slots__ = ("frame", "n", "unique", "bounds", "mask", "fdeps", "dbound")

    def __init__(
        self, frame: TensorFrame, n, unique=(), bounds=None, mask=None,
        fdeps=None, dbound=None,
    ):
        self.frame = frame
        self.n = n  # device live-row count (== sum(mask) when masked)
        self.unique = set(unique)
        self.bounds = dict(bounds or {})
        # None: rows [0, n) are live (contiguous).  Otherwise a device
        # bool mask: live rows sit at their original positions and the
        # compaction (a scan + scatter and a full-width gather) is
        # deferred until an operator truly needs contiguity (sort /
        # limit / final output)
        self.mask = mask
        # functional dependencies: column -> the probe-key columns that
        # determine it (a unique-build join makes every build column a
        # function of the probe keys).  GROUP BY / DISTINCT drop
        # determined columns from their packed code, which is what lets
        # e.g. q3's 3-key grouping collapse to one bounded key
        self.fdeps: Dict[str, frozenset] = dict(fdeps or {})
        # static upper bound on the column's distinct live values (only
        # where tighter than cap): an inner probe against a unique build
        # side bounds the surviving probe keys by the build capacity.
        # GROUP BY shrinks its output capacity to the product of its
        # keys' bounds -- which shrinks every operator downstream
        self.dbound: Dict[str, int] = dict(dbound or {})

    @property
    def cap(self) -> int:
        return self.frame.nrows

    @property
    def device(self) -> torch.device:
        return self.frame.device

    @property
    def row_valid(self):
        if self.mask is not None:
            return self.mask
        return _arange(self.cap, self.device) < self.n


def _arange(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=INT, device=device)


def _nonzero_static(mask: torch.Tensor) -> torch.Tensor:
    """Positions of the True entries of ``mask``, in order, padded with 0
    to ``mask``'s length (``jnp.nonzero(mask, size=len, fill_value=0)``)
    without reading the count on the host: each live row scatters its
    index to its rank; the dead rows' slot is dropped."""
    cap = mask.shape[0]
    slot = torch.where(mask, torch.cumsum(mask.to(INT), 0) - 1, cap)
    idx = torch.zeros((cap + 1,), dtype=INT, device=mask.device)
    idx.scatter_(0, slot, _arange(cap, mask.device))
    return idx[:cap]


def _compact(ct: CTable) -> CTable:
    """Gather the live rows into [0, n) (no-op when already there)."""
    if ct.mask is None:
        return ct
    return _gather_rows(ct, _nonzero_static(ct.mask), ct.n)


def _is_unique(ct: CTable, keys) -> bool:
    ks = set(keys)
    return any(u <= ks for u in ct.unique)


def _gather_rows(ct: CTable, idx, n, unique=None) -> CTable:
    f = ct.frame
    out = TensorFrame(
        f.itensor[idx], f.ftensor[idx], dict(f.columns), {}, int(idx.shape[0])
    )
    # row subsets keep value bounds (padding rows are masked everywhere)
    return CTable(
        out, n, ct.unique if unique is None else unique, ct.bounds,
        fdeps=ct.fdeps, dbound=ct.dbound,
    )


def _effective_keys(ct: CTable, names) -> List[str]:
    """Drop grouping columns functionally determined by other kept
    grouping columns -- equality of the determinants already implies
    equality of the determined values row-to-row."""
    kept = set(names)
    out: List[str] = []
    for k in names:
        dep = ct.fdeps.get(k)
        if dep and dep <= (kept - {k}):
            kept.discard(k)
            continue
        out.append(k)
    return out or list(names)[:1]


def _masked_min(v, ok):
    return torch.where(ok, v, _BIG).min()


def _masked_max(v, ok):
    return torch.where(ok, v, -_BIG).max()


def _rank(v, n: int):
    """Equality- and order-preserving codes in ``[0, n]``: each value's
    first position in its own sorted order (one sort and one binary
    search instead of a multi-key sort)."""
    v = v.contiguous()
    return torch.searchsorted(torch.sort(v).values, v)


def _expr_bounds(ct: CTable, e) -> Optional[Tuple[int, int]]:
    """Sound static (lo, hi) value bounds for an integer-valued scalar
    plan expression, or None.  Interval arithmetic over column bounds
    lets *computed* group / sort keys (q7-q9's EXTRACT(YEAR ...), price
    buckets, ...) keep trace-time spans, so they pack densely instead
    of forcing the rank path and a full-capacity aggregate output."""
    if isinstance(e, SCol):
        m = ct.frame.meta(e.internal) if ct.frame.has_column(e.internal) else None
        if m is not None and m.kind == "bool":
            return 0, 1
        return ct.bounds.get(e.internal)
    if isinstance(e, SLit):
        if isinstance(e.value, bool):
            return int(e.value), int(e.value)
        if isinstance(e.value, int):
            return e.value, e.value
        return None
    if isinstance(e, SDate):
        return e.days, e.days
    if isinstance(e, SExtract):
        if e.field == "month":
            return 1, 12
        if e.field == "day":
            return 1, 31
        b = _expr_bounds(ct, e.e)
        if b is None:
            return None

        # calendar year is monotone in epoch days
        def _year(days: int) -> int:
            return int(
                np.datetime64(int(days), "D").astype("datetime64[Y]").astype(int)
            ) + 1970

        return _year(b[0]), _year(b[1])
    if isinstance(e, SBin) and e.op in ("+", "-", "*"):
        a = _expr_bounds(ct, e.a)
        b = _expr_bounds(ct, e.b)
        if a is None or b is None:
            return None
        if e.op == "+":
            lo, hi = a[0] + b[0], a[1] + b[1]
        elif e.op == "-":
            lo, hi = a[0] - b[1], a[1] - b[0]
        else:
            cands = [a[0] * b[0], a[0] * b[1], a[1] * b[0], a[1] * b[1]]
            lo, hi = min(cands), max(cands)
        if abs(lo) > 1 << 62 or abs(hi) > 1 << 62:
            return None  # the real computation could overflow int64
        return lo, hi
    return None


def _static_span(ct: CTable, name: str) -> Optional[Tuple[int, int]]:
    """(lo, span) known at trace time, or None.  Dict codes span the
    dictionary, bools span {0,1}, int/date columns use the bucketed
    base-table bounds propagated through row-preserving operators."""
    m = ct.frame.meta(name)
    if m.kind == "dict" and m.dictionary is not None:
        return 0, max(int(m.dictionary.shape[0]), 1)
    if m.kind == "bool":
        return 0, 2
    b = ct.bounds.get(name)
    if b is not None:
        return b[0], max(b[1] - b[0] + 1, 1)
    return None


# packed composite codes must stay well inside int64 (and strictly
# below the _BIG padding sentinel)
_PACK_LIMIT = 1 << 59
# largest direct-address table a join build will scatter into
_DENSE_JOIN_LIMIT = 1 << 22
# largest dense group-id space (sort-free group-by)
_DENSE_GROUP_LIMIT = 1 << 20


# ----------------------------------------------------------------------
# traced operators
# ----------------------------------------------------------------------
def _c_filter(node: Filter, ct: CTable, ctx) -> CTable:
    expr = to_expr(ctx.bind(node.pred))
    mask = expr.eval_bool(ct.frame) & ct.row_valid
    # no compaction: rows keep their positions under a narrowed mask
    return CTable(
        ct.frame, mask.sum(dtype=INT), ct.unique, ct.bounds, mask,
        ct.fdeps, ct.dbound,
    )


def _int_key(ct: CTable, name: str):
    m = ct.frame.meta(name)
    if m.kind in ("float", "obj"):
        raise Unsupported(f"non-integer join key {name} (kind={m.kind})")
    v = ct.frame.col_values(name)
    val = ct.frame.valid_array(name)
    ok = ct.row_valid if val is None else (ct.row_valid & val)
    return v, ok


def _clip(x, hi):
    """``clip(x, 0, hi)`` with a static or device upper bound."""
    if isinstance(hi, torch.Tensor):
        return torch.minimum(torch.clamp(x, min=0), hi)
    return torch.clamp(x, 0, hi)


def _joint_codes(lct: CTable, lkeys, rct: CTable, rkeys):
    """Composite key codes comparable across sides, plus a *static*
    bound ``S`` on the code space when every key has trace-time bounds
    (dict keys re-coded onto a merged dictionary when the two sides'
    dictionaries differ).  ``S`` is None when any key needed device
    bounds; a static ``S`` small enough lets the join direct-address."""
    dev = lct.device
    lcode = torch.zeros((lct.cap,), dtype=INT, device=dev)
    rcode = torch.zeros((rct.cap,), dtype=INT, device=dev)
    lok = lct.row_valid
    rok = rct.row_valid
    S: Optional[int] = 1
    for i, (lk, rk) in enumerate(zip(lkeys, rkeys)):
        lv, lo_ok = _int_key(lct, lk)
        rv, ro_ok = _int_key(rct, rk)
        lok = lok & lo_ok
        rok = rok & ro_ok
        lm, rm = lct.frame.meta(lk), rct.frame.meta(rk)
        if (lm.kind == "dict") != (rm.kind == "dict"):
            raise Unsupported(f"join key {lk}={rk} mixes dict and non-dict")
        lo = span = None
        if lm.kind == "dict" and lm.dictionary is not rm.dictionary:
            merged = np.union1d(
                lm.dictionary.astype("U"), rm.dictionary.astype("U")
            )
            llut = torch.as_tensor(
                np.searchsorted(merged, lm.dictionary.astype("U")), dtype=INT, device=dev
            )
            rlut = torch.as_tensor(
                np.searchsorted(merged, rm.dictionary.astype("U")), dtype=INT, device=dev
            )
            lv = llut[torch.clamp(lv, 0, max(lm.dictionary.shape[0] - 1, 0))]
            rv = rlut[torch.clamp(rv, 0, max(rm.dictionary.shape[0] - 1, 0))]
            lo, span = 0, max(int(merged.shape[0]), 1)
        else:
            ls = _static_span(lct, lk)
            rs = _static_span(rct, rk)
            if ls is not None and rs is not None:
                lo = min(ls[0], rs[0])
                span = max(ls[0] + ls[1], rs[0] + rs[1]) - lo
        if i and (S is None or (span is not None and S * span > _PACK_LIMIT)):
            # packing could overflow int64 (previous key had only
            # device bounds, or the static product got too wide):
            # rank-compress the running codes *jointly* so both sides
            # stay comparable.  Rank output is statically bounded by
            # the total capacity, so S recovers a static value.
            cat = torch.cat([lcode, rcode])
            rr = _rank(cat, lct.cap + rct.cap)
            lcode, rcode = rr[: lct.cap], rr[lct.cap:]
            S = lct.cap + rct.cap + 1
        if span is None:
            tlo = torch.minimum(_masked_min(lv, lok), _masked_min(rv, rok))
            thi = torch.maximum(_masked_max(lv, lok), _masked_max(rv, rok))
            tspan = torch.clamp(thi - tlo + 1, min=1)
            lcode = lcode * tspan + _clip(lv - tlo, tspan - 1)
            rcode = rcode * tspan + _clip(rv - tlo, tspan - 1)
            S = None
        else:
            lcode = lcode * span + _clip(lv - lo, span - 1)
            rcode = rcode * span + _clip(rv - lo, span - 1)
            S = None if S is None else S * span
    return lcode, lok, rcode, rok, S


def _dense_lookup(code, ok, cap: int, S: int):
    """Direct-address table: slot ``c`` holds a row whose key code is
    ``c``, or -1.  Exact -- no post-probe code comparison."""
    tbl = torch.full((S + 1,), -1, dtype=INT, device=code.device)
    tbl.scatter_(0, torch.where(ok, code, S), _arange(cap, code.device))
    return tbl[:S]


def _stack_sides(lf: TensorFrame, l_idx, rf: TensorFrame, r_idx, cap: int):
    """Horizontal stack of gathered left and right payloads (left
    columns first, like the engine's join output).  A ``None`` index
    keeps that side's rows in place -- no gather at all."""
    if set(lf.columns) & set(rf.columns):
        raise Unsupported("join sides share column names")
    lit_ = lf.itensor if l_idx is None else lf.itensor[l_idx]
    lft_ = lf.ftensor if l_idx is None else lf.ftensor[l_idx]
    rit_ = rf.itensor if r_idx is None else rf.itensor[r_idx]
    rft_ = rf.ftensor if r_idx is None else rf.ftensor[r_idx]
    it = torch.cat([lit_, rit_], dim=1)
    ft = torch.cat([lft_, rft_], dim=1)
    iw, fw = lf.itensor.shape[1], lf.ftensor.shape[1]
    cols: Dict[str, ColumnMeta] = {}
    for name, m in lf.columns.items():
        cols[name] = dataclasses.replace(m)
    for name, m in rf.columns.items():
        off = fw if m.kind == "float" else iw
        cols[name] = dataclasses.replace(m, slot=m.slot + off)
    return TensorFrame(it, ft, cols, {}, cap)


def _probe_build(build: CTable, bcode, bok, pcode, pok, S):
    """(matched, brow): for each probe row, whether a build row with an
    equal key exists and (any) one such row's index.  Direct addressing
    when the static code space fits; else sort + binary search."""
    if S is not None and S <= _DENSE_JOIN_LIMIT:
        tbl = _dense_lookup(bcode, bok, build.cap, S)
        brow = tbl[torch.clamp(pcode, 0, S - 1)]
        matched = (brow >= 0) & pok
        return matched, torch.clamp(brow, 0, build.cap - 1)
    key = torch.where(bok, bcode, _BIG)
    s = torch.sort(key).values
    pos = torch.searchsorted(s, pcode)
    posc = torch.clamp(pos, 0, build.cap - 1)
    matched = (pos < build.cap) & (s[posc] == pcode) & pok
    # recover the row index behind sorted slot ``posc``: rank the same
    # codes against the sort and scatter the row ids (live build codes
    # are unique, so ranks are collision-free where it matters)
    rank = torch.searchsorted(s, key)
    perm = torch.zeros((build.cap,), dtype=INT, device=key.device)
    perm.scatter_(0, rank, _arange(build.cap, key.device))
    return matched, perm[posc]


def _c_join(node: Join, lct: CTable, rct: CTable) -> CTable:
    lcode, lok, rcode, rok, S = _joint_codes(
        lct, node.left_keys, rct, node.right_keys
    )
    if node.how in ("semi", "anti"):
        # membership only
        if S is not None and S <= _DENSE_JOIN_LIMIT:
            tbl = _dense_lookup(rcode, rok, rct.cap, S)
            present = (tbl[torch.clamp(lcode, 0, S - 1)] >= 0) & lok
        else:
            s = torch.sort(torch.where(rok, rcode, _BIG)).values
            pos = torch.searchsorted(s, lcode)
            posc = torch.clamp(pos, 0, rct.cap - 1)
            present = (pos < rct.cap) & (s[posc] == lcode) & lok
        keep = present if node.how == "semi" else (lct.row_valid & ~present)
        return CTable(
            lct.frame, keep.sum(dtype=INT), lct.unique, lct.bounds,
            keep, lct.fdeps, lct.dbound,
        )
    if node.how not in ("inner", "left"):
        raise Unsupported(f"join type {node.how}")

    right_build = _is_unique(rct, node.right_keys)
    if node.how == "left":
        if not right_build:
            if _is_unique(lct, node.left_keys):
                # one-to-many: expand matches instead of probing
                return _c_left_expand(
                    node, lct, lcode, lok, rct, rcode, rok, S
                )
            raise Unsupported("left join with no provably-unique side")
    elif not right_build and not _is_unique(lct, node.left_keys):
        raise Unsupported("inner join with no provably-unique side")
    if right_build:
        build, probe = rct, lct
        bcode, bok, pcode, pok = rcode, rok, lcode, lok
        pkeys = node.left_keys
    else:  # swapped: build on the unique left side, probe the right
        build, probe = lct, rct
        bcode, bok, pcode, pok = lcode, lok, rcode, rok
        pkeys = node.right_keys

    matched, brow = _probe_build(build, bcode, bok, pcode, pok, S)

    unique = set(probe.unique)
    if _is_unique(probe, pkeys):
        unique |= build.unique
    bounds = {**lct.bounds, **rct.bounds}
    # rows agreeing on the probe keys read the same (unique) build row,
    # so every build column is now a function of the probe keys
    fdeps = {**lct.fdeps, **rct.fdeps}
    dep = frozenset(pkeys)
    dbound = {**lct.dbound, **rct.dbound}
    for cname in build.frame.columns:
        fdeps[cname] = dep
        # build payloads are gathered from <= build.cap rows
        dbound[cname] = min(dbound.get(cname, build.cap), build.cap)

    if node.how == "inner":
        # surviving probe keys are a subset of the build side's live
        # key tuples, of which there are at most build.cap
        for pk in pkeys:
            dbound[pk] = min(dbound.get(pk, probe.cap), build.cap)
        # probe rows stay in place (the match flag becomes the mask);
        # only the build side pays a gather
        n_out = matched.sum(dtype=INT)
        if right_build:
            out = _stack_sides(probe.frame, None, build.frame, brow, probe.cap)
        else:
            out = _stack_sides(build.frame, brow, probe.frame, None, probe.cap)
        return CTable(out, n_out, unique, bounds, matched, fdeps, dbound)

    # left join: keep every probe (=left) row; unmatched rows take
    # clamped build payloads masked off by fresh validity columns
    out = _stack_sides(probe.frame, None, build.frame, brow, probe.cap)
    out = _mask_right(out, build.frame, matched)
    return CTable(out, probe.n, unique, bounds, probe.mask, fdeps, dbound)


def _mask_right(out: TensorFrame, rf: TensorFrame, matched) -> TensorFrame:
    """Append/merge validity for every right-side output column so
    unmatched left rows read as NULL (mirrors the engine's left-outer
    ``need_valid`` append)."""
    for name in list(rf.columns):
        if name.startswith(_valid_name("")):
            continue
        vn = _valid_name(name)
        if vn in out.columns:
            flag = (out.col_values(vn) != 0) & matched
        else:
            flag = matched
        out = out._append_int_column(vn, flag.to(INT), "bool")
    return out


def _c_left_expand(node, lct, lcode, lok, rct, rcode, rok, S) -> CTable:
    """One-to-many left join with a provably-unique LEFT side: each
    right row finds its single left owner, producing the matched pairs;
    left rows no right row claimed are appended with NULL right
    payloads.  Output capacity = cap_right + cap_left."""
    dev = lct.device
    matched_r, lrow_r = _probe_build(lct, lcode, lok, rcode, rok, S)

    # matched pairs, compacted over the right capacity
    idx_r = _nonzero_static(matched_r)
    n1 = matched_r.sum(dtype=INT)
    # left rows never claimed (null-key left rows stay too: engine left
    # joins keep them with NULL right payloads)
    hit = torch.zeros((lct.cap,), dtype=INT, device=dev).scatter_reduce_(
        0, lrow_r, matched_r.to(INT), "amax", include_self=True
    )
    keep_l = lct.row_valid & (hit == 0)
    idx_l = _nonzero_static(keep_l)
    n2 = keep_l.sum(dtype=INT)

    live = torch.cat([_arange(rct.cap, dev) < n1, _arange(lct.cap, dev) < n2])
    # compact both parts into contiguous [0, n1+n2)
    sel = _nonzero_static(live)
    l_all = torch.cat([lrow_r[idx_r], idx_l])[sel]
    r_all = torch.cat([idx_r, torch.zeros((lct.cap,), dtype=INT, device=dev)])[sel]
    matched_all = torch.cat(
        [
            torch.ones((rct.cap,), dtype=torch.bool, device=dev),
            torch.zeros((lct.cap,), dtype=torch.bool, device=dev),
        ]
    )[sel]
    out = _stack_sides(lct.frame, l_all, rct.frame, r_all, rct.cap + lct.cap)
    out = _mask_right(out, rct.frame, matched_all)
    return CTable(
        out, n1 + n2, set(), {**lct.bounds, **rct.bounds},
        dbound={**lct.dbound, **rct.dbound},
    )


def _check_group_cols(f: TensorFrame, names) -> None:
    for k in names:
        if f.valid_array(k) is not None:
            raise Unsupported(f"nullable group key {k}")
        if f.meta(k).kind == "obj":
            raise Unsupported(f"group key {k} is offloaded")


def _pack_group_code(ct: CTable, f: TensorFrame, names) -> Tuple:
    """(code, S): one int64 composite code per row whose equality
    matches tuple-equality of the named columns, and a static bound on
    the code space.  Keys with trace-time spans pack directly; float or
    unbounded keys are rank-compressed first (rank preserves equality),
    so S always stays static."""
    _check_group_cols(f, names)
    cap = ct.cap
    code = torch.zeros((cap,), dtype=INT, device=ct.device)
    S = 1
    for k in names:
        m = f.meta(k)
        v = f.col_values(k)
        sp = None if m.kind == "float" else _static_span(ct, k)
        if sp is None:
            if m.kind == "float":
                # collapse -0.0 onto +0.0 so equal keys share a rank
                v = torch.where(v == 0, torch.zeros((), dtype=v.dtype, device=v.device), v)
            v = _rank(v, cap)
            span = cap + 1
        else:
            lo, span = sp
            v = torch.clamp(v - lo, 0, span - 1)
        if S * span > _PACK_LIMIT:
            # re-rank the running code (injective on present values)
            code = _rank(code, cap)
            S = cap + 1
        code = code * span + v
        S = S * span
    return code, S


def _dbound_product(ct: CTable, names) -> int:
    """Static upper bound on the number of distinct live key tuples:
    the product of the per-key distinct bounds, saturating at cap."""
    db = 1
    for k in names:
        db *= ct.dbound.get(k, ct.cap)
        if db >= ct.cap:
            return ct.cap
    return db


def _group_ids(code, S: int, rv, cap: int, dmax: Optional[int] = None):
    """(gids, n_groups, cap_out): dense group ids in code order for live
    rows; padding maps to ``cap_out`` so segment scatters drop it.  A
    small static code space counts occupancy directly (no sort at all);
    otherwise sort the codes once and rank against the distinct values.
    ``dmax`` (a sound static bound on the distinct key count) shrinks
    the output capacity below the code space -- the whole plan
    downstream of the aggregate narrows with it."""
    cap_out = min(cap, _pow2(S))
    if dmax is not None:
        cap_out = min(cap_out, _pow2(max(dmax, 1)))
    dev = code.device
    if S <= _DENSE_GROUP_LIMIT:
        ids = torch.where(rv, code, S)
        cnt = _seg_sum(torch.ones((cap,), dtype=INT, device=dev), ids, S)
        present = cnt > 0
        dense = torch.cumsum(present.to(INT), 0) - 1
        n_groups = present.sum(dtype=INT)
        gids = torch.where(rv, dense[torch.clamp(code, 0, S - 1)], cap_out)
        return gids, n_groups, cap_out
    scode = torch.where(rv, code, _BIG)
    s = torch.sort(scode).values
    live = s < _BIG
    first = torch.cat([live[:1], (s[1:] != s[:-1]) & live[1:]])
    n_groups = first.sum(dtype=INT)
    # dense id per sorted slot; a live row reads it back through the
    # first-occurrence slot of its own code
    did = torch.cumsum(first.to(INT), 0) - 1
    gids = torch.where(rv, did[torch.searchsorted(s, scode)], cap_out)
    return gids, n_groups, cap_out


def _seg_sum(vals, gids, m: int):
    """Per-segment sums (K1 on the card); ids outside [0, m) drop."""
    return ops.segment_sum(vals.contiguous(), gids.contiguous(), m)


def _seg_extreme(vals, gids, m: int, how: str):
    """``jax.ops.segment_min``/``segment_max``: empty segments read the
    identity (+-inf for floats, the int64 extremes for ints); ids
    outside [0, m) drop."""
    if vals.is_floating_point():
        ident = float("inf") if how == "amin" else float("-inf")
    else:
        ident = _IMAX if how == "amin" else _IMIN
    out = torch.full((m + 1,), ident, dtype=vals.dtype, device=vals.device)
    idx = torch.where((gids >= 0) & (gids < m), gids, m)
    out.scatter_reduce_(0, idx, vals, how, include_self=True)
    return out[:m]


def _c_aggregate(node: Aggregate, ct: CTable, ctx) -> CTable:
    f = ct.frame
    dev = ct.device
    key_names: List[str] = []
    kbounds = dict(ct.bounds)
    for name, e in node.keys:
        if not (
            isinstance(e, SCol) and e.internal == name and f.has_column(name)
        ):
            f = f.with_column(name, to_expr(ctx.bind(e)))
            kb = _expr_bounds(ct, e)
            if kb is not None:
                kbounds[name] = kb
        key_names.append(name)
    specs: List[Tuple[str, str, Optional[str]]] = []
    for name, fn, e in node.aggs:
        if fn == "size":
            specs.append((name, fn, None))
            continue
        if isinstance(e, SCol) and f.has_column(e.internal):
            specs.append((name, fn, e.internal))
        else:
            cn = f"__in.{name}"
            f = f.with_column(cn, to_expr(ctx.bind(e)))
            specs.append((name, fn, cn))
    ct = CTable(f, ct.n, ct.unique, kbounds, ct.mask, ct.fdeps, ct.dbound)
    cap, rv = ct.cap, ct.row_valid
    fd = float_dtype()

    if key_names:
        _check_group_cols(f, key_names)
        eff = _effective_keys(ct, key_names)
        code, S = _pack_group_code(ct, f, eff)
        gids, n_groups, cap_out = _group_ids(
            code, S, rv, cap, _dbound_product(ct, eff)
        )
        rep = _seg_extreme(
            torch.where(rv, _arange(cap, dev), _BIG), gids, cap_out, "amin"
        )
        repc = torch.clamp(rep, 0, cap - 1)
    else:
        cap_out = 1
        n_groups = torch.ones((), dtype=INT, device=dev)
        gids = torch.where(rv, 0, 1)
        repc = None

    icols: List = []
    fcols: List = []
    cols: Dict[str, ColumnMeta] = {}

    def add(name: str, kind: str, arr, dictionary=None):
        if kind == "float":
            cols[name] = ColumnMeta(name, "float", len(fcols))
            fcols.append(arr.to(fd))
        else:
            cols[name] = ColumnMeta(name, kind, len(icols), dictionary)
            icols.append(arr.to(INT))

    for k in key_names:
        m = f.meta(k)
        add(k, m.kind, f.col_values(k)[repc], m.dictionary)

    for name, fn, cn in specs:
        if fn == "size":
            add(name, "int", _seg_sum(rv.to(INT), gids, cap_out))
            continue
        m = f.meta(cn)
        if m.kind == "obj":
            raise Unsupported(f"aggregate over offloaded column {cn}")
        v = f.col_values(cn)
        val = f.valid_array(cn)
        ok = rv if val is None else (rv & val)
        isf = m.kind == "float"
        if fn == "count":
            add(name, "int", _seg_sum(ok.to(INT), gids, cap_out))
        elif fn == "sum":
            zero = torch.zeros((), dtype=v.dtype, device=dev)
            arr = _seg_sum(torch.where(ok, v, zero), gids, cap_out)
            add(name, "float" if isf else "int", arr)
        elif fn == "mean":
            s_ = _seg_sum(torch.where(ok, v, 0).to(fd), gids, cap_out)
            c_ = _seg_sum(ok.to(INT), gids, cap_out)
            # engine formula (agg.segment_agg): sum / max(count, 1)
            add(name, "float", s_ / torch.clamp(c_, min=1).to(fd))
        elif fn in ("min", "max"):
            if fn == "min":
                sent = float("inf") if isf else _BIG
                arr = _seg_extreme(torch.where(ok, v, sent), gids, cap_out, "amin")
            else:
                sent = float("-inf") if isf else -_BIG
                arr = _seg_extreme(torch.where(ok, v, sent), gids, cap_out, "amax")
            add(name, m.kind, arr, m.dictionary)
        elif fn == "nunique":
            if isf:
                raise Unsupported("nunique over float column")
            add(name, "int", _seg_nunique(v, ok, gids, cap_out, cap))
        else:
            raise Unsupported(f"aggregate fn {fn}")

    it = torch.stack(icols, dim=1) if icols else _empty_tensor(cap_out, INT, dev)
    ft = torch.stack(fcols, dim=1) if fcols else _empty_tensor(cap_out, fd, dev)
    out = TensorFrame(it, ft, cols, {}, cap_out)
    unique = {frozenset(key_names)} if key_names else set()
    bounds = {k: ct.bounds[k] for k in key_names if k in ct.bounds}
    dbound = {k: ct.dbound[k] for k in key_names if k in ct.dbound}
    for name, fn, cn in specs:
        if fn in ("min", "max") and cn in ct.bounds:
            bounds[name] = ct.bounds[cn]  # output values c input values
    return CTable(out, n_groups, unique, bounds, dbound=dbound)


def _seg_nunique(v, ok, gids, cap_out: int, cap: int):
    """COUNT(DISTINCT col) per group: pack (gid, rank(value)) into one
    code, sort it once, count first occurrences per gid -- the traced
    twin of agg's distinct count, minus the host sync and the multi-key
    sort."""
    M = 2 * cap  # rank(v) <= cap < M, so the packing is collision-free
    pair = gids * M + _rank(v, cap)
    s = torch.sort(torch.where(ok, pair, _BIG)).values
    live = s < _BIG
    first = torch.cat([live[:1], (s[1:] != s[:-1]) & live[1:]])
    seg = torch.where(live, torch.div(s, M, rounding_mode="floor"), cap_out)
    return _seg_sum(first.to(INT), seg, cap_out)


def _c_project(node: Project, ct: CTable, ctx) -> CTable:
    f = ct.frame
    srcs: List[str] = []
    mapping: Dict[str, str] = {}
    used = set()
    ebounds: Dict[str, Tuple[int, int]] = {}
    for i, (name, e) in enumerate(node.outputs):
        if (
            isinstance(e, SCol)
            and f.has_column(e.internal)
            and e.internal not in used
        ):
            src = e.internal
        else:
            src = f"__o.{i}.{name}"
            f = f.with_column(src, to_expr(ctx.bind(e)))
            eb = _expr_bounds(ct, e)
            if eb is not None:
                ebounds[name] = eb
        used.add(src)
        srcs.append(src)
        mapping[src] = name
    out = f.select(srcs).rename(mapping)
    unique = set()
    for combo in ct.unique:
        if all(c in mapping for c in combo):
            unique.add(frozenset(mapping[c] for c in combo))
    bounds = {
        name: ct.bounds[src]
        for src, name in mapping.items()
        if src in ct.bounds
    }
    bounds.update(ebounds)
    fdeps = {}
    for src, name in mapping.items():
        dep = ct.fdeps.get(src)
        if dep is not None and dep <= set(mapping):
            fdeps[name] = frozenset(mapping[d] for d in dep)
    dbound = {
        name: ct.dbound[src]
        for src, name in mapping.items()
        if src in ct.dbound
    }
    return CTable(out, ct.n, unique, bounds, ct.mask, fdeps, dbound)


def _order_code(node: Sort, ct: CTable):
    """One int64 per row whose ascending order IS the requested sort:
    keys pack least-significant first (static spans multiply in; float
    or unbounded keys enter through their order-preserving rank),
    seeded with the row index so codes are *distinct* per row and ties
    break stably; dead rows land after every live row."""
    f = ct.frame
    cap = ct.cap
    acc = _arange(cap, ct.device)  # stable tiebreak, keeps acc distinct
    S = cap
    for name, asc in reversed(node.keys):  # first key most significant
        m = f.meta(name)
        v = f.col_values(name)
        if not asc:
            v = -v
        sp = None if m.kind == "float" else _static_span(ct, name)
        if sp is None:
            r = _rank(v, cap)  # order-preserving (ties collapse: fine)
            lo, span = 0, cap + 1
        else:
            lo, span = sp
            if not asc:
                lo = -(lo + span - 1)  # negation flips the window
            r = torch.clamp(v - lo, 0, span - 1)
        if S * span > _PACK_LIMIT:
            acc = _rank(acc, cap)  # bijective on a distinct array
            S = cap
        acc = r * S + acc
        S = S * span
    return torch.where(ct.row_valid, acc, acc + S)  # padding rows last


def _c_sort(node: Sort, ct: CTable) -> CTable:
    """ORDER BY without a multi-key sort: ranking the distinct packed
    order codes is a bijection, so scattering the ranks yields the sort
    permutation from two cheap sorts."""
    cap = ct.cap
    acc = _order_code(node, ct)
    pos = _rank(acc, cap)  # bijection: every acc value is distinct
    order = torch.zeros((cap,), dtype=INT, device=ct.device)
    order.scatter_(0, pos, _arange(cap, ct.device))
    return _gather_rows(ct, order, ct.n)


def _c_topk(sort_node: Sort, k: int, ct: CTable) -> CTable:
    """Fused ORDER BY + LIMIT k: ``topk`` over the negated order codes
    finds the k smallest (codes are distinct, ties to the lower row
    index, matching the stable sort), so only k rows are ever
    gathered."""
    kk = min(ct.cap, _pow2(k))
    idx = torch.topk(-_order_code(sort_node, ct), kk).indices
    return _gather_rows(ct, idx, torch.clamp(ct.n, max=k))


def _c_limit(node: Limit, ct: CTable) -> CTable:
    k = int(node.n)
    ct = _compact(ct)  # LIMIT slices, so rows must sit in [0, n)
    new_cap = min(ct.cap, _pow2(k))
    f = ct.frame
    out = TensorFrame(
        f.itensor[:new_cap], f.ftensor[:new_cap], dict(f.columns), {}, new_cap
    )
    return CTable(
        out, torch.clamp(ct.n, max=k), ct.unique, ct.bounds, fdeps=ct.fdeps,
        dbound=ct.dbound,
    )


def _c_distinct(ct: CTable) -> CTable:
    f = ct.frame
    names = f.column_names
    for c in names:
        if f.meta(c).kind in ("float", "obj"):
            raise Unsupported(
                f"DISTINCT over kind {f.meta(c).kind} column {c}"
            )
    rv = ct.row_valid
    _check_group_cols(f, names)
    eff = _effective_keys(ct, names)
    code, S = _pack_group_code(ct, f, eff)
    gids, n_out, cap_out = _group_ids(
        code, S, rv, ct.cap, _dbound_product(ct, eff)
    )
    # each group's first row index; sorting puts the kept rows in
    # original order (matches the engine) with empty slots pushed last
    rep = _seg_extreme(
        torch.where(rv, _arange(ct.cap, ct.device), _BIG), gids, cap_out, "amin"
    )
    idx = torch.clamp(torch.sort(rep).values, 0, ct.cap - 1)
    return _gather_rows(
        ct, idx, n_out, unique=ct.unique | {frozenset(names)}
    )


def _c_attach_scalar(node: AttachScalar, ct: CTable, sub: CTable) -> CTable:
    q = node.sub.v
    while isinstance(q, Project):
        q = q.child
    if not (isinstance(q, Aggregate) and not q.keys):
        raise Unsupported("scalar subquery not provably single-row")
    m = sub.frame.meta(node.output)
    if _valid_name(node.output) in sub.frame.columns:
        raise Unsupported("nullable scalar subquery output")
    v = sub.frame.col_values(node.output)[0]
    f = ct.frame
    if m.kind == "float":
        out = f._append_float_column(
            node.name, v.to(float_dtype()).expand(ct.cap).contiguous()
        )
    else:
        out = f._append_int_column(
            node.name, v.to(INT).expand(ct.cap).contiguous(), m.kind, m.dictionary
        )
    return CTable(
        out, ct.n, ct.unique, ct.bounds, ct.mask, ct.fdeps, ct.dbound
    )


def _c_scan(node: Scan, ctx) -> CTable:
    if node.predicates:
        raise Unsupported("scan with pushed predicates")
    base = ctx.base_table(node.table)
    f = base.frame.select(list(node.columns))
    f = f.rename({c: f"{node.alias}.{c}" for c in node.columns})
    prep = ctx.tables[node.table]
    uniq = set()
    have = set(node.columns)
    for combo, verdict in ctx.combos[node.table].items():
        if verdict and set(combo) <= have:
            uniq.add(frozenset(f"{node.alias}.{c}" for c in combo))
    bounds = {
        f"{node.alias}.{c}": prep.bounds[c]
        for c in node.columns
        if c in prep.bounds
    }
    return CTable(f, base.n, uniq, bounds)


def _c_lower(node, ctx, memo: Dict) -> CTable:
    if isinstance(node, Shared):
        if node not in memo:
            memo[node] = _c_lower(node.child, ctx, memo)
        return memo[node]
    if isinstance(node, Scan):
        return _c_scan(node, ctx)
    if isinstance(node, Filter):
        return _c_filter(node, _c_lower(node.child, ctx, memo), ctx)
    if isinstance(node, Join):
        return _c_join(
            node,
            _c_lower(node.left, ctx, memo),
            _c_lower(node.right, ctx, memo),
        )
    if isinstance(node, Aggregate):
        return _c_aggregate(node, _c_lower(node.child, ctx, memo), ctx)
    if isinstance(node, Project):
        return _c_project(node, _c_lower(node.child, ctx, memo), ctx)
    if isinstance(node, Sort):
        return _c_sort(node, _c_lower(node.child, ctx, memo))
    if isinstance(node, Limit):
        if isinstance(node.child, Sort) and int(node.n) <= 1 << 12:
            return _c_topk(
                node.child,
                int(node.n),
                _c_lower(node.child.child, ctx, memo),
            )
        return _c_limit(node, _c_lower(node.child, ctx, memo))
    if isinstance(node, Distinct):
        return _c_distinct(_c_lower(node.child, ctx, memo))
    if isinstance(node, AttachScalar):
        return _c_attach_scalar(
            node,
            _c_lower(node.child, ctx, memo),
            _c_lower(node.sub.v, ctx, memo),
        )
    raise Unsupported(f"plan node {type(node).__name__}")


def _finalize(ct: CTable) -> CTable:
    """Compact the result to fresh, dead-slot-free payload tensors so
    the program returns exactly what the caller slices."""
    ct = _compact(ct)
    f = ct.frame
    islots: List[int] = []
    fslots: List[int] = []
    cols: Dict[str, ColumnMeta] = {}
    for name, m in f.columns.items():
        if m.kind == "float":
            cols[name] = dataclasses.replace(m, slot=len(fslots), block=0)
            fslots.append(m.slot)
        else:
            cols[name] = dataclasses.replace(m, slot=len(islots), block=0)
            islots.append(m.slot)
    # column by column: an index list would be a host-to-device copy
    dev = f.device
    it = (
        torch.stack([f.itensor[:, s] for s in islots], dim=1)
        if islots
        else _empty_tensor(f.nrows, INT, dev)
    )
    ft = (
        torch.stack([f.ftensor[:, s] for s in fslots], dim=1)
        if fslots
        else _empty_tensor(f.nrows, float_dtype(), dev)
    )
    out = TensorFrame(it, ft, cols, {}, f.nrows)
    return CTable(out, ct.n.to(INT), ct.unique)


# ----------------------------------------------------------------------
# trace context + captured-program construction
# ----------------------------------------------------------------------
class _TableMeta:
    """What the traced program reads of a prepared table besides its
    padded tensors (an entry keeps this, not the frame)."""

    __slots__ = ("columns", "cap", "bounds")

    def __init__(self, prep: _PrepTable):
        self.columns = dict(prep.frame.columns)
        self.cap = prep.cap
        self.bounds = dict(prep.bounds)


class _Ctx:
    def __init__(self, bases, tables, combos, params_i, params_f, slots):
        self.bases = bases  # table -> _Pad (padded itensor, ftensor, n)
        self.tables = tables  # table -> _TableMeta
        self.combos = combos  # table -> the uniqueness verdicts the plan asked for
        self.params_i = params_i
        self.params_f = params_f
        self.slots = slots  # global param index -> ('i'|'f', position)
        self._base_memo: Dict[str, CTable] = {}

    def base_table(self, name: str) -> CTable:
        got = self._base_memo.get(name)
        if got is None:
            pad = self.bases[name]
            meta = self.tables[name]
            cols = {k: dataclasses.replace(m) for k, m in meta.columns.items()}
            got = CTable(TensorFrame(pad.it, pad.ft, cols, {}, meta.cap), pad.n)
            self._base_memo[name] = got
        return got

    def bind(self, e):
        if not self.slots:
            return e

        def fn(n):
            if isinstance(n, SParam):
                tag, j = self.slots[n.index]
                arr = self.params_f if tag == "f" else self.params_i
                return _BoundParam(arr[j], n.kind)
            return n

        return transform(e, fn)


def _param_slots(kinds: List[str]):
    slots = []
    ni = nf = 0
    for k in kinds:
        if k == "float":
            slots.append(("f", nf))
            nf += 1
        else:
            slots.append(("i", ni))
            ni += 1
    return slots, ni, nf


class _Pad:
    """The padded copy of one base table that every graph reading a
    table of this signature reads in place: ``cap`` rows (the live ones,
    then zeros) and a device row count; refilled when a call brings
    another frame of the same signature."""

    __slots__ = ("it", "ft", "n", "frame")

    def __init__(self, prep: _PrepTable):
        f = prep.frame
        dev = f.device
        self.it = torch.zeros((prep.cap, f.itensor.shape[1]), dtype=INT, device=dev)
        self.ft = torch.zeros((prep.cap, f.ftensor.shape[1]), dtype=f.ftensor.dtype, device=dev)
        self.n = torch.zeros((), dtype=INT, device=dev)
        self.frame = None  # weakref to the frame whose rows it holds

    def load(self, prep: _PrepTable) -> None:
        f = prep.frame
        if self.frame is not None and self.frame() is f:
            return
        n = f.nrows
        self.it[:n].copy_(f.itensor)
        self.it[n:].zero_()
        self.ft[:n].copy_(f.ftensor)
        self.ft[n:].zero_()
        self.n.fill_(n)
        self.frame = weakref.ref(f)


#: table signature -> its padded copy (one per (table, capacity, schema)),
#: shared by the entries compiled while it is here; each entry holds its own
_PADS: Dict[str, _Pad] = {}


def _load_pads(preps, order, sigs) -> Dict[str, _Pad]:
    """The padded copies of the plan's tables, filled with these frames'
    rows.  The caller holds _RUN_LOCK."""
    for sig in [k for k, p in _PADS.items() if p.frame is not None and p.frame() is None]:
        del _PADS[sig]  # its frame is gone (entries keep theirs)
    out = {}
    for name, sig in zip(order, sigs):
        pad = _PADS.get(sig)
        if pad is None:
            pad = _PADS[sig] = _Pad(preps[name])
        pad.load(preps[name])
        out[name] = pad
    return out


class _Entry:
    __slots__ = (
        "run",
        "graph",
        "outs",
        "consts",
        "pads",
        "pins",
        "params_i",
        "params_f",
        "slots",
        "columns",
        "cap",
        "order",
        "sigs",
        "digest",
        "trace_s",
        "compile_s",
    )

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw.get(k))

    def set_params(self, values) -> None:
        vi = np.zeros((self.params_i.shape[0],), dtype=np.int64)
        vf = np.zeros((self.params_f.shape[0],), dtype=np.float64)
        for (kind, v), (tag, j) in zip(values, self.slots):
            if tag == "f":
                vf[j] = float(v)
            else:
                vi[j] = int(v)
        self.params_i.copy_(torch.from_numpy(vi))
        self.params_f.copy_(torch.from_numpy(vf).to(self.params_f.dtype))

    def execute(self, preps):
        """(itensor, ftensor, n) of one run over ``preps``' frames, the
        rows copied out of the graph's buffers.  Under _RUN_LOCK."""
        # the entry's own padded copies: its graph reads them by address
        for name, pad in self.pads.items():
            pad.load(preps[name])
        if self.graph is None:  # the CPU: the traced function, eagerly
            it, ft, n_out = self.run(self.pads)
            n = int(n_out)
            count_d2h()
            return it[:n], ft[:n], n
        self.graph.replay()
        it, ft, n_out = self.outs
        n = int(n_out)  # host sync: the graph really ran
        count_d2h()
        return it[:n].clone(), ft[:n].clone(), n


_POOL = None  # the memory pool every captured graph allocates from
#: device -> the one side stream of every warm-up and capture: the caching
#: allocator reuses a freed block only on the stream it was allocated on,
#: so graphs captured on one stream share the pool's memory
_SIDE: Dict[torch.device, "torch.cuda.Stream"] = {}


def _graph_pool():
    global _POOL
    if _POOL is None:
        _POOL = torch.cuda.graph_pool_handle()
    return _POOL


def _side_stream(dev) -> "torch.cuda.Stream":
    got = _SIDE.get(dev)
    if got is None:
        got = _SIDE[dev] = torch.cuda.Stream(device=dev)
    return got


def _compile_entry(fpr, pplan, preps, combos, order, sigs, kinds, values):
    from ..resilience.faults import fault_point

    fault_point("compile")
    slots, n_i, n_f = _param_slots(kinds)
    dev = preps[order[0]].frame.device
    tables = {t: _TableMeta(p) for t, p in preps.items()}
    captured: Dict = {}

    entry = _Entry(
        slots=slots, order=order, sigs=sigs, consts={}, pins=[],
        params_i=torch.zeros((n_i,), dtype=INT, device=dev),
        params_f=torch.zeros((n_f,), dtype=float_dtype(), device=dev),
    )

    def run(bases):
        ctx = _Ctx(bases, tables, combos, entry.params_i, entry.params_f, slots)
        out = _finalize(_c_lower(pplan, ctx, {}))
        captured["columns"] = out.frame.columns
        captured["cap"] = out.cap
        return out.frame.itensor, out.frame.ftensor, out.n

    entry.run = run
    cuda = dev.type == "cuda"
    with _RUN_LOCK:
        entry.set_params(values)
        bases = entry.pads = _load_pads(preps, order, sigs)
        t0 = time.perf_counter()
        with obs.span("sql.compile.trace", fingerprint=fpr[:80]):
            with _TraceGuard(entry.consts if cuda else None, record=True):
                run(bases)
            if cuda:
                torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        if cuda:
            with obs.span("sql.compile.compile"):
                entry.graph, entry.outs = _capture(run, bases, entry, dev)
        t2 = time.perf_counter()
    entry.columns = captured["columns"]
    entry.cap = captured["cap"]
    entry.digest = hashlib.sha1(fpr.encode()).hexdigest()[:12]
    entry.trace_s, entry.compile_s = t1 - t0, t2 - t1
    return entry


def _capture(run, bases, entry, dev):
    """Warm ``run`` up on a side stream, then capture it into the shared
    pool: (graph, its output tensors).  The graph reads the entry's
    padded tables, parameters, hoisted constants and the packed
    dictionaries its kernels take (``entry.pins``) by address, so the
    entry holds them.  Raises ``CaptureError``."""
    try:
        side = _side_stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            with _TraceGuard(entry.consts, record=False):
                run(bases)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=_graph_pool(), stream=side):
            with _TraceGuard(entry.consts, record=False), strings.pinning(entry.pins):
                outs = run(bases)
        return graph, outs
    except CaptureError:
        raise
    except Exception as e:
        raise CaptureError(f"capture of a traced plan failed: {type(e).__name__}: {e}") from e


def _maybe_compile(fpr, pplan, preps, combos, tables, sigs, kinds, values):
    """Resolve a cache miss: compile ``fpr``, or reuse the entry a
    racing thread produced while we waited on the trace lock.  The
    caller holds the per-fingerprint lock.  Returns None on fallback."""
    with _LOCK:
        entry = _CACHE.get(fpr)
        if entry is not None:
            STATS["hits"] += 1
            _count_call(entry)
            _CACHE.move_to_end(fpr)
            return entry
        if fpr in _NEGATIVE:
            STATS["fallbacks"] += 1
            return None
        STATS["misses"] += 1
    try:
        entry = _compile_entry(fpr, pplan, preps, combos, tables, sigs, kinds, values)
    except _FALLBACK_ERRORS as e:
        with _LOCK:
            _NEGATIVE[fpr] = f"{type(e).__name__}: {e}"
            _TRACE_LOCKS.pop(fpr, None)
            STATS["fallbacks"] += 1
        return None
    except CaptureError:
        # warm-up or capture failed: a fault of this module, not of the
        # plan -- never negative-cached, never hidden behind op-by-op
        with _LOCK:
            _TRACE_LOCKS.pop(fpr, None)
        raise
    except Exception as e:
        # an *unexpected* crash before capture (an injected fault at the
        # compile point) must not poison serving: negative-cache the
        # fingerprint so the plan dispatches op-by-op, and release the
        # trace lock so waiters aren't stuck behind it
        with _LOCK:
            _NEGATIVE[fpr] = f"compile failure {type(e).__name__}: {e}"
            _TRACE_LOCKS.pop(fpr, None)
            STATS["compile_failures"] += 1
            STATS["fallbacks"] += 1
        return None
    with _LOCK:
        STATS["compiles"] += 1
        _CACHE[fpr] = entry
        _TRACE_LOCKS.pop(fpr, None)
        while len(_CACHE) > CACHE_CAPACITY:
            _CACHE.popitem(last=False)  # the graph goes with its entry
            STATS["evictions"] += 1
        rec = STATS["plans"].setdefault(
            entry.digest,
            {
                "tables": tables,
                "trace_s": 0.0,
                "compile_s": 0.0,
                "calls": 0,
            },
        )
        rec["trace_s"] += entry.trace_s
        rec["compile_s"] += entry.compile_s
        rec["calls"] += 1
    return entry


def _count_call(entry) -> None:
    """One more execution of ``entry``'s plan (a cache hit).  Under _LOCK."""
    rec = STATS["plans"].get(entry.digest)
    if rec is not None:
        rec["calls"] += 1


_FALLBACK_ERRORS = (Unsupported, SqlError, TraceGuardError)


def maybe_execute_compiled(plan, frames) -> Optional[TensorFrame]:
    """Run ``plan`` through the compiled path, or return None to let
    the caller dispatch op-by-op (the JAX package's entry point;
    ``sql.execute_plan`` calls ``run_compiled``)."""
    got = run_compiled(plan, frames)
    return None if got is None else got[0]


def run_compiled(plan, frames) -> Optional[Tuple[TensorFrame, bool, str]]:
    """``maybe_execute_compiled``, with whether the plan's graph was
    cached and its digest beside the frame: ``(frame, cache_hit,
    digest)``, or None where the compiled path declines."""
    mode = CONFIG.compiled
    if mode == "off":
        return None
    with obs.span("sql.compile.prepare") as sp:
        scans: List[Scan] = list(walk_scans(plan))
        if not scans:
            return None
        tables = sorted({s.table for s in scans})
        sp.set(tables=tables)
        for s in scans:
            if s.predicates:
                with _LOCK:
                    STATS["fallbacks"] += 1
                return None
        for t in tables:
            if not isinstance(frames.get(t), TensorFrame):
                with _LOCK:
                    STATS["fallbacks"] += 1
                return None
        udfs = active_udfs()
        if udfs and plan_uses_udf(plan, frozenset(udfs)):
            # the fingerprint keys on plan structure; it cannot capture the
            # python closure behind a session UDF -> op-by-op dispatch
            with _LOCK:
                STATS["fallbacks"] += 1
            return None
        if mode != "force":
            total = sum(frames[t].nrows for t in tables)
            if total < CONFIG.compiled_min_rows:
                with _LOCK:
                    STATS["skipped_small"] += 1
                return None

        preps = {t: _prep_table(frames[t]) for t in tables}
        reqs: Dict[str, set] = {}
        _collect_unique_requests(plan, reqs)
        for t, combos in reqs.items():
            if t in preps:
                for combo in combos:
                    _ensure_unique(preps[t], combo)

        try:
            pplan, values = parameterize(plan)
        except Unsupported:
            with _LOCK:
                STATS["fallbacks"] += 1
            return None
        kinds = [k for k, _ in values]
        combos = {t: _plan_combos(preps[t], reqs.get(t, ())) for t in tables}
        sigs = [_table_sig(t, preps[t], combos[t]) for t in tables]
        fpr = "|".join([repr(pplan), f"fd={CONFIG.float_dtype}", *sigs])
        with _LOCK:
            if fpr in _NEGATIVE:
                STATS["fallbacks"] += 1
                return None
            entry = _CACHE.get(fpr)
            if entry is not None:
                STATS["hits"] += 1
                _count_call(entry)
                _CACHE.move_to_end(fpr)
                tlock = None
            else:
                # one lock per in-flight fingerprint: concurrent first
                # compiles of the same plan serialize, distinct plans don't
                tlock = _TRACE_LOCKS.setdefault(fpr, threading.Lock())

    cache_hit = entry is not None
    if entry is None:
        with tlock:
            entry = _maybe_compile(fpr, pplan, preps, combos, tables, sigs, kinds, values)
        if entry is None:
            return None

    with obs.span(
        "sql.compile.execute", digest=entry.digest, cache_hit=cache_hit
    ) as sp:
        with _RUN_LOCK:
            entry.set_params(values)
            it, ft, n = entry.execute(preps)
        sp.set(rows=n)
    cols = {k: dataclasses.replace(m) for k, m in entry.columns.items()}
    return TensorFrame(it, ft, cols, {}, n), cache_hit, entry.digest
