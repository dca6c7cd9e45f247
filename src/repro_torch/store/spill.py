"""Spill-to-disk for host-side intermediates under a memory budget.

The out-of-core layer (``repro_torch.core.pipeline``) holds intermediate
results — per-chunk partial aggregates, buffered probe outputs — as
host array blocks.  ``SpillManager`` tracks their bytes against
``CONFIG.memory_budget_bytes`` and, when the pool overflows, evicts the
least-recently-used blocks to ``.tfb`` v2 chunk files (the store's own
format, so spilled frames keep zone maps, encodings and validity
bitmaps).  Access through ``Spillable.get`` transparently re-hydrates
and re-registers the block as most-recently-used.

Lifecycle: a spill file belongs to its ``Spillable`` — a
``weakref.finalize`` deletes the directory when the handle is garbage
collected, and the per-process spill root (used when
``CONFIG.spill_dir`` is unset) is removed at interpreter exit.

Resilience — spilling is an *optimization*, so its I/O
failures degrade, never escalate:

- **writes** retry transient OSErrors (``resilience.retry``, budget
  ``CONFIG.io_retries``); a write that still fails keeps the block
  resident in memory — the budget overruns, counted in
  ``write_failures`` / ``retained_bytes`` — and the block is not
  re-offered for eviction;
- **reads** retry the same way; a block that comes back corrupt
  (unreadable, or its schema/row-count no longer matches what was
  written) is *recomputed* through the closure registered with the
  block (``register(..., recompute=)``) when one exists — counted in
  ``corrupt_blocks``/``recomputes`` — and surfaces as a typed
  ``TransientIOError`` only when it can't be;
- **deletes** never raise (a vanished spill dir is the desired end
  state); undeletable leftovers are counted in ``delete_failures``
  and swept again by the atexit root cleanup.

Fault-injection sites: ``spill.write``, ``spill.read``,
``spill.delete`` (armed by the chaos suite via ``resilience.faults``).

No torch imports: ``repro_torch.store`` stays a host-side layer.
"""
from __future__ import annotations

import atexit
import itertools
import os
import shutil
import tempfile
import threading
import weakref
from collections import OrderedDict
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from repro_torch.resilience import TransientIOError, faults, retry

_IDS = itertools.count()

_PROC_DIR: Optional[str] = None
_PROC_LOCK = threading.Lock()


def _process_spill_root() -> str:
    """Lazily created per-process spill directory, removed atexit."""
    global _PROC_DIR
    with _PROC_LOCK:
        if _PROC_DIR is None:
            _PROC_DIR = tempfile.mkdtemp(prefix="repro-spill-")
            atexit.register(shutil.rmtree, _PROC_DIR, ignore_errors=True)
    return _PROC_DIR


def _nbytes(arr: np.ndarray) -> int:
    if arr.dtype == object:
        return int(sum(len(str(s).encode()) + 8 for s in arr))
    return int(arr.nbytes)


def block_bytes(
    data: Dict[str, np.ndarray], validity: Optional[Dict[str, np.ndarray]]
) -> int:
    total = sum(_nbytes(a) for a in data.values())
    if validity:
        total += sum(_nbytes(a) for a in validity.values())
    return total


def _delete_dir(path: str) -> None:
    """Best-effort spill-dir removal: must never raise (it runs from
    weakref finalizers and GC), but a leftover dir is still counted."""
    try:
        faults.fault_point("spill.delete")
        shutil.rmtree(path)
    except FileNotFoundError:
        pass
    except Exception:
        try:
            shutil.rmtree(path, ignore_errors=True)
        except Exception:
            pass
        if os.path.exists(path):
            with SPILL._lock:
                SPILL.counters["delete_failures"] += 1


class Spillable:
    """One spillable block: a dict of host arrays (+ validity bitmaps).

    In-memory by default; ``spill()`` persists it as a ``.tfb`` v2
    directory and drops the arrays; ``get()`` re-hydrates on demand.
    The spill directory is deleted when the handle is GC'd.
    ``recompute`` (optional) rebuilds ``(data, validity)`` from durable
    inputs when the spill file comes back corrupt.
    """

    def __init__(
        self,
        manager: "SpillManager",
        data: Dict[str, np.ndarray],
        validity: Optional[Dict[str, np.ndarray]] = None,
        recompute: Optional[Callable[[], Tuple[Dict, Dict]]] = None,
    ):
        self.id = next(_IDS)
        self._manager = manager
        self._data: Optional[Dict[str, np.ndarray]] = dict(data)
        self._validity: Dict[str, np.ndarray] = dict(validity or {})
        self.nbytes = block_bytes(data, validity)
        self._path: Optional[str] = None
        self._finalizer = None
        self._recompute = recompute
        self._write_failed = False
        # written-block identity for corruption checks on re-read
        self._schema = tuple(sorted(data))
        self._rows = {k: int(a.shape[0]) for k, a in data.items()}

    @property
    def spilled(self) -> bool:
        return self._data is None

    # -- called by the manager (under its lock) ------------------------
    def _spill_path(self) -> str:
        root = self._manager.spill_root()
        return os.path.join(root, f"block-{os.getpid()}-{self.id}.tfb")

    def _write(self, path: str) -> None:
        from . import format as storefmt

        faults.fault_point("spill.write")
        n = max((a.shape[0] for a in self._data.values()), default=0)
        storefmt.write_arrays(
            path,
            self._data,
            chunk_rows=max(1, n),
            validity=self._validity or None,
        )

    def _do_spill(self) -> int:
        """Write the block out and free the host arrays; returns bytes
        written (0 when a previous spill file is still valid — blocks
        are immutable, so re-hydrated copies can be dropped free).

        A write that fails through the retry budget raises
        ``TransientIOError`` with the block left resident (the caller
        counts it and stops offering the block for eviction)."""
        if self._data is None:
            return 0
        wrote = 0
        if self._path is None:
            path = self._spill_path()
            try:
                retry.call(
                    lambda: self._write(path), site="spill.write"
                )
            except Exception:
                _delete_dir(path)  # never leave a half-written block
                raise
            self._path = path
            self._finalizer = weakref.finalize(self, _delete_dir, path)
            wrote = self.nbytes
        self._data = None
        return wrote

    def _read(self) -> Tuple[Dict, Dict]:
        from . import format as storefmt

        faults.fault_point("spill.read")
        table = storefmt.open_store(self._path)
        data: Dict[str, np.ndarray] = {}
        validity: Dict[str, np.ndarray] = {}
        for name, col in table.columns.items():
            phys = col.physical()
            if col.encoding == "dict":
                phys = col.dictionary[
                    np.clip(phys, 0, max(0, col.dictionary.shape[0] - 1))
                ]
            elif col.ctype == "date":
                phys = phys.astype("datetime64[D]")
            elif col.ctype == "bool":
                phys = phys != 0
            data[name] = phys
            v = col.validity()
            if v is not None:
                validity[name] = v
        if tuple(sorted(data)) != self._schema or any(
            int(data[k].shape[0]) != self._rows[k] for k in self._schema
        ):
            raise TransientIOError(
                f"corrupt spill block at {self._path}: schema/row-count "
                f"mismatch against what was written"
            )
        return data, validity

    def _do_load(self) -> None:
        """Re-hydrate from the spill file, recovering a corrupt or
        unreadable block through its recompute closure when one was
        registered (counted by the caller via the returned flag)."""
        if self._data is not None:
            return
        try:
            # corrupt-content mismatch (TransientIOError from _read) is
            # NOT retried: re-reading the same bad file cannot fix it
            data, validity = retry.call(
                self._read, site="spill.read", retry_on=(OSError, EOFError)
            )
        except Exception as e:
            with self._manager._lock:
                self._manager.counters["corrupt_blocks"] += 1
            if self._recompute is None:
                if isinstance(e, TransientIOError):
                    raise
                raise TransientIOError(
                    f"unreadable spill block at {self._path}"
                ) from e
            data, validity = self._recompute()
            validity = dict(validity or {})
            with self._manager._lock:
                self._manager.counters["recomputes"] += 1
            # the on-disk copy is bad: drop it so the next eviction
            # rewrites instead of re-reading garbage
            _delete_dir(self._path)
            self._path = None
            if self._finalizer is not None:
                self._finalizer.detach()
                self._finalizer = None
        self._data = dict(data)
        self._validity = dict(validity)

    # -- public --------------------------------------------------------
    def get(self) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
        """(data, validity), re-hydrating from disk when spilled."""
        return self._manager.touch(self)

    def release(self) -> None:
        """Stop tracking this block (arrays stay as they are)."""
        self._manager.unregister(self)


class SpillManager:
    """LRU byte-budget tracker over registered ``Spillable`` blocks.

    The budget is read from ``CONFIG.memory_budget_bytes`` at every
    enforcement point, so tests and the serving layer can flip it at
    runtime.  ``None`` disables spilling (blocks are still tracked, so
    ``peak_tracked_bytes`` stays observable).
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._lru: "OrderedDict[int, Spillable]" = OrderedDict()
        self.counters = {
            "bytes_spilled": 0,
            "bytes_reread": 0,
            "evictions": 0,
            "peak_tracked_bytes": 0,
            "write_failures": 0,  # spill writes that exhausted retries
            "retained_bytes": 0,  # bytes kept resident past the budget
            "corrupt_blocks": 0,  # spill files unreadable/mismatched
            "recomputes": 0,  # corrupt blocks rebuilt from source
            "delete_failures": 0,  # spill dirs that would not delete
        }

    # -- config --------------------------------------------------------
    @staticmethod
    def budget() -> Optional[int]:
        from repro_torch.core.config import CONFIG

        return CONFIG.memory_budget_bytes

    @staticmethod
    def spill_root() -> str:
        from repro_torch.core.config import CONFIG

        if CONFIG.spill_dir:
            os.makedirs(CONFIG.spill_dir, exist_ok=True)
            return CONFIG.spill_dir
        return _process_spill_root()

    # -- introspection -------------------------------------------------
    def tracked_bytes(self) -> int:
        with self._lock:
            return sum(
                s.nbytes for s in self._lru.values() if not s.spilled
            )

    def reset_counters(self) -> None:
        with self._lock:
            for k in self.counters:
                self.counters[k] = 0

    # -- registration / LRU --------------------------------------------
    def register(
        self,
        data: Dict[str, np.ndarray],
        validity: Optional[Dict[str, np.ndarray]] = None,
        recompute: Optional[Callable[[], Tuple[Dict, Dict]]] = None,
    ) -> Spillable:
        s = Spillable(self, data, validity, recompute=recompute)
        with self._lock:
            self._lru[s.id] = s
            self._note_peak()
            self._enforce(keep=s)
        return s

    def unregister(self, s: Spillable) -> None:
        with self._lock:
            self._lru.pop(s.id, None)

    def touch(self, s: Spillable):
        with self._lock:
            reread = s.spilled
            if reread:
                from repro_torch import obs

                with obs.span("spill.reread") as sp:
                    s._do_load()
                    sp.set(bytes=s.nbytes)
                self.counters["bytes_reread"] += s.nbytes
            else:
                s._do_load()
            if s.id in self._lru:
                self._lru.move_to_end(s.id)
            self._note_peak()
            self._enforce(keep=s)
            return s._data, s._validity

    def _note_peak(self) -> None:
        t = sum(s.nbytes for s in self._lru.values() if not s.spilled)
        if t > self.counters["peak_tracked_bytes"]:
            self.counters["peak_tracked_bytes"] = t

    def _enforce(self, keep: Optional[Spillable] = None) -> None:
        budget = self.budget()
        if budget is None:
            return
        resident = [s for s in self._lru.values() if not s.spilled]
        total = sum(s.nbytes for s in resident)
        for s in resident:  # LRU order (OrderedDict insertion/touch)
            if total <= budget:
                break
            if keep is not None and s.id == keep.id:
                continue
            if s._write_failed:
                continue  # already retained in memory; don't re-fail
            from repro_torch import obs

            with obs.span("spill.write") as sp:
                try:
                    wrote = s._do_spill()
                except (OSError, TransientIOError):
                    # graceful degradation: keep the block resident and
                    # overrun the budget rather than lose the data
                    s._write_failed = True
                    self.counters["write_failures"] += 1
                    self.counters["retained_bytes"] += s.nbytes
                    sp.set(bytes=0, failed=1)
                    continue
                sp.set(bytes=wrote)
            self.counters["bytes_spilled"] += wrote
            self.counters["evictions"] += 1
            total -= s.nbytes
        # the kept block alone may still overflow the budget — that's
        # fine, a block must be resident to be usable at all


#: process-wide manager (the out-of-core layer's single pool)
SPILL = SpillManager()

from repro_torch import obs as _obs  # noqa: E402  (torch-free)

_obs.metrics.register_group(
    "store.spill", lambda: dict(SPILL.counters), SPILL.reset_counters
)
