"""Process-wide interned string-pool for column dictionaries.

Every dictionary that enters the store is canonicalized through one
process-wide pool: two columns (in the same table, across chunks, or in
different tables/frames) whose dictionaries have equal content share
the *same* ``np.ndarray`` object.  Downstream, identity is the fast
path — ``core.encoding.merge_dictionaries`` returns an O(1)/O(k)
identity remap when both sides are the same object, and the join's
shared-factorization step (``core.join.shared_key_codes``) skips the
dictionary merge entirely (``ld is rd``).  This is the paper's own
"dictionary operations" optimization opportunity: re-sorting and
re-merging identical dictionaries per frame was pure waste.

The pool is content-addressed (byte digest of the entries), guarded by
a full equality check so a digest collision can never alias two
different dictionaries.  Interned arrays are marked read-only; sharing
is only safe because nobody may write through them.

The pool is **bounded**: entries are kept in LRU order and evicted past
``max_entries`` (default 1024 dictionaries), so a long-running process
churning through many distinct table sets no longer accumulates strong
references for its lifetime.  Eviction is always *safe*: code still
holding an evicted canonical array keeps it alive through its own
reference; a later equal dictionary simply interns to a fresh object
and the identity fast path degrades to the content-merge slow path.
``POOL.clear()`` still empties the pool manually; ``POOL.max_entries``
is assignable (``None`` disables the bound).

The pool is **thread-safe**: a serving tier interns dictionaries from
many sessions concurrently, so lookup/insert/eviction run
under one mutex.  Interning is a short host-side critical section —
digesting happens outside the lock; only the bucket probe, insert and
LRU eviction are serialized.

No torch imports here: the pool (like all of ``repro_torch.store``) is host-side
numpy and must stay importable without initializing any accelerator.
"""
from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import List, Optional, Tuple

import numpy as np

DEFAULT_MAX_ENTRIES = 1024


def _digest(dictionary: np.ndarray) -> Tuple[int, bytes]:
    h = hashlib.sha1()
    for s in dictionary:
        b = str(s).encode("utf-8")
        h.update(len(b).to_bytes(4, "little"))
        h.update(b)
    return int(dictionary.shape[0]), h.digest()


class StringPool:
    """Content-addressed, LRU-bounded intern table for sorted
    dictionary arrays."""

    def __init__(self, max_entries: Optional[int] = DEFAULT_MAX_ENTRIES) -> None:
        # key -> collision bucket, in LRU order (oldest first)
        self._by_key: "OrderedDict[Tuple[int, bytes], List[np.ndarray]]" = (
            OrderedDict()
        )
        self._count = 0  # total interned arrays, kept O(1)
        self._lock = threading.Lock()
        self.max_entries = max_entries
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def intern(self, dictionary: np.ndarray) -> np.ndarray:
        """Return the canonical instance of ``dictionary``.

        Equal-content calls return the *same object* (``is``-identical),
        so identity checks downstream replace content comparisons.  The
        canonical array is read-only.  Safe to call from any thread.
        """
        dictionary = np.asarray(dictionary)
        key = _digest(dictionary)  # hash outside the lock
        with self._lock:
            bucket = self._by_key.get(key)
            if bucket is not None:
                self._by_key.move_to_end(key)  # LRU touch
                for cand in bucket:  # digest-collision guard: verify content
                    if cand.shape == dictionary.shape and bool(
                        np.all(cand == dictionary)
                    ):
                        self.hits += 1
                        return cand
            else:
                bucket = self._by_key[key] = []
            canonical = dictionary.copy()
            canonical.setflags(write=False)
            bucket.append(canonical)
            self._count += 1
            self.misses += 1
            self._evict()
        return canonical

    def _evict(self) -> None:
        if self.max_entries is None:
            return
        while self._count > self.max_entries and len(self._by_key) > 1:
            _, bucket = self._by_key.popitem(last=False)
            self._count -= len(bucket)
            self.evictions += len(bucket)

    def __len__(self) -> int:
        return self._count

    def clear(self) -> None:
        with self._lock:
            self._by_key.clear()
            self._count = 0
            self.hits = 0
            self.misses = 0
            self.evictions = 0

    def stats_snapshot(self) -> dict:
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "entries": self._count,
            }

    def reset_stats(self) -> None:
        """Zero the counters; interned entries stay (counter isolation
        must not evict canonical dictionaries other frames hold)."""
        with self._lock:
            self.hits = 0
            self.misses = 0
            self.evictions = 0


#: The process-wide pool every store table interns through.
POOL = StringPool()

from repro_torch import obs as _obs  # noqa: E402  (torch-free)

_obs.metrics.register_group(
    "store.pool", POOL.stats_snapshot, POOL.reset_stats
)


def intern_dictionary(dictionary: np.ndarray) -> np.ndarray:
    return POOL.intern(dictionary)
