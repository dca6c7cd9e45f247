"""Chunked columnar tables with per-chunk statistics.

The storage layer under TensorFrame (the paper's
conclusion names "in-memory data representation and dictionary
operations" as the biggest remaining optimization surface):

- every column is split into fixed-size **chunks** (default 64Ki rows);
- every chunk carries **zone-map statistics**: min/max over the chunk's
  comparable domain, a null count, and a distinct count (exact for
  in-memory builds, an estimate once persisted loaders round-trip it);
- every column carries one **encoding**, chosen by a cardinality-aware
  policy generalizing ``core.encoding``:

  * ``dict`` — low-cardinality strings: one *sorted, interned*
    dictionary per column (shared across all chunks and, through the
    process-wide pool, across tables), chunks hold dense int64 codes.
    Sorted dictionaries make codes order-isomorphic to the strings, so
    zone maps and range predicates work on codes directly.
  * ``rle``  — run-clustered numeric/date/bool columns: chunks hold
    (run values, run lengths).
  * ``plain`` — everything else: raw numpy payloads (high-cardinality
    strings stay object arrays; the frame layer offloads them).

Chunks may be *lazy*: a chunk constructed with a loader callback reads
its payload from disk on first access (the ``.tfb`` v2 path) and caches
it.  Zone maps are always eager — they live in the manifest — so scan
pruning never touches the payload of a skipped chunk.

No torch imports: ``repro_torch.store`` is a host-side layer and imports
without initializing any accelerator backend.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .pool import intern_dictionary

DEFAULT_CHUNK_ROWS = 1 << 16

#: column types; 'date' is int64 days since epoch, 'bool' is int64 0/1
CTYPES = ("int", "float", "date", "bool", "str")
ENCODINGS = ("plain", "dict", "rle")


@dataclasses.dataclass(frozen=True)
class ChunkStats:
    """Zone-map statistics of one chunk.

    ``vmin``/``vmax`` are over the chunk's *physical* domain — values
    for numeric columns, codes for dict columns (sorted dictionaries
    make code order == string order), raw strings for plain string
    columns.  ``None`` bounds mean the chunk is all-null (every
    predicate may skip it).  ``distinct`` counts distinct non-null
    physical values (exact when built in memory).
    """

    vmin: object
    vmax: object
    null_count: int
    distinct: int


class Chunk:
    """One chunk of one column: stats + (possibly lazy) payload.

    ``payload`` is the encoded representation: a values array (plain /
    dict codes) or a ``(values, run_lengths)`` pair (rle).  A lazy chunk
    holds a zero-arg ``loader`` instead and caches its result.

    ``validity`` is an optional row-aligned bool array (True = value
    present); ``None`` means every row is valid — except float columns,
    where NaN cells stay the legacy null encoding.  Validity makes
    int/date/bool/str nulls first-class in the store (they previously
    survived only as float NaN), so spilled engine intermediates
    round-trip losslessly.  ``vloader`` defers the validity read (the
    ``.tfb`` v2 ``<col>.valid`` file).
    """

    __slots__ = ("n", "stats", "_payload", "_loader", "_validity", "_vloader")

    def __init__(
        self,
        n: int,
        stats: ChunkStats,
        payload=None,
        loader: Optional[Callable[[], object]] = None,
        validity: Optional[np.ndarray] = None,
        vloader: Optional[Callable[[], np.ndarray]] = None,
    ):
        if (payload is None) == (loader is None):
            raise ValueError("chunk needs exactly one of payload/loader")
        self.n = int(n)
        self.stats = stats
        self._payload = payload
        self._loader = loader
        self._validity = validity
        self._vloader = vloader

    @property
    def loaded(self) -> bool:
        return self._payload is not None

    def payload(self):
        if self._payload is None:
            self._payload = self._loader()
        return self._payload

    def validity(self) -> Optional[np.ndarray]:
        """Row-aligned bool validity (None = all rows valid)."""
        if self._validity is None and self._vloader is not None:
            self._validity = self._vloader()
        return self._validity


class Column:
    """One column: ctype, encoding, optional interned dictionary, chunks.

    Persisted columns may pass loaders instead of eager data:
    ``dict_loader`` defers the dictionary read to first use, and
    ``bulk_loader`` (returning every chunk's payload from one
    sequential read) accelerates full-column materialization when no
    chunk has been touched yet.
    """

    def __init__(
        self,
        name: str,
        ctype: str,
        encoding: str,
        chunks: List[Chunk],
        dictionary: Optional[np.ndarray] = None,
        dict_loader: Optional[Callable[[], np.ndarray]] = None,
        bulk_loader: Optional[Callable[[], List[object]]] = None,
    ):
        if ctype not in CTYPES:
            raise ValueError(f"unknown ctype {ctype!r}")
        if encoding not in ENCODINGS:
            raise ValueError(f"unknown encoding {encoding!r}")
        if (encoding == "dict") != (
            dictionary is not None or dict_loader is not None
        ):
            raise ValueError("dictionary required iff encoding == 'dict'")
        self.name = name
        self.ctype = ctype
        self.encoding = encoding
        self.chunks = chunks
        self._dictionary = dictionary
        self._dict_loader = dict_loader
        self._bulk_loader = bulk_loader
        self._zones = None  # cached (mins, maxs) float64 zone arrays

    @property
    def dictionary(self) -> Optional[np.ndarray]:
        if self._dictionary is None and self._dict_loader is not None:
            self._dictionary = self._dict_loader()
        return self._dictionary

    @property
    def nrows(self) -> int:
        return sum(c.n for c in self.chunks)

    def zone_bounds(self):
        """(mins, maxs, exact) zone arrays over chunks, NaN = all-null.

        float64 arrays for vectorized pruning; ``exact`` is False when
        any bound exceeds float64's integer range (2**53), in which
        case callers must fall back to exact per-chunk checks.  Only
        for numeric-domain stats (everything but plain strings);
        cached.
        """
        if self._zones is None:
            nan = float("nan")
            mins = np.array(
                [nan if c.stats.vmin is None else float(c.stats.vmin)
                 for c in self.chunks],
                dtype=np.float64,
            )
            maxs = np.array(
                [nan if c.stats.vmax is None else float(c.stats.vmax)
                 for c in self.chunks],
                dtype=np.float64,
            )
            if self.ctype == "float":
                exact = True  # bounds were float64 to begin with
            else:
                finite = np.concatenate(
                    [mins[~np.isnan(mins)], maxs[~np.isnan(maxs)]]
                )
                exact = bool(np.all(np.abs(finite) < float(1 << 53)))
            self._zones = (mins, maxs, exact)
        return self._zones

    def uniqueness_from_stats(self):
        """(unique, distinct) provable from the chunk zone maps alone.

        ``unique=True`` when every chunk's non-null values are
        internally distinct (per-chunk distinct == non-null count) and
        the chunks' [vmin, vmax] ranges are pairwise disjoint — the
        layout of primary-key-ish and sorted columns; the total
        distinct count is then exact.  ``unique=False`` when some chunk
        provably holds a duplicate.  ``(None, None)`` when the zone
        maps cannot decide (overlapping chunk ranges).  Consumed by
        ``TensorFrame.from_store`` to seed the frame stats cache so
        ``join(algorithm="auto")`` skips its build-side sort test.
        """
        total = 0
        spans = []
        for c in self.chunks:
            nn = c.n - c.stats.null_count
            if nn == 0:
                continue
            if c.stats.distinct < nn:
                return False, None
            total += c.stats.distinct
            spans.append((c.stats.vmin, c.stats.vmax))
        spans.sort()
        for (_, a_hi), (b_lo, _) in zip(spans, spans[1:]):
            if b_lo <= a_hi:
                return None, None  # ranges overlap: zone maps can't prove
        return True, total

    def chunk_physical(self, i: int) -> np.ndarray:
        """Decoded *physical* values of chunk ``i`` (codes for dict)."""
        c = self.chunks[i]
        if self.encoding == "rle":
            values, runs = c.payload()
            return np.repeat(values, runs)
        return c.payload()

    def chunk_validity(self, i: int) -> Optional[np.ndarray]:
        """Row-aligned validity of chunk ``i`` (None = all valid)."""
        return self.chunks[i].validity()

    def has_validity(self) -> bool:
        """Does any chunk carry an explicit validity bitmap?

        Answered from the chunk objects (payload/validity stay on disk
        for lazy columns: persisted validity always pairs a vloader)."""
        return any(
            c._validity is not None or c._vloader is not None
            for c in self.chunks
        )

    def validity(self) -> Optional[np.ndarray]:
        """All chunks' validity, concatenated (None = no bitmaps)."""
        if not self.has_validity():
            return None
        parts = []
        for c in self.chunks:
            v = c.validity()
            parts.append(np.ones(c.n, dtype=bool) if v is None else v)
        return np.concatenate(parts) if parts else np.ones(0, dtype=bool)

    def ensure_loaded(self) -> None:
        """Populate every chunk's payload, preferring one sequential
        bulk read over per-chunk seeks when nothing is loaded yet."""
        if self._bulk_loader is not None and not any(
            c.loaded for c in self.chunks
        ):
            for c, payload in zip(self.chunks, self._bulk_loader()):
                c._payload = payload

    def physical(self) -> np.ndarray:
        """All chunks' physical values, concatenated."""
        self.ensure_loaded()
        parts = [self.chunk_physical(i) for i in range(len(self.chunks))]
        if not parts:
            return _empty_physical(self.ctype, self.encoding)
        return np.concatenate(parts)

    def decode(self, physical: np.ndarray) -> np.ndarray:
        """Physical values -> user-facing values."""
        if self.encoding == "dict":
            safe = np.clip(physical, 0, max(0, self.dictionary.shape[0] - 1))
            return self.dictionary[safe]
        if self.ctype == "date":
            return physical.astype("datetime64[D]")
        if self.ctype == "bool":
            return physical != 0
        return physical

    def values(self) -> np.ndarray:
        return self.decode(self.physical())


def _empty_physical(ctype: str, encoding: str) -> np.ndarray:
    if encoding == "dict" or ctype in ("int", "date", "bool"):
        return np.zeros((0,), dtype=np.int64)
    if ctype == "float":
        return np.zeros((0,), dtype=np.float64)
    return np.array([], dtype=object)


# ----------------------------------------------------------------------
# statistics + encoding policy
# ----------------------------------------------------------------------
def compute_stats(
    physical: np.ndarray, ctype: str, validity: Optional[np.ndarray] = None
) -> ChunkStats:
    """Zone-map stats of one chunk's physical values.

    Nulls are NaN in float columns (the engine's convention); other
    ctypes hold nulls through an explicit ``validity`` bitmap (True =
    present).  Stats cover the non-null values only.
    """
    n = physical.shape[0]
    if ctype == "float":
        mask = ~np.isnan(physical.astype(np.float64))
        if validity is not None:
            mask &= validity
        nn = physical[mask]
        nulls = n - int(mask.sum())
    elif validity is not None:
        nn = physical[validity]
        nulls = n - int(validity.sum())
    else:
        nn = physical
        nulls = 0
    if nn.shape[0] == 0:
        return ChunkStats(None, None, nulls, 0)
    if ctype == "str":  # plain strings: python-comparable min/max
        vmin, vmax = min(nn), max(nn)
        distinct = len(set(nn))
        return ChunkStats(str(vmin), str(vmax), nulls, distinct)
    vmin = nn.min()
    vmax = nn.max()
    distinct = int(np.unique(nn).shape[0])
    vmin = float(vmin) if ctype == "float" else int(vmin)
    vmax = float(vmax) if ctype == "float" else int(vmax)
    return ChunkStats(vmin, vmax, nulls, distinct)


def _run_count(arr: np.ndarray) -> int:
    if arr.shape[0] <= 1:
        return arr.shape[0]
    return int((arr[1:] != arr[:-1]).sum()) + 1


@dataclasses.dataclass(frozen=True)
class EncodingPolicy:
    """Cardinality-aware per-column encoding choice.

    Generalizes ``core.encoding``'s single dict-vs-offload threshold:

    - strings dict-encode when ``distinct/n <= dict_threshold`` (the
      paper's 50% default), else stay plain (the frame layer offloads
      them);
    - numeric/date/bool columns RLE-encode when the column's run count
      is at most ``rle_threshold`` of its rows (clustered/sorted data:
      dates in time-ordered fact tables, repeated foreign keys), else
      stay plain.  Floats never RLE (NaN runs compare False).
    """

    dict_threshold: float = 0.5
    rle_threshold: float = 0.5

    def choose(self, arr: np.ndarray, ctype: str) -> str:
        n = max(1, arr.shape[0])
        if ctype == "str":
            distinct = np.unique(arr).shape[0]
            return "dict" if distinct <= self.dict_threshold * n else "plain"
        if ctype == "float":
            return "plain"
        return "rle" if _run_count(arr) <= self.rle_threshold * n else "plain"


DEFAULT_POLICY = EncodingPolicy()


# ----------------------------------------------------------------------
# the table
# ----------------------------------------------------------------------
class Table:
    """A chunked columnar table (the store's unit of storage).

    All columns share one chunk grid: chunk ``i`` covers the same row
    range in every column, so a zone-map skip decision on one column
    drops the same rows from all of them (and a chunk is the natural
    shard unit for a sharded engine).
    """

    def __init__(self, columns: Dict[str, Column], nrows: int, chunk_rows: int):
        self.columns = columns
        self.nrows = int(nrows)
        self.chunk_rows = int(chunk_rows)

    # ---- construction ------------------------------------------------
    @staticmethod
    def from_arrays(
        data: Dict[str, np.ndarray],
        *,
        chunk_rows: int = DEFAULT_CHUNK_ROWS,
        policy: EncodingPolicy = DEFAULT_POLICY,
        encode: Optional[Dict[str, str]] = None,
        validity: Optional[Dict[str, np.ndarray]] = None,
    ) -> "Table":
        """Chunk + encode a dict of host arrays.

        ``encode`` forces an encoding per column name ('plain' | 'dict'
        | 'rle'), overriding the policy.  ``validity`` maps column name
        -> row-aligned bool array (True = present) for nullable non-
        float columns; null cells' payload values are kept verbatim
        (callers pass an in-domain sentinel), the bitmap is
        authoritative.
        """
        if chunk_rows <= 0:
            raise ValueError("chunk_rows must be positive")
        encode = encode or {}
        validity = validity or {}
        columns: Dict[str, Column] = {}
        n = None
        for name, arr in data.items():
            arr = np.asarray(arr)
            if n is None:
                n = arr.shape[0]
            elif arr.shape[0] != n:
                raise ValueError(f"column {name}: length {arr.shape[0]} != {n}")
            valid = validity.get(name)
            if valid is not None:
                valid = np.asarray(valid, dtype=bool)
                if valid.shape[0] != arr.shape[0]:
                    raise ValueError(f"column {name}: validity length mismatch")
                if bool(valid.all()):
                    valid = None  # all-valid bitmap: store nothing
            columns[name] = _build_column(
                name, arr, chunk_rows, policy, encode.get(name), valid
            )
        return Table(columns, 0 if n is None else n, chunk_rows)

    # ---- introspection -----------------------------------------------
    @property
    def column_names(self) -> List[str]:
        return list(self.columns)

    def column(self, name: str) -> Column:
        try:
            return self.columns[name]
        except KeyError:
            raise KeyError(
                f"no column {name!r}; have {self.column_names}"
            ) from None

    @property
    def n_chunks(self) -> int:
        if not self.columns:
            return 0
        return len(next(iter(self.columns.values())).chunks)

    def schema(self) -> Dict[str, str]:
        return {name: c.ctype for name, c in self.columns.items()}

    def to_arrays(
        self, columns: Optional[Sequence[str]] = None
    ) -> Dict[str, np.ndarray]:
        """Full decode to host arrays (dates back to datetime64)."""
        names = list(columns) if columns is not None else self.column_names
        return {name: self.column(name).values() for name in names}

    def stats(self, name: str) -> List[ChunkStats]:
        return [c.stats for c in self.column(name).chunks]

    def memory_bytes(self) -> int:
        """Bytes of every *loaded* payload (lazy chunks count 0)."""
        total = 0
        for col in self.columns.values():
            if col._dictionary is not None:  # loaded dictionaries only
                total += sum(
                    len(str(s).encode()) + 8 for s in col._dictionary
                )
            for c in col.chunks:
                if not c.loaded:
                    continue
                p = c.payload()
                parts = p if isinstance(p, tuple) else (p,)
                for a in parts:
                    if a.dtype == object:
                        total += sum(len(str(s).encode()) + 8 for s in a)
                    else:
                        total += a.nbytes
        return total

    def __repr__(self) -> str:
        cols = ", ".join(
            f"{name}:{c.ctype}/{c.encoding}" for name, c in self.columns.items()
        )
        return (
            f"store.Table({self.nrows} rows x {self.n_chunks} chunks; {cols})"
        )


# ----------------------------------------------------------------------
# column construction
# ----------------------------------------------------------------------
def _normalize(arr: np.ndarray) -> Tuple[np.ndarray, str]:
    """Host array -> (physical int64/float64/object array, ctype)."""
    if np.issubdtype(arr.dtype, np.datetime64):
        return arr.astype("datetime64[D]").astype(np.int64), "date"
    if arr.dtype == np.bool_:
        return arr.astype(np.int64), "bool"
    if np.issubdtype(arr.dtype, np.integer):
        return arr.astype(np.int64), "int"
    if np.issubdtype(arr.dtype, np.floating):
        return arr.astype(np.float64), "float"
    if arr.dtype.kind in ("U", "S", "O"):
        arr = arr.astype(object)
        if any(not isinstance(x, str) for x in arr):
            # match the v1 tfb writer: object cells stringify (None ->
            # "None") — mixed None/str arrays would otherwise crash the
            # sort-based encoders
            arr = np.array([str(x) for x in arr], dtype=object)
        return arr, "str"
    raise TypeError(f"unsupported dtype {arr.dtype}")


def _factorize_sorted(values: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    dictionary, codes = np.unique(values, return_inverse=True)
    return codes.astype(np.int64).reshape(values.shape), dictionary


def _build_column(
    name: str,
    arr: np.ndarray,
    chunk_rows: int,
    policy: EncodingPolicy,
    forced: Optional[str],
    valid: Optional[np.ndarray] = None,
) -> Column:
    phys, ctype = _normalize(arr)
    encoding = forced if forced is not None else policy.choose(phys, ctype)
    if encoding == "dict" and ctype != "str":
        raise ValueError(f"column {name}: dict encoding is for strings")
    if encoding == "rle" and ctype in ("str", "float"):
        raise ValueError(f"column {name}: rle is for int/date/bool columns")

    dictionary = None
    stats_ctype = ctype
    if encoding == "dict":
        codes, dictionary = _factorize_sorted(phys)
        dictionary = intern_dictionary(dictionary)
        phys, stats_ctype = codes, "int"  # zone maps over codes

    chunks: List[Chunk] = []
    for lo in range(0, max(phys.shape[0], 1), chunk_rows):
        part = phys[lo: lo + chunk_rows]
        if part.shape[0] == 0 and phys.shape[0] != 0:
            break
        vpart = None
        if valid is not None:
            vpart = valid[lo: lo + chunk_rows]
            if bool(vpart.all()):
                vpart = None  # chunk without nulls: no bitmap
        stats = compute_stats(part, stats_ctype, vpart)
        if encoding == "rle":
            payload = _rle_encode(part)
        else:
            payload = part
        chunks.append(
            Chunk(part.shape[0], stats, payload=payload, validity=vpart)
        )
        if phys.shape[0] == 0:
            break
    return Column(name, ctype, encoding, chunks, dictionary)


def _rle_encode(part: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    n = part.shape[0]
    if n == 0:
        return part, np.zeros((0,), dtype=np.int64)
    starts = np.empty(n, dtype=bool)
    starts[0] = True
    np.not_equal(part[1:], part[:-1], out=starts[1:])
    idx = np.nonzero(starts)[0]
    values = part[idx]
    runs = np.diff(np.append(idx, n)).astype(np.int64)
    return values, runs
