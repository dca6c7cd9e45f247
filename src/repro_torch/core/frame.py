"""TensorFrame: the paper's tensor-backed dataframe, on PyTorch.

Representation (paper §III, Fig. 3):

- ``itensor``: one 2-D int64 tensor holding ALL integer-like columns —
  raw ints, dates (days since epoch), bools (0/1) and the dense
  dictionary codes of low-cardinality non-numeric columns.
- ``ftensor``: one 2-D float tensor holding all measures.
- high-cardinality non-numeric columns are *offloaded*
  (``OffloadedColumn``): the physical host array never moves; a device
  row indexer maps logical rows to physical positions, so relational
  ops only update the indexer (paper §III-f).
- ``columns``: the column indexer — an ordered map from logical column
  name to its physical (tensor, slot) location.

Every tensor of a frame lives on one device (``TensorFrame.device``);
derived frames stay on their inputs' device.

Late materialization: row-subsetting ops do not copy the tensors.  A
frame may instead carry a ``RowView`` — a list of ``ViewBlock`` s, each
pairing base (itensor, ftensor) payloads with a row-index *selection
vector* — and every ``ColumnMeta`` names the block it lives in.
``take``/``mask_rows``/``filter``/``sort`` compose the selection vectors
and joins stack blocks from both sides, so a join chain performs **one**
payload gather per base table when ``materialize()`` fires at a pipeline
exit.  Column accessors gather single columns through the view without
materializing the rest.

Null semantics: nullable columns carry a hidden companion column
``__v__<name>`` (0/1 in the int tensor) that flows through every
relational op like any other column.

Stats cache: each frame carries ``_stats`` — per-column(-combination)
distinct counts, provable-uniqueness flags and value bounds
(``ColStats``), populated by ``GroupBy``, ``distinct`` and joins, and
consulted by ``join(algorithm="auto")``.

Tensors are never updated in place once a frame holds them: column
accessors return views into the payload.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .config import CONFIG, resolve_device
from . import encoding

INT = torch.int64
# Sentinel stored in int/code slots of null cells (the hidden validity
# column is authoritative; the sentinel just keeps gathers in-range).
INT_NULL = np.int64(-1)

VALID_PREFIX = "__v__"


def _valid_name(name: str) -> str:
    return VALID_PREFIX + name


def _is_hidden(name: str) -> bool:
    return name.startswith(VALID_PREFIX)


def float_dtype() -> torch.dtype:
    return getattr(torch, CONFIG.float_dtype)


def host(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as a host numpy array."""
    return t.detach().cpu().numpy()


@dataclasses.dataclass
class ColumnMeta:
    """Logical column → physical storage mapping (the column indexer).

    ``block`` names the ``RowView`` block holding the column's payload
    (always 0 for materialized frames).
    """

    name: str
    kind: str  # 'int' | 'float' | 'bool' | 'date' | 'dict' | 'obj'
    slot: int  # slot in itensor (int-like kinds) or ftensor ('float'); -1 for 'obj'
    dictionary: Optional[np.ndarray] = None  # sorted uniques for 'dict'
    block: int = 0  # RowView block index (0 when the frame is eager)

    def is_int_like(self) -> bool:
        return self.kind in ("int", "bool", "date", "dict")


@dataclasses.dataclass
class ColStats:
    """Cached per-column(-combination) statistics for algorithm picks.

    ``unique=True`` is a correctness-grade guarantee (the values — as a
    tuple, for multi-column keys — are pairwise distinct over the
    frame's rows); ``unique=False`` is a perf hint only.  ``distinct``
    is the exact non-null distinct count when known.  ``vmin``/``vmax``
    bound an int-like column's values, possibly over a *superset* of the
    rows (row subsetting and join gathers only shrink the true range).
    """

    unique: Optional[bool] = None
    distinct: Optional[int] = None
    vmin: Optional[int] = None
    vmax: Optional[int] = None


class ViewBlock:
    """One late-materialization source: base payload tensors + the id
    of its selection vector in the owning view's row matrix.
    ``row_id=None`` means identity (the base tensors are already
    aligned with the frame's logical rows)."""

    __slots__ = ("itensor", "ftensor", "row_id")

    def __init__(self, itensor, ftensor, row_id: Optional[int]):
        self.itensor = itensor
        self.ftensor = ftensor
        self.row_id = row_id


class RowView:
    """The selection-vector representation.

    ``blocks`` are the payload sources; ``rowmat`` is ONE stacked
    ``(R, nrows)`` int64 matrix holding every block's selection vector
    as a row, so ``take`` composes the whole view with a single 2-D
    gather (``rowmat[:, rows]``).
    """

    __slots__ = ("blocks", "rowmat", "_row_cache")

    def __init__(self, blocks: List[ViewBlock], rowmat: Optional[torch.Tensor]):
        self.blocks = blocks
        self.rowmat = rowmat
        self._row_cache: Dict[int, torch.Tensor] = {}

    def rows_of(self, block: ViewBlock) -> Optional[torch.Tensor]:
        rid = block.row_id
        if rid is None:
            return None
        if rid not in self._row_cache:
            self._row_cache[rid] = self.rowmat[rid]
        return self._row_cache[rid]


class OffloadedColumn:
    """High-cardinality non-numeric column, offloaded from the tensor.

    ``values`` is the immutable physical host array; ``idx`` is an int64
    row indexer (logical row -> physical position) on the frame's
    device.  Factorized codes and packed byte tensors are cached on the
    *physical* array so filtered/joined views share them.
    """

    def __init__(self, values: np.ndarray, idx: torch.Tensor, _cache: Optional[dict] = None):
        self.values = values
        self.idx = idx
        # cache shared across views of the same physical array
        self._cache = _cache if _cache is not None else {}

    @property
    def nrows(self) -> int:
        return int(self.idx.shape[0])

    def take(self, rows: torch.Tensor) -> "OffloadedColumn":
        return OffloadedColumn(self.values, self.idx[rows], self._cache)

    def materialize(self) -> np.ndarray:
        return self.values[host(self.idx)]

    def phys_factorize(self) -> Tuple[np.ndarray, np.ndarray]:
        """(codes over physical rows, sorted dictionary), cached."""
        if "fact" not in self._cache:
            self._cache["fact"] = encoding.factorize(self.values)
        return self._cache["fact"]

    def codes(self) -> Tuple[torch.Tensor, np.ndarray]:
        """Dense codes aligned with *logical* rows + dictionary."""
        phys_codes, dictionary = self.phys_factorize()
        key = ("dev_codes", self.idx.device)
        if key not in self._cache:
            self._cache[key] = torch.as_tensor(phys_codes, dtype=INT, device=self.idx.device)
        return self._cache[key][self.idx], dictionary

    def packed(self):
        """Packed (n_phys, L) uint8 byte tensor + int32 lengths, cached."""
        from . import strings  # local import to avoid cycle

        key = ("packed", self.idx.device)
        if key not in self._cache:
            self._cache[key] = strings.pack_strings(self.values, None, self.idx.device)
        return self._cache[key]


def _offload(arr: np.ndarray, device, fact=None) -> OffloadedColumn:
    """``arr`` offloaded with an identity row indexer on ``device``;
    ``fact`` is its (codes, dictionary) when already factorized."""
    cache = {} if fact is None else {"fact": fact}
    return OffloadedColumn(arr, torch.arange(arr.shape[0], dtype=INT, device=device), cache)


def _empty_tensor(n: int, dtype, device) -> torch.Tensor:
    return torch.zeros((n, 0), dtype=dtype, device=device)


def _assemble_frame(
    int_cols: List[Tuple[str, np.ndarray, str, Optional[np.ndarray]]],
    float_cols: List[Tuple[str, np.ndarray]],
    offloaded: Dict[str, "OffloadedColumn"],
    order: List[str],
    n: int,
    device: torch.device,
) -> "TensorFrame":
    """Stack encoded host columns into the two device tensors."""
    columns: Dict[str, ColumnMeta] = {}
    islots = {name: i for i, (name, _, _, _) in enumerate(int_cols)}
    fslots = {name: i for i, (name, _) in enumerate(float_cols)}
    itensor = (
        torch.as_tensor(np.column_stack([c[1] for c in int_cols]).astype(np.int64), device=device)
        if int_cols
        else _empty_tensor(n, INT, device)
    )
    ftensor = (
        torch.as_tensor(
            np.column_stack([c[1] for c in float_cols]).astype(np.dtype(CONFIG.float_dtype)),
            device=device,
        )
        if float_cols
        else _empty_tensor(n, float_dtype(), device)
    )
    imeta = {name: (kind, dic) for name, _, kind, dic in int_cols}
    for name in order:
        if name in islots:
            kind, dic = imeta[name]
            columns[name] = ColumnMeta(name, kind, islots[name], dic)
        elif name in fslots:
            columns[name] = ColumnMeta(name, "float", fslots[name])
        else:
            columns[name] = ColumnMeta(name, "obj", -1)
    return TensorFrame(itensor, ftensor, columns, offloaded, n)


class TensorFrame:
    def __init__(
        self,
        itensor: Optional[torch.Tensor],
        ftensor: Optional[torch.Tensor],
        columns: Dict[str, ColumnMeta],
        offloaded: Dict[str, OffloadedColumn],
        nrows: int,
        view: Optional[RowView] = None,
    ):
        self._itensor = itensor
        self._ftensor = ftensor
        self.columns = columns
        self.offloaded = offloaded
        self.nrows = int(nrows)
        self._view = view
        self._stats: Dict[Tuple[str, ...], ColStats] = {}

    @classmethod
    def _from_view(
        cls,
        columns: Dict[str, ColumnMeta],
        offloaded: Dict[str, OffloadedColumn],
        nrows: int,
        blocks: List[ViewBlock],
        rowmat: Optional[torch.Tensor],
    ) -> "TensorFrame":
        return cls(None, None, columns, offloaded, nrows, RowView(blocks, rowmat))

    @property
    def device(self) -> torch.device:
        if self._view is not None:
            return self._view.blocks[0].itensor.device
        return self._itensor.device

    # ------------------------------------------------------------------
    # late materialization
    # ------------------------------------------------------------------
    @property
    def is_view(self) -> bool:
        return self._view is not None

    def _view_parts(self) -> Tuple[List[ViewBlock], Optional[torch.Tensor]]:
        """(blocks, rowmat) — identity block for an eager frame; the
        join's zero-copy stacking input."""
        if self._view is not None:
            return self._view.blocks, self._view.rowmat
        return [ViewBlock(self._itensor, self._ftensor, None)], None

    def materialize(self) -> "TensorFrame":
        """Resolve the view: ONE fused 2-D gather per (block, tensor) of
        exactly the live slots, then a single horizontal concat.
        In-place (caching) — logical content is unchanged.  Returns
        ``self`` for chaining."""
        if self._view is None:
            return self
        blocks = self._view.blocks
        device = self.device
        # live slots per block, in column order (dead columns from
        # select()/projection pruning are never gathered)
        per_int: List[List[int]] = [[] for _ in blocks]
        per_float: List[List[int]] = [[] for _ in blocks]
        within: Dict[str, int] = {}
        for name, m in self.columns.items():
            if m.kind == "obj":
                continue
            lst = per_float[m.block] if m.kind == "float" else per_int[m.block]
            if m.slot in lst:  # two logical columns sharing a payload
                within[name] = lst.index(m.slot)
            else:
                within[name] = len(lst)
                lst.append(m.slot)

        def _gather(tensor: torch.Tensor, slots: List[int], rows) -> torch.Tensor:
            # whole-tensor row gather when every slot is live in order
            # (the common join-chain case); otherwise slice the live
            # columns, then gather rows
            full = slots == list(range(tensor.shape[1]))
            sub = tensor if full else tensor[:, slots]
            return sub if rows is None else sub[rows]

        iparts: List[torch.Tensor] = []
        fparts: List[torch.Tensor] = []
        ioffs: List[int] = []
        foffs: List[int] = []
        ioff = foff = 0
        for b, isl, fsl in zip(blocks, per_int, per_float):
            ioffs.append(ioff)
            foffs.append(foff)
            rows = self._view.rows_of(b)
            if isl:
                iparts.append(_gather(b.itensor, isl, rows))
                ioff += len(isl)
            if fsl:
                fparts.append(_gather(b.ftensor, fsl, rows))
                foff += len(fsl)
        self._itensor = (
            torch.cat(iparts, dim=1)
            if len(iparts) > 1
            else (iparts[0] if iparts else _empty_tensor(self.nrows, INT, device))
        )
        self._ftensor = (
            torch.cat(fparts, dim=1)
            if len(fparts) > 1
            else (fparts[0] if fparts else _empty_tensor(self.nrows, float_dtype(), device))
        )
        newcols: Dict[str, ColumnMeta] = {}
        for name, m in self.columns.items():  # original order preserved
            if m.kind == "obj":
                newcols[name] = dataclasses.replace(m, block=0)
                continue
            base = foffs[m.block] if m.kind == "float" else ioffs[m.block]
            newcols[name] = dataclasses.replace(m, slot=base + within[name], block=0)
        self.columns = newcols
        self._view = None
        return self

    @property
    def itensor(self) -> torch.Tensor:
        if self._view is not None:
            self.materialize()
        return self._itensor

    @property
    def ftensor(self) -> torch.Tensor:
        if self._view is not None:
            self.materialize()
        return self._ftensor

    # ------------------------------------------------------------------
    # stats cache
    # ------------------------------------------------------------------
    @staticmethod
    def _stats_key(cols: Sequence[str]) -> Tuple[str, ...]:
        return tuple(sorted(cols))

    def set_stats(
        self,
        cols: Union[str, Sequence[str]],
        *,
        unique: Optional[bool] = None,
        distinct: Optional[int] = None,
        vmin: Optional[int] = None,
        vmax: Optional[int] = None,
    ) -> None:
        key = self._stats_key([cols] if isinstance(cols, str) else cols)
        st = self._stats.setdefault(key, ColStats())
        if unique is not None:
            st.unique = unique
        if distinct is not None:
            st.distinct = distinct
        if vmin is not None:
            st.vmin = vmin
        if vmax is not None:
            st.vmax = vmax

    def col_stats(self, cols: Union[str, Sequence[str]]) -> Optional[ColStats]:
        key = self._stats_key([cols] if isinstance(cols, str) else cols)
        return self._stats.get(key)

    def int_bounds(self, name: str) -> Tuple[int, int]:
        """(lo, hi) bounds of a (non-empty) int-like column, from the
        stats cache when possible, else ONE fused device fetch (cached).
        Bounds may cover a superset of the rows."""
        st = self.col_stats(name)
        if st is not None and st.vmin is not None:
            return int(st.vmin), int(st.vmax)
        arr = self.col_values(name)
        lo, hi = torch.stack([arr.min(), arr.max()]).tolist()
        self.set_stats(name, vmin=lo, vmax=hi)
        return lo, hi

    def unique_hint(self, cols: Sequence[str]) -> Optional[bool]:
        """Is the column combination provably unique (/ non-unique)?
        ``True`` is correctness-grade; ``False`` is a perf hint; ``None``
        means unknown.  Any single unique member makes the combination
        unique."""
        st = self._stats.get(self._stats_key(cols))
        if st is not None and st.unique is not None:
            return st.unique
        for c in cols:
            s1 = self._stats.get((c,))
            if s1 is not None and s1.unique:
                return True
        return None

    def _drop_stats_mentioning(self, name: str) -> None:
        """Invalidate every cached stat involving ``name``."""
        self._stats = {k: v for k, v in self._stats.items() if name not in k}

    def _inherit_stats(
        self,
        child: "TensorFrame",
        mode: str,
        mapping: Optional[Dict[str, str]] = None,
    ) -> None:
        """Propagate stats onto ``child``: 'permutation' and 'columns'
        keep everything, 'subset' keeps unique flags and value bounds,
        'bounds' keeps only value bounds (rows may repeat).  Entries
        whose columns do not all survive are dropped; ``mapping``
        renames columns."""
        for key, st in self._stats.items():
            cols = [mapping.get(c, c) for c in key] if mapping else list(key)
            if not all(c in child.columns for c in cols):
                continue
            if mode == "permutation" or mode == "columns":
                new = dataclasses.replace(st)
            elif mode == "subset":
                if st.unique is None and st.vmin is None:
                    continue
                new = ColStats(unique=st.unique, vmin=st.vmin, vmax=st.vmax)
            elif mode == "bounds":
                if st.vmin is None:
                    continue
                new = ColStats(vmin=st.vmin, vmax=st.vmax)
            else:
                raise ValueError(mode)
            child._stats[child._stats_key(cols)] = new

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    @staticmethod
    def from_arrays(
        data: Dict[str, np.ndarray],
        *,
        card_threshold: Optional[float] = None,
        encode: Optional[Dict[str, str]] = None,
        device=None,
    ) -> "TensorFrame":
        """Build a frame from host numpy arrays on ``device`` (default
        ``CONFIG.device``; raises when that is CUDA and no card is
        visible).

        ``encode`` optionally forces 'dict' or 'obj' per column name,
        overriding the cardinality policy.
        """
        dev = resolve_device(device)
        threshold = CONFIG.card_threshold if card_threshold is None else card_threshold
        encode = encode or {}
        int_cols: List[Tuple[str, np.ndarray, str, Optional[np.ndarray]]] = []
        float_cols: List[Tuple[str, np.ndarray]] = []
        offloaded: Dict[str, OffloadedColumn] = {}
        order: List[str] = []
        n = None

        for name, arr in data.items():
            arr = np.asarray(arr)
            if n is None:
                n = arr.shape[0]
            elif arr.shape[0] != n:
                raise ValueError(f"column {name}: length {arr.shape[0]} != {n}")
            order.append(name)
            if np.issubdtype(arr.dtype, np.datetime64):
                days = arr.astype("datetime64[D]").astype(np.int64)
                int_cols.append((name, days, "date", None))
            elif arr.dtype == np.bool_:
                int_cols.append((name, arr.astype(np.int64), "bool", None))
            elif np.issubdtype(arr.dtype, np.integer):
                int_cols.append((name, arr.astype(np.int64), "int", None))
            elif np.issubdtype(arr.dtype, np.floating):
                float_cols.append((name, arr))
            elif encoding.is_string_like(arr):
                forced = encode.get(name)
                if forced == "obj":
                    offloaded[name] = _offload(arr, dev)
                    continue
                codes, dictionary = encoding.factorize(arr)
                if forced == "dict" or dictionary.shape[0] <= threshold * max(1, n):
                    int_cols.append((name, codes, "dict", dictionary))
                else:
                    # keep the factorization: the offloaded column's
                    # codes() would compute exactly this again
                    offloaded[name] = _offload(arr, dev, (codes, dictionary))
            else:
                raise TypeError(f"column {name}: unsupported dtype {arr.dtype}")
        n = 0 if n is None else n
        return _assemble_frame(int_cols, float_cols, offloaded, order, n, dev)

    @staticmethod
    def from_store(
        table,
        columns: Optional[Sequence[str]] = None,
        predicates: Sequence = (),
        *,
        card_threshold: Optional[float] = None,
        encode: Optional[Dict[str, str]] = None,
        result=None,
        device=None,
    ) -> "TensorFrame":
        """Materialize a frame on ``device`` (default ``CONFIG.device``)
        from a ``repro_torch.store`` chunked table.

        ``predicates`` are sargable store conjuncts
        (``repro_torch.store.Pred``): zone maps skip whole chunks and the
        survivors are row-filtered host-side, so only matching rows ever
        reach the device tensors (scan pushdown).  Dictionary columns
        keep the store's *interned* dictionary — no re-factorization, and
        frames built from the same store share dictionary objects, making
        join-time dictionary merges identity operations.  Validity
        bitmaps become hidden ``__v__`` columns.

        Zone-map statistics thread through: columns the chunk stats prove
        unique (or duplicate-bearing) seed the frame's stats cache, so
        downstream ``join(algorithm="auto")`` picks its build strategy
        without sorting the build side.

        ``result`` short-circuits the scan with a precomputed
        ``store.ScanResult`` for exactly these columns/predicates.
        """
        from .. import store as _store

        dev = resolve_device(device)
        if result is None:
            result = _store.scan(table, columns, list(predicates))
        threshold = CONFIG.card_threshold if card_threshold is None else card_threshold
        encode = encode or {}
        n = result.nrows
        int_cols: List[Tuple[str, np.ndarray, str, Optional[np.ndarray]]] = []
        float_cols: List[Tuple[str, np.ndarray]] = []
        offloaded: Dict[str, OffloadedColumn] = {}
        order: List[str] = []

        for name, mc in result.columns.items():
            order.append(name)
            forced = encode.get(name)
            if mc.dictionary is not None:
                if forced == "obj":
                    safe = np.clip(mc.values, 0, max(0, mc.dictionary.shape[0] - 1))
                    offloaded[name] = _offload(mc.dictionary[safe], dev)
                else:
                    int_cols.append((name, mc.values, "dict", mc.dictionary))
            elif mc.ctype == "float":
                float_cols.append((name, mc.values))
            elif mc.ctype == "str":
                # plain (high-cardinality) strings: the policy of
                # from_arrays — dict-encode below the threshold, offload
                # above it
                if forced == "obj":
                    offloaded[name] = _offload(mc.values, dev)
                    continue
                codes, dictionary = encoding.factorize(mc.values)
                if forced == "dict" or dictionary.shape[0] <= threshold * max(1, n):
                    int_cols.append((name, codes, "dict", dictionary))
                else:
                    offloaded[name] = _offload(mc.values, dev, (codes, dictionary))
            else:  # int / date / bool days already in physical form
                int_cols.append((name, mc.values, mc.ctype, None))
        # explicit store validity bitmaps become the engine's hidden
        # __v__ companion columns (float nulls stay NaN-encoded)
        for name, mc in result.columns.items():
            if mc.validity is not None and not bool(mc.validity.all()):
                vname = _valid_name(name)
                order.append(vname)
                int_cols.append((vname, mc.validity.astype(np.int64), "bool", None))
        out = _assemble_frame(int_cols, float_cols, offloaded, order, n, dev)
        # thread zone-map uniqueness/distinct/bounds stats into the frame
        # so joins and group-bys skip their probing work
        unfiltered = not predicates and n == table.nrows
        for name in order:
            if name not in table.columns:
                continue
            col = table.columns[name]
            if col.ctype == "float":
                continue
            unique, distinct = col.uniqueness_from_stats()
            if unique is True:
                # uniqueness survives any row filtering (subset)
                out.set_stats(name, unique=True, distinct=distinct if unfiltered else None)
            elif unique is False and unfiltered:
                out.set_stats(name, unique=False, distinct=distinct)
            if n and col.ctype in ("int", "date", "bool") and col.encoding != "dict":
                mins, maxs, exact = col.zone_bounds()
                if exact and not np.isnan(mins).all():
                    out.set_stats(name, vmin=int(np.nanmin(mins)), vmax=int(np.nanmax(maxs)))
        return out

    @staticmethod
    def from_state(state: dict, device=None) -> "TensorFrame":
        """Rebuild a frame from its eager host representation (the
        ``to_state`` layout): exact tensors, metas, dictionaries,
        offloaded values with their row indexers, validity columns
        (ordinary ``__v__`` columns) and stats."""
        dev = resolve_device(device)
        n = int(state["nrows"])
        # both payloads are 2-D (n, k), k possibly 0; copied, so the frame
        # never shares (possibly read-only) host buffers with the caller
        itensor = torch.as_tensor(np.array(state["itensor"], dtype=np.int64), device=dev)
        ftensor = torch.as_tensor(np.array(state["ftensor"]), device=dev)
        columns = {
            name: ColumnMeta(name, kind, int(slot), dictionary)
            for name, kind, slot, dictionary in state["columns"]
        }
        offloaded = {
            name: OffloadedColumn(
                values, torch.as_tensor(np.array(idx, dtype=np.int64), device=dev)
            )
            for name, (values, idx) in state["offloaded"].items()
        }
        out = TensorFrame(itensor, ftensor, columns, offloaded, n)
        for key, st in state.get("stats", {}).items():
            out._stats[tuple(key)] = ColStats(**st)
        return out

    def to_state(self) -> dict:
        """The frame's eager representation as host numpy (materializes)."""
        self.materialize()
        return {
            "nrows": self.nrows,
            "itensor": host(self._itensor),
            "ftensor": host(self._ftensor),
            "columns": [(m.name, m.kind, m.slot, m.dictionary) for m in self.columns.values()],
            "offloaded": {
                name: (oc.values, host(oc.idx)) for name, oc in self.offloaded.items()
            },
            "stats": {key: dataclasses.asdict(st) for key, st in self._stats.items()},
        }

    # ------------------------------------------------------------------
    # basic introspection
    # ------------------------------------------------------------------
    @property
    def column_names(self) -> List[str]:
        return [c for c in self.columns if not _is_hidden(c)]

    def meta(self, name: str) -> ColumnMeta:
        try:
            return self.columns[name]
        except KeyError:
            raise KeyError(f"no column {name!r}; have {self.column_names}") from None

    def has_column(self, name: str) -> bool:
        return name in self.columns

    def has_nulls(self, name: str) -> bool:
        return _valid_name(name) in self.columns

    def valid_array(self, name: str) -> Optional[torch.Tensor]:
        vn = _valid_name(name)
        if vn in self.columns:
            return self.col_values(vn) != 0
        return None

    # ------------------------------------------------------------------
    # column access
    # ------------------------------------------------------------------
    def _raw_values(self, m: ColumnMeta) -> torch.Tensor:
        """Payload of one non-obj column, gathered through the view when
        lazy (a single-column gather — no materialization)."""
        if self._view is not None:
            b = self._view.blocks[m.block]
            arr = (b.ftensor if m.kind == "float" else b.itensor)[:, m.slot]
            rows = self._view.rows_of(b)
            return arr if rows is None else arr[rows]
        t = self._ftensor if m.kind == "float" else self._itensor
        return t[:, m.slot]

    def col_values(self, name: str) -> torch.Tensor:
        """Device numeric representation (codes for dict columns)."""
        m = self.meta(name)
        if m.kind == "obj":
            codes, _ = self.offloaded[name].codes()
            return codes
        return self._raw_values(m)

    def col_codes(self, name: str) -> Tuple[torch.Tensor, np.ndarray]:
        """(codes, dictionary) for any string-typed column."""
        m = self.meta(name)
        if m.kind == "dict":
            return self._raw_values(m), m.dictionary
        if m.kind == "obj":
            return self.offloaded[name].codes()
        raise TypeError(f"column {name} is not string-typed (kind={m.kind})")

    def column(self, name: str) -> np.ndarray:
        """Decode a column back to host numpy (a pipeline exit: gathers
        exactly this column through the view)."""
        m = self.meta(name)
        valid = self.valid_array(name)
        if valid is not None:
            valid = host(valid)
        if m.kind == "obj":
            out = self.offloaded[name].materialize()
            if valid is not None:
                out = out.astype(object)
                out[~valid] = None
            return out
        if m.kind == "float":
            out = host(self._raw_values(m))
            if valid is not None:
                out = out.copy()
                out[~valid] = np.nan
            return out
        raw = host(self._raw_values(m))
        if m.kind == "dict":
            if m.dictionary.shape[0] == 0:
                # empty dictionary (e.g. null rows stitched against an
                # empty build side): every cell is null
                return np.full(raw.shape, None, dtype=object)
            safe = np.clip(raw, 0, m.dictionary.shape[0] - 1)
            out = m.dictionary[safe].astype(object)
            if valid is not None:
                out[~valid] = None
            elif (raw < 0).any():
                out[raw < 0] = None
            return out
        if m.kind == "date":
            return raw.astype("datetime64[D]")
        if m.kind == "bool":
            return raw != 0
        return raw

    def to_dict(self) -> Dict[str, np.ndarray]:
        return {name: self.column(name) for name in self.column_names}

    def __len__(self) -> int:
        return self.nrows

    # ------------------------------------------------------------------
    # row ops
    # ------------------------------------------------------------------
    def take(
        self,
        rows: Union[torch.Tensor, np.ndarray],
        *,
        stats: str = "none",
    ) -> "TensorFrame":
        """Select rows by index.

        Late-materializing by default: the result is a ``RowView`` frame
        whose blocks compose ``rows`` into their selection vectors.

        ``stats`` declares what the caller knows about ``rows``:
        'permutation' (every row exactly once), 'subset' (no row more
        than once), 'none' (may repeat rows — drop all cached stats).
        """
        dev = self.device
        rows = torch.as_tensor(rows, dtype=INT, device=dev)
        n = int(rows.shape[0])
        off = {k: v.take(rows) for k, v in self.offloaded.items()}
        if CONFIG.late_materialization:
            v = self._view
            if v is None:
                blocks = [ViewBlock(self._itensor, self._ftensor, 0)]
                rowmat = rows[None, :]
            else:
                # compose EVERY block's selection vector in one 2-D
                # gather; identity blocks share one new vector (= rows)
                mats = []
                ident_id: Optional[int] = None
                if v.rowmat is not None:
                    mats.append(v.rowmat[:, rows])
                if any(b.row_id is None for b in v.blocks):
                    ident_id = 0 if v.rowmat is None else int(v.rowmat.shape[0])
                    mats.append(rows[None, :])
                rowmat = mats[0] if len(mats) == 1 else torch.cat(mats, dim=0)
                blocks = [
                    ViewBlock(b.itensor, b.ftensor, ident_id if b.row_id is None else b.row_id)
                    for b in v.blocks
                ]
            out = TensorFrame._from_view(dict(self.columns), off, n, blocks, rowmat)
        else:
            it = self.itensor[rows] if self.itensor.shape[1] else _empty_tensor(n, INT, dev)
            ft = (
                self.ftensor[rows]
                if self.ftensor.shape[1]
                else _empty_tensor(n, float_dtype(), dev)
            )
            out = TensorFrame(it, ft, dict(self.columns), off, n)
        if stats in ("permutation", "subset"):
            self._inherit_stats(out, stats)
        return out

    def head(self, n: int) -> "TensorFrame":
        n = min(n, self.nrows)
        return self.take(torch.arange(n, dtype=INT, device=self.device), stats="subset")

    def mask_rows(self, mask: torch.Tensor) -> "TensorFrame":
        """Compact rows where mask is True (one host sync for the count;
        the payload gather is deferred behind the view)."""
        mask = torch.as_tensor(mask, device=self.device)
        idx = torch.nonzero(mask).reshape(-1)
        return self.take(idx, stats="subset")

    def filter(self, expr) -> "TensorFrame":
        from .expr import Expr

        if isinstance(expr, Expr):
            mask = expr.eval_bool(self)
        else:
            mask = torch.as_tensor(expr, device=self.device)
        return self.mask_rows(mask)

    # ------------------------------------------------------------------
    # column ops
    # ------------------------------------------------------------------
    def select(self, names: Sequence[str]) -> "TensorFrame":
        cols: Dict[str, ColumnMeta] = {}
        off: Dict[str, OffloadedColumn] = {}
        for name in names:
            m = self.meta(name)
            cols[name] = m
            if m.kind == "obj":
                off[name] = self.offloaded[name]
            vn = _valid_name(name)
            if vn in self.columns:
                cols[vn] = self.columns[vn]
        out = TensorFrame(self._itensor, self._ftensor, cols, off, self.nrows, self._view)
        self._inherit_stats(out, "columns")
        return out

    def drop(self, names: Sequence[str]) -> "TensorFrame":
        keep = [c for c in self.column_names if c not in set(names)]
        return self.select(keep)

    def rename(self, mapping: Dict[str, str]) -> "TensorFrame":
        cols: Dict[str, ColumnMeta] = {}
        off: Dict[str, OffloadedColumn] = {}
        for name, m in self.columns.items():
            if _is_hidden(name):
                base = name[len(VALID_PREFIX):]
                new = _valid_name(mapping.get(base, base))
            else:
                new = mapping.get(name, name)
            cols[new] = dataclasses.replace(m, name=new)
            if m.kind == "obj":
                off[new] = self.offloaded[name]
        out = TensorFrame(self._itensor, self._ftensor, cols, off, self.nrows, self._view)
        self._inherit_stats(out, "columns", mapping=mapping)
        return out

    def _append_int_column(
        self,
        name: str,
        values: torch.Tensor,
        kind: str = "int",
        dictionary: Optional[np.ndarray] = None,
    ) -> "TensorFrame":
        dev = self.device
        values = torch.as_tensor(values, dtype=INT, device=dev).reshape(self.nrows, 1)
        cols = dict(self.columns)
        cols.pop(name, None)
        off = dict(self.offloaded)
        off.pop(name, None)
        if self._view is not None:
            # Lazy append: the computed column is already aligned with
            # the logical rows, so it rides along as its own identity
            # block — the view's deferred gathers survive.
            blocks = list(self._view.blocks)
            blocks.append(ViewBlock(values, _empty_tensor(self.nrows, float_dtype(), dev), None))
            cols[name] = ColumnMeta(name, kind, 0, dictionary, len(blocks) - 1)
            out = TensorFrame._from_view(cols, off, self.nrows, blocks, self._view.rowmat)
        else:
            it = torch.cat([self._itensor, values], dim=1)
            cols[name] = ColumnMeta(name, kind, self._itensor.shape[1], dictionary)
            out = TensorFrame(it, self._ftensor, cols, off, self.nrows)
        self._inherit_stats(out, "columns")
        out._drop_stats_mentioning(name)  # the name may have been replaced
        return out

    def _append_float_column(self, name: str, values: torch.Tensor) -> "TensorFrame":
        dev = self.device
        values = torch.as_tensor(values, dtype=float_dtype(), device=dev).reshape(self.nrows, 1)
        cols = dict(self.columns)
        cols.pop(name, None)
        off = dict(self.offloaded)
        off.pop(name, None)
        if self._view is not None:
            blocks = list(self._view.blocks)
            blocks.append(ViewBlock(_empty_tensor(self.nrows, INT, dev), values, None))
            cols[name] = ColumnMeta(name, "float", 0, None, len(blocks) - 1)
            out = TensorFrame._from_view(cols, off, self.nrows, blocks, self._view.rowmat)
        else:
            ft = torch.cat([self._ftensor, values], dim=1)
            cols[name] = ColumnMeta(name, "float", self._ftensor.shape[1])
            out = TensorFrame(self._itensor, ft, cols, off, self.nrows)
        self._inherit_stats(out, "columns")
        out._drop_stats_mentioning(name)
        return out

    def with_column(self, name: str, expr) -> "TensorFrame":
        from .expr import Expr, Value

        if isinstance(expr, Expr):
            val = expr.eval(self)
        elif isinstance(expr, Value):
            val = expr
        else:  # raw array
            arr = torch.as_tensor(expr, device=self.device)
            if arr.is_floating_point():
                return self._append_float_column(name, arr)
            return self._append_int_column(name, arr)
        if val.kind == "str":
            return self._append_int_column(name, val.arr, "dict", val.dictionary)
        if val.kind == "bool":
            return self._append_int_column(name, val.arr.to(INT), "bool")
        if val.kind == "date":
            return self._append_int_column(name, val.arr, "date")
        arr = val.arr
        if arr.is_floating_point():
            out = self._append_float_column(name, arr)
        else:
            out = self._append_int_column(name, arr)
        if val.valid is not None:
            out = out._append_int_column(_valid_name(name), val.valid.to(INT), "bool")
        return out

    # ------------------------------------------------------------------
    # relational ops (implemented in sibling modules)
    # ------------------------------------------------------------------
    def groupby(self, keys: Union[str, Sequence[str]]):
        from .groupby import GroupBy

        if isinstance(keys, str):
            keys = [keys]
        return GroupBy(self, list(keys))

    def agg(self, specs) -> Dict[str, float]:
        from .agg import frame_agg

        return frame_agg(self, specs)

    def sort_values(self, by, ascending=True) -> "TensorFrame":
        from .sort import sort_values

        return sort_values(self, by, ascending)

    def join(self, other: "TensorFrame", **kwargs) -> "TensorFrame":
        from .join import join

        return join(self, other, **kwargs)

    def nunique(self, name: str) -> int:
        from .groupby import nunique_column

        return nunique_column(self, name)

    def unique_rows(self, names: Sequence[str]) -> "TensorFrame":
        from .groupby import unique_rows

        return unique_rows(self, list(names))

    def scalar(self, name: str):
        arr = self.column(name)
        if arr.shape[0] != 1:
            raise ValueError(f"scalar() on column with {arr.shape[0]} rows")
        return arr[0]

    # ------------------------------------------------------------------
    # memory accounting (paper §VI-H)
    # ------------------------------------------------------------------
    def memory_bytes(self) -> Dict[str, int]:
        dict_bytes = 0
        for m in self.columns.values():
            if m.kind == "dict" and m.dictionary is not None:
                dict_bytes += sum(len(str(s).encode()) + 8 for s in m.dictionary)
        offload_bytes = 0
        for oc in self.offloaded.values():
            # physical payload + per-string overhead (the paper's Mojo
            # strings carry ~20B of metadata), plus the row indexer
            offload_bytes += sum(len(str(s).encode()) + 20 for s in oc.values)
            offload_bytes += oc.idx.numel() * 8
        return {
            "itensor": self.itensor.numel() * self.itensor.element_size(),
            "ftensor": self.ftensor.numel() * self.ftensor.element_size(),
            "dicts": dict_bytes,
            "offloaded": offload_bytes,
        }

    def total_bytes(self) -> int:
        return sum(self.memory_bytes().values())

    # ------------------------------------------------------------------
    def __repr__(self) -> str:
        cols = ", ".join(f"{name}:{self.columns[name].kind}" for name in self.column_names)
        tag = " view" if self._view is not None else ""
        return f"TensorFrame({self.nrows} rows{tag}; {cols}; {self.device})"

    def show(self, n: int = 8) -> str:
        names = self.column_names
        data = {name: self.column(name)[: min(n, self.nrows)] for name in names}
        widths = {
            name: max(len(name), *(len(str(v)) for v in data[name])) if self.nrows else len(name)
            for name in names
        }
        lines = [" | ".join(name.ljust(widths[name]) for name in names)]
        lines.append("-+-".join("-" * widths[name] for name in names))
        for i in range(min(n, self.nrows)):
            lines.append(" | ".join(str(data[name][i]).ljust(widths[name]) for name in names))
        if self.nrows > n:
            lines.append(f"... ({self.nrows} rows)")
        return "\n".join(lines)


def concat_rows(frames: Sequence[TensorFrame]) -> TensorFrame:
    """Vertical concatenation (schemas must match by name & kind),
    decoded through the host; the result stays on the first frame's
    device."""
    if not frames:
        raise ValueError("concat of zero frames")
    base = frames[0]
    names = list(base.columns.keys())
    for f in frames[1:]:
        if list(f.columns.keys()) != names:
            raise ValueError("concat: schema mismatch")
    data: Dict[str, np.ndarray] = {}
    for name in base.column_names:
        data[name] = np.concatenate([f.column(name) for f in frames])
    return TensorFrame.from_arrays(data, device=base.device)
