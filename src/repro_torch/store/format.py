"""``.tfb`` v2: persisted chunked columnar tables, lazily loadable.

Layout (a directory, like v1):

- ``manifest.json`` — ``{"magic": "tfb-v2", "nrows", "chunk_rows",
  "columns": [...]}``; every column entry carries its ctype, encoding,
  dictionary size and the per-chunk descriptors — byte offsets into the
  column's data files plus the zone-map stats (min/max/nulls/distinct).
  The manifest is the only thing ``open_store`` reads: stats live here,
  so scan pruning decides chunk-by-chunk *before* any payload I/O.
- ``<col>.bin`` — the column's chunk payloads, concatenated:
  int64/float64 values (plain), int64 codes (dict), or per chunk the
  run values followed by int64 run lengths (rle).  Plain string chunks
  are NUL-separated utf-8 payloads.
- ``<col>.off`` — for plain string columns: per chunk ``n+1`` int64
  offsets into that chunk's payload.
- ``<col>.dict`` / ``<col>.dictoff`` — dict columns: the sorted
  dictionary, stored once per column (NUL-separated utf-8 + offsets).
  Dictionaries are interned into the process pool at load, so two
  tables (or two loads of one table) with equal dictionaries share one
  array object and merge in O(1).
- ``<col>.valid`` — nullable columns: per-chunk ``np.packbits``
  validity bitmaps (True = present).  Only chunks with nulls write one
  (their manifest entries carry a ``voffset``); files without it read
  as before, so pre-bitmap v2 tables stay compatible and int/date/str
  nulls now round-trip losslessly instead of surviving only as float
  NaN.

``open_store`` returns a ``Table`` whose chunks hold loader callbacks:
payloads hit disk on first access and are cached.  ``read_arrays`` is
the eager v1-compatible read (used by ``core.io.read_tfb_arrays``).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.resilience import faults, retry

from .pool import intern_dictionary
from .table import (
    Chunk,
    ChunkStats,
    Column,
    DEFAULT_CHUNK_ROWS,
    EncodingPolicy,
    DEFAULT_POLICY,
    Table,
)

MAGIC_V2 = "tfb-v2"

_DTYPES = {"int": np.int64, "date": np.int64, "bool": np.int64, "float": np.float64}


def _payload_dtype(ctype: str, encoding: str):
    if encoding == "dict":
        return np.int64
    return _DTYPES[ctype]


# ----------------------------------------------------------------------
# string payload helpers (shared by dictionaries and plain-str chunks)
# ----------------------------------------------------------------------
def _pack_strings(values) -> tuple:
    payload = "\x00".join(str(s) for s in values).encode("utf-8")
    lengths = np.array(
        [len(str(s).encode("utf-8")) for s in values], dtype=np.int64
    )
    offs = np.zeros(len(lengths) + 1, dtype=np.int64)
    if len(lengths):
        offs[1:] = np.cumsum(lengths + 1)
    return payload, offs


def _unpack_strings(payload: bytes, offs: np.ndarray) -> np.ndarray:
    n = offs.shape[0] - 1
    out = np.empty(n, dtype=object)
    for i in range(n):
        out[i] = payload[offs[i]: offs[i + 1] - 1].decode("utf-8")
    return out


# ----------------------------------------------------------------------
# writer
# ----------------------------------------------------------------------
def write_store(path: str, table: Table) -> None:
    """Persist a chunked table as a ``.tfb`` v2 directory."""
    faults.fault_point("store.write")
    os.makedirs(path, exist_ok=True)
    manifest = {
        "magic": MAGIC_V2,
        "nrows": table.nrows,
        "chunk_rows": table.chunk_rows,
        "columns": [],
    }
    for name, col in table.columns.items():
        base = os.path.join(path, name)
        entry = {
            "name": name,
            "ctype": col.ctype,
            "encoding": col.encoding,
            "chunks": [],
        }
        if col.encoding == "dict":
            payload, offs = _pack_strings(col.dictionary)
            with open(base + ".dict", "wb") as f:
                f.write(payload)
            offs.tofile(base + ".dictoff")
            entry["dict_size"] = int(col.dictionary.shape[0])
        if col.ctype == "str" and col.encoding == "plain":
            _write_plain_str(base, col, entry)
        else:
            _write_binary(base, col, entry)
        if col.has_validity():
            _write_validity(base, col, entry)
        manifest["columns"].append(entry)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)


def _stats_doc(s: ChunkStats) -> dict:
    return {
        "min": s.vmin,
        "max": s.vmax,
        "nulls": int(s.null_count),
        "distinct": int(s.distinct),
    }


def _write_binary(base: str, col: Column, entry: dict) -> None:
    pos = 0
    with open(base + ".bin", "wb") as f:
        for c in col.chunks:
            cent = {"n": c.n, "offset": pos, "stats": _stats_doc(c.stats)}
            if col.encoding == "rle":
                values, runs = c.payload()
                vb = values.astype(_payload_dtype(col.ctype, "plain")).tobytes()
                rb = runs.astype(np.int64).tobytes()
                f.write(vb)
                f.write(rb)
                cent["runs"] = int(runs.shape[0])
                pos += len(vb) + len(rb)
            else:
                b = c.payload().astype(
                    _payload_dtype(col.ctype, col.encoding)
                ).tobytes()
                f.write(b)
                pos += len(b)
            entry["chunks"].append(cent)


def _write_plain_str(base: str, col: Column, entry: dict) -> None:
    bin_pos = 0
    off_pos = 0
    with open(base + ".bin", "wb") as fb, open(base + ".off", "wb") as fo:
        for c in col.chunks:
            payload, offs = _pack_strings(c.payload())
            fb.write(payload)
            fo.write(offs.tobytes())
            entry["chunks"].append(
                {
                    "n": c.n,
                    "offset": bin_pos,
                    "nbytes": len(payload),
                    "off_offset": off_pos,
                    "stats": _stats_doc(c.stats),
                }
            )
            bin_pos += len(payload)
            off_pos += offs.nbytes


def _write_validity(base: str, col: Column, entry: dict) -> None:
    """``<col>.valid``: per-chunk ``np.packbits`` validity bitmaps.

    Chunks without nulls write nothing; their manifest entries carry no
    ``voffset`` and load as all-valid.  Added alongside v2 without a
    magic bump — older readers ignored the unknown key, older files
    simply lack it (nulls then survive only as float NaN, the legacy
    behavior)."""
    pos = 0
    with open(base + ".valid", "wb") as f:
        for c, cent in zip(col.chunks, entry["chunks"]):
            v = c.validity()
            if v is None:
                continue
            packed = np.packbits(np.asarray(v, dtype=bool))
            f.write(packed.tobytes())
            cent["voffset"] = pos
            pos += packed.nbytes


def write_arrays(
    path: str,
    data: Dict[str, np.ndarray],
    *,
    chunk_rows: int = DEFAULT_CHUNK_ROWS,
    policy: EncodingPolicy = DEFAULT_POLICY,
    encode: Optional[Dict[str, str]] = None,
    validity: Optional[Dict[str, np.ndarray]] = None,
) -> Table:
    """Chunk/encode host arrays and persist them; returns the table."""
    table = Table.from_arrays(
        data, chunk_rows=chunk_rows, policy=policy, encode=encode,
        validity=validity,
    )
    write_store(path, table)
    return table


# ----------------------------------------------------------------------
# reader
# ----------------------------------------------------------------------
class _ColumnFile:
    """One column data file, opened lazily and kept open across chunk
    loads (per-chunk ``open()`` dominates small-chunk reads otherwise).
    The handle closes with the object (all chunk loaders of a column
    share one ``_ColumnFile``)."""

    __slots__ = ("path", "_fh")

    def __init__(self, path: str):
        self.path = path
        self._fh = None

    def _read_once(self, offset: int, nbytes: int) -> bytes:
        faults.fault_point("store.read")
        if self._fh is None:
            self._fh = open(self.path, "rb")
        self._fh.seek(offset)
        return self._fh.read(nbytes)

    def read(self, offset: int, nbytes: int) -> bytes:
        try:
            return self._read_once(offset, nbytes)
        except OSError:
            self._fh = None  # handle may be stale; reopen under retry
            return retry.call(
                lambda: self._read_once(offset, nbytes), site="store.read"
            )

    def read_array(self, offset: int, count: int, dtype) -> np.ndarray:
        nbytes = count * np.dtype(dtype).itemsize
        return np.frombuffer(self.read(offset, nbytes), dtype=dtype)


def is_v2(path: str) -> bool:
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            return json.load(f).get("magic") == MAGIC_V2
    except (OSError, ValueError):
        return False


def open_store(path: str, manifest: Optional[dict] = None) -> Table:
    """Open a ``.tfb`` v2 directory lazily (manifest + stats only).

    ``manifest`` may be passed pre-parsed (callers that already read it
    to sniff the magic, e.g. ``core.io``, skip the second JSON parse).
    """
    if manifest is None:
        def _load_manifest():
            faults.fault_point("store.read")
            with open(os.path.join(path, "manifest.json")) as f:
                return json.load(f)

        manifest = retry.call(_load_manifest, site="store.read")
    if manifest.get("magic") != MAGIC_V2:
        raise ValueError(
            f"{path} is not a tfb-v2 store "
            f"(magic={manifest.get('magic')!r}); use core.io.read_tfb "
            f"for v1 tables"
        )
    columns: Dict[str, Column] = {}
    for entry in manifest["columns"]:
        name, ctype, encoding = entry["name"], entry["ctype"], entry["encoding"]
        base = os.path.join(path, name)
        dict_loader = None
        if encoding == "dict":
            dict_loader = _make_dict_loader(base, entry["dict_size"])
        data = _ColumnFile(base + ".bin")
        offf = (
            _ColumnFile(base + ".off")
            if ctype == "str" and encoding == "plain"
            else None
        )
        validf = (
            _ColumnFile(base + ".valid")
            if any("voffset" in c for c in entry["chunks"])
            else None
        )
        chunks: List[Chunk] = []
        for cent in entry["chunks"]:
            stats = ChunkStats(
                cent["stats"]["min"],
                cent["stats"]["max"],
                cent["stats"]["nulls"],
                cent["stats"]["distinct"],
            )
            vloader = None
            if validf is not None and "voffset" in cent:
                vloader = _make_validity_loader(validf, cent)
            chunks.append(
                Chunk(cent["n"], stats, loader=_make_loader(
                    data, offf, ctype, encoding, cent
                ), vloader=vloader)
            )
        columns[name] = Column(
            name,
            ctype,
            encoding,
            chunks,
            dict_loader=dict_loader,
            bulk_loader=_make_bulk_loader(data, offf, ctype, encoding, entry),
        )
    return Table(columns, manifest["nrows"], manifest["chunk_rows"])


def _make_validity_loader(validf: _ColumnFile, cent: dict):
    n = int(cent["n"])
    voffset = int(cent["voffset"])
    nbytes = (n + 7) // 8

    def load_validity():
        packed = np.frombuffer(validf.read(voffset, nbytes), dtype=np.uint8)
        return np.unpackbits(packed, count=n).astype(bool)

    return load_validity


def _make_dict_loader(base: str, size: int):
    def load_dict():
        offs = np.fromfile(base + ".dictoff", dtype=np.int64, count=size + 1)
        with open(base + ".dict", "rb") as f:
            payload = f.read()
        return intern_dictionary(_unpack_strings(payload, offs))

    return load_dict


def _make_bulk_loader(
    data: _ColumnFile, offf: Optional[_ColumnFile],
    ctype: str, encoding: str, entry: dict,
):
    """One sequential read of the whole column file -> every chunk's
    payload (the full-materialization fast path; per-chunk seeks only
    pay off when pruning actually skips)."""
    cents = entry["chunks"]
    if not cents:
        return None
    if ctype == "str" and encoding == "plain":
        def bulk_str():
            last = cents[-1]
            payload = data.read(0, last["offset"] + last["nbytes"])
            n_offs = sum(c["n"] + 1 for c in cents)
            offs_all = offf.read_array(0, n_offs, np.int64)
            out = []
            for c in cents:
                start = c["off_offset"] // 8
                offs = offs_all[start: start + c["n"] + 1]
                out.append(
                    _unpack_strings(
                        payload[c["offset"]: c["offset"] + c["nbytes"]], offs
                    )
                )
            return out

        return bulk_str
    dt = _payload_dtype(ctype, encoding)
    isz = np.dtype(dt).itemsize
    if encoding == "rle":
        def bulk_rle():
            last = cents[-1]
            buf = data.read(0, last["offset"] + last["runs"] * (isz + 8))
            out = []
            for c in cents:
                nr = c["runs"]
                values = np.frombuffer(buf, dt, count=nr, offset=c["offset"])
                runs = np.frombuffer(
                    buf, np.int64, count=nr, offset=c["offset"] + nr * isz
                )
                out.append((values, runs))
            return out

        return bulk_rle

    def bulk_plain():
        last = cents[-1]
        buf = data.read(0, last["offset"] + last["n"] * isz)
        return [
            np.frombuffer(buf, dt, count=c["n"], offset=c["offset"])
            for c in cents
        ]

    return bulk_plain


def _make_loader(
    data: _ColumnFile, offf: Optional[_ColumnFile],
    ctype: str, encoding: str, cent: dict,
):
    if ctype == "str" and encoding == "plain":
        def load_str():
            offs = offf.read_array(cent["off_offset"], cent["n"] + 1, np.int64)
            payload = data.read(cent["offset"], cent["nbytes"])
            return _unpack_strings(payload, offs)

        return load_str
    dt = _payload_dtype(ctype, encoding)
    if encoding == "rle":
        def load_rle():
            nruns = cent["runs"]
            values = data.read_array(cent["offset"], nruns, dt)
            runs = data.read_array(
                cent["offset"] + values.nbytes, nruns, np.int64
            )
            return values, runs

        return load_rle

    return lambda: data.read_array(cent["offset"], cent["n"], dt)


def read_arrays(
    path: str,
    columns: Optional[Sequence[str]] = None,
    manifest: Optional[dict] = None,
) -> Dict[str, np.ndarray]:
    """Eager projection read of a v2 store back to host arrays."""
    table = open_store(path, manifest)
    return table.to_arrays(columns)
