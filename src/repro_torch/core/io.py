"""Data loading (paper §V-b, §VI-G).

Two loaders:

Every loader takes the frame's ``device=`` (default ``CONFIG.device``)
through ``**frame_kwargs``.

- **Binary columnar ("tfb")**: v2 (default) is the chunked store
  format (``repro_torch.store.format``) — per-chunk zone maps, per-column
  encodings, lazy loading, scan pushdown via ``read_tfb(...,
  predicates=...)``.  v1 is the original flat layout (little-endian
  packed column files + a JSON manifest with projection pushdown);
  it stays fully readable and writable via ``version=1``.
- **CSV**: the deliberately text-bound baseline.  Explicit ``dtypes``
  hints always win over sniffing; the tokens ``''``/``'None'``/
  ``'NULL'``/``'nan'`` parse as nulls in numeric/date columns (all-null
  columns round-trip as NaN floats / NaT dates).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .frame import TensorFrame

MAGIC = "tfb-v1"


def _read_manifest(path: str) -> dict:
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def write_tfb(
    path: str,
    data: Dict[str, np.ndarray],
    *,
    version: int = 2,
    chunk_rows: Optional[int] = None,
) -> None:
    """Write a dict of host arrays as a binary columnar table.

    ``version=2`` (default) writes the chunked store format with zone
    maps and per-column encodings; ``version=1`` writes the original
    flat layout.
    """
    if version == 2:
        from repro_torch.store import DEFAULT_CHUNK_ROWS, format as storefmt

        storefmt.write_arrays(
            path, data, chunk_rows=chunk_rows or DEFAULT_CHUNK_ROWS
        )
        return
    if version != 1:
        raise ValueError(f"unknown tfb version {version!r}")
    os.makedirs(path, exist_ok=True)
    manifest = {"magic": MAGIC, "columns": []}
    n = None
    for name, arr in data.items():
        arr = np.asarray(arr)
        n = arr.shape[0] if n is None else n
        entry = {"name": name, "n": int(arr.shape[0])}
        base = os.path.join(path, name)
        if np.issubdtype(arr.dtype, np.datetime64):
            days = arr.astype("datetime64[D]").astype(np.int64)
            days.tofile(base + ".i64")
            entry["type"] = "date"
        elif np.issubdtype(arr.dtype, np.integer):
            arr.astype(np.int64).tofile(base + ".i64")
            entry["type"] = "int"
        elif np.issubdtype(arr.dtype, np.floating):
            arr.astype(np.float64).tofile(base + ".f64")
            entry["type"] = "float"
        else:
            payload = "\x00".join(str(s) for s in arr).encode("utf-8")
            offs = np.zeros(arr.shape[0] + 1, dtype=np.int64)
            lengths = np.array([len(str(s).encode("utf-8")) for s in arr], dtype=np.int64)
            offs[1:] = np.cumsum(lengths + 1)
            with open(base + ".str", "wb") as f:
                f.write(payload)
            offs.tofile(base + ".off")
            entry["type"] = "str"
        manifest["columns"].append(entry)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)


def read_tfb_arrays(
    path: str,
    columns: Optional[Sequence[str]] = None,
    manifest: Optional[dict] = None,
) -> Dict[str, np.ndarray]:
    """Projection-pushdown read of raw host arrays (v1 or v2)."""
    if manifest is None:
        manifest = _read_manifest(path)
    if manifest.get("magic") == "tfb-v2":
        from repro_torch.store import format as storefmt

        return storefmt.read_arrays(path, columns, manifest=manifest)
    want = set(columns) if columns is not None else None
    out: Dict[str, np.ndarray] = {}
    order = columns if columns is not None else [c["name"] for c in manifest["columns"]]
    entries = {c["name"]: c for c in manifest["columns"]}
    for name in order:
        if want is not None and name not in want:
            continue
        e = entries[name]
        base = os.path.join(path, name)
        if e["type"] in ("int",):
            out[name] = np.fromfile(base + ".i64", dtype=np.int64)
        elif e["type"] == "date":
            out[name] = np.fromfile(base + ".i64", dtype=np.int64).astype("datetime64[D]")
        elif e["type"] == "float":
            out[name] = np.fromfile(base + ".f64", dtype=np.float64)
        else:
            offs = np.fromfile(base + ".off", dtype=np.int64)
            with open(base + ".str", "rb") as f:
                payload = f.read()
            # byte offsets delimit NUL-separated utf-8 entries
            out[name] = np.array(
                [
                    payload[offs[i]: offs[i + 1] - 1].decode("utf-8")
                    for i in range(len(offs) - 1)
                ],
                dtype=object,
            )
    return out


def read_tfb(
    path: str,
    columns: Optional[Sequence[str]] = None,
    predicates: Sequence = (),
    **frame_kwargs,
) -> TensorFrame:
    """Load a tfb table as a TensorFrame.

    On v2 stores this is a pushdown scan: ``predicates`` (sargable
    ``repro_torch.store.Pred`` conjuncts) skip chunks via zone maps and only
    surviving rows are materialized; dictionaries stay interned.  v1
    tables load flat (predicates are rejected there — v1 has no
    chunk statistics to push into).
    """
    manifest = _read_manifest(path)
    if manifest.get("magic") == "tfb-v2":
        from repro_torch.store import open_store

        return TensorFrame.from_store(
            open_store(path, manifest), columns, predicates, **frame_kwargs
        )
    if predicates:
        raise ValueError("predicate pushdown requires a tfb-v2 store")
    return TensorFrame.from_arrays(
        read_tfb_arrays(path, columns, manifest=manifest), **frame_kwargs
    )


# ----------------------------------------------------------------------
# CSV baseline
# ----------------------------------------------------------------------
def write_csv(path: str, data: Dict[str, np.ndarray], sep: str = "|") -> None:
    names = list(data.keys())
    cols = [data[n] for n in names]
    n = cols[0].shape[0]
    with open(path, "w") as f:
        f.write(sep.join(names) + "\n")
        for i in range(n):
            f.write(sep.join(str(c[i]) for c in cols) + "\n")


def read_csv_arrays(
    path: str,
    columns: Optional[Sequence[str]] = None,
    sep: str = "|",
    dtypes: Optional[Dict[str, str]] = None,
) -> Dict[str, np.ndarray]:
    """Text-parsing CSV loader (the runtime-parsing baseline)."""
    with open(path) as f:
        header = f.readline().rstrip("\n").split(sep)
        rows = [line.rstrip("\n").split(sep) for line in f]
    idx = {name: i for i, name in enumerate(header)}
    want = list(columns) if columns is not None else header
    out: Dict[str, np.ndarray] = {}
    for name in want:
        j = idx[name]
        raw = [r[j] for r in rows]
        hint = (dtypes or {}).get(name)
        out[name] = _infer_column(raw, hint)
    return out


# Tokens parsed as SQL NULL in numeric/date columns ('' is an empty
# field; 'None'/'nan' are what write_csv emits for null object cells
# and NaN floats, so null columns round-trip).
_NULL_TOKENS = frozenset({"", "None", "NULL", "null", "nan", "NaN"})


def _infer_column(raw: List[str], hint: Optional[str]) -> np.ndarray:
    """One CSV column -> numpy array.

    An explicit ``hint`` is authoritative: the column is parsed as that
    type (raising on malformed cells) instead of being sniffed — a
    digits-only string column hinted 'str' stays strings, a float
    column of round numbers hinted 'float' never collapses to int64.
    Unknown hints raise instead of silently falling back to sniffing.
    Null tokens in int columns promote the column to float64 (NaN is
    the engine's null); hint 'str' takes every cell verbatim.
    """
    if hint is not None and hint not in ("int", "float", "date", "str"):
        raise ValueError(
            f"unknown dtype hint {hint!r}; use 'int', 'float', 'date' or 'str'"
        )
    if hint == "str":
        return np.array(raw, dtype=object)
    nulls = [x in _NULL_TOKENS for x in raw]
    any_null = any(nulls)
    if raw and all(nulls) and hint != "date":
        # all-null column: no values to sniff — NaN floats (the
        # engine's null column representation) regardless of int hint
        return np.full(len(raw), np.nan, dtype=np.float64)
    if hint == "int":
        if any_null:
            return np.array(
                [np.nan if m else float(int(x)) for x, m in zip(raw, nulls)],
                dtype=np.float64,
            )
        return np.array([int(x) for x in raw], dtype=np.int64)
    if hint == "float":
        return np.array(
            [np.nan if m else float(x) for x, m in zip(raw, nulls)],
            dtype=np.float64,
        )
    if hint == "date":
        return np.array(
            ["NaT" if m else x for x, m in zip(raw, nulls)],
            dtype="datetime64[D]",
        )
    # inference over the non-null cells only
    vals = [x for x, m in zip(raw, nulls) if not m]
    try:
        ints = [int(x) for x in vals]
        if not any_null:
            return np.array(ints, dtype=np.int64)
        it = iter(ints)
        return np.array(
            [np.nan if m else float(next(it)) for m in nulls], dtype=np.float64
        )
    except ValueError:
        pass
    try:
        floats = [float(x) for x in vals]
        it = iter(floats)
        return np.array(
            [np.nan if m else next(it) for m in nulls], dtype=np.float64
        )
    except ValueError:
        pass
    try:
        return np.array(
            ["NaT" if m else x for x, m in zip(raw, nulls)],
            dtype="datetime64[D]",
        )
    except ValueError:
        # string column: cells verbatim (null tokens could be words)
        return np.array(raw, dtype=object)


def read_csv(path: str, columns=None, sep: str = "|", dtypes=None, **frame_kwargs) -> TensorFrame:
    """CSV -> TensorFrame.

    Null cells (NaN floats / NaT dates out of ``read_csv_arrays``) get
    a hidden validity companion column, so nullable columns round-trip
    with engine null semantics intact (COUNT skips them, SUM treats
    them as zero) instead of degrading to bare NaN values.
    """
    from .frame import _valid_name

    arrays = read_csv_arrays(path, columns, sep, dtypes)
    f = TensorFrame.from_arrays(arrays, **frame_kwargs)
    for name, arr in arrays.items():
        if arr.dtype.kind == "f":
            invalid = np.isnan(arr)
        elif np.issubdtype(arr.dtype, np.datetime64):
            invalid = np.isnat(arr)
        else:
            continue
        if invalid.any():
            f = f._append_int_column(
                _valid_name(name),
                torch.as_tensor((~invalid).astype(np.int64), device=f.device),
                "bool",
            )
    return f
