"""repro_torch.store — chunked columnar storage under TensorFrame.

The storage layer the paper's conclusion asks for ("in-memory data
representation and dictionary operations"):

- ``table``  — fixed-size column chunks with zone-map statistics and a
  cardinality-aware per-column encoding (plain / dict / rle);
- ``pool``   — a process-wide interned string-pool: equal dictionaries
  are one object, so cross-frame dictionary merges become identity;
- ``scan``   — predicate scans that skip whole chunks via zone maps
  before materializing anything;
- ``format`` — the ``.tfb`` v2 on-disk format with lazy per-column /
  per-chunk loading (v1 stays readable through ``core.io``).

Import-time constraint: this package imports no torch — it is a
host-side layer usable before any accelerator backend
initializes.  The device side enters only through
``TensorFrame.from_store`` (``repro_torch.core``), which depends on this
package, never the reverse.
"""
from .pool import POOL, StringPool, intern_dictionary
from .table import (
    CTYPES,
    DEFAULT_CHUNK_ROWS,
    DEFAULT_POLICY,
    Chunk,
    ChunkStats,
    Column,
    EncodingPolicy,
    Table,
    compute_stats,
)
from .scan import (
    MaterializedColumn,
    Pred,
    ScanResult,
    chunk_may_match,
    plan_scan,
    scan,
    scan_chunk,
    shared_scan,
)
from .format import (
    MAGIC_V2,
    is_v2,
    open_store,
    read_arrays,
    write_arrays,
    write_store,
)
from .spill import SPILL, SpillManager, Spillable, block_bytes

__all__ = [
    "POOL",
    "StringPool",
    "intern_dictionary",
    "CTYPES",
    "DEFAULT_CHUNK_ROWS",
    "DEFAULT_POLICY",
    "Chunk",
    "ChunkStats",
    "Column",
    "EncodingPolicy",
    "Table",
    "compute_stats",
    "MaterializedColumn",
    "Pred",
    "ScanResult",
    "chunk_may_match",
    "plan_scan",
    "scan",
    "scan_chunk",
    "shared_scan",
    "MAGIC_V2",
    "is_v2",
    "open_store",
    "read_arrays",
    "write_arrays",
    "write_store",
    "SPILL",
    "SpillManager",
    "Spillable",
    "block_bytes",
]
