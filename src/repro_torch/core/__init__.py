"""TensorFrame on PyTorch — MojoFrame's tensor-backed dataframe engine.

Frames hold exact int64 keys and float64 measures on their device
(``CONFIG.device``, the CUDA card by default; ``device="cpu"`` asks for
the CPU).
"""
from .config import CONFIG, EngineConfig, resolve_device
from .frame import TensorFrame, concat_rows
from .expr import (
    DateLit,
    Expr,
    col,
    lit,
    d,
    if_else,
    parse_date,
    udf,
)
from .join import join
from .io import read_csv, read_csv_arrays, read_tfb, read_tfb_arrays, write_csv, write_tfb

__all__ = [
    "CONFIG",
    "EngineConfig",
    "resolve_device",
    "TensorFrame",
    "concat_rows",
    "DateLit",
    "Expr",
    "col",
    "lit",
    "d",
    "if_else",
    "parse_date",
    "udf",
    "join",
    "read_csv",
    "read_csv_arrays",
    "read_tfb",
    "read_tfb_arrays",
    "write_csv",
    "write_tfb",
]
