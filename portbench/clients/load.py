"""Loading a configuration's host tables onto the device: one
``TensorFrame.from_arrays`` a table, timed to a synchronize."""
from __future__ import annotations

import time


def frames(tables: dict, device: str):
    """``({name: TensorFrame}, seconds)``."""
    import torch
    from repro_torch.core import TensorFrame

    t0 = time.perf_counter()
    out = {name: TensorFrame.from_arrays(cols, device=device) for name, cols in tables.items()}
    if device == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0
