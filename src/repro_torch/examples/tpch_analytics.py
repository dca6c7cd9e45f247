"""Run the full TPC-H suite on generated data and print a Fig.6-style
relative-time table (TensorFrame vs the row-at-a-time reference).

    PYTHONPATH=src python -m repro_torch.examples.tpch_analytics [--sf 0.01] [--row-engine] [--device cpu]

Each query runs once to warm up, then once timed on the host clock; on
the card the timing ends in ``torch.cuda.synchronize()``.  The row
engine is the port's own copy of the row-at-a-time reference
(``repro_torch.queries.tpch_numpy``).
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import torch

from repro_torch.core import resolve_device
from repro_torch.data import tpch
from repro_torch.queries import tpch_frames as QF
from repro_torch.queries import tpch_numpy as QN


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(sf: float = 0.01, row_engine: bool = False, device=None) -> Dict:
    """The script's work on ``device`` (default ``CONFIG.device``):
    ``{"lines": what it prints, "results": each query's timed result as
    host columns, "ms": each query's timed run}``."""
    dev = resolve_device(device)
    tables = tpch.generate(sf=sf, seed=0)
    frames = tpch.as_frames(tables, device=dev)
    lines: List[str] = [
        f"TPC-H sf={sf}: lineitem={tables['lineitem']['l_orderkey'].shape[0]} rows\n",
        f"{'query':6s} {'tensorframe':>12s} {'rowpython':>12s} {'speedup':>8s}",
    ]
    results, ms = {}, {}
    for i in range(1, 23):
        q = f"q{i}"
        fn = QF.ALL[q]
        fn(frames, sf=sf)  # warm
        _sync(dev)
        t0 = time.perf_counter()
        res = fn(frames, sf=sf)
        _sync(dev)
        tf = time.perf_counter() - t0
        results[q] = res if isinstance(res, dict) else res.to_dict()
        ms[q] = tf * 1e3
        if row_engine:
            t0 = time.perf_counter()
            QN.ALL[q](tables, sf=sf)
            tr = time.perf_counter() - t0
            lines.append(f"{q:6s} {tf*1e3:10.1f}ms {tr*1e3:10.1f}ms {tr/tf:7.1f}x")
        else:
            lines.append(f"{q:6s} {tf*1e3:10.1f}ms {'-':>12s} {'-':>8s}")
    return {"lines": lines, "results": results, "ms": ms}


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=0.01)
    ap.add_argument("--row-engine", action="store_true", help="also time the row-python reference")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    out = run(args.sf, args.row_engine, args.device)
    print("\n".join(out["lines"]))
    return out


if __name__ == "__main__":
    main()
