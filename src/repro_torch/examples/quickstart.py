"""Quickstart: the TensorFrame public API — MojoFrame's Fig. 5 workflow
(filter / join / group-by, trait-based stateless UDFs), on PyTorch.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

On the card the ordered-substring filter runs the substring kernel's
fused ``exists_before`` (K2) and the group-by sums the segment-sum
kernel (K1).
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core import TensorFrame, col, d, resolve_device


def make_frames(device) -> Dict[str, TensorFrame]:
    """The script's 10,000 orders and 800 customers, drawn from seed 0."""
    rng = np.random.default_rng(0)
    n = 10_000
    orders = TensorFrame.from_arrays(
        {
            "order_id": np.arange(n, dtype=np.int64),
            "cust_id": rng.integers(0, 800, n),
            "price": np.round(rng.uniform(5, 500, n), 2),
            "status": rng.choice(["open", "shipped", "returned"], n).astype(object),
            "odate": np.datetime64("1995-01-01") + rng.integers(0, 900, n).astype("timedelta64[D]"),
            "comment": np.array(
                [f"note {i}: " + ("special packages requests" if i % 97 == 0 else "regular deposit")
                 for i in range(n)], dtype=object),
        },
        device=device,
    )
    customers = TensorFrame.from_arrays(
        {
            "cust_id": np.arange(800, dtype=np.int64),
            "segment": rng.choice(["BUILDING", "MACHINERY", "HOUSEHOLD"], 800).astype(object),
            "balance": np.round(rng.uniform(-100, 5000, 800), 2),
        },
        device=device,
    )
    return {"orders": orders, "customers": customers}


def run(device=None) -> Dict:
    """The script's work on ``device`` (default ``CONFIG.device``):
    ``{"lines": what it prints, "results": {"filtered": rows kept,
    "top": the revenue table's columns}}``."""
    dev = resolve_device(device)
    frames = make_frames(dev)
    orders, customers = frames["orders"], frames["customers"]
    lines: List[str] = [repr(orders), repr(customers)]

    # trait-based stateless filtering (paper §IV-A): composable exprs,
    # including the Q13-style ordered-substring UDF — no row loops
    hot = orders.filter(
        (col("status") != "returned")
        & (col("odate") >= d("1996-01-01"))
        & col("comment").str.not_exists_before("special", "requests")
        & (col("price") > 50.0)
    )
    lines.append(f"\nfiltered: {hot.nrows} rows")

    # factorize-then-join (paper §IV-C): dense-code direct-address probe
    j = hot.join(customers, on="cust_id")

    # transposed composite-key group-by (paper §IV-B) + sort
    top = (
        j.groupby(["segment"])
        .agg([("revenue", "sum", "price"), ("orders", "size", ""), ("avg_bal", "mean", "balance")])
        .sort_values("revenue", ascending=False)
    )
    lines.append("\nrevenue by segment:")
    lines.append(top.show())
    return {"lines": lines, "results": {"filtered": hot.nrows, "top": top.to_dict()}}


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    out = run(args.device)
    print("\n".join(out["lines"]))
    return out


if __name__ == "__main__":
    main()
