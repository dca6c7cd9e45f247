"""SQL front-end quickstart: query TensorFrames with plain SELECTs.

    PYTHONPATH=src python -m repro_torch.examples.sql_quickstart [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import numpy as np

from repro_torch import sql
from repro_torch.core import TensorFrame, resolve_device
from repro_torch.queries import scope

QUERY = """
    SELECT region,
           EXTRACT(MONTH FROM placed) AS month,
           COUNT(*) AS orders,
           SUM(amount) AS total
    FROM orders, customers
    WHERE customer = name AND amount BETWEEN 5 AND 50
    GROUP BY region, month
    HAVING SUM(amount) > 10
    ORDER BY region, month
"""

BIG_SPENDERS = """
    SELECT customer, COUNT(*) AS n
    FROM orders o
    WHERE amount > (SELECT AVG(o2.amount) FROM orders o2)
      AND EXISTS (SELECT * FROM customers c
                  WHERE c.name = o.customer AND c.region = 'north')
    GROUP BY customer
    ORDER BY customer
"""

TPCH_PRICING = """
    SELECT l_returnflag, l_linestatus, SUM(l_quantity) AS sum_qty
    FROM lineitem
    WHERE l_shipdate <= DATE '1998-12-01' - INTERVAL '90' DAY
    GROUP BY l_returnflag, l_linestatus
    ORDER BY l_returnflag, l_linestatus
    """


def make_frames(device) -> Dict[str, TensorFrame]:
    """The ad-hoc scope: the scope is just a dict of tables."""
    return {
        "orders": TensorFrame.from_arrays(
            {
                "order_id": np.arange(8),
                "customer": np.array(
                    ["ada", "bob", "ada", "cyd", "bob", "ada", "cyd", "bob"],
                    dtype=object,
                ),
                "amount": np.array([10.0, 20.0, 35.0, 5.0, 60.0, 12.0, 44.0, 3.0]),
                "placed": np.array(
                    ["2024-01-05", "2024-01-07", "2024-02-01", "2024-02-03",
                     "2024-02-11", "2024-03-02", "2024-03-09", "2024-03-15"],
                    dtype="datetime64[D]",
                ),
            },
            device=device,
        ),
        "customers": TensorFrame.from_arrays(
            {
                "name": np.array(["ada", "bob", "cyd"], dtype=object),
                "region": np.array(["north", "south", "north"], dtype=object),
            },
            device=device,
        ),
    }


def run(device=None) -> Dict:
    """The script's work on ``device`` (default ``CONFIG.device``):
    ``{"lines": what it prints, "results": each query's columns}``."""
    dev = resolve_device(device)
    frames = make_frames(dev)
    lines: List[str] = []
    results = {}

    # 1. ad-hoc frames
    res = sql.execute(QUERY, frames)
    results["by_region_month"] = res.to_dict()
    lines.append(res.show())

    # 2. explain(): pre- vs post-optimization plans
    lines += ["", sql.explain(QUERY, frames)]

    # 3. subqueries: the optimizer decorrelates them into joins
    res = sql.execute(BIG_SPENDERS, frames)
    results["big_spenders"] = res.to_dict()
    lines += ["", res.show()]
    # the naive plan keeps interpreted subquery markers; the optimized one
    # shows the AttachScalar constant and the EXISTS rewritten to a semi join
    lines += ["", sql.explain(BIG_SPENDERS, frames)]

    # 4. registered scopes: benchmark tables by name
    tpch = scope("tpch", sf=0.001, seed=0, device=dev)
    top = sql.execute(TPCH_PRICING, tpch)
    results["tpch_pricing"] = top.to_dict()
    lines += ["", top.show()]
    return {"lines": lines, "results": results}


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    out = run(args.device)
    print("\n".join(out["lines"]))
    return out


if __name__ == "__main__":
    main()
