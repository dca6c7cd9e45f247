"""Mini-dsgen: the TPC-DS tables/columns needed by the paper's five
queries (Q3, Q6, Q7, Q42, Q96 — §VI-B Fig. 9).  The same generator as
the JAX package's: one seed gives the same tables in both."""
from __future__ import annotations

from typing import Dict

import numpy as np

Tables = Dict[str, Dict[str, np.ndarray]]

CATEGORIES = ["Books", "Music", "Home", "Electronics", "Shoes", "Jewelry", "Men", "Women", "Sports", "Children"]
STATES = ["CA", "NY", "TX", "WA", "IL", "FL", "GA", "OH", "MI", "PA", "AZ", "TN"]


def generate(sf: float = 0.01, seed: int = 1) -> Tables:
    rng = np.random.default_rng(seed)
    n_item = max(60, int(18_000 * sf))
    n_cust = max(40, int(100_000 * sf))
    n_addr = max(40, int(50_000 * sf))
    n_cdemo = max(50, int(19_20_00 * sf))
    n_hdemo = 72_00 // 100 or 72
    n_promo = max(10, int(300 * sf))
    n_store = max(4, int(12 * max(sf, 1)))
    n_ss = max(200, int(2_880_000 * sf))

    # ---- date_dim: 1998-01-01 .. 2002-12-31 ----
    days = np.arange(np.datetime64("1998-01-01"), np.datetime64("2003-01-01"))
    n_date = days.shape[0]
    years = days.astype("datetime64[Y]").astype(int) + 1970
    months = days.astype("datetime64[M]").astype(int) % 12 + 1
    date_dim = {
        "d_date_sk": np.arange(1, n_date + 1, dtype=np.int64),
        "d_date": days,
        "d_year": years.astype(np.int64),
        "d_moy": months.astype(np.int64),
        "d_month_seq": ((years - 1990) * 12 + months - 1).astype(np.int64),
    }

    # ---- time_dim: all 86400/60 minutes ----
    n_time = 24 * 60
    hours = np.repeat(np.arange(24), 60)
    time_dim = {
        "t_time_sk": np.arange(1, n_time + 1, dtype=np.int64),
        "t_hour": hours.astype(np.int64),
        "t_minute": np.tile(np.arange(60), 24).astype(np.int64),
    }

    # ---- item ----
    cat_id = rng.integers(1, len(CATEGORIES) + 1, n_item)
    brand_id = rng.integers(1, 1000, n_item)
    item = {
        "i_item_sk": np.arange(1, n_item + 1, dtype=np.int64),
        "i_item_id": np.array([f"ITEM{i:08d}" for i in range(1, n_item + 1)], dtype=object),
        "i_brand_id": brand_id.astype(np.int64),
        "i_brand": np.array([f"brand-{b}" for b in brand_id], dtype=object),
        "i_manufact_id": rng.integers(1, 200, n_item).astype(np.int64),
        "i_category_id": cat_id.astype(np.int64),
        "i_category": np.array(CATEGORIES, dtype=object)[cat_id - 1],
        "i_current_price": np.round(rng.uniform(0.5, 100.0, n_item), 2),
        "i_manager_id": rng.integers(1, 20, n_item).astype(np.int64),
    }

    # ---- dimensions ----
    customer_address = {
        "ca_address_sk": np.arange(1, n_addr + 1, dtype=np.int64),
        "ca_state": np.array(STATES, dtype=object)[rng.integers(0, len(STATES), n_addr)],
    }
    customer = {
        "c_customer_sk": np.arange(1, n_cust + 1, dtype=np.int64),
        "c_current_addr_sk": rng.integers(1, n_addr + 1, n_cust).astype(np.int64),
    }
    customer_demographics = {
        "cd_demo_sk": np.arange(1, n_cdemo + 1, dtype=np.int64),
        "cd_gender": np.array(["M", "F"], dtype=object)[rng.integers(0, 2, n_cdemo)],
        "cd_marital_status": np.array(["S", "M", "D", "W", "U"], dtype=object)[
            rng.integers(0, 5, n_cdemo)
        ],
        "cd_education_status": np.array(
            ["College", "2 yr Degree", "4 yr Degree", "Secondary", "Advanced Degree", "Unknown"],
            dtype=object,
        )[rng.integers(0, 6, n_cdemo)],
    }
    household_demographics = {
        "hd_demo_sk": np.arange(1, n_hdemo + 1, dtype=np.int64),
        "hd_dep_count": rng.integers(0, 10, n_hdemo).astype(np.int64),
    }
    promotion = {
        "p_promo_sk": np.arange(1, n_promo + 1, dtype=np.int64),
        "p_channel_email": np.array(["N", "Y"], dtype=object)[rng.integers(0, 2, n_promo)],
        "p_channel_event": np.array(["N", "Y"], dtype=object)[rng.integers(0, 2, n_promo)],
    }
    store = {
        "s_store_sk": np.arange(1, n_store + 1, dtype=np.int64),
        "s_store_name": np.array(["ought", "able", "pri", "ese", "anti", "cally"], dtype=object)[
            np.arange(n_store) % 6
        ],
    }

    # ---- store_sales (fact) ----
    qty = rng.integers(1, 100, n_ss).astype(np.int64)
    list_price = np.round(rng.uniform(1.0, 200.0, n_ss), 2)
    sales_price = np.round(list_price * rng.uniform(0.2, 1.0, n_ss), 2)
    store_sales = {
        "ss_sold_date_sk": rng.integers(1, n_date + 1, n_ss).astype(np.int64),
        "ss_sold_time_sk": rng.integers(1, n_time + 1, n_ss).astype(np.int64),
        "ss_item_sk": rng.integers(1, n_item + 1, n_ss).astype(np.int64),
        "ss_customer_sk": rng.integers(1, n_cust + 1, n_ss).astype(np.int64),
        "ss_cdemo_sk": rng.integers(1, n_cdemo + 1, n_ss).astype(np.int64),
        "ss_hdemo_sk": rng.integers(1, n_hdemo + 1, n_ss).astype(np.int64),
        "ss_store_sk": rng.integers(1, n_store + 1, n_ss).astype(np.int64),
        "ss_promo_sk": rng.integers(1, n_promo + 1, n_ss).astype(np.int64),
        "ss_quantity": qty,
        "ss_list_price": list_price,
        "ss_sales_price": sales_price,
        "ss_ext_sales_price": np.round(sales_price * qty, 2),
        "ss_coupon_amt": np.round(rng.uniform(0, 20.0, n_ss) * (rng.random(n_ss) < 0.3), 2),
    }

    return {
        "date_dim": date_dim,
        "time_dim": time_dim,
        "item": item,
        "customer": customer,
        "customer_address": customer_address,
        "customer_demographics": customer_demographics,
        "household_demographics": household_demographics,
        "promotion": promotion,
        "store": store,
        "store_sales": store_sales,
    }


def as_frames(tables: Tables, device=None, **kwargs):
    """Every table as a ``TensorFrame`` on ``device`` (default
    ``CONFIG.device``)."""
    from repro_torch.core import TensorFrame

    return {
        name: TensorFrame.from_arrays(cols, device=device, **kwargs)
        for name, cols in tables.items()
    }


def as_store(tables: Tables, *, chunk_rows: int = 1 << 16, sort_fact_by_date: bool = False):
    """Tables as chunked ``repro_torch.store`` tables (host-side; frames
    reach a device through ``TensorFrame.from_store``).

    ``sort_fact_by_date`` clusters ``store_sales`` by its sold-date key
    before chunking so date-keyed zone maps become selective (the
    layout a date-partitioned warehouse load produces).
    """
    from repro_torch import store as storelib

    out = {}
    for name, cols in tables.items():
        cols = dict(cols)
        if sort_fact_by_date and name == "store_sales":
            order = np.argsort(cols["ss_sold_date_sk"], kind="stable")
            cols = {c: v[order] for c, v in cols.items()}
        out[name] = storelib.Table.from_arrays(cols, chunk_rows=chunk_rows)
    return out
