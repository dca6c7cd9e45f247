"""Reference TPC-DS implementations (row-at-a-time, independent)."""
from __future__ import annotations

from collections import defaultdict

from .tpch_numpy import rows_of


def q3(T, sf=1.0):
    dates = {r["d_date_sk"]: r["d_year"] for r in rows_of(T["date_dim"]) if r["d_moy"] == 11}
    items = {
        r["i_item_sk"]: (r["i_brand_id"], r["i_brand"])
        for r in rows_of(T["item"])
        if r["i_manufact_id"] == 128
    }
    acc = defaultdict(float)
    for r in rows_of(T["store_sales"]):
        if r["ss_sold_date_sk"] in dates and r["ss_item_sk"] in items:
            b = items[r["ss_item_sk"]]
            acc[(dates[r["ss_sold_date_sk"]], b[0], b[1])] += r["ss_ext_sales_price"]
    return [
        {"d_year": k[0], "i_brand_id": k[1], "i_brand": k[2], "sum_agg": v}
        for k, v in acc.items()
    ]


def q6(T, sf=1.0):
    seqs = {
        r["d_month_seq"]
        for r in rows_of(T["date_dim"])
        if r["d_year"] == 2001 and r["d_moy"] == 1
    }
    dates = {r["d_date_sk"] for r in rows_of(T["date_dim"]) if r["d_month_seq"] in seqs}
    items = rows_of(T["item"])
    cat_sum = defaultdict(float)
    cat_cnt = defaultdict(int)
    for r in items:
        cat_sum[r["i_category"]] += r["i_current_price"]
        cat_cnt[r["i_category"]] += 1
    pricey = {
        r["i_item_sk"]
        for r in items
        if r["i_current_price"] > 1.2 * cat_sum[r["i_category"]] / cat_cnt[r["i_category"]]
    }
    addr = {r["ca_address_sk"]: r["ca_state"] for r in rows_of(T["customer_address"])}
    cust = {r["c_customer_sk"]: addr[r["c_current_addr_sk"]] for r in rows_of(T["customer"])}
    acc = defaultdict(int)
    for r in rows_of(T["store_sales"]):
        if r["ss_sold_date_sk"] in dates and r["ss_item_sk"] in pricey:
            acc[cust[r["ss_customer_sk"]]] += 1
    return [{"state": k, "cnt": v} for k, v in acc.items() if v >= 10]


def q7(T, sf=1.0):
    cd = {
        r["cd_demo_sk"]
        for r in rows_of(T["customer_demographics"])
        if r["cd_gender"] == "M"
        and r["cd_marital_status"] == "S"
        and r["cd_education_status"] == "College"
    }
    dates = {r["d_date_sk"] for r in rows_of(T["date_dim"]) if r["d_year"] == 2000}
    promos = {
        r["p_promo_sk"]
        for r in rows_of(T["promotion"])
        if r["p_channel_email"] == "N" or r["p_channel_event"] == "N"
    }
    item_id = {r["i_item_sk"]: r["i_item_id"] for r in rows_of(T["item"])}
    acc = defaultdict(lambda: [0.0, 0.0, 0.0, 0.0, 0])
    for r in rows_of(T["store_sales"]):
        if (
            r["ss_cdemo_sk"] in cd
            and r["ss_sold_date_sk"] in dates
            and r["ss_promo_sk"] in promos
        ):
            a = acc[item_id[r["ss_item_sk"]]]
            a[0] += r["ss_quantity"]
            a[1] += r["ss_list_price"]
            a[2] += r["ss_coupon_amt"]
            a[3] += r["ss_sales_price"]
            a[4] += 1
    return [
        {
            "i_item_id": k,
            "agg1": v[0] / v[4],
            "agg2": v[1] / v[4],
            "agg3": v[2] / v[4],
            "agg4": v[3] / v[4],
        }
        for k, v in acc.items()
    ]


def q42(T, sf=1.0):
    dates = {
        r["d_date_sk"]: r["d_year"]
        for r in rows_of(T["date_dim"])
        if r["d_moy"] == 11 and r["d_year"] == 2000
    }
    items = {
        r["i_item_sk"]: (r["i_category_id"], r["i_category"])
        for r in rows_of(T["item"])
        if r["i_manager_id"] == 1
    }
    acc = defaultdict(float)
    for r in rows_of(T["store_sales"]):
        if r["ss_sold_date_sk"] in dates and r["ss_item_sk"] in items:
            c = items[r["ss_item_sk"]]
            acc[(dates[r["ss_sold_date_sk"]], c[0], c[1])] += r["ss_ext_sales_price"]
    return [
        {"d_year": k[0], "i_category_id": k[1], "i_category": k[2], "sum_agg": v}
        for k, v in acc.items()
    ]


def q96(T, sf=1.0):
    times = {
        r["t_time_sk"]
        for r in rows_of(T["time_dim"])
        if r["t_hour"] == 20 and r["t_minute"] >= 30
    }
    hd = {r["hd_demo_sk"] for r in rows_of(T["household_demographics"]) if r["hd_dep_count"] == 7}
    stores = {r["s_store_sk"] for r in rows_of(T["store"]) if r["s_store_name"] == "ese"}
    cnt = 0
    for r in rows_of(T["store_sales"]):
        if (
            r["ss_sold_time_sk"] in times
            and r["ss_hdemo_sk"] in hd
            and r["ss_store_sk"] in stores
        ):
            cnt += 1
    return {"cnt": cnt}


ALL = {"q3": q3, "q6": q6, "q7": q7, "q42": q42, "q96": q96}
