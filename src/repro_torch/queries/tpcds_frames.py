"""The paper's five TPC-DS queries (Fig. 9) in the TensorFrame API."""
from __future__ import annotations

from repro_torch.core import col


def q3(t, sf=1.0, apply_limit=True):
    dt = t["date_dim"].filter(col("d_moy") == 11).select(["d_date_sk", "d_year"])
    it = t["item"].filter(col("i_manufact_id") == 128).select(
        ["i_item_sk", "i_brand_id", "i_brand"]
    )
    ss = t["store_sales"].select(["ss_sold_date_sk", "ss_item_sk", "ss_ext_sales_price"])
    j = ss.join(dt, left_on="ss_sold_date_sk", right_on="d_date_sk")
    j = j.join(it, left_on="ss_item_sk", right_on="i_item_sk")
    res = j.groupby(["d_year", "i_brand_id", "i_brand"]).agg(
        [("sum_agg", "sum", "ss_ext_sales_price")]
    )
    res = res.sort_values(
        ["d_year", "sum_agg", "i_brand_id"], ascending=[True, False, True]
    )
    return res.head(100) if apply_limit else res


def q6(t, sf=1.0, apply_limit=True):
    # scalar subquery 1: the month_seq of 2001-01
    seq_f = t["date_dim"].filter((col("d_year") == 2001) & (col("d_moy") == 1))
    month_seq = int(seq_f.column("d_month_seq")[0])
    dt = t["date_dim"].filter(col("d_month_seq") == month_seq).select(["d_date_sk"])
    # correlated subquery 2: category average price
    cat_avg = t["item"].groupby("i_category").agg([("cat_avg", "mean", "i_current_price")])
    it = t["item"].select(["i_item_sk", "i_category", "i_current_price"]).join(
        cat_avg, on="i_category"
    )
    it = it.filter(col("i_current_price") > 1.2 * col("cat_avg")).select(["i_item_sk"])
    ss = t["store_sales"].select(["ss_sold_date_sk", "ss_item_sk", "ss_customer_sk"])
    j = ss.join(dt, left_on="ss_sold_date_sk", right_on="d_date_sk", how="semi")
    j = j.join(it, left_on="ss_item_sk", right_on="i_item_sk", how="semi")
    j = j.join(
        t["customer"].select(["c_customer_sk", "c_current_addr_sk"]),
        left_on="ss_customer_sk",
        right_on="c_customer_sk",
    )
    j = j.join(
        t["customer_address"].select(["ca_address_sk", "ca_state"]),
        left_on="c_current_addr_sk",
        right_on="ca_address_sk",
    )
    res = j.groupby("ca_state").agg([("cnt", "size", "")])
    res = res.filter(col("cnt") >= 10).rename({"ca_state": "state"})
    res = res.sort_values(["cnt", "state"])
    return res.head(100) if apply_limit else res


def q7(t, sf=1.0, apply_limit=True):
    cd = t["customer_demographics"].filter(
        (col("cd_gender") == "M")
        & (col("cd_marital_status") == "S")
        & (col("cd_education_status") == "College")
    ).select(["cd_demo_sk"])
    dt = t["date_dim"].filter(col("d_year") == 2000).select(["d_date_sk"])
    pr = t["promotion"].filter(
        (col("p_channel_email") == "N") | (col("p_channel_event") == "N")
    ).select(["p_promo_sk"])
    ss = t["store_sales"].select(
        [
            "ss_sold_date_sk", "ss_item_sk", "ss_cdemo_sk", "ss_promo_sk",
            "ss_quantity", "ss_list_price", "ss_coupon_amt", "ss_sales_price",
        ]
    )
    j = ss.join(cd, left_on="ss_cdemo_sk", right_on="cd_demo_sk", how="semi")
    j = j.join(dt, left_on="ss_sold_date_sk", right_on="d_date_sk", how="semi")
    j = j.join(pr, left_on="ss_promo_sk", right_on="p_promo_sk", how="semi")
    j = j.join(t["item"].select(["i_item_sk", "i_item_id"]), left_on="ss_item_sk", right_on="i_item_sk")
    res = j.groupby("i_item_id").agg(
        [
            ("agg1", "mean", "ss_quantity"),
            ("agg2", "mean", "ss_list_price"),
            ("agg3", "mean", "ss_coupon_amt"),
            ("agg4", "mean", "ss_sales_price"),
        ]
    )
    res = res.sort_values("i_item_id")
    return res.head(100) if apply_limit else res


def q42(t, sf=1.0, apply_limit=True):
    dt = t["date_dim"].filter((col("d_moy") == 11) & (col("d_year") == 2000)).select(
        ["d_date_sk", "d_year"]
    )
    it = t["item"].filter(col("i_manager_id") == 1).select(
        ["i_item_sk", "i_category_id", "i_category"]
    )
    ss = t["store_sales"].select(["ss_sold_date_sk", "ss_item_sk", "ss_ext_sales_price"])
    j = ss.join(dt, left_on="ss_sold_date_sk", right_on="d_date_sk")
    j = j.join(it, left_on="ss_item_sk", right_on="i_item_sk")
    res = j.groupby(["d_year", "i_category_id", "i_category"]).agg(
        [("sum_agg", "sum", "ss_ext_sales_price")]
    )
    res = res.sort_values(
        ["sum_agg", "d_year", "i_category_id", "i_category"],
        ascending=[False, True, True, True],
    )
    return res.head(100) if apply_limit else res


def q96(t, sf=1.0, apply_limit=True):
    td = t["time_dim"].filter((col("t_hour") == 20) & (col("t_minute") >= 30)).select(["t_time_sk"])
    hd = t["household_demographics"].filter(col("hd_dep_count") == 7).select(["hd_demo_sk"])
    st = t["store"].filter(col("s_store_name") == "ese").select(["s_store_sk"])
    ss = t["store_sales"].select(["ss_sold_time_sk", "ss_hdemo_sk", "ss_store_sk"])
    j = ss.join(td, left_on="ss_sold_time_sk", right_on="t_time_sk", how="semi")
    j = j.join(hd, left_on="ss_hdemo_sk", right_on="hd_demo_sk", how="semi")
    j = j.join(st, left_on="ss_store_sk", right_on="s_store_sk", how="semi")
    return {"cnt": j.nrows}


ALL = {"q3": q3, "q6": q6, "q7": q7, "q42": q42, "q96": q96}
SCALAR_QUERIES = {"q96"}
