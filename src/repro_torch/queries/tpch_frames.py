"""All 22 TPC-H queries in the TensorFrame API (paper §VI, Fig. 5).

Each function takes ``t`` = dict of TensorFrames keyed by table name.
``apply_limit=False`` disables the final LIMIT so tests can compare the
full result set against the reference implementation (LIMIT with sort
ties is non-deterministic across engines).

Translations follow the paper's style: explicit column selection
(projection pushdown by hand), trait-based filter expressions, and
per-operation chained calls.
"""
from __future__ import annotations

from repro_torch.core import col, d, if_else, lit


def _rev():
    return col("l_extendedprice") * (1 - col("l_discount"))


def q1(t, sf=1.0, apply_limit=True):
    le = t["lineitem"].filter(col("l_shipdate") <= d("1998-12-01") - 90)
    le = le.with_column("disc_price", _rev())
    le = le.with_column("charge", col("disc_price") * (1 + col("l_tax")))
    res = le.groupby(["l_returnflag", "l_linestatus"]).agg(
        [
            ("sum_qty", "sum", "l_quantity"),
            ("sum_base_price", "sum", "l_extendedprice"),
            ("sum_disc_price", "sum", "disc_price"),
            ("sum_charge", "sum", "charge"),
            ("avg_qty", "mean", "l_quantity"),
            ("avg_price", "mean", "l_extendedprice"),
            ("avg_disc", "mean", "l_discount"),
            ("count_order", "size", ""),
        ]
    )
    return res.sort_values(["l_returnflag", "l_linestatus"])


def q2(t, sf=1.0, apply_limit=True):
    p = t["part"].filter((col("p_size") == 15) & col("p_type").str.like("%BRASS"))
    p = p.select(["p_partkey", "p_mfgr"])
    eu = t["region"].filter(col("r_name") == "EUROPE").select(["r_regionkey"])
    n = t["nation"].select(["n_nationkey", "n_name", "n_regionkey"]).join(
        eu, left_on="n_regionkey", right_on="r_regionkey"
    )
    s = t["supplier"].select(
        ["s_suppkey", "s_name", "s_address", "s_nationkey", "s_phone", "s_acctbal", "s_comment"]
    ).join(n, left_on="s_nationkey", right_on="n_nationkey")
    ps = t["partsupp"].select(["ps_partkey", "ps_suppkey", "ps_supplycost"]).join(
        s, left_on="ps_suppkey", right_on="s_suppkey"
    )
    ps = ps.join(p, left_on="ps_partkey", right_on="p_partkey")
    mins = ps.groupby("ps_partkey").agg([("min_cost", "min", "ps_supplycost")])
    ps = ps.join(mins, on="ps_partkey")
    res = ps.filter(col("ps_supplycost") == col("min_cost"))
    res = res.select(
        ["s_acctbal", "s_name", "n_name", "ps_partkey", "p_mfgr", "s_address", "s_phone", "s_comment"]
    ).rename({"ps_partkey": "p_partkey"})
    res = res.sort_values(
        ["s_acctbal", "n_name", "s_name", "p_partkey"], ascending=[False, True, True, True]
    )
    return res.head(100) if apply_limit else res


def q3(t, sf=1.0, apply_limit=True):
    c = t["customer"].filter(col("c_mktsegment") == "BUILDING").select(["c_custkey"])
    o = t["orders"].filter(col("o_orderdate") < d("1995-03-15")).select(
        ["o_orderkey", "o_custkey", "o_orderdate", "o_shippriority"]
    )
    o = o.join(c, left_on="o_custkey", right_on="c_custkey")
    le = t["lineitem"].filter(col("l_shipdate") > d("1995-03-15")).select(
        ["l_orderkey", "l_extendedprice", "l_discount"]
    )
    j = le.join(o, left_on="l_orderkey", right_on="o_orderkey")
    j = j.with_column("rev", _rev())
    res = j.groupby(["l_orderkey", "o_orderdate", "o_shippriority"]).agg(
        [("revenue", "sum", "rev")]
    )
    res = res.sort_values(["revenue", "o_orderdate"], ascending=[False, True])
    return res.head(10) if apply_limit else res


def q4(t, sf=1.0, apply_limit=True):
    o = t["orders"].filter(
        (col("o_orderdate") >= d("1993-07-01")) & (col("o_orderdate") < d("1993-10-01"))
    )
    late = t["lineitem"].filter(col("l_commitdate") < col("l_receiptdate")).select(["l_orderkey"])
    o = o.join(late, left_on="o_orderkey", right_on="l_orderkey", how="semi")
    return o.groupby("o_orderpriority").agg([("order_count", "size", "")]).sort_values(
        "o_orderpriority"
    )


def q5(t, sf=1.0, apply_limit=True):
    r = t["region"].filter(col("r_name") == "ASIA").select(["r_regionkey"])
    n = t["nation"].select(["n_nationkey", "n_name", "n_regionkey"]).join(
        r, left_on="n_regionkey", right_on="r_regionkey"
    )
    s = t["supplier"].select(["s_suppkey", "s_nationkey"]).join(
        n, left_on="s_nationkey", right_on="n_nationkey"
    )
    o = t["orders"].filter(
        (col("o_orderdate") >= d("1994-01-01")) & (col("o_orderdate") < d("1995-01-01"))
    ).select(["o_orderkey", "o_custkey"])
    le = t["lineitem"].select(["l_orderkey", "l_suppkey", "l_extendedprice", "l_discount"])
    j = le.join(o, left_on="l_orderkey", right_on="o_orderkey")
    j = j.join(s, left_on="l_suppkey", right_on="s_suppkey")
    j = j.join(
        t["customer"].select(["c_custkey", "c_nationkey"]),
        left_on="o_custkey",
        right_on="c_custkey",
    )
    j = j.filter(col("c_nationkey") == col("s_nationkey"))
    j = j.with_column("rev", _rev())
    return (
        j.groupby("n_name")
        .agg([("revenue", "sum", "rev")])
        .sort_values("revenue", ascending=False)
    )


def q6(t, sf=1.0, apply_limit=True):
    le = t["lineitem"].filter(
        (col("l_shipdate") >= d("1994-01-01"))
        & (col("l_shipdate") < d("1995-01-01"))
        & (col("l_discount") >= 0.05)
        & (col("l_discount") <= 0.07)
        & (col("l_quantity") < 24.0)
    )
    le = le.with_column("rev", col("l_extendedprice") * col("l_discount"))
    return le.agg([("revenue", "sum", "rev")])


def q7(t, sf=1.0, apply_limit=True):
    n1 = t["nation"].select(["n_nationkey", "n_name"]).rename(
        {"n_nationkey": "s_nk", "n_name": "supp_nation"}
    )
    n2 = t["nation"].select(["n_nationkey", "n_name"]).rename(
        {"n_nationkey": "c_nk", "n_name": "cust_nation"}
    )
    s = t["supplier"].select(["s_suppkey", "s_nationkey"]).join(
        n1, left_on="s_nationkey", right_on="s_nk"
    )
    c = t["customer"].select(["c_custkey", "c_nationkey"]).join(
        n2, left_on="c_nationkey", right_on="c_nk"
    )
    le = t["lineitem"].filter(
        (col("l_shipdate") >= d("1995-01-01")) & (col("l_shipdate") <= d("1996-12-31"))
    ).select(["l_orderkey", "l_suppkey", "l_extendedprice", "l_discount", "l_shipdate"])
    j = le.join(s, left_on="l_suppkey", right_on="s_suppkey")
    j = j.join(t["orders"].select(["o_orderkey", "o_custkey"]), left_on="l_orderkey", right_on="o_orderkey")
    j = j.join(c, left_on="o_custkey", right_on="c_custkey")
    j = j.filter(
        ((col("supp_nation") == "FRANCE") & (col("cust_nation") == "GERMANY"))
        | ((col("supp_nation") == "GERMANY") & (col("cust_nation") == "FRANCE"))
    )
    j = j.with_column("l_year", col("l_shipdate").dt.year()).with_column("volume", _rev())
    return (
        j.groupby(["supp_nation", "cust_nation", "l_year"])
        .agg([("revenue", "sum", "volume")])
        .sort_values(["supp_nation", "cust_nation", "l_year"])
    )


def q8(t, sf=1.0, apply_limit=True):
    am = t["region"].filter(col("r_name") == "AMERICA").select(["r_regionkey"])
    n_am = t["nation"].select(["n_nationkey", "n_regionkey"]).join(
        am, left_on="n_regionkey", right_on="r_regionkey"
    )
    c = t["customer"].select(["c_custkey", "c_nationkey"]).join(
        n_am.select(["n_nationkey"]), left_on="c_nationkey", right_on="n_nationkey", how="semi"
    )
    p = t["part"].filter(col("p_type") == "ECONOMY ANODIZED STEEL").select(["p_partkey"])
    o = t["orders"].filter(
        (col("o_orderdate") >= d("1995-01-01")) & (col("o_orderdate") <= d("1996-12-31"))
    ).select(["o_orderkey", "o_custkey", "o_orderdate"])
    le = t["lineitem"].select(
        ["l_orderkey", "l_partkey", "l_suppkey", "l_extendedprice", "l_discount"]
    )
    j = le.join(p, left_on="l_partkey", right_on="p_partkey")
    j = j.join(o, left_on="l_orderkey", right_on="o_orderkey")
    j = j.join(c, left_on="o_custkey", right_on="c_custkey")
    n2 = t["nation"].select(["n_nationkey", "n_name"]).rename({"n_name": "supp_nation"})
    j = j.join(t["supplier"].select(["s_suppkey", "s_nationkey"]), left_on="l_suppkey", right_on="s_suppkey")
    j = j.join(n2, left_on="s_nationkey", right_on="n_nationkey")
    j = j.with_column("volume", _rev()).with_column("o_year", col("o_orderdate").dt.year())
    j = j.with_column(
        "brazil_volume", if_else(col("supp_nation") == "BRAZIL", col("volume"), lit(0.0))
    )
    g = j.groupby("o_year").agg(
        [("bv", "sum", "brazil_volume"), ("tv", "sum", "volume")]
    )
    g = g.with_column("mkt_share", col("bv") / col("tv"))
    return g.select(["o_year", "mkt_share"]).sort_values("o_year")


def q9(t, sf=1.0, apply_limit=True):
    p = t["part"].filter(col("p_name").str.contains("green")).select(["p_partkey"])
    le = t["lineitem"].select(
        ["l_orderkey", "l_partkey", "l_suppkey", "l_quantity", "l_extendedprice", "l_discount"]
    )
    j = le.join(p, left_on="l_partkey", right_on="p_partkey")
    j = j.join(t["supplier"].select(["s_suppkey", "s_nationkey"]), left_on="l_suppkey", right_on="s_suppkey")
    j = j.join(
        t["partsupp"].select(["ps_partkey", "ps_suppkey", "ps_supplycost"]),
        left_on=["l_partkey", "l_suppkey"],
        right_on=["ps_partkey", "ps_suppkey"],
    )
    j = j.join(t["orders"].select(["o_orderkey", "o_orderdate"]), left_on="l_orderkey", right_on="o_orderkey")
    j = j.join(t["nation"].select(["n_nationkey", "n_name"]), left_on="s_nationkey", right_on="n_nationkey")
    j = j.with_column("o_year", col("o_orderdate").dt.year())
    j = j.with_column("amount", _rev() - col("ps_supplycost") * col("l_quantity"))
    return (
        j.groupby(["n_name", "o_year"])
        .agg([("sum_profit", "sum", "amount")])
        .sort_values(["n_name", "o_year"], ascending=[True, False])
    )


def q10(t, sf=1.0, apply_limit=True):
    o = t["orders"].filter(
        (col("o_orderdate") >= d("1993-10-01")) & (col("o_orderdate") < d("1994-01-01"))
    ).select(["o_orderkey", "o_custkey"])
    le = t["lineitem"].filter(col("l_returnflag") == "R").select(
        ["l_orderkey", "l_extendedprice", "l_discount"]
    )
    j = le.join(o, left_on="l_orderkey", right_on="o_orderkey")
    j = j.join(
        t["customer"].select(
            ["c_custkey", "c_name", "c_acctbal", "c_phone", "c_nationkey", "c_address", "c_comment"]
        ),
        left_on="o_custkey",
        right_on="c_custkey",
    )
    j = j.join(t["nation"].select(["n_nationkey", "n_name"]), left_on="c_nationkey", right_on="n_nationkey")
    j = j.with_column("rev", _rev())
    res = j.groupby(
        ["o_custkey", "c_name", "c_acctbal", "c_phone", "n_name", "c_address", "c_comment"]
    ).agg([("revenue", "sum", "rev")])
    res = res.sort_values("revenue", ascending=False)
    return res.head(20) if apply_limit else res


def q11(t, sf=1.0, apply_limit=True):
    g = t["nation"].filter(col("n_name") == "GERMANY").select(["n_nationkey"])
    s = t["supplier"].select(["s_suppkey", "s_nationkey"]).join(
        g, left_on="s_nationkey", right_on="n_nationkey", how="semi"
    )
    ps = t["partsupp"].select(["ps_partkey", "ps_suppkey", "ps_availqty", "ps_supplycost"])
    ps = ps.join(s.select(["s_suppkey"]), left_on="ps_suppkey", right_on="s_suppkey", how="semi")
    ps = ps.with_column("value", col("ps_supplycost") * col("ps_availqty"))
    total = ps.agg([("tv", "sum", "value")])["tv"]
    res = ps.groupby("ps_partkey").agg([("value", "sum", "value")])
    res = res.filter(col("value") > total * (0.0001 / sf))
    return res.sort_values("value", ascending=False)


def q12(t, sf=1.0, apply_limit=True):
    le = t["lineitem"].filter(
        col("l_shipmode").isin(["MAIL", "SHIP"])
        & (col("l_commitdate") < col("l_receiptdate"))
        & (col("l_shipdate") < col("l_commitdate"))
        & (col("l_receiptdate") >= d("1994-01-01"))
        & (col("l_receiptdate") < d("1995-01-01"))
    ).select(["l_orderkey", "l_shipmode"])
    j = le.join(
        t["orders"].select(["o_orderkey", "o_orderpriority"]),
        left_on="l_orderkey",
        right_on="o_orderkey",
    )
    j = j.with_column(
        "high", if_else(col("o_orderpriority").isin(["1-URGENT", "2-HIGH"]), lit(1), lit(0))
    )
    j = j.with_column("low", 1 - col("high"))
    return (
        j.groupby("l_shipmode")
        .agg([("high_line_count", "sum", "high"), ("low_line_count", "sum", "low")])
        .sort_values("l_shipmode")
    )


def q13(t, sf=1.0, apply_limit=True):
    o = t["orders"].filter(
        col("o_comment").str.not_exists_before("special", "requests")
    ).select(["o_orderkey", "o_custkey"])
    c = t["customer"].select(["c_custkey"])
    j = c.join(o, left_on="c_custkey", right_on="o_custkey", how="left")
    counts = j.groupby("c_custkey").agg([("c_count", "count", "o_orderkey")])
    hist = counts.groupby("c_count").agg([("custdist", "size", "")])
    return hist.sort_values(["custdist", "c_count"], ascending=[False, False])


def q14(t, sf=1.0, apply_limit=True):
    le = t["lineitem"].filter(
        (col("l_shipdate") >= d("1995-09-01")) & (col("l_shipdate") < d("1995-10-01"))
    ).select(["l_partkey", "l_extendedprice", "l_discount"])
    j = le.join(t["part"].select(["p_partkey", "p_type"]), left_on="l_partkey", right_on="p_partkey")
    j = j.with_column("rev", _rev())
    j = j.with_column(
        "promo", if_else(col("p_type").str.like("PROMO%"), col("rev"), lit(0.0))
    )
    s = j.agg([("p", "sum", "promo"), ("r", "sum", "rev")])
    return {"promo_revenue": 100.0 * s["p"] / s["r"]}


def q15(t, sf=1.0, apply_limit=True):
    le = t["lineitem"].filter(
        (col("l_shipdate") >= d("1996-01-01")) & (col("l_shipdate") < d("1996-04-01"))
    ).select(["l_suppkey", "l_extendedprice", "l_discount"])
    le = le.with_column("rev", _rev())
    g = le.groupby("l_suppkey").agg([("total_revenue", "sum", "rev")])
    mx = g.agg([("m", "max", "total_revenue")])["m"]
    top = g.filter(col("total_revenue") == mx)
    res = t["supplier"].select(["s_suppkey", "s_name", "s_address", "s_phone"]).join(
        top, left_on="s_suppkey", right_on="l_suppkey"
    )
    return res.drop(["l_suppkey"]).sort_values("s_suppkey")


def q16(t, sf=1.0, apply_limit=True):
    bad = t["supplier"].filter(
        col("s_comment").str.exists_before("Customer", "Complaints")
    ).select(["s_suppkey"])
    p = t["part"].filter(
        (col("p_brand") != "Brand#45")
        & ~col("p_type").str.like("MEDIUM POLISHED%")
        & col("p_size").isin([49, 14, 23, 45, 19, 3, 36, 9])
    ).select(["p_partkey", "p_brand", "p_type", "p_size"])
    ps = t["partsupp"].select(["ps_partkey", "ps_suppkey"]).join(
        p, left_on="ps_partkey", right_on="p_partkey"
    )
    ps = ps.join(bad, left_on="ps_suppkey", right_on="s_suppkey", how="anti")
    res = ps.groupby(["p_brand", "p_type", "p_size"]).agg(
        [("supplier_cnt", "nunique", "ps_suppkey")]
    )
    return res.sort_values(
        ["supplier_cnt", "p_brand", "p_type", "p_size"], ascending=[False, True, True, True]
    )


def q17(t, sf=1.0, apply_limit=True):
    p = t["part"].filter(
        (col("p_brand") == "Brand#23") & (col("p_container") == "MED BOX")
    ).select(["p_partkey"])
    le = t["lineitem"].select(["l_partkey", "l_quantity", "l_extendedprice"])
    j = le.join(p, left_on="l_partkey", right_on="p_partkey")
    avg_q = j.groupby("l_partkey").agg([("avg_qty", "mean", "l_quantity")])
    j = j.join(avg_q, on="l_partkey")
    j = j.filter(col("l_quantity") < 0.2 * col("avg_qty"))
    s = j.agg([("s", "sum", "l_extendedprice")])
    return {"avg_yearly": s["s"] / 7.0}


def q18(t, sf=1.0, apply_limit=True):
    big = t["lineitem"].groupby("l_orderkey").agg([("sum_qty", "sum", "l_quantity")])
    big = big.filter(col("sum_qty") > 300.0)
    o = t["orders"].select(["o_orderkey", "o_custkey", "o_orderdate", "o_totalprice"]).join(
        big, left_on="o_orderkey", right_on="l_orderkey"
    )
    j = o.join(t["customer"].select(["c_custkey", "c_name"]), left_on="o_custkey", right_on="c_custkey")
    res = j.select(["c_name", "o_custkey", "o_orderkey", "o_orderdate", "o_totalprice", "sum_qty"])
    res = res.sort_values(["o_totalprice", "o_orderdate"], ascending=[False, True])
    return res.head(100) if apply_limit else res


def q19(t, sf=1.0, apply_limit=True):
    le = t["lineitem"].filter(
        col("l_shipmode").isin(["AIR", "AIR REG"])
        & (col("l_shipinstruct") == "DELIVER IN PERSON")
    ).select(["l_partkey", "l_quantity", "l_extendedprice", "l_discount"])
    j = le.join(
        t["part"].select(["p_partkey", "p_brand", "p_size", "p_container"]),
        left_on="l_partkey",
        right_on="p_partkey",
    )
    b1 = (
        (col("p_brand") == "Brand#12")
        & col("p_container").isin(["SM CASE", "SM BOX", "SM PACK", "SM PKG"])
        & col("l_quantity").between(1.0, 11.0)
        & col("p_size").between(1, 5)
    )
    b2 = (
        (col("p_brand") == "Brand#23")
        & col("p_container").isin(["MED BAG", "MED BOX", "MED PKG", "MED PACK"])
        & col("l_quantity").between(10.0, 20.0)
        & col("p_size").between(1, 10)
    )
    b3 = (
        (col("p_brand") == "Brand#34")
        & col("p_container").isin(["LG CASE", "LG BOX", "LG PACK", "LG PKG"])
        & col("l_quantity").between(20.0, 30.0)
        & col("p_size").between(1, 15)
    )
    j = j.filter(b1 | b2 | b3)
    j = j.with_column("rev", _rev())
    return j.agg([("revenue", "sum", "rev")])


def q20(t, sf=1.0, apply_limit=True):
    p = t["part"].filter(col("p_name").str.like("forest%")).select(["p_partkey"])
    l94 = t["lineitem"].filter(
        (col("l_shipdate") >= d("1994-01-01")) & (col("l_shipdate") < d("1995-01-01"))
    ).select(["l_partkey", "l_suppkey", "l_quantity"])
    sums = l94.groupby(["l_partkey", "l_suppkey"]).agg([("qty", "sum", "l_quantity")])
    ps = t["partsupp"].select(["ps_partkey", "ps_suppkey", "ps_availqty"]).join(
        p, left_on="ps_partkey", right_on="p_partkey"
    )
    ps = ps.join(sums, left_on=["ps_partkey", "ps_suppkey"], right_on=["l_partkey", "l_suppkey"])
    ok = ps.filter(col("ps_availqty").cast_float() > 0.5 * col("qty")).select(["ps_suppkey"])
    ca = t["nation"].filter(col("n_name") == "CANADA").select(["n_nationkey"])
    s = t["supplier"].select(["s_suppkey", "s_name", "s_address", "s_nationkey"]).join(
        ca, left_on="s_nationkey", right_on="n_nationkey", how="semi"
    )
    s = s.join(ok, left_on="s_suppkey", right_on="ps_suppkey", how="semi")
    return s.select(["s_name", "s_address"]).sort_values("s_name")


def q21(t, sf=1.0, apply_limit=True):
    sa = t["nation"].filter(col("n_name") == "SAUDI ARABIA").select(["n_nationkey"])
    s = t["supplier"].select(["s_suppkey", "s_name", "s_nationkey"]).join(
        sa, left_on="s_nationkey", right_on="n_nationkey", how="semi"
    )
    fo = t["orders"].filter(col("o_orderstatus") == "F").select(["o_orderkey"])
    le = t["lineitem"].select(["l_orderkey", "l_suppkey", "l_receiptdate", "l_commitdate"])
    l1 = le.filter(col("l_receiptdate") > col("l_commitdate"))
    l1 = l1.join(fo, left_on="l_orderkey", right_on="o_orderkey", how="semi")
    l1 = l1.join(s.select(["s_suppkey", "s_name"]), left_on="l_suppkey", right_on="s_suppkey")
    nsupp = le.groupby("l_orderkey").agg([("nsupp", "nunique", "l_suppkey")])
    nlate = le.filter(col("l_receiptdate") > col("l_commitdate")).groupby("l_orderkey").agg(
        [("nlate", "nunique", "l_suppkey")]
    )
    l1 = l1.join(nsupp, on="l_orderkey").join(nlate, on="l_orderkey")
    l1 = l1.filter((col("nsupp") >= 2) & (col("nlate") == 1))
    res = l1.groupby("s_name").agg([("numwait", "size", "")])
    res = res.sort_values(["numwait", "s_name"], ascending=[False, True])
    return res.head(100) if apply_limit else res


def q22(t, sf=1.0, apply_limit=True):
    codes = ["13", "31", "23", "29", "30", "18", "17"]
    c = t["customer"].select(["c_custkey", "c_phone", "c_acctbal"])
    c = c.with_column("cntrycode", col("c_phone").str.slice(0, 2))
    c = c.filter(col("cntrycode").isin(codes))
    avg_bal = c.filter(col("c_acctbal") > 0.0).agg([("a", "mean", "c_acctbal")])["a"]
    c = c.filter(col("c_acctbal") > avg_bal)
    c = c.join(t["orders"].select(["o_custkey"]), left_on="c_custkey", right_on="o_custkey", how="anti")
    return (
        c.groupby("cntrycode")
        .agg([("numcust", "size", ""), ("totacctbal", "sum", "c_acctbal")])
        .sort_values("cntrycode")
    )


ALL = {f"q{i}": globals()[f"q{i}"] for i in range(1, 23)}
SCALAR_QUERIES = {"q6", "q14", "q17", "q19"}
