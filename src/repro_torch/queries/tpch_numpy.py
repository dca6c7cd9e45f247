"""Reference TPC-H implementations: row-at-a-time Python, written
directly from the SQL text, independent of the TensorFrame engine.

Used only for correctness testing (tests compare full result sets,
unsorted, no LIMIT).  Dates are integer epoch-days.
"""
from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List

import numpy as np


def dd(s: str) -> int:
    return int(np.datetime64(s, "D").astype(np.int64))


def rows_of(tbl: Dict[str, np.ndarray]) -> List[dict]:
    conv = {}
    n = None
    for k, arr in tbl.items():
        arr = np.asarray(arr)
        n = arr.shape[0] if n is None else n
        if np.issubdtype(arr.dtype, np.datetime64):
            conv[k] = arr.astype("datetime64[D]").astype(np.int64).tolist()
        elif np.issubdtype(arr.dtype, np.floating):
            conv[k] = [float(x) for x in arr]
        elif np.issubdtype(arr.dtype, np.integer):
            conv[k] = [int(x) for x in arr]
        else:
            conv[k] = [str(x) for x in arr]
    return [dict(zip(conv.keys(), vals)) for vals in zip(*conv.values())]


def gagg(rs: List[dict], keys: List[str], aggs: List[tuple]) -> List[dict]:
    """aggs: (out_name, fn, col_or_callable); fn in sum/mean/min/max/
    count/size/nunique."""
    groups: Dict[tuple, List[dict]] = defaultdict(list)
    for r in rs:
        groups[tuple(r[k] for k in keys)].append(r)
    out = []
    for key, members in groups.items():
        rec = dict(zip(keys, key))
        for out_name, fn, colspec in aggs:
            get = colspec if callable(colspec) else (lambda r, c=colspec: r[c])
            if fn == "size":
                rec[out_name] = len(members)
            else:
                vals = [get(r) for r in members]
                vals = [v for v in vals if v is not None]
                if fn == "count":
                    rec[out_name] = len(vals)
                elif fn == "nunique":
                    rec[out_name] = len(set(vals))
                elif fn == "sum":
                    rec[out_name] = sum(vals) if vals else None
                elif fn == "mean":
                    rec[out_name] = sum(vals) / len(vals) if vals else None
                elif fn == "min":
                    rec[out_name] = min(vals) if vals else None
                elif fn == "max":
                    rec[out_name] = max(vals) if vals else None
                else:
                    raise ValueError(fn)
        out.append(rec)
    return out


def hjoin(
    left: List[dict],
    right: List[dict],
    lkeys: List[str],
    rkeys: List[str],
    how: str = "inner",
    keep: List[str] = None,
) -> List[dict]:
    idx: Dict[tuple, List[dict]] = defaultdict(list)
    for r in right:
        idx[tuple(r[k] for k in rkeys)].append(r)
    out = []
    for l in left:
        key = tuple(l[k] for k in lkeys)
        matches = idx.get(key, [])
        if how == "semi":
            if matches:
                out.append(dict(l))
            continue
        if how == "anti":
            if not matches:
                out.append(dict(l))
            continue
        if matches:
            for r in matches:
                rec = dict(l)
                for k, v in r.items():
                    if k not in lkeys or k not in rec:
                        rec.setdefault(k, v)
                out.append(rec)
        elif how == "left":
            rec = dict(l)
            for k in right[0].keys() if right else []:
                rec.setdefault(k, None)
            out.append(rec)
    return out


def year_of(days: int) -> int:
    return int(np.int64(days).astype("datetime64[D]").astype("datetime64[Y]").astype(int)) + 1970


def _not_exists_before(s: str, a: str, b: str) -> bool:
    i = s.find(a)
    return not (i >= 0 and s.find(b, i + len(a)) >= 0)


# ----------------------------------------------------------------------
def q1(T, sf=1.0):
    cutoff = dd("1998-12-01") - 90
    rs = [r for r in rows_of(T["lineitem"]) if r["l_shipdate"] <= cutoff]
    return gagg(
        rs,
        ["l_returnflag", "l_linestatus"],
        [
            ("sum_qty", "sum", "l_quantity"),
            ("sum_base_price", "sum", "l_extendedprice"),
            ("sum_disc_price", "sum", lambda r: r["l_extendedprice"] * (1 - r["l_discount"])),
            ("sum_charge", "sum", lambda r: r["l_extendedprice"] * (1 - r["l_discount"]) * (1 + r["l_tax"])),
            ("avg_qty", "mean", "l_quantity"),
            ("avg_price", "mean", "l_extendedprice"),
            ("avg_disc", "mean", "l_discount"),
            ("count_order", "size", ""),
        ],
    )


def q2(T, sf=1.0):
    parts = {
        r["p_partkey"]: r
        for r in rows_of(T["part"])
        if r["p_size"] == 15 and r["p_type"].endswith("BRASS")
    }
    eu = {r["r_regionkey"] for r in rows_of(T["region"]) if r["r_name"] == "EUROPE"}
    nat = {r["n_nationkey"]: r for r in rows_of(T["nation"]) if r["n_regionkey"] in eu}
    supp = {r["s_suppkey"]: r for r in rows_of(T["supplier"]) if r["s_nationkey"] in nat}
    ps = [
        r
        for r in rows_of(T["partsupp"])
        if r["ps_partkey"] in parts and r["ps_suppkey"] in supp
    ]
    mins: Dict[int, float] = {}
    for r in ps:
        k = r["ps_partkey"]
        mins[k] = min(mins.get(k, math.inf), r["ps_supplycost"])
    out = []
    for r in ps:
        if r["ps_supplycost"] == mins[r["ps_partkey"]]:
            s = supp[r["ps_suppkey"]]
            out.append(
                {
                    "s_acctbal": s["s_acctbal"],
                    "s_name": s["s_name"],
                    "n_name": nat[s["s_nationkey"]]["n_name"],
                    "p_partkey": r["ps_partkey"],
                    "p_mfgr": parts[r["ps_partkey"]]["p_mfgr"],
                    "s_address": s["s_address"],
                    "s_phone": s["s_phone"],
                    "s_comment": s["s_comment"],
                }
            )
    return out


def q3(T, sf=1.0):
    cutoff = dd("1995-03-15")
    cust = {r["c_custkey"] for r in rows_of(T["customer"]) if r["c_mktsegment"] == "BUILDING"}
    orders = {
        r["o_orderkey"]: r
        for r in rows_of(T["orders"])
        if r["o_orderdate"] < cutoff and r["o_custkey"] in cust
    }
    acc = defaultdict(float)
    meta = {}
    for r in rows_of(T["lineitem"]):
        if r["l_shipdate"] > cutoff and r["l_orderkey"] in orders:
            o = orders[r["l_orderkey"]]
            k = (r["l_orderkey"], o["o_orderdate"], o["o_shippriority"])
            acc[k] += r["l_extendedprice"] * (1 - r["l_discount"])
            meta[k] = o
    return [
        {"l_orderkey": k[0], "o_orderdate": k[1], "o_shippriority": k[2], "revenue": v}
        for k, v in acc.items()
    ]


def q4(T, sf=1.0):
    lo, hi = dd("1993-07-01"), dd("1993-10-01")
    late = {r["l_orderkey"] for r in rows_of(T["lineitem"]) if r["l_commitdate"] < r["l_receiptdate"]}
    rs = [
        r
        for r in rows_of(T["orders"])
        if lo <= r["o_orderdate"] < hi and r["o_orderkey"] in late
    ]
    return gagg(rs, ["o_orderpriority"], [("order_count", "size", "")])


def q5(T, sf=1.0):
    asia = {r["r_regionkey"] for r in rows_of(T["region"]) if r["r_name"] == "ASIA"}
    nat = {r["n_nationkey"]: r["n_name"] for r in rows_of(T["nation"]) if r["n_regionkey"] in asia}
    supp = {r["s_suppkey"]: r["s_nationkey"] for r in rows_of(T["supplier"]) if r["s_nationkey"] in nat}
    cust = {r["c_custkey"]: r["c_nationkey"] for r in rows_of(T["customer"])}
    lo, hi = dd("1994-01-01"), dd("1995-01-01")
    orders = {
        r["o_orderkey"]: r["o_custkey"]
        for r in rows_of(T["orders"])
        if lo <= r["o_orderdate"] < hi
    }
    acc = defaultdict(float)
    for r in rows_of(T["lineitem"]):
        ok, sk = r["l_orderkey"], r["l_suppkey"]
        if ok in orders and sk in supp:
            cnk = cust[orders[ok]]
            snk = supp[sk]
            if cnk == snk:
                acc[nat[snk]] += r["l_extendedprice"] * (1 - r["l_discount"])
    return [{"n_name": k, "revenue": v} for k, v in acc.items()]


def q6(T, sf=1.0):
    lo, hi = dd("1994-01-01"), dd("1995-01-01")
    tot = 0.0
    for r in rows_of(T["lineitem"]):
        if (
            lo <= r["l_shipdate"] < hi
            and 0.05 - 1e-12 <= r["l_discount"] <= 0.07 + 1e-12
            and r["l_quantity"] < 24
        ):
            tot += r["l_extendedprice"] * r["l_discount"]
    return {"revenue": tot}


def q7(T, sf=1.0):
    nat = {r["n_nationkey"]: r["n_name"] for r in rows_of(T["nation"])}
    supp = {r["s_suppkey"]: nat[r["s_nationkey"]] for r in rows_of(T["supplier"])}
    cust = {r["c_custkey"]: nat[r["c_nationkey"]] for r in rows_of(T["customer"])}
    orders = {r["o_orderkey"]: r["o_custkey"] for r in rows_of(T["orders"])}
    lo, hi = dd("1995-01-01"), dd("1996-12-31")
    acc = defaultdict(float)
    for r in rows_of(T["lineitem"]):
        if not (lo <= r["l_shipdate"] <= hi):
            continue
        sn = supp[r["l_suppkey"]]
        cn = cust[orders[r["l_orderkey"]]]
        if (sn, cn) in (("FRANCE", "GERMANY"), ("GERMANY", "FRANCE")):
            key = (sn, cn, year_of(r["l_shipdate"]))
            acc[key] += r["l_extendedprice"] * (1 - r["l_discount"])
    return [
        {"supp_nation": k[0], "cust_nation": k[1], "l_year": k[2], "revenue": v}
        for k, v in acc.items()
    ]


def q8(T, sf=1.0):
    am = {r["r_regionkey"] for r in rows_of(T["region"]) if r["r_name"] == "AMERICA"}
    nat_am = {r["n_nationkey"] for r in rows_of(T["nation"]) if r["n_regionkey"] in am}
    nat_name = {r["n_nationkey"]: r["n_name"] for r in rows_of(T["nation"])}
    cust = {r["c_custkey"] for r in rows_of(T["customer"]) if r["c_nationkey"] in nat_am}
    parts = {r["p_partkey"] for r in rows_of(T["part"]) if r["p_type"] == "ECONOMY ANODIZED STEEL"}
    lo, hi = dd("1995-01-01"), dd("1996-12-31")
    orders = {
        r["o_orderkey"]: r
        for r in rows_of(T["orders"])
        if lo <= r["o_orderdate"] <= hi and r["o_custkey"] in cust
    }
    supp = {r["s_suppkey"]: nat_name[r["s_nationkey"]] for r in rows_of(T["supplier"])}
    bv = defaultdict(float)
    tv = defaultdict(float)
    for r in rows_of(T["lineitem"]):
        if r["l_partkey"] in parts and r["l_orderkey"] in orders:
            o = orders[r["l_orderkey"]]
            y = year_of(o["o_orderdate"])
            vol = r["l_extendedprice"] * (1 - r["l_discount"])
            tv[y] += vol
            if supp[r["l_suppkey"]] == "BRAZIL":
                bv[y] += vol
    return [{"o_year": y, "mkt_share": bv[y] / tv[y]} for y in tv]


def q9(T, sf=1.0):
    parts = {r["p_partkey"] for r in rows_of(T["part"]) if "green" in r["p_name"]}
    nat = {r["n_nationkey"]: r["n_name"] for r in rows_of(T["nation"])}
    supp = {r["s_suppkey"]: nat[r["s_nationkey"]] for r in rows_of(T["supplier"])}
    pscost = {
        (r["ps_partkey"], r["ps_suppkey"]): r["ps_supplycost"] for r in rows_of(T["partsupp"])
    }
    odate = {r["o_orderkey"]: r["o_orderdate"] for r in rows_of(T["orders"])}
    acc = defaultdict(float)
    for r in rows_of(T["lineitem"]):
        if r["l_partkey"] in parts:
            amount = r["l_extendedprice"] * (1 - r["l_discount"]) - pscost[
                (r["l_partkey"], r["l_suppkey"])
            ] * r["l_quantity"]
            key = (supp[r["l_suppkey"]], year_of(odate[r["l_orderkey"]]))
            acc[key] += amount
    return [{"n_name": k[0], "o_year": k[1], "sum_profit": v} for k, v in acc.items()]


def q10(T, sf=1.0):
    lo, hi = dd("1993-10-01"), dd("1994-01-01")
    orders = {
        r["o_orderkey"]: r["o_custkey"]
        for r in rows_of(T["orders"])
        if lo <= r["o_orderdate"] < hi
    }
    cust = {r["c_custkey"]: r for r in rows_of(T["customer"])}
    nat = {r["n_nationkey"]: r["n_name"] for r in rows_of(T["nation"])}
    acc = defaultdict(float)
    for r in rows_of(T["lineitem"]):
        if r["l_returnflag"] == "R" and r["l_orderkey"] in orders:
            ck = orders[r["l_orderkey"]]
            acc[ck] += r["l_extendedprice"] * (1 - r["l_discount"])
    out = []
    for ck, rev in acc.items():
        c = cust[ck]
        out.append(
            {
                "o_custkey": ck,
                "c_name": c["c_name"],
                "c_acctbal": c["c_acctbal"],
                "c_phone": c["c_phone"],
                "n_name": nat[c["c_nationkey"]],
                "c_address": c["c_address"],
                "c_comment": c["c_comment"],
                "revenue": rev,
            }
        )
    return out


def q11(T, sf=1.0):
    ger = {r["n_nationkey"] for r in rows_of(T["nation"]) if r["n_name"] == "GERMANY"}
    supp = {r["s_suppkey"] for r in rows_of(T["supplier"]) if r["s_nationkey"] in ger}
    acc = defaultdict(float)
    total = 0.0
    for r in rows_of(T["partsupp"]):
        if r["ps_suppkey"] in supp:
            v = r["ps_supplycost"] * r["ps_availqty"]
            acc[r["ps_partkey"]] += v
            total += v
    thresh = total * (0.0001 / sf)
    return [{"ps_partkey": k, "value": v} for k, v in acc.items() if v > thresh]


def q12(T, sf=1.0):
    lo, hi = dd("1994-01-01"), dd("1995-01-01")
    prio = {r["o_orderkey"]: r["o_orderpriority"] for r in rows_of(T["orders"])}
    acc = defaultdict(lambda: [0, 0])
    for r in rows_of(T["lineitem"]):
        if (
            r["l_shipmode"] in ("MAIL", "SHIP")
            and r["l_commitdate"] < r["l_receiptdate"]
            and r["l_shipdate"] < r["l_commitdate"]
            and lo <= r["l_receiptdate"] < hi
        ):
            p = prio[r["l_orderkey"]]
            if p in ("1-URGENT", "2-HIGH"):
                acc[r["l_shipmode"]][0] += 1
            else:
                acc[r["l_shipmode"]][1] += 1
    return [
        {"l_shipmode": k, "high_line_count": v[0], "low_line_count": v[1]}
        for k, v in acc.items()
    ]


def q13(T, sf=1.0):
    per_cust = defaultdict(int)
    for r in rows_of(T["orders"]):
        if _not_exists_before(r["o_comment"], "special", "requests"):
            per_cust[r["o_custkey"]] += 1
    hist = defaultdict(int)
    for r in rows_of(T["customer"]):
        hist[per_cust.get(r["c_custkey"], 0)] += 1
    return [{"c_count": k, "custdist": v} for k, v in hist.items()]


def q14(T, sf=1.0):
    lo, hi = dd("1995-09-01"), dd("1995-10-01")
    ptype = {r["p_partkey"]: r["p_type"] for r in rows_of(T["part"])}
    promo = tot = 0.0
    for r in rows_of(T["lineitem"]):
        if lo <= r["l_shipdate"] < hi:
            rev = r["l_extendedprice"] * (1 - r["l_discount"])
            tot += rev
            if ptype[r["l_partkey"]].startswith("PROMO"):
                promo += rev
    return {"promo_revenue": 100.0 * promo / tot}


def q15(T, sf=1.0):
    lo, hi = dd("1996-01-01"), dd("1996-04-01")
    acc = defaultdict(float)
    for r in rows_of(T["lineitem"]):
        if lo <= r["l_shipdate"] < hi:
            acc[r["l_suppkey"]] += r["l_extendedprice"] * (1 - r["l_discount"])
    mx = max(acc.values()) if acc else 0.0
    supp = {r["s_suppkey"]: r for r in rows_of(T["supplier"])}
    out = []
    for sk, rev in acc.items():
        if rev == mx:
            s = supp[sk]
            out.append(
                {
                    "s_suppkey": sk,
                    "s_name": s["s_name"],
                    "s_address": s["s_address"],
                    "s_phone": s["s_phone"],
                    "total_revenue": rev,
                }
            )
    return out


def q16(T, sf=1.0):
    bad = {
        r["s_suppkey"]
        for r in rows_of(T["supplier"])
        if not _not_exists_before(r["s_comment"], "Customer", "Complaints")
    }
    sizes = {49, 14, 23, 45, 19, 3, 36, 9}
    parts = {
        r["p_partkey"]: r
        for r in rows_of(T["part"])
        if r["p_brand"] != "Brand#45"
        and not r["p_type"].startswith("MEDIUM POLISHED")
        and r["p_size"] in sizes
    }
    groups = defaultdict(set)
    for r in rows_of(T["partsupp"]):
        if r["ps_partkey"] in parts and r["ps_suppkey"] not in bad:
            p = parts[r["ps_partkey"]]
            groups[(p["p_brand"], p["p_type"], p["p_size"])].add(r["ps_suppkey"])
    return [
        {"p_brand": k[0], "p_type": k[1], "p_size": k[2], "supplier_cnt": len(v)}
        for k, v in groups.items()
    ]


def q17(T, sf=1.0):
    parts = {
        r["p_partkey"]
        for r in rows_of(T["part"])
        if r["p_brand"] == "Brand#23" and r["p_container"] == "MED BOX"
    }
    per_part = defaultdict(list)
    li = rows_of(T["lineitem"])
    for r in li:
        if r["l_partkey"] in parts:
            per_part[r["l_partkey"]].append(r["l_quantity"])
    avg = {k: sum(v) / len(v) for k, v in per_part.items()}
    tot = 0.0
    for r in li:
        pk = r["l_partkey"]
        if pk in parts and r["l_quantity"] < 0.2 * avg[pk]:
            tot += r["l_extendedprice"]
    return {"avg_yearly": tot / 7.0}


def q18(T, sf=1.0):
    qty = defaultdict(float)
    for r in rows_of(T["lineitem"]):
        qty[r["l_orderkey"]] += r["l_quantity"]
    big = {k: v for k, v in qty.items() if v > 300}
    cname = {r["c_custkey"]: r["c_name"] for r in rows_of(T["customer"])}
    out = []
    for r in rows_of(T["orders"]):
        if r["o_orderkey"] in big:
            out.append(
                {
                    "c_name": cname[r["o_custkey"]],
                    "o_custkey": r["o_custkey"],
                    "o_orderkey": r["o_orderkey"],
                    "o_orderdate": r["o_orderdate"],
                    "o_totalprice": r["o_totalprice"],
                    "sum_qty": big[r["o_orderkey"]],
                }
            )
    return out


def q19(T, sf=1.0):
    parts = {r["p_partkey"]: r for r in rows_of(T["part"])}
    tot = 0.0
    sm = {"SM CASE", "SM BOX", "SM PACK", "SM PKG"}
    med = {"MED BAG", "MED BOX", "MED PKG", "MED PACK"}
    lg = {"LG CASE", "LG BOX", "LG PACK", "LG PKG"}
    for r in rows_of(T["lineitem"]):
        if r["l_shipmode"] not in ("AIR", "AIR REG"):
            continue
        if r["l_shipinstruct"] != "DELIVER IN PERSON":
            continue
        p = parts[r["l_partkey"]]
        q = r["l_quantity"]
        ok = (
            (p["p_brand"] == "Brand#12" and p["p_container"] in sm and 1 <= q <= 11 and 1 <= p["p_size"] <= 5)
            or (p["p_brand"] == "Brand#23" and p["p_container"] in med and 10 <= q <= 20 and 1 <= p["p_size"] <= 10)
            or (p["p_brand"] == "Brand#34" and p["p_container"] in lg and 20 <= q <= 30 and 1 <= p["p_size"] <= 15)
        )
        if ok:
            tot += r["l_extendedprice"] * (1 - r["l_discount"])
    return {"revenue": tot}


def q20(T, sf=1.0):
    parts = {r["p_partkey"] for r in rows_of(T["part"]) if r["p_name"].startswith("forest")}
    lo, hi = dd("1994-01-01"), dd("1995-01-01")
    qty = defaultdict(float)
    for r in rows_of(T["lineitem"]):
        if lo <= r["l_shipdate"] < hi:
            qty[(r["l_partkey"], r["l_suppkey"])] += r["l_quantity"]
    ok_supp = set()
    for r in rows_of(T["partsupp"]):
        key = (r["ps_partkey"], r["ps_suppkey"])
        if r["ps_partkey"] in parts and key in qty and r["ps_availqty"] > 0.5 * qty[key]:
            ok_supp.add(r["ps_suppkey"])
    canada = {r["n_nationkey"] for r in rows_of(T["nation"]) if r["n_name"] == "CANADA"}
    return [
        {"s_name": r["s_name"], "s_address": r["s_address"]}
        for r in rows_of(T["supplier"])
        if r["s_nationkey"] in canada and r["s_suppkey"] in ok_supp
    ]


def q21(T, sf=1.0):
    saudi = {r["n_nationkey"] for r in rows_of(T["nation"]) if r["n_name"] == "SAUDI ARABIA"}
    sname = {
        r["s_suppkey"]: r["s_name"]
        for r in rows_of(T["supplier"])
        if r["s_nationkey"] in saudi
    }
    fstatus = {r["o_orderkey"] for r in rows_of(T["orders"]) if r["o_orderstatus"] == "F"}
    li = rows_of(T["lineitem"])
    supp_per_order = defaultdict(set)
    late_per_order = defaultdict(set)
    for r in li:
        supp_per_order[r["l_orderkey"]].add(r["l_suppkey"])
        if r["l_receiptdate"] > r["l_commitdate"]:
            late_per_order[r["l_orderkey"]].add(r["l_suppkey"])
    acc = defaultdict(int)
    for r in li:
        sk, ok = r["l_suppkey"], r["l_orderkey"]
        if sk not in sname or ok not in fstatus:
            continue
        if r["l_receiptdate"] <= r["l_commitdate"]:
            continue
        others = supp_per_order[ok] - {sk}
        if not others:
            continue
        late_others = late_per_order[ok] - {sk}
        if late_others:
            continue
        acc[sname[sk]] += 1
    return [{"s_name": k, "numwait": v} for k, v in acc.items()]


def q22(T, sf=1.0):
    codes = {"13", "31", "23", "29", "30", "18", "17"}
    cust = [
        r for r in rows_of(T["customer"]) if r["c_phone"][:2] in codes
    ]
    pos = [r["c_acctbal"] for r in cust if r["c_acctbal"] > 0]
    avg = sum(pos) / len(pos) if pos else 0.0
    has_orders = {r["o_custkey"] for r in rows_of(T["orders"])}
    acc = defaultdict(lambda: [0, 0.0])
    for r in cust:
        if r["c_acctbal"] > avg and r["c_custkey"] not in has_orders:
            a = acc[r["c_phone"][:2]]
            a[0] += 1
            a[1] += r["c_acctbal"]
    return [{"cntrycode": k, "numcust": v[0], "totacctbal": v[1]} for k, v in acc.items()]


ALL = {f"q{i}": globals()[f"q{i}"] for i in range(1, 23)}
