"""TPC-H tables from a seed: a frozen copy of the port's mini-dbgen
(``repro_torch/data/tpch.py``) that gives the same arrays for a seed,
with the word-salad text columns built from Python lists instead of
numpy rows (the same strings, about three times faster).

Schema- and distribution-faithful where queries depend on it (key
relationships, date ranges, LIKE-able text patterns, value domains);
approximate elsewhere.  Row counts follow the spec: SF=1 gives 6M
lineitem rows.  Deterministic under ``seed``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

Tables = Dict[str, Dict[str, np.ndarray]]

REGIONS = np.array(["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"], dtype=object)
NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]
SEGMENTS = np.array(["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"], dtype=object)
PRIORITIES = np.array(["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"], dtype=object)
SHIPMODES = np.array(["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"], dtype=object)
INSTRUCTS = np.array(
    ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"], dtype=object
)
TYPE_S1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_S2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_S3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
CONTAINER_S1 = ["SM", "LG", "MED", "JUMBO", "WRAP"]
CONTAINER_S2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]
COLORS = [
    "almond", "antique", "aquamarine", "azure", "beige", "bisque", "black",
    "blanched", "blue", "blush", "brown", "burlywood", "burnished", "chartreuse",
    "chiffon", "chocolate", "coral", "cornflower", "cornsilk", "cream", "cyan",
    "dark", "deep", "dim", "dodger", "drab", "firebrick", "floral", "forest",
    "frosted", "gainsboro", "ghost", "goldenrod", "green", "grey", "honeydew",
    "hot", "indian", "ivory", "khaki", "lace", "lavender", "lawn", "lemon",
    "light", "lime", "linen", "magenta", "maroon", "medium", "metallic", "midnight",
    "mint", "misty", "moccasin", "navajo", "navy", "olive", "orange", "orchid",
    "pale", "papaya", "peach", "peru", "pink", "plum", "powder", "puff", "purple",
    "red", "rose", "rosy", "royal", "saddle", "salmon", "sandy", "seashell",
    "sienna", "sky", "slate", "smoke", "snow", "spring", "steel", "tan",
    "thistle", "tomato", "turquoise", "violet", "wheat", "white", "yellow",
]
WORDS = [
    "the", "quickly", "slyly", "carefully", "furiously", "express", "regular",
    "final", "ironic", "pending", "bold", "even", "silent", "blithely",
    "deposits", "accounts", "packages", "foxes", "theodolites", "pinto",
    "beans", "instructions", "dependencies", "platelets", "requests", "ideas",
    "asymptotes", "somas", "sheaves", "sauternes", "waters", "dugouts",
    "sleep", "wake", "nag", "haggle", "boost", "detect", "integrate", "among",
    "above", "according", "against", "along", "alongside",
]


def _rand_words(rng, n, k_lo=4, k_hi=9, vocab=None) -> np.ndarray:
    """Random word-salad sentences: the same draws, in the same order, as
    the port's generator."""
    vocab = np.array(vocab if vocab is not None else WORDS)
    k = int(k_hi)
    picks = rng.integers(0, len(vocab), size=(n, k))
    lens = rng.integers(k_lo, k_hi + 1, size=n)
    words = vocab.tolist()
    out = np.empty(n, dtype=object)
    out[:] = [
        " ".join([words[j] for j in row[:m]])
        for row, m in zip(picks.tolist(), lens.tolist())
    ]
    return out


def _inject_pattern(rng, comments: np.ndarray, first: str, second: str, prob: float) -> np.ndarray:
    """Inject '<first> ... <second>' into a fraction of comments (the
    dbgen trick that makes Q13/Q16 predicates selective)."""
    n = comments.shape[0]
    hit = rng.random(n) < prob
    mids = np.array(["packages", "ironic", "", "pending accounts"], dtype=object)
    for i in np.nonzero(hit)[0]:
        mid = mids[rng.integers(0, len(mids))]
        sep = f" {mid} " if mid else " "
        comments[i] = f"{comments[i][:20]} {first}{sep}{second} {comments[i][20:40]}"
    return comments


def _dates(rng, n, lo="1992-01-01", hi="1998-08-02"):
    base = np.datetime64(lo, "D")
    span = int((np.datetime64(hi, "D") - base).astype(int))
    return base + rng.integers(0, span + 1, n).astype("timedelta64[D]")


def generate(sf: float = 0.01, seed: int = 0) -> Tables:
    rng = np.random.default_rng(seed)
    n_supp = max(3, int(10_000 * sf))
    n_part = max(5, int(200_000 * sf))
    n_cust = max(5, int(150_000 * sf))
    n_ord = max(10, int(1_500_000 * sf))

    # ---- region / nation ----
    region = {
        "r_regionkey": np.arange(5, dtype=np.int64),
        "r_name": REGIONS.copy(),
        "r_comment": _rand_words(rng, 5),
    }
    nation = {
        "n_nationkey": np.arange(25, dtype=np.int64),
        "n_name": np.array([n for n, _ in NATIONS], dtype=object),
        "n_regionkey": np.array([r for _, r in NATIONS], dtype=np.int64),
        "n_comment": _rand_words(rng, 25),
    }

    # ---- supplier ----
    s_nat = rng.integers(0, 25, n_supp)
    supplier = {
        "s_suppkey": np.arange(1, n_supp + 1, dtype=np.int64),
        "s_name": np.array([f"Supplier#{i:09d}" for i in range(1, n_supp + 1)], dtype=object),
        "s_address": _rand_words(rng, n_supp, 2, 4),
        "s_nationkey": s_nat,
        "s_phone": _phones(rng, s_nat),
        "s_acctbal": np.round(rng.uniform(-999.99, 9999.99, n_supp), 2),
        "s_comment": _inject_pattern(
            rng, _rand_words(rng, n_supp), "Customer", "Complaints", 0.003
        ),
    }

    # ---- part ----
    mfgr = rng.integers(1, 6, n_part)
    brand = mfgr * 10 + rng.integers(1, 6, n_part)
    t1 = np.array(TYPE_S1, dtype=object)[rng.integers(0, 6, n_part)]
    t2 = np.array(TYPE_S2, dtype=object)[rng.integers(0, 5, n_part)]
    t3 = np.array(TYPE_S3, dtype=object)[rng.integers(0, 5, n_part)]
    colors = np.array(COLORS, dtype=object)
    name_words = colors[rng.integers(0, len(colors), size=(n_part, 5))]
    part = {
        "p_partkey": np.arange(1, n_part + 1, dtype=np.int64),
        "p_name": _joined(name_words.tolist()),
        "p_mfgr": np.array([f"Manufacturer#{m}" for m in mfgr], dtype=object),
        "p_brand": np.array([f"Brand#{b}" for b in brand], dtype=object),
        "p_type": np.array([f"{a} {b} {c}" for a, b, c in zip(t1, t2, t3)], dtype=object),
        "p_size": rng.integers(1, 51, n_part),
        "p_container": np.array(
            [
                f"{a} {b}"
                for a, b in zip(
                    np.array(CONTAINER_S1, dtype=object)[rng.integers(0, 5, n_part)],
                    np.array(CONTAINER_S2, dtype=object)[rng.integers(0, 8, n_part)],
                )
            ],
            dtype=object,
        ),
        "p_retailprice": np.round(
            900 + (np.arange(1, n_part + 1) % 1000) / 10 + rng.uniform(0, 100, n_part), 2
        ),
        "p_comment": _rand_words(rng, n_part, 2, 5),
    }

    # ---- partsupp: 4 suppliers per part ----
    ps_part = np.repeat(np.arange(1, n_part + 1, dtype=np.int64), 4)
    n_ps = ps_part.shape[0]
    ps_supp = (
        (ps_part + (np.tile(np.arange(4), n_part) * (n_supp // 4 + 1))) % n_supp
    ) + 1
    partsupp = {
        "ps_partkey": ps_part,
        "ps_suppkey": ps_supp.astype(np.int64),
        "ps_availqty": rng.integers(1, 10_000, n_ps),
        "ps_supplycost": np.round(rng.uniform(1.0, 1000.0, n_ps), 2),
        "ps_comment": _rand_words(rng, n_ps, 3, 8),
    }

    # ---- customer ----
    c_nat = rng.integers(0, 25, n_cust)
    customer = {
        "c_custkey": np.arange(1, n_cust + 1, dtype=np.int64),
        "c_name": np.array([f"Customer#{i:09d}" for i in range(1, n_cust + 1)], dtype=object),
        "c_address": _rand_words(rng, n_cust, 2, 4),
        "c_nationkey": c_nat,
        "c_phone": _phones(rng, c_nat),
        "c_acctbal": np.round(rng.uniform(-999.99, 9999.99, n_cust), 2),
        "c_mktsegment": SEGMENTS[rng.integers(0, 5, n_cust)],
        "c_comment": _rand_words(rng, n_cust),
    }

    # ---- orders (1/3 of customers have no orders, per spec) ----
    cust_with_orders = np.arange(1, n_cust + 1)[: max(1, (n_cust * 2) // 3)]
    o_cust = cust_with_orders[rng.integers(0, len(cust_with_orders), n_ord)]
    o_date = _dates(rng, n_ord, "1992-01-01", "1998-08-02")
    orders = {
        "o_orderkey": np.arange(1, n_ord + 1, dtype=np.int64) * 4 - 3,  # sparse keys
        "o_custkey": o_cust.astype(np.int64),
        "o_orderstatus": np.array(["F", "O", "P"], dtype=object)[
            rng.choice(3, n_ord, p=[0.49, 0.49, 0.02])
        ],
        "o_totalprice": np.round(rng.uniform(850.0, 560_000.0, n_ord), 2),
        "o_orderdate": o_date,
        "o_orderpriority": PRIORITIES[rng.integers(0, 5, n_ord)],
        "o_clerk": np.array(
            [f"Clerk#{i:09d}" for i in rng.integers(1, max(2, n_supp), n_ord)], dtype=object
        ),
        "o_shippriority": np.zeros(n_ord, dtype=np.int64),
        "o_comment": _inject_pattern(
            rng, _rand_words(rng, n_ord), "special", "requests", 0.01
        ),
    }

    # ---- lineitem: 1..7 per order ----
    per_order = rng.integers(1, 8, n_ord)
    l_ordkey = np.repeat(orders["o_orderkey"], per_order)
    n_li = l_ordkey.shape[0]
    l_odate = np.repeat(o_date, per_order)
    l_part = rng.integers(1, n_part + 1, n_li)
    # supplier consistent with partsupp: one of the part's 4 suppliers
    pick = rng.integers(0, 4, n_li)
    l_supp = ((l_part + pick * (n_supp // 4 + 1)) % n_supp) + 1
    quantity = rng.integers(1, 51, n_li).astype(np.float64)
    retail = part["p_retailprice"][l_part - 1]
    extended = np.round(quantity * retail, 2)
    ship_lag = rng.integers(1, 122, n_li).astype("timedelta64[D]")
    commit_lag = rng.integers(30, 91, n_li).astype("timedelta64[D]")
    receipt_lag = rng.integers(1, 31, n_li).astype("timedelta64[D]")
    l_ship = l_odate + ship_lag
    lineitem = {
        "l_orderkey": l_ordkey.astype(np.int64),
        "l_partkey": l_part.astype(np.int64),
        "l_suppkey": l_supp.astype(np.int64),
        "l_linenumber": _line_numbers(per_order),
        "l_quantity": quantity,
        "l_extendedprice": extended,
        "l_discount": np.round(rng.uniform(0.0, 0.10, n_li), 2),
        "l_tax": np.round(rng.uniform(0.0, 0.08, n_li), 2),
        "l_returnflag": np.array(["R", "A", "N"], dtype=object)[
            rng.choice(3, n_li, p=[0.25, 0.25, 0.5])
        ],
        "l_linestatus": np.array(["O", "F"], dtype=object)[rng.integers(0, 2, n_li)],
        "l_shipdate": l_ship,
        "l_commitdate": l_odate + commit_lag,
        "l_receiptdate": l_ship + receipt_lag,
        "l_shipinstruct": INSTRUCTS[rng.integers(0, 4, n_li)],
        "l_shipmode": SHIPMODES[rng.integers(0, 7, n_li)],
        "l_comment": _rand_words(rng, n_li, 2, 5),
    }

    return {
        "region": region,
        "nation": nation,
        "supplier": supplier,
        "part": part,
        "partsupp": partsupp,
        "customer": customer,
        "orders": orders,
        "lineitem": lineitem,
    }


def _phones(rng, nationkeys: np.ndarray) -> np.ndarray:
    n = nationkeys.shape[0]
    a = rng.integers(100, 1000, n)
    b = rng.integers(100, 1000, n)
    c = rng.integers(1000, 10000, n)
    return np.array(
        [f"{10 + nk}-{x}-{y}-{z}" for nk, x, y, z in zip(nationkeys, a, b, c)],
        dtype=object,
    )


def _line_numbers(per_order: np.ndarray) -> np.ndarray:
    total = int(per_order.sum())
    out = np.ones(total, dtype=np.int64)
    ends = np.cumsum(per_order)
    starts = ends - per_order
    idx = np.arange(total)
    return (idx - np.repeat(starts, per_order) + 1).astype(np.int64)


def _joined(rows) -> np.ndarray:
    out = np.empty(len(rows), dtype=object)
    out[:] = [" ".join(r) for r in rows]
    return out
