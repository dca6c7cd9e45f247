"""The plain reference of the 22 TPC-H SQL templates: vectorised numpy,
written from the SQL text (``queries/tpch.toml``) and the row-at-a-time
reference ``repro_torch/queries/tpch_numpy.py``, taking the same
parameters as the templates.  It imports nothing of the program and
works every answer out again from the generator's host tables.

``Reference(tables, ftype)`` holds the tables with floats in ``ftype``:
``np.float64`` as the configuration states, ``np.float32`` for the
control.  ``run(name, params)`` returns the result's columns in ORDER BY
order; dates are int64 days.
"""
from __future__ import annotations

import numpy as np

from .common import (
    Index, columns, count, days, group, like_between, prepare, seg_sum, sort_rows,
    str_mask, total, year_of,
)


class Reference:
    def __init__(self, tables, ftype=np.float64):
        self.f = ftype
        self.t = {name: prepare(cols, ftype) for name, cols in tables.items()}
        self._idx = {}

    def run(self, name: str, params: dict) -> dict:
        return getattr(self, name)(**params)

    # -- lookups ------------------------------------------------------
    def idx(self, table: str, key: str) -> Index:
        k = (table, key)
        if k not in self._idx:
            self._idx[k] = Index(self.t[table][key])
        return self._idx[k]

    def nation_keys(self, name: str) -> np.ndarray:
        n = self.t["nation"]
        return n["n_nationkey"][n["n_name"] == name]

    def region_nations(self, region: str) -> np.ndarray:
        r, n = self.t["region"], self.t["nation"]
        rk = r["r_regionkey"][r["r_name"] == region]
        return n["n_nationkey"][np.isin(n["n_regionkey"], rk)]

    def nation_name(self, keys: np.ndarray) -> np.ndarray:
        n = self.t["nation"]
        return n["n_name"][self.idx("nation", "n_nationkey")(keys)]

    def vol(self, l, m):
        return l["l_extendedprice"][m] * (1 - l["l_discount"][m])

    # -- the queries --------------------------------------------------
    def q1(self, delta, date):
        l = self.t["lineitem"]
        m = l["l_shipdate"] <= days(date)
        gid, first = group(l["l_returnflag"][m], l["l_linestatus"][m])
        k = len(first)
        qty, price = l["l_quantity"][m], l["l_extendedprice"][m]
        disc, tax = l["l_discount"][m], l["l_tax"][m]
        cnt = count(gid, k)
        out = columns(
            l_returnflag=l["l_returnflag"][m][first],
            l_linestatus=l["l_linestatus"][m][first],
            sum_qty=seg_sum(qty, gid, k),
            sum_base_price=seg_sum(price, gid, k),
            sum_disc_price=seg_sum(price * (1 - disc), gid, k),
            sum_charge=seg_sum(price * (1 - disc) * (1 + tax), gid, k),
            avg_qty=seg_sum(qty, gid, k) / cnt.astype(self.f),
            avg_price=seg_sum(price, gid, k) / cnt.astype(self.f),
            avg_disc=seg_sum(disc, gid, k) / cnt.astype(self.f),
            count_order=cnt,
        )
        return sort_rows(out, [["l_returnflag", "asc"], ["l_linestatus", "asc"]])

    def q2(self, size):
        p, s, ps = self.t["part"], self.t["supplier"], self.t["partsupp"]
        eu = self.region_nations("EUROPE")
        s_pos = self.idx("supplier", "s_suppkey")(ps["ps_suppkey"])
        eu_ps = np.isin(s["s_nationkey"][s_pos], eu)
        # the correlated MIN(ps_supplycost) over European suppliers, per part
        pk = ps["ps_partkey"][eu_ps]
        cost = ps["ps_supplycost"][eu_ps]
        p_idx = self.idx("part", "p_partkey")
        mins = np.full(len(p["p_partkey"]), np.inf, dtype=self.f)
        np.minimum.at(mins, p_idx(pk), cost)
        pm = (p["p_size"] == size) & str_mask(p["p_type"], lambda x: x.endswith("BRASS"))
        pp = p_idx(ps["ps_partkey"])
        keep = eu_ps & pm[pp] & (ps["ps_supplycost"] == mins[pp])
        sp, pr = s_pos[keep], pp[keep]
        out = columns(
            s_acctbal=s["s_acctbal"][sp], s_name=s["s_name"][sp],
            n_name=self.nation_name(s["s_nationkey"][sp]), p_partkey=p["p_partkey"][pr],
            p_mfgr=p["p_mfgr"][pr], s_address=s["s_address"][sp], s_phone=s["s_phone"][sp],
            s_comment=s["s_comment"][sp],
        )
        return sort_rows(out, [["s_acctbal", "desc"], ["n_name", "asc"], ["s_name", "asc"],
                               ["p_partkey", "asc"]])

    def q3(self, date):
        c, o, l = self.t["customer"], self.t["orders"], self.t["lineitem"]
        d = days(date)
        ck = c["c_custkey"][c["c_mktsegment"] == "BUILDING"]
        om = (o["o_orderdate"] < d) & np.isin(o["o_custkey"], ck)
        op = self.idx("orders", "o_orderkey")(l["l_orderkey"])
        m = (l["l_shipdate"] > d) & om[op]
        gid, first = group(l["l_orderkey"][m])
        k = len(first)
        rows = op[m][first]
        out = columns(
            l_orderkey=l["l_orderkey"][m][first], o_orderdate=o["o_orderdate"][rows],
            o_shippriority=o["o_shippriority"][rows], revenue=seg_sum(self.vol(l, m), gid, k),
        )
        return sort_rows(out, [["revenue", "desc"], ["o_orderdate", "asc"]])

    def q4(self, date, date_end):
        o, l = self.t["orders"], self.t["lineitem"]
        late = l["l_commitdate"] < l["l_receiptdate"]
        has = np.zeros(len(o["o_orderkey"]), dtype=bool)
        has[self.idx("orders", "o_orderkey")(l["l_orderkey"][late])] = True
        m = (o["o_orderdate"] >= days(date)) & (o["o_orderdate"] < days(date_end)) & has
        gid, first = group(o["o_orderpriority"][m])
        out = columns(o_orderpriority=o["o_orderpriority"][m][first],
                      order_count=count(gid, len(first)))
        return sort_rows(out, [["o_orderpriority", "asc"]])

    def q5(self, date, date_end):
        c, o, l, s = self.t["customer"], self.t["orders"], self.t["lineitem"], self.t["supplier"]
        asia = self.region_nations("ASIA")
        op = self.idx("orders", "o_orderkey")(l["l_orderkey"])
        od = o["o_orderdate"][op]
        c_nat = c["c_nationkey"][self.idx("customer", "c_custkey")(o["o_custkey"][op])]
        s_nat = s["s_nationkey"][self.idx("supplier", "s_suppkey")(l["l_suppkey"])]
        m = (od >= days(date)) & (od < days(date_end)) & (c_nat == s_nat) & np.isin(s_nat, asia)
        gid, first = group(s_nat[m])
        out = columns(n_name=self.nation_name(s_nat[m][first]),
                      revenue=seg_sum(self.vol(l, m), gid, len(first)))
        return sort_rows(out, [["revenue", "desc"]])

    def q6(self, date, date_end, discount, discount_lo, discount_hi, quantity):
        l = self.t["lineitem"]
        m = ((l["l_shipdate"] >= days(date)) & (l["l_shipdate"] < days(date_end))
             & (l["l_discount"] >= discount_lo) & (l["l_discount"] <= discount_hi)
             & (l["l_quantity"] < quantity))
        return columns(revenue=[total(l["l_extendedprice"][m] * l["l_discount"][m])])

    def q7(self):
        s, l, o, c = self.t["supplier"], self.t["lineitem"], self.t["orders"], self.t["customer"]
        fr, de = self.nation_keys("FRANCE")[0], self.nation_keys("GERMANY")[0]
        sn = s["s_nationkey"][self.idx("supplier", "s_suppkey")(l["l_suppkey"])]
        op = self.idx("orders", "o_orderkey")(l["l_orderkey"])
        cn = c["c_nationkey"][self.idx("customer", "c_custkey")(o["o_custkey"][op])]
        m = (((sn == fr) & (cn == de)) | ((sn == de) & (cn == fr))) & \
            (l["l_shipdate"] >= days("1995-01-01")) & (l["l_shipdate"] <= days("1996-12-31"))
        yr = year_of(l["l_shipdate"][m])
        gid, first = group(sn[m], cn[m], yr)
        out = columns(supp_nation=self.nation_name(sn[m][first]),
                      cust_nation=self.nation_name(cn[m][first]), l_year=yr[first],
                      revenue=seg_sum(self.vol(l, m), gid, len(first)))
        return sort_rows(out, [["supp_nation", "asc"], ["cust_nation", "asc"], ["l_year", "asc"]])

    def q8(self):
        p, l, o, c, s = (self.t[k] for k in ("part", "lineitem", "orders", "customer", "supplier"))
        america = self.region_nations("AMERICA")
        brazil = self.nation_keys("BRAZIL")[0]
        pm = p["p_type"] == "ECONOMY ANODIZED STEEL"
        op = self.idx("orders", "o_orderkey")(l["l_orderkey"])
        od = o["o_orderdate"][op]
        cn = c["c_nationkey"][self.idx("customer", "c_custkey")(o["o_custkey"][op])]
        m = (pm[self.idx("part", "p_partkey")(l["l_partkey"])] & np.isin(cn, america)
             & (od >= days("1995-01-01")) & (od <= days("1996-12-31")))
        sn = s["s_nationkey"][self.idx("supplier", "s_suppkey")(l["l_suppkey"][m])]
        vol = self.vol(l, m)
        yr = year_of(od[m])
        gid, first = group(yr)
        k = len(first)
        share = seg_sum(np.where(sn == brazil, vol, self.f(0)), gid, k) / seg_sum(vol, gid, k)
        return sort_rows(columns(o_year=yr[first], mkt_share=share), [["o_year", "asc"]])

    def q9(self):
        p, l, o, s, ps = (self.t[k] for k in ("part", "lineitem", "orders", "supplier", "partsupp"))
        green = str_mask(p["p_name"], lambda x: "green" in x)
        m = green[self.idx("part", "p_partkey")(l["l_partkey"])]
        nsupp = int(max(ps["ps_suppkey"].max(), l["l_suppkey"].max())) + 1
        ps_code = ps["ps_partkey"] * nsupp + ps["ps_suppkey"]
        order = np.argsort(ps_code, kind="stable")
        l_code = l["l_partkey"][m] * nsupp + l["l_suppkey"][m]
        sorted_code = ps_code[order]
        at = np.minimum(np.searchsorted(sorted_code, l_code), len(order) - 1)
        m[m] = sorted_code[at] == l_code
        l_code = l["l_partkey"][m] * nsupp + l["l_suppkey"][m]
        cost = ps["ps_supplycost"][order[np.searchsorted(sorted_code, l_code)]]
        amount = self.vol(l, m) - cost * l["l_quantity"][m]
        sn = s["s_nationkey"][self.idx("supplier", "s_suppkey")(l["l_suppkey"][m])]
        yr = year_of(o["o_orderdate"][self.idx("orders", "o_orderkey")(l["l_orderkey"][m])])
        gid, first = group(sn, yr)
        out = columns(n_name=self.nation_name(sn[first]), o_year=yr[first],
                      sum_profit=seg_sum(amount, gid, len(first)))
        return sort_rows(out, [["n_name", "asc"], ["o_year", "desc"]])

    def q10(self, date, date_end):
        c, o, l = self.t["customer"], self.t["orders"], self.t["lineitem"]
        op = self.idx("orders", "o_orderkey")(l["l_orderkey"])
        od = o["o_orderdate"][op]
        m = (od >= days(date)) & (od < days(date_end)) & (l["l_returnflag"] == "R")
        cust = o["o_custkey"][op[m]]
        gid, first = group(cust)
        cp = self.idx("customer", "c_custkey")(cust[first])
        out = columns(
            o_custkey=cust[first], c_name=c["c_name"][cp], c_acctbal=c["c_acctbal"][cp],
            c_phone=c["c_phone"][cp], n_name=self.nation_name(c["c_nationkey"][cp]),
            c_address=c["c_address"][cp], c_comment=c["c_comment"][cp],
            revenue=seg_sum(self.vol(l, m), gid, len(first)),
        )
        return sort_rows(out, [["revenue", "desc"]])

    def q11(self, fraction):
        ps, s = self.t["partsupp"], self.t["supplier"]
        de = self.nation_keys("GERMANY")
        sn = s["s_nationkey"][self.idx("supplier", "s_suppkey")(ps["ps_suppkey"])]
        m = np.isin(sn, de)
        val = ps["ps_supplycost"][m] * ps["ps_availqty"][m]
        gid, first = group(ps["ps_partkey"][m])
        value = seg_sum(val, gid, len(first))
        keep = value > total(val) * fraction
        out = columns(ps_partkey=ps["ps_partkey"][m][first][keep], value=value[keep])
        return sort_rows(out, [["value", "desc"]])

    def q12(self, date, date_end):
        o, l = self.t["orders"], self.t["lineitem"]
        m = (np.isin(l["l_shipmode"], ["MAIL", "SHIP"]) & (l["l_commitdate"] < l["l_receiptdate"])
             & (l["l_shipdate"] < l["l_commitdate"]) & (l["l_receiptdate"] >= days(date))
             & (l["l_receiptdate"] < days(date_end)))
        prio = o["o_orderpriority"][self.idx("orders", "o_orderkey")(l["l_orderkey"][m])]
        high = np.isin(prio, ["1-URGENT", "2-HIGH"])
        gid, first = group(l["l_shipmode"][m])
        k = len(first)
        out = columns(l_shipmode=l["l_shipmode"][m][first], high_line_count=seg_sum(high, gid, k),
                      low_line_count=seg_sum(~high, gid, k))
        return sort_rows(out, [["l_shipmode", "asc"]])

    def q13(self):
        c, o = self.t["customer"], self.t["orders"]
        ok = ~str_mask(o["o_comment"], lambda x: like_between(x, "special", "requests"))
        cp = self.idx("customer", "c_custkey")(o["o_custkey"][ok])
        per_cust = np.bincount(cp[cp >= 0], minlength=len(c["c_custkey"])).astype(np.int64)
        gid, first = group(per_cust)
        out = columns(c_count=per_cust[first], custdist=count(gid, len(first)))
        return sort_rows(out, [["custdist", "desc"], ["c_count", "desc"]])

    def q14(self, date, date_end):
        l, p = self.t["lineitem"], self.t["part"]
        m = (l["l_shipdate"] >= days(date)) & (l["l_shipdate"] < days(date_end))
        promo = str_mask(p["p_type"], lambda x: x.startswith("PROMO"))
        pm = promo[self.idx("part", "p_partkey")(l["l_partkey"][m])]
        vol = self.vol(l, m)
        share = self.f(100.0) * total(np.where(pm, vol, self.f(0))) / total(vol)
        return columns(promo_revenue=[share])

    def q15(self, date, date_end):
        l, s = self.t["lineitem"], self.t["supplier"]
        m = (l["l_shipdate"] >= days(date)) & (l["l_shipdate"] < days(date_end))
        gid, first = group(l["l_suppkey"][m])
        rev = seg_sum(self.vol(l, m), gid, len(first))
        top = rev == rev.max()
        supp = l["l_suppkey"][m][first][top]
        sp = self.idx("supplier", "s_suppkey")(supp)
        out = columns(s_suppkey=supp, s_name=s["s_name"][sp], s_address=s["s_address"][sp],
                      s_phone=s["s_phone"][sp], total_revenue=rev[top])
        return sort_rows(out, [["s_suppkey", "asc"]])

    def q16(self):
        ps, p, s = self.t["partsupp"], self.t["part"], self.t["supplier"]
        bad = s["s_suppkey"][str_mask(s["s_comment"],
                                      lambda x: like_between(x, "Customer", "Complaints"))]
        pm = ((p["p_brand"] != "Brand#45")
              & ~str_mask(p["p_type"], lambda x: x.startswith("MEDIUM POLISHED"))
              & np.isin(p["p_size"], [49, 14, 23, 45, 19, 3, 36, 9]))
        pp = self.idx("part", "p_partkey")(ps["ps_partkey"])
        m = pm[pp] & ~np.isin(ps["ps_suppkey"], bad)
        pr = pp[m]
        gid, first = group(p["p_brand"][pr], p["p_type"][pr], p["p_size"][pr])
        pairs, _ = group(gid, ps["ps_suppkey"][m])
        distinct = np.zeros(len(first), dtype=np.int64)
        _, one = np.unique(pairs, return_index=True)
        np.add.at(distinct, gid[one], 1)
        out = columns(p_brand=p["p_brand"][pr][first], p_type=p["p_type"][pr][first],
                      p_size=p["p_size"][pr][first], supplier_cnt=distinct)
        return sort_rows(out, [["supplier_cnt", "desc"], ["p_brand", "asc"], ["p_type", "asc"],
                               ["p_size", "asc"]])

    def q17(self):
        l, p = self.t["lineitem"], self.t["part"]
        pm = (p["p_brand"] == "Brand#23") & (p["p_container"] == "MED BOX")
        pp = self.idx("part", "p_partkey")(l["l_partkey"])
        m = pm[pp]
        gid, first = group(l["l_partkey"][m])
        k = len(first)
        qty = l["l_quantity"][m]
        avg = seg_sum(qty, gid, k) / count(gid, k).astype(self.f)
        keep = qty < self.f(0.2) * avg[gid]
        return columns(avg_yearly=[total(l["l_extendedprice"][m][keep]) / self.f(7.0)])

    def q18(self, quantity):
        c, o, l = self.t["customer"], self.t["orders"], self.t["lineitem"]
        op = self.idx("orders", "o_orderkey")(l["l_orderkey"])
        n = len(o["o_orderkey"])
        qsum = seg_sum(l["l_quantity"], op, n)
        big = np.nonzero(qsum > quantity)[0]
        cp = self.idx("customer", "c_custkey")(o["o_custkey"][big])
        out = columns(c_name=c["c_name"][cp], o_custkey=o["o_custkey"][big],
                      o_orderkey=o["o_orderkey"][big], o_orderdate=o["o_orderdate"][big],
                      o_totalprice=o["o_totalprice"][big], sum_qty=qsum[big])
        return sort_rows(out, [["o_totalprice", "desc"], ["o_orderdate", "asc"]])

    def q19(self, quantity1, quantity1_hi, quantity2, quantity2_hi, quantity3, quantity3_hi):
        l, p = self.t["lineitem"], self.t["part"]
        base = (l["l_shipinstruct"] == "DELIVER IN PERSON") & np.isin(l["l_shipmode"], ["AIR", "AIR REG"])
        pp = self.idx("part", "p_partkey")(l["l_partkey"][base])
        brand, cont, size = p["p_brand"][pp], p["p_container"][pp], p["p_size"][pp]
        q = l["l_quantity"][base]

        def branch(b, conts, lo, hi, smax):
            return ((brand == b) & np.isin(cont, conts) & (q >= lo) & (q <= hi)
                    & (size >= 1) & (size <= smax))

        m = (branch("Brand#12", ["SM CASE", "SM BOX", "SM PACK", "SM PKG"], quantity1, quantity1_hi, 5)
             | branch("Brand#23", ["MED BAG", "MED BOX", "MED PKG", "MED PACK"], quantity2, quantity2_hi, 10)
             | branch("Brand#34", ["LG CASE", "LG BOX", "LG PACK", "LG PKG"], quantity3, quantity3_hi, 15))
        price = l["l_extendedprice"][base][m] * (1 - l["l_discount"][base][m])
        return columns(revenue=[total(price)])

    def q20(self, date, date_end):
        s, ps, p, l = self.t["supplier"], self.t["partsupp"], self.t["part"], self.t["lineitem"]
        forest = p["p_partkey"][str_mask(p["p_name"], lambda x: x.startswith("forest"))]
        psm = np.isin(ps["ps_partkey"], forest)
        lm = ((l["l_shipdate"] >= days(date)) & (l["l_shipdate"] < days(date_end))
              & np.isin(l["l_partkey"], forest))
        nsupp = int(max(ps["ps_suppkey"].max(), l["l_suppkey"].max())) + 1
        ps_code = ps["ps_partkey"][psm] * nsupp + ps["ps_suppkey"][psm]
        l_code = l["l_partkey"][lm] * nsupp + l["l_suppkey"][lm]
        uniq, inv = np.unique(l_code, return_inverse=True)
        qsum = seg_sum(l["l_quantity"][lm], inv.astype(np.int64), len(uniq))
        at = np.searchsorted(uniq, ps_code)
        found = (at < len(uniq)) & (uniq[np.minimum(at, len(uniq) - 1)] == ps_code)
        half = np.where(found, self.f(0.5) * qsum[np.minimum(at, len(uniq) - 1)], np.inf)
        ok = found & (ps["ps_availqty"][psm] > half)
        supp = np.unique(ps["ps_suppkey"][psm][ok])
        ca = self.nation_keys("CANADA")
        sm = np.isin(s["s_suppkey"], supp) & np.isin(s["s_nationkey"], ca)
        out = columns(s_name=s["s_name"][sm], s_address=s["s_address"][sm])
        return sort_rows(out, [["s_name", "asc"]])

    def q21(self):
        s, l, o = self.t["supplier"], self.t["lineitem"], self.t["orders"]
        sa = self.nation_keys("SAUDI ARABIA")
        op = self.idx("orders", "o_orderkey")(l["l_orderkey"])
        n = len(o["o_orderkey"])
        late = l["l_receiptdate"] > l["l_commitdate"]
        lines = np.bincount(op, minlength=n)
        late_lines = np.bincount(op[late], minlength=n)
        pair, _ = group(op, l["l_suppkey"])
        m_pairs = int(pair.max()) + 1 if len(pair) else 0
        pair_lines = np.bincount(pair, minlength=m_pairs)
        pair_late = np.bincount(pair[late], minlength=m_pairs)
        other = lines[op] - pair_lines[pair] > 0
        other_late = late_lines[op] - pair_late[pair] > 0
        sp = self.idx("supplier", "s_suppkey")(l["l_suppkey"])
        m = (late & other & ~other_late & (o["o_orderstatus"][op] == "F")
             & np.isin(s["s_nationkey"][sp], sa))
        names = s["s_name"][sp[m]]
        gid, first = group(names)
        out = columns(s_name=names[first], numwait=count(gid, len(first)))
        return sort_rows(out, [["numwait", "desc"], ["s_name", "asc"]])

    def q22(self):
        c, o = self.t["customer"], self.t["orders"]
        codes = np.array([x[:2] for x in c["c_phone"]], dtype=object)
        inlist = np.isin(codes, ["13", "31", "23", "29", "30", "18", "17"])
        bal = c["c_acctbal"]
        pos = inlist & (bal > 0.0)
        avg = total(bal[pos]) / self.f(pos.sum())
        has = np.isin(c["c_custkey"], o["o_custkey"])
        m = inlist & (bal > avg) & ~has
        gid, first = group(codes[m])
        k = len(first)
        out = columns(cntrycode=codes[m][first], numcust=count(gid, k),
                      totacctbal=seg_sum(bal[m], gid, k))
        return sort_rows(out, [["cntrycode", "asc"]])
