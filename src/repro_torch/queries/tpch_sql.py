"""All 22 TPC-H queries as SQL text for the ``repro_torch.sql`` front-end.

Column aliases match the hand-written plans' output names so the
differential tests can compare all three engines row-for-row.  The 11
single-block queries ride the base dialect; the other 11 use the
subquery forms of the dialect: scalar subqueries (q2, q11, q15, q17,
q20, q22), ``IN``/``NOT IN (SELECT ...)`` (q16, q18, q20),
``EXISTS``/``NOT EXISTS`` incl. correlated ``<>`` residuals (q4, q21,
q22), and derived tables in FROM (q13, q15).

Conventions forced by the dialect:

- LIMIT clauses are omitted: sort ties make LIMIT non-deterministic
  across engines, and the reference tests compare full result sets
  (same convention as ``tpch_frames(..., apply_limit=False)``).
- ``INTERVAL '3' MONTH``-style calendar arithmetic is written as
  explicit DATE bounds (the dialect refuses approximate month math).
- Subquery aliases are distinct from enclosing aliases (the planner
  rejects shadowing so correlated references stay unambiguous).
- Cheap predicates come before EXISTS/IN conjuncts: the oracle's
  nested-loop interpreter short-circuits ANDs left-to-right.
- q11's threshold fraction is scale-dependent (0.0001/SF per the TPC-H
  spec); use ``sql_text("q11", sf=...)`` for non-unit scale factors.
"""
from __future__ import annotations

TPCH_SQL = {
    "q1": """
        SELECT l_returnflag, l_linestatus,
               SUM(l_quantity) AS sum_qty,
               SUM(l_extendedprice) AS sum_base_price,
               SUM(l_extendedprice * (1 - l_discount)) AS sum_disc_price,
               SUM(l_extendedprice * (1 - l_discount) * (1 + l_tax)) AS sum_charge,
               AVG(l_quantity) AS avg_qty,
               AVG(l_extendedprice) AS avg_price,
               AVG(l_discount) AS avg_disc,
               COUNT(*) AS count_order
        FROM lineitem
        WHERE l_shipdate <= DATE '1998-12-01' - INTERVAL '90' DAY
        GROUP BY l_returnflag, l_linestatus
        ORDER BY l_returnflag, l_linestatus
    """,
    "q2": """
        SELECT s_acctbal, s_name, n_name, p_partkey, p_mfgr, s_address,
               s_phone, s_comment
        FROM part, supplier, partsupp, nation, region
        WHERE p_partkey = ps_partkey AND s_suppkey = ps_suppkey
          AND p_size = 15 AND p_type LIKE '%BRASS'
          AND s_nationkey = n_nationkey AND n_regionkey = r_regionkey
          AND r_name = 'EUROPE'
          AND ps_supplycost = (
            SELECT MIN(ps2.ps_supplycost)
            FROM partsupp ps2, supplier s2, nation n2, region r2
            WHERE p_partkey = ps2.ps_partkey AND s2.s_suppkey = ps2.ps_suppkey
              AND s2.s_nationkey = n2.n_nationkey
              AND n2.n_regionkey = r2.r_regionkey AND r2.r_name = 'EUROPE')
        ORDER BY s_acctbal DESC, n_name, s_name, p_partkey
    """,
    "q3": """
        SELECT l_orderkey, o_orderdate, o_shippriority,
               SUM(l_extendedprice * (1 - l_discount)) AS revenue
        FROM customer, orders, lineitem
        WHERE c_mktsegment = 'BUILDING'
          AND c_custkey = o_custkey AND l_orderkey = o_orderkey
          AND o_orderdate < DATE '1995-03-15'
          AND l_shipdate > DATE '1995-03-15'
        GROUP BY l_orderkey, o_orderdate, o_shippriority
        ORDER BY revenue DESC, o_orderdate
    """,
    "q4": """
        SELECT o_orderpriority, COUNT(*) AS order_count
        FROM orders
        WHERE o_orderdate >= DATE '1993-07-01'
          AND o_orderdate < DATE '1993-10-01'
          AND EXISTS (
            SELECT * FROM lineitem
            WHERE l_orderkey = o_orderkey AND l_commitdate < l_receiptdate)
        GROUP BY o_orderpriority
        ORDER BY o_orderpriority
    """,
    "q5": """
        SELECT n_name, SUM(l_extendedprice * (1 - l_discount)) AS revenue
        FROM customer, orders, lineitem, supplier, nation, region
        WHERE c_custkey = o_custkey AND l_orderkey = o_orderkey
          AND l_suppkey = s_suppkey AND c_nationkey = s_nationkey
          AND s_nationkey = n_nationkey AND n_regionkey = r_regionkey
          AND r_name = 'ASIA'
          AND o_orderdate >= DATE '1994-01-01'
          AND o_orderdate < DATE '1995-01-01'
        GROUP BY n_name
        ORDER BY revenue DESC
    """,
    "q6": """
        SELECT SUM(l_extendedprice * l_discount) AS revenue
        FROM lineitem
        WHERE l_shipdate >= DATE '1994-01-01'
          AND l_shipdate < DATE '1994-01-01' + INTERVAL '365' DAY
          AND l_discount BETWEEN 0.05 AND 0.07
          AND l_quantity < 24
    """,
    "q7": """
        SELECT n1.n_name AS supp_nation, n2.n_name AS cust_nation,
               EXTRACT(YEAR FROM l_shipdate) AS l_year,
               SUM(l_extendedprice * (1 - l_discount)) AS revenue
        FROM supplier, lineitem, orders, customer, nation n1, nation n2
        WHERE s_suppkey = l_suppkey AND o_orderkey = l_orderkey
          AND c_custkey = o_custkey
          AND s_nationkey = n1.n_nationkey AND c_nationkey = n2.n_nationkey
          AND ((n1.n_name = 'FRANCE' AND n2.n_name = 'GERMANY')
            OR (n1.n_name = 'GERMANY' AND n2.n_name = 'FRANCE'))
          AND l_shipdate BETWEEN DATE '1995-01-01' AND DATE '1996-12-31'
        GROUP BY supp_nation, cust_nation, l_year
        ORDER BY supp_nation, cust_nation, l_year
    """,
    "q8": """
        SELECT EXTRACT(YEAR FROM o_orderdate) AS o_year,
               SUM(CASE WHEN n2.n_name = 'BRAZIL'
                        THEN l_extendedprice * (1 - l_discount)
                        ELSE 0.0 END)
                 / SUM(l_extendedprice * (1 - l_discount)) AS mkt_share
        FROM part, lineitem, orders, customer, nation n1, region, supplier,
             nation n2
        WHERE p_partkey = l_partkey AND o_orderkey = l_orderkey
          AND c_custkey = o_custkey
          AND n1.n_nationkey = c_nationkey AND r_regionkey = n1.n_regionkey
          AND s_suppkey = l_suppkey AND n2.n_nationkey = s_nationkey
          AND r_name = 'AMERICA' AND p_type = 'ECONOMY ANODIZED STEEL'
          AND o_orderdate BETWEEN DATE '1995-01-01' AND DATE '1996-12-31'
        GROUP BY o_year
        ORDER BY o_year
    """,
    "q9": """
        SELECT n_name, EXTRACT(YEAR FROM o_orderdate) AS o_year,
               SUM(l_extendedprice * (1 - l_discount)
                   - ps_supplycost * l_quantity) AS sum_profit
        FROM part, supplier, lineitem, partsupp, orders, nation
        WHERE s_suppkey = l_suppkey AND ps_suppkey = l_suppkey
          AND ps_partkey = l_partkey AND p_partkey = l_partkey
          AND o_orderkey = l_orderkey AND s_nationkey = n_nationkey
          AND p_name LIKE '%green%'
        GROUP BY n_name, o_year
        ORDER BY n_name, o_year DESC
    """,
    "q10": """
        SELECT o_custkey, c_name, c_acctbal, c_phone, n_name, c_address,
               c_comment,
               SUM(l_extendedprice * (1 - l_discount)) AS revenue
        FROM customer, orders, lineitem, nation
        WHERE c_custkey = o_custkey AND l_orderkey = o_orderkey
          AND c_nationkey = n_nationkey
          AND o_orderdate >= DATE '1993-10-01'
          AND o_orderdate < DATE '1994-01-01'
          AND l_returnflag = 'R'
        GROUP BY o_custkey, c_name, c_acctbal, c_phone, n_name, c_address,
                 c_comment
        ORDER BY revenue DESC
    """,
    "q11": """
        SELECT ps_partkey, SUM(ps_supplycost * ps_availqty) AS value
        FROM partsupp, supplier, nation
        WHERE ps_suppkey = s_suppkey AND s_nationkey = n_nationkey
          AND n_name = 'GERMANY'
        GROUP BY ps_partkey
        HAVING SUM(ps_supplycost * ps_availqty) > (
            SELECT SUM(ps2.ps_supplycost * ps2.ps_availqty) * {q11_fraction}
            FROM partsupp ps2, supplier s2, nation n2
            WHERE ps2.ps_suppkey = s2.s_suppkey
              AND s2.s_nationkey = n2.n_nationkey AND n2.n_name = 'GERMANY')
        ORDER BY value DESC
    """,
    "q12": """
        SELECT l_shipmode,
               SUM(CASE WHEN o_orderpriority = '1-URGENT'
                          OR o_orderpriority = '2-HIGH'
                        THEN 1 ELSE 0 END) AS high_line_count,
               SUM(CASE WHEN o_orderpriority <> '1-URGENT'
                         AND o_orderpriority <> '2-HIGH'
                        THEN 1 ELSE 0 END) AS low_line_count
        FROM orders, lineitem
        WHERE o_orderkey = l_orderkey AND l_shipmode IN ('MAIL', 'SHIP')
          AND l_commitdate < l_receiptdate AND l_shipdate < l_commitdate
          AND l_receiptdate >= DATE '1994-01-01'
          AND l_receiptdate < DATE '1995-01-01'
        GROUP BY l_shipmode
        ORDER BY l_shipmode
    """,
    "q13": """
        SELECT c_count, COUNT(*) AS custdist
        FROM (SELECT c_custkey, COUNT(o_orderkey) AS c_count
              FROM customer LEFT JOIN orders
                ON c_custkey = o_custkey
               AND o_comment NOT LIKE '%special%requests%'
              GROUP BY c_custkey) c_orders
        GROUP BY c_count
        ORDER BY custdist DESC, c_count DESC
    """,
    "q14": """
        SELECT 100.00 * SUM(CASE WHEN p_type LIKE 'PROMO%'
                                 THEN l_extendedprice * (1 - l_discount)
                                 ELSE 0.0 END)
               / SUM(l_extendedprice * (1 - l_discount)) AS promo_revenue
        FROM lineitem, part
        WHERE l_partkey = p_partkey
          AND l_shipdate >= DATE '1995-09-01'
          AND l_shipdate < DATE '1995-10-01'
    """,
    "q15": """
        SELECT s_suppkey, s_name, s_address, s_phone, total_revenue
        FROM supplier,
             (SELECT l_suppkey,
                     SUM(l_extendedprice * (1 - l_discount)) AS total_revenue
              FROM lineitem
              WHERE l_shipdate >= DATE '1996-01-01'
                AND l_shipdate < DATE '1996-04-01'
              GROUP BY l_suppkey) revenue0
        WHERE s_suppkey = l_suppkey
          AND total_revenue = (
            SELECT MAX(r1.total_revenue)
            FROM (SELECT l2.l_suppkey AS supplier_no,
                         SUM(l2.l_extendedprice * (1 - l2.l_discount))
                           AS total_revenue
                  FROM lineitem l2
                  WHERE l2.l_shipdate >= DATE '1996-01-01'
                    AND l2.l_shipdate < DATE '1996-04-01'
                  GROUP BY l2.l_suppkey) r1)
        ORDER BY s_suppkey
    """,
    "q16": """
        SELECT p_brand, p_type, p_size,
               COUNT(DISTINCT ps_suppkey) AS supplier_cnt
        FROM partsupp, part
        WHERE p_partkey = ps_partkey
          AND p_brand <> 'Brand#45'
          AND p_type NOT LIKE 'MEDIUM POLISHED%'
          AND p_size IN (49, 14, 23, 45, 19, 3, 36, 9)
          AND ps_suppkey NOT IN (
            SELECT s_suppkey FROM supplier
            WHERE s_comment LIKE '%Customer%Complaints%')
        GROUP BY p_brand, p_type, p_size
        ORDER BY supplier_cnt DESC, p_brand, p_type, p_size
    """,
    "q17": """
        SELECT SUM(l_extendedprice) / 7.0 AS avg_yearly
        FROM lineitem, part
        WHERE p_partkey = l_partkey
          AND p_brand = 'Brand#23' AND p_container = 'MED BOX'
          AND l_quantity < (
            SELECT 0.2 * AVG(l2.l_quantity) FROM lineitem l2
            WHERE l2.l_partkey = p_partkey)
    """,
    "q18": """
        SELECT c_name, o_custkey, o_orderkey, o_orderdate, o_totalprice,
               SUM(l_quantity) AS sum_qty
        FROM customer, orders, lineitem
        WHERE c_custkey = o_custkey AND o_orderkey = l_orderkey
          AND o_orderkey IN (
            SELECT l2.l_orderkey FROM lineitem l2
            GROUP BY l2.l_orderkey HAVING SUM(l2.l_quantity) > 300)
        GROUP BY c_name, o_custkey, o_orderkey, o_orderdate, o_totalprice
        ORDER BY o_totalprice DESC, o_orderdate
    """,
    "q19": """
        SELECT SUM(l_extendedprice * (1 - l_discount)) AS revenue
        FROM lineitem, part
        WHERE p_partkey = l_partkey
          AND l_shipinstruct = 'DELIVER IN PERSON'
          AND l_shipmode IN ('AIR', 'AIR REG')
          AND ((p_brand = 'Brand#12'
                AND p_container IN ('SM CASE', 'SM BOX', 'SM PACK', 'SM PKG')
                AND l_quantity BETWEEN 1 AND 11 AND p_size BETWEEN 1 AND 5)
            OR (p_brand = 'Brand#23'
                AND p_container IN ('MED BAG', 'MED BOX', 'MED PKG', 'MED PACK')
                AND l_quantity BETWEEN 10 AND 20 AND p_size BETWEEN 1 AND 10)
            OR (p_brand = 'Brand#34'
                AND p_container IN ('LG CASE', 'LG BOX', 'LG PACK', 'LG PKG')
                AND l_quantity BETWEEN 20 AND 30 AND p_size BETWEEN 1 AND 15))
    """,
    "q20": """
        SELECT s_name, s_address
        FROM supplier, nation
        WHERE s_nationkey = n_nationkey AND n_name = 'CANADA'
          AND s_suppkey IN (
            SELECT ps_suppkey FROM partsupp
            WHERE ps_partkey IN (
                SELECT p_partkey FROM part WHERE p_name LIKE 'forest%')
              AND ps_availqty > (
                SELECT 0.5 * SUM(l_quantity) FROM lineitem
                WHERE l_partkey = ps_partkey AND l_suppkey = ps_suppkey
                  AND l_shipdate >= DATE '1994-01-01'
                  AND l_shipdate < DATE '1995-01-01'))
        ORDER BY s_name
    """,
    "q21": """
        SELECT s_name, COUNT(*) AS numwait
        FROM supplier, lineitem l1, orders, nation
        WHERE s_suppkey = l1.l_suppkey AND o_orderkey = l1.l_orderkey
          AND s_nationkey = n_nationkey AND n_name = 'SAUDI ARABIA'
          AND o_orderstatus = 'F'
          AND l1.l_receiptdate > l1.l_commitdate
          AND EXISTS (
            SELECT * FROM lineitem l2
            WHERE l2.l_orderkey = l1.l_orderkey
              AND l2.l_suppkey <> l1.l_suppkey)
          AND NOT EXISTS (
            SELECT * FROM lineitem l3
            WHERE l3.l_orderkey = l1.l_orderkey
              AND l3.l_suppkey <> l1.l_suppkey
              AND l3.l_receiptdate > l3.l_commitdate)
        GROUP BY s_name
        ORDER BY numwait DESC, s_name
    """,
    "q22": """
        SELECT SUBSTRING(c_phone, 1, 2) AS cntrycode, COUNT(*) AS numcust,
               SUM(c_acctbal) AS totacctbal
        FROM customer
        WHERE SUBSTRING(c_phone, 1, 2)
                IN ('13', '31', '23', '29', '30', '18', '17')
          AND c_acctbal > (
            SELECT AVG(c2.c_acctbal) FROM customer c2
            WHERE c2.c_acctbal > 0.00
              AND SUBSTRING(c2.c_phone, 1, 2)
                    IN ('13', '31', '23', '29', '30', '18', '17'))
          AND NOT EXISTS (
            SELECT * FROM orders WHERE o_custkey = c_custkey)
        GROUP BY cntrycode
        ORDER BY cntrycode
    """,
}


_Q11_TEMPLATE = TPCH_SQL["q11"]


def sql_text(qname: str, sf: float = 1.0) -> str:
    """SQL text of a TPC-H query at scale factor ``sf``.

    Only q11 is scale-dependent (its HAVING threshold fraction is
    0.0001/SF per the TPC-H spec); every other query returns the
    ``TPCH_SQL`` entry verbatim."""
    if qname == "q11":
        return _Q11_TEMPLATE.replace("{q11_fraction}", f"{0.0001 / sf:.12f}")
    return TPCH_SQL[qname]


# the plain dict entry carries the SF=1 threshold so every TPCH_SQL
# text is directly executable
TPCH_SQL["q11"] = sql_text("q11", 1.0)


# queries whose SQL form returns a single aggregate row
SCALAR_SQL = {"q6", "q14", "q17", "q19"}
