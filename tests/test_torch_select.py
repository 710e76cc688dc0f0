"""The rest of SELECT in the port, held against the JAX package.

The same SQL over the same seeded rows goes through ``citus_tpu.Cluster``
(the reference, JAX on the CPU) and ``citus_tpu_torch.Cluster(device=
"cpu")`` (the port); the rows must be identical (floats within rel 1e-12:
an intermediate table reorders rows, so a float sum may differ in its
last bits; decimals, integers, text and dates are exact).  The cases are
the SQL of tests/test_cte.py, test_recursive_cte.py, test_setops.py,
test_subqueries.py, test_window.py and the DISTINCT ON cases of
test_upsert_distinct_on.py, GROUPING SETS, SELECT without FROM,
unnest, DELETE/UPDATE with subqueries, and chip_smoke.py's phase 10
queries at a few thousand rows.  Also: both packages raise the same
error class on the same bad query, including the two reference faults
ROADMAP.md C10 and C11, and the intermediate tables are dropped.
"""

import os
import sqlite3  # noqa: F401  (the reference's tests diff against it)
import sys

import numpy as np
import pytest

import citus_tpu as ct  # noqa: F401  (flips JAX to 64 bits first)
import citus_tpu_torch as ctt
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

LINEITEM_ROWS = 6000
#: phase 10's IN-subquery threshold at LINEITEM_ROWS (a few dozen keys)
IN_THRESHOLD = 30


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _setops_rows():
    """tests/test_setops.py's t and u (seed 5)."""
    rng = np.random.default_rng(5)
    trows = [(i, int(rng.integers(0, 12)) if rng.random() > 0.05 else None,
              f"g{i % 3}") for i in range(400)]
    urows = [(i, int(rng.integers(0, 8)) if rng.random() > 0.05 else None)
             for i in range(250)]
    return trows, urows


def _emp_rows():
    """tests/test_recursive_cte.py's org hierarchy (seed 7)."""
    rng = np.random.default_rng(7)
    rows = [(0, None, 100)]
    for i in range(1, 300):
        rows.append((i, int(rng.integers(0, i)), int(rng.integers(50, 150))))
    return rows


def _load(cl):
    """Every table of the cases, under names of their own."""
    ddl = [
        # tests/test_cte.py
        ("CREATE TABLE t (k bigint NOT NULL, v bigint, s text)", "t", "k"),
        ("CREATE TABLE bt (k bigint NOT NULL, v bigint)", "bt", "k"),
        # tests/test_setops.py's t and u
        ("CREATE TABLE st (k bigint NOT NULL, v bigint, s text)", "st", "k"),
        ("CREATE TABLE su (k bigint NOT NULL, v bigint)", "su", "k"),
        # tests/test_subqueries.py's t (distributed) and u (local)
        ("CREATE TABLE qt (k bigint NOT NULL, v bigint, s text)", "qt", "k"),
        ("CREATE TABLE qu (x bigint, y bigint)", None, None),
        # its correlated pairs
        ("CREATE TABLE ct1 (k bigint NOT NULL, v bigint)", "ct1", "k"),
        ("CREATE TABLE cu1 (k bigint NOT NULL, w bigint)", "cu1", "k"),
        ("CREATE TABLE ct2 (k bigint NOT NULL, g bigint, v bigint)", "ct2",
         "k"),
        ("CREATE TABLE cu2 (k bigint NOT NULL, w bigint)", "cu2", "k"),
        ("CREATE TABLE o (ok bigint NOT NULL, oa bigint, ob bigint, "
         "ov bigint)", "o", "ok"),
        ("CREATE TABLE i (ik bigint NOT NULL, ia bigint, ib bigint, "
         "iv bigint)", "i", "ik"),
        ("CREATE TABLE nt (k bigint NOT NULL, v bigint)", "nt", "k"),
        ("CREATE TABLE lk (lk_k bigint NOT NULL, lk_v bigint)", None, None),
        # tests/test_window.py
        ("CREATE TABLE wt (k bigint NOT NULL, g text, v bigint)", "wt", "k"),
        ("CREATE TABLE wp (k bigint NOT NULL, g bigint, v bigint)", "wp",
         "k"),
        # tests/test_upsert_distinct_on.py
        ("CREATE TABLE e (id bigint NOT NULL, dev bigint, ts bigint, "
         "v double)", "e", "id"),
        # tests/test_recursive_cte.py
        ("CREATE TABLE edges (src bigint NOT NULL, dst bigint)", "edges",
         "src"),
        ("CREATE TABLE emp (id bigint NOT NULL, boss bigint, salary bigint)",
         "emp", "id"),
        ("CREATE TABLE fact (k bigint NOT NULL, v bigint)", "fact", "k"),
        # tests/golden/grouping_sets.sql and types2.sql
        ("CREATE TABLE sales (id bigint NOT NULL, region text, product text, "
         "amount decimal(10,2))", "sales", "id"),
        ("CREATE TABLE ev (k bigint NOT NULL, tags text[])", "ev", "k"),
        # tests/test_torch_slice.py's events (its first three statements
        # that the port refused before it answered WITH, windows and
        # derived tables)
        ("CREATE TABLE events (id bigint NOT NULL, kind text)", "events",
         "id"),
        # DELETE / UPDATE with subqueries, one table a case
        ("CREATE TABLE dm1 (k bigint NOT NULL, v bigint)", "dm1", "k"),
        ("CREATE TABLE dm2 (k bigint NOT NULL, v bigint)", "dm2", "k"),
        ("CREATE TABLE dm3 (k bigint NOT NULL, v bigint)", "dm3", "k"),
        ("CREATE TABLE dm4 (k bigint NOT NULL, v bigint)", "dm4", "k"),
    ]
    for sql, name, col in ddl:
        cl.execute(sql)
        if name is not None:
            cl.execute(f"SELECT create_distributed_table('{name}', '{col}', 4)")
    cl.copy_from("t", rows=[(i, i % 15, ["x", "y", "z"][i % 3])
                            for i in range(1000)])
    cl.copy_from("bt", columns={"k": np.arange(6000),
                                "v": np.arange(6000) % 100})
    trows, urows = _setops_rows()
    cl.copy_from("st", rows=trows)
    cl.copy_from("su", rows=urows)
    cl.copy_from("qt", rows=[(i, i % 20, ["a", "b", "c"][i % 3])
                             for i in range(500)])
    cl.copy_from("qu", rows=[(i, i * 3) for i in range(10)])
    cl.copy_from("ct1", rows=[(i, i % 7 if i % 11 else None)
                              for i in range(200)])
    cl.copy_from("cu1", rows=[(i, i % 5) for i in range(80)])
    cl.copy_from("ct2", rows=[(i, i % 6, (i * 3) % 50) for i in range(150)])
    cl.copy_from("cu2", rows=[(i % 40, i) for i in range(120)])
    cl.copy_from("o", rows=[(n, n % 7, n % 5, n % 11) for n in range(300)])
    cl.copy_from("i", rows=[(n, n % 9, n % 5, n % 13) for n in range(120)])
    cl.copy_from("nt", rows=[(i, i % 4) for i in range(50)] + [(100, 99)])
    cl.copy_from("lk", rows=[(i, i * 100) for i in range(4)])
    cl.copy_from("wt", rows=[(i, ["a", "b", "c"][i % 3], (i * 7) % 23)
                             for i in range(300)])
    cl.copy_from("wp", rows=[(i % 10, i % 3, (i * 7) % 20) for i in range(60)])
    cl.copy_from("e", rows=[(i, i % 3, (i * 7) % 20, float(i))
                            for i in range(60)])
    cl.copy_from("edges", rows=[(1, 2), (2, 3), (3, 4), (3, 1), (4, 5),
                                (9, 10)])
    cl.copy_from("emp", rows=_emp_rows())
    cl.copy_from("fact", columns={"k": np.arange(20), "v": np.arange(20) * 10})
    cl.execute("INSERT INTO sales VALUES (1, 'east', 'ax', 10.00), "
               "(2, 'east', 'bx', 20.00), (3, 'west', 'ax', 30.00), "
               "(4, 'west', 'bx', 40.00), (5, 'east', 'ax', 5.00)")
    cl.execute("INSERT INTO ev VALUES (1, ARRAY['a','b']), "
               "(2, ARRAY['c']), (3, NULL)")
    cl.copy_from("events", rows=[(i, ["click", "view", "buy", None][i % 4])
                                 for i in range(500)])
    for name in ("dm1", "dm2", "dm3", "dm4"):
        cl.copy_from(name, rows=[(i, i % 20) for i in range(200)])
    cl.execute(chip_smoke.LINEITEM_DDL)
    cl.execute("SELECT create_distributed_table('lineitem', 'l_orderkey', 4)")
    for c in chip_smoke.lineitem_chunks(LINEITEM_ROWS):
        cl.copy_from("lineitem", columns=chip_smoke.copy_columns(c))


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(reference cluster, port cluster) over the same rows, two nodes
    each, as the reference's tests run."""
    ref = ct.Cluster(str(tmp_path_factory.mktemp("ref")), n_nodes=2)
    port = ctt.Cluster(str(tmp_path_factory.mktemp("port")), n_nodes=2,
                       device="cpu")
    for cl in (ref, port):
        _load(cl)
    yield ref, port
    port.close()
    ref.close()


def assert_same_rows(got, want):
    """Identical rows; floats within rel 1e-12 (see the module doc)."""
    assert len(got) == len(want), (got[:10], want[:10])
    for g, w in zip(got, want):
        assert len(g) == len(w), (g, w)
        for a, b in zip(g, w):
            if isinstance(b, float) and isinstance(a, float):
                assert a == pytest.approx(b, rel=1e-12, nan_ok=True), (g, w)
            else:
                assert type(a) is type(b) and a == b, (g, w)


CTE = [
    # tests/test_cte.py
    "WITH top AS (SELECT v, count(*) AS c FROM t GROUP BY v) "
    "SELECT count(*), sum(c) FROM top",
    "WITH f AS (SELECT k, v FROM t WHERE v > 10) "
    "SELECT v, count(*) FROM f GROUP BY v",
    "WITH a AS (SELECT v, count(*) AS c FROM t GROUP BY v), "
    "b AS (SELECT c FROM a WHERE c > 60) SELECT count(*) FROM b",
    "WITH agg AS (SELECT s, sum(v) AS sv FROM t GROUP BY s) "
    "SELECT t2.s, t2.sv FROM agg t2 ORDER BY t2.s",
    "WITH sums AS (SELECT v, sum(k) AS sk FROM t GROUP BY v) "
    "SELECT count(*) FROM t JOIN sums ON t.v = sums.v WHERE sums.sk > 30000",
    "WITH x AS (SELECT count(*) AS c FROM t) SELECT c FROM x",
    # an intermediate result past 4,096 rows is hash-distributed
    "WITH big AS (SELECT k, v * 2 AS w FROM bt WHERE v < 90) "
    "SELECT count(*), sum(w) FROM big",
    "WITH allv AS (SELECT v FROM st UNION SELECT v FROM su) "
    "SELECT count(*) FROM allv",
]

SETOPS = [
    # tests/test_setops.py
    "SELECT v FROM st UNION SELECT v FROM su ORDER BY v NULLS LAST",
    "SELECT v FROM st UNION ALL SELECT v FROM su ORDER BY v NULLS LAST LIMIT 40",
    "SELECT v FROM st INTERSECT SELECT v FROM su ORDER BY v NULLS LAST",
    "SELECT v FROM st EXCEPT SELECT v FROM su ORDER BY v NULLS LAST",
    "SELECT v, count(*) FROM st GROUP BY v UNION SELECT v, count(*) FROM su "
    "GROUP BY v ORDER BY 1 NULLS LAST, 2",
    "SELECT v FROM st WHERE v < 3 UNION SELECT v FROM st WHERE v > 9 "
    "INTERSECT SELECT v FROM su ORDER BY v",
    "SELECT k FROM st WHERE exists (SELECT 1 FROM su WHERE su.v = 7) "
    "ORDER BY k LIMIT 5",
    "SELECT count(*) FROM st WHERE not exists (SELECT 1 FROM su WHERE su.v = 99)",
    "SELECT count(*) FROM (SELECT v FROM st UNION ALL SELECT v FROM su) z",
    "SELECT g, n FROM (SELECT s AS g, count(*) AS n FROM st GROUP BY s) z "
    "WHERE n > 50 ORDER BY g",
    "SELECT count(*) FROM st JOIN (SELECT k FROM su WHERE v < 4) z "
    "ON st.k = z.k",
    "SELECT z.v, count(*) FROM (SELECT v FROM st WHERE v IS NOT NULL) z "
    "GROUP BY z.v ORDER BY z.v",
    "SELECT v FROM st EXCEPT ALL SELECT v FROM su",
    "SELECT v FROM st INTERSECT ALL SELECT v FROM su",
    "SELECT v FROM (SELECT v FROM st WHERE v < 5 UNION ALL "
    "SELECT v FROM su WHERE v < 5) z ORDER BY v NULLS LAST LIMIT 20",
]

SUBQUERIES = [
    # tests/test_subqueries.py
    "SELECT count(*) FROM qt WHERE v > (SELECT count(*) FROM qu)",
    "SELECT count(*) FROM qt WHERE k IN (SELECT x FROM qu)",
    "SELECT count(*) FROM qt WHERE k NOT IN (SELECT x FROM qu WHERE y > 12)",
    "SELECT count(*) FROM qt WHERE v = (SELECT min(y) FROM qu WHERE x = 1)",
    "SELECT v, count(*) FROM qt WHERE v >= (SELECT max(x) FROM qu) "
    "GROUP BY v ORDER BY v",
    "SELECT count(*) FROM qt WHERE k IN (SELECT x FROM qu) AND v < 10",
    "SELECT count(*) FROM qt WHERE v > (SELECT y FROM qu WHERE x = 9999)",
    "SELECT count(*) FROM ct1 WHERE EXISTS "
    "(SELECT 1 FROM cu1 WHERE cu1.k = ct1.k)",
    "SELECT count(*) FROM ct1 WHERE EXISTS "
    "(SELECT 1 FROM cu1 WHERE cu1.k = ct1.k AND cu1.w > 2)",
    "SELECT count(*) FROM ct1 WHERE NOT EXISTS "
    "(SELECT 1 FROM cu1 WHERE cu1.k = ct1.k)",
    "SELECT count(*) FROM ct1 WHERE NOT EXISTS "
    "(SELECT 1 FROM cu1 WHERE cu1.w = ct1.v)",
    "SELECT count(*) FROM ct1 WHERE EXISTS "
    "(SELECT 1 FROM cu1 WHERE ct1.v = cu1.w AND cu1.k < 40)",
    "SELECT v, count(*) FROM ct1 WHERE EXISTS "
    "(SELECT 1 FROM cu1 WHERE cu1.k = ct1.k) GROUP BY v ORDER BY v NULLS LAST",
    "SELECT ct2.k, (SELECT max(w) FROM cu2 WHERE cu2.k = ct2.k) FROM ct2 "
    "ORDER BY ct2.k LIMIT 50",
    "SELECT ct2.k, (SELECT count(*) FROM cu2 WHERE cu2.k = ct2.k) FROM ct2 "
    "ORDER BY ct2.k LIMIT 50",
    "SELECT count(*) FROM ct2 WHERE ct2.v > "
    "(SELECT avg(w) FROM cu2 WHERE cu2.k = ct2.g)",
    "SELECT ct2.k, (SELECT sum(w) FROM cu2 WHERE cu2.k = ct2.k AND cu2.w > 30) "
    "FROM ct2 ORDER BY ct2.k LIMIT 40",
    "SELECT count(*) FROM o WHERE EXISTS (SELECT 1 FROM i WHERE "
    "i.ia = o.oa AND i.ib = o.ob)",
    "SELECT count(*) FROM o WHERE NOT EXISTS (SELECT 1 FROM i WHERE "
    "i.ia = o.oa AND i.ib = o.ob AND i.iv > 5)",
    "SELECT oa, count(*) FROM o WHERE EXISTS (SELECT 1 FROM i WHERE "
    "i.ia = o.oa AND i.ib = o.ob AND i.iv < 9) AND o.ov > 2 "
    "GROUP BY oa ORDER BY oa",
    "SELECT count(*) FROM o WHERE o.ov IN (SELECT i.iv FROM i WHERE "
    "i.ia = o.oa)",
    "SELECT count(*) FROM o WHERE o.ov IN (SELECT i.iv FROM i WHERE "
    "i.ib = o.ob AND i.ik < 60) AND o.oa < 5",
    "SELECT ok, (SELECT sum(i.iv) FROM i WHERE i.ia = o.oa AND "
    "i.ib = o.ob) FROM o ORDER BY ok LIMIT 40",
    "SELECT ok, (SELECT count(*) FROM i WHERE i.ia = o.oa AND "
    "i.ib = o.ob) FROM o ORDER BY ok LIMIT 40",
    "SELECT count(*) FROM o WHERE o.oa = 6 OR EXISTS "
    "(SELECT 1 FROM i WHERE i.ia = o.ob)",
    "SELECT count(*) FROM o WHERE o.ov IN "
    "(SELECT max(i.iv) FROM i WHERE i.ia = o.oa)",
    "SELECT count(*) FROM o WHERE EXISTS "
    "(SELECT count(*) FROM i WHERE i.ia = o.oa)",
    "SELECT count(*) FROM o WHERE NOT EXISTS "
    "(SELECT sum(i.iv) FROM i WHERE i.ia = o.oa)",
    "SELECT k, (SELECT lk.lk_v FROM lk WHERE lk.lk_k = nt.v) FROM nt "
    "WHERE k < 100 ORDER BY k LIMIT 5",
    "SELECT (SELECT lk.lk_v FROM lk WHERE lk.lk_k = nt.v) FROM nt "
    "WHERE k = 100",
]

def _nested(levels: int) -> str:
    """A scalar subquery nested ``levels`` deep, each level a statement
    that ``_execute_stmt`` materializes first."""
    sql = "SELECT 1"
    for _ in range(levels):
        sql = f"SELECT count(*) FROM qt WHERE v < ({sql}) + 15"
    return sql


SUBQUERIES.append(_nested(30))

RECURSIVE = [
    # tests/test_recursive_cte.py and tests/golden/recursive_cte.sql
    "WITH RECURSIVE s(n) AS (SELECT 1 UNION ALL SELECT n + 1 FROM s "
    "WHERE n < 10) SELECT n FROM s ORDER BY n",
    "WITH RECURSIVE reach(node) AS (SELECT 1 UNION "
    "SELECT e.dst FROM edges e, reach r WHERE e.src = r.node) "
    "SELECT node FROM reach ORDER BY node",
    "WITH RECURSIVE hops(node, depth) AS (SELECT 1, 0 UNION ALL "
    "SELECT e.dst, h.depth + 1 FROM edges e, hops h WHERE e.src = h.node "
    "AND h.depth < 3) SELECT depth, count(*) FROM hops GROUP BY depth "
    "ORDER BY depth",
    "WITH RECURSIVE chain(id, depth) AS (SELECT id, 0 FROM emp WHERE boss "
    "IS NULL UNION ALL SELECT e.id, c.depth + 1 FROM emp e, chain c "
    "WHERE e.boss = c.id) SELECT depth, count(*) FROM chain GROUP BY depth "
    "ORDER BY depth",
    "WITH RECURSIVE sub(id) AS (SELECT id FROM emp WHERE id = 5 UNION ALL "
    "SELECT e.id FROM emp e, sub s WHERE e.boss = s.id) "
    "SELECT count(*) FROM sub",
    "WITH RECURSIVE keys(n) AS (SELECT 0 UNION ALL SELECT n + 2 FROM keys "
    "WHERE n < 8) SELECT sum(f.v) FROM fact f, keys WHERE f.k = keys.n",
    "WITH RECURSIVE a(x) AS (SELECT 41), b(y) AS (SELECT x + 1 FROM a) "
    "SELECT y FROM b",
]

WINDOWS = [
    # tests/test_window.py
    "SELECT k, row_number() OVER (PARTITION BY g ORDER BY k) FROM wt",
    "SELECT k, rank() OVER (PARTITION BY g ORDER BY v) FROM wt",
    "SELECT k, dense_rank() OVER (PARTITION BY g ORDER BY v) FROM wt",
    "SELECT k, sum(v) OVER (PARTITION BY g) FROM wt",
    "SELECT k, sum(v) OVER (PARTITION BY g ORDER BY k) FROM wt",
    "SELECT k, count(*) OVER (PARTITION BY g ORDER BY v) FROM wt",
    "SELECT k, min(v) OVER (PARTITION BY g ORDER BY k) FROM wt",
    "SELECT k, row_number() OVER (ORDER BY k DESC) FROM wt WHERE v > 10",
    "SELECT k, row_number() OVER (ORDER BY k) AS rn FROM wt "
    "ORDER BY rn DESC LIMIT 5",
    # the pushdown: PARTITION BY the distribution column
    "SELECT k, sum(v) OVER (PARTITION BY k ORDER BY v "
    "ROWS BETWEEN 1 PRECEDING AND CURRENT ROW) AS s FROM wp ORDER BY k, s",
    "SELECT k, avg(v) OVER (PARTITION BY g ORDER BY k ROWS BETWEEN "
    "2 PRECEDING AND 1 FOLLOWING) AS a FROM wp ORDER BY k, a",
    "SELECT k, lag(v, 2, 0) OVER w AS l, lead(v) OVER w AS n FROM wp "
    "WINDOW w AS (PARTITION BY g ORDER BY k, v) ORDER BY k, l, n",
    "SELECT k, first_value(v) OVER (PARTITION BY g ORDER BY v) AS fv, "
    "last_value(v) OVER (PARTITION BY g ORDER BY v ROWS BETWEEN UNBOUNDED "
    "PRECEDING AND UNBOUNDED FOLLOWING) AS lv, nth_value(v, 2) OVER "
    "(PARTITION BY g ORDER BY v) AS nv FROM wp ORDER BY k, fv, lv, nv",
    "SELECT k, ntile(3) OVER (ORDER BY v, k) AS bucket FROM wp "
    "ORDER BY k, bucket",
    "SELECT k, sum(v) OVER (ORDER BY v RANGE BETWEEN 3 PRECEDING AND "
    "CURRENT ROW) AS r FROM wp ORDER BY k, r",
    "SELECT g, sum(v) AS total, rank() OVER (ORDER BY sum(v) DESC) AS rnk "
    "FROM wp GROUP BY g ORDER BY g",
    "SELECT k, count(v) FILTER (WHERE v > 5) OVER (PARTITION BY g) AS c "
    "FROM wp ORDER BY k, c",
]

DISTINCT_ON = [
    # tests/test_upsert_distinct_on.py
    "SELECT DISTINCT ON (dev) dev, ts, v FROM e ORDER BY dev, ts DESC, v DESC",
    "SELECT DISTINCT ON (dev) dev, ts FROM e ORDER BY dev DESC, ts LIMIT 2",
    "SELECT DISTINCT ON (dev) dev FROM e",
    "SELECT DISTINCT ON (dev % 2) dev % 2, ts FROM e ORDER BY dev % 2, ts DESC",
]

GROUPING_SETS = [
    # tests/golden/grouping_sets.sql
    "SELECT region, product, sum(amount) FROM sales GROUP BY "
    "ROLLUP(region, product) ORDER BY region NULLS LAST, product NULLS LAST",
    "SELECT region, product, count(*) FROM sales GROUP BY "
    "CUBE(region, product) ORDER BY region NULLS LAST, product NULLS LAST",
    "SELECT region, product, sum(amount) FROM sales GROUP BY "
    "GROUPING SETS((region), (product)) ORDER BY region NULLS LAST, "
    "product NULLS LAST",
    "SELECT region, grouping(region) AS g, sum(amount) FROM sales GROUP BY "
    "ROLLUP(region) ORDER BY g, region NULLS LAST",
    "SELECT region, sum(amount) FROM sales GROUP BY ROLLUP(region) "
    "HAVING sum(amount) > 20 ORDER BY region NULLS LAST",
]

CONSTANT = [
    "SELECT 1 + 2, 'x', NULL",
    "SELECT 41 + 1 AS answer WHERE 1 < 2",
    "SELECT (SELECT count(*) FROM t), (SELECT max(v) FROM st)",
    "SELECT round(2.345, 2), upper('abc'), coalesce(NULL, 7)",
]

UNNEST = [
    "SELECT k, unnest(tags) AS tag FROM ev ORDER BY k, tag",
    "SELECT unnest(tags) FROM ev WHERE k = 1",
]

MOVED = [
    "SELECT id, row_number() OVER (ORDER BY id) FROM events",
    "WITH w AS (SELECT id FROM events) SELECT count(*) FROM w",
    "SELECT count(*) FROM (SELECT id FROM events) s",
]

#: DELETE / UPDATE with subqueries, then the table read back (each case
#: has its table to itself)
DML = [
    ("DELETE FROM dm1 WHERE k IN (SELECT x FROM qu)",
     "SELECT count(*), sum(v) FROM dm1"),
    ("DELETE FROM dm2 WHERE v > (SELECT max(x) FROM qu) AND EXISTS "
     "(SELECT 1 FROM su WHERE su.v = 7)", "SELECT count(*), sum(v) FROM dm2"),
    ("UPDATE dm3 SET v = (SELECT max(y) FROM qu) WHERE k < 10",
     "SELECT k, v FROM dm3 WHERE k < 12 ORDER BY k"),
    ("UPDATE dm4 SET v = v + 1 WHERE k NOT IN (SELECT x FROM qu)",
     "SELECT count(*), sum(v) FROM dm4"),
]

PHASE10 = [sql for _, sql in chip_smoke.phase10_queries(IN_THRESHOLD)]

CASES = ([(q,) for q in CTE + SETOPS + SUBQUERIES + RECURSIVE + WINDOWS
          + DISTINCT_ON + GROUPING_SETS + CONSTANT + UNNEST + PHASE10
          + MOVED]
         + DML)


def _sorted_unless_ordered(sql, rows):
    return rows if "ORDER BY" in sql else sorted(rows, key=repr)


@pytest.mark.parametrize("stmts", CASES, ids=lambda s: s[0][:70])
def test_select_rows_identical_to_reference(pair, stmts):
    ref, port = pair
    for sql in stmts:
        want = ref.execute(sql)
        got = port.execute(sql)
        assert got.columns == want.columns, (got.columns, want.columns)
        assert_same_rows(_sorted_unless_ordered(sql, got.rows),
                         _sorted_unless_ordered(sql, want.rows))
        assert got.explain.get("strategy") == want.explain.get("strategy")
        assert got.explain.get("deleted") == want.explain.get("deleted")
        assert got.explain.get("updated") == want.explain.get("updated")


ERRORS = [
    # a scalar subquery of more than one row
    "SELECT count(*) FROM qt WHERE v > (SELECT y FROM qu)",
    # a set operation's sides of different widths
    "SELECT v FROM st UNION SELECT k, v FROM su",
    # a derived table without its alias
    "SELECT * FROM (SELECT v FROM st)",
    # a recursive CTE past its iteration cap, and one referring to
    # itself in its first arm
    "WITH RECURSIVE s(n) AS (SELECT 1 UNION ALL SELECT n + 1 FROM s) "
    "SELECT count(*) FROM s",
    "WITH RECURSIVE s(n) AS (SELECT n FROM s UNION ALL SELECT 1) "
    "SELECT * FROM s",
    # DISTINCT ON whose keys do not lead the ORDER BY
    "SELECT DISTINCT ON (dev) dev, ts FROM e ORDER BY ts",
    # a CTE's alias list of the wrong width
    "WITH c(a, b) AS (SELECT k FROM t) SELECT * FROM c",
    # a window ORDER BY on a name that is not an output
    "SELECT k, row_number() OVER (ORDER BY k) FROM wt ORDER BY v",
    # GROUP BY without FROM
    "SELECT 1 GROUP BY 1",
    # ROADMAP.md C10: a CTE named only inside a scalar subquery
    "WITH revenue AS (SELECT v, count(*) AS c FROM t GROUP BY v) "
    "SELECT v FROM revenue WHERE c = (SELECT max(c) FROM revenue)",
    # ROADMAP.md C11: an IN-subquery of a thousand keys
    "SELECT count(*) FROM t WHERE k IN "
    "(SELECT k FROM t GROUP BY k HAVING count(*) > 0)",
]


@pytest.mark.parametrize("sql", ERRORS, ids=lambda s: s[:70])
def test_same_error_class_as_reference(pair, sql):
    ref, port = pair
    with pytest.raises(Exception) as want:
        ref.execute(sql)
    with pytest.raises(Exception) as got:
        port.execute(sql)
    assert type(got.value).__name__ == type(want.value).__name__, (
        got.value, want.value)


def test_c10_cte_in_scalar_subquery_is_not_remapped(pair):
    """ROADMAP.md C10: TPC-H Q15's own text names its CTE inside a
    scalar subquery, which _execute_with does not remap: both packages
    raise CatalogError; the two-CTE form (chip_smoke.Q15) answers."""
    ref, port = pair
    q15 = ("WITH revenue AS (SELECT l_suppkey AS supplier_no, "
           "sum(l_extendedprice * (1 - l_discount)) AS total_revenue "
           "FROM lineitem GROUP BY l_suppkey) SELECT supplier_no "
           "FROM revenue WHERE total_revenue = "
           "(SELECT max(total_revenue) FROM revenue)")
    for cl in (ref, port):
        with pytest.raises(Exception) as e:
            cl.execute(q15)
        assert type(e.value).__name__ == "CatalogError"
        assert 'relation "revenue" does not exist' in str(e.value)
    assert port.execute(chip_smoke.Q15).rows == ref.execute(
        chip_smoke.Q15).rows


def test_c11_large_in_subquery_overflows_recursion(pair):
    """ROADMAP.md C11: an IN-subquery becomes an IN list, which the
    binder turns into a left-deep OR chain: past a few hundred keys
    both packages raise RecursionError; a few dozen keys answer."""
    ref, port = pair
    sql = ("SELECT count(*) FROM t WHERE k IN "
           "(SELECT k FROM t GROUP BY k HAVING count(*) > 0)")
    for cl in (ref, port):
        with pytest.raises(RecursionError):
            cl.execute(sql)
    small = sql.replace("GROUP BY k", "WHERE k < 40 GROUP BY k")
    assert port.execute(small).rows == ref.execute(small).rows == [(40,)]


def test_intermediate_tables_dropped_and_distributed(pair, monkeypatch):
    """Each CTE, derived table and recursive step is a catalog table
    dropped after the statement; one of 4,096 rows or more is
    hash-distributed over the active nodes, a smaller one stays
    local (reference: tests/test_cte.py)."""
    _, port = pair
    seen = []
    orig = port.catalog.distribute_table

    def spy(*a, **kw):
        seen.append(a[0])
        return orig(*a, **kw)
    monkeypatch.setattr(port.catalog, "distribute_table", spy)
    port.execute(CTE[6])
    assert any(n.startswith("__cte_") for n in seen)
    seen.clear()
    port.execute("WITH s AS (SELECT k FROM t WHERE k < 10) "
                 "SELECT count(*) FROM s")
    port.execute(SETOPS[8])
    port.execute(RECURSIVE[1])
    assert not seen
    assert not [n for n in port.catalog.tables if n.startswith("__")]


def test_dropped_intermediate_tables_leave_the_device_cache(pair):
    """A warm CTE query leaves no batch of its dropped intermediate
    tables in the device cache, however often it runs."""
    from citus_tpu_torch.executor.device_cache import GLOBAL_CACHE
    _, port = pair
    port.execute(chip_smoke.Q15)
    live = GLOBAL_CACHE.memory_view()["live_bytes"]
    for _ in range(5):
        port.execute(chip_smoke.Q15)
    view = GLOBAL_CACHE.memory_view()
    assert view["live_bytes"] == live
    assert not [t for t, _, _ in view["by_owner"] if t.startswith("__")]


def test_chip_smoke_phase10_oracles_match_the_port(pair):
    """chip_smoke.py's phase-10 helpers at LINEITEM_ROWS on the CPU: the
    numpy Q15 oracle, the cpu backend's rows of every query beside the
    device backend's (``same_rows``), and the parameterized Q6 of each
    of phase 5's value sets beside the literal Q6 and its oracle."""
    _, port = pair
    chunks = list(chip_smoke.lineitem_chunks(LINEITEM_ROWS))
    cols = {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}
    assert port.execute(chip_smoke.Q15).rows == chip_smoke.oracle_q15(cols)
    for _, sql in chip_smoke.phase10_queries(IN_THRESHOLD):
        got = port.execute(sql).rows
        assert chip_smoke.same_rows(
            got, chip_smoke.cpu_backend_rows(port, sql))
    assert port.settings.executor.task_executor_backend == "gpu"
    for i in range(chip_smoke.Q_BATCH):
        year, disc, qty = 1993 + i % 5, 2 + i, 24 + i % 2
        want = chip_smoke.oracle_q6(cols, year, disc, qty)
        assert port.execute(chip_smoke.Q6_PARAM,
                            params=chip_smoke.q6_params(i)).rows == want
        assert port.execute(chip_smoke.q6_variant(year, disc, qty)).rows \
            == want


def test_views_functions_and_partitions_of_the_catalog_are_refused(
        tmp_path):
    """A data directory the reference wrote with a view, an SQL function
    and a partitioned table opens in the port.  Until A14a a statement
    naming the view or the function was refused; since their expansion
    is ported, each runs, as does one naming the partitioned parent
    (ported since A11's local write surface) and one that names none of
    them, with the reference's rows."""
    d = str(tmp_path / "db")
    ref = ct.Cluster(d)
    ref.execute("CREATE TABLE vt (k bigint NOT NULL, v bigint)")
    ref.execute("SELECT create_distributed_table('vt', 'k', 4)")
    ref.copy_from("vt", rows=[(i, i % 3) for i in range(30)])
    ref.execute("CREATE VIEW small AS SELECT k FROM vt WHERE v = 0")
    ref.execute("CREATE FUNCTION addone(x bigint) RETURNS bigint AS 'x + 1'")
    ref.execute("CREATE TABLE metrics (tenant bigint NOT NULL, "
                "ts timestamp, v bigint) PARTITION BY RANGE (ts)")
    ref.execute("SELECT create_time_partitions('metrics', '1 hour', "
                "'2024-01-01 04:00', '2024-01-01 00:00')")
    want = ref.execute("SELECT count(*) FROM vt WHERE v < 2").rows
    want_parent = ref.execute("SELECT count(*) FROM metrics").rows
    named = ("SELECT count(*) FROM small",
             "WITH c AS (SELECT k FROM small) SELECT count(*) FROM c",
             "SELECT addone(k) FROM vt ORDER BY 1",
             "SELECT k FROM vt UNION SELECT addone(k) FROM vt ORDER BY 1")
    want_named = [ref.execute(sql).rows for sql in named]
    ref.close()
    port = ctt.Cluster(d, device="cpu")
    try:
        for sql, w in zip(named, want_named):
            assert port.execute(sql).rows == w, sql
        # a partitioned parent expands to its partitions
        assert port.execute("SELECT count(*) FROM metrics").rows \
            == want_parent
        assert port.execute("SELECT count(*) FROM vt WHERE v < 2").rows \
            == want
    finally:
        port.close()
