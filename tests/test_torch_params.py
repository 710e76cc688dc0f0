"""Parameterized execution in the port, held against the JAX package.

``execute(sql, params)`` and PREPARE / EXECUTE / DEALLOCATE run the
same SQL with the same $N values through ``citus_tpu.Cluster`` and
``citus_tpu_torch.Cluster(device="cpu")`` over the same seeded rows:
date, decimal, text (against a dictionary column), NULL and integer
values; the generic-plan cache (one miss, then hits, shared by both
spellings, one kernel build); the literal-substitution fallback (a
subquery, a window, DISTINCT ON, DML); and the reference's errors
(too few parameters, a duplicate PREPARE, an unknown EXECUTE or
DEALLOCATE, an error inside a transaction block).
"""

import datetime
import decimal

import numpy as np
import pytest

import citus_tpu as ct  # noqa: F401  (flips JAX to 64 bits first)
import citus_tpu_torch as ctt
import torch

D = decimal.Decimal


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _load(cl):
    """tests/test_param_plans.py's table, plus a date column."""
    cl.execute("CREATE TABLE t (k bigint NOT NULL, v bigint, s text, "
               "d decimal(8,2), dt date)")
    cl.execute("SELECT create_distributed_table('t', 'k', 4)")
    n = 2000
    cl.copy_from("t", columns={
        "k": np.arange(n), "v": np.arange(n) % 50,
        "s": [f"n{i % 5}" if i % 17 else None for i in range(n)],
        "d": np.arange(n) / 4,
        "dt": (np.arange(n) % 400 + 9000).astype(np.int32)})
    cl.execute("CREATE TABLE w (k bigint NOT NULL, v bigint)")
    cl.execute("SELECT create_distributed_table('w', 'k', 4)")
    cl.copy_from("w", rows=[(i, i % 7) for i in range(300)])


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    ref = ct.Cluster(str(tmp_path_factory.mktemp("ref")))
    port = ctt.Cluster(str(tmp_path_factory.mktemp("port")), device="cpu")
    for cl in (ref, port):
        _load(cl)
    yield ref, port
    port.close()
    ref.close()


def _lit(v) -> str:
    """A parameter value as the SQL literal an EXECUTE passes."""
    if v is None:
        return "NULL"
    if isinstance(v, datetime.date):
        return f"date '{v.isoformat()}'"
    if isinstance(v, str):
        return f"'{v}'"
    return str(v)


CASES = [
    ("SELECT count(*), sum(d) FROM t WHERE dt >= $1 AND dt < $2",
     [datetime.date(1994, 9, 1), datetime.date(1994, 12, 1)]),
    ("SELECT count(*), sum(v) FROM t WHERE d <= $1",
     [D("2.50")]),
    ("SELECT count(*), min(k) FROM t WHERE d BETWEEN $1 AND $2",
     [D("100.25"), D("120.00")]),
    ("SELECT count(*) FROM t WHERE s = $1", ["n3"]),
    ("SELECT count(*) FROM t WHERE s = $1", ["missing"]),
    ("SELECT count(*) FROM t WHERE k = $1", [None]),
    ("SELECT count(*) FROM t WHERE s = $1 OR d > $2", [None, D("400")]),
    ("SELECT s, count(*), sum(d) FROM t WHERE v < $1 AND dt < $2 "
     "GROUP BY s ORDER BY s NULLS LAST", [33, datetime.date(1995, 1, 1)]),
    ("SELECT v + $2, s FROM t WHERE k = $1", [3, 100]),
    ("SELECT count(*) FROM t WHERE v IN ($1, $2, $3)", [1, 2, 3]),
    # the literal-substitution fallback: a subquery, a window, DISTINCT ON
    ("SELECT count(*) FROM t WHERE v < "
     "(SELECT max(v) FROM t WHERE k < $1)", [100]),
    ("SELECT k, row_number() OVER (ORDER BY v, k) AS rn FROM w "
     "WHERE k < $1 ORDER BY rn", [20]),
    ("SELECT DISTINCT ON (v) v, k FROM w WHERE k < $1 ORDER BY v, k DESC",
     [60]),
]


@pytest.mark.parametrize("how", ["execute", "prepare"])
@pytest.mark.parametrize("sql,params", CASES, ids=lambda x: str(x)[:60])
def test_params_rows_identical_to_reference(pair, sql, params, how):
    ref, port = pair
    if how == "execute":
        want = ref.execute(sql, params=params)
        got = port.execute(sql, params=params)
    else:
        args = ", ".join(_lit(v) for v in params)
        out = []
        for cl in (ref, port):
            s = cl.session()
            s.execute(f"PREPARE pq AS {sql}")
            out.append(s.execute(f"EXECUTE pq ({args})"))
            s.execute("DEALLOCATE pq")
        want, got = out
    assert got.columns == want.columns
    assert got.rows == want.rows
    assert got.explain.get("strategy") == want.explain.get("strategy")


def _delta(c0, c1, key):
    return c1.get(key, 0) - c0.get(key, 0)


def test_one_generic_plan_for_both_spellings(pair):
    """8 value sets through execute(sql, params), then the same 8
    through PREPARE / EXECUTE: one plan-cache miss, 15 hits, one kernel
    build; rows equal the literal query's and the reference's."""
    ref, port = pair
    sql = ("SELECT count(*), sum(d) FROM t WHERE dt >= $1 AND dt < $2 "
           "AND d BETWEEN $3 AND $4 AND v < $5")
    sets = [[datetime.date(1994, 8 + i % 4, 1),
             datetime.date(1995, 1 + i % 3, 1),
             D(f"{i}.25"), D(f"{300 + 20 * i}.00"), 20 + i]
            for i in range(8)]
    c0 = port.counters.snapshot()
    got = [port.execute(sql, params=p).rows for p in sets]
    s = port.session()
    s.execute(f"PREPARE q6 (date, date, numeric, numeric, bigint) AS {sql}")
    got2 = [s.execute(f"EXECUTE q6 ({', '.join(_lit(v) for v in p)})").rows
            for p in sets]
    s.execute("DEALLOCATE q6")
    c1 = port.counters.snapshot()
    assert _delta(c0, c1, "plan_cache_misses") == 1
    assert _delta(c0, c1, "plan_cache_hits") == 15
    assert _delta(c0, c1, "kernel_cache_misses") <= 1
    for p, a, b in zip(sets, got, got2):
        assert a == b == ref.execute(sql, params=p).rows
        literal = sql
        for j in range(len(p), 0, -1):
            literal = literal.replace(f"${j}", _lit(p[j - 1]))
        assert a == port.execute(literal).rows


def test_dml_params_match_reference(pair):
    ref, port = pair
    for cl in (ref, port):
        cl.execute("CREATE TABLE dm (k bigint NOT NULL, v bigint)")
        cl.execute("SELECT create_distributed_table('dm', 'k', 4)")
        cl.copy_from("dm", rows=[(i, i % 9) for i in range(100)])
        cl.execute("DELETE FROM dm WHERE v = $1", params=[3])
        cl.execute("UPDATE dm SET v = $1 WHERE k < $2", params=[40, 10])
        s = cl.session()
        s.execute("PREPARE ins AS INSERT INTO dm VALUES ($1, $2)")
        s.execute("EXECUTE ins (1000, 5)")
    q = "SELECT count(*), sum(v), max(k) FROM dm"
    assert port.execute(q).rows == ref.execute(q).rows
    assert port.execute(q).rows[0][2] == 1000


@pytest.mark.parametrize("case", ["too_few", "duplicate", "unknown_execute",
                                  "unknown_deallocate", "not_plannable"])
def test_errors_match_reference(pair, case):
    ref, port = pair
    names = []
    for cl in (ref, port):
        s = cl.session()
        with pytest.raises(Exception) as e:
            if case == "too_few":
                s.execute("SELECT count(*) FROM t WHERE v < $2", params=[1])
            elif case == "duplicate":
                s.execute("PREPARE d1 AS SELECT 1")
                s.execute("PREPARE d1 AS SELECT 2")
            elif case == "unknown_execute":
                s.execute("EXECUTE nope")
            elif case == "unknown_deallocate":
                s.execute("DEALLOCATE nope")
            else:
                s.execute("PREPARE bad AS BEGIN")
        names.append((type(e.value).__name__, str(e.value)))
    assert names[0] == names[1]


def test_prepared_statements_per_session_and_not_transactional(pair):
    """As in tests/test_prepare_execute.py: a statement prepared inside
    a rolled-back block survives, DEALLOCATE ALL forgets every one, a
    failed EXECUTE aborts the block, another session sees none."""
    from citus_tpu_torch.errors import CatalogError
    from citus_tpu_torch.transaction.session import InFailedTransaction
    _, port = pair
    s = port.session()
    s.execute("BEGIN")
    s.execute("PREPARE q AS SELECT count(*) FROM t")
    s.execute("ROLLBACK")
    assert s.execute("EXECUTE q").rows == [(2000,)]
    s.execute("PREPARE r AS SELECT 1")
    with pytest.raises(CatalogError):
        port.session().execute("EXECUTE r")
    s.execute("DEALLOCATE ALL")
    for name in ("q", "r"):
        with pytest.raises(CatalogError):
            s.execute(f"EXECUTE {name}")
    s.execute("BEGIN")
    with pytest.raises(CatalogError):
        s.execute("EXECUTE nope")
    with pytest.raises(InFailedTransaction):
        s.execute("SELECT 1")
    assert s.execute("COMMIT").explain.get("transaction") == "rollback"


def test_execute_not_double_counted_in_stats(pair):
    _, port = pair
    s = port.session()
    s.execute("PREPARE sq AS SELECT count(*) FROM w")
    s.execute("EXECUTE sq")
    texts = [row[0] for row in
             port.execute("SELECT citus_stat_statements()").rows]
    assert not any(t.startswith("execute sq") for t in texts), texts
    assert any(t == "select count(*) from w" for t in texts), texts


def test_role_is_refused_naming_its_roadmap_item(pair):
    """Roles are ported (A14b): an unknown role is refused with the
    reference's error, a known one runs a statement that reads no
    table, in both packages."""
    outs = []
    for cl in pair:
        got = []
        try:
            cl.execute("SELECT 1", role="alice")
        except Exception as e:  # noqa: BLE001 -- the error is the outcome
            got.append((type(e).__name__, str(e)))
        cl.execute("CREATE ROLE alice")
        got.append(cl.execute("SELECT 1", role="alice").rows)
        cl.execute("DROP ROLE alice")
        outs.append(got)
    assert outs[1] == outs[0]
    assert outs[0] == [("CatalogError", 'role "alice" does not exist'),
                       [(1,)]]
