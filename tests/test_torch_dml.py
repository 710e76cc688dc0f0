"""The port's write path (transactions, DML, upserts, change data
capture), held against the JAX package.

The same statements over the same rows go through ``citus_tpu.Cluster``
and ``citus_tpu_torch.Cluster(device="cpu")``, each on its own data
directory with ``citus.enable_change_data_capture`` on: BEGIN / COMMIT /
ROLLBACK and savepoints, UPDATE, DELETE, TRUNCATE, DROP TABLE and
``INSERT ... ON CONFLICT DO NOTHING / DO UPDATE`` with ``excluded.``.
After every step both tables hold identical rows, and the CDC streams
hold identical events (op, columns, rows, counts) in LSN order.  A warm
scalar aggregate served from the device cache returns the new rows
after a DELETE and after a committed transaction.  The port's batched
DO UPDATE (one delete-and-reinsert transaction) gives the rows the
reference's per-row UPDATEs give, and an upsert of 2,000 distinct keys
runs in the port where the reference's conflict probe overflows the
recursion limit (ROADMAP.md C).
"""

import os
import sys

import numpy as np
import pytest

import citus_tpu as ct
import torch

import citus_tpu_torch as ctt
from citus_tpu_torch.errors import UnsupportedFeatureError
from citus_tpu_torch.transaction import InFailedTransaction

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_slice import assert_same_rows  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _fill(cl, n=400):
    cl.execute("SET citus.enable_change_data_capture = on")
    cl.execute("CREATE TABLE t (k bigint NOT NULL, v bigint, p decimal(10,2), "
               "s text, f double)")
    cl.execute("SELECT create_distributed_table('t', 'k', 4)")
    rng = np.random.default_rng(21)
    cl.copy_from("t", columns={
        "k": np.arange(n), "v": rng.integers(0, 20, n),
        "p": rng.integers(0, 100_000, n) / 100.0,
        "s": [f"s{i % 9}" for i in range(n)],
        "f": [None if i % 17 == 0 else float(x) for i, x in
              enumerate(rng.standard_normal(n))]})


@pytest.fixture()
def pair(tmp_path):
    ref = ct.Cluster(str(tmp_path / "ref"))
    port = ctt.Cluster(str(tmp_path / "port"), device="cpu")
    for cl in (ref, port):
        _fill(cl)
    yield ref, port
    port.close()
    ref.close()


def _rows(cl, table="t"):
    return sorted(cl.execute(f"SELECT * FROM {table}").rows,
                  key=lambda r: tuple((x is None, str(x)) for x in r))


def _same(ref, port, table="t"):
    assert_same_rows(_rows(port, table), _rows(ref, table))


def _events(cl, table="t"):
    """The table's CDC stream in LSN order, without the LSNs (each
    package's hybrid logical clock reads its own wall clock)."""
    evs = sorted(cl.cdc.events(table), key=lambda e: e["lsn"])
    return [(e["op"], e.get("columns"), e.get("rows"), e.get("count"))
            for e in evs]


def _both(ref, port, *sqls):
    out = []
    for sql in sqls:
        r, p = ref.execute(sql), port.execute(sql)
        assert_same_rows(p.rows, r.rows)
        out.append((r, p))
    return out


SCRIPTS = {
    "update_delete": [
        "UPDATE t SET v = v + 100, s = 'upd' WHERE k < 30",
        "DELETE FROM t WHERE v = 3 OR p > 900",
        "UPDATE t SET f = f * 2 WHERE f > 0.5",
        "DELETE FROM t WHERE s = 's4'",
    ],
    "commit": [
        "BEGIN",
        "INSERT INTO t VALUES (1000, 1, 1.50, 'new', 0.25)",
        "UPDATE t SET p = p + 1 WHERE k >= 390",
        "DELETE FROM t WHERE k < 10",
        "COMMIT",
    ],
    "rollback": [
        "BEGIN",
        "INSERT INTO t VALUES (1001, 2, 2.50, 'gone', NULL)",
        "DELETE FROM t WHERE k < 200",
        "ROLLBACK",
        "UPDATE t SET v = 0 WHERE k = 5",
    ],
    "savepoint": [
        "BEGIN",
        "DELETE FROM t WHERE k < 5",
        "SAVEPOINT a",
        "DELETE FROM t WHERE k < 100",
        "INSERT INTO t VALUES (1002, 3, 3.50, 'sp', 1.0)",
        "ROLLBACK TO SAVEPOINT a",
        "INSERT INTO t VALUES (1003, 4, 4.50, 'kept', 2.0)",
        "RELEASE SAVEPOINT a",
        "COMMIT",
    ],
    "upsert": [
        "INSERT INTO t VALUES (1, 7, 1.00, 'x', 1.5), (2000, 8, 2.00, 'y', "
        "NULL) ON CONFLICT (k) DO NOTHING",
        "INSERT INTO t (k, v, p, s, f) VALUES (3, 9, 3.00, 'z', 2.5), "
        "(4, 10, 4.00, 'w', 3.5), (2001, 11, 5.00, 'u', 4.5) ON CONFLICT (k) "
        "DO UPDATE SET v = v + excluded.v, f = excluded.f, s = excluded.s",
        "INSERT INTO t VALUES (5, 1, 9.99, 'q', 0.5) ON CONFLICT (k) DO "
        "UPDATE SET p = excluded.p WHERE t.v < 100",
        "INSERT INTO t VALUES (6, 1, 9.99, 'q', 0.5) ON CONFLICT (k) DO "
        "UPDATE SET v = v * 2 + excluded.v",
        "BEGIN",
        "INSERT INTO t VALUES (7, 5, 1.00, 'tx', 1.0) ON CONFLICT (k) DO "
        "UPDATE SET v = v + excluded.v",
        "COMMIT",
    ],
    "truncate_drop": [
        "DELETE FROM t WHERE k > 100",
        "TRUNCATE t",
        "INSERT INTO t VALUES (9, 9, 9.00, 'after', NULL)",
    ],
}


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_write_script_identical_to_reference(pair, name):
    ref, port = pair
    for sql in SCRIPTS[name]:
        r, p = ref.execute(sql), port.execute(sql)
        for key in ("inserted", "updated", "deleted", "skipped"):
            assert p.explain.get(key) == r.explain.get(key), (sql, key)
        if not sql.startswith(("BEGIN", "SAVEPOINT", "RELEASE")):
            _same(ref, port)
    assert _events(port) == _events(ref)
    assert any(op != "insert" for op, *_ in _events(port)) \
        or name == "commit"


def test_drop_table_and_recreate(pair):
    ref, port = pair
    for cl in (ref, port):
        cl.execute("DROP TABLE t")
        cl.execute("DROP TABLE IF EXISTS t")
        with pytest.raises(Exception):
            cl.execute("SELECT count(*) FROM t")
        cl.execute("CREATE TABLE t (k bigint, v bigint)")
        cl.execute("SELECT create_distributed_table('t', 'k', 2)")
        cl.execute("INSERT INTO t VALUES (1, 2), (3, 4)")
    _same(ref, port)
    # a DROP inside a transaction block rolls back with it
    for cl in (ref, port):
        cl.execute("BEGIN")
        cl.execute("DROP TABLE t")
        cl.execute("ROLLBACK")
    _same(ref, port)


def test_failed_statement_aborts_the_block(pair):
    _, port = pair
    port.execute("BEGIN")
    port.execute("DELETE FROM t WHERE k < 50")
    with pytest.raises(Exception):
        port.execute("SELECT no_such_column FROM t")
    with pytest.raises(InFailedTransaction):
        port.execute("SELECT count(*) FROM t")
    r = port.execute("COMMIT")  # COMMIT of an aborted block rolls back
    assert r.explain["transaction"] == "rollback"
    assert port.execute("SELECT count(*) FROM t").rows == [(400,)]
    with pytest.raises(UnsupportedFeatureError):
        port.execute("BEGIN")
        try:
            port.execute("TRUNCATE t")
        finally:
            port.execute("ROLLBACK")


def test_transaction_reads_its_own_writes_and_others_do_not(pair):
    _, port = pair
    s = port.session()
    s.execute("BEGIN")
    s.execute("DELETE FROM t WHERE k < 100")
    assert s.execute("SELECT count(*) FROM t").rows == [(300,)]
    assert port.execute("SELECT count(*) FROM t").rows == [(400,)]
    s.execute("COMMIT")
    assert port.execute("SELECT count(*) FROM t").rows == [(300,)]


WARM = "SELECT count(*), sum(p), max(v), min(f) FROM t WHERE v < 15"


def test_warm_scan_after_writes_reads_the_new_rows(pair):
    """The device cache keys on the table version and flip generation:
    a DELETE, an UPDATE and a committed transaction each bump them, so
    the warm scan never replays batches cached before the write."""
    from citus_tpu_torch.executor.device_cache import GLOBAL_CACHE
    ref, port = pair
    _both(ref, port, WARM)
    h0 = GLOBAL_CACHE.hits
    _both(ref, port, WARM)
    assert GLOBAL_CACHE.hits > h0  # the second run was served warm
    for sql in ("DELETE FROM t WHERE k % 3 = 0",
                "UPDATE t SET v = 1 WHERE k % 5 = 0"):
        for cl in (ref, port):
            cl.execute(sql)
        _both(ref, port, WARM, WARM)
    for cl in (ref, port):
        cl.execute("BEGIN")
        cl.execute("DELETE FROM t WHERE k < 200")
        cl.execute(WARM)  # reads its own staged delete, not the cache
        cl.execute("COMMIT")
    (r, p), = _both(ref, port, WARM)
    assert p.rows[0][0] < 200


def test_batched_upsert_equals_per_row_updates(pair):
    """A DO UPDATE of many rows: the port's one delete-and-reinsert
    transaction gives the rows, counts and CDC events of the
    reference's per-row UPDATE statements; 100 distinct keys also take
    the port's full-scan conflict probe (past its IN-list limit)."""
    ref, port = pair
    rows = ", ".join(f"({k}, {k % 7}, {k}.25, 'b{k % 3}', {k / 8})"
                     for k in range(150, 450, 3))
    sql = (f"INSERT INTO t VALUES {rows} ON CONFLICT (k) DO UPDATE SET "
           "v = v + excluded.v, f = f + excluded.f, p = excluded.p")
    r, p = ref.execute(sql), port.execute(sql)
    assert (p.explain["inserted"], p.explain["updated"]) == \
        (r.explain["inserted"], r.explain["updated"]) == (16, 84)
    _same(ref, port)
    assert _events(port) == _events(ref)


def test_upsert_of_many_keys_runs_where_the_reference_overflows(pair):
    """ROADMAP.md C: the reference's conflict probe binds its IN-list of
    distribution values as one OR chain and overflows Python's
    recursion limit at 2,000 keys; the port scans instead and upserts."""
    ref, port = pair
    rows = ", ".join(f"({k}, 1, 1.00, 'm', 1.0)" for k in range(2000))
    sql = (f"INSERT INTO t VALUES {rows} ON CONFLICT (k) DO UPDATE SET "
           "v = v + excluded.v")
    with pytest.raises(RecursionError):
        ref.execute(sql)
    r = port.execute(sql)
    assert (r.explain["inserted"], r.explain["updated"]) == (1600, 400)
    assert port.execute("SELECT count(*), sum(v) FROM t").rows[0][0] == 2000
