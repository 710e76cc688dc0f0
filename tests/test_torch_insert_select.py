"""INSERT ... SELECT, RETURNING, sequences and DDL in transactions in
the port, held against the JAX package.

The same statements over the same seeded rows go through
``citus_tpu.Cluster`` and ``citus_tpu_torch.Cluster(device="cpu")``
(tests/torch_write_pair.py): identical rows (floats within rel 1e-12),
identical write counts, ``explain["strategy"]`` and error classes.  The
cases are the SQL of tests/test_insert_select.py (5; its wall-clock
comparison of the colocated and pull rungs is not repeated: both
packages' strategies and rows are), tests/test_breadth2.py's
test_sequences, test_dml_returning and
test_dml_returning_params_and_coercion, the DDL-in-transaction cases of
tests/test_txn_ddl.py (CREATE VIEW, CREATE TYPE, CREATE ROLE and the
maintenance daemon are ROADMAP.md A14 and stay out), and
``chip_smoke.py`` phase 11's INSERT ... SELECT, RETURNING, CREATE TABLE
AS and FK-checked COPY statements at a few thousand rows.
"""

import datetime
import os
import sys

import numpy as np
import pytest

import citus_tpu as ct  # noqa: F401  (flips JAX to 64 bits first)
import citus_tpu_torch as ctt
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
from torch_write_pair import Pair  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ------------------------------------------ tests/test_insert_select.py

@pytest.fixture()
def src(tmp_path):
    p = Pair(tmp_path)
    p.run("CREATE TABLE src (k bigint NOT NULL, v bigint, s text)",
          "SELECT create_distributed_table('src', 'k', 4)",
          ("copy", "src", {"columns": {
              "k": np.arange(10_000, dtype=np.int64),
              "v": np.arange(10_000, dtype=np.int64) * 2,
              "s": [f"w{i % 11}" for i in range(10_000)]}}))
    yield p
    p.close()


def test_colocated_pushdown(src):
    out = src.run("CREATE TABLE dst (k bigint NOT NULL, v bigint, s text)",
                  "SELECT create_distributed_table('dst', 'k', 4, 'src')",
                  "INSERT INTO dst SELECT k, v, s FROM src WHERE v < 10000",
                  "SELECT count(*), sum(v) FROM dst",
                  "SELECT k FROM dst ORDER BY k",
                  "SELECT count(*) FROM dst WHERE s = 'w3'")
    assert out[2][3] == {"inserted": 5000,
                         "strategy": "insert_select:colocated"}


def test_repartition_when_dist_key_changes(src):
    out = src.run("CREATE TABLE byv (k bigint, v bigint NOT NULL)",
                  "SELECT create_distributed_table('byv', 'v', 4)",
                  "INSERT INTO byv SELECT k, v FROM src",
                  "SELECT count(*), sum(k) FROM byv")
    assert out[2][3]["strategy"] == "insert_select:repartition"


def test_repartition_when_expression_feeds_dist_col(src):
    out = src.run("CREATE TABLE dst2 (k bigint NOT NULL, v bigint, s text)",
                  "SELECT create_distributed_table('dst2', 'k', 4, 'src')",
                  "INSERT INTO dst2 SELECT k + 1, v, s FROM src",
                  "SELECT sum(k) FROM dst2")
    assert out[2][3]["strategy"] == "insert_select:repartition"


def test_pull_fallback_for_aggregate_select(src):
    out = src.run("CREATE TABLE agg (k bigint NOT NULL, c bigint)",
                  "SELECT create_distributed_table('agg', 'k', 4)",
                  "INSERT INTO agg SELECT v % 10, count(*) FROM src "
                  "GROUP BY v % 10",
                  "SELECT k, c FROM agg ORDER BY k")
    assert out[2][3]["strategy"] == "insert_select:pull"


def test_colocated_beats_pull_wallclock(src):
    """The statements of the reference's wall-clock test: the colocated
    and the ORDER BY (pull) rung give the same strategy and rows in both
    packages."""
    for i in range(3):
        src.run(f"CREATE TABLE fast{i} (k bigint NOT NULL, v bigint, s text)",
                f"SELECT create_distributed_table('fast{i}', 'k', 4, 'src')",
                f"CREATE TABLE slow{i} (k bigint NOT NULL, v bigint, s text)",
                f"SELECT create_distributed_table('slow{i}', 'k', 4, 'src')")
        out = src.run(f"INSERT INTO fast{i} SELECT k, v, s FROM src",
                      f"INSERT INTO slow{i} SELECT k, v, s FROM src "
                      "ORDER BY k")
        assert out[0][3]["strategy"] == "insert_select:colocated"
        assert out[1][3]["strategy"] == "insert_select:pull"
    src.run("SELECT sum(v) FROM slow0", "SELECT sum(v) FROM fast0",
            "SELECT count(*), sum(v) FROM fast2")


# ------------------------------------------------ tests/test_breadth2.py

def test_sequences(tmp_path):
    p = Pair(tmp_path)
    try:
        out = p.run("CREATE TABLE t (k bigint NOT NULL, g bigint, v bigint, "
                    "s text)",
                    "SELECT create_distributed_table('t', 'k', 4)",
                    "CREATE SEQUENCE ids START 10 INCREMENT 5",
                    "SELECT nextval('ids')", "SELECT nextval('ids')",
                    "SELECT nextval('ids')", "SELECT currval('ids')",
                    "SELECT setval('ids', 100)", "SELECT nextval('ids')",
                    "CREATE TABLE st (id bigint, v bigint)",
                    "INSERT INTO st VALUES (nextval('ids'), 1), "
                    "(nextval('ids'), 2)",
                    "SELECT id FROM st ORDER BY id",
                    "SELECT citus_sequences()")
        assert [o[2] for o in out[3:7]] == [[(10,)], [(15,)], [(20,)],
                                             [(20,)]]
        assert out[11][2] == [(110,), (115,)]
        # a restart never repeats (a block gap is allowed)
        c2 = ctt.Cluster(str(tmp_path / "port" / "db"), device="cpu")
        assert c2.execute("SELECT nextval('ids')").rows[0][0] > 115
        c2.close()
        out = p.run("SELECT nextval('nope')", "DROP SEQUENCE ids",
                    "SELECT nextval('ids')")
        assert out[0] == out[2] == ("error", "CatalogError")
    finally:
        p.close()


def test_dml_returning(tmp_path):
    p = Pair(tmp_path, "ret")
    try:
        out = p.run("CREATE TABLE t (k bigint NOT NULL, v bigint, c text)",
                    "SELECT create_distributed_table('t', 'k', 4)",
                    "INSERT INTO t (k, v, c) VALUES (1, 10, 'a'), "
                    "(2, 20, 'b') RETURNING k, v * 2 AS dbl, c",
                    "INSERT INTO t (k) VALUES (3) RETURNING *",
                    "UPDATE t SET v = v + 5 WHERE k <= 2 RETURNING k, v",
                    "UPDATE t SET c = 'z' WHERE k = 1 RETURNING c, k",
                    "UPDATE t SET v = 0 WHERE k <= 2 RETURNING v",
                    "DELETE FROM t WHERE k = 2 RETURNING *",
                    "SELECT count(*) FROM t")
        assert out[2][1:3] == (["k", "dbl", "c"], [(1, 20, "a"),
                                                   (2, 40, "b")])
        assert out[3][2] == [(3, None, None)]
        assert out[4][3]["updated"] == 2 and out[5][2] == [("z", 1)]
        assert out[7][2] == [(2, 0, "b")] and out[7][3]["deleted"] == 1
    finally:
        p.close()


def test_dml_returning_params_and_coercion(tmp_path):
    p = Pair(tmp_path, "ret2")
    try:
        out = p.run("CREATE TABLE t (k bigint NOT NULL, v bigint, d date)",
                    "SELECT create_distributed_table('t', 'k', 4)",
                    "INSERT INTO t (k, d) VALUES (5, '2020-01-02') "
                    "RETURNING d, t.k",
                    "INSERT INTO t (k, v) VALUES (1, 10), (2, 20)",
                    ("params", "UPDATE t SET v = v + $1 WHERE k = $2 "
                               "RETURNING k, v", [5, 1]),
                    ("params", "DELETE FROM t WHERE k = $1 RETURNING *",
                     [2]))
        assert out[2][2] == [(datetime.date(2020, 1, 2), 5)]
        assert out[4][2] == [(1, 15)]
        assert out[5][2] == [(2, 20, None)] and out[5][3]["deleted"] == 1
    finally:
        p.close()


def test_defaults_serial_and_returning_on_conflict(tmp_path):
    """DEFAULT and serial columns resolved up front (VALUES and INSERT
    ... SELECT), CHECK constraints through INSERT ... SELECT, and the
    refusals of RETURNING with ON CONFLICT and with INSERT ... SELECT."""
    p = Pair(tmp_path, "defaults")
    try:
        out = p.run("CREATE TABLE t (id serial, k bigint NOT NULL, "
                    "v bigint DEFAULT 42, c text DEFAULT 'x', "
                    "CHECK (v < 1000))",
                    "SELECT create_distributed_table('t', 'k', 4)",
                    "INSERT INTO t (k) VALUES (1), (2) RETURNING id, v, c",
                    "INSERT INTO t (k, v) VALUES (3, NULL) RETURNING *",
                    "INSERT INTO t (k, v) VALUES (4, 5000)",
                    "INSERT INTO t (k) VALUES (5) ON CONFLICT (k) "
                    "DO NOTHING RETURNING id",
                    "CREATE TABLE s (k bigint, v bigint)",
                    "INSERT INTO s VALUES (7, 1), (8, 2000)",
                    "INSERT INTO t (k, v) SELECT k, v FROM s WHERE v < 10",
                    "INSERT INTO t (k) SELECT k FROM s RETURNING k",
                    "SELECT id, k, v, c FROM t ORDER BY id")
        assert out[2][2] == [(1, 42, "x"), (2, 42, "x")]
        assert out[4] == ("error", "CheckViolation")
        assert out[5] == out[9] == ("error", "UnsupportedFeatureError")
    finally:
        p.close()


def test_c13_insert_select_arrays_path_checks_constraints(tmp_path):
    """ROADMAP.md C13: the reference's array path of INSERT ... SELECT
    writes a row that fails the target's CHECK (or a leaf partition's
    bounds) without checking it; the port checks each batch, raises the
    CheckViolation that INSERT VALUES raises, and writes nothing."""
    p = Pair(tmp_path, "c13")
    try:
        p.run("CREATE TABLE t (k bigint NOT NULL, v bigint, CHECK (v < 1000))",
              "SELECT create_distributed_table('t', 'k', 4)",
              "CREATE TABLE s (k bigint, v bigint)",
              "INSERT INTO s VALUES (7, 1), (8, 2000)")
        sql = "INSERT INTO t (k, v) SELECT k, v FROM s"
        r = p.ref.execute(sql)
        assert r.explain["strategy"] == "insert_select:repartition"
        assert p.ref.execute("SELECT count(*) FROM t WHERE v >= 1000").rows \
            == [(1,)]
        from citus_tpu_torch.integrity import CheckViolation
        with pytest.raises(CheckViolation):
            p.port.execute(sql)
        assert p.port.execute("SELECT count(*) FROM t").rows == [(0,)]
    finally:
        p.close()


# ------------------------------------- tests/test_txn_ddl.py (DDL in a block)

@pytest.fixture()
def base(tmp_path):
    p = Pair(tmp_path)
    p.run("CREATE TABLE base (k bigint, v bigint)",
          "SELECT create_distributed_table('base', 'k', 4)",
          ("copy", "base", {"rows": [(i, i * 10) for i in range(100)]}))
    yield p
    p.close()


def _seg_files(cl, table, column):
    t = cl.catalog.table(table)
    out = []
    for shard in t.shards:
        for node in shard.placements:
            d = cl.catalog.shard_dir(table, shard.shard_id, node)
            if os.path.isdir(d):
                out += sorted(f for f in os.listdir(d)
                              if f.endswith(f".idx.{column}.npz"))
    return out


def _has(name):
    return ("check", lambda cl: cl.catalog.has_table(name))


def test_create_table_rollback_leaves_no_trace(base):
    out = base.run(("s", "BEGIN"), ("s", "CREATE TABLE t2 (a bigint, b text)"),
                   ("s", "INSERT INTO t2 VALUES (1, 'x'), (2, 'y')"),
                   ("s", "SELECT count(*) FROM t2"), ("s", "ROLLBACK"),
                   _has("t2"), "SELECT count(*) FROM t2")
    assert out[5] == ("value", False) and out[6][0] == "error"


def test_create_distribute_ingest_commit_is_atomic(base, tmp_path):
    base.run(("s", "BEGIN"), ("s", "CREATE TABLE ev (id bigint, "
                                   "amt decimal(8,2))"),
             ("s", "SELECT create_distributed_table('ev', 'id', 4)"),
             ("scopy", "ev", {"rows": [(i, i / 4) for i in range(1000)]}))
    peer = ctt.Cluster(str(tmp_path / "port" / "db"), device="cpu")
    assert not peer.catalog.has_table("ev")
    peer.close()
    base.run(("s", "COMMIT"), "SELECT count(*), sum(amt) FROM ev",
             ("check", lambda cl: (cl.catalog.table("ev").is_distributed,
                                   cl.catalog.table("ev").shard_count)))
    peer2 = ctt.Cluster(str(tmp_path / "port" / "db"), device="cpu")
    assert peer2.execute("SELECT count(*) FROM ev").rows == [(1000,)]
    peer2.close()


def test_drop_table_rollback_keeps_table_and_files(base):
    out = base.run(("s", "BEGIN"), ("s", "DROP TABLE base"), _has("base"),
                   ("s", "ROLLBACK"), _has("base"),
                   "SELECT count(*) FROM base")
    assert out[2] == ("value", False) and out[4] == ("value", True)


def test_drop_table_commit_removes_files(base):
    def data_root(cl):
        return os.path.isdir(os.path.join(cl.catalog.data_dir, "data",
                                          "base"))
    out = base.run(("check", data_root), ("s", "BEGIN"),
                   ("s", "DROP TABLE base"), ("check", data_root),
                   ("s", "COMMIT"), _has("base"), ("check", data_root))
    assert [o[1] for o in (out[0], out[3], out[5], out[6])] \
        == [True, True, False, False]


def test_create_index_rollback_removes_segments(base):
    out = base.run(("s", "BEGIN"), ("s", "CREATE INDEX base_v ON base (v)"),
                   ("check", lambda cl: bool(_seg_files(cl, "base", "v"))),
                   ("s", "ROLLBACK"),
                   ("check", lambda cl: cl.catalog.table("base").indexes),
                   ("check", lambda cl: _seg_files(cl, "base", "v")))
    assert out[2][1] is True and out[4][1] == [] and out[5][1] == []


def test_drop_index_rollback_keeps_segments(base):
    out = base.run("CREATE INDEX base_v ON base (v)", ("s", "BEGIN"),
                   ("s", "DROP INDEX base_v"),
                   ("check", lambda cl: cl.catalog.table("base").indexes),
                   ("check", lambda cl: bool(_seg_files(cl, "base", "v"))),
                   ("s", "ROLLBACK"),
                   ("check", lambda cl: cl.catalog.table("base").indexes),
                   "EXPLAIN SELECT count(*) FROM base WHERE v = 50")
    assert out[3][1] == [] and out[4][1] is True
    assert any("Index Lookup" in r[0] for r in out[7][2])


def test_create_index_commit_enforces_unique(base):
    out = base.run(("s", "BEGIN"),
                   ("s", "CREATE UNIQUE INDEX base_k ON base (k)"),
                   ("s", "COMMIT"), ("copy", "base", {"rows": [(5, 999)]}))
    assert out[3] == ("error", "UniqueViolation")


def test_savepoint_rolls_back_ddl(base):
    out = base.run(("s", "BEGIN"), ("s", "CREATE TABLE a1 (x bigint)"),
                   ("s", "SAVEPOINT sp"), ("s", "CREATE TABLE b1 (y bigint)"),
                   ("s", "CREATE INDEX base_v ON base (v)"), _has("b1"),
                   ("s", "ROLLBACK TO SAVEPOINT sp"), _has("a1"), _has("b1"),
                   ("check", lambda cl: cl.catalog.table("base").indexes),
                   ("check", lambda cl: _seg_files(cl, "base", "v")),
                   ("s", "COMMIT"), _has("a1"), _has("b1"))
    assert [out[i][1] for i in (5, 7, 8, 12, 13)] \
        == [True, True, False, True, False]


def test_catalog_objects_stage_and_rollback(base):
    """Its sequence: staged in the block, gone after ROLLBACK (views,
    types and roles are ROADMAP.md A14)."""
    out = base.run(("s", "BEGIN"), ("s", "CREATE SEQUENCE seq1 START 10"),
                   ("check", lambda cl: "seq1" in cl.catalog.sequences),
                   ("s", "ROLLBACK"),
                   ("check", lambda cl: "seq1" in cl.catalog.sequences))
    assert (out[2][1], out[4][1]) == (True, False)


def test_failed_statement_after_ddl_rolls_back_cleanly(base):
    out = base.run(("s", "BEGIN"), ("s", "CREATE TABLE t3 (a bigint NOT NULL)"),
                   ("s", "INSERT INTO t3 VALUES (NULL)"), ("s", "COMMIT"),
                   _has("t3"))
    assert out[2][0] == "error" and out[4] == ("value", False)


def test_nextval_block_reservation_after_ddl_refused(base):
    out = base.run("CREATE SEQUENCE s1", ("s", "BEGIN"),
                   ("s", "CREATE TABLE t4 (a bigint)"),
                   ("s", "SELECT nextval('s1')"), ("s", "ROLLBACK"),
                   "SELECT nextval('s1')")
    assert out[3] == ("error", "UnsupportedFeatureError")
    assert out[5][2] == [(1,)]


def test_drop_recreate_table_in_txn_keeps_new_data(base):
    out = base.run(("s", "BEGIN"), ("s", "DROP TABLE base"),
                   ("s", "CREATE TABLE base (k bigint, v bigint)"),
                   ("s", "INSERT INTO base VALUES (1, 111)"), ("s", "COMMIT"),
                   "SELECT count(*), sum(v) FROM base")
    assert out[5][2] == [(1, 111)]


def test_drop_recreate_index_same_column_in_txn(base):
    out = base.run("CREATE INDEX base_v ON base (v)", ("s", "BEGIN"),
                   ("s", "DROP INDEX base_v"),
                   ("s", "CREATE INDEX base_v2 ON base (v)"), ("s", "COMMIT"),
                   ("check", lambda cl: bool(_seg_files(cl, "base", "v"))),
                   "EXPLAIN SELECT count(*) FROM base WHERE v = 50",
                   "SELECT count(*) FROM base WHERE v = 500")
    assert out[5][1] is True
    assert any("base_v2" in r[0] for r in out[6][2])


def test_concurrent_autocommit_ddl_blocked_while_staging(base):
    from citus_tpu_torch.utils.filelock import LockTimeout
    cl = base.port
    base.run(("s", "BEGIN"), ("s", "CREATE TABLE staged_t (a bigint)"))
    with pytest.raises(LockTimeout):
        cl.catalog._await_no_staging(timeout=0.2)
    base.step(("s", "ROLLBACK"))
    cl.catalog._await_no_staging(timeout=0.2)
    base.run(_has("staged_t"), "CREATE TABLE other (b bigint)",
             _has("other"))


def test_ddl_commit_is_crash_atomic(base, tmp_path):
    """A session abandoned between stage and COMMIT: a fresh coordinator
    of the port sees nothing (the maintenance daemon's recovery sweep is
    ROADMAP.md A14)."""
    base.run(("s", "BEGIN"), ("s", "CREATE TABLE ghost (a bigint)"),
             ("scopy", "ghost", {"rows": [(1,)]}))
    fresh = ctt.Cluster(str(tmp_path / "port" / "db"), device="cpu")
    assert not fresh.catalog.has_table("ghost")
    fresh.close()


# -------------------------------------- chip_smoke.py phase 11 (c) and (d)

LINEITEM_ROWS = 6000


@pytest.fixture(scope="module")
def li(tmp_path_factory):
    """chip_smoke.py's generated lineitem at LINEITEM_ROWS in both
    packages: -> (the pair, the oracles' integer arrays)."""
    chunks = list(chip_smoke.lineitem_chunks(LINEITEM_ROWS))
    cols = {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}
    p = Pair(tmp_path_factory.mktemp("ph11"))
    p.run(chip_smoke.LINEITEM_DDL,
          "SELECT create_distributed_table('lineitem', 'l_orderkey', 4)",
          ("copy", "lineitem", {"columns": chip_smoke.copy_columns(cols)}))
    yield p, cols
    p.close()


def test_phase11_insert_select_ladder(li):
    """(c): the month's INSERT ... SELECT through the colocated and the
    repartition rungs, the daily pull and its upsert (every n twice the
    count), CREATE TABLE AS of H1 over the month, UPDATE and DELETE ...
    RETURNING of one day: rows equal between the packages and equal to
    chip_smoke.py's numpy oracles."""
    p, cols = li
    june = chip_smoke.month_mask(cols)
    for label, (table, key, sql) in chip_smoke.PH11_INSERTS.items():
        out = p.run(chip_smoke.lineitem_named(table),
                    f"SELECT create_distributed_table('{table}', '{key}', 4)",
                    sql, chip_smoke.PH11_TARGET_CHECK.format(t=table))
        assert out[2][3]["strategy"] == "insert_select:" + label.split()[1]
        assert out[3][2] == chip_smoke.oracle_target(cols, june)
    out = p.run(chip_smoke.DAILY_DDL,
                "SELECT create_distributed_table('daily', 'l_shipdate', 4)",
                chip_smoke.INSERT_DAILY, chip_smoke.DAILY_CHECK)
    assert out[2][3]["strategy"] == "insert_select:pull"
    assert out[3][2] == chip_smoke.oracle_daily(cols)
    # the upsert of a ship day a key: about 2,300 keys, where the
    # reference's conflict probe overflows (ROADMAP.md C4)
    with pytest.raises(RecursionError):
        p.ref.execute(chip_smoke.UPSERT_DAILY)
    r = p.port.execute(chip_smoke.UPSERT_DAILY)
    assert r.explain["strategy"] == "insert_select:upsert_pull"
    assert p.port.execute(chip_smoke.DAILY_CHECK).rows \
        == chip_smoke.oracle_daily(cols, 2)
    p.port.execute("DROP TABLE daily")
    p.ref.execute("DROP TABLE daily")
    out = p.run(chip_smoke.CTAS_H1, chip_smoke.H1_MONTH_CHECK)
    assert out[1][2] == chip_smoke.oracle_h1_month(cols)
    out = p.run(chip_smoke.UPDATE_RETURNING, chip_smoke.DELETE_RETURNING,
                chip_smoke.REINSERT_JUNE_16,
                chip_smoke.PH11_TARGET_CHECK.format(t="li_copy"))
    assert sorted(out[0][2]) == chip_smoke.day_rows(cols, 15, "tax")
    assert sorted(out[1][2]) == chip_smoke.day_rows(cols, 16, "qty")
    assert out[3][2][0][0] == int(june.sum())


def test_phase11_fk_checked_copy(li):
    """(d): orders_ref (PRIMARY KEY, reference table) of the distinct
    order keys, the month's COPY into li_fk (l_orderkey REFERENCES
    orders_ref), a batch with one missing key refused and the table
    unchanged, a DELETE of a referenced parent row refused."""
    p, cols = li
    june = chip_smoke.month_mask(cols)
    keys = np.unique(cols["orderkey"])
    batch = chip_smoke.copy_columns({k: v[june] for k, v in cols.items()})
    bad = {k: (np.concatenate([v[:9], [keys.max() + 5]])
               if k == "l_orderkey" else v[:10]) for k, v in batch.items()}
    out = p.run(chip_smoke.ORDERS_REF_DDL,
                "SELECT create_reference_table('orders_ref')",
                ("copy", "orders_ref", {"columns": {"o_orderkey": keys}}),
                chip_smoke.lineitem_named("li_fk", "orders_ref (o_orderkey)"),
                "SELECT create_distributed_table('li_fk', 'l_orderkey', 4)",
                ("copy", "li_fk", {"columns": batch}),
                chip_smoke.PH11_TARGET_CHECK.format(t="li_fk"),
                ("copy", "li_fk", {"columns": bad}),
                chip_smoke.PH11_TARGET_CHECK.format(t="li_fk"),
                f"DELETE FROM orders_ref WHERE o_orderkey = "
                f"{int(cols['orderkey'][june][0])}")
    assert out[5] == ("copied", int(june.sum()))
    assert out[6][2] == out[8][2] == chip_smoke.oracle_target(cols, june)
    assert out[7] == out[9] == ("error", "ForeignKeyViolation")
