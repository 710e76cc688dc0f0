"""MERGE through the port against the reference.

Each test of tests/test_merge.py, as a differential test: the same
statements over the same rows through ``citus_tpu`` and
``citus_tpu_torch`` (``device="cpu"``), comparing rows, the whole
``explain`` dict of each write and each error's class and message
(``torch_write_pair.Pair(strict=True)``).  Counts and integers are
compared exactly; there is no float column here.  Also: the refusals
the port keeps (foreign keys, non-equi ON, too many WHEN clauses), the
CDC event, and a query cached warm on the device before a MERGE.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_write_pair import Pair  # noqa: E402

UPSERT = ("MERGE INTO tgt t USING src s ON t.id = s.id "
          "WHEN MATCHED THEN UPDATE SET qty = s.qty, s = 'upd' "
          "WHEN NOT MATCHED THEN INSERT (id, qty, s) "
          "VALUES (s.id, s.qty, 'new')")


@pytest.fixture()
def db(tmp_path):
    """tests/test_merge.py's db: tgt 0..9, src 5..14, 2 nodes."""
    p = Pair(tmp_path, strict=True, n_nodes=2)
    p.run("CREATE TABLE tgt (id bigint NOT NULL, qty bigint, s text)",
          "SELECT create_distributed_table('tgt', 'id', 4)",
          "CREATE TABLE src (id bigint NOT NULL, qty bigint)",
          "SELECT create_distributed_table('src', 'id', 4)",
          ("copy", "tgt", {"rows": [(i, i * 10, "old") for i in range(10)]}),
          ("copy", "src", {"rows": [(i, 1000 + i) for i in range(5, 15)]}))
    yield p
    p.close()


def test_merge_update_and_insert(db):
    out = db.run(UPSERT, "SELECT id, qty, s FROM tgt ORDER BY id")
    assert out[0][3] == {"updated": 5, "deleted": 0, "inserted": 5}
    assert len(out[1][2]) == 15
    assert out[1][2][5] == (5, 1005, "upd")
    assert out[1][2][14] == (14, 1014, "new")


def test_merge_delete(db):
    out = db.run("MERGE INTO tgt t USING src s ON t.id = s.id "
                 "WHEN MATCHED AND s.qty > 1007 THEN DELETE",
                 "SELECT count(*) FROM tgt")
    assert out[0][3] == {"updated": 0, "deleted": 2, "inserted": 0}
    assert out[1][2] == [(8,)]


def test_merge_duplicate_source_match_errors(db):
    out = db.run("CREATE TABLE dup (id bigint NOT NULL, v bigint)",
                 "SELECT create_distributed_table('dup', 'id', 2)",
                 ("copy", "dup", {"rows": [(5, 1), (5, 2)]}),
                 "MERGE INTO tgt t USING dup d ON t.id = d.id "
                 "WHEN MATCHED THEN UPDATE SET qty = d.v",
                 "SELECT id, qty, s FROM tgt ORDER BY id")
    assert out[3] == ("error", "ExecutionError",
                      "MERGE command cannot affect the same row a second "
                      "time")
    assert out[4][2] == [(i, i * 10, "old") for i in range(10)]


def test_merge_do_nothing_and_condition(db):
    out = db.run("MERGE INTO tgt t USING src s ON t.id = s.id "
                 "WHEN MATCHED AND s.qty < 1007 THEN UPDATE SET qty = 0 "
                 "WHEN NOT MATCHED THEN DO NOTHING",
                 "SELECT count(*) FROM tgt WHERE qty = 0",
                 "SELECT count(*) FROM tgt")
    assert out[0][3]["updated"] == 2
    assert out[1][2] == [(3,)] and out[2][2] == [(10,)]


def test_merge_text_values_and_conditions(db):
    out = db.run(
        "CREATE TABLE ev (id bigint NOT NULL, tag text, n bigint)",
        "SELECT create_distributed_table('ev', 'id', 4)",
        ("copy", "ev", {"rows": [(1, "hot", 5), (2, "cold", 3),
                                 (3, "hot", 1)]}),
        "CREATE TABLE delta (id bigint NOT NULL, n bigint)",
        "SELECT create_distributed_table('delta', 'id', 4)",
        ("copy", "delta", {"rows": [(1, 10), (3, 30), (9, 90)]}),
        "MERGE INTO ev e USING delta d ON e.id = d.id "
        "WHEN MATCHED AND e.tag = 'hot' THEN UPDATE SET n = d.n, "
        "tag = 'warm' "
        "WHEN NOT MATCHED THEN INSERT (id, tag, n) "
        "VALUES (d.id, 'fresh', d.n)",
        "SELECT id, tag, n FROM ev ORDER BY id")
    assert out[6][3] == {"updated": 2, "deleted": 0, "inserted": 1}
    assert out[7][2] == [(1, "warm", 10), (2, "cold", 3), (3, "warm", 30),
                         (9, "fresh", 90)]


def test_merge_is_one_transaction(db):
    """A fault at the catalog commit of the merge leaves the target
    untouched in both packages (nothing was logged PREPARED)."""
    from citus_tpu.testing.faults import FAULTS as REF_FAULTS
    from citus_tpu.testing.faults import FaultError as RefFault
    from citus_tpu_torch.testing.faults import FAULTS, FaultError
    before = db.step("SELECT count(*), sum(qty) FROM tgt")
    merge = ("MERGE INTO tgt t USING src s ON t.id = s.id "
             "WHEN MATCHED THEN UPDATE SET qty = 0 "
             "WHEN NOT MATCHED THEN INSERT (id, qty, s) "
             "VALUES (s.id, 0, 'x')")
    REF_FAULTS.arm("catalog_commit", error=RefFault("boom"), times=1)
    try:
        with pytest.raises(RefFault):
            db.ref.execute(merge)
    finally:
        REF_FAULTS.disarm()
    FAULTS.arm("catalog_commit", error=FaultError("boom"), times=1)
    try:
        with pytest.raises(FaultError):
            db.port.execute(merge)
    finally:
        FAULTS.disarm()
    db.ref.execute("SELECT recover_prepared_transactions()")
    assert db.step("SELECT count(*), sum(qty) FROM tgt") == before
    # and the table takes the same merge afterwards
    out = db.run(merge, "SELECT count(*), sum(qty) FROM tgt")
    assert out[0][3] == {"updated": 5, "deleted": 0, "inserted": 5}
    assert out[1][2] == [(15, 100)]


def test_merge_insert_only(db):
    out = db.run("DELETE FROM tgt WHERE id >= 5",
                 "MERGE INTO tgt t USING src s ON t.id = s.id "
                 "WHEN NOT MATCHED THEN INSERT (id, qty, s) "
                 "VALUES (s.id, s.qty, 'ins')",
                 "SELECT count(*) FROM tgt")
    assert out[1][3] == {"updated": 0, "deleted": 0, "inserted": 10}
    assert out[2][2] == [(15,)]


def test_merge_respects_unique_index(tmp_path):
    p = Pair(tmp_path, strict=True)
    try:
        out = p.run(
            "CREATE TABLE tgt (k bigint PRIMARY KEY, v bigint)",
            "CREATE TABLE src (k bigint, v bigint)",
            ("copy", "tgt", {"rows": [(1, 10), (2, 20)]}),
            ("copy", "src", {"rows": [(1, 11), (3, 30)]}),
            "MERGE INTO tgt t USING src s ON t.k = s.k "
            "WHEN MATCHED THEN UPDATE SET v = s.v "
            "WHEN NOT MATCHED THEN INSERT (k, v) VALUES (s.k, s.v)",
            "SELECT k, v FROM tgt ORDER BY k",
            "CREATE TABLE src2 (k bigint, v bigint)",
            ("copy", "src2", {"rows": [(9, 90)]}),
            "MERGE INTO tgt t USING src2 s ON t.k = s.k + 1000 "
            "WHEN NOT MATCHED THEN INSERT (k, v) VALUES (2, s.v)",
            "SELECT k, v FROM tgt ORDER BY k")
    finally:
        p.close()
    assert out[4][3] == {"updated": 1, "deleted": 0, "inserted": 1}
    assert out[5][2] == [(1, 11), (2, 20), (3, 30)]
    assert out[8][:2] == ("error", "UniqueViolation")
    assert out[9][2] == [(1, 11), (2, 20), (3, 30)]


def test_merge_text_insert_remaps_dictionaries(tmp_path):
    p = Pair(tmp_path, strict=True)
    try:
        out = p.run(
            "CREATE TABLE tgt (k bigint, name text)",
            "CREATE TABLE src (k bigint, name text)",
            ("copy", "tgt", {"rows": [(1, "alice")]}),
            ("copy", "src", {"rows": [(2, "bob"), (3, "alice")]}),
            "MERGE INTO tgt t USING src s ON t.k = s.k "
            "WHEN NOT MATCHED THEN INSERT (k, name) VALUES (s.k, s.name)",
            "SELECT k, name FROM tgt ORDER BY k",
            "MERGE INTO tgt t USING src s ON t.k = s.k "
            "WHEN MATCHED THEN UPDATE SET name = s.name",
            "SELECT k, name FROM tgt ORDER BY k",
            "MERGE INTO tgt t USING src s ON t.k = s.k "
            "WHEN MATCHED THEN UPDATE SET name = upper(s.name)")
    finally:
        p.close()
    assert out[5][2] == [(1, "alice"), (2, "bob"), (3, "alice")]
    assert out[7][2] == out[5][2]
    assert out[8][:2] == ("error", "UnsupportedFeatureError")


def test_merge_text_unique_and_on_keys_fail_closed(tmp_path):
    p = Pair(tmp_path, strict=True)
    try:
        out = p.run(
            "CREATE TABLE tgt (name text PRIMARY KEY, v bigint)",
            "CREATE TABLE src (name text, v bigint)",
            ("copy", "tgt", {"rows": [("alice", 1)]}),
            ("copy", "src", {"rows": [("zed", 2), ("alice", 3)]}),
            "MERGE INTO tgt t USING src s ON t.name = s.name "
            "WHEN MATCHED THEN UPDATE SET v = s.v",
            "MERGE INTO tgt t USING src s ON t.v = s.v "
            "WHEN NOT MATCHED THEN INSERT (name, v) VALUES (s.name, s.v)",
            "SELECT count(*) FROM tgt")
    finally:
        p.close()
    assert out[4] == ("error", "UnsupportedFeatureError",
                      "MERGE ON text join keys is not supported yet")
    assert out[5][:2] == ("error", "UniqueViolation")
    assert out[6][2] == [(1,)]


@pytest.mark.parametrize("sql", [
    # a residual ON conjunct that is not an equality
    "MERGE INTO tgt t USING src s ON t.id = s.id AND t.qty < s.qty "
    "WHEN MATCHED THEN DELETE",
    # no equality at all
    "MERGE INTO tgt t USING src s ON t.id < s.id WHEN MATCHED THEN DELETE",
    # two clauses of one kind
    "MERGE INTO tgt t USING src s ON t.id = s.id "
    "WHEN MATCHED AND s.qty > 1 THEN DELETE "
    "WHEN MATCHED THEN UPDATE SET qty = 0",
    # INSERT with more values than columns
    "MERGE INTO tgt t USING src s ON t.id = s.id "
    "WHEN NOT MATCHED THEN INSERT (id) VALUES (s.id, s.qty)",
])
def test_merge_refusals_match(db, sql):
    out = db.run(sql, "SELECT id, qty, s FROM tgt ORDER BY id")
    assert out[0][0] == "error"
    assert out[1][2] == [(i, i * 10, "old") for i in range(10)]


def test_merge_on_a_table_with_foreign_keys_is_refused(tmp_path):
    p = Pair(tmp_path, strict=True)
    try:
        out = p.run(
            "CREATE TABLE par (k bigint NOT NULL, v bigint)",
            "SELECT create_reference_table('par')",
            "CREATE INDEX par_k ON par (k)",
            "CREATE UNIQUE INDEX par_uk ON par (k)",
            "CREATE TABLE ch (i bigint NOT NULL, k bigint REFERENCES par (k))",
            ("copy", "par", {"rows": [(1, 1), (2, 2)]}),
            "CREATE TABLE s2 (k bigint, v bigint)",
            ("copy", "s2", {"rows": [(1, 5)]}),
            "MERGE INTO par t USING s2 s ON t.k = s.k "
            "WHEN MATCHED THEN UPDATE SET v = s.v",
            "MERGE INTO ch t USING s2 s ON t.i = s.k "
            "WHEN MATCHED THEN DELETE")
    finally:
        p.close()
    assert out[8] == ("error", "UnsupportedFeatureError",
                      "MERGE on tables with foreign key constraints is not "
                      "supported")
    assert out[9] == out[8]


def test_merge_emits_one_cdc_event(tmp_path):
    p = Pair(tmp_path, strict=True)
    try:
        p.run("CREATE TABLE tgt (id bigint NOT NULL, qty bigint)",
              "CREATE TABLE src (id bigint NOT NULL, qty bigint)",
              ("copy", "tgt", {"rows": [(1, 1), (2, 2)]}),
              ("copy", "src", {"rows": [(2, 20), (3, 30)]}))
        for cl in (p.ref, p.port):
            cl.cdc.enabled = True
        p.step("MERGE INTO tgt t USING src s ON t.id = s.id "
               "WHEN MATCHED THEN UPDATE SET qty = s.qty "
               "WHEN NOT MATCHED THEN INSERT (id, qty) VALUES (s.id, s.qty)")
        events = [[(e["table"], e["op"], e.get("count"))
                   for e in cl.cdc.events("tgt")] for cl in (p.ref, p.port)]
    finally:
        p.close()
    assert events[0] == events[1] == [("tgt", "merge", 2)]


def test_warm_device_query_sees_the_merge(db):
    """The port's gpu backend on the CPU keeps batches in the same
    device cache as on the card: a query cached warm before the MERGE
    returns the merged rows after it."""
    from citus_tpu_torch.executor.executor import GLOBAL_COUNTERS
    q = "SELECT s, count(*), sum(qty) FROM tgt GROUP BY s ORDER BY s"
    db.run(q, q)
    hits = GLOBAL_COUNTERS.snapshot().get("device_cache_hits", 0)
    db.step(q)
    assert GLOBAL_COUNTERS.snapshot().get("device_cache_hits", 0) > hits
    out = db.run(UPSERT, q, q)
    assert out[1][2] == [("new", 5, 5060), ("old", 5, 100),
                         ("upd", 5, 5035)]


def test_phase12_statements_match_the_reference(tmp_path):
    """chip_smoke.py phase 12's statements over 3,000 of its orders
    (value ranges of SF1's 1,500,303), through both packages: the `|`
    load, the exports, the MERGEs of the staging tables, the ALTERs,
    the redistributions, statistics and REINDEX."""
    import numpy as np
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs
    n_orders = cs.SF1_ROWS // 4
    state = cs.ph12_orders(n_orders, 3_000)
    stage = cs.ph12_staging(state, n_orders, updates=300, rf1=30, rf2=30)
    tbl = tmp_path / "orders.tbl"
    tbl.write_text("\n".join(cs.ph12_lines(state, "|")) + "\n")
    checks = [q.format(t="orders_m", f="o_flag")
              for q in cs.PH12_CHECKS.values()]
    p = Pair(tmp_path, strict=True)
    files = {id(p.ref): tmp_path / "ref_out", id(p.port): tmp_path / "port_out"}
    for d in files.values():
        d.mkdir()

    def to_file(sql):
        return ("check", lambda cl: (
            cl.execute(sql.format(d=files[id(cl)])).explain,
            sorted((files[id(cl)] / "out").read_text().splitlines())))
    try:
        out = p.run(
            cs.ORDERS_M_DDL.format(t="orders_m"),
            "SELECT create_distributed_table('orders_m', 'o_orderkey', 4)",
            f"COPY orders_m FROM '{tbl}' WITH (delimiter '|')",
            *checks,
            to_file("COPY orders_m TO '{d}/out'"),
            to_file("COPY (SELECT o_flag, count(*) FROM orders_m GROUP BY "
                    "o_flag) TO '{d}/out'"),
            "CREATE STATISTICS st_cust_flag ON o_custkey, o_flag "
            "FROM orders_m",
            ("check", lambda cl: cl.catalog.statistics["st_cust_flag"]
             ["ndistinct"]),
            cs.ORDERS_M_DDL.format(t="orders_delta").replace(
                " PRIMARY KEY", " NOT NULL"),
            "SELECT create_distributed_table('orders_delta', 'o_orderkey', 4)",
            ("copy", "orders_delta",
             {"columns": cs.ph12_columns(stage["delta"])}),
            "CREATE TABLE orders_rf2 (o_orderkey bigint NOT NULL)",
            ("copy", "orders_rf2", {"columns": {"o_orderkey": stage["rf2"]}}),
            "CREATE TABLE orders_dup (o_orderkey bigint NOT NULL, "
            "o_custkey bigint)",
            ("copy", "orders_dup", {"columns": {
                "o_orderkey": stage["dup"], "o_custkey": np.zeros(2, int)}}),
            cs.PH12_MERGE, cs.PH12_MERGE, *checks,
            cs.PH12_MERGE_RF2, cs.PH12_MERGE_DUP, *checks,
            "ANALYZE orders_m",
            cs.PH12_CHECK_OK, cs.PH12_CHECK_BAD,
            "ALTER TABLE orders_m ADD COLUMN o_comment text",
            "ALTER TABLE orders_m RENAME COLUMN o_flag TO o_status",
            "SELECT o_status, count(*) FROM orders_m GROUP BY o_status "
            "ORDER BY o_status",
            "ALTER TABLE orders_m RENAME COLUMN o_status TO o_flag",
            "ALTER TABLE orders_m DROP COLUMN o_comment",
            "SELECT alter_distributed_table('orders_m', 8)", *checks,
            "CREATE INDEX ix_cust ON orders_m (o_custkey)",
            cs.PH12_LOOKUP.format(k=int(state["cust"][0])),
            "REINDEX TABLE orders_m",
            cs.PH12_LOOKUP.format(k=int(state["cust"][0])))
    finally:
        p.close()
    assert out[2][3] == {"copied": 3_000}
    assert out[5][1][0] == {"copied": 3_000}
    assert out[8] == ("value", cs.ph12_ndistinct(state))
    merged = cs.ph12_merge_state(state, stage["delta"])
    assert out[16][3] == {"updated": 300, "deleted": 0, "inserted": 30}
    assert out[17][3] == {"updated": 330, "deleted": 0, "inserted": 0}
    assert [out[18][2][0]] + out[19][2] == cs.ph12_want(merged)
    assert out[20][3] == {"updated": 0, "deleted": 30, "inserted": 0}
    assert out[21][:2] == ("error", "ExecutionError")
