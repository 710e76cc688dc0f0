"""Constraints in the port, held against the JAX package.

The same statements over the same seeded rows go through
``citus_tpu.Cluster`` and ``citus_tpu_torch.Cluster(device="cpu")``
(tests/torch_write_pair.py): identical rows (floats within rel 1e-12),
identical write counts and error classes.  The cases are the SQL of
tests/test_foreign_keys.py (20) and tests/test_index.py (21), the
reference fault ROADMAP.md C12 (its FK probe overflows the recursion
limit; the port answers), and data directories that each package wrote
with partitions, foreign keys, unique indexes, CHECKs and sequences,
opened, queried and written by the other; ALTER TABLE's renames and
DROP COLUMN carry the FK edges and index segments in both.
"""

import os
import sys

import numpy as np
import pytest

import citus_tpu as ct  # noqa: F401  (flips JAX to 64 bits first)
import citus_tpu_torch as ctt
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_write_pair import Pair  # noqa: E402

from citus_tpu_torch.integrity import ForeignKeyViolation  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ------------------------------------------ tests/test_foreign_keys.py

@pytest.fixture()
def fk(tmp_path):
    p = Pair(tmp_path)
    p.run("CREATE TABLE customers (cid bigint NOT NULL, name text)",
          "CREATE TABLE orders (oid bigint NOT NULL, "
          "cid bigint REFERENCES customers (cid), amt bigint)",
          "SELECT create_distributed_table('customers','cid',4)",
          "SELECT create_distributed_table('orders','cid',4)",
          "INSERT INTO customers VALUES (1,'a'), (2,'b'), (3,'c')",
          "INSERT INTO orders VALUES (10,1,100), (11,2,200)")
    yield p
    p.close()


@pytest.fixture()
def pair(tmp_path):
    p = Pair(tmp_path, "d")
    yield p
    p.close()


def test_distribution_must_cover_fk_key(pair):
    out = pair.run("CREATE TABLE p (k bigint NOT NULL)",
                   "CREATE TABLE f (i bigint NOT NULL, "
                   "k bigint REFERENCES p (k))",
                   "SELECT create_distributed_table('p','k',4)",
                   "SELECT create_distributed_table('f','i',4)",
                   "SELECT create_distributed_table('f','k',4)")
    assert out[3] == ("error", "AnalysisError")


def test_colocation_required(pair):
    out = pair.run("CREATE TABLE p (k bigint NOT NULL)",
                   "CREATE TABLE f (k bigint NOT NULL REFERENCES p (k))",
                   "SELECT create_distributed_table('p','k',4)",
                   "SELECT create_distributed_table('f','k',8)")
    assert out[3] == ("error", "AnalysisError")


def test_reference_to_distributed_rejected(pair):
    out = pair.run("CREATE TABLE p (k bigint NOT NULL)",
                   "CREATE TABLE f (k bigint NOT NULL REFERENCES p (k))",
                   "SELECT create_distributed_table('p','k',4)",
                   "SELECT create_reference_table('f')")
    assert out[3] == ("error", "AnalysisError")


def test_unknown_parent_and_columns(pair):
    out = pair.run("CREATE TABLE f (k bigint REFERENCES nope (k))",
                   "CREATE TABLE p (k bigint NOT NULL)",
                   "CREATE TABLE f (k bigint REFERENCES p (missing))",
                   "CREATE TABLE f (k text REFERENCES p (k))",
                   ("check", lambda cl: cl.catalog.has_table("f")))
    assert [o[0] for o in out] == ["error", "rows", "error", "error",
                                   "value"]


def test_anything_may_reference_reference_table(pair):
    out = pair.run("CREATE TABLE dims (d bigint NOT NULL, label text)",
                   "SELECT create_reference_table('dims')",
                   "CREATE TABLE facts (i bigint NOT NULL, d bigint "
                   "REFERENCES dims (d))",
                   "SELECT create_distributed_table('facts','i',4)",
                   "INSERT INTO dims VALUES (1,'x')",
                   "INSERT INTO facts VALUES (1, 1)",
                   "INSERT INTO facts VALUES (2, 9)",
                   "SELECT * FROM facts")
    assert out[6] == ("error", "ForeignKeyViolation")


def test_insert_violation_and_null(fk):
    out = fk.run("INSERT INTO orders VALUES (12, 99, 1)",
                 "INSERT INTO orders VALUES (13, NULL, 1)",
                 "SELECT count(*) FROM orders")
    assert out[0] == ("error", "ForeignKeyViolation")
    assert out[2][2] == [(3,)]


def test_copy_from_batch_violation(fk):
    out = fk.run(("copy", "orders", {"rows": [(20, 1, 5), (21, 42, 5)]}),
                 "SELECT count(*) FROM orders")
    assert out[0] == ("error", "ForeignKeyViolation")
    assert out[1][2] == [(2,)]


def test_delete_restrict_and_allowed(fk):
    out = fk.run("DELETE FROM customers WHERE cid = 1",
                 "DELETE FROM customers WHERE cid = 3",
                 "SELECT count(*) FROM customers")
    assert out[0] == ("error", "ForeignKeyViolation")


def test_delete_cascade_recursive(pair):
    pair.run("CREATE TABLE a (k bigint NOT NULL)",
             "CREATE TABLE b (k bigint NOT NULL "
             "REFERENCES a (k) ON DELETE CASCADE)",
             "CREATE TABLE cc (k bigint NOT NULL "
             "REFERENCES b (k) ON DELETE CASCADE)",
             "SELECT create_distributed_table('a','k',2)",
             "SELECT create_distributed_table('b','k',2)",
             "SELECT create_distributed_table('cc','k',2)",
             "INSERT INTO a VALUES (1), (2)",
             "INSERT INTO b VALUES (1), (2)",
             "INSERT INTO cc VALUES (1), (2)",
             "DELETE FROM a WHERE k = 1",
             "SELECT k FROM b", "SELECT k FROM cc")


def test_delete_set_null(pair):
    out = pair.run("CREATE TABLE r (k bigint NOT NULL)",
                   "SELECT create_reference_table('r')",
                   "CREATE TABLE s (i bigint NOT NULL, k bigint "
                   "REFERENCES r (k) ON DELETE SET NULL)",
                   "SELECT create_distributed_table('s','i',2)",
                   "INSERT INTO r VALUES (1), (2)",
                   "INSERT INTO s VALUES (1, 1), (2, 2)",
                   "DELETE FROM r WHERE k = 1",
                   "SELECT i, k FROM s ORDER BY i")
    assert out[-1][2] == [(1, None), (2, 2)]


def test_parent_key_update_restricted(fk):
    out = fk.run("UPDATE customers SET cid = 77 WHERE cid = 1",
                 "UPDATE customers SET name = 'z' WHERE cid = 1",
                 "SELECT cid, name FROM customers ORDER BY cid")
    assert out[0] == ("error", "ForeignKeyViolation")


def test_child_fk_update_checked(fk):
    out = fk.run("UPDATE orders SET cid = 42 WHERE oid = 10",
                 "UPDATE orders SET cid = 3 WHERE oid = 10",
                 "SELECT cid FROM orders WHERE oid = 10",
                 "UPDATE orders SET cid = cid + 1 WHERE oid = 10")
    assert out[0] == ("error", "ForeignKeyViolation")
    assert out[3] == ("error", "UnsupportedFeatureError")


def test_truncate_and_drop_blocked(fk):
    out = fk.run("TRUNCATE customers", "DROP TABLE customers",
                 "DROP TABLE orders", "DROP TABLE customers",
                 ("check", lambda cl: sorted(cl.catalog.tables)))
    assert out[:2] == [("error", "AnalysisError")] * 2


def test_upsert_respects_fk(fk):
    out = fk.run("INSERT INTO orders VALUES (30, 77, 1) "
                 "ON CONFLICT (oid, cid) DO NOTHING",
                 "SELECT count(*) FROM orders")
    assert out[0] == ("error", "ForeignKeyViolation")


def test_insert_select_respects_fk(fk):
    out = fk.run("CREATE TABLE src (oid bigint NOT NULL, cid bigint, "
                 "amt bigint)",
                 "SELECT create_distributed_table('src','cid',4)",
                 "INSERT INTO src VALUES (50, 1, 7), (51, 42, 7)",
                 "INSERT INTO orders SELECT oid, cid, amt FROM src",
                 "SELECT count(*) FROM orders",
                 "DELETE FROM src WHERE cid = 42",
                 "INSERT INTO orders SELECT oid, cid, amt FROM src",
                 "SELECT oid, cid, amt FROM orders ORDER BY oid")
    assert out[3] == ("error", "ForeignKeyViolation")
    assert out[6][3]["strategy"] == "insert_select:pull"


def test_merge_fails_closed_on_fk_tables(fk):
    out = fk.run("CREATE TABLE stage (oid bigint NOT NULL, cid bigint, "
                 "amt bigint)",
                 "SELECT create_distributed_table('stage','cid',4)",
                 "MERGE INTO orders o USING stage s ON o.oid = s.oid "
                 "WHEN NOT MATCHED THEN INSERT VALUES (s.oid, s.cid, "
                 "s.amt)")
    assert out[2] == ("error", "UnsupportedFeatureError")


def test_cross_kind_numeric_fk(pair):
    out = pair.run("CREATE TABLE p (k decimal(8,2) NOT NULL)",
                   "CREATE TABLE f (i bigint NOT NULL, k double "
                   "REFERENCES p (k))",
                   "INSERT INTO p VALUES (5.00)",
                   "INSERT INTO f VALUES (1, 5.0)",
                   "INSERT INTO f VALUES (2, 6.0)",
                   "SELECT i, k FROM f")
    assert out[4] == ("error", "ForeignKeyViolation")


def test_if_not_exists_does_not_clobber_fks(fk):
    out = fk.run("CREATE TABLE IF NOT EXISTS orders (zzz bigint "
                 "REFERENCES customers (cid))",
                 ("check", lambda cl: cl.catalog.table("orders")
                  .foreign_keys),
                 "DELETE FROM customers WHERE cid = 1")
    assert out[1][1][0]["columns"] == ["cid"]
    assert out[2] == ("error", "ForeignKeyViolation")


def test_rename_keeps_fk_edges(fk):
    """RENAME TO repoints the children's FK edges at the new name."""
    out = fk.run("ALTER TABLE customers RENAME TO clients",
                 ("check", lambda cl: [f["ref_table"] for f in
                                       cl.catalog.table("orders")
                                       .foreign_keys]),
                 "DELETE FROM clients WHERE cid = 1",
                 "INSERT INTO orders VALUES (61, 3, 1)",
                 "INSERT INTO orders VALUES (62, 99, 1)",
                 "SELECT count(*) FROM customers")
    assert out[1] == ("value", ["clients"])
    assert out[2] == ("error", "ForeignKeyViolation")
    assert out[4] == ("error", "ForeignKeyViolation")
    assert out[5][0] == "error"


def test_fk_survives_catalog_reload(fk, tmp_path):
    """A second coordinator of the port on the same data directory sees
    the constraint."""
    c2 = ctt.Cluster(str(tmp_path / "port" / "db"), device="cpu")
    try:
        with pytest.raises(ForeignKeyViolation):
            c2.execute("INSERT INTO orders VALUES (31, 88, 1)")
    finally:
        c2.close()


def test_c12_fk_probe_of_many_keys_answers_where_the_reference_overflows(
        tmp_path):
    """ROADMAP.md C12: the reference probes a parent with IN-lists of up
    to 1,000 keys, one left-deep OR chain each, and raises RecursionError
    from about 500 distinct keys.  A reference table p (k bigint PRIMARY
    KEY), a distributed child c (k REFERENCES p(k)), one copy_from of n
    rows, each with its own key (seed 12).  At 300 keys both packages
    load and give identical rows; at 2,000 the reference raises and the
    port loads every row, and a batch with one missing key raises the
    reference's ForeignKeyViolation message."""
    rng = np.random.default_rng(12)
    keys = rng.permutation(10_000)[:2_000].astype(np.int64)
    p = Pair(tmp_path)
    try:
        p.run("CREATE TABLE p (k bigint PRIMARY KEY)",
              "SELECT create_reference_table('p')",
              ("copy", "p", {"columns": {"k": keys}}),
              "CREATE TABLE c (i bigint NOT NULL, k bigint REFERENCES "
              "p (k))",
              "SELECT create_distributed_table('c', 'i', 4)")
        small = {"i": np.arange(300), "k": keys[:300]}
        p.run(("copy", "c", {"columns": small}),
              "SELECT i, k FROM c ORDER BY i",
              "TRUNCATE c")
        many = {"i": np.arange(2_000), "k": keys}
        with pytest.raises(RecursionError):
            p.ref.copy_from("c", columns=many)
        assert p.port.copy_from("c", columns=many) == 2_000
        assert p.port.execute("SELECT count(*), sum(k) FROM c").rows \
            == [(2_000, int(keys.sum()))]
        bad = {"i": np.arange(2_000, 2_400),
               "k": np.concatenate([keys[:399], [10_007]])}
        with pytest.raises(ForeignKeyViolation) as e:
            p.port.copy_from("c", columns=bad)
        assert str(e.value) == (
            'insert or update on table "c" violates foreign key '
            'constraint "c_fk_1": Key (k)=(10007) is not present in table '
            '"p"')
        # the reference's message at a size it answers
        small_bad = {"i": np.arange(3), "k": np.array([keys[0], 10_007,
                                                       keys[1]])}
        out = p.step(("copy", "c", {"columns": small_bad}))
        assert out == ("error", "ForeignKeyViolation")
        msgs = []
        for cl in (p.ref, p.port):
            try:
                cl.copy_from("c", columns=small_bad)
            except Exception as exc:  # noqa: BLE001 -- compared below
                msgs.append(str(exc))
        assert msgs[0] == msgs[1]
        assert p.port.execute("SELECT count(*) FROM c").rows == [(2_000,)]
    finally:
        p.close()


# ----------------------------------------------- tests/test_index.py

ITEM_ROWS = [(i, i % 7, f"label-{i % 50}", i * 1.25) for i in range(5000)]


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


@pytest.fixture()
def db(tmp_path):
    p = Pair(tmp_path)
    p.run("CREATE TABLE items (id bigint NOT NULL, grp bigint, label text, "
          "price decimal(10,2))",
          "SELECT create_distributed_table('items', 'id', 4)",
          ("copy", "items", {"rows": ITEM_ROWS}))
    yield p
    p.close()


def _indexes(cl):
    return cl.catalog.table("items").indexes


def test_create_index_backfills_existing_stripes(db):
    out = db.run("CREATE INDEX items_grp_idx ON items (grp)",
                 ("check", _indexes),
                 ("check", lambda cl: _seg_files(cl, "items", "grp")))
    assert out[2][1]


def test_new_ingest_builds_segments_without_backfill(db):
    out = db.run("CREATE INDEX items_grp_idx ON items (grp)",
                 ("check", lambda cl: len(_seg_files(cl, "items", "grp"))),
                 ("copy", "items", {"rows": [(9001, 3, "x", 1.0)]}),
                 ("check", lambda cl: len(_seg_files(cl, "items", "grp"))))
    assert out[3][1] > out[1][1]


def test_drop_index_removes_segments_and_metadata(db):
    out = db.run("CREATE INDEX items_grp_idx ON items (grp)",
                 "DROP INDEX items_grp_idx", ("check", _indexes),
                 ("check", lambda cl: _seg_files(cl, "items", "grp")),
                 "SELECT count(*) FROM items WHERE grp = 3")
    assert out[3][1] == []


def test_index_name_collision_and_if_not_exists(db):
    out = db.run("CREATE INDEX ix ON items (grp)",
                 "CREATE INDEX ix ON items (price)",
                 "CREATE INDEX IF NOT EXISTS ix ON items (grp)",
                 "CREATE INDEX ix2 ON items (grp)",
                 "DROP INDEX nope", "DROP INDEX IF EXISTS nope")
    assert [o[0] for o in out] == ["rows", "error", "rows", "error",
                                   "error", "rows"]


def test_point_query_uses_index_and_prunes_chunks(db):
    from citus_tpu_torch.executor.executor import GLOBAL_COUNTERS
    db.step("CREATE INDEX items_grp_idx ON items (grp)")
    GLOBAL_COUNTERS.reset()
    db.step("SELECT count(*) FROM items WHERE grp = 5")
    assert GLOBAL_COUNTERS.snapshot().get("index_lookups", 0) > 0


def test_explain_shows_index_path(db):
    out = db.run("CREATE INDEX items_grp_idx ON items (grp)",
                 "EXPLAIN SELECT sum(price) FROM items WHERE grp = 2")
    assert ("  Index Lookup: grp = 2 using items_grp_idx",) in out[1][2]


def test_index_lookup_matches_scan_results(db):
    queries = [
        "SELECT count(*), sum(price), min(id), max(id) FROM items "
        "WHERE grp = 4",
        "SELECT id, price FROM items WHERE grp = 6 ORDER BY id LIMIT 20",
        "SELECT count(*) FROM items WHERE label = 'label-17'",
        "SELECT grp, count(*) FROM items WHERE grp = 1 GROUP BY grp",
    ]
    before = db.run(*queries)
    db.run("CREATE INDEX ix_grp ON items (grp)",
           "CREATE INDEX ix_label ON items (label)")
    assert db.run(*queries) == before


def test_index_lookup_respects_deletes(db):
    db.run("CREATE INDEX ix_grp ON items (grp)",
           "SELECT count(*) FROM items WHERE grp = 2",
           "DELETE FROM items WHERE grp = 2 AND id < 1000",
           "SELECT count(*) FROM items WHERE grp = 2")


def test_index_survives_vacuum_rewrite(db):
    out = db.run("CREATE INDEX ix_grp ON items (grp)",
                 "DELETE FROM items WHERE grp = 0", "VACUUM items",
                 ("check", lambda cl: bool(_seg_files(cl, "items", "grp"))),
                 "SELECT count(*) FROM items WHERE grp = 3")
    assert out[3][1] is True


def test_rename_column_carries_index(db):
    """RENAME COLUMN renames the index's segment files in place."""
    out = db.run("CREATE INDEX ix_grp ON items (grp)",
                 ("check", lambda cl: len(_seg_files(cl, "items", "grp"))),
                 "ALTER TABLE items RENAME COLUMN grp TO bucket",
                 ("check", lambda cl: (
                     len(_seg_files(cl, "items", "bucket")),
                     _seg_files(cl, "items", "grp"),
                     cl.catalog.table("items").index_on("bucket")["name"])),
                 "SELECT count(*) FROM items WHERE bucket = 3",
                 "SELECT count(*) FROM items WHERE grp = 3")
    assert out[1][1] > 0
    assert out[3] == ("value", (out[1][1], [], "ix_grp"))
    assert out[5][0] == "error"


def test_drop_column_drops_index(db):
    """DROP COLUMN drops the column's index and its segment files."""
    out = db.run("CREATE INDEX ix_grp ON items (grp)",
                 "ALTER TABLE items DROP COLUMN grp",
                 ("check", lambda cl: (_seg_files(cl, "items", "grp"),
                                       cl.catalog.table("items").indexes)),
                 "SELECT count(*), sum(price) FROM items")
    assert out[2] == ("value", ([], []))


def test_unique_index_rejects_duplicate_ingest(db):
    out = db.run("CREATE UNIQUE INDEX items_id_key ON items (id)",
                 ("copy", "items", {"rows": [(17, 0, "dup", 1.0)]}),
                 ("copy", "items", {"rows": [(90001, 0, "a", 1.0),
                                             (90001, 1, "b", 2.0)]}),
                 ("copy", "items", {"rows": [(90002, 0, "ok", 1.0)]}))
    assert out[1:] == [("error", "UniqueViolation"),
                       ("error", "UniqueViolation"), ("copied", 1)]


def test_unique_on_non_distribution_column(db):
    out = db.run("CREATE UNIQUE INDEX items_price_key ON items (price)",
                 ("copy", "items", {"rows": [(80001, 0, "x", 100 * 1.25)]}))
    assert out[1] == ("error", "UniqueViolation")


def test_unique_backfill_validates_existing_data(db):
    out = db.run(("copy", "items", {"rows": [(70001, 0, "dup-grp", 1.0),
                                             (70002, 0, "dup-grp", 2.0)]}),
                 "CREATE UNIQUE INDEX ix_label ON items (label)",
                 ("check", _indexes))
    assert out[1] == ("error", "UniqueViolation") and out[2][1] == []


def test_delete_frees_unique_value(db):
    out = db.run("CREATE UNIQUE INDEX items_id_key ON items (id)",
                 "DELETE FROM items WHERE id = 42",
                 ("copy", "items", {"rows": [(42, 0, "back", 9.0)]}),
                 ("copy", "items", {"rows": [(42, 0, "again", 9.0)]}))
    assert out[2:] == [("copied", 1), ("error", "UniqueViolation")]


def test_update_respects_unique(db):
    out = db.run("CREATE UNIQUE INDEX items_id_key ON items (id)",
                 "UPDATE items SET id = 100 WHERE id = 200",
                 "UPDATE items SET id = 990001 WHERE id = 200",
                 "SELECT count(*) FROM items WHERE id = 990001",
                 "UPDATE items SET grp = 99 WHERE id = 300",
                 "SELECT id, grp FROM items WHERE id IN (100, 200, 300, "
                 "990001) ORDER BY id")
    assert out[1] == ("error", "UniqueViolation")


def test_upsert_still_works_with_unique_index(db):
    db.run("CREATE UNIQUE INDEX items_id_key ON items (id)",
           "INSERT INTO items (id, grp, label, price) VALUES "
           "(55, 0, 'x', 1.0) ON CONFLICT (id) DO UPDATE SET grp = 77",
           "SELECT grp FROM items WHERE id = 55",
           "INSERT INTO items (id, grp, label, price) VALUES "
           "(600001, 5, 'new', 2.0) ON CONFLICT (id) DO NOTHING",
           "SELECT count(*) FROM items WHERE id = 600001")


def test_primary_key_column_constraint(tmp_path):
    p = Pair(tmp_path, "db2")
    try:
        out = p.run("CREATE TABLE users (uid bigint PRIMARY KEY, "
                    "name text UNIQUE)",
                    ("check", lambda cl: (cl.catalog.table("users").indexes,
                                          cl.catalog.table("users").schema
                                          .column("uid").not_null)),
                    "INSERT INTO users VALUES (1, 'ann'), (2, 'bo')",
                    "INSERT INTO users VALUES (1, 'carl')",
                    "INSERT INTO users VALUES (3, 'ann')")
        assert out[3:] == [("error", "UniqueViolation")] * 2
    finally:
        p.close()


def test_create_table_pk_validation_is_atomic(tmp_path):
    p = Pair(tmp_path, "db3")
    try:
        out = p.run("CREATE TABLE bad (x double precision PRIMARY KEY)",
                    ("check", lambda cl: cl.catalog.has_table("bad")),
                    "CREATE TABLE a (k bigint PRIMARY KEY)",
                    "CREATE UNIQUE INDEX a_pkey ON a (k)")
        assert out[0] == ("error", "UnsupportedFeatureError")
        assert out[3] == ("error", "CatalogError")
    finally:
        p.close()


def test_unique_index_inside_transaction_overlay(db):
    out = db.run("CREATE UNIQUE INDEX items_id_key ON items (id)",
                 ("s", "BEGIN"),
                 ("s", "INSERT INTO items (id, grp, label, price) VALUES "
                       "(770001, 1, 'a', 1.0)"),
                 ("s", "INSERT INTO items (id, grp, label, price) VALUES "
                       "(770001, 2, 'b', 2.0)"),
                 ("s", "ROLLBACK"),
                 ("copy", "items", {"rows": [(770001, 1, "c", 1.0)]}))
    assert out[3] == ("error", "UniqueViolation")
    assert out[5] == ("copied", 1)


def test_table_level_pk_and_unique_constraints(tmp_path):
    p = Pair(tmp_path, "db4")
    try:
        out = p.run("CREATE TABLE t (k bigint NOT NULL, v bigint,"
                    " PRIMARY KEY (k), UNIQUE (v))",
                    "SELECT create_distributed_table('t', 'k', 4)",
                    ("check", lambda cl: sorted(
                        ix["name"] for ix in
                        cl.catalog.table("t").unique_indexes)),
                    "INSERT INTO t VALUES (1, 10)",
                    "INSERT INTO t VALUES (1, 20)",
                    "INSERT INTO t VALUES (2, 10)")
        assert out[2][1] == ["t_pkey", "t_v_key"]
        assert out[4:] == [("error", "UniqueViolation")] * 2
    finally:
        p.close()


# ------------------------------------------ data directories, both ways

def _write_constrained(cl, check_fn):
    """Partitions, a foreign key, unique indexes, a CHECK and a serial
    column with its sequence, through ``cl``; -> what ``check_fn``
    reads back."""
    cl.execute("CREATE TABLE acct (aid bigint PRIMARY KEY, name text "
               "UNIQUE)")
    cl.execute("SELECT create_reference_table('acct')")
    cl.execute("INSERT INTO acct VALUES (1, 'a'), (2, 'b'), (3, 'c')")
    cl.execute("CREATE TABLE ev (id bigserial, aid bigint REFERENCES "
               "acct (aid) ON DELETE CASCADE, d date, amt bigint "
               "DEFAULT 5, CHECK (amt >= 0)) PARTITION BY RANGE (d)")
    cl.execute("SELECT create_time_partitions('ev', '1 month', "
               "'2024-04-01', '2024-01-01')")
    cl.execute("SELECT create_distributed_table('ev', 'aid', 4)")
    cl.execute("INSERT INTO ev (aid, d, amt) VALUES (1, '2024-01-05', 10), "
               "(2, '2024-02-05', 20), (3, '2024-03-05', 30)")
    cl.execute("INSERT INTO ev (aid, d) VALUES (1, '2024-03-09')")
    return check_fn(cl)


def _read_back(cl) -> list:
    return [cl.execute("SELECT id, aid, d, amt FROM ev ORDER BY id").rows,
            cl.execute("SELECT count(*), sum(amt) FROM ev "
                       "WHERE d >= date '2024-02-01'").rows,
            cl.execute("SELECT aid, name FROM acct ORDER BY aid").rows]


def _write_more(cl) -> list:
    """Writes that go through every constraint of the directory:
    -> the outcome of each (rows, or the error class)."""
    out = []
    for sql in ("INSERT INTO ev (aid, d, amt) VALUES (9, '2024-01-02', 1)",
                "INSERT INTO ev (aid, d, amt) VALUES (2, '2024-01-02', -1)",
                "INSERT INTO acct VALUES (2, 'z')",
                "INSERT INTO ev (aid, d, amt) VALUES (2, '2024-01-02', 7) "
                "RETURNING id, amt",
                "DELETE FROM acct WHERE aid = 1",
                "SELECT id, aid, d, amt FROM ev ORDER BY id",
                "SELECT nextval('ev_id_seq')"):
        try:
            out.append(cl.execute(sql).rows)
        except Exception as e:  # noqa: BLE001 -- the class is compared
            out.append(type(e).__name__)
    return out


def test_reference_directory_opens_in_the_port(tmp_path):
    """A data directory citus_tpu wrote with partitions, a foreign key,
    unique indexes, a CHECK and a sequence: the port opens it, reads the
    reference's rows and writes through every constraint as the
    reference does on its own copy."""
    d = str(tmp_path / "ref_written")
    ref = ct.Cluster(d)
    want = _write_constrained(ref, _read_back)
    ref.close()
    import shutil
    shutil.copytree(d, str(tmp_path / "copy"))
    port = ctt.Cluster(d, device="cpu")
    try:
        assert _read_back(port) == want
        got = _write_more(port)
    finally:
        port.close()
    ref2 = ct.Cluster(str(tmp_path / "copy"))
    try:
        assert got == _write_more(ref2)
    finally:
        ref2.close()
    assert got[0] == "ForeignKeyViolation" and got[1] == "CheckViolation"
    assert got[2] == "UniqueViolation"


def test_port_directory_opens_in_the_reference(tmp_path):
    """The same directory written by the port opens in citus_tpu, reads
    the port's rows and writes as the port does on its own copy."""
    d = str(tmp_path / "port_written")
    port = ctt.Cluster(d, device="cpu")
    want = _write_constrained(port, _read_back)
    port.close()
    import shutil
    shutil.copytree(d, str(tmp_path / "copy"))
    ref = ct.Cluster(d)
    try:
        assert _read_back(ref) == want
        got = _write_more(ref)
    finally:
        ref.close()
    port2 = ctt.Cluster(str(tmp_path / "copy"), device="cpu")
    try:
        assert got == _write_more(port2)
    finally:
        port2.close()
