"""ALTER TABLE, alter_distributed_table and undistribute_table through
the port against the reference.

The same statements over the same seeded rows go through
``citus_tpu.Cluster`` and ``citus_tpu_torch.Cluster(device="cpu")``
(tests/torch_write_pair.py, strict): identical rows, ``explain`` dicts,
error classes and messages.  Integers and decimals are compared
exactly; the float column within rel 1e-12 (an intermediate table may
reorder a float sum).  Also: a query cached warm on the device before
``alter_distributed_table`` and DROP COLUMN, and data directories that
one package altered, opened, queried and written by the other.
"""

import os
import sys

import numpy as np
import pytest

import citus_tpu as ct
import citus_tpu_torch as ctt

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_write_pair import Pair, same_rows  # noqa: E402

N = 600


def _rows(seed=7, n=N):
    rng = np.random.default_rng(seed)
    grp = rng.integers(0, 6, n)
    price = rng.integers(1, 100_000, n)
    w = rng.random(n)
    return [(i, int(g), f"g{g}", f"{p // 100}.{p % 100:02d}", float(x))
            for i, g, p, x in zip(range(n), grp, price, w)]


PLAIN = ("CREATE TABLE items (id bigint NOT NULL, grp bigint, label text, "
         "price decimal(10,2), w double precision)",
         "SELECT create_distributed_table('items', 'id', 4)")
PARENT = ("CREATE TABLE items (id bigint NOT NULL, grp bigint, label text, "
          "price decimal(10,2), w double precision) "
          "PARTITION BY RANGE (id)",
          "CREATE TABLE items_lo PARTITION OF items "
          "FOR VALUES FROM (0) TO (300)",
          "CREATE TABLE items_hi PARTITION OF items "
          "FOR VALUES FROM (300) TO (100000)",
          "SELECT create_distributed_table('items', 'grp', 4)")

READ = "SELECT * FROM items ORDER BY id"

#: one step list an action: the ALTER and what reads its effect
ACTIONS = {
    "add_column": ["ALTER TABLE items ADD COLUMN note text",
                   "INSERT INTO items (id, grp, note) VALUES (9001, 1, 'x')",
                   "SELECT note, count(*) FROM items GROUP BY note "
                   "ORDER BY note",
                   "ALTER TABLE items ADD COLUMN note text",
                   "ALTER TABLE items ADD COLUMN z bigint NOT NULL"],
    "drop_column": ["ALTER TABLE items DROP COLUMN label",
                    READ,
                    "SELECT label FROM items",
                    "ALTER TABLE items DROP COLUMN id",
                    "ALTER TABLE items DROP COLUMN nope"],
    "rename_column": ["ALTER TABLE items RENAME COLUMN label TO tag",
                      "SELECT tag, count(*) FROM items GROUP BY tag "
                      "ORDER BY tag",
                      "ALTER TABLE items RENAME COLUMN grp TO price"],
    "rename_table": ["ALTER TABLE items RENAME TO goods",
                     "SELECT count(*), sum(price) FROM goods",
                     "SELECT count(*) FROM items"],
    "add_check": ["ALTER TABLE items ADD CONSTRAINT pos CHECK (price > 0)",
                  "INSERT INTO items VALUES (9002, 1, 'n', -1.00, 0.5)",
                  "INSERT INTO items VALUES (9003, 1, 'p', 1.00, 0.5)",
                  "ALTER TABLE items ADD CONSTRAINT pos CHECK (grp >= 0)",
                  "ALTER TABLE items ADD CONSTRAINT cheap "
                  "CHECK (price < 500)",
                  "ALTER TABLE items ADD CONSTRAINT nb CHECK (grp + 1)",
                  "SELECT count(*) FROM items"],
    "drop_constraint": ["ALTER TABLE items ADD CONSTRAINT pos "
                        "CHECK (price > 0)",
                        "ALTER TABLE items DROP CONSTRAINT pos",
                        "INSERT INTO items VALUES (9002, 1, 'n', -1.00, 0.5)",
                        "ALTER TABLE items DROP CONSTRAINT pos",
                        "SELECT count(*) FROM items WHERE price < 0"],
    "set_default": ["ALTER TABLE items ALTER COLUMN grp SET DEFAULT 5",
                    "INSERT INTO items (id, label) VALUES (9004, 'd')",
                    "SELECT id, grp, label FROM items WHERE id = 9004",
                    "ALTER TABLE items ALTER COLUMN nope SET DEFAULT 1"],
}


def _pair(tmp_path, layout, name="db"):
    p = Pair(tmp_path, name, strict=True)
    p.run(*(PLAIN if layout == "plain" else PARENT),
          ("copy", "items", {"rows": _rows()}))
    return p


@pytest.mark.parametrize("layout", ["plain", "parent"])
@pytest.mark.parametrize("action", sorted(ACTIONS))
def test_alter_action(tmp_path, layout, action):
    p = _pair(tmp_path, layout)
    try:
        out = p.run(*ACTIONS[action],
                    ("check", lambda cl: [
                        (t.name, t.schema.names, list(t.check_constraints),
                         [c.default_sql for c in t.schema])
                        for t in sorted(cl.catalog.tables.values(),
                                        key=lambda t: t.name)]))
    finally:
        p.close()
    assert out[0][0] == ("error" if layout == "parent" and action in (
        "rename_table", "rename_column") else "rows")


def test_add_check_violated_names_its_count(tmp_path):
    p = _pair(tmp_path, "plain")
    try:
        want = p.step("SELECT count(*) FROM items WHERE price >= 500")
        out = p.run("ALTER TABLE items ADD CONSTRAINT cheap "
                    "CHECK (price < 500)",
                    ("check", lambda cl: list(cl.catalog.table("items")
                                              .check_constraints)))
    finally:
        p.close()
    assert out[0] == (
        "error", "AnalysisError",
        'check constraint of relation "items" is violated by '
        f"{want[2][0][0]} existing row(s)")
    assert out[1] == ("value", [])


def test_add_check_inside_a_rolled_back_block(tmp_path):
    p = _pair(tmp_path, "plain")
    try:
        out = p.run(("s", "BEGIN"),
                    ("s", "ALTER TABLE items ADD CONSTRAINT pos "
                          "CHECK (price > 0)"),
                    ("s", "ALTER TABLE items ALTER COLUMN grp SET DEFAULT 3"),
                    ("s", "ALTER TABLE items ADD COLUMN note text"),
                    ("s", "INSERT INTO items VALUES "
                          "(9002, 1, 'n', -1.00, 0.5, 'x')"),
                    ("s", "ROLLBACK"),
                    ("check", lambda cl: (
                        list(cl.catalog.table("items").check_constraints),
                        cl.catalog.table("items").schema.names)),
                    "INSERT INTO items VALUES (9002, 1, 'n', -1.00, 0.5)",
                    ("s", "BEGIN"),
                    ("s", "ALTER TABLE items RENAME COLUMN grp TO g"),
                    ("s", "ROLLBACK"),
                    ("s", "BEGIN"),
                    ("s", "ALTER TABLE items ADD CONSTRAINT pos "
                          "CHECK (price > -5)"),
                    ("s", "COMMIT"),
                    ("check", lambda cl: cl.catalog.table("items")
                     .check_constraints),
                    "SELECT count(*) FROM items WHERE price < 0")
    finally:
        p.close()
    assert out[4][:2] == ("error", "CheckViolation")
    assert out[6] == ("value", ([], ["id", "grp", "label", "price", "w"]))
    assert out[9] == ("error", "UnsupportedFeatureError",
                      "ALTER TABLE RENAME cannot run inside a transaction "
                      "block")
    assert out[14] == ("value", [{"name": "pos", "sql": "price > -5"}])
    assert out[15][2] == [(1,)]


def test_alter_distributed_table_then_undistribute(tmp_path):
    p = _pair(tmp_path, "plain")
    q = "SELECT grp, count(*), sum(price), sum(w) FROM items GROUP BY grp " \
        "ORDER BY grp"
    shards = ("check", lambda cl: (
        cl.catalog.table("items").method,
        cl.catalog.table("items").dist_column,
        cl.catalog.table("items").shard_count))
    try:
        out = p.run(q, "SELECT alter_distributed_table('items', 8)", shards,
                    q, READ,
                    "SELECT alter_distributed_table('items', 8, 'grp')",
                    shards, q, "INSERT INTO items VALUES (9005, 2, 'n', "
                               "1.00, 0.5)",
                    "SELECT count(*) FROM items WHERE grp = 2",
                    "SELECT undistribute_table('items')", shards, q, READ,
                    "SELECT undistribute_table('items')",
                    "SELECT alter_distributed_table('items', 4)")
    finally:
        p.close()
    assert out[2] == ("value", ("hash", "id", 8))
    assert out[6] == ("value", ("hash", "grp", 8))
    assert out[11] == ("value", ("local", None, 1))
    assert out[14] == ("error", "CatalogError",
                       'table "items" is not distributed')
    assert out[15] == out[14]


@pytest.mark.parametrize("ddl", [
    "SELECT alter_distributed_table('items', 8)",
    "ALTER TABLE items DROP COLUMN label",
])
def test_warm_device_query_sees_the_alter(tmp_path, ddl):
    """A scan cached on the device (the gpu backend's cache, CPU tensors
    here) before the statement returns the new rows and layout after
    it."""
    from citus_tpu_torch.executor.executor import GLOBAL_COUNTERS
    p = _pair(tmp_path, "plain")
    q = "SELECT grp, count(*), sum(price) FROM items GROUP BY grp " \
        "ORDER BY grp"
    try:
        p.run(q, q)
        hits = GLOBAL_COUNTERS.snapshot().get("device_cache_hits", 0)
        p.step(q)
        assert GLOBAL_COUNTERS.snapshot().get("device_cache_hits", 0) > hits
        out = p.run(ddl, "INSERT INTO items (id, grp, price) "
                         "VALUES (9006, 77, 3.00)", q, q)
    finally:
        p.close()
    assert out[2][2][-1] == (77, 1, 3)


def _alter_everything(cl):
    """ALTER TABLE, alter_distributed_table, MERGE and CREATE STATISTICS
    on a fresh directory, written by either package."""
    for sql in PLAIN:
        cl.execute(sql)
    cl.copy_from("items", rows=_rows())
    for sql in (
            "CREATE INDEX ix_grp ON items (grp)",
            "ALTER TABLE items RENAME COLUMN grp TO bucket",
            "ALTER TABLE items DROP COLUMN w",
            "ALTER TABLE items ADD COLUMN note text",
            "ALTER TABLE items ADD CONSTRAINT pos CHECK (price > 0)",
            "ALTER TABLE items ALTER COLUMN note SET DEFAULT 'n/a'",
            "SELECT alter_distributed_table('items', 6)",
            "CREATE TABLE stage (id bigint NOT NULL, bucket bigint)",
            "SELECT create_distributed_table('stage', 'id', 6)",
            "INSERT INTO stage VALUES (1, 50), (2, 51), (7000, 52)",
            "MERGE INTO items t USING stage s ON t.id = s.id "
            "WHEN MATCHED THEN UPDATE SET bucket = s.bucket "
            "WHEN NOT MATCHED THEN INSERT (id, bucket, price) "
            "VALUES (s.id, s.bucket, 1.00)",
            "CREATE STATISTICS st ON bucket, label FROM items",
            "ALTER TABLE stage RENAME TO stage_old"):
        cl.execute(sql)


CROSS_READS = [
    "SELECT * FROM items ORDER BY id",
    "SELECT bucket, count(*), sum(price) FROM items GROUP BY bucket "
    "ORDER BY bucket",
    "SELECT count(*) FROM items WHERE bucket = 3",
    "SELECT * FROM stage_old ORDER BY id",
]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_altered_directory_opens_in_the_other_package(tmp_path, writer):
    d = str(tmp_path / "db")
    w = ct.Cluster(d) if writer == "reference" \
        else ctt.Cluster(d, device="cpu")
    _alter_everything(w)
    want = [w.execute(q).rows for q in CROSS_READS]
    w.close()
    r = ctt.Cluster(d, device="cpu") if writer == "reference" \
        else ct.Cluster(d)
    try:
        t = r.catalog.table("items")
        assert t.schema.names == ["id", "bucket", "label", "price", "note"]
        assert t.shard_count == 6 and t.index_on("bucket") is not None
        assert r.catalog.statistics["st"]["columns"] == ["bucket", "label"]
        for q, rows in zip(CROSS_READS, want):
            assert same_rows(r.execute(q).rows, rows, True), q
        # and written there: a default, the CHECK, the index
        r.execute("INSERT INTO items (id, bucket, label, price) "
                  "VALUES (8000, 3, 'z', 2.50)")
        with pytest.raises(Exception, match="check"):
            r.execute("INSERT INTO items (id, price) VALUES (8001, -1.00)")
        assert r.execute("SELECT note FROM items WHERE id = 8000").rows \
            == [("n/a",)]
        assert r.execute("SELECT count(*) FROM items WHERE bucket = 3"
                         ).rows == [(want[2][0][0] + 1,)]
        assert r.execute("ANALYZE items").explain == \
            {"statistics_refreshed": 1}
    finally:
        r.close()
