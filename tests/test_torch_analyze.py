"""CREATE / DROP STATISTICS, ANALYZE, VACUUM ANALYZE and REINDEX through
the port against the reference.

The same statements over the same seeded rows go through
``citus_tpu.Cluster`` and ``citus_tpu_torch.Cluster(device="cpu")``
(tests/torch_write_pair.py, strict): identical rows, ``explain`` dicts
(``statistics_refreshed``, ``segments_rebuilt``), error classes and
messages, and identical statistics entries in the catalog.  Every
value here is an integer or a word, compared exactly.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_write_pair import Pair  # noqa: E402

N = 800


def _rows(seed=3, n=N, start=0):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 40, n)
    b = rng.integers(0, 7, n)
    return [(start + i, int(x), None if y == 6 else f"w{y}",
             None if i % 9 == 0 else int(x) % 5)
            for i, (x, y) in enumerate(zip(a, b))]


@pytest.fixture()
def db(tmp_path):
    p = Pair(tmp_path, strict=True)
    p.run("CREATE TABLE t (id bigint NOT NULL, a bigint, s text, c bigint)",
          "SELECT create_distributed_table('t', 'id', 4)",
          ("copy", "t", {"rows": _rows()}))
    yield p
    p.close()


def _stats(cl):
    return {k: dict(v) for k, v in cl.catalog.statistics.items()}


def _tables(cl):
    return sorted(cl.catalog.tables)


def test_statistics_then_analyze_after_writes_then_drop(db):
    rows = _rows()
    want0 = len({(a, s) for _i, a, s, _c in rows})
    out = db.run("CREATE STATISTICS st_as ON a, s FROM t",
                 "CREATE STATISTICS st_c ON c, a FROM t",
                 ("check", _stats),
                 ("check", _tables),
                 ("copy", "t", {"rows": _rows(seed=5, n=300, start=N)}),
                 "DELETE FROM t WHERE a < 3",
                 "UPDATE t SET s = 'new' WHERE a = 7",
                 "ANALYZE",
                 ("check", _stats),
                 "ANALYZE t",
                 "VACUUM ANALYZE t",
                 "DROP STATISTICS st_c",
                 "ANALYZE t",
                 ("check", _stats),
                 "DROP STATISTICS st_c",
                 "DROP STATISTICS IF EXISTS st_c",
                 "CREATE STATISTICS st_as ON a FROM t",
                 "CREATE STATISTICS st_x ON nope FROM t",
                 "ANALYZE nope",
                 ("check", _tables))
    assert out[2][1]["st_as"] == {"table": "t", "columns": ["a", "s"],
                                  "ndistinct": want0}
    assert out[3] == ("value", ["t"])
    assert out[7][3] == {"statistics_refreshed": 2}
    assert out[8][1]["st_as"]["ndistinct"] != want0
    assert out[10][3] == {"statistics_refreshed": 2}
    assert out[12][3] == {"statistics_refreshed": 1}
    assert list(out[13][1]) == ["st_as"]
    assert out[14] == ("error", "CatalogError",
                       'statistic "st_c" does not exist')
    assert out[16][:2] == ("error", "CatalogError")
    assert out[17][0] == "error" and out[18][0] == "error"
    # the derived table of the count is dropped after each statement
    assert out[19] == ("value", ["t"])


def test_statistics_on_a_partitioned_parent_and_in_a_block(tmp_path):
    p = Pair(tmp_path, strict=True)
    try:
        out = p.run(
            "CREATE TABLE e (id bigint NOT NULL, k bigint, s text) "
            "PARTITION BY RANGE (id)",
            "CREATE TABLE e_lo PARTITION OF e FOR VALUES FROM (0) TO (400)",
            "CREATE TABLE e_hi PARTITION OF e FOR VALUES FROM (400) TO (900)",
            "SELECT create_distributed_table('e', 'k', 4)",
            ("copy", "e", {"rows": [(i, i % 13, f"s{i % 5}")
                                    for i in range(900)]}),
            "CREATE STATISTICS se ON k, s FROM e",
            ("s", "BEGIN"),
            ("s", "CREATE STATISTICS se_lo ON s FROM e_lo"),
            ("s", "ANALYZE e_lo"),
            ("s", "ROLLBACK"),
            ("check", _stats),
            ("s", "BEGIN"),
            ("s", "CREATE STATISTICS se_lo ON s FROM e_lo"),
            ("s", "COMMIT"),
            "INSERT INTO e VALUES (5, 99, 'x')",
            "ANALYZE",
            ("check", _stats))
    finally:
        p.close()
    assert out[5][3] == {}
    assert out[10][1] == {"se": {"table": "e", "columns": ["k", "s"],
                                 "ndistinct": 65}}
    assert out[15][3] == {"statistics_refreshed": 2}
    assert out[16][1]["se"]["ndistinct"] == 66
    assert out[16][1]["se_lo"]["ndistinct"] == 6


def _seg_files(cl, table):
    t = cl.catalog.table(table)
    out = []
    for shard in t.shards:
        for node in shard.placements:
            d = cl.catalog.shard_dir(table, shard.shard_id, node)
            if os.path.isdir(d):
                out += sorted(os.path.join(d, f) for f in os.listdir(d)
                              if ".idx." in f)
    return out


def _delete_segments(cl, table):
    files = _seg_files(cl, table)
    for f in files:
        os.remove(f)
    return len(files)


@pytest.mark.parametrize("kind", ["index", "table"])
def test_reindex_after_the_segments_are_deleted(db, kind):
    target = "ix_a" if kind == "index" else "t"
    out = db.run("CREATE INDEX ix_a ON t (a)",
                 "CREATE INDEX ix_c ON t (c)",
                 ("check", lambda cl: len(_seg_files(cl, "t"))),
                 "SELECT count(*) FROM t WHERE a = 17",
                 ("check", lambda cl: _delete_segments(cl, "t")),
                 "SELECT count(*) FROM t WHERE a = 17",
                 f"REINDEX {kind.upper()} {target}",
                 ("check", lambda cl: len(_seg_files(cl, "t"))),
                 "SELECT count(*) FROM t WHERE a = 17",
                 "SELECT count(*), sum(c) FROM t WHERE c = 3",
                 "REINDEX INDEX nope",
                 "REINDEX TABLE nope")
    assert out[2][1] > 0 and out[4][1] == out[2][1]
    assert out[5][2] == out[3][2] == out[8][2]
    assert out[6][3] == {"segments_rebuilt": out[2][1] // (
        2 if kind == "index" else 1)}
    assert out[10] == ("error", "CatalogError",
                       'index "nope" does not exist')
    assert out[11][:2] == ("error", "CatalogError")


def test_reindex_of_a_partitioned_parent_and_a_table_without_indexes(
        tmp_path):
    p = Pair(tmp_path, strict=True)
    try:
        out = p.run(
            "CREATE TABLE e (id bigint NOT NULL, k bigint) "
            "PARTITION BY RANGE (id)",
            "CREATE TABLE e_lo PARTITION OF e FOR VALUES FROM (0) TO (400)",
            "CREATE TABLE e_hi PARTITION OF e FOR VALUES FROM (400) TO (900)",
            "SELECT create_distributed_table('e', 'id', 4)",
            ("copy", "e", {"rows": [(i, i % 13) for i in range(900)]}),
            "REINDEX TABLE e",
            "CREATE INDEX ix_lo ON e_lo (k)",
            "REINDEX TABLE e",
            "SELECT count(*) FROM e WHERE k = 4")
    finally:
        p.close()
    assert out[5][3] == {"segments_rebuilt": 0}
    assert out[7][3]["segments_rebuilt"] > 0


def test_c15_rename_column_leaves_statistics_stale(db):
    """ROADMAP.md C15, a reference fault the port mirrors: RENAME COLUMN
    leaves a statistics object naming the old column, and an ANALYZE of
    the table, or of every table, then fails."""
    out = db.run("CREATE STATISTICS st_as ON a, s FROM t",
                 "ALTER TABLE t RENAME COLUMN s TO s2",
                 ("check", _stats),
                 "ANALYZE",
                 "ALTER TABLE t RENAME COLUMN s2 TO s",
                 "ANALYZE")
    assert out[2][1]["st_as"]["columns"] == ["a", "s"]
    assert out[3] == ("error", "AnalysisError", "column 's' does not exist")
    assert out[5][3] == {"statistics_refreshed": 1}


def test_c16_rename_and_drop_table_leave_statistics_behind(db):
    """ROADMAP.md C16, a reference fault the port mirrors: RENAME TO and
    DROP TABLE leave a table's statistics under its old name, refreshed
    by no ANALYZE."""
    out = db.run("CREATE STATISTICS st_as ON a, s FROM t",
                 "ALTER TABLE t RENAME TO t2",
                 "ANALYZE t2",
                 "DROP TABLE t2",
                 "ANALYZE",
                 ("check", _stats))
    assert out[2][3] == {"statistics_refreshed": 0}
    assert out[4][3] == {"statistics_refreshed": 0}
    assert list(out[5][1]) == ["st_as"] and out[5][1]["st_as"]["table"] == "t"
