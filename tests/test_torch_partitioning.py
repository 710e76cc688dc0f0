"""Range-partitioned tables in the port, held against the JAX package.

The same statements over the same seeded rows go through
``citus_tpu.Cluster`` and ``citus_tpu_torch.Cluster(device="cpu")``
(tests/torch_write_pair.py): identical rows (floats within rel 1e-12),
identical write counts and error classes.  The cases are the SQL of
tests/test_partitioning.py (17) and tests/test_fuzz_partitioned.py (5,
seed 42), and ``chip_smoke.py`` phase 11's time-partitioned lineitem at
a few thousand rows.  ALTER TABLE on a parent cascades to its
partitions in both packages.
"""

import datetime
import json
import os
import sys

import numpy as np
import pytest

import citus_tpu as ct  # noqa: F401  (flips JAX to 64 bits first)
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


def _events_rows():
    d0 = datetime.date(2024, 1, 1)
    return [(i % 10, (d0 + datetime.timedelta(days=i % 360)).isoformat(), i)
            for i in range(2000)]


@pytest.fixture()
def db(tmp_path):
    """tests/test_partitioning.py's events: two half-year partitions,
    distributed by tenant, 2,000 rows."""
    p = Pair(tmp_path)
    p.run("CREATE TABLE events (tenant bigint NOT NULL, ts date, "
          "amount bigint) PARTITION BY RANGE (ts)",
          "CREATE TABLE events_2024h1 PARTITION OF events "
          "FOR VALUES FROM ('2024-01-01') TO ('2024-07-01')",
          "CREATE TABLE events_2024h2 PARTITION OF events "
          "FOR VALUES FROM ('2024-07-01') TO ('2025-01-01')",
          "SELECT create_distributed_table('events', 'tenant', 4)",
          ("copy", "events", {"rows": _events_rows()}))
    yield p
    p.close()


def _partitions(cl):
    return [(t.name, t.is_distributed, t.shard_count, t.partition_of["lo"],
             t.partition_of["hi"])
            for t in cl.catalog.partitions_of("events")]


def test_metadata_shape(db):
    db.step(("check", _partitions))
    db.step(("check", lambda cl: len({p.colocation_id for p in
                                      cl.catalog.partitions_of("events")})))
    db.step(("check", lambda cl: cl.catalog.table("events").partition_by))


def test_ingest_routes_by_range(db):
    db.run("SELECT count(*) FROM events_2024h1",
           "SELECT count(*) FROM events_2024h2",
           "SELECT count(*) FROM events_2024h1 WHERE ts >= '2024-07-01'")


def test_parent_scan_unions_partitions(db):
    db.run("SELECT count(*) FROM events",
           "SELECT sum(amount) FROM events",
           "SELECT tenant, count(*) FROM events GROUP BY tenant "
           "ORDER BY tenant")


def test_partition_pruning_single_partition(db):
    out = db.run("EXPLAIN SELECT count(*) FROM events "
                 "WHERE ts >= date '2024-02-01' AND ts < date '2024-03-01'",
                 "SELECT count(*) FROM events "
                 "WHERE ts >= date '2024-02-01' AND ts < date '2024-03-01'")
    text = "\n".join(r[0] for r in out[0][2])
    assert "partitions: 1/2" in text and "Chunk Pruning" in text


def test_row_outside_partitions_rejected(db):
    out = db.run(("copy", "events", {"rows": [(1, "2030-01-01", 5)]}),
                 ("copy", "events", {"rows": [(1, None, 5)]}),
                 "SELECT count(*) FROM events")
    assert out[0] == ("error", "AnalysisError")


def test_overlapping_partition_rejected(db):
    out = db.run("CREATE TABLE events_bad PARTITION OF events "
                 "FOR VALUES FROM ('2024-06-01') TO ('2024-08-01')")
    assert out[0] == ("error", "CatalogError")


def test_dml_through_parent(db):
    out = db.run("UPDATE events SET amount = 0 WHERE amount < 100",
                 "SELECT sum(amount) FROM events",
                 "DELETE FROM events WHERE ts < date '2024-07-01'",
                 "SELECT count(*) FROM events_2024h1",
                 "UPDATE events SET ts = '2024-08-01' WHERE amount = 150",
                 "SELECT count(*), sum(amount) FROM events")
    assert out[0][3]["updated"] == 100
    assert out[4] == ("error", "UnsupportedFeatureError")


def test_drop_parent_cascades(db):
    db.run("DROP TABLE events",
           ("check", lambda cl: sorted(cl.catalog.tables)),
           "SELECT count(*) FROM events_2024h1")


def test_truncate_parent(db):
    db.run("TRUNCATE events", "SELECT count(*) FROM events",
           "SELECT count(*) FROM events_2024h2")


def test_joins_through_parent(db):
    db.run("CREATE TABLE tenants (tenant bigint, name text)",
           ("copy", "tenants", {"rows": [(i, f"t{i}") for i in range(10)]}),
           "SELECT t.name, count(*) FROM events e JOIN tenants t "
           "ON e.tenant = t.tenant GROUP BY t.name ORDER BY t.name")


def test_create_time_partitions_and_retention(tmp_path):
    p = Pair(tmp_path, "db2")
    try:
        out = p.run(
            "CREATE TABLE metrics (k bigint, ts timestamp, v bigint) "
            "PARTITION BY RANGE (ts)",
            "SELECT create_time_partitions('metrics', '1 hour', "
            "'2024-01-01 06:00', '2024-01-01 00:00')",
            "SELECT create_time_partitions('metrics', '1 hour', "
            "'2024-01-01 06:00', '2024-01-01 00:00')",
            "SELECT create_time_partitions('metrics', '1 hour', "
            "'2024-01-01 08:00')",
            ("check", lambda cl: [t.name for t in
                                  cl.catalog.partitions_of("metrics")]),
            ("copy", "metrics", {"rows": [(1, "2024-01-01 03:30:00", 7),
                                          (2, "2024-01-01 07:15:00", 9)]}),
            "SELECT count(*) FROM metrics_p2024010103",
            "SELECT drop_old_time_partitions('metrics', '2024-01-01 06:00')",
            "SELECT count(*) FROM metrics",
            "SELECT time_partitions()")
        assert out[1][2] == [(True,)] and out[2][2] == [(False,)]
        assert len(out[4][1]) == 8 and out[7][2] == [(6,)]
    finally:
        p.close()


def test_daily_time_partitions_on_date_column(tmp_path):
    p = Pair(tmp_path, "db3")
    try:
        out = p.run("CREATE TABLE logs (k bigint, d date, msg text) "
                    "PARTITION BY RANGE (d)",
                    "SELECT create_time_partitions('logs', '1 day', "
                    "'2024-03-05', '2024-03-01')",
                    ("check", lambda cl: [t.name for t in
                                          cl.catalog.partitions_of("logs")]))
        assert out[2][1] == ["logs_p20240301", "logs_p20240302",
                             "logs_p20240303", "logs_p20240304"]
    finally:
        p.close()


def test_insert_select_through_parent(db):
    out = db.run(
        "CREATE TABLE staging (tenant bigint, ts date, amount bigint)",
        ("copy", "staging", {"rows": [(1, "2024-03-03", 100000),
                                      (2, "2024-09-09", 200000)]}),
        "INSERT INTO events SELECT * FROM staging",
        "SELECT count(*) FROM events WHERE amount >= 100000",
        "CREATE TABLE flat (tenant bigint, ts date, amount bigint)",
        "INSERT INTO flat SELECT * FROM events",
        "SELECT count(*) FROM flat")
    assert out[2][3] == {"inserted": 2, "strategy": "insert_select:pull"}


def test_parameterized_select_on_parent(db):
    db.step(("params", "SELECT count(*) FROM events WHERE amount < $1",
             [100]))


def test_parent_pk_enforced_in_partitions(tmp_path):
    p = Pair(tmp_path, "db4")
    try:
        out = p.run("CREATE TABLE seq_events (ts date PRIMARY KEY, v bigint) "
                    "PARTITION BY RANGE (ts)",
                    "CREATE TABLE seq_a PARTITION OF seq_events "
                    "FOR VALUES FROM ('2024-01-01') TO ('2024-02-01')",
                    ("copy", "seq_events", {"rows": [("2024-01-05", 1)]}),
                    ("copy", "seq_events", {"rows": [("2024-01-05", 2)]}),
                    "CREATE TABLE bad (k bigint PRIMARY KEY, ts date) "
                    "PARTITION BY RANGE (ts)",
                    "SELECT * FROM seq_events")
        assert out[3] == ("error", "UniqueViolation")
        assert out[4] == ("error", "UnsupportedFeatureError")
    finally:
        p.close()


def test_decimal_partition_column_routing(tmp_path):
    p = Pair(tmp_path, "db5")
    try:
        p.run("CREATE TABLE priced (k bigint, amount decimal(10,2)) "
              "PARTITION BY RANGE (amount)",
              "CREATE TABLE priced_lo PARTITION OF priced "
              "FOR VALUES FROM (0) TO (100)",
              "CREATE TABLE priced_hi PARTITION OF priced "
              "FOR VALUES FROM (100) TO (1000)",
              ("copy", "priced", {"columns": {
                  "k": np.arange(4),
                  "amount": np.array([50.0, 99.99, 100.0, 500.5])}}),
              "SELECT count(*) FROM priced_lo",
              "SELECT count(*) FROM priced_hi",
              ("copy", "priced", {"rows": [(9, 42.42)]}),
              "SELECT k, amount FROM priced ORDER BY k")
    finally:
        p.close()


def test_alter_parent_cascades_add_column(db):
    """ADD COLUMN on the parent reaches every partition."""
    out = db.run("ALTER TABLE events ADD COLUMN note text",
                 ("check", lambda cl: [
                     p.schema.names
                     for p in cl.catalog.partitions_of("events")]),
                 "INSERT INTO events VALUES (3, '2024-08-08', 7, 'late')",
                 "SELECT note, count(*) FROM events GROUP BY note "
                 "ORDER BY note",
                 "SELECT count(*) FROM events_2024h2 WHERE note = 'late'")
    assert out[1] == ("value", [["tenant", "ts", "amount", "note"]] * 2)
    assert out[3][2] == [("late", 1), (None, 2000)]
    assert out[4][2] == [(1,)]


# --------------------------------------- tests/test_fuzz_partitioned.py

N = 4000

PREDICATES = [
    "",
    " WHERE d >= date '2024-03-15' AND d < date '2024-05-20'",
    " WHERE d < date '2024-02-01'",
    " WHERE d >= date '2024-11-11'",
    " WHERE v > 0",
    " WHERE v > 0 AND d >= date '2024-06-01'",
    " WHERE s = 'y'",
    " WHERE k = 77",
    " WHERE k = 77 AND d < date '2024-07-01'",
    " WHERE d >= date '2024-01-01' AND d < date '2025-01-01'",
]

SHAPES = [
    "SELECT count(*), sum(v), min(v), max(v) FROM {t}{p}",
    "SELECT s, count(*), sum(v) FROM {t}{p} GROUP BY s ORDER BY s",
    "SELECT count(DISTINCT k) FROM {t}{p}",
    "SELECT avg(v) FROM {t}{p}",
]


@pytest.fixture(scope="module")
def fuzz(tmp_path_factory):
    """tests/test_fuzz_partitioned.py's flat and quarterly-partitioned
    tables (seed 42, 4,000 rows)."""
    p = Pair(tmp_path_factory.mktemp("pfz"))
    p.run("CREATE TABLE flat (k bigint NOT NULL, d date, v bigint, s text)",
          "SELECT create_distributed_table('flat', 'k', 4)",
          "CREATE TABLE part (k bigint NOT NULL, d date, v bigint, s text) "
          "PARTITION BY RANGE (d)")
    for q, (lo, hi) in enumerate([("2024-01-01", "2024-04-01"),
                                  ("2024-04-01", "2024-07-01"),
                                  ("2024-07-01", "2024-10-01"),
                                  ("2024-10-01", "2025-01-01")]):
        p.step(f"CREATE TABLE part_q{q} PARTITION OF part "
               f"FOR VALUES FROM ('{lo}') TO ('{hi}')")
    p.step("SELECT create_distributed_table('part', 'k', 4)")
    rng = np.random.default_rng(42)
    d0 = datetime.date(2024, 1, 1)
    rows = []
    for _ in range(N):
        rows.append((
            int(rng.integers(0, 500)),
            (d0 + datetime.timedelta(days=int(rng.integers(0, 366)))
             ).isoformat(),
            int(rng.integers(-100, 100)) if rng.random() > 0.05 else None,
            ["x", "y", "z"][int(rng.integers(0, 3))],
        ))
    p.run(("copy", "flat", {"rows": rows}), ("copy", "part", {"rows": rows}))
    yield p
    p.close()


@pytest.mark.parametrize("shape", SHAPES)
def test_partitioned_equals_flat(fuzz, shape):
    for pred in PREDICATES:
        got = fuzz.step(shape.format(t="part", p=pred))
        want = fuzz.step(shape.format(t="flat", p=pred))
        assert sorted(got[2], key=repr) == sorted(want[2], key=repr), pred


def test_partitioned_joins_equal_flat(fuzz):
    out = fuzz.run(
        "CREATE TABLE dims (k bigint, name text)",
        ("copy", "dims", {"rows": [(i, f"n{i % 7}") for i in range(500)]}),
        "SELECT dm.name, count(*) FROM part e JOIN dims dm ON e.k = dm.k "
        "WHERE e.d >= date '2024-05-01' GROUP BY dm.name ORDER BY dm.name",
        "SELECT dm.name, count(*) FROM flat e JOIN dims dm ON e.k = dm.k "
        "WHERE e.d >= date '2024-05-01' GROUP BY dm.name ORDER BY dm.name")
    assert out[2][2] == out[3][2]


def test_partitioned_dml_equals_flat(fuzz):
    for t in ("part", "flat"):
        fuzz.run(f"UPDATE {t} SET v = 0 WHERE v < -50",
                 f"DELETE FROM {t} WHERE s = 'z' AND d < date '2024-03-01'")
    out = fuzz.run("SELECT count(*), sum(v) FROM part",
                   "SELECT count(*), sum(v) FROM flat")
    assert out[0][2] == out[1][2]


def test_vacuum_parent_fans_out(fuzz):
    out = fuzz.run("DELETE FROM part WHERE v = 7", "VACUUM part",
                   "SELECT count(*), sum(v) FROM part",
                   "SELECT count(*), sum(v) FROM flat WHERE v != 7 "
                   "OR v IS NULL")
    assert out[1][3]["placements_rewritten"] > 0
    assert out[2][2] == out[3][2]


def test_legacy_catalog_document_loads(tmp_path):
    """A round-3-shaped catalog document (no indexes or partition keys)
    opens in the port with their defaults, and CREATE INDEX works on it."""
    import citus_tpu_torch as ctt
    d = str(tmp_path / "old")
    cl = ct.Cluster(d)
    cl.execute("CREATE TABLE t (k bigint, v bigint)")
    cl.copy_from("t", rows=[(1, 2)])
    doc = cl.catalog.export_document()
    for sec in ("extensions", "domains", "collations", "publications",
                "statistics", "domain_columns"):
        doc.pop(sec, None)
    for td in doc["tables"]:
        td.pop("indexes", None)
        td.pop("partition_by", None)
        td.pop("partition_of", None)
    cl.close()
    with open(os.path.join(d, "catalog.json"), "w") as fh:
        json.dump(doc, fh)
    port = ctt.Cluster(d, device="cpu")
    try:
        t = port.catalog.table("t")
        assert t.indexes == [] and not t.is_partitioned
        assert port.execute("SELECT v FROM t WHERE k = 1").rows == [(2,)]
        port.execute("CREATE INDEX t_v ON t (v)")
        assert port.execute("SELECT count(*) FROM t WHERE v = 2").rows \
            == [(1,)]
    finally:
        port.close()


# ------------------------------------------- chip_smoke.py phase 11 (a/b/e)

LINEITEM_ROWS = 4000


def _lineitem():
    """chip_smoke.py's generated lineitem at LINEITEM_ROWS: (the
    copy_from columns, the integer arrays the oracles read)."""
    chunks = list(chip_smoke.lineitem_chunks(LINEITEM_ROWS))
    cols = {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}
    return chip_smoke.copy_columns(cols), cols


def test_phase11_time_partitioned_lineitem(tmp_path):
    """Phase 11's load, parent queries and retention at a few thousand
    rows: the monthly partitions of 1992-1998, distributed by
    l_orderkey, Q6 of one month (one survivor), Q6 as written (12
    survivors: the UNION ALL arms), P1 over the parent, the EXPLAIN,
    drop_old_time_partitions and DROP of the parent; the rows also equal
    chip_smoke.py's numpy oracles.  The parent's count after retention
    (72 survivors) is C14's: the port's alone, against numpy's."""
    batch, cols = _lineitem()
    p = Pair(tmp_path)
    try:
        for sql in chip_smoke.PH11_DDL:
            p.step(sql)
        p.step(("copy", "lineitem_m", {"columns": batch}))
        out = p.run(*chip_smoke.PH11_QUERIES.values(),
                    chip_smoke.PH11_EXPLAIN)
        assert out[0][2] == chip_smoke.oracle_q6_month(cols)
        assert out[1][2] == chip_smoke.oracle_q6(cols)
        assert out[2][2] == chip_smoke.oracle_p1(cols)
        text = "\n".join(r[0] for r in out[-1][2])
        assert "partitions: 12/84" in text
        out = p.run(("check", lambda cl: len(cl.catalog.partitions_of(
            "lineitem_m"))),
            chip_smoke.PH11_RETENTION,
            ("check", lambda cl: len(cl.catalog.partitions_of(
                "lineitem_m"))))
        assert (out[0][1], out[1][2], out[2][1]) == (84, [(12,)], 72)
        want = int((cols["ship"] >= chip_smoke._day(1993, 1, 1)).sum())
        assert p.port.execute("SELECT count(*) FROM lineitem_m").rows \
            == [(want,)]
        p.run("DROP TABLE lineitem_m",
              ("check", lambda cl: sorted(n for n in cl.catalog.tables
                                          if n.startswith("lineitem_m"))))
    finally:
        p.close()


def test_c14_parent_of_many_partitions_answers_where_the_reference_nests(
        tmp_path):
    """ROADMAP.md C14: a scan of a parent with more than about 60
    surviving partitions passes the reference's statement depth limit
    (its UNION ALL of the arms nests one statement an arm) and raises
    AnalysisError; the port runs the chain arm by arm and answers.  With
    60 survivors both answer, with identical rows."""
    p = Pair(tmp_path)
    try:
        p.run("CREATE TABLE ev (k bigint, d date, v bigint) "
              "PARTITION BY RANGE (d)",
              "SELECT create_time_partitions('ev', '1 day', '2024-03-11', "
              "'2024-01-01')",
              ("copy", "ev", {"rows": [
                  (i, (datetime.date(2024, 1, 1)
                       + datetime.timedelta(days=i % 70)).isoformat(), i)
                  for i in range(700)]}))
        out = p.run("SELECT count(*), sum(v) FROM ev "
                    "WHERE d < date '2024-03-01'")
        assert out[0][2] == [(600, sum(i for i in range(700)
                                       if i % 70 < 60))]
        with pytest.raises(ct.errors.AnalysisError, match="too deep"):
            p.ref.execute("SELECT count(*), sum(v) FROM ev")
        assert p.port.execute("SELECT count(*), sum(v) FROM ev").rows \
            == [(700, sum(range(700)))]
    finally:
        p.close()
