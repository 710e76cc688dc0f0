"""Views, SQL functions, enum and domain types, publications, schemas,
collations, extensions and their catalog UDFs through the port, held
against the JAX package.

Each test runs the same statements over the same rows through
``citus_tpu`` and ``citus_tpu_torch`` (``device="cpu"``) with
``torch_write_pair.Pair(strict=True)``: rows, the whole ``explain`` dict
of each write (but its timings) and each error's class and message must
be equal.  Rows are compared in order under ORDER BY, else as
multisets; float values within rel 1e-12 (``FLOAT_REL``: an intermediate
table may reorder a float sum), all else exactly.

Also:
- the kernels' generated sources for the statements of this slice (a
  function body inlined into the fold, an enum's rank table in a
  predicate, GROUP BY and ORDER BY) are accepted by the generator and
  compile with g++; an inlined body gives the same source as the
  written-out expression, and an INSERT that grows the enum column's
  dictionary leaves the source unchanged;
- a prepared ``$n`` statement over a function sees CREATE OR REPLACE;
- a type, a function and a view made on one coordinator of a port pair
  (``tests/test_torch_net.py``'s) are used on the other through the
  metadata sync.
"""

import os
import sys

import numpy as np
import pytest

import citus_tpu as ct
import citus_tpu_torch as ctt

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_write_pair import Pair  # noqa: E402

BASE = ("CREATE TABLE base (k bigint NOT NULL, g bigint, v bigint, "
        "amt decimal(8,2), c text)")


def _base_rows(n=60):
    rng = np.random.default_rng(17)
    return [(i, int(rng.integers(0, 5)), int(rng.integers(0, 1000)),
             float(rng.integers(0, 100000)) / 100,
             ["x", "y", "z"][int(rng.integers(0, 3))]) for i in range(n)]


@pytest.fixture()
def db(tmp_path):
    p = Pair(tmp_path, strict=True, n_nodes=2)
    p.run(BASE, "SELECT create_distributed_table('base', 'k', 4)",
          ("copy", "base", {"rows": _base_rows()}),
          "CREATE TABLE other (k bigint NOT NULL, w bigint)",
          "SELECT create_distributed_table('other', 'k', 4)",
          ("copy", "other", {"rows": [(i, i * 3) for i in range(0, 60, 2)]}))
    yield p
    p.close()


# ---------------------------------------------------------------- views

def test_view_nested_join_and_scalar_subquery(db):
    out = db.run(
        "CREATE VIEW totals AS SELECT g, sum(v) AS total, count(*) AS n "
        "FROM base GROUP BY g",
        "SELECT g, total, n FROM totals ORDER BY g",
        "CREATE VIEW big AS SELECT g, total FROM totals WHERE total > 4000",
        "SELECT g, total FROM big ORDER BY g",
        "SELECT count(*) FROM base JOIN big b ON base.g = b.g",
        "SELECT b.g, count(*), sum(base.v) FROM base JOIN totals b "
        "ON base.g = b.g GROUP BY b.g ORDER BY b.g",
        "SELECT g, total FROM totals "
        "WHERE total = (SELECT max(total) FROM totals) ORDER BY g",
        "SELECT k, v FROM base WHERE v > (SELECT avg(total) / 10 FROM big) "
        "ORDER BY k",
        "SELECT citus_views()",
        "DROP VIEW big",
        "SELECT count(*) FROM big",
        "DROP VIEW IF EXISTS big",
        "DROP VIEW big",
        "DROP VIEW totals")
    assert len(out[1][2]) == 5
    assert out[10][0] == "error" and out[12][0] == "error"


def test_view_or_replace_rules(db):
    out = db.run(
        "CREATE VIEW v1 AS SELECT k, v FROM base",
        "CREATE VIEW v1 AS SELECT k, v FROM base",
        # may add a column at the end, same names and types
        "CREATE OR REPLACE VIEW v1 AS SELECT k, v, g FROM base",
        "SELECT k, v, g FROM v1 WHERE k < 4 ORDER BY k",
        # may not drop, rename, reorder or retype one (new sources under
        # the same names and types are a replace)
        "CREATE OR REPLACE VIEW v1 AS SELECT k, v FROM base",
        "CREATE OR REPLACE VIEW v1 AS SELECT k, g AS w, v FROM base",
        "CREATE OR REPLACE VIEW v1 AS SELECT k, c AS v, g FROM base",
        "CREATE OR REPLACE VIEW v1 AS SELECT v AS k, k AS v, g FROM base",
        # nor reference itself
        "CREATE OR REPLACE VIEW v1 AS SELECT k, v, g FROM v1",
        # the body must bind now
        "CREATE VIEW v2 AS SELECT nope FROM base",
        "CREATE VIEW v3 AS SELECT k FROM missing",
        "SELECT citus_views()")
    assert out[1][0] == "error" and out[2][0] == "rows"
    assert [o[0] for o in out[4:11]] == \
        ["error", "error", "error", "rows", "error", "error", "error"]
    assert out[11][2] == [("v1", "SELECT v AS k, k AS v, g FROM base")]


def test_view_over_set_operation_and_cte(db):
    db.run("CREATE VIEW u AS SELECT k FROM base WHERE g = 1 "
           "UNION SELECT k FROM other",
           "SELECT count(*) FROM u",
           "CREATE VIEW w AS WITH t AS (SELECT g, max(v) AS m FROM base "
           "GROUP BY g) SELECT g, m FROM t",
           "SELECT g, m FROM w ORDER BY g",
           "DROP VIEW u", "DROP VIEW w")


def test_circular_view_through_a_replace_is_caught(db):
    db.run("CREATE VIEW a1 AS SELECT k, v FROM base",
           "CREATE VIEW a2 AS SELECT k, v FROM a1",
           "CREATE OR REPLACE VIEW a1 AS SELECT k, v FROM a2",
           "SELECT count(*) FROM a2")


# ------------------------------------------------------------ functions

def test_functions_nested_calls_and_decimal_scale(db):
    out = db.run(
        "CREATE FUNCTION bonus(amount decimal) RETURNS decimal AS "
        "'amount * 1.5'",
        "CREATE FUNCTION net(a decimal, d decimal) RETURNS decimal AS "
        "'bonus(a) - d'",
        "CREATE FUNCTION twice(x bigint) RETURNS bigint AS 'x + x'",
        "SELECT k, bonus(amt), net(amt, 1.25) FROM base WHERE k < 6 "
        "ORDER BY k",
        "SELECT g, sum(bonus(amt)), sum(twice(twice(v))) FROM base "
        "GROUP BY g ORDER BY g",
        "SELECT count(*) FROM base WHERE twice(v) > 900 AND bonus(amt) < 400",
        "SELECT k FROM base WHERE k < 20 UNION SELECT twice(k) FROM other "
        "WHERE k < 10 ORDER BY 1",
        "SELECT twice(21)",
        "SELECT twice(1, 2) FROM base",
        "SELECT bonus() FROM base")
    assert out[3][2][0][1] is not None
    assert out[8][0] == "error" and out[9][0] == "error"


def test_function_or_replace_under_prepared_statement(db):
    out = db.run(
        "CREATE FUNCTION scale(x bigint) RETURNS bigint AS 'x * 2'",
        "PREPARE q AS SELECT sum(scale(v)) FROM base WHERE g = $1",
        "EXECUTE q(1)",
        ("params", "SELECT count(*), sum(scale(v)) FROM base WHERE g = $1",
         [2]),
        "CREATE FUNCTION scale(x bigint) RETURNS bigint AS 'x * 3'",
        "CREATE OR REPLACE FUNCTION scale(x bigint) RETURNS bigint AS "
        "'x * 3'",
        "EXECUTE q(1)",
        ("params", "SELECT count(*), sum(scale(v)) FROM base WHERE g = $1",
         [2]),
        "SELECT sum(scale(v)) FROM base",
        "SELECT sum(scale(v)) FROM base",
        "DROP FUNCTION scale",
        "EXECUTE q(1)",
        "DROP FUNCTION scale",
        "DROP FUNCTION IF EXISTS scale")
    assert out[4][0] == "error"
    (before,), (after,) = out[2][2][0], out[6][2][0]
    assert after * 2 == before * 3
    assert out[11][0] == "error" and out[12][0] == "error"


def test_function_depth_and_argument_count_errors(db):
    out = db.run(
        "CREATE FUNCTION loop1(x bigint) RETURNS bigint AS 'loop1(x) + 1'",
        "SELECT loop1(v) FROM base",
        "CREATE FUNCTION two(a bigint, b bigint) RETURNS bigint AS 'a + b'",
        "SELECT two(v) FROM base",
        "SELECT two(v, 1, 2) FROM base",
        "CREATE FUNCTION sum(x bigint) RETURNS bigint AS 'x'",
        "CREATE FUNCTION bad(x bigint) RETURNS bigint AS 'x +'",
        "CREATE FUNCTION trg() RETURNS trigger AS "
        "'INSERT INTO other VALUES (1, 1)'",
        "SELECT trg() FROM base")
    assert [o[0] for o in out] == ["rows", "error", "rows", "error", "error",
                                   "error", "error", "rows", "error"]


# ---------------------------------------------------------------- enums

def test_enum_ordering_group_by_and_bad_label(db):
    out = db.run(
        "CREATE TYPE sev AS ENUM ('low', 'high', 'critical')",
        "CREATE TYPE sev AS ENUM ('a')",
        "CREATE TYPE dup AS ENUM ('a', 'a')",
        "CREATE TABLE ev (k bigint NOT NULL, s sev, n bigint)",
        "SELECT create_distributed_table('ev', 'k', 4)",
        "INSERT INTO ev VALUES (1, 'high', 5), (2, 'low', 7), "
        "(3, 'critical', 1), (4, 'low', 2), (5, NULL, 9)",
        "SELECT k, s FROM ev WHERE s >= 'high' ORDER BY s, k",
        "SELECT k FROM ev WHERE s < 'critical' ORDER BY k",
        "SELECT s, count(*), sum(n) FROM ev GROUP BY s ORDER BY s",
        "SELECT s, count(*) FROM ev GROUP BY s ORDER BY s DESC",
        "SELECT k, s FROM ev ORDER BY s DESC, k",
        "SELECT max(n) FROM ev WHERE s = 'low'",
        "INSERT INTO ev VALUES (6, 'bogus', 1)",
        "SELECT count(*) FROM ev WHERE s > 'bogus'",
        "SELECT count(*) FROM ev",
        ("copy", "ev", {"rows": [(7, "nope", 1)]}),
        ("copy", "ev", {"rows": [(7, "critical", 3), (8, "high", 4)]}),
        "SELECT s, count(*) FROM ev GROUP BY s ORDER BY s",
        "UPDATE ev SET s = 'critical' WHERE k = 2",
        "SELECT k, s FROM ev ORDER BY s, k",
        "SELECT citus_types()",
        "DROP TYPE sev",
        "DROP TABLE ev",
        "DROP TYPE sev",
        "DROP TYPE sev",
        "DROP TYPE IF EXISTS sev",
        "SELECT citus_types()")
    assert [r[0] for r in out[8][2]] == ["low", "high", "critical", None]
    assert out[12][0] == "error" and out[13][0] == "error"
    assert out[15][0] == "error"
    assert out[21][0] == "error" and out[23][0] == "rows"


def test_enum_and_domain_add_column(db):
    out = db.run(
        "CREATE TYPE mood AS ENUM ('sad', 'ok', 'happy')",
        "CREATE DOMAIN pos AS bigint CHECK (VALUE > 0)",
        "ALTER TABLE other ADD COLUMN m mood",
        "ALTER TABLE other ADD COLUMN p pos",
        "INSERT INTO other VALUES (101, 1, 'happy', 3), (103, 2, 'sad', 4)",
        "INSERT INTO other VALUES (105, 1, 'meh', 3)",
        "INSERT INTO other VALUES (105, 1, 'ok', 0)",
        "SELECT m, count(*), sum(p) FROM other GROUP BY m ORDER BY m",
        "SELECT k FROM other WHERE m > 'sad' ORDER BY k",
        "DROP TYPE mood",
        "DROP DOMAIN pos",
        "ALTER TABLE other DROP COLUMN m",
        "SELECT citus_domains()")
    assert out[5][0] == "error" and out[6][0] == "error"
    assert [r[0] for r in out[7][2]] == ["sad", "happy", None]
    assert out[9][0] == "error" and out[10][0] == "error"


# -------------------------------------------------------------- domains

def test_domain_insert_copy_update_null_and_drop(db):
    out = db.run(
        "CREATE DOMAIN custkey_t AS bigint CHECK (VALUE >= 0)",
        "CREATE DOMAIN custkey_t AS bigint",
        "CREATE DOMAIN code_t AS text NOT NULL CHECK (length(VALUE) = 3)",
        "CREATE TABLE o (k bigint NOT NULL, ck custkey_t, code code_t)",
        "SELECT create_distributed_table('o', 'k', 4)",
        "INSERT INTO o VALUES (1, 10, 'abc'), (2, NULL, 'xyz')",
        "INSERT INTO o VALUES (3, -1, 'abc')",
        "INSERT INTO o VALUES (3, 5, 'abcd')",
        "INSERT INTO o VALUES (3, 5, NULL)",
        ("copy", "o", {"columns": {"k": np.arange(10, 20),
                                   "ck": np.arange(10) * 7,
                                   "code": ["aaa"] * 10}}),
        ("copy", "o", {"columns": {"k": np.arange(20, 23),
                                   "ck": np.array([1, -2, 3]),
                                   "code": ["aaa"] * 3}}),
        "SELECT count(*), sum(ck), count(ck) FROM o",
        "UPDATE o SET ck = ck + 100 WHERE k >= 10",
        "UPDATE o SET ck = ck - 1000 WHERE k = 12",
        "UPDATE o SET code = 'toolong' WHERE k = 1",
        "UPDATE o SET ck = NULL WHERE k = 1",
        "SELECT k, ck, code FROM o ORDER BY k",
        "SELECT citus_domains()",
        "DROP DOMAIN custkey_t",
        "DROP TABLE o",
        "DROP DOMAIN custkey_t",
        "DROP DOMAIN IF EXISTS custkey_t",
        "DROP DOMAIN custkey_t",
        "SELECT citus_domains()")
    assert [o[0] for o in out[6:9]] == ["error"] * 3
    assert out[10][0] == "error"
    assert out[11][2] == [(12, 325, 11)]
    assert out[13][0] == "error" and out[14][0] == "error"
    assert out[18][0] == "error" and out[20][0] == "rows"
    assert out[22][0] == "error"


# ---------------------------------- publications, schemas, collations, ...

def _cdc_ops(cl, table):
    """The change stream of ``table`` without its LSNs and clocks."""
    return [(e["op"], e.get("rows"), e.get("count"))
            for e in cl.cdc.events(table)]


def test_publication_feeds_cdc(tmp_path):
    p = Pair(tmp_path, strict=True, n_nodes=2)
    try:
        out = p.run(
            "CREATE TABLE pt (k bigint NOT NULL, v bigint)",
            "SELECT create_distributed_table('pt', 'k', 2)",
            "CREATE TABLE quiet (k bigint NOT NULL)",
            "SELECT create_distributed_table('quiet', 'k', 2)",
            "INSERT INTO pt VALUES (1, 1)",
            ("check", lambda cl: cl._cdc_captures("pt")),
            "CREATE PUBLICATION pub FOR TABLE pt",
            "CREATE PUBLICATION pub FOR TABLE pt",
            "CREATE PUBLICATION bad FOR TABLE missing",
            ("check", lambda cl: (cl._cdc_captures("pt"),
                                  cl._cdc_captures("quiet"))),
            "INSERT INTO pt VALUES (2, 2), (3, 3)",
            "INSERT INTO quiet VALUES (9)",
            "UPDATE pt SET v = 5 WHERE k = 2",
            "DELETE FROM pt WHERE k = 3",
            ("check", lambda cl: (_cdc_ops(cl, "pt"),
                                  _cdc_ops(cl, "quiet"))),
            "CREATE PUBLICATION everything FOR ALL TABLES",
            ("check", lambda cl: cl._cdc_captures("quiet")),
            "SELECT citus_publications()",
            "DROP PUBLICATION pub",
            "DROP PUBLICATION everything",
            "DROP PUBLICATION pub",
            "DROP PUBLICATION IF EXISTS pub",
            ("check", lambda cl: cl._cdc_captures("pt")),
            "SELECT citus_publications()")
        assert out[5][1] is False and out[9][1] == (True, False)
        assert out[16][1] is True and out[22][1] is False
        assert [e[0] for e in out[14][1][0]] == \
            ["insert", "update", "delete"]
        assert out[14][1][1] == []
    finally:
        p.close()


def test_schemas_collations_extensions_and_inventories(db):
    out = db.run(
        "CREATE SCHEMA sales",
        "CREATE SCHEMA sales",
        "CREATE SCHEMA IF NOT EXISTS sales",
        "CREATE TABLE sales.orders (k bigint NOT NULL, v bigint)",
        "SELECT create_distributed_table('sales.orders', 'k', 2)",
        "INSERT INTO sales.orders VALUES (1, 2), (3, 4)",
        "SELECT sum(v) FROM sales.orders",
        ("check", lambda cl: [(r[0], r[3]) for r in
                              cl.execute("SELECT citus_schemas()").rows]),
        "CREATE COLLATION de (locale = 'de_DE', provider = 'icu')",
        "CREATE COLLATION de (locale = 'de_DE')",
        "SELECT citus_collations()",
        "CREATE EXTENSION citus",
        "CREATE EXTENSION citus",
        "CREATE EXTENSION IF NOT EXISTS citus",
        "CREATE EXTENSION hll VERSION '2.18'",
        "SELECT citus_extensions()",
        "CREATE STATISTICS st ON g, c FROM base",
        "SELECT citus_statistics_objects()",
        "CREATE TYPE t1 AS ENUM ('a', 'b')",
        "SELECT citus_types()",
        "CREATE VIEW vv AS SELECT k FROM base",
        "SELECT citus_views()",
        "SELECT citus_sequences()",
        "DROP SCHEMA sales",
        "DROP SCHEMA sales CASCADE",
        "SELECT count(*) FROM sales.orders",
        "DROP COLLATION de", "DROP COLLATION de",
        "DROP EXTENSION hll", "DROP EXTENSION IF EXISTS hll",
        "SELECT citus_collations()", "SELECT citus_extensions()")
    assert out[1][0] == "error" and out[2][0] == "rows"
    assert out[7][1] == [("sales", 1)]
    assert out[23][0] == "error" and out[25][0] == "error"


@pytest.mark.parametrize("sql", [
    "CREATE ROLE analyst",
    "GRANT SELECT ON base TO analyst",
    "CREATE POLICY p ON base USING (g = 1)",
    "ALTER TABLE base ENABLE ROW LEVEL SECURITY",
    "CREATE TEXT SEARCH CONFIGURATION english2 (COPY = simple)",
    "SELECT citus_roles()",
])
def test_rls_roles_and_triggers_stay_refused_naming_a14b(tmp_path, sql):
    """Ported since A14b (tests/test_torch_policies.py): each statement
    now runs in both packages with the same outcome, and the catalog
    inventories that follow it are the reference's."""
    outs = []
    for pkg in (ct, ctt):
        kw = {"device": "cpu"} if pkg is ctt else {}
        cl = pkg.Cluster(str(tmp_path / pkg.__name__), **kw)
        try:
            cl.execute(BASE)
            if "ROLE" not in sql:
                cl.execute("CREATE ROLE analyst")
            got = [cl.execute(sql).rows]
            for udf in ("citus_roles", "citus_grants", "citus_policies",
                        "citus_text_search_configs"):
                got.append(cl.execute(f"SELECT {udf}()").rows)
            outs.append(got)
        finally:
            cl.close()
    assert outs[1] == outs[0]


# ------------------------------------------ the kernels' generated rows

def _fold_sources(cl, sqls, monkeypatch) -> dict:
    """Each SELECT through the port with every fold and insert program it
    runs recorded: -> {sql: sorted row sources}."""
    from test_torch_fold_codegen import _recorded_sources
    out = {}
    for sql in sqls:
        seen = _recorded_sources(monkeypatch)
        cl.execute(sql)
        out[sql] = sorted(seen)
        monkeypatch.undo()
    return out


def _predicate_sources(cl, sqls, monkeypatch) -> dict:
    """Each SELECT through the port with every predicate program it
    runs recorded: -> {sql: sorted predicate sources}."""
    from citus_tpu_torch.ops import filter_mask as fm
    plain = fm.filter_mask_plain
    out = {}
    for sql in sqls:
        seen = {}

        def record(prog, *args):
            seen[prog.predicate.source] = prog
            return plain(prog, *args)
        monkeypatch.setattr(fm, "filter_mask_plain", record)
        cl.execute(sql)
        out[sql] = sorted(seen)
        monkeypatch.undo()
    return out


def test_inlined_body_and_enum_ranks_generate(tmp_path, monkeypatch):
    """A function body inlined into a fold gives the written-out
    expression's source; the enum's rank table lives in the parameter
    block, so growing the column's dictionary keeps the source; every
    source compiles with g++."""
    from test_torch_fold_codegen import _harness
    cl = ctt.Cluster(str(tmp_path / "db"), device="cpu")
    try:
        cl.execute("CREATE TYPE prio AS ENUM ('L', 'M', 'H')")
        cl.execute("CREATE TABLE e (k bigint NOT NULL, f prio, "
                   "p decimal(12,2), d decimal(12,2))")
        cl.execute("SELECT create_distributed_table('e', 'k', 4)")
        rng = np.random.default_rng(3)
        n = 4000
        cl.copy_from("e", columns={
            "k": np.arange(n), "f": np.array(["L", "M"])[rng.integers(0, 2, n)],
            "p": rng.integers(100, 10**6, n) / 100,
            "d": rng.integers(0, 10, n) / 100})
        cl.execute("CREATE FUNCTION disc(p decimal, d decimal) RETURNS "
                   "decimal AS 'p * (1 - d)'")
        inlined = "SELECT f, sum(disc(p, d)) FROM e GROUP BY f ORDER BY f"
        written = "SELECT f, sum(p * (1 - d)) FROM e GROUP BY f ORDER BY f"
        ranked = "SELECT count(*), sum(p) FROM e WHERE f >= 'M'"
        folds = _fold_sources(cl, [inlined, written, ranked], monkeypatch)
        assert folds[inlined] and folds[inlined] == folds[written]
        assert cl.execute(inlined).rows == cl.execute(written).rows
        preds = _predicate_sources(
            cl, ["SELECT k FROM e WHERE f > 'L' AND k < 40 ORDER BY k"],
            monkeypatch)
        assert all(preds.values())
        # the dictionary grows by 'H': the rank table lengthens, the
        # generated sources stay
        cl.execute("INSERT INTO e VALUES (900001, 'H', 1.00, 0.01)")
        again = _fold_sources(cl, [ranked], monkeypatch)
        assert again[ranked] == folds[ranked]
        assert _predicate_sources(cl, list(preds), monkeypatch) == preds
        assert cl.execute(ranked).rows[0][0] == \
            int(cl.execute("SELECT count(*) FROM e WHERE f = 'M' "
                           "OR f = 'H'").rows[0][0])
    finally:
        cl.close()
    sources = sorted({s for v in folds.values() for s in v})
    _harness({f"s{i}": s for i, s in enumerate(sources)}, tmp_path)


# ------------------------------------------------- two coordinators

def test_objects_made_on_one_coordinator_are_used_on_the_other(tmp_path):
    """B (attached) makes an enum type, a function and a view; A (the
    metadata authority) reads them after its sync.  The view is read on
    A: an intermediate table of a coordinator that is not the authority
    is not found by the authority, in both packages (ROADMAP.md C20)."""
    from test_torch_net import _open_pair

    from citus_tpu_torch.errors import AnalysisError
    a, b = _open_pair(tmp_path)
    try:
        b.execute("CREATE TYPE lvl AS ENUM ('lo', 'mid', 'hi')")
        b.execute("CREATE TABLE m (k bigint NOT NULL, l lvl, v bigint)")
        b.execute("SELECT create_distributed_table('m', 'k', 4)")
        b.copy_from("m", rows=[(i, ["lo", "mid", "hi"][i % 3], i)
                               for i in range(300)])
        b.execute("CREATE FUNCTION dbl(x bigint) RETURNS bigint AS 'x * 2'")
        b.execute("CREATE VIEW hi_m AS SELECT k, dbl(v) AS w FROM m "
                  "WHERE l >= 'mid'")
        want = [(200, 2 * sum(i for i in range(300) if i % 3))]
        assert b.execute("SELECT count(*), sum(dbl(v)) FROM m "
                         "WHERE l >= 'mid'").rows == want
        a._maybe_reload_catalog(force_sync=True)
        assert a.execute("SELECT count(*), sum(w) FROM hi_m").rows == want
        assert a.execute("SELECT l, count(*) FROM m GROUP BY l "
                         "ORDER BY l DESC").rows == \
            [("hi", 100), ("mid", 100), ("lo", 100)]
        with pytest.raises(AnalysisError):
            a.execute("INSERT INTO m VALUES (1000, 'top', 1)")
    finally:
        b.close()
        a.close()



# ------------------------------------------------ chip_smoke.py phase 13

def test_chip_smoke_phase13_rehearses_on_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's phase 13 whole on a CPU cluster at a small size
    (its checks against numpy and the cpu backend, no profiled run), and
    its rehearsal's fold and insert sources compile with g++."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    from test_torch_fold_codegen import _harness
    cl = ctt.Cluster(str(tmp_path / "db"), device="cpu")
    try:
        cl.execute(chip_smoke.LINEITEM_DDL)
        cl.execute("SELECT create_distributed_table('lineitem', "
                   f"'l_orderkey', {chip_smoke.SHARDS})")
        chunk = next(chip_smoke.lineitem_chunks(40_000))
        cl.copy_from("lineitem", columns=chip_smoke.copy_columns(chunk))
        chip_smoke.load_orders_b(cl, 10_000)
        launches = dict.fromkeys(chip_smoke.launch_counters(), 0)
        chip_smoke.run_phase13(cl, chunk, 10_000, launches, "cpu", [],
                               profile=False)
        assert not any(n in cl.catalog.tables for n in ("orders_e", "prio_g"))
        assert not cl.catalog.views and not cl.catalog.functions
    finally:
        cl.close()
    sources = chip_smoke.phase13_sources(str(tmp_path), 10_000)
    folds = {f"s{i}": src for i, (build, src) in enumerate(sources)
             if build != "filter_mask"}
    assert folds and len(folds) < len(sources)
    _harness(folds, tmp_path)
