"""Roles, GRANT / REVOKE, row-level security, statement triggers and
text-search configurations through the port, against the JAX package.

Each test is one of tests/test_policies_triggers.py (and the role tests
of test_breadth2.py, test_advice_fixes.py, test_upsert_distinct_on.py
and test_prepare_execute.py) with every step run through
``citus_tpu.Cluster`` and ``citus_tpu_torch.Cluster(device="cpu")`` by
``tests/torch_write_pair.py Pair(strict=True)``: rows, write counts,
error classes and messages must be equal, and the values the original
test asserts are asserted on the reference's outcome.  A policy's read
runs through a derived table whose WHERE is the policy (generated into
B4 / B1 / B2 on the card); a modify's policy is ANDed into its WHERE.

The leak check: the same SQL text as superuser (warm), under a tenant
role, then as superuser again, each returning its own rows, with the
text-keyed plan cache, the ``$n`` generic plan, the device cache and the
megabatch queues warm between the calls.
"""

import os
import sys
import threading

import numpy as np
import pytest

import citus_tpu as ct
import citus_tpu_torch as ctt

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_write_pair import Pair  # noqa: E402

DOCS = {"k": np.arange(100), "owner_id": np.arange(100) % 4,
        "v": np.arange(100)}


def _rows(outcome):
    assert outcome[0] == "rows", outcome
    return outcome[2]


def _error(outcome, cls, text=""):
    assert outcome[0] == "error" and outcome[1] == cls, outcome
    assert text in outcome[2], outcome


@pytest.fixture()
def db(tmp_path):
    p = Pair(tmp_path, strict=True, n_nodes=2)
    p.run("CREATE TABLE docs (k bigint NOT NULL, owner_id bigint, v bigint)",
          "SELECT create_distributed_table('docs', 'k', 4)",
          ("copy", "docs", {"columns": DOCS}),
          "CREATE ROLE app",
          "GRANT SELECT, INSERT, UPDATE, DELETE ON docs TO app")
    yield p
    p.close()


def _reopen(tmp_path, name="db"):
    return (ct.Cluster(str(tmp_path / "ref" / name), n_nodes=2),
            ctt.Cluster(str(tmp_path / "port" / name), device="cpu",
                        n_nodes=2))


# ------------------------------------------------------------ policies

def test_rls_default_deny_and_policy_filter(db):
    db.step("ALTER TABLE docs ENABLE ROW LEVEL SECURITY")
    assert _rows(db.step(("role", "SELECT count(*) FROM docs", "app"))) \
        == [(0,)]
    assert _rows(db.step("SELECT count(*) FROM docs")) == [(100,)]
    db.step("CREATE POLICY own ON docs USING (owner_id = 2)")
    assert _rows(db.step(("role", "SELECT count(*) FROM docs", "app"))) \
        == [(25,)]
    got = db.step(("role", "SELECT sum(v) FROM docs WHERE v < 50", "app"))
    assert _rows(got) == [(sum(v for v in range(50) if v % 4 == 2),)]


def test_rls_policies_are_permissive_or(db):
    db.run("ALTER TABLE docs ENABLE ROW LEVEL SECURITY",
           "CREATE POLICY p1 ON docs USING (owner_id = 1)",
           "CREATE POLICY p2 ON docs USING (owner_id = 3)")
    assert _rows(db.step(("role", "SELECT count(*) FROM docs", "app"))) \
        == [(50,)]


def test_rls_role_scoped_policy(db):
    db.run("CREATE ROLE other", "GRANT SELECT ON docs TO other",
           "ALTER TABLE docs ENABLE ROW LEVEL SECURITY",
           "CREATE POLICY justapp ON docs TO app USING (owner_id = 0)")
    assert _rows(db.step(("role", "SELECT count(*) FROM docs", "app"))) \
        == [(25,)]
    assert _rows(db.step(("role", "SELECT count(*) FROM docs", "other"))) \
        == [(0,)]


def test_rls_update_delete(db):
    db.run("ALTER TABLE docs ENABLE ROW LEVEL SECURITY",
           "CREATE POLICY own ON docs USING (owner_id = 2)",
           ("role", "UPDATE docs SET v = v + 1000 WHERE v < 10", "app"))
    assert _rows(db.step("SELECT count(*) FROM docs WHERE v >= 1000")) \
        == [(2,)]
    db.step(("role", "DELETE FROM docs WHERE v >= 1000", "app"))
    assert _rows(db.step("SELECT count(*) FROM docs")) == [(98,)]
    db.step("DELETE FROM docs WHERE v < 10")
    assert _rows(db.step("SELECT count(*) FROM docs WHERE v < 10")) \
        == [(0,)]


def test_rls_insert_with_check(db):
    db.run("ALTER TABLE docs ENABLE ROW LEVEL SECURITY",
           "CREATE POLICY own ON docs USING (owner_id = 2)",
           ("role", "INSERT INTO docs VALUES (200, 2, 7)", "app"))
    _error(db.step(("role", "INSERT INTO docs VALUES (201, 3, 7)", "app")),
           "AnalysisError", "violates row-level security")
    db.step("INSERT INTO docs VALUES (202, 3, 7)")
    assert _rows(db.step("SELECT count(*) FROM docs WHERE k >= 200")) \
        == [(2,)]


def test_rls_in_joins(db):
    db.run("CREATE TABLE tags (tk bigint NOT NULL, doc_k bigint, lbl text)",
           "SELECT create_distributed_table('tags', 'tk', 4)",
           ("copy", "tags", {"columns": {"tk": np.arange(20),
                                         "doc_k": np.arange(20),
                                         "lbl": ["x"] * 20}}),
           "GRANT SELECT ON tags TO app",
           "ALTER TABLE docs ENABLE ROW LEVEL SECURITY",
           "CREATE POLICY own ON docs USING (owner_id = 2)")
    got = db.step(("role", "SELECT count(*) FROM docs d JOIN tags g "
                   "ON d.k = g.doc_k", "app"))
    assert _rows(got) == [(5,)]


def test_drop_policy_and_disable(db):
    db.run("ALTER TABLE docs ENABLE ROW LEVEL SECURITY",
           "CREATE POLICY own ON docs USING (owner_id = 2)",
           "DROP POLICY own ON docs")
    assert _rows(db.step(("role", "SELECT count(*) FROM docs", "app"))) \
        == [(0,)]
    db.step("ALTER TABLE docs DISABLE ROW LEVEL SECURITY")
    assert _rows(db.step(("role", "SELECT count(*) FROM docs", "app"))) \
        == [(100,)]
    _error(db.step("DROP POLICY nope ON docs"), "CatalogError")
    db.step("DROP POLICY IF EXISTS nope ON docs")


def test_policies_view_and_persistence(db, tmp_path):
    db.run("ALTER TABLE docs ENABLE ROW LEVEL SECURITY",
           "CREATE POLICY own ON docs FOR SELECT TO app "
           "USING (owner_id = 1)")
    assert _rows(db.step("SELECT citus_policies()")) == [
        ("docs", "own", "select", "app", "owner_id = 1", None)]
    db.close()
    ref, port = _reopen(tmp_path)
    try:
        sql = "SELECT count(*) FROM docs"
        assert port.execute(sql, role="app").rows \
            == ref.execute(sql, role="app").rows == [(25,)]
    finally:
        port.close()
        ref.close()


# ------------------------------------------------------------ triggers

def test_statement_trigger_fires(db):
    db.run("CREATE TABLE audit (n bigint)",
           "CREATE FUNCTION log_ins() RETURNS trigger AS "
           "'INSERT INTO audit VALUES (1)'",
           "CREATE TRIGGER t_ins AFTER INSERT ON docs "
           "FOR EACH STATEMENT EXECUTE FUNCTION log_ins()",
           "INSERT INTO docs VALUES (300, 0, 0), (301, 0, 0)")
    assert _rows(db.step("SELECT count(*) FROM audit")) == [(1,)]
    db.step("UPDATE docs SET v = 1 WHERE k = 300")
    assert _rows(db.step("SELECT count(*) FROM audit")) == [(1,)]
    db.run("DROP TRIGGER t_ins ON docs", "INSERT INTO docs VALUES (302, 0, 0)")
    assert _rows(db.step("SELECT count(*) FROM audit")) == [(1,)]


def test_trigger_events_and_view(db):
    db.run("CREATE TABLE audit (n bigint)",
           "CREATE FUNCTION log_any() RETURNS trigger AS "
           "'INSERT INTO audit VALUES (1)'",
           "CREATE TRIGGER t_u AFTER UPDATE ON docs "
           "EXECUTE FUNCTION log_any()",
           "CREATE TRIGGER t_d AFTER DELETE ON docs "
           "EXECUTE FUNCTION log_any()")
    assert _rows(db.step("SELECT citus_triggers()")) == [
        ("t_d", "docs", "delete", "log_any"),
        ("t_u", "docs", "update", "log_any")]
    db.run("UPDATE docs SET v = 0 WHERE k = 1", "DELETE FROM docs WHERE k = 2")
    assert _rows(db.step("SELECT count(*) FROM audit")) == [(2,)]


def test_trigger_recursion_limited(db):
    db.run("CREATE TABLE loopt (n bigint)",
           "CREATE FUNCTION loop_fn() RETURNS trigger AS "
           "'INSERT INTO loopt VALUES (1)'",
           "CREATE TRIGGER t_loop AFTER INSERT ON loopt "
           "EXECUTE FUNCTION loop_fn()")
    _error(db.step("INSERT INTO loopt VALUES (0)"), "ExecutionError",
           "trigger recursion limit exceeded (8 levels)")
    # the rows of the eight levels that ran stay, as in the reference
    db.step("SELECT count(*) FROM loopt")


def test_trigger_requires_trigger_function(db):
    db.step("CREATE FUNCTION notrig(x bigint) RETURNS bigint AS 'x + 1'")
    _error(db.step("CREATE TRIGGER bad AFTER INSERT ON docs "
                   "EXECUTE FUNCTION notrig()"),
           "CatalogError", "not a trigger function")
    db.step("CREATE FUNCTION trg() RETURNS trigger AS "
            "'INSERT INTO docs VALUES (1, 1, 1)'")
    _error(db.step("SELECT trg() FROM docs"), "AnalysisError",
           "trigger function")


def test_merge_fires_all_three_triggers(db):
    """MERGE fires the INSERT, UPDATE and DELETE statement triggers."""
    db.run("CREATE TABLE audit (n bigint)",
           "CREATE TABLE src (k bigint NOT NULL, v bigint)",
           "SELECT create_distributed_table('src', 'k', 4, 'docs')",
           "INSERT INTO src VALUES (1, 5), (500, 6)",
           "CREATE FUNCTION log_any() RETURNS trigger AS "
           "'INSERT INTO audit VALUES (1)'")
    for ev in ("INSERT", "UPDATE", "DELETE"):
        db.step(f"CREATE TRIGGER t_{ev.lower()} AFTER {ev} ON docs "
                "EXECUTE FUNCTION log_any()")
    db.step("MERGE INTO docs d USING src s ON d.k = s.k "
            "WHEN MATCHED THEN UPDATE SET v = s.v "
            "WHEN NOT MATCHED THEN INSERT VALUES (s.k, 0, s.v)")
    assert _rows(db.step("SELECT count(*) FROM audit")) == [(3,)]


def test_upsert_fires_update_trigger_and_runs_in_a_transaction(db):
    """ON CONFLICT DO UPDATE fires the UPDATE triggers besides the
    INSERT ones; inside BEGIN..COMMIT the trigger's rows commit with the
    statement's, and roll back with them."""
    db.run("CREATE TABLE kv (k bigint NOT NULL PRIMARY KEY, v bigint)",
           "CREATE TABLE audit (n bigint)",
           "CREATE FUNCTION log_any() RETURNS trigger AS "
           "'INSERT INTO audit VALUES (1)'",
           "CREATE TRIGGER t_i AFTER INSERT ON kv EXECUTE FUNCTION log_any()",
           "CREATE TRIGGER t_u AFTER UPDATE ON kv EXECUTE FUNCTION log_any()",
           "INSERT INTO kv VALUES (1, 1) ON CONFLICT (k) "
           "DO UPDATE SET v = excluded.v")
    assert _rows(db.step("SELECT count(*) FROM audit")) == [(2,)]
    db.run(("s", "BEGIN"), ("s", "INSERT INTO kv VALUES (2, 2)"),
           ("s", "COMMIT"), ("s", "BEGIN"), ("s", "DELETE FROM kv"),
           ("s", "INSERT INTO kv VALUES (3, 3)"), ("s", "ROLLBACK"))
    assert _rows(db.step("SELECT count(*) FROM audit")) == [(3,)]
    assert _rows(db.step("SELECT k, v FROM kv ORDER BY k")) \
        == [(1, 1), (2, 2)]


# ------------------------------------------- text search configurations

def test_text_search_configurations(db, tmp_path):
    db.run("CREATE TEXT SEARCH CONFIGURATION english_fast "
           "(PARSER = default)",
           "CREATE TEXT SEARCH CONFIGURATION english_copy "
           "(COPY = english_fast)")
    assert _rows(db.step("SELECT citus_text_search_configs()")) == [
        ("english_copy", "default"), ("english_fast", "default")]
    _error(db.step("CREATE TEXT SEARCH CONFIGURATION english_fast "
                   "(PARSER = default)"), "CatalogError", "already exists")
    _error(db.step("CREATE TEXT SEARCH CONFIGURATION bad (COPY = missing)"),
           "CatalogError", "does not exist")
    db.run("DROP TEXT SEARCH CONFIGURATION english_copy",
           "DROP TEXT SEARCH CONFIGURATION IF EXISTS english_copy")
    _error(db.step("DROP TEXT SEARCH CONFIGURATION english_copy"),
           "CatalogError")
    db.close()
    ref, port = _reopen(tmp_path)
    try:
        sql = "SELECT citus_text_search_configs()"
        assert port.execute(sql).rows == ref.execute(sql).rows \
            == [("english_fast", "default")]
    finally:
        port.close()
        ref.close()


# ------------------------------------- review-finding regressions (RLS)

def test_rls_no_bypass_via_setops_and_subqueries(db):
    db.run("CREATE TABLE pub (k bigint)", "INSERT INTO pub VALUES (2)",
           "GRANT SELECT ON pub TO app",
           "ALTER TABLE docs ENABLE ROW LEVEL SECURITY",
           "CREATE POLICY own ON docs USING (owner_id = 2)")
    r = _rows(db.step(("role", "SELECT count(*) FROM docs UNION ALL "
                       "SELECT 0", "app")))
    assert (25,) in r and (100,) not in r
    assert _rows(db.step(("role", "SELECT (SELECT count(*) FROM docs) "
                          "FROM pub", "app"))) == [(25,)]
    assert _rows(db.step(("role", "SELECT count(*) FROM pub WHERE k IN "
                          "(SELECT owner_id FROM docs)", "app"))) == [(1,)]
    assert _rows(db.step(("role", "SELECT count(*) FROM pub WHERE k IN "
                          "(SELECT v FROM docs WHERE owner_id = 3)",
                          "app"))) == [(0,)]
    assert _rows(db.step(("role", "WITH c AS (SELECT v FROM docs) "
                          "SELECT count(*) FROM c", "app"))) == [(25,)]


def test_rls_update_cannot_escape_policy(db):
    db.run("ALTER TABLE docs ENABLE ROW LEVEL SECURITY",
           "CREATE POLICY own ON docs USING (owner_id = 2)")
    _error(db.step(("role", "UPDATE docs SET owner_id = 99 WHERE k = 2",
                    "app")), "AnalysisError", "violates row-level security")
    db.run(("role", "UPDATE docs SET owner_id = 2 WHERE k = 2", "app"),
           ("role", "UPDATE docs SET v = v + 1 WHERE k = 2", "app"),
           "UPDATE docs SET owner_id = 99 WHERE k = 3",
           "SELECT k, owner_id, v FROM docs WHERE k < 4 ORDER BY k")


def test_rls_parameterized_insert(db):
    db.run("ALTER TABLE docs ENABLE ROW LEVEL SECURITY",
           "CREATE POLICY own ON docs USING (owner_id = 2)",
           ("rparams", "INSERT INTO docs VALUES ($1, $2, $3)", [400, 2, 7],
            "app"))
    _error(db.step(("rparams", "INSERT INTO docs VALUES ($1, $2, $3)",
                    [401, 3, 7], "app")),
           "AnalysisError", "violates row-level security")


def test_replace_or_drop_trigger_function_guarded(db):
    db.run("CREATE TABLE audit (n bigint)",
           "CREATE FUNCTION tf() RETURNS trigger AS "
           "'INSERT INTO audit VALUES (1)'",
           "CREATE TRIGGER tr AFTER INSERT ON docs EXECUTE FUNCTION tf()")
    _error(db.step("CREATE OR REPLACE FUNCTION tf(x bigint) "
                   "RETURNS bigint AS 'x + 1'"), "CatalogError", "depend")
    _error(db.step("DROP FUNCTION tf"), "CatalogError", "depend")
    db.run("DROP TRIGGER tr ON docs", "DROP FUNCTION tf")


def test_rls_applies_inside_dml_subqueries(db):
    db.run("CREATE TABLE sink (k bigint, v bigint)",
           "GRANT SELECT, INSERT, UPDATE, DELETE ON sink TO app",
           "ALTER TABLE docs ENABLE ROW LEVEL SECURITY",
           "CREATE POLICY own ON docs USING (owner_id = 2)",
           ("role", "INSERT INTO sink SELECT k, v FROM docs", "app"))
    assert _rows(db.step("SELECT count(*) FROM sink")) == [(25,)]
    db.run("DELETE FROM sink", "INSERT INTO sink VALUES (1, 0), (3, 0)",
           ("role", "UPDATE sink SET v = 99 WHERE k IN "
            "(SELECT owner_id FROM docs)", "app"))
    assert _rows(db.step("SELECT k, v FROM sink ORDER BY k")) \
        == [(1, 0), (3, 0)]
    db.step(("role", "DELETE FROM sink WHERE k IN (SELECT owner_id FROM "
             "docs WHERE owner_id = 3)", "app"))
    assert _rows(db.step("SELECT count(*) FROM sink")) == [(2,)]


def test_rls_insert_select_into_policy_table_is_refused(db):
    db.run("ALTER TABLE docs ENABLE ROW LEVEL SECURITY",
           "CREATE POLICY own ON docs USING (owner_id = 2)")
    _error(db.step(("role", "INSERT INTO docs SELECT k + 500, owner_id, v "
                    "FROM docs", "app")),
           "UnsupportedFeatureError", "under row-level security")


def test_cte_shadowing_cannot_bypass_privileges(db):
    db.run("CREATE TABLE secret (x bigint)", "INSERT INTO secret VALUES (42)")
    _error(db.step(("role", "WITH secret AS (SELECT x FROM secret) "
                    "SELECT count(*) FROM secret", "app")),
           "CatalogError", "permission denied")


def test_cte_shadowing_rls_table_is_the_cte(db):
    db.run("ALTER TABLE docs ENABLE ROW LEVEL SECURITY",
           "CREATE POLICY own ON docs USING (owner_id = 2)")
    assert _rows(db.step(("role", "WITH docs AS (SELECT 1 AS x) "
                          "SELECT x FROM docs", "app"))) == [(1,)]


@pytest.mark.parametrize("pkg", ["citus_tpu", "citus_tpu_torch"])
def test_policy_merge_is_per_policy(tmp_path, pkg):
    """Two coordinators on one data directory add policies through the
    catalog flock: both survive the commit-time merge, and a drop does
    not come back through the other.  The port's steps are the
    reference's, each package on a directory of its own."""
    mod = ct if pkg == "citus_tpu" else ctt
    kw = {"n_nodes": 2} if mod is ct else {"n_nodes": 2, "device": "cpu"}
    a = mod.Cluster(str(tmp_path / "db"), **kw)
    b = mod.Cluster(str(tmp_path / "db"), **kw)
    try:
        a.execute("CREATE TABLE t (k bigint, owner bigint)")
        a.execute("CREATE POLICY p1 ON t USING (owner = 1)")
        b.execute("CREATE POLICY p2 ON t USING (owner = 2)")
        a.execute("CREATE TABLE t2 (x bigint)")
        assert {p["name"] for p in a.catalog.policies.get("t", [])} \
            == {"p1", "p2"}
        a.execute("DROP POLICY p1 ON t")
        b.execute("CREATE TABLE t3 (x bigint)")
        a.execute("CREATE TABLE t4 (x bigint)")
        assert {p["name"] for p in a.catalog.policies.get("t", [])} \
            == {"p2"}
    finally:
        b.close()
        a.close()


def test_drop_table_drops_its_policies_rls_and_triggers(db):
    """DROP TABLE takes the table's policies, RLS switch and triggers
    with it: a table made again under the name starts without them."""
    db.run("ALTER TABLE docs ENABLE ROW LEVEL SECURITY",
           "CREATE POLICY own ON docs USING (owner_id = 2)",
           "CREATE TABLE audit (n bigint)",
           "CREATE FUNCTION log_ins() RETURNS trigger AS "
           "'INSERT INTO audit VALUES (1)'",
           "CREATE TRIGGER t_ins AFTER INSERT ON docs "
           "EXECUTE FUNCTION log_ins()",
           "DROP TABLE docs")
    for udf in ("citus_policies", "citus_triggers"):
        assert _rows(db.step(f"SELECT {udf}()")) == []
    db.run("CREATE TABLE docs (k bigint NOT NULL, owner_id bigint, v bigint)",
           "INSERT INTO docs VALUES (1, 3, 1)",
           "GRANT SELECT ON docs TO app")
    assert _rows(db.step(("role", "SELECT count(*) FROM docs", "app"))) \
        == [(1,)]
    assert _rows(db.step("SELECT count(*) FROM audit")) == [(0,)]


# ------------------------------------------------------ roles and grants

def test_roles_and_grants(tmp_path):
    """test_breadth2.py's roles test: grants enforced per statement,
    DDL refused to a role, grants persisting across a reopen."""
    p = Pair(tmp_path, strict=True, name="roles")
    p.run("CREATE TABLE t (k bigint NOT NULL, v bigint)",
          "SELECT create_distributed_table('t', 'k', 4)",
          "INSERT INTO t VALUES (1, 10), (2, 20)",
          "CREATE ROLE analyst", "GRANT SELECT ON t TO analyst")
    assert _rows(p.step(("role", "SELECT count(*) FROM t", "analyst"))) \
        == [(2,)]
    _error(p.step(("role", "INSERT INTO t VALUES (3, 30)", "analyst")),
           "CatalogError", "lacks INSERT")
    p.run("GRANT INSERT, DELETE ON t TO analyst",
          ("role", "INSERT INTO t VALUES (3, 30)", "analyst"),
          "REVOKE ALL ON t FROM analyst")
    _error(p.step(("role", "SELECT count(*) FROM t", "analyst")),
           "CatalogError")
    _error(p.step(("role", "CREATE TABLE x (a bigint)", "analyst")),
           "CatalogError", "cannot run CreateTable")
    _error(p.step(("role", "EXPLAIN SELECT count(*) FROM t", "analyst")),
           "CatalogError", "cannot run Explain")
    assert _rows(p.step("SELECT citus_roles()")) == [("analyst",)]
    p.step("GRANT SELECT ON t TO analyst")
    assert _rows(p.step("SELECT citus_grants()")) == [
        ("t", "analyst", "select")]
    p.close()
    ref = ct.Cluster(str(tmp_path / "ref" / "roles"))
    port = ctt.Cluster(str(tmp_path / "port" / "roles"), device="cpu")
    try:
        sql = "SELECT count(*) FROM t"
        assert port.execute(sql, role="analyst").rows \
            == ref.execute(sql, role="analyst").rows == [(3,)]
        ref.execute("DROP ROLE analyst")
        port.execute("DROP ROLE analyst")
        for cl in (ref, port):
            with pytest.raises(Exception, match="does not exist"):
                cl.execute("SELECT 1 FROM t", role="analyst")
    finally:
        port.close()
        ref.close()


def test_privileges_cover_expression_subqueries(tmp_path):
    """test_advice_fixes.py: a subquery in WHERE, the select list,
    EXISTS or a DML predicate needs SELECT on what it reads."""
    p = Pair(tmp_path, strict=True, name="privsub")
    p.run("CREATE TABLE t1 (x bigint)", "CREATE TABLE t2 (secret bigint)",
          "INSERT INTO t1 VALUES (1)", "INSERT INTO t2 VALUES (42)",
          "CREATE ROLE r", "GRANT SELECT ON t1 TO r",
          "GRANT DELETE ON t1 TO r")
    for sql in ("SELECT * FROM t1 WHERE x IN (SELECT secret FROM t2)",
                "SELECT (SELECT max(secret) FROM t2) FROM t1",
                "SELECT * FROM t1 WHERE EXISTS (SELECT 1 FROM t2)",
                "DELETE FROM t1 WHERE x = (SELECT max(secret) FROM t2)"):
        _error(p.step(("role", sql, "r")), "CatalogError",
               "permission denied for t2")
    p.step("GRANT SELECT ON t2 TO r")
    assert _rows(p.step(("role", "SELECT (SELECT max(secret) FROM t2) "
                         "FROM t1", "r"))) == [(42,)]
    p.close()


def test_upsert_requires_update_privilege_and_respects_update_rls(tmp_path):
    """test_upsert_distinct_on.py: DO UPDATE needs UPDATE as well as
    INSERT, and the conflicting row must pass the role's UPDATE policy
    whatever the conflict WHERE says."""
    p = Pair(tmp_path, strict=True, name="upsert")
    p.run("CREATE TABLE kv (k bigint NOT NULL PRIMARY KEY, v bigint)",
          "SELECT create_distributed_table('kv', 'k', 4)",
          "INSERT INTO kv VALUES (1, 1), (2, 2)",
          "CREATE ROLE bob", "GRANT INSERT ON kv TO bob")
    up = ("INSERT INTO kv (k, v) VALUES (1, 5) "
          "ON CONFLICT (k) DO UPDATE SET v = excluded.v")
    _error(p.step(("role", up, "bob")), "CatalogError", "lacks UPDATE")
    p.run("GRANT UPDATE ON kv TO bob", ("role", up, "bob"))
    assert _rows(p.step("SELECT v FROM kv WHERE k = 1")) == [(5,)]
    p.run("CREATE TABLE t (id bigint NOT NULL, tenant bigint, v bigint)",
          "SELECT create_distributed_table('t','id',2)",
          "CREATE UNIQUE INDEX t_id ON t (id)",
          "INSERT INTO t VALUES (2, 2, 200), (3, 1, 300)",
          "GRANT SELECT, INSERT, UPDATE ON t TO bob",
          "ALTER TABLE t ENABLE ROW LEVEL SECURITY",
          "CREATE POLICY p ON t USING (tenant = 1) WITH CHECK (tenant = 1)")
    _error(p.step(("role", "INSERT INTO t VALUES (2, 1, 999) ON CONFLICT "
                   "(id) DO UPDATE SET v = excluded.v", "bob")),
           "AnalysisError", "violates row-level security")
    p.step(("role", "INSERT INTO t VALUES (3, 1, 301), (4, 1, 400) "
            "ON CONFLICT (id) DO UPDATE SET v = excluded.v", "bob"))
    assert _rows(p.step("SELECT id, tenant, v FROM t ORDER BY id")) == [
        (2, 2, 200), (3, 1, 301), (4, 1, 400)]
    p.close()


def test_prepare_works_for_roles_and_checks_inner_privileges(tmp_path):
    """test_prepare_execute.py: any role may PREPARE; EXECUTE checks
    the underlying statement under the same role."""
    p = Pair(tmp_path, strict=True, name="prep")
    p.run("CREATE TABLE t (k bigint NOT NULL, v bigint)",
          "SELECT create_distributed_table('t', 'k', 4)",
          ("copy", "t", {"columns": {"k": np.arange(100),
                                     "v": np.arange(100)}}),
          "CREATE ROLE alice", "GRANT SELECT ON t TO alice",
          ("srole", "PREPARE pq AS SELECT count(*) FROM t", "alice"))
    assert _rows(p.step(("srole", "EXECUTE pq", "alice"))) == [(100,)]
    p.step(("srole", "PREPARE pd AS DELETE FROM t", "alice"))
    _error(p.step(("srole", "EXECUTE pd", "alice")), "CatalogError",
           "permission denied")
    _error(p.step(("s", "PREPARE bad AS EXECUTE bad")), "SqlSyntaxError",
           "plannable")
    p.close()


# ------------------------------------------------------- the leak check

def _tenant_db(tmp_path):
    p = Pair(tmp_path, strict=True, name="leak")
    n = 4000
    rng = np.random.default_rng(11)
    p.run("CREATE TABLE li (k bigint NOT NULL, supp bigint, q bigint, "
          "flag text)",
          "SELECT create_distributed_table('li', 'k', 4)",
          ("copy", "li", {"columns": {
              "k": np.arange(n), "supp": rng.integers(1, 1001, n),
              "q": rng.integers(1, 51, n),
              "flag": np.array(["A", "N", "R"])[rng.integers(0, 3, n)]}}),
          "CREATE ROLE supp_100", "GRANT SELECT ON li TO supp_100",
          "CREATE ROLE supp_500", "GRANT SELECT ON li TO supp_500",
          "ALTER TABLE li ENABLE ROW LEVEL SECURITY",
          "CREATE POLICY p100 ON li FOR SELECT TO supp_100 "
          "USING (supp <= 100)",
          "CREATE POLICY p500 ON li FOR SELECT TO supp_500 "
          "USING (supp <= 500)")
    return p


@pytest.mark.parametrize("sql", [
    "SELECT count(*), sum(q) FROM li",
    "SELECT flag, count(*), sum(q) FROM li GROUP BY flag ORDER BY flag",
    "SELECT count(*) FROM li WHERE q > 25",
])
def test_role_rows_never_leak_between_callers(tmp_path, sql):
    """Superuser (cold, then warm), tenant, other tenant, superuser:
    each call returns its own rows, on both packages, with the plan
    cache, the device cache and the generated kernels warm."""
    p = _tenant_db(tmp_path)
    try:
        su = [_rows(p.step(sql)), _rows(p.step(sql))]
        t100 = [_rows(p.step(("role", sql, "supp_100"))) for _ in range(2)]
        t500 = _rows(p.step(("role", sql, "supp_500")))
        su.append(_rows(p.step(sql)))
        assert su[0] == su[1] == su[2]
        where = " WHERE supp <= 100" if "WHERE" not in sql else \
            " AND supp <= 100"
        cut = sql.replace(" GROUP BY", where + " GROUP BY") \
            if "GROUP BY" in sql else sql + where
        assert t100[0] == t100[1] == _rows(p.step(cut))
        assert t500 != t100[0] and t100[0] != su[0]
    finally:
        p.close()


def test_role_rows_never_leak_through_the_generic_plan(tmp_path):
    """A $n statement: the superuser's generic plan serves the superuser
    only; a role's call substitutes its parameters and is rewritten."""
    p = _tenant_db(tmp_path)
    try:
        sql = "SELECT count(*) FROM li WHERE q > $1"
        su = [_rows(p.step(("params", sql, [v]))) for v in (10, 20, 10)]
        tr = [_rows(p.step(("rparams", sql, [v], "supp_100")))
              for v in (10, 20)]
        assert su[0] == su[2] and su[0] != tr[0] and tr[0] != tr[1]
        assert _rows(p.step(("params", sql, [20]))) == su[1]
    finally:
        p.close()


def test_role_rows_never_leak_through_megabatch_queues(tmp_path):
    """Threads of the superuser and of a tenant send one SQL text at
    once under a megabatch window: each gets its own rows."""
    p = _tenant_db(tmp_path)
    try:
        sql = "SELECT count(*), sum(q) FROM li WHERE q > 5"
        want_su = _rows(p.step(sql))
        want_t = _rows(p.step(("role", sql, "supp_100")))
        port = p.port
        port.execute("SET citus.megabatch_window_ms = 200")
        out: dict = {}

        def run(i):
            role = "supp_100" if i % 2 else None
            out[i] = port.execute(sql, role=role).rows

        threads = [threading.Thread(target=run, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for i, rows in out.items():
            assert rows == (want_t if i % 2 else want_su), (i, rows)
        assert len(out) == 6
    finally:
        p.close()


# ------------------------------------------------ chip_smoke.py phase 14

def test_chip_smoke_phase14_rehearses_on_cpu(tmp_path):
    """chip_smoke.py's phase 14 (a) whole on a CPU cluster at a small
    size (its checks against numpy and the cpu backend), and its
    rehearsal's fold and insert sources compile with g++.  Phase 14 (b)
    rehearses with phase 7 (tests/test_torch_net.py)."""
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
        launches = dict.fromkeys(chip_smoke.launch_counters(), 0)
        chip_smoke.run_phase14(cl, chunk, 10_000, launches, "cpu", [])
        assert not any(n in cl.catalog.tables for n in ("orders_t", "audit"))
        assert not cl.catalog.roles and not cl.catalog.rls
        assert cl.execute("SELECT count(*) FROM lineitem").rows == [(40_000,)]
    finally:
        cl.close()
    sources = chip_smoke.phase14_sources(str(tmp_path), 10_000)
    folds = {f"s{i}": src for i, (build, src) in enumerate(sources)
             if build != "filter_mask"}
    assert folds and len(folds) < len(sources)
    _harness(folds, tmp_path)
