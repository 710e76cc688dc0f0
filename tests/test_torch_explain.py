"""EXPLAIN and EXPLAIN ANALYZE through the port, line for line against
the JAX package.

The same tables, made from numpy seeds, go into ``citus_tpu.Cluster``
and ``citus_tpu_torch.Cluster(device="cpu")``; each EXPLAIN's lines must
be identical, for every kind the reference renders: a single-table scan
(scalar, direct and hash aggregates, a router query, an index lookup,
chunk pruning), a partitioned parent, a rollup scan, joins, GROUPING
SETS, set operations, UPDATE / DELETE with their strategy (local, and
forwarded or cross-host on a pair of coordinators), INSERT … SELECT's
strategy ladder, and the statements EXPLAIN refuses.

A direct GROUP BY prints the reference's ``combine: psum`` (ROADMAP.md
C19, repaired), held by ``test_c19_direct_groupby_combine_line``.

EXPLAIN ANALYZE: each line's name and layout, ``Rows``, the plan
cache's miss then hit and its fingerprint, the device cache's hits and
misses, the bytes the statement touched, the task count; every time,
the double buffer's stall counts and the process-wide device cache's
resident bytes, masked (``_mask``).  No float is compared.
"""

import os
import re
import sys

import numpy as np
import pytest

import citus_tpu as ct
import citus_tpu_torch as ctt

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

def _fill(cl):
    rng = np.random.default_rng(23)
    n = 2000
    cl.execute("CREATE TABLE t (k bigint NOT NULL, g bigint, v decimal(10,2), "
               "c text, d date, f double)")
    cl.execute("SELECT create_distributed_table('t', 'k', 4)")
    cl.copy_from("t", columns={
        "k": np.arange(n), "g": rng.integers(0, 7, n),
        "v": rng.integers(0, 10**6, n) / 100,
        "c": np.array(["a", "b", "c"])[rng.integers(0, 3, n)],
        "d": rng.integers(8000, 9000, n).astype(np.int32),
        "f": rng.standard_normal(n)})
    cl.execute("CREATE TABLE u (k bigint NOT NULL, w bigint, c text)")
    cl.execute("SELECT create_distributed_table('u', 'k', 4)")
    cl.copy_from("u", columns={"k": np.arange(0, n, 3),
                               "w": np.arange(0, n, 3) % 11,
                               "c": ["x", "y"] * (len(range(0, n, 3)) // 2)
                               + ["x"] * (len(range(0, n, 3)) % 2)})
    cl.execute("CREATE TABLE r (id bigint NOT NULL, name text)")
    cl.execute("SELECT create_reference_table('r')")
    cl.copy_from("r", rows=[(i, f"n{i}") for i in range(7)])
    cl.execute("CREATE TABLE loc (k bigint, w bigint)")
    cl.copy_from("loc", rows=[(i, i % 3) for i in range(50)])
    cl.execute("CREATE TABLE ev (tenant bigint NOT NULL, ts date, "
               "amount bigint) PARTITION BY RANGE (ts)")
    cl.execute("CREATE TABLE ev_h1 PARTITION OF ev "
               "FOR VALUES FROM ('2024-01-01') TO ('2024-07-01')")
    cl.execute("CREATE TABLE ev_h2 PARTITION OF ev "
               "FOR VALUES FROM ('2024-07-01') TO ('2025-01-01')")
    cl.execute("SELECT create_distributed_table('ev', 'tenant', 4)")
    cl.copy_from("ev", rows=[(i % 10, f"2024-{1 + i % 12:02d}-15", i)
                             for i in range(240)])
    cl.execute("CREATE INDEX t_c ON t (c)")
    cl.execute("CREATE TABLE tgt (k bigint NOT NULL, g bigint)")
    cl.execute("SELECT create_distributed_table('tgt', 'k', 4)")
    cl.execute("CREATE TABLE tgt2 (k bigint NOT NULL, g bigint)")
    cl.execute("SELECT create_distributed_table('tgt2', 'g', 2)")
    cl.execute("CREATE TABLE li (sk bigint NOT NULL, q bigint, pk bigint)")
    cl.execute("SELECT create_distributed_table('li', 'sk', 4)")
    cl.copy_from("li", columns={"sk": np.arange(600) % 20,
                                "q": np.arange(600) % 50,
                                "pk": np.arange(600) * 7})
    cl.execute("CREATE PUBLICATION li_changes FOR TABLE li")
    cl.execute("SELECT citus_create_rollup('li_r', 'li', 'sk', "
               "'count(*), sum(q), approx_count_distinct(pk)')")


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("explain")
    ref = ct.Cluster(str(d / "ref"))
    port = ctt.Cluster(str(d / "port"), device="cpu")
    try:
        _fill(ref)
        _fill(port)
        yield ref, port
    finally:
        port.close()
        ref.close()


def _outcome(cl, sql):
    try:
        return [r[0] for r in cl.execute(sql).rows]
    except Exception as e:  # noqa: BLE001 -- the class is the outcome
        return ("error", type(e).__name__, str(e))


PLANS = {
    "scalar": "EXPLAIN SELECT count(*), sum(v) FROM t",
    "scalar_pruned": "EXPLAIN SELECT sum(v) FROM t WHERE d < '1992-01-01'",
    "router": "EXPLAIN SELECT sum(v), count(*) FROM t WHERE k = 17",
    "index": "EXPLAIN SELECT count(*) FROM t WHERE c = 'b'",
    "direct": "EXPLAIN SELECT g, count(*), sum(v), avg(f) FROM t GROUP BY g",
    "hash": "EXPLAIN SELECT k, sum(v) FROM t GROUP BY k",
    "projection": "EXPLAIN SELECT k, v FROM t WHERE g = 3 ORDER BY k "
                  "LIMIT 5",
    "local": "EXPLAIN SELECT w, count(*) FROM loc GROUP BY w",
    "reference": "EXPLAIN SELECT count(*) FROM r",
    "partitioned": "EXPLAIN SELECT count(*), sum(amount) FROM ev",
    "partitioned_pruned": "EXPLAIN SELECT sum(amount) FROM ev "
                          "WHERE ts >= '2024-08-01'",
    "partitioned_none": "EXPLAIN SELECT sum(amount) FROM ev "
                        "WHERE ts >= '2026-01-01'",
    "rollup": "EXPLAIN SELECT sk, count(*), approx_count_distinct(pk) "
              "FROM li GROUP BY sk",
    "rollup_global": "EXPLAIN SELECT count(*), sum(q) FROM li",
    "join": "EXPLAIN SELECT t.c, sum(u.w) FROM t JOIN u ON t.k = u.k "
            "WHERE t.g = 2 GROUP BY t.c",
    "join_repartition": "EXPLAIN SELECT count(*) FROM t JOIN u "
                        "ON t.g = u.w",
    "join_left_reference": "EXPLAIN SELECT t.k, r.name FROM t LEFT JOIN r "
                           "ON t.g = r.id WHERE t.k < 5",
    "join_three": "EXPLAIN SELECT count(*) FROM t JOIN u ON t.k = u.k "
                  "JOIN r ON t.g = r.id",
    "rollup_sets": "EXPLAIN SELECT c, g, sum(v) FROM t "
                   "GROUP BY ROLLUP (c, g)",
    "grouping_sets": "EXPLAIN SELECT c, g, count(*), grouping(c) FROM t "
                     "GROUP BY GROUPING SETS ((c), (g), ())",
    "union": "EXPLAIN SELECT k FROM t WHERE g = 1 UNION SELECT k FROM u",
    "union_all": "EXPLAIN SELECT g, count(*) FROM t GROUP BY g "
                 "UNION ALL SELECT w, count(*) FROM u GROUP BY w",
    "intersect": "EXPLAIN SELECT k FROM t INTERSECT SELECT k FROM u",
    "except_nested": "EXPLAIN SELECT k FROM t EXCEPT (SELECT k FROM u "
                     "UNION SELECT id FROM r)",
    "update": "EXPLAIN UPDATE t SET v = 0 WHERE k = 5",
    "update_all": "EXPLAIN UPDATE t SET v = v + 1",
    "update_range": "EXPLAIN UPDATE t SET f = 0 WHERE k > 10 AND d < "
                    "'1993-01-01'",
    "delete": "EXPLAIN DELETE FROM t WHERE k IN (1, 2, 3)",
    "delete_all": "EXPLAIN DELETE FROM u",
    "delete_partitioned": "EXPLAIN DELETE FROM ev WHERE ts < '2024-03-01'",
    "update_partitioned": "EXPLAIN UPDATE ev SET amount = 0",
    "insert_colocated": "EXPLAIN INSERT INTO tgt SELECT k, g FROM t",
    "insert_repartition": "EXPLAIN INSERT INTO tgt (k, g) SELECT g, k "
                          "FROM t WHERE g > 2",
    "insert_other_group": "EXPLAIN INSERT INTO tgt2 SELECT k, g FROM t",
    "insert_pull_agg": "EXPLAIN INSERT INTO tgt SELECT g, count(*) FROM t "
                       "GROUP BY g",
    "insert_setop": "EXPLAIN INSERT INTO tgt SELECT k, g FROM t UNION "
                    "SELECT k, w FROM u",
    "insert_values": "EXPLAIN INSERT INTO tgt VALUES (1, 2)",
    "view_refused": "EXPLAIN SELECT * FROM no_such_view",
    "unknown_column": "EXPLAIN SELECT nope FROM t",
}


@pytest.mark.parametrize("name", list(PLANS))
def test_explain_lines_identical_to_reference(pair, name):
    ref, port = pair
    want = _outcome(ref, PLANS[name])
    got = _outcome(port, PLANS[name])
    assert got == want, (name, want, got)


def test_c19_direct_groupby_combine_line(pair):
    """ROADMAP.md C19, repaired: a direct GROUP BY's line is the
    reference's ``combine: psum`` label in both packages, and every
    line of the two EXPLAINs is equal."""
    ref, port = pair
    sql = "EXPLAIN SELECT g, count(*) FROM t GROUP BY g"
    want, got = _outcome(ref, sql), _outcome(port, sql)
    assert want[1] == ("  Partial Aggregate per shard -> Direct GroupBy "
                       "(groups: 8, combine: psum)")
    assert got == want


# ------------------------------------------------------------- ANALYZE

@pytest.fixture()
def one_device(monkeypatch):
    """The reference on its single-device stream, the port's path
    (tests/conftest.py forces 8 virtual JAX devices, which send the
    reference's multi-batch scans down its mesh, whose ANALYZE shows
    device rounds where the stream shows tasks)."""
    import jax
    real = jax.devices()
    monkeypatch.setattr(jax, "devices", lambda *a, **k: real[:1])

def _mask(lines):
    """Times, compile milliseconds, the double buffer's stall counts and
    what the process-wide device cache holds (every earlier test's
    tables too) masked; counts, the bytes this statement touched, rows
    and the fingerprint kept."""
    out = []
    for ln in lines:
        ln = re.sub(r"\d+\.\d+", "#", ln)
        ln = re.sub(r"compile \d+ ms", "compile # ms", ln)
        ln = re.sub(r"stalls host=\d+ device=\d+", "stalls #", ln)
        ln = re.sub(r"cache-resident \d+ bytes \(high water \d+\)",
                    "cache-resident # bytes (high water #)", ln)
        out.append(ln)
    return out


ANALYZE = {
    "scalar": "EXPLAIN ANALYZE SELECT count(*), sum(v), min(d) FROM t "
              "WHERE g < 5",
    "direct": "EXPLAIN ANALYZE SELECT c, count(*), sum(v) FROM t GROUP BY c",
    "hash": "EXPLAIN ANALYZE SELECT k, count(*) FROM t WHERE g = 1 "
            "GROUP BY k",
    "projection": "EXPLAIN ANALYZE SELECT k, c FROM t WHERE g = 6 AND "
                  "k < 300",
    "join": "EXPLAIN ANALYZE SELECT t.c, sum(u.w) FROM t JOIN u "
            "ON t.k = u.k GROUP BY t.c",
    "setop": "EXPLAIN ANALYZE SELECT g FROM t UNION SELECT w FROM u",
    "grouping_sets": "EXPLAIN ANALYZE SELECT c, g, count(*) FROM t "
                     "GROUP BY ROLLUP (c, g)",
    "rollup": "EXPLAIN ANALYZE SELECT count(*), sum(q) FROM li",
}


def _line_names(lines):
    return [re.match(r"\s*(->\s*)?([A-Za-z /]+)", ln).group(2).strip()
            for ln in lines]


@pytest.mark.parametrize("name", list(ANALYZE))
def test_explain_analyze_lines_and_second_run_hit(pair, one_device, name):
    ref, port = pair
    sql = ANALYZE[name]
    runs = []
    for _ in range(2):
        want = _mask(_outcome(ref, sql))
        got = _mask(_outcome(port, sql))
        assert _line_names(got) == _line_names(want), (want, got)
        assert got == want, (want, got)
        runs.append(got)
    if "Plan Cache" in " ".join(runs[0]):
        first = [ln for ln in runs[0] if "Plan Cache" in ln][0]
        second = [ln for ln in runs[1] if "Plan Cache" in ln][0]
        assert "Plan Cache: miss" in first and "Plan Cache: hit" in second
    if name != "setop" and name != "grouping_sets":
        rows = [ln for ln in runs[0] if "Rows:" in ln]
        assert rows, runs[0]


def test_explain_analyze_rows_equal_the_query(pair, one_device):
    ref, port = pair
    sql = "SELECT g, count(*), sum(v) FROM t WHERE c = 'a' GROUP BY g"
    lines = _outcome(port, "EXPLAIN ANALYZE " + sql)
    n = port.execute(sql).rowcount
    assert n == ref.execute(sql).rowcount
    assert f"  Rows: {n}  Elapsed:" in "\n".join(lines)


# ------------------------------------------------- cross-host strategies

@pytest.mark.parametrize("where, line", [
    ("WHERE k = {k_remote}", "forward to remote owner"),
    ("", "cross-host two-phase commit"),
    ("WHERE k = {k_local}", "local (deletion bitmaps"),
])
def test_explain_modify_strategy_on_a_pair(tmp_path, where, line):
    """On a pair of coordinators (tests/test_torch_net.py's layout),
    EXPLAIN of an UPDATE / DELETE names the strategy the statement would
    take, and runs nothing remote."""
    from test_torch_net import _open_pair
    outs = []
    for pkg in (ct, ctt):
        a, b = _open_pair(tmp_path / pkg.__name__, pkg, pkg)
        try:
            a.execute("CREATE TABLE t (k bigint NOT NULL, v bigint)")
            a.execute("SELECT create_distributed_table('t', 'k', 4)")
            t = a.catalog.table("t")
            hosted = {}
            for k in range(200):
                si = int(np.flatnonzero([
                    s.hash_min <= _hash(pkg, k) <= s.hash_max
                    for s in t.shards])[0])
                remote = a.catalog.is_remote_node(
                    t.shards[si].placements[0])
                hosted.setdefault(remote, k)
            w = where.format(k_remote=hosted[True], k_local=hosted[False])
            got = [_outcome(a, f"EXPLAIN {op} {w}") for op in
                   ("UPDATE t SET v = 1", "DELETE FROM t")]
            assert all(line in g[-1] for g in got), got
            outs.append(got)
        finally:
            b.close()
            a.close()
    assert outs[0] == outs[1]


def _hash(pkg, k):
    from citus_tpu.catalog.hashing import hash_int64 as ref_hash
    from citus_tpu_torch.catalog.hashing import hash_int64
    f = ref_hash if pkg is ct else hash_int64
    return int(f(np.asarray([k], np.int64))[0])
