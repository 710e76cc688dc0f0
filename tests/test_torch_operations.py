"""Shard operations of the port against the JAX package: moves and
copies between local nodes, splits, both tenant isolations, the
rebalancer and its plan under each strategy, a background job started
and awaited, the shard inventories and node UDFs, and the cleaner
after a failed move.

tests/test_operations.py's and tests/test_rebalance_plan.py's steps run
through ``tests/torch_write_pair.py Pair``: the same statements over the
same rows (made from a seed with numpy) through ``citus_tpu`` and
``citus_tpu_torch`` on the CPU, comparing each UDF's columns and rows,
the error class of each refused call, and the reads that follow.  The
two catalogs allocate the same shard ids, and the two writers the same
stripe bytes, so shard ids, hash ranges and placement sizes are held
exactly.  Times (``citus_shard_move_stats`` total and blocked ms, a
job's start time) are left out of the comparison.
"""

import importlib
import os
import sys

import numpy as np
import pytest

import citus_tpu_torch as ctt

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_write_pair import Pair  # noqa: E402

N = 10_000
READS = ("SELECT count(*), sum(v) FROM t",
         "SELECT v % 7, count(*), sum(k) FROM t GROUP BY v % 7",
         "SELECT k, v FROM t WHERE k IN (42, 4242, 9999) ORDER BY k")


def _pkg(cl):
    return "citus_tpu_torch" if isinstance(cl, ctt.Cluster) else "citus_tpu"


def _m(cl, name):
    return importlib.import_module(f"{_pkg(cl)}.{name}")


def _pair(tmp_path, nodes=2, shards=4, n=N, seed=0, **kw):
    """A pair loaded with ``t``.  Both maintenance daemons are stopped,
    so no timed cleaner pass races the steps that read the cleaner's
    records."""
    p = Pair(tmp_path, n_nodes=nodes, **kw)
    for cl in (p.ref, p.port):
        cl.maintenance.stop()
    rng = np.random.default_rng(seed)
    cols = {"k": np.arange(n, dtype=np.int64),
            "v": rng.integers(0, 97, n).astype(np.int64)}
    p.run("CREATE TABLE t (k bigint NOT NULL, v bigint)",
          f"SELECT create_distributed_table('t', 'k', {shards})",
          ("copy", "t", {"columns": cols}))
    return p


def _reads(p, extra=()):
    p.run(*READS, *extra)


def _shard(p, i, table="t"):
    s = p.ref.catalog.table(table).shards[i]
    return s.shard_id, s.placements[0]


def _stats(cl):
    """citus_shard_move_stats() without its two times."""
    r = cl.execute("SELECT citus_shard_move_stats()")
    return [row[:6] for row in r.rows]


def _on_disk(sid, node, table="t"):
    return ("check", lambda cl: os.path.isdir(
        cl.catalog.shard_dir(table, sid, node)))


def _pending(cl):
    return sorted((os.path.relpath(r["path"], cl.catalog.data_dir),
                   r["policy"])
                  for r in _m(cl, "operations").pending_cleanup(cl.catalog))


def _operations(cl):
    return sorted(v["kind"] for v in
                  _m(cl, "operations").operations_view(cl.catalog).values())


@pytest.fixture(autouse=True)
def _reset_process_ledgers():
    """The move-stats ring, the load-attribution ledger and the tenant
    registry are process-wide: another test's table ``t`` has the same
    shard ids, another test pinned its tenants."""
    for pkg in ("citus_tpu", "citus_tpu_torch"):
        importlib.import_module(f"{pkg}.operations").MOVE_STATS.reset()
        importlib.import_module(
            f"{pkg}.observability.load_attribution").GLOBAL_ATTRIBUTION.reset()
        importlib.import_module(f"{pkg}.workload").GLOBAL_TENANTS.clear()
    yield


def test_move_shard_placement(tmp_path):
    p = _pair(tmp_path)
    try:
        sid, src = _shard(p, 0)
        dst = 1 - src
        p.run("SELECT citus_shards()", "SELECT citus_shard_sizes()",
              f"SELECT citus_move_shard_placement({sid}, {src}, {dst})",
              "SELECT citus_shards()",
              ("check", _stats), ("check", _pending),
              _on_disk(sid, src), _on_disk(sid, dst))
        _reads(p)
        p.run("SELECT citus_cleanup_orphaned_resources()",
              _on_disk(sid, src), ("check", _pending),
              ("check", _operations))
        _reads(p)
    finally:
        p.close()


@pytest.mark.parametrize("call", ["same_node", "not_the_source",
                                  "unknown_shard", "unknown_node"])
def test_move_errors(tmp_path, call):
    p = _pair(tmp_path, n=500)
    try:
        sid, src = _shard(p, 0)
        sql = {"same_node": f"{sid}, {src}, {src}",
               "not_the_source": f"{sid}, {1 - src}, {src}",
               "unknown_shard": "999999, 0, 1",
               "unknown_node": f"{sid}, {src}, 7"}[call]
        out = p.step(f"SELECT citus_move_shard_placement({sql})")
        assert out[:2] == ("error", "CatalogError")
        p.run("SELECT citus_shards()", ("check", _operations))
    finally:
        p.close()


def test_copy_shard_placement_then_failover(tmp_path):
    """citus_copy_shard_placement adds a replica; with the source node
    disabled, reads go to the copy."""
    p = _pair(tmp_path, nodes=3)
    try:
        sid, src = _shard(p, 1)
        dst = 2
        p.run(f"SELECT citus_copy_shard_placement({sid}, {src}, {dst})",
              "SELECT citus_shards()", "SELECT citus_shard_sizes()",
              f"SELECT citus_copy_shard_placement({sid}, {src}, {dst})")
        _reads(p)
        p.run(f"SELECT citus_disable_node({src})",
              "SELECT citus_get_active_worker_nodes()")
        _reads(p)
        p.run(f"SELECT citus_activate_node({src})",
              "SELECT master_get_active_worker_nodes()")
    finally:
        p.close()


def test_colocated_shards_move_together(tmp_path):
    p = _pair(tmp_path)
    try:
        p.run("CREATE TABLE t2 (k bigint NOT NULL, w bigint)",
              "SELECT create_distributed_table('t2', 'k', 4)",
              ("copy", "t2", {"columns": {
                  "k": np.arange(5000, dtype=np.int64),
                  "w": np.arange(5000, dtype=np.int64)}}))
        sid, src = _shard(p, 2)
        p.run(f"SELECT citus_move_shard_placement({sid}, {src}, {1 - src})",
              "SELECT citus_shards()", ("check", _stats),
              "SELECT count(*), sum(w) FROM t2",
              "SELECT count(*) FROM t JOIN t2 ON t.k = t2.k")
    finally:
        p.close()


def test_add_node_and_rebalance(tmp_path):
    p = _pair(tmp_path)
    try:
        p.run("SELECT citus_add_node('worker-2', 5432)",
              "SELECT get_rebalance_table_shards_plan('t')",
              "SELECT get_rebalance_table_shards_plan()",
              "SELECT rebalance_table_shards('t')",
              "SELECT citus_shards()", ("check", _stats),
              "SELECT get_rebalance_table_shards_plan('t')")
        _reads(p)
    finally:
        p.close()


def test_rebalance_by_shard_count(tmp_path):
    p = _pair(tmp_path, shards=8)
    try:
        p.run("SELECT citus_add_node('w', 1)",
              "SELECT get_rebalance_table_shards_plan('t', "
              "'by_shard_count')",
              "SELECT rebalance_table_shards('t', 'by_shard_count')",
              "SELECT citus_shards()")
        _reads(p)
        out = p.step("SELECT rebalance_table_shards('t', 'bogus')")
        assert out[:2] == ("error", "CatalogError")
    finally:
        p.close()


def test_background_rebalance_job(tmp_path):
    p = _pair(tmp_path)
    try:
        p.run("SELECT citus_add_node('w', 1)",
              "SELECT citus_rebalance_start()",
              "SELECT citus_job_wait(1)", "SELECT citus_shards()",
              ("check", lambda cl: [
                  r[:8] for r in cl.execute(
                      "SELECT get_rebalance_progress()").rows]),
              ("check", lambda cl: cl.background_jobs.task_rows()))
        _reads(p)
    finally:
        p.close()


def test_split_shard(tmp_path):
    p = _pair(tmp_path)
    try:
        s = p.ref.catalog.table("t").shards[0]
        mid = (s.hash_min + s.hash_max) // 2
        p.run(f"SELECT citus_split_shard_by_split_points({s.shard_id}, "
              f"{mid})", "SELECT citus_shards()",
              "SELECT citus_shard_sizes()", ("check", _stats),
              "SELECT count(*) FROM t WHERE k = 123",
              "SELECT get_shard_id_for_distribution_column('t', 123)")
        _reads(p)
        p.run("SELECT citus_cleanup_orphaned_resources()",
              "SELECT citus_shard_sizes()")
        _reads(p)
        bad = p.step(f"SELECT citus_split_shard_by_split_points("
                     f"{p.ref.catalog.table('t').shards[0].shard_id}, "
                     f"{s.hash_max})")
        assert bad[:2] == ("error", "CatalogError")
    finally:
        p.close()


def test_split_colocated_group_at_several_points(tmp_path):
    p = _pair(tmp_path)
    try:
        p.run("CREATE TABLE t2 (k bigint NOT NULL, w bigint)",
              "SELECT create_distributed_table('t2', 'k', 4)",
              ("copy", "t2", {"columns": {
                  "k": np.arange(3000, dtype=np.int64),
                  "w": np.ones(3000, dtype=np.int64)}}))
        s = p.ref.catalog.table("t").shards[2]
        q = (s.hash_max - s.hash_min) // 4
        pts = ", ".join(str(s.hash_min + i * q) for i in (1, 2, 3))
        p.run(f"SELECT citus_split_shard_by_split_points({s.shard_id}, "
              f"{pts})", "SELECT citus_shards()", "SELECT citus_tables()",
              "SELECT count(*) FROM t JOIN t2 ON t.k = t2.k",
              "SELECT count(*), sum(w) FROM t2")
        _reads(p)
    finally:
        p.close()


def test_isolate_tenant_to_new_shard(tmp_path):
    p = _pair(tmp_path)
    try:
        p.run("SELECT isolate_tenant_to_new_shard('t', 42)",
              "SELECT citus_shards()",
              "SELECT get_shard_id_for_distribution_column('t', 42)",
              "SELECT count(*), sum(v) FROM t WHERE k = 42",
              ("check", lambda cl: cl.execute(
                  "SELECT count(*) FROM t WHERE k = 42"
              ).explain.get("strategy")))
        _reads(p)
    finally:
        p.close()


def test_isolate_tenant_to_node(tmp_path):
    p = _pair(tmp_path, nodes=3)
    try:
        p.run("SELECT citus_isolate_tenant_to_node('t', 4242, 2)",
              "SELECT citus_shards()", "SELECT citus_tenant_quotas()",
              "SELECT count(*), sum(v) FROM t WHERE k = 4242",
              "SELECT citus_isolate_tenant_to_node('t', 4242, 9)")
        _reads(p)
    finally:
        p.close()


@pytest.mark.parametrize("strategy", ["by_shard_count", "by_bytes",
                                      "by_observed_load", "by_vibes"])
def test_rebalance_plan_strategies(tmp_path, strategy):
    """citus_rebalance_plan over a new empty node: the same steps from
    both packages, and nothing moved.  Under by_observed_load the
    ledgers are empty (no read has run), so no slot carries load;
    test_rebalance_plan_observed_load_shapes gives it load snapshots."""
    p = _pair(tmp_path)
    try:
        p.run("SELECT citus_add_node('w2', 5432)")
        before = p.step("SELECT citus_shards()")
        p.run(f"SELECT citus_rebalance_plan('{strategy}')",
              f"SELECT citus_rebalance_plan('{strategy}', 0.2)",
              ("check", _operations))
        assert p.step("SELECT citus_shards()") == before
    finally:
        p.close()


def _plans(cl, shards_on, rows_for):
    rp = _m(cl, "operations.rebalance_plan")
    t = cl.catalog.table("t")
    scores = {("t", s.shard_id, s.placements[0]): shards_on(s)
              for s in t.shards}
    steps = rp.build_rebalance_plan(cl.catalog, "by_observed_load",
                                    load_scores=scores,
                                    attribution_rows=rows_for(t))
    return rp.plan_rows(steps)


@pytest.mark.parametrize("shape", ["hot_node", "hot_tenant",
                                   "diffuse_tenants", "hot_slot"])
def test_rebalance_plan_observed_load_shapes(tmp_path, shape):
    """build_rebalance_plan on explicit load snapshots: a move off a hot
    node, an isolation for a dominant tenant, a split for a diffuse mix
    or a lone hot slot."""
    p = _pair(tmp_path, shards=1 if shape != "hot_node" else 4, n=2000)
    try:
        def score(s):
            if shape == "hot_node":
                return 500.0 if s.placements[0] == 0 else 1.0
            return 1000.0

        def rows(t):
            s = t.shards[0]
            node = s.placements[0]
            if shape == "hot_tenant":
                return [["t", s.shard_id, node, "42", 10, 800.0, 0, 0, 0.0,
                         0.0],
                        ["t", s.shard_id, node, "7", 3, 200.0, 0, 0, 0.0,
                         0.0]]
            if shape == "diffuse_tenants":
                return [["t", s.shard_id, node, str(i), 1, 100.0, 0, 0, 0.0,
                         0.0] for i in range(10)]
            return []
        want = p.step(("check", lambda cl: _plans(cl, score, rows)))
        action = {"hot_node": "move", "hot_tenant": "isolate",
                  "diffuse_tenants": "split", "hot_slot": "split"}[shape]
        assert want[1] and want[1][0][1] == action
    finally:
        p.close()


@pytest.mark.parametrize("name", ["citus_table_size", "citus_relation_size",
                                  "citus_total_relation_size"])
def test_table_size_names(tmp_path, name):
    p = _pair(tmp_path, n=3000)
    try:
        p.run(f"SELECT {name}('t')", f"SELECT {name}('nope')")
    finally:
        p.close()


def test_inventories_and_node_udfs(tmp_path):
    p = _pair(tmp_path, nodes=3)
    try:
        p.run("CREATE TABLE r (a bigint, b text)",
              "SELECT create_reference_table('r')",
              "INSERT INTO r VALUES (1, 'x'), (2, 'y')",
              "SELECT citus_shards()", "SELECT citus_shard_sizes()",
              "SELECT citus_tables()",
              "SELECT get_shard_id_for_distribution_column('t', 42)",
              "SELECT get_shard_id_for_distribution_column('t', -7)",
              "SELECT get_shard_id_for_distribution_column('r', 1)",
              "SELECT master_get_active_worker_nodes()",
              "SELECT citus_get_active_worker_nodes()",
              "SELECT citus_coordinator_nodeid()",
              "SELECT citus_disable_node(0)",
              "SELECT citus_get_active_worker_nodes()",
              "SELECT citus_coordinator_nodeid()",
              "SELECT citus_disable_node(9)",
              "SELECT citus_activate_node(0)",
              "SELECT citus_activate_node_metadata(2)",
              "SELECT citus_activate_node_metadata(9)",
              ("check", lambda cl: [
                  n.metadata_synced for n in cl.catalog.nodes.values()]),
              "SELECT citus_sync_metadata()")
        _reads(p)
    finally:
        p.close()


def test_shard_load_and_device_memory_views(tmp_path):
    """citus_shard_load and citus_device_memory: the same columns from
    both packages; each package's ledger rows are its own reads (the
    device work differs), so the rows are held to the views'
    invariants: every shard_load row names a placement of the table,
    and the device ledger's entry rows sum to its total."""
    p = _pair(tmp_path)
    try:
        _reads(p)
        for cl in (p.ref, p.port):
            r = cl.execute("SELECT citus_shard_load('t')")
            assert r.columns == [
                "observer", "table_name", "shard_id", "node", "tenant",
                "queries", "device_ms", "bytes_scanned", "rows_returned",
                "remote_wait_ms", "ewma_ms_per_s"]
            placed = {(s.shard_id, s.placements[0])
                      for s in cl.catalog.table("t").shards}
            assert all((row[2], row[3]) in placed and row[1] == "t"
                       for row in r.rows)
            m = cl.execute("SELECT citus_device_memory()")
            assert m.columns == ["scope", "table", "tenant", "bytes"]
            total = [row[3] for row in m.rows if row[0] == "total"]
            assert sum(row[3] for row in m.rows if row[0] == "entry") \
                == total[0]
            assert [row[0] for row in m.rows if row[0] != "entry"] == \
                ["total", "high_water", "capacity"]
        p.run("SELECT citus_shard_load('nope')")
    finally:
        p.close()


def test_cleaner_after_failed_move(tmp_path):
    """A move that fails in its bulk copy leaves the source serving and
    its half-copied target parked ON_FAILURE, which the failure made
    droppable: the next pass drops it and retires the registry row."""
    p = _pair(tmp_path)
    try:
        sid, src = _shard(p, 0)
        dst = 1 - src

        def failing_move(cl):
            faults = _m(cl, "testing.faults")
            faults.FAULTS.arm("shard_move_catchup",
                              error=RuntimeError("copy lost"), times=1)
            try:
                cl.execute(f"SELECT citus_move_shard_placement({sid}, "
                           f"{src}, {dst})")
            except RuntimeError as e:
                return str(e)
            finally:
                faults.FAULTS.disarm()
            return None

        p.run(("check", failing_move), "SELECT citus_shards()",
              ("check", _pending), ("check", _operations),
              _on_disk(sid, dst))
        _reads(p)
        p.run("SELECT citus_cleanup_orphaned_resources()",
              _on_disk(sid, dst), ("check", _pending))
        p.run(f"SELECT citus_move_shard_placement({sid}, {src}, {dst})",
              "SELECT citus_shards()")
        _reads(p)
    finally:
        p.close()


@pytest.mark.parametrize("writer,cleaner", [
    ("citus_tpu_torch", "citus_tpu"), ("citus_tpu", "citus_tpu_torch")])
def test_cleanup_records_are_shared_between_packages(tmp_path, writer,
                                                     cleaner):
    """The cleaner's record files are the reference's: records and
    registry rows one package writes, the other resolves."""
    import subprocess
    import sys
    w = importlib.import_module(f"{writer}.operations.cleaner")
    c = importlib.import_module(f"{cleaner}.operations.cleaner")

    class _Cat:
        data_dir = str(tmp_path)
        tables = {}

        def _path(self):
            return os.path.join(self.data_dir, "catalog.json")
    cat = _Cat()
    dead = subprocess.Popen([sys.executable, "-c", "pass"])
    dead.wait()
    paths = {}
    for i, policy in enumerate([w.ALWAYS, w.ON_FAILURE, w.ON_SUCCESS,
                                w.DEFERRED_ON_SUCCESS]):
        paths[policy] = str(tmp_path / f"res{i}")
        os.makedirs(paths[policy])
    w.register_operation(cat, 11, kind="move_shard", pid=dead.pid)
    w.record_cleanup(cat, paths[w.ON_FAILURE], w.ON_FAILURE, operation_id=11)
    w.register_operation(cat, 12, kind="split_shard")
    w.record_cleanup(cat, paths[w.ON_SUCCESS], w.ON_SUCCESS, operation_id=12)
    w.record_cleanup(cat, paths[w.ALWAYS], w.ALWAYS)
    w.record_cleanup(cat, paths[w.DEFERRED_ON_SUCCESS])
    assert sorted(c.operations_view(cat)) == ["11", "12"]
    assert c.operations_view(cat)["11"]["kind"] == "move_shard"
    assert len(c.pending_cleanup(cat)) == 4
    # 11's owner is dead: adopted and dropped; 12's is alive: parked
    assert c.try_drop_orphaned_resources(cat) == 3
    assert {k: os.path.isdir(v) for k, v in paths.items()} == {
        w.ALWAYS: False, w.ON_FAILURE: False, w.ON_SUCCESS: True,
        w.DEFERRED_ON_SUCCESS: False}
    c.mark_operation_phase(cat, 12, "decided")
    assert w.operations_view(cat)["12"]["phase"] == "decided"
    c.complete_operation(cat, 12, success=True)
    assert w.operations_view(cat) == {}
    assert w.try_drop_orphaned_resources(cat) == 1
    assert not os.path.isdir(paths[w.ON_SUCCESS])
    assert w.pending_cleanup(cat) == []


def test_c26_move_back_then_cleanup(tmp_path):
    """ROADMAP.md C26: a shard moved away and back lands in its old
    directory, whose deferred drop is still pending.  The reference's
    next cleaner pass deletes the live placement (its rows are gone);
    the port's move claims the path, and its cleaner never drops a live
    placement."""
    got = {}
    for pkg in ("citus_tpu", "citus_tpu_torch"):
        mod = importlib.import_module(pkg)
        st = importlib.import_module(f"{pkg}.config").Settings(
            start_maintenance_daemon=False)
        kw = {"device": "cpu"} if pkg == "citus_tpu_torch" else {}
        cl = mod.Cluster(str(tmp_path / pkg), n_nodes=2, settings=st, **kw)
        try:
            cl.execute("CREATE TABLE t (k bigint NOT NULL, v bigint)")
            cl.execute("SELECT create_distributed_table('t', 'k', 4)")
            cl.copy_from("t", columns={"k": np.arange(N),
                                       "v": np.ones(N, np.int64)})
            s = cl.catalog.table("t").shards[0]
            sid, src = s.shard_id, s.placements[0]
            cl.execute(f"SELECT citus_move_shard_placement({sid}, {src}, "
                       f"{1 - src})")
            cl.execute(f"SELECT citus_move_shard_placement({sid}, "
                       f"{1 - src}, {src})")
            cl.execute("SELECT citus_cleanup_orphaned_resources()")
            importlib.import_module(
                f"{pkg}.executor.device_cache").GLOBAL_CACHE.clear()
            got[pkg] = cl.execute("SELECT count(*) FROM t").rows[0][0]
        finally:
            cl.close()
    assert got["citus_tpu"] < N
    assert got["citus_tpu_torch"] == N


@pytest.mark.parametrize("sql", ["SELECT get_rebalance_table_shards_plan()",
                                 "SELECT citus_shard_sizes()"])
def test_c27_sizes_a_placement_whose_file_vanishes(tmp_path, monkeypatch,
                                                    sql):
    """ROADMAP.md C27: a file its writer removes between the listing of
    a placement and its size (a transaction's staged side file at its
    commit; phase 15 (b) of chip_smoke.py met one on the card with a
    writer running beside ``citus_rebalance_start()``).  A listing that
    names one such file: the reference raises FileNotFoundError; the
    port counts it 0 and answers as without it."""
    real = os.listdir

    def listdir(path="."):
        names = real(path)
        if os.path.basename(os.fspath(path)).startswith("placement_"):
            names = names + ["shard_meta.json.staged.9.tmp"]
        return names
    got = {}
    for pkg in ("citus_tpu", "citus_tpu_torch"):
        mod = importlib.import_module(pkg)
        st = importlib.import_module(f"{pkg}.config").Settings(
            start_maintenance_daemon=False)
        kw = {"device": "cpu"} if pkg == "citus_tpu_torch" else {}
        cl = mod.Cluster(str(tmp_path / pkg), n_nodes=2, settings=st, **kw)
        try:
            cl.execute("CREATE TABLE t (k bigint NOT NULL, v bigint)")
            cl.execute("SELECT create_distributed_table('t', 'k', 4)")
            cl.copy_from("t", columns={"k": np.arange(N),
                                       "v": np.ones(N, np.int64)})
            want = cl.execute(sql).rows
            with monkeypatch.context() as m:
                m.setattr(os, "listdir", listdir)
                try:
                    got[pkg] = (want, cl.execute(sql).rows)
                except FileNotFoundError as e:
                    got[pkg] = (want, type(e).__name__)
        finally:
            cl.close()
    assert got["citus_tpu"][1] == "FileNotFoundError"
    want, rows = got["citus_tpu_torch"]
    assert rows == want == got["citus_tpu"][0]
