"""Cross-host DML and its two-phase commit through the port, against the
JAX package.

The tests of tests/test_data_plane.py that modify a table with shards on
two coordinators, each run on three pairs (``tests/test_torch_net.py
_open_pair``): two port coordinators, a ``citus_tpu`` authority whose
peer is the port (the 2PC's coordinator is the reference, its branch the
port), and the reverse.  Every count they assert is the one the
reference's own test asserts on a ``citus_tpu`` pair, and
``test_cross_host_steps_match_the_reference`` holds a sequence of
forwarded, two-phase, interactive and routed writes row for row against
a ``citus_tpu`` pair.  Also here: the recovery tests of
tests/test_transactions.py on both packages,
``recover_prepared_transactions``, and the refusal to forward a modify
that a role's policy rewrote (its SQL text is not the statement that
ran).
"""

import fcntl
import importlib
import os
import sys
import uuid

import numpy as np
import pytest

import citus_tpu as ct
import citus_tpu_torch as ctt

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_net import _open_pair  # noqa: E402

PAIRS = {"port": (ctt, ctt), "ref_coordinator": (ct, ctt),
         "ref_branch": (ctt, ct)}


@pytest.fixture(params=list(PAIRS))
def pair(request, tmp_path):
    a_pkg, b_pkg = PAIRS[request.param]
    a, b = _open_pair(tmp_path, a_pkg, b_pkg)
    try:
        yield a, b
    finally:
        b.close()
        a.close()


def _pkg(cl):
    return ctt if isinstance(cl, ctt.Cluster) else ct


def _mod(cl, name):
    """``<package of cl>.<name>``, imported."""
    return importlib.import_module(f"{_pkg(cl).__name__}.{name}")


def _clear_device_caches():
    from citus_tpu.executor.device_cache import GLOBAL_CACHE as ref_cache
    from citus_tpu_torch.executor.device_cache import GLOBAL_CACHE
    GLOBAL_CACHE.clear()
    ref_cache.clear()


def _make(a, b, name, n, v=0):
    """Create and fill ``name`` through A.  B reloads its catalog before
    the COPY: a citus_tpu peer's ingest can outrun the DDL's
    invalidation and drop the rows (ROADMAP.md C6)."""
    a.execute(f"CREATE TABLE {name} (k bigint NOT NULL, v bigint)")
    a.execute(f"SELECT create_distributed_table('{name}', 'k', 4)")
    b._reload_catalog()
    a.copy_from(name, columns={"k": np.arange(n),
                               "v": np.full(n, v, np.int64)})


def _keys_on(cl, table, n, node):
    from citus_tpu_torch.catalog.hashing import shard_index_for_values
    t = cl.catalog.table(table)
    idx = shard_index_for_values(np.arange(n, dtype=np.int64), t.shard_count)
    return [k for k in range(n) if t.shards[idx[k]].placements[0] == node]


def test_remote_write_restrictions(pair):
    a, b = pair
    a.execute("CREATE TABLE r (k bigint NOT NULL, v bigint)")
    a.execute("SELECT create_distributed_table('r', 'k', 4)")
    s = a.session()
    s.execute("BEGIN")
    with pytest.raises(_mod(a, "errors").UnsupportedFeatureError,
                       match="cross-host 2PC"):
        s.execute("INSERT INTO r VALUES (1, 2)")
    s.execute("ROLLBACK")


def test_update_delete_on_remote_shards_visible(pair):
    a, b = pair
    n = 400
    _make(a, b, "d", n)
    b._maybe_reload_catalog(force_sync=True)
    assert b.execute("SELECT count(*) FROM d").rows == [(n,)]
    local = _keys_on(b, "d", n, 1)[:5]
    deleted = sum(b.execute(f"DELETE FROM d WHERE k = {k}").explain["deleted"]
                  for k in local)
    assert deleted == len(local) > 0
    _clear_device_caches()
    assert a.execute("SELECT count(*) FROM d").rows == [(n - deleted,)]


def test_remote_dml_forwarding_and_guard(pair):
    """A router modify of a shard on the peer forwards its SQL text; a
    modify over both hosts runs as a cross-host 2PC."""
    a, b = pair
    n = 500
    _make(a, b, "w", n)
    k0 = _keys_on(a, "w", n, 1)[0]
    assert a.execute(f"UPDATE w SET v = 7 WHERE k = {k0}").explain.get(
        "updated") == 1
    _clear_device_caches()
    assert a.execute(f"SELECT v FROM w WHERE k = {k0}").rows == [(7,)]
    assert a.execute(f"DELETE FROM w WHERE k = {k0}").explain.get(
        "deleted") == 1
    _clear_device_caches()
    assert a.execute("SELECT count(*) FROM w").rows == [(n - 1,)]
    r = a.execute("UPDATE w SET v = 9")
    assert r.explain.get("updated") == n - 1 and "gxid" in r.explain
    _clear_device_caches()
    assert a.execute("SELECT sum(v) FROM w").rows == [(9 * (n - 1),)]


def test_reference_table_modify_is_refused(pair):
    """A reference table's replicas span both hosts: a modify is
    refused (it would diverge them), as in the reference."""
    a, b = pair
    a.execute("CREATE TABLE ref (id bigint NOT NULL, name text)")
    a.execute("SELECT create_reference_table('ref')")
    b._reload_catalog()
    a.copy_from("ref", rows=[(1, "one"), (2, "two"), (3, "three")])
    b._maybe_reload_catalog(force_sync=True)
    assert b.execute("SELECT count(*) FROM ref").rows == [(3,)]
    with pytest.raises(_mod(a, "errors").UnsupportedFeatureError,
                       match="reference table"):
        a.execute("DELETE FROM ref WHERE id = 1")


def test_insert_select_routes_to_remote_host(pair):
    a, b = pair
    a.execute("CREATE TABLE src (k bigint NOT NULL, v bigint)")
    a.execute("SELECT create_distributed_table('src', 'k', 4)")
    a.execute("CREATE TABLE dst (k bigint NOT NULL, v bigint)")
    a.execute("SELECT create_distributed_table('dst', 'k', 4, 'src')")
    n = 800
    b._reload_catalog()
    a.copy_from("src", columns={"k": np.arange(n), "v": np.arange(n) * 2})
    r = a.execute("INSERT INTO dst SELECT k, v FROM src")
    assert r.explain["inserted"] == n
    assert r.explain["strategy"] == "insert_select:pull"
    assert a.execute("SELECT count(*), sum(v) FROM dst").rows == \
        [(n, n * (n - 1))]
    t = a.catalog.table("dst")
    for s in t.shards:
        if s.placements[0] == 1:
            assert not os.path.isdir(a.catalog.shard_dir("dst", s.shard_id, 1))


def test_truncate_forwards_to_remote_host(pair):
    a, b = pair
    _make(a, b, "tr", 300, v=1)
    assert a.execute("SELECT count(*) FROM tr").rows == [(300,)]
    a.execute("TRUNCATE tr")
    _clear_device_caches()
    assert a.execute("SELECT count(*) FROM tr").rows == [(0,)]
    b._maybe_reload_catalog(force_sync=True)
    assert b.execute("SELECT count(*) FROM tr").rows == [(0,)]


def test_vacuum_runs_on_the_local_placements(pair):
    """VACUUM of a table with shards on both hosts compacts the local
    placements, as in the reference, and reads stay whole."""
    a, b = pair
    _make(a, b, "vc", 300, v=1)
    a.execute("DELETE FROM vc WHERE k < 100")
    r = a.execute("VACUUM vc")
    assert r.explain is not None
    _clear_device_caches()
    assert a.execute("SELECT count(*), sum(v) FROM vc").rows == [(200, 200)]


def test_merge_into_remote_shards_fails_closed(pair):
    a, b = pair
    a.execute("CREATE TABLE mt (k bigint NOT NULL, v bigint)")
    a.execute("SELECT create_distributed_table('mt', 'k', 4)")
    a.execute("CREATE TABLE ms (k bigint NOT NULL, v bigint)")
    a.execute("SELECT create_distributed_table('ms', 'k', 4, 'mt')")
    with pytest.raises(_mod(a, "errors").UnsupportedFeatureError,
                       match="remote-hosted"):
        a.execute("MERGE INTO mt USING ms ON mt.k = ms.k "
                  "WHEN MATCHED THEN UPDATE SET v = ms.v "
                  "WHEN NOT MATCHED THEN INSERT VALUES (ms.k, ms.v)")


def test_multi_host_update_two_phase_commit(pair):
    a, b = pair
    n = 600
    _make(a, b, "tp", n)
    r = a.execute("UPDATE tp SET v = 5 WHERE k % 2 = 0")
    assert r.explain.get("updated") == n // 2 and "gxid" in r.explain
    _clear_device_caches()
    assert a.execute("SELECT sum(v) FROM tp").rows == [(5 * n // 2,)]
    b._maybe_reload_catalog(force_sync=True)
    assert b.execute("SELECT sum(v) FROM tp").rows == [(5 * n // 2,)]
    r = a.execute("DELETE FROM tp WHERE v = 5")
    assert r.explain.get("deleted") == n // 2
    _clear_device_caches()
    assert a.execute("SELECT count(*) FROM tp").rows == [(n // 2,)]
    assert a.execute("SELECT recover_prepared_transactions()").rows == [(0,)]


def test_multi_host_update_aborts_atomically_on_branch_failure(pair):
    """B's branch cannot take its write lock (a foreign holder keeps the
    colocation group's flock): the whole statement aborts, on A too."""
    a, b = pair
    n = 400
    _make(a, b, "ab", n)
    bw = _mod(b, "transaction.write_locks")
    res = bw.group_resource(b.catalog.table("ab"))
    fd = open(bw.lockfile_path(b.catalog.data_dir, res), "w")
    fcntl.flock(fd, fcntl.LOCK_EX)
    b.settings.executor.lock_timeout_s = 1.0
    try:
        with pytest.raises(Exception):
            a.execute("UPDATE ab SET v = 9")
    finally:
        fcntl.flock(fd, fcntl.LOCK_UN)
        fd.close()
    _clear_device_caches()
    assert a.execute("SELECT sum(v) FROM ab").rows == [(0,)]
    b._maybe_reload_catalog(force_sync=True)
    assert b.execute("SELECT sum(v) FROM ab").rows == [(0,)]


def test_branch_resolves_from_outcome_store_when_decide_lost(pair):
    a, b = pair
    _make(a, b, "rb", 200)
    ep = ("127.0.0.1", b.data_port)
    gxid = uuid.uuid4().hex
    r = a.catalog.remote_data.call(
        ep, "dml_prepare", {"gxid": gxid, "sql": "UPDATE rb SET v = 3"})
    assert r["explain"]["updated"] > 0
    a._control.record_txn_outcome(gxid, "commit")
    b._data_server.BRANCH_EXPIRE_S = 0.0
    b._data_server._expire_stale_branches()
    _clear_device_caches()
    assert [row for row in b.execute("SELECT k, v FROM rb").rows
            if row[1] == 3], "B's branch must have committed from the store"
    gxid2 = uuid.uuid4().hex
    a.catalog.remote_data.call(
        ep, "dml_prepare", {"gxid": gxid2, "sql": "UPDATE rb SET v = 8"})
    b._data_server._expire_stale_branches()
    _clear_device_caches()
    assert not [row for row in b.execute("SELECT v FROM rb").rows
                if row[0] == 8]


def test_interactive_cross_host_transaction_commit(pair):
    a, b = pair
    n = 400
    _make(a, b, "it", n)
    s = a.session()
    s.execute("BEGIN")
    assert s.execute("UPDATE it SET v = 1 WHERE k % 2 = 0").explain.get(
        "updated") == n // 2
    assert s.execute("UPDATE it SET v = v + 10 WHERE k % 2 = 0").explain.get(
        "updated") == n // 2
    _clear_device_caches()
    assert a.execute("SELECT sum(v) FROM it").rows == [(0,)]
    s.execute("COMMIT")
    _clear_device_caches()
    assert a.execute("SELECT sum(v) FROM it").rows == [(11 * n // 2,)]
    b._maybe_reload_catalog(force_sync=True)
    assert b.execute("SELECT sum(v) FROM it").rows == [(11 * n // 2,)]


def test_interactive_cross_host_transaction_rollback(pair):
    a, b = pair
    _make(a, b, "ir", 200)
    s = a.session()
    s.execute("BEGIN")
    s.execute("UPDATE ir SET v = 7")
    s.execute("ROLLBACK")
    _clear_device_caches()
    assert a.execute("SELECT sum(v) FROM ir").rows == [(0,)]
    b._maybe_reload_catalog(force_sync=True)
    assert b.execute("SELECT sum(v) FROM ir").rows == [(0,)]


def test_interactive_cross_host_restrictions(pair):
    a, b = pair
    _make(a, b, "rr", 100)
    err = _mod(a, "errors").UnsupportedFeatureError
    s = a.session()
    s.execute("BEGIN")
    s.execute("UPDATE rr SET v = 1")
    with pytest.raises(err, match="remote-hosted"):
        s.execute("SELECT count(*) FROM rr")
    s.execute("ROLLBACK")
    s = a.session()
    s.execute("BEGIN")
    s.execute("UPDATE rr SET v = 2")
    with pytest.raises(err, match="savepoint"):
        s.execute("SAVEPOINT sp")
    s.execute("ROLLBACK")


def _steps(a, b, n):
    """Forwarded, two-phase, interactive and routed writes; -> what A
    and B read after each."""
    out = []

    def read():
        _clear_device_caches()
        b._maybe_reload_catalog(force_sync=True)
        sql = "SELECT count(*), sum(v), sum(k) FROM w"
        out.append((a.execute(sql).rows, b.execute(sql).rows))

    _make(a, b, "w", n)
    k0 = _keys_on(a, "w", n, 1)[0]
    for sql in (f"UPDATE w SET v = 7 WHERE k = {k0}",
                "UPDATE w SET v = v + 5 WHERE k % 3 = 0",
                "DELETE FROM w WHERE k % 7 = 1"):
        r = a.execute(sql)
        out.append({k: v for k, v in r.explain.items()
                    if k in ("updated", "deleted")})
        read()
    s = a.session()
    for sql in ("BEGIN", "UPDATE w SET v = v * 2 WHERE k < 300", "COMMIT",
                "BEGIN", "DELETE FROM w WHERE k < 200", "ROLLBACK"):
        s.execute(sql)
    read()
    r = a.execute("INSERT INTO w SELECT k + 10000, v FROM w WHERE k < 40")
    out.append((r.explain["inserted"], r.explain["strategy"]))
    read()
    out.append(a.execute("SELECT recover_prepared_transactions()").rows)
    a.execute("TRUNCATE w")
    read()
    return out


def test_cross_host_steps_match_the_reference(pair, tmp_path):
    """The same writes on this pair and on a citus_tpu pair: the same
    counts and the same rows read back on both coordinators."""
    a, b = pair
    got = _steps(a, b, 500)
    ra, rb = _open_pair(tmp_path / "reference", ct, ct)
    try:
        want = _steps(ra, rb, 500)
    finally:
        rb.close()
        ra.close()
    assert got == want


@pytest.mark.parametrize("pkg", ["citus_tpu", "citus_tpu_torch"])
def test_policy_rewritten_modify_is_not_forwarded(tmp_path, pkg):
    """A modify that a role's policy rewrote has no SQL text of its own:
    forwarding it would run it on the other host without the policy.
    Both packages refuse it and no row on the other host changes."""
    mod = ct if pkg == "citus_tpu" else ctt
    a, b = _open_pair(tmp_path, mod, mod)
    try:
        n = 200
        _make(a, b, "w", n)
        a.execute("CREATE ROLE tenant")
        a.execute("GRANT SELECT, UPDATE, DELETE ON w TO tenant")
        a.execute("ALTER TABLE w ENABLE ROW LEVEL SECURITY")
        a.execute("CREATE POLICY own ON w USING (k < 100)")
        k0 = _keys_on(a, "w", n, 1)[0]
        err = importlib.import_module(f"{pkg}.errors").UnsupportedFeatureError
        for sql in (f"UPDATE w SET v = 1 WHERE k = {k0}", "UPDATE w SET v = 1",
                    "DELETE FROM w"):
            with pytest.raises(err, match="no original SQL text"):
                a.execute(sql, role="tenant")
        _clear_device_caches()
        b._maybe_reload_catalog(force_sync=True)
        assert b.execute("SELECT count(*), sum(v) FROM w").rows == [(n, 0)]
        assert a.execute("SELECT count(*), sum(v) FROM w").rows == [(n, 0)]
    finally:
        b.close()
        a.close()


def test_foreign_key_probe_of_a_remote_hosted_parent(pair):
    """A parent whose shards both coordinators host is probed by a
    SELECT through the executor, the reference's path: a local child's
    keys are checked against every shard of the parent.  The parent's
    own COPY is refused (a unique index cannot span hosts), in both
    packages, so every child key is missing."""
    a, b = pair
    a.execute("CREATE TABLE dp (k bigint NOT NULL PRIMARY KEY, v bigint)")
    a.execute("SELECT create_distributed_table('dp', 'k', 4)")
    b._reload_catalog()
    err = _mod(a, "errors")
    with pytest.raises(err.UnsupportedFeatureError,
                       match="cannot span remote-hosted shards"):
        a.copy_from("dp", columns={"k": np.arange(100),
                                   "v": np.arange(100)})
    a.execute("CREATE TABLE lc (k bigint REFERENCES dp(k), w bigint)")
    assert all(p == [0] for p in
               (s.placements for s in a.catalog.table("lc").shards))
    for k in (0, 7):
        with pytest.raises(_mod(a, "integrity").ForeignKeyViolation,
                           match=f"Key \\(k\\)=\\({k}\\) is not present"):
            a.execute(f"INSERT INTO lc VALUES ({k}, 1)")
    a.execute("INSERT INTO lc VALUES (NULL, 1)")
    assert a.execute("SELECT count(*) FROM lc").rows == [(1,)]


def test_two_os_processes_two_data_dirs(tmp_path):
    """Coordinators in two OS processes with data directories of their
    own: a distributed query over both, and a two-phase UPDATE whose
    branch runs in the other process (test_data_plane.py's test, with
    the shard move of A14c left out)."""
    import subprocess
    import textwrap
    a = ctt.Cluster(str(tmp_path / "a"), serve_port=0, data_port=0,
                    hosted_nodes=set(), n_nodes=0, device="cpu")
    na = a.register_node()
    worker = textwrap.dedent(f"""
        import sys, time
        sys.path.insert(0, {os.path.dirname(os.path.dirname(os.path.abspath(__file__)))!r})
        import citus_tpu_torch as ctt
        b = ctt.Cluster({str(tmp_path / 'b')!r}, data_port=0,
                        hosted_nodes=set(), n_nodes=0, device="cpu",
                        coordinator=("127.0.0.1", {a.control_port}))
        nb = b.register_node()
        print("READY", nb, flush=True)
        sys.stdout.close()
        time.sleep(120)
    """)
    proc = subprocess.Popen([sys.executable, "-c", worker],
                            stdout=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline().split()
        assert line and line[0] == "READY", f"worker failed: {line}"
        nb = int(line[1])
        a._maybe_reload_catalog(force_sync=True)
        a.execute("CREATE TABLE big (k bigint NOT NULL, v bigint)")
        a.execute("SELECT create_distributed_table('big', 'k', 4)")
        n = 3000
        a.copy_from("big", columns={"k": np.arange(n), "v": np.arange(n)})
        t = a.catalog.table("big")
        assert {s.placements[0] for s in t.shards} == {na, nb}
        assert a.execute("SELECT count(*), sum(v) FROM big").rows == \
            [(n, n * (n - 1) // 2)]
        r = a.execute("UPDATE big SET v = 1 WHERE k % 3 = 0")
        assert r.explain["updated"] == n // 3 and "gxid" in r.explain
        want = n * (n - 1) // 2 - sum(range(0, n, 3)) + n // 3
        assert a.execute("SELECT count(*), sum(v) FROM big").rows == \
            [(n, want)]
        assert a.execute("SELECT recover_prepared_transactions()").rows \
            == [(0,)]
    finally:
        proc.kill()
        proc.wait()
        a.close()


def test_rpc_auth_rejects_unauthenticated_peer(tmp_path):
    """Registration, catalog fetch and the data plane refuse a client
    with no secret or a wrong one; the right secret attaches."""
    from citus_tpu_torch.net.rpc import RpcClient, RpcError
    a = ctt.Cluster(str(tmp_path / "a"), serve_port=0, data_port=0,
                    hosted_nodes=set(), n_nodes=0, secret=b"s3cret",
                    device="cpu")
    b = None
    try:
        a.register_node()
        for secret in (None, b"wrong"):
            c = RpcClient("127.0.0.1", a.control_port, secret=secret)
            with pytest.raises(RpcError):
                c.call("fetch_catalog")
            c.close()
        b = ctt.Cluster(str(tmp_path / "b"), data_port=0, hosted_nodes=set(),
                        n_nodes=0, coordinator=("127.0.0.1", a.control_port),
                        secret=b"s3cret", device="cpu")
        assert b.register_node() in b.catalog.nodes
        dc = RpcClient("127.0.0.1", a.data_port)
        for method, payload in (
                ("list_placement", {"table": "x", "shard_id": 1, "node": 0}),
                ("execute_sql", {"sql": "SELECT 1"})):
            with pytest.raises(RpcError):
                dc.call(method, payload)
        dc.close()
    finally:
        if b is not None:
            b.close()
        a.close()


# ----------------------------------------------------------- recovery

def _make_cluster(mod, d):
    kw = {"device": "cpu"} if mod is ctt else {}
    cl = mod.Cluster(d, n_nodes=2, **kw)
    cl.execute("CREATE TABLE t (k bigint NOT NULL, v bigint)")
    cl.execute("SELECT create_distributed_table('t', 'k', 4)")
    return cl


def _staged_ingest(mod, cl, n=1000):
    ingest = importlib.import_module(f"{mod.__name__}.ingest")
    t = cl.catalog.table("t")
    values, validity = ingest.encode_columns(cl.catalog, t, {
        "k": np.arange(n, dtype=np.int64), "v": np.ones(n, dtype=np.int64)})
    ing = ingest.TableIngestor(cl.catalog, t, txlog=cl.txlog)
    ing.append(values, validity)
    for w in ing._writers.values():
        w.flush()
    return ing


def _recover(tmp_path, mod, records):
    """``records`` of the TxState names logged after a staged ingest,
    the coordinator 'dying' after them -> (count, outstanding, staged
    files left) after the reopen."""
    d = str(tmp_path / mod.__name__ / "db")
    cl = _make_cluster(mod, d)
    ing = _staged_ingest(mod, cl)
    TxState = importlib.import_module(
        f"{mod.__name__}.transaction.manager").TxState
    dirs = [w.directory for w in ing._writers.values()]
    for rec in records:
        cl.txlog.log(ing.xid, getattr(TxState, rec),
                     {"kind": "ingest", "table": "t", "placements": dirs})
    cl.close()
    kw = {"device": "cpu"} if mod is ctt else {}
    cl2 = mod.Cluster(d, n_nodes=2, **kw)
    try:
        staged = sum(".staged." in f for _, _, fs in os.walk(d) for f in fs)
        return (cl2.execute("SELECT count(*) FROM t").rows,
                cl2.txlog.outstanding(), staged,
                cl2.execute("SELECT recover_prepared_transactions()").rows)
    finally:
        cl2.close()


@pytest.mark.parametrize("records,count", [
    ((), 0), (("PREPARED",), 0), (("PREPARED", "COMMITTED"), 1000)],
    ids=["unprepared_staged_files_swept", "prepared_rolls_back",
         "committed_rolls_forward"])
def test_recovery_after_a_crash_matches_the_reference(tmp_path, records,
                                                      count):
    """test_transactions.py's recovery tests: a coordinator dies with a
    staged ingest before any record, after PREPARED, or after COMMITTED
    before the flip; the reopen rolls back, back, forward, sweeps the
    staged files, and leaves nothing for recover_prepared_transactions."""
    want = _recover(tmp_path, ct, records)
    got = _recover(tmp_path, ctt, records)
    assert got == want
    assert want == ([(count,)], [], 0, [(0,)])


@pytest.mark.parametrize("name", list(PAIRS) + ["reference"])
def test_c22_direct_group_key_zero_reads_null_on_a_pair(tmp_path, name):
    """ROADMAP.md C22, a reference fault the port mirrors: on two
    coordinators a direct GROUP BY returns the group of key 0 with a
    NULL key, pushed or pulled, while one coordinator returns 0."""
    a_pkg, b_pkg = PAIRS.get(name, (ct, ct))
    a, b = _open_pair(tmp_path, a_pkg, b_pkg)
    try:
        _make(a, b, "g0", 200)
        for mode in ("auto", "pull"):
            a.execute(f"SET citus.remote_task_execution = {mode}")
            rows = a.execute("SELECT k, count(*) FROM g0 WHERE k < 3 "
                             "GROUP BY k").rows
            assert sorted(rows, key=repr) == [(1, 1), (2, 1), (None, 1)]
    finally:
        b.close()
        a.close()
