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
ran).  The shard operations across hosts: a move pulled from and pushed
to the other coordinator over the data plane (rows of both
coordinators held against a ``citus_tpu`` pair), a tenant isolated to
the other coordinator's node, and the split of a remote-hosted shard,
which the reference answers by losing its rows and the port refuses
(ROADMAP.md C23).
"""

import fcntl
import importlib
import os
import sys
import time
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
    own: a distributed query over both, a two-phase UPDATE whose branch
    runs in the other process, and a move of a shard the other process
    hosts into this one over the data plane (test_data_plane.py's
    test)."""
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
        # move a remote-hosted shard into this process over the wire
        moved = next(s for s in t.shards if s.placements[0] == nb)
        a.execute(f"SELECT citus_move_shard_placement({moved.shard_id}, "
                  f"{nb}, {na})")
        assert a.execute("SELECT count(*), sum(v) FROM big").rows == \
            [(n, want)]
        t = a.catalog.table("big")
        assert next(s for s in t.shards
                    if s.shard_id == moved.shard_id).placements == [na]
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


def _move_steps(a, b, n):
    """B -> A (a pull over the data plane, the source dropped by RPC),
    then A -> B (a push); the rows of both coordinators after each."""
    a.execute("CREATE TABLE m (k bigint NOT NULL, v bigint)")
    a.execute("SELECT create_distributed_table('m', 'k', 4)")
    b._reload_catalog()
    rng = np.random.default_rng(19)
    a.copy_from("m", columns={"k": np.arange(n),
                              "v": rng.integers(0, 1000, n)})
    na = next(x for x in a.catalog.nodes if not a.catalog.is_remote_node(x))
    nb = next(x for x in a.catalog.nodes if a.catalog.is_remote_node(x))
    out = []

    def read():
        _clear_device_caches()
        b._maybe_reload_catalog(force_sync=True)
        out.append([cl.execute("SELECT k, v FROM m ORDER BY k").rows
                    for cl in (a, b)])
        out.append([cl.execute("SELECT count(*), sum(v) FROM m").rows
                    for cl in (a, b)])
    read()
    t = a.catalog.table("m")
    pulled = next(s for s in t.shards if s.placements[0] == nb).shard_id
    a.execute(f"SELECT citus_move_shard_placement({pulled}, {nb}, {na})")
    assert os.path.isdir(a.catalog.shard_dir("m", pulled, na))
    read()
    t = a.catalog.table("m")
    pushed = next(s for s in t.shards if s.placements[0] == na).shard_id
    a.execute(f"SELECT citus_move_shard_placement({pushed}, {na}, {nb})")
    assert os.path.isdir(b.catalog.shard_dir("m", pushed, nb))
    read()
    out.append(sorted((r[1], r[4]) for r in
                      a.execute("SELECT citus_shards()").rows))
    out.append([r[:6] for r in
                a.execute("SELECT citus_shard_move_stats()").rows[-2:]])
    a.execute("SELECT citus_cleanup_orphaned_resources()")
    b.execute("SELECT citus_cleanup_orphaned_resources()")
    read()
    out.append([os.path.isdir(a.catalog.shard_dir("m", pushed, na)),
                os.path.isdir(b.catalog.shard_dir("m", pulled, nb))])
    return out


def test_move_shard_placement_over_the_wire(pair, tmp_path):
    """A move between two coordinators, in both directions, on a port
    pair and on both mixed pairs: the rows of both coordinators after
    each move, the placements and the move stats equal a
    ``citus_tpu`` pair's, and the sources are gone after cleanup."""
    a, b = pair
    n = 2000
    got = _move_steps(a, b, n)
    ra, rb = _open_pair(tmp_path / "ref", ct, ct)
    try:
        want = _move_steps(ra, rb, n)
    finally:
        rb.close()
        ra.close()
    assert got == want
    assert got[-1] == [False, False]
    assert got[1] == [[(n, got[1][0][0][1])]] * 2


def test_isolate_tenant_to_the_other_coordinators_node(pair, tmp_path):
    """citus_isolate_tenant_to_node to a node the other coordinator
    hosts: the split runs where the shard lives, the move pushes the
    tenant's shard over the data plane."""
    a, b = pair
    _make(a, b, "iso", 1000, v=1)
    na = next(x for x in a.catalog.nodes if not a.catalog.is_remote_node(x))
    nb = next(x for x in a.catalog.nodes if a.catalog.is_remote_node(x))
    t = a.catalog.table("iso")
    key = next(k for k in range(1000)
               if t.shards[t.route_hash(_h(k))].placements[0] == na)
    sid = a.execute(f"SELECT citus_isolate_tenant_to_node('iso', {key}, "
                    f"{nb})").rows[0][0]
    t = a.catalog.table("iso")
    assert next(s for s in t.shards if s.shard_id == sid).placements == [nb]
    assert t.shard_count == 6
    _clear_device_caches()
    b._maybe_reload_catalog(force_sync=True)
    for cl in (a, b):
        assert cl.execute("SELECT count(*), sum(v) FROM iso").rows == \
            [(1000, 1000)]
        assert cl.execute(f"SELECT count(*) FROM iso WHERE k = {key}"
                          ).rows == [(1,)]


def _h(k):
    from citus_tpu_torch.catalog.hashing import hash_int64_scalar
    return hash_int64_scalar(k)


@pytest.mark.parametrize("op", ["split", "isolate"])
def test_c23_split_of_a_remote_hosted_shard(tmp_path, op):
    """ROADMAP.md C23: a split of a shard the other coordinator hosts
    reads and writes local directories only.  The reference's pair
    answers with the remote rows gone (1,000 rows become fewer); the
    port refuses and keeps every row."""
    counts = {}
    for name, pkgs in [("reference", (ct, ct)), ("port", (ctt, ctt))]:
        a, b = _open_pair(tmp_path / name, *pkgs)
        try:
            _make(a, b, "sp", 1000, v=1)
            nb = next(x for x in a.catalog.nodes
                      if a.catalog.is_remote_node(x))
            t = a.catalog.table("sp")
            s = next(s for s in t.shards if s.placements[0] == nb)
            if op == "split":
                sql = (f"SELECT citus_split_shard_by_split_points("
                       f"{s.shard_id}, {(s.hash_min + s.hash_max) // 2})")
            else:
                key = next(k for k in range(1000)
                           if t.shards[t.route_hash(_h(k))] is s)
                sql = f"SELECT isolate_tenant_to_new_shard('sp', {key})"
            try:
                a.execute(sql)
                outcome = "ran"
            except Exception as e:  # noqa: BLE001 -- the outcome compared
                outcome = (type(e).__name__, str(e))
            _clear_device_caches()
            counts[name] = (outcome,
                            a.execute("SELECT count(*) FROM sp").rows[0][0])
        finally:
            b.close()
            a.close()
    assert counts["reference"][0] == "ran"
    assert counts["reference"][1] < 1000
    outcome, n = counts["port"]
    assert outcome[0] == "UnsupportedFeatureError" and "C23" in outcome[1]
    assert n == 1000


def test_c24_rebalance_plan_sizes_remote_placements(tmp_path):
    """ROADMAP.md C24: after a move leaves A one shard and B three, the
    reference's by_disk_size plan on A weighs each of B's placements 1
    byte and plans nothing; the port sizes them over the data plane and
    plans one move back from B to A, which a background job runs (the
    data plane's pull path)."""
    plans = {}
    for name, pkgs in [("reference", (ct, ct)), ("port", (ctt, ctt))]:
        a, b = _open_pair(tmp_path / name, *pkgs)
        try:
            _make(a, b, "rp", 4000, v=1)
            na = next(x for x in a.catalog.nodes
                      if not a.catalog.is_remote_node(x))
            nb = next(x for x in a.catalog.nodes
                      if a.catalog.is_remote_node(x))
            t = a.catalog.table("rp")
            sid = next(s for s in t.shards if s.placements[0] == na).shard_id
            a.execute(f"SELECT citus_move_shard_placement({sid}, {na}, {nb})")
            a.execute("SELECT citus_cleanup_orphaned_resources()")
            plans[name] = a.execute(
                "SELECT get_rebalance_table_shards_plan()").rows
            if name == "port":
                jid = a.execute("SELECT citus_rebalance_start()").rows[0][0]
                assert a.execute(f"SELECT citus_job_wait({jid})").rows == \
                    [("done",)]
                t = a.catalog.table("rp")
                assert sorted(s.placements[0] for s in t.shards) == \
                    [na, na, nb, nb]
                _clear_device_caches()
                assert a.execute("SELECT count(*), sum(v) FROM rp").rows == \
                    [(4000, 4000)]
        finally:
            b.close()
            a.close()
    assert plans["reference"] == []
    assert len(plans["port"]) == 1 and plans["port"][0][1:] == (nb, na)


@pytest.mark.parametrize("how", ["copy", "insert"])
def test_c25_writes_during_a_move_to_the_other_coordinator(tmp_path, how):
    """ROADMAP.md C25: a write that splits its batch by the placement
    map before a move's flip and takes the write lock after it: the
    reference's ingest skips the moved shard's rows as remote, so they
    are lost; the port ships them under the lock.  The flip is held
    0.3 s (fault point ``shard_move_flip``) so a writer always waits
    across it."""
    import threading
    got = {}
    for name, mod in [("reference", ct), ("port", ctt)]:
        faults = importlib.import_module(f"{mod.__name__}.testing.faults")
        a, b = _open_pair(tmp_path / name, mod, mod)
        try:
            _make(a, b, "mw", 20_000, v=1)
            na = next(x for x in a.catalog.nodes
                      if not a.catalog.is_remote_node(x))
            nb = next(x for x in a.catalog.nodes
                      if a.catalog.is_remote_node(x))
            sid = next(s for s in a.catalog.table("mw").shards
                       if s.placements[0] == na).shard_id
            stop, wrote = threading.Event(), [0]

            def writer():
                base = 1_000_000
                while not stop.is_set():
                    ks = np.arange(base, base + 256)
                    if how == "copy":
                        a.copy_from("mw", columns={
                            "k": ks, "v": np.ones(ks.size, np.int64)})
                    else:
                        a.execute("INSERT INTO mw VALUES " + ", ".join(
                            f"({k}, 1)" for k in ks))
                    wrote[0] += ks.size
                    base += ks.size
            faults.FAULTS.arm("shard_move_flip", delay_s=0.3, times=1)
            th = threading.Thread(target=writer)
            th.start()
            try:
                a.execute(f"SELECT citus_move_shard_placement({sid}, {na}, "
                          f"{nb})")
            finally:
                stop.set()
                th.join()
                faults.FAULTS.disarm()
            _clear_device_caches()
            b._maybe_reload_catalog(force_sync=True)
            got[name] = (20_000 + wrote[0],
                         [cl.execute("SELECT count(*), sum(v) FROM mw"
                                     ).rows[0] for cl in (a, b)])
        finally:
            b.close()
            a.close()
    want, rows = got["reference"]
    assert rows[0] == rows[1] and rows[0][0] < want
    want, rows = got["port"]
    assert rows == [(want, want)] * 2


@pytest.mark.parametrize("move,via", [("pull", "b"), ("pull", "a"),
                                      ("push", "b")])
def test_c27_writes_during_a_move_across_coordinators(
        tmp_path, monkeypatch, move, via):
    """ROADMAP.md C27: A moves one of B's shards to its own node (pull),
    or one of its own to B's (push), while a writer commits batches of
    the source's shards through B or through A.  The move is held 0.3 s
    at the flip (fault point ``shard_move_flip``, before the final pull)
    and 0.3 s more between the final pull and the flip's commit.  The
    reference locks only A's data dir: stripes B commits after the final
    pull stay in the dropped source, and a batch a coordinator receives
    after the flip is skipped as remote; or its pull fails on a file B's
    writer removed after the listing.  The port takes B's lock over the
    data plane across the final pull and the flip, a coordinator refuses
    a batch for a shard it no longer hosts, which the sender routes
    again, and the pull passes over a file that vanished."""
    import threading

    from citus_tpu_torch.catalog.hashing import shard_index_for_values
    got = {}
    for name, mod in [("reference", ct), ("port", ctt)]:
        faults = importlib.import_module(f"{mod.__name__}.testing.faults")
        branches = importlib.import_module(
            f"{mod.__name__}.transaction.branches")
        flip = branches.commit_metadata_flip

        def held_flip(cat, op_id, mutate, flip=flip):
            time.sleep(0.3)
            flip(cat, op_id, mutate)
        monkeypatch.setattr(branches, "commit_metadata_flip", held_flip)
        a, b = _open_pair(tmp_path / name, mod, mod)
        try:
            _make(a, b, "pw", 20_000, v=1)
            na = next(x for x in a.catalog.nodes
                      if not a.catalog.is_remote_node(x))
            nb = next(x for x in a.catalog.nodes
                      if a.catalog.is_remote_node(x))
            src, dst = (nb, na) if move == "pull" else (na, nb)
            sid = next(s for s in a.catalog.table("pw").shards
                       if s.placements[0] == src).shard_id
            writer_cl = b if via == "b" else a
            # keys of the source's shards only: in a pull, a batch with
            # rows for A's shards waits for A's lock, which the move
            # holds, and the writer would commit nothing in the window
            pool = np.arange(1_000_000, 1_400_000)
            pool = pool[np.isin(
                shard_index_for_values(pool, 4),
                [i for i, s in enumerate(a.catalog.table("pw").shards)
                 if s.placements[0] == src])]
            stop, wrote = threading.Event(), [0]

            def writer():
                while not stop.is_set() and wrote[0] < pool.size:
                    ks = pool[wrote[0]:wrote[0] + 256]
                    writer_cl.copy_from("pw", columns={
                        "k": ks, "v": np.ones(ks.size, np.int64)})
                    wrote[0] += ks.size
            faults.FAULTS.arm("shard_move_flip", delay_s=0.3, times=1)
            th = threading.Thread(target=writer)
            th.start()
            failed = None
            try:
                a.execute(f"SELECT citus_move_shard_placement({sid}, "
                          f"{src}, {dst})")
            except Exception as e:  # noqa: BLE001 -- the reference's, held below
                failed = str(e)
            finally:
                stop.set()
                th.join()
                faults.FAULTS.disarm()
            a.execute("SELECT citus_cleanup_orphaned_resources()")
            b.execute("SELECT citus_cleanup_orphaned_resources()")
            _clear_device_caches()
            b._maybe_reload_catalog(force_sync=True)
            got[name] = (20_000 + wrote[0], failed,
                         [cl.execute("SELECT count(*), sum(v) FROM pw"
                                     ).rows[0] for cl in (a, b)])
        finally:
            b.close()
            a.close()
    want, failed, rows = got["reference"]
    assert rows[0] == rows[1]
    assert rows[0][0] < want \
        or "No such file or directory" in (failed or "")
    want, failed, rows = got["port"]
    assert failed is None and rows == [(want, want)] * 2


@pytest.mark.parametrize("then", ["pull_back", "read_pulled",
                                  "push_again"])
def test_c26_pull_back_after_writes_on_the_other_coordinator(tmp_path,
                                                              then):
    """ROADMAP.md C26: a shard pushed to B, then written there through A.
    The reference's push stages the copy at B's placement path in A's
    data dir and leaves it there for the cleaner: a move back to A
    copies that stale copy (B's writes are lost), and a pulled read on A
    takes it for the placement.  The port stages outside the placement
    tree and pulls from B.  Pushed to B once more, the shard lands in
    the directory B was asked to drop: B's cleaner deletes it in the
    reference; the port's push claims it on B."""
    got = {}
    for name, mod in [("reference", ct), ("port", ctt)]:
        a, b = _open_pair(tmp_path / name, mod, mod)
        try:
            _make(a, b, "pb", 4000, v=1)
            na = next(x for x in a.catalog.nodes
                      if not a.catalog.is_remote_node(x))
            nb = next(x for x in a.catalog.nodes
                      if a.catalog.is_remote_node(x))
            t = a.catalog.table("pb")
            s = next(s for s in t.shards if s.placements[0] == na)
            a.execute(f"SELECT citus_move_shard_placement({s.shard_id}, "
                      f"{na}, {nb})")
            keys = [k for k in range(4000, 40000)
                    if t.shards[t.route_hash(_h(k))].shard_id == s.shard_id
                    ][:300]
            a.copy_from("pb", columns={"k": np.array(keys),
                                       "v": np.ones(len(keys), np.int64)})
            if then == "read_pulled":
                a.execute("SET citus.remote_task_execution = pull")
            else:
                a.execute(f"SELECT citus_move_shard_placement("
                          f"{s.shard_id}, {nb}, {na})")
            if then == "push_again":
                # back onto B, whose old directory still waits for the
                # drop the previous move asked for by RPC
                a.execute(f"SELECT citus_move_shard_placement("
                          f"{s.shard_id}, {na}, {nb})")
                b.execute("SELECT citus_cleanup_orphaned_resources()")
            _clear_device_caches()
            got[name] = a.execute("SELECT count(*) FROM pb").rows[0][0]
        finally:
            b.close()
            a.close()
    assert got["reference"] < 4300
    assert got["port"] == 4300
