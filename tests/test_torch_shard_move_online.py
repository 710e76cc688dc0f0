"""The non-blocking shard move and split of the port under live
writes, with fault-injected crash recovery, against the JAX package.

tests/test_shard_move_online.py's tests, each run through both packages
(``pkg``: ``citus_tpu`` and ``citus_tpu_torch`` on the CPU): writers
during a background move and a split (zero failed writes, every
committed row readable after the flip, the blocked-write window a
fraction of the move), deletes during a move, a mover killed in a child
process at each phase (``shard_move_copy``, ``shard_move_catchup``,
``shard_move_flip``) whose orphan the next cleaner pass adopts, the
cleaner's exactly-once adoption, the stale partial stripe, the GUCs and
the stats view.  The records a dead mover of one package leaves are
adopted by the other package's cleaner (the same files on disk).
"""

import importlib
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

PKGS = ["citus_tpu", "citus_tpu_torch"]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(params=PKGS)
def pkg(request):
    return request.param


def _m(pkg, name=None):
    return importlib.import_module(pkg if name is None else f"{pkg}.{name}")


def _open(pkg, d, **kw):
    if pkg == "citus_tpu_torch":
        kw["device"] = "cpu"
    return _m(pkg).Cluster(d, **kw)


@pytest.fixture(autouse=True)
def _disarm():
    yield
    for p in PKGS:
        _m(p, "testing.faults").FAULTS.disarm()


def make_cluster(pkg, tmp_path, nodes=2, rows=4000, cdc=True, daemon=True):
    Settings = _m(pkg, "config").Settings
    cl = _open(pkg, str(tmp_path / "db"), n_nodes=nodes,
               settings=Settings(enable_change_data_capture=cdc,
                                 start_maintenance_daemon=daemon))
    cl.execute("CREATE TABLE t (k bigint NOT NULL, v bigint)")
    cl.execute("SELECT create_distributed_table('t', 'k', 4)")
    cl.copy_from("t", columns={"k": np.arange(rows, dtype=np.int64),
                               "v": np.arange(rows, dtype=np.int64) % 97})
    return cl


def _move_args(cl):
    shard = cl.catalog.table("t").shards[0]
    src = shard.placements[0]
    return shard.shard_id, src, 1 - src if src in (0, 1) else 0


# ------------------------------------------------- writer availability

def test_writer_hammer_during_background_move(pkg, tmp_path):
    """The headline availability contract: N writer threads hammer the
    table for the whole duration of a background shard move — zero
    failed writes, every row readable after the flip, and the
    blocked-write window (the only stretch writers are excluded) is a
    fraction of the total move time."""
    cl = make_cluster(pkg, tmp_path)
    try:
        sid, src, dst = _move_args(cl)
        # slow the bulk copy pass only (times=1) so writers demonstrably
        # overlap the move; catch-up and flip passes run at full speed
        _m(pkg, "testing.faults").FAULTS.arm("shard_move_copy", delay_s=0.4,
                                             times=1)
        jid = cl.background_jobs.create_job("online move")
        cl.background_jobs.add_task(
            jid, "move_shard", {"shard_id": sid, "source": src,
                                "target": dst})
        stop = threading.Event()
        wrote, failures = [], []

        def hammer(base):
            i = 0
            while not stop.is_set():
                k = base + i * 8
                try:
                    cl.execute(f"INSERT INTO t VALUES ({k}, {k % 97})")
                    wrote.append(k)
                except Exception as e:  # any failed write breaks the contract
                    failures.append(e)
                i += 1

        threads = [threading.Thread(target=hammer, args=(100000 + n,))
                   for n in range(4)]
        for th in threads:
            th.start()
        status = cl.background_jobs.wait_for_job(jid)
        stop.set()
        for th in threads:
            th.join()
        assert status == "done"
        assert not failures, failures[:3]
        assert wrote, "hammer never ran"
        cl._plan_cache.clear()
        assert cl.catalog.table("t").shards[0].placements == [dst]
        assert cl.execute("SELECT count(*) FROM t").rows[0][0] == \
            4000 + len(wrote)
        # per-move stats: catch-up ran, and the blocked window is a
        # fraction of the total (the bulk pass alone took >= 400 ms)
        r = cl.execute("SELECT citus_shard_move_stats()")
        d = [dict(zip(r.columns, row)) for row in r.rows
             if row[0] == "move" and row[1] == sid][-1]
        assert d["catchup_rounds"] >= 1
        assert d["total_ms"] >= 400
        assert d["blocked_write_ms"] < 0.5 * d["total_ms"]
        snap = cl.counters.snapshot()
        assert snap.get("shard_move_catchup_rounds", 0) >= 1
        assert snap.get("shard_move_blocked_write_ms", 0) >= 0
    finally:
        cl.close()


def test_concurrent_deletes_during_move(pkg, tmp_path):
    """Regression (torn deletes-bitmap copy): DELETEs mutate the
    placement's bitmap file in place while the move's copy passes run;
    the snapshot-under-delete-lock copy must never ship a torn bitmap,
    and no delete may be lost across the flip."""
    cl = make_cluster(pkg, tmp_path)
    try:
        sid, src, dst = _move_args(cl)
        _m(pkg, "testing.faults").FAULTS.arm("shard_move_copy", delay_s=0.1)
        jid = cl.background_jobs.create_job("move under deletes")
        cl.background_jobs.add_task(
            jid, "move_shard", {"shard_id": sid, "source": src,
                                "target": dst})
        stop = threading.Event()
        deleted, failures = [], []

        def deleter(base):
            k = base
            while not stop.is_set() and k < base + 400:
                try:
                    cl.execute(f"DELETE FROM t WHERE k = {k}")
                    deleted.append(k)
                except Exception as e:
                    failures.append(e)
                k += 1

        threads = [threading.Thread(target=deleter, args=(n * 400,))
                   for n in range(2)]
        for th in threads:
            th.start()
        status = cl.background_jobs.wait_for_job(jid)
        stop.set()
        for th in threads:
            th.join()
        assert status == "done"
        assert not failures, failures[:3]
        assert deleted
        cl._plan_cache.clear()
        # every delete that committed is still deleted after the flip
        assert cl.execute("SELECT count(*) FROM t").rows[0][0] == \
            4000 - len(deleted)
        # the shipped bitmap file is valid JSON (not torn mid-write)
        DELETES_FILE = _m(pkg, "storage.deletes").DELETES_FILE
        moved = cl.catalog.shard_dir("t", sid, dst)
        p = os.path.join(moved, DELETES_FILE)
        if os.path.exists(p):
            with open(p) as fh:
                json.load(fh)
    finally:
        cl.close()


def test_split_under_live_writes_and_deletes(pkg, tmp_path):
    """Shard split takes the same non-blocking path: writers keep
    writing through the redistribute, catch-up rounds route the new
    stripes, and a DELETE against an already-routed stripe forces the
    dirty restart — the final table is exact either way."""
    cl = make_cluster(pkg, tmp_path)
    try:
        t = cl.catalog.table("t")
        shard = t.shards[0]
        mid = (shard.hash_min + shard.hash_max) // 2
        _m(pkg, "testing.faults").FAULTS.arm("shard_move_copy", delay_s=0.15,
                                             match="split:")
        stop = threading.Event()
        wrote, deleted, failures = [], [], []

        def writer():
            i = 0
            while not stop.is_set():
                k = 200000 + i * 2
                try:
                    cl.execute(f"INSERT INTO t VALUES ({k}, 1)")
                    wrote.append(k)
                    if i % 7 == 0:
                        cl.execute(f"DELETE FROM t WHERE k = {i * 3}")
                        deleted.append(i * 3)
                except Exception as e:
                    failures.append(e)
                i += 1

        th = threading.Thread(target=writer)
        th.start()
        r = cl.execute("SELECT citus_split_shard_by_split_points("
                       f"{shard.shard_id}, {mid})")
        stop.set()
        th.join()
        assert not failures, failures[:3]
        assert r.rowcount == 2
        cl._plan_cache.clear()
        assert cl.catalog.table("t").shard_count == 5
        expect = 4000 + len(wrote) - len(set(d for d in deleted if d < 4000))
        assert cl.execute("SELECT count(*) FROM t").rows[0][0] == expect
    finally:
        cl.close()


# --------------------------------------------- kill-mid-move recovery

_CHILD = r"""
import importlib, os, sys
sys.path.insert(0, sys.argv[7])
pkg = sys.argv[6]
ct = importlib.import_module(pkg)
FAULTS = importlib.import_module(pkg + ".testing.faults").FAULTS
point, db = sys.argv[1], sys.argv[2]
FAULTS.arm(point, kill=True)
Settings = importlib.import_module(pkg + ".config").Settings
kw = {"device": "cpu"} if pkg == "citus_tpu_torch" else {}
cl = ct.Cluster(db, settings=Settings(start_maintenance_daemon=False), **kw)
sid, src, dst = [int(a) for a in sys.argv[3:6]]
try:
    cl.execute(f"SELECT citus_move_shard_placement({sid}, {src}, {dst})")
except BaseException:
    pass
os._exit(7)  # fault never fired: the parent fails on this exit code
"""


@pytest.mark.parametrize("point", ["shard_move_copy", "shard_move_catchup",
                                   "shard_move_flip"])
def test_kill_mid_move_leaves_source_serving(pkg, tmp_path, point):
    """A mover killed at any phase (bulk copy, catch-up round, inside
    the locked flip window before the commit) leaves the cluster
    serving reads AND writes from the source placement, and the next
    cleaner pass adopts the dead operation via the registry and drops
    the orphaned target."""
    cl = make_cluster(pkg, tmp_path, rows=2000, daemon=False)
    sid, src, dst = _move_args(cl)
    cl.close()
    db = str(tmp_path / "db")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-c", _CHILD, point, db,
         str(sid), str(src), str(dst), pkg, ROOT],
        env=env, timeout=120, capture_output=True)
    assert r.returncode == 1, (point, r.returncode, r.stderr[-2000:])

    Settings = _m(pkg, "config").Settings
    cl2 = _open(pkg, db, settings=Settings(start_maintenance_daemon=False))
    try:
        # catalog never flipped: the source still owns the placement
        assert cl2.catalog.table("t").shards[0].placements == [src]
        # reads and writes keep working from the source
        assert cl2.execute("SELECT count(*) FROM t").rows[0][0] == 2000
        cl2.execute("INSERT INTO t VALUES (500000, 1)")
        assert cl2.execute("SELECT count(*) FROM t").rows[0][0] == 2001
        # the next maintenance pass adopts the dead mover's records
        # (registry pid is gone) and drops the orphaned target dir
        ops = _m(pkg, "operations")
        operations_view = ops.operations_view
        pending_cleanup = ops.pending_cleanup
        try_drop_orphaned_resources = ops.try_drop_orphaned_resources
        tgt = cl2.catalog.shard_dir("t", sid, dst)
        had_target = os.path.isdir(tgt)
        try_drop_orphaned_resources(cl2.catalog)
        assert not os.path.isdir(tgt)
        if point != "shard_move_copy":
            # the kill struck after the bulk copy, so the orphan existed
            assert had_target
        # nothing op-gated left parked; the dead registry row is retired
        assert all(r["policy"] not in ("on_failure", "on_success")
                   for r in pending_cleanup(cl2.catalog))
        assert operations_view(cl2.catalog) == {}
        # a re-run of the same move now succeeds end to end
        cl2.execute(f"SELECT citus_move_shard_placement({sid}, {src}, {dst})")
        cl2._plan_cache.clear()
        assert cl2.catalog.table("t").shards[0].placements == [dst]
        assert cl2.execute("SELECT count(*) FROM t").rows[0][0] == 2001
    finally:
        cl2.close()


# ------------------------------------------------ cleaner crash-adoption

def test_cleaner_adopts_crashed_operation_exactly_once(pkg, tmp_path):
    """An operation killed between record_cleanup(ON_FAILURE) and
    complete_operation is adopted by the next pass via the operation
    registry (its pid is dead), and two concurrent cleaners drop the
    orphan exactly once (the cross-process cleanup lock serializes the
    passes)."""
    c = _m(pkg, "operations.cleaner")
    ON_FAILURE, ON_SUCCESS = c.ON_FAILURE, c.ON_SUCCESS
    operations_view, pending_cleanup = c.operations_view, c.pending_cleanup
    record_cleanup, register_operation = c.record_cleanup, c.register_operation
    try_drop_orphaned_resources = c.try_drop_orphaned_resources
    cl = make_cluster(pkg, tmp_path, rows=100, daemon=False)
    try:
        # a pid that is certainly dead (the subprocess already exited)
        dead_proc = subprocess.Popen([sys.executable, "-c", "pass"])
        dead_proc.wait()
        dead_pid = dead_proc
        orphan = str(tmp_path / "db" / "data" / "t" / "shard_9999"
                     / "placement_1")
        os.makedirs(orphan)
        with open(os.path.join(orphan, "junk.cts"), "w") as fh:
            fh.write("half-copied")
        register_operation(cl.catalog, 4242, kind="move_shard",
                          pid=dead_pid.pid)
        record_cleanup(cl.catalog, orphan, ON_FAILURE, operation_id=4242)
        results = []
        barrier = threading.Barrier(2)

        def pass_(n):
            barrier.wait()
            results.append(try_drop_orphaned_resources(cl.catalog))

        ts = [threading.Thread(target=pass_, args=(n,)) for n in range(2)]
        for th in ts:
            th.start()
        for th in ts:
            th.join()
        assert sum(results) == 1  # dropped exactly once across both
        assert not os.path.isdir(orphan)
        assert pending_cleanup(cl.catalog) == []
        assert operations_view(cl.catalog) == {}

        # arbitration keeps resources the committed catalog promoted:
        # an ON_FAILURE record for a LIVE placement (the flip landed an
        # instant before the kill) must survive adoption, and an
        # ON_SUCCESS record for a live placement (the flip never
        # landed) must too
        shard = cl.catalog.table("t").shards[0]
        live = cl.catalog.shard_dir("t", shard.shard_id,
                                    shard.placements[0])
        assert os.path.isdir(live)
        register_operation(cl.catalog, 4343, pid=dead_pid.pid)
        record_cleanup(cl.catalog, live, ON_FAILURE, operation_id=4343)
        register_operation(cl.catalog, 4444, pid=dead_pid.pid)
        record_cleanup(cl.catalog, live, ON_SUCCESS, operation_id=4444)
        try_drop_orphaned_resources(cl.catalog)
        assert os.path.isdir(live)  # promoted by the committed catalog
        assert pending_cleanup(cl.catalog) == []
        # a LIVE op's records are never adopted, dead dirs or not
        register_operation(cl.catalog, 4545)  # this process: alive
        record_cleanup(cl.catalog, str(tmp_path / "inflight"), ON_FAILURE,
                       operation_id=4545)
        assert try_drop_orphaned_resources(cl.catalog) == 0
        assert len(pending_cleanup(cl.catalog)) == 1
    finally:
        cl.close()


# -------------------------------------------------- copy-path regressions

def test_stale_partial_stripe_recopied(pkg, tmp_path):
    """Regression: a stripe truncated by a killed earlier pass exists at
    the target with the right name but the wrong size — the copy loop
    must re-ship it (size-verified skip), not silently keep it."""
    cl = make_cluster(pkg, tmp_path, rows=3000, cdc=False, daemon=False)
    try:
        before = cl.execute("SELECT count(*), sum(v) FROM t").rows
        sid, src, dst = _move_args(cl)
        src_dir = cl.catalog.shard_dir("t", sid, src)
        dst_dir = cl.catalog.shard_dir("t", sid, dst)
        stripes = sorted(n for n in os.listdir(src_dir)
                         if n.endswith(".cts"))
        assert stripes
        os.makedirs(dst_dir)
        with open(os.path.join(src_dir, stripes[0]), "rb") as fh:
            data = fh.read()
        with open(os.path.join(dst_dir, stripes[0]), "wb") as fh:
            fh.write(data[:len(data) // 2])  # the killed pass's leftover
        cl.execute(f"SELECT citus_move_shard_placement({sid}, {src}, {dst})")
        cl._plan_cache.clear()
        assert os.path.getsize(os.path.join(dst_dir, stripes[0])) == len(data)
        assert cl.execute("SELECT count(*), sum(v) FROM t").rows == before
    finally:
        cl.close()


# ------------------------------------------------------- GUCs and stats

def test_shard_move_gucs_roundtrip(pkg, tmp_path):
    cl = _open(pkg, str(tmp_path / "db"), n_nodes=2)
    try:
        for guc, val, shown in [
                ("citus.shard_move_catchup_threshold", "3", "3"),
                ("citus.shard_move_max_catchup_rounds", "7", "7"),
                ("citus.defer_drop_after_shard_move", "off", "off")]:
            cl.execute(f"SET {guc} = {val}")
            assert cl.execute(f"SHOW {guc}").rows[0][0] == shown
        assert cl.settings.sharding.shard_move_catchup_threshold == 3
        assert cl.settings.sharding.shard_move_max_catchup_rounds == 7
        assert cl.settings.sharding.defer_drop_after_shard_move is False
    finally:
        cl.close()


def test_inline_drop_when_defer_disabled(pkg, tmp_path):
    """citus.defer_drop_after_shard_move=off drops the source placement
    inside the move instead of waiting for the next cleaner pass."""
    cl = make_cluster(pkg, tmp_path, rows=500, cdc=False, daemon=False)
    try:
        cl.execute("SET citus.defer_drop_after_shard_move = off")
        sid, src, dst = _move_args(cl)
        cl.execute(f"SELECT citus_move_shard_placement({sid}, {src}, {dst})")
        cl._plan_cache.clear()
        assert not os.path.isdir(cl.catalog.shard_dir("t", sid, src))
        assert cl.execute("SELECT count(*) FROM t").rows[0][0] == 500
    finally:
        cl.close()


def test_move_stats_view_and_split_row(pkg, tmp_path):
    cl = make_cluster(pkg, tmp_path, rows=500, cdc=False, daemon=False)
    try:
        sid, src, dst = _move_args(cl)
        cl.execute(f"SELECT citus_move_shard_placement({sid}, {src}, {dst})")
        t = cl.catalog.table("t")
        shard = t.shards[1]
        mid = (shard.hash_min + shard.hash_max) // 2
        cl.execute("SELECT citus_split_shard_by_split_points("
                   f"{shard.shard_id}, {mid})")
        r = cl.execute("SELECT citus_shard_move_stats()")
        assert r.columns == ["op", "shard_id", "source", "target",
                             "bytes_copied", "catchup_rounds",
                             "blocked_write_ms", "total_ms"]
        ops = {row[0] for row in r.rows}
        assert {"move", "split"} <= ops
        for row in r.rows:
            d = dict(zip(r.columns, row))
            assert d["blocked_write_ms"] >= 0
            assert d["total_ms"] >= d["blocked_write_ms"]
            assert d["catchup_rounds"] >= 1
    finally:
        cl.close()


@pytest.mark.parametrize("mover,cleaner", [
    ("citus_tpu_torch", "citus_tpu"), ("citus_tpu", "citus_tpu_torch")])
def test_the_other_package_adopts_a_move_killed_at_the_flip(
        tmp_path, mover, cleaner):
    """A mover of one package killed inside the flip window leaves its
    registry row and op-gated records in the files both packages share:
    the other package's cleaner adopts them, drops the orphaned target
    and keeps the source, which goes on serving."""
    cl = make_cluster(mover, tmp_path, rows=2000, daemon=False)
    sid, src, dst = _move_args(cl)
    cl.close()
    db = str(tmp_path / "db")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-c", _CHILD, "shard_move_flip", db,
         str(sid), str(src), str(dst), mover, ROOT],
        env=env, timeout=120, capture_output=True)
    assert r.returncode == 1, (r.returncode, r.stderr[-2000:])
    Settings = _m(cleaner, "config").Settings
    cl2 = _open(cleaner, db, settings=Settings(start_maintenance_daemon=False))
    try:
        ops = _m(cleaner, "operations")
        assert len(ops.operations_view(cl2.catalog)) == 1
        tgt = cl2.catalog.shard_dir("t", sid, dst)
        assert os.path.isdir(tgt)
        assert ops.try_drop_orphaned_resources(cl2.catalog) >= 1
        assert not os.path.isdir(tgt)
        assert ops.operations_view(cl2.catalog) == {}
        assert cl2.catalog.table("t").shards[0].placements == [src]
        assert cl2.execute("SELECT count(*), sum(v) FROM t").rows == \
            [(2000, sum(k % 97 for k in range(2000)))]
    finally:
        cl2.close()
