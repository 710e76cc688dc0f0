"""The port's services against the JAX package: the maintenance daemon
and its duties (a distributed deadlock the daemon breaks, branch
expiry, the cleaner), the background job runner's cancel, restore
points, and the eight GUCs of the shard operations and services.

Each test runs the same steps through ``citus_tpu`` and
``citus_tpu_torch`` (on the CPU) and compares what they return: the
daemon's duties and intervals (the reference's ``autopilot`` duty comes
with the flight recorder, ROADMAP.md A14c-2), the rows of every read
(held to numpy too), the jobs' statuses, and SHOW's answers.
"""

import importlib
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import citus_tpu as ct
import citus_tpu_torch as ctt

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_net import _open_pair  # noqa: E402
from torch_write_pair import Pair  # noqa: E402

PKGS = ["citus_tpu", "citus_tpu_torch"]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _m(pkg, name=None):
    return importlib.import_module(pkg if name is None else f"{pkg}.{name}")


def _open(pkg, d, **kw):
    if pkg == "citus_tpu_torch":
        kw["device"] = "cpu"
    return _m(pkg).Cluster(d, **kw)


def _duties(cl):
    """The daemon's (name, interval) rows, without the reference's
    autopilot (not ported: ROADMAP.md A14c-2)."""
    return [(n, i) for n, i, _runs, _errors in cl.maintenance.status()
            if n != "autopilot"]


# ------------------------------------------------------- the daemon

def test_daemon_starts_with_every_cluster_and_close_joins_it(tmp_path):
    out = {}
    for pkg in PKGS:
        cl = _open(pkg, str(tmp_path / pkg / "db"))
        assert cl._maintenance is not None
        th = cl.maintenance._thread
        assert th is not None and th.is_alive()
        out[pkg] = _duties(cl)
        cl.close()
        assert not th.is_alive()
        assert cl.maintenance._thread is None
        st = _m(pkg, "config").Settings(start_maintenance_daemon=False)
        cl2 = _open(pkg, str(tmp_path / pkg / "db2"), settings=st)
        assert cl2._maintenance is None
        cl2.close()
    assert out["citus_tpu"] == out["citus_tpu_torch"]
    assert [n for n, _ in out["citus_tpu_torch"]] == [
        "deferred_cleanup", "transaction_recovery", "deadlock_detection"]


def test_daemon_duties_on_a_pair(tmp_path):
    """With a data server and a control plane attached the daemon also
    expires branches and watches the authority, on both packages."""
    got = {}
    for pkg in PKGS:
        a, b = _open_pair(tmp_path / pkg, _m(pkg), _m(pkg))
        try:
            got[pkg] = (_duties(a), _duties(b))
            a.maintenance.run_once()
            b.maintenance.run_once()
            assert all(errors == 0 for cl in (a, b)
                       for *_, errors in cl.maintenance.status())
        finally:
            b.close()
            a.close()
    assert got["citus_tpu"] == got["citus_tpu_torch"]
    names = [n for n, _ in got["citus_tpu_torch"][1]]
    assert names == ["deferred_cleanup", "transaction_recovery",
                     "branch_expiry", "deadlock_detection",
                     "authority_watch"]


def test_duty_intervals_follow_set(tmp_path):
    """The deadlock and authority intervals are re-read every tick, so
    SET changes them on a running daemon; the daemon runs the
    deadlock duty first (priority 10)."""
    for pkg in PKGS:
        cl = _open(pkg, str(tmp_path / pkg))
        try:
            cl.execute("SET citus.distributed_deadlock_detection_interval "
                       "= 0.5")
            cl.execute("SET citus.authority_watch_interval = 3")
            assert dict(_duties(cl))["deadlock_detection"] == 0.5
            assert cl.maintenance._ordered()[0].name == "deadlock_detection"
        finally:
            cl.close()


DEADLOCK_CHILD = r"""
import importlib, os, sys, time
sys.path.insert(0, sys.argv[4])
pkg = sys.argv[3]
if pkg == "citus_tpu":
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
ct = importlib.import_module(pkg)
cfg = importlib.import_module(pkg + ".config")
DeadlockDetected = importlib.import_module(
    pkg + ".transaction.locks").DeadlockDetected
data_dir, sync_dir = sys.argv[1], sys.argv[2]
kw = {"device": "cpu"} if pkg == "citus_tpu_torch" else {}
# no daemon here: only the parent's daemon can break the cycle
cl = ct.Cluster(data_dir, settings=cfg.Settings(
    start_maintenance_daemon=False,
    executor=cfg.ExecutorSettings(lock_timeout_s=120.0)), **kw)
s = cl.session()
s.execute("BEGIN")
s.execute("UPDATE a SET v = v + 1 WHERE k = 1")
open(os.path.join(sync_dir, "child_locked_a"), "w").close()
deadline = time.time() + 30
while not os.path.exists(os.path.join(sync_dir, "parent_locked_b")):
    if time.time() > deadline:
        print("SYNC_TIMEOUT"); sys.exit(2)
    time.sleep(0.05)
try:
    s.execute("UPDATE b SET v = v + 1 WHERE k = 1")
    print("CHILD_COMPLETED")
except DeadlockDetected:
    print("CHILD_DEADLOCK_VICTIM")
    s.execute("ROLLBACK")
except Exception as e:
    print("CHILD_OTHER:" + type(e).__name__)
cl.close()
"""


@pytest.mark.parametrize("child_pkg", PKGS)
def test_daemon_breaks_a_distributed_deadlock(tmp_path, child_pkg):
    """Two processes take two colocation groups' write locks in
    opposite order.  The child runs no daemon; the port's daemon, its
    interval shortened by SET, finds the cycle and cancels the younger
    transaction (the child's) long before the 120 s lock timeout.  The
    child is a port or a ``citus_tpu`` process: the lock records on
    disk are the reference's."""
    data_dir = str(tmp_path / "db")
    sync_dir = str(tmp_path / "sync")
    os.makedirs(sync_dir)
    from citus_tpu_torch.config import ExecutorSettings, Settings
    cl = ctt.Cluster(data_dir, device="cpu", settings=Settings(
        executor=ExecutorSettings(lock_timeout_s=120.0)))
    child = None
    try:
        cl.execute("SET citus.distributed_deadlock_detection_interval "
                   "= 0.25")
        cl.execute("CREATE TABLE a (k bigint, v bigint)")
        cl.execute("CREATE TABLE b (k bigint, v bigint)")
        cl.create_distributed_table("a", "k", 2, colocate_with="none")
        cl.create_distributed_table("b", "k", 2, colocate_with="none")
        cl.copy_from("a", rows=[(1, 0)])
        cl.copy_from("b", rows=[(1, 0)])
        before = cl.counters.snapshot().get("deadlocks_cancelled", 0)
        s = cl.session()
        s.execute("BEGIN")
        s.execute("UPDATE b SET v = v + 1 WHERE k = 1")
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        child = subprocess.Popen(
            [sys.executable, "-c", DEADLOCK_CHILD, data_dir, sync_dir,
             child_pkg, ROOT],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)
        deadline = time.time() + 90
        while not os.path.exists(os.path.join(sync_dir, "child_locked_a")):
            assert child.poll() is None, child.communicate()
            assert time.time() < deadline, "child never locked a"
            time.sleep(0.05)
        open(os.path.join(sync_dir, "parent_locked_b"), "w").close()
        time.sleep(0.3)
        t0 = time.time()
        s.execute("UPDATE a SET v = v + 1 WHERE k = 1")
        elapsed = time.time() - t0
        s.execute("COMMIT")
        out, err = child.communicate(timeout=180)
        assert "CHILD_DEADLOCK_VICTIM" in out, (out, err[-2000:])
        assert elapsed < 60, f"{elapsed:.1f} s: the lock timeout, not the daemon"
        assert cl.counters.snapshot().get("deadlocks_cancelled", 0) > before
        assert cl.execute("SELECT v FROM a WHERE k = 1").rows == [(1,)]
        assert cl.execute("SELECT v FROM b WHERE k = 1").rows == [(1,)]
    finally:
        if child is not None and child.poll() is None:
            child.kill()
            child.wait()
        cl.close()


@pytest.mark.parametrize("name", ["port", "ref_coordinator", "ref_branch"])
def test_branch_expiry_duty_resolves_an_abandoned_branch(tmp_path, name):
    """A prepared branch on B whose decide never comes resolves when
    B's daemon runs its branch_expiry duty: committed when the
    authority recorded commit, rolled back (presumed abort) when it
    recorded nothing."""
    pkgs = {"port": (ctt, ctt), "ref_coordinator": (ct, ctt),
            "ref_branch": (ctt, ct)}[name]
    a, b = _open_pair(tmp_path, *pkgs)
    try:
        a.execute("CREATE TABLE rb (k bigint NOT NULL, v bigint)")
        a.execute("SELECT create_distributed_table('rb', 'k', 4)")
        b._reload_catalog()
        n = 200
        a.copy_from("rb", columns={"k": np.arange(n),
                                   "v": np.zeros(n, np.int64)})
        import uuid
        ep = ("127.0.0.1", b.data_port)
        b._data_server.BRANCH_EXPIRE_S = 0.0
        g1 = uuid.uuid4().hex
        r = a.catalog.remote_data.call(
            ep, "dml_prepare", {"gxid": g1, "sql": "UPDATE rb SET v = 3"})
        on_b = r["explain"]["updated"]
        assert on_b > 0
        a._control.record_txn_outcome(g1, "commit")
        b.maintenance.run_once()
        g2 = uuid.uuid4().hex
        a.catalog.remote_data.call(
            ep, "dml_prepare", {"gxid": g2, "sql": "UPDATE rb SET v = 8"})
        b.maintenance.run_once()
        for mod in (ct, ctt):
            importlib.import_module(
                f"{mod.__name__}.executor.device_cache").GLOBAL_CACHE.clear()
        rows = b.execute("SELECT v, count(*) FROM rb GROUP BY v "
                         "ORDER BY v").rows
        assert rows == [(0, n - on_b), (3, on_b)]
        assert b.execute("SELECT recover_prepared_transactions()").rows \
            == [(0,)]
    finally:
        b.close()
        a.close()


def test_daemon_cleanup_duty_drops_deferred_sources(tmp_path):
    """After a move, the daemon's deferred_cleanup duty (not an explicit
    call) drops the source placement, on both packages."""
    p = Pair(tmp_path, n_nodes=2)
    try:
        p.run("CREATE TABLE t (k bigint NOT NULL, v bigint)",
              "SELECT create_distributed_table('t', 'k', 4)",
              ("copy", "t", {"columns": {"k": np.arange(3000),
                                         "v": np.arange(3000)}}))
        s = p.ref.catalog.table("t").shards[0]
        sid, src = s.shard_id, s.placements[0]
        p.run(f"SELECT citus_move_shard_placement({sid}, {src}, {1 - src})")

        def cleaned(cl):
            cl.maintenance.run_once()
            return os.path.isdir(cl.catalog.shard_dir("t", sid, src))
        assert p.step(("check", cleaned)) == ("value", False)
        p.run("SELECT count(*), sum(v) FROM t")
    finally:
        p.close()


# ---------------------------------------------------------- job runner

def test_job_runner_cancel(tmp_path):
    """A job whose first task blocks: cancel_job marks the scheduled
    tasks cancelled, the running one finishes, and wait_for_job returns
    the job's status: the same rows from both packages."""
    rows = {}
    for p_ in PKGS:
        cl = _open(p_, str(tmp_path / p_), n_nodes=1)
        try:
            gate, ran = threading.Event(), []
            r = cl.background_jobs
            r.register("block", lambda: gate.wait(10))
            r.register("step", lambda name: ran.append(name))
            jid = r.create_job("cancel me")
            t1 = r.add_task(jid, "block", {})
            t2 = r.add_task(jid, "step", {"name": "b"}, depends_on=[t1])
            r.add_task(jid, "step", {"name": "c"}, depends_on=[t2])
            deadline = time.time() + 10
            while r.job_status(jid) != "running":
                assert time.time() < deadline
                time.sleep(0.01)
            r.cancel_job(jid)
            gate.set()
            r.wait_for_job(jid, timeout=2.0)
            deadline = time.time() + 10
            while any(t[3] == "running" for t in r.task_rows()):
                assert time.time() < deadline
                time.sleep(0.01)
            rows[p_] = (r.task_rows(), r.job_status(jid), ran,
                        [(j["job_id"], j["description"], j["status"])
                         for j in r.jobs_view()["jobs"]])
            threads = list(r._threads)
        finally:
            cl.close()
        assert not any(th.is_alive() for th in threads)
    assert rows["citus_tpu"] == rows["citus_tpu_torch"]
    assert [t[3] for t in rows["citus_tpu_torch"][0]] == [
        "done", "cancelled", "cancelled"]
    assert rows["citus_tpu_torch"][2] == []


@pytest.mark.parametrize("pkg", PKGS)
def test_jobs_survive_a_restart(tmp_path, pkg):
    """The jobs file is the reference's: a job one package scheduled
    and did not run, the other runs after a restart."""
    other = PKGS[1 - PKGS.index(pkg)]
    d = str(tmp_path / "db")
    cl = _open(pkg, d, n_nodes=2)
    cl.execute("CREATE TABLE t (k bigint NOT NULL, v bigint)")
    cl.execute("SELECT create_distributed_table('t', 'k', 4)")
    cl.copy_from("t", columns={"k": np.arange(2000), "v": np.arange(2000)})
    s = cl.catalog.table("t").shards[0]
    r = _m(pkg, "services").BackgroundJobRunner(cl.catalog)
    jid = r.create_job("deferred move")
    r.add_task(jid, "move_shard", {"shard_id": s.shard_id,
                                   "source": s.placements[0],
                                   "target": 1 - s.placements[0]})
    cl.close()
    cl2 = _open(other, d)
    try:
        assert cl2.background_jobs.wait_for_job(jid) == "done"
        cl2._plan_cache.clear()
        assert cl2.catalog.table("t").shards[0].placements == \
            [1 - s.placements[0]]
        assert cl2.execute("SELECT count(*), sum(v) FROM t").rows == \
            [(2000, 1999000)]
    finally:
        cl2.close()


# ------------------------------------------------------ restore points

def _restore(cl, name):
    _m("citus_tpu_torch" if isinstance(cl, ctt.Cluster) else "citus_tpu",
       "operations.restore").restore_to_point(cl.catalog, name)


def test_restore_point_roundtrip(tmp_path):
    """test_aux.py's restore point through both packages: the restore
    point's rows come back after more inserts and deletes."""
    rows = {}
    for pkg in PKGS:
        d = str(tmp_path / pkg)
        cl = _open(pkg, d, n_nodes=2)
        cl.execute("CREATE TABLE t (k bigint NOT NULL, v bigint)")
        cl.execute("SELECT create_distributed_table('t', 'k', 4)")
        cl.copy_from("t", columns={"k": np.arange(100, dtype=np.int64),
                                   "v": np.arange(100, dtype=np.int64)})
        out = [cl.execute("SELECT citus_create_restore_point('p')").rows,
               [r[0] for r in cl.execute(
                   "SELECT citus_list_restore_points()").rows]]
        try:
            cl.execute("SELECT citus_create_restore_point('p')")
        except Exception as e:  # noqa: BLE001 -- the class is compared
            out.append(type(e).__name__)
        cl.copy_from("t", columns={"k": np.arange(100, 200, dtype=np.int64),
                                   "v": np.zeros(100, dtype=np.int64)})
        cl.execute("DELETE FROM t WHERE k < 50")
        out.append(cl.execute("SELECT count(*), sum(v) FROM t").rows)
        _restore(cl, "p")
        cl.close()
        cl2 = _open(pkg, d, n_nodes=2)
        out.append(cl2.execute("SELECT count(*), sum(v) FROM t").rows)
        cl2.close()
        rows[pkg] = out
    assert rows["citus_tpu"] == rows["citus_tpu_torch"]
    assert rows["citus_tpu_torch"][-1] == [(100, 4950)]


@pytest.mark.parametrize("write", ["copy", "update", "delete"])
def test_restore_point_and_the_device_cache(tmp_path, write):
    """Restore point, write, read (cached), restore, reopen, a different
    write, read — in one process, so the process-wide device cache still
    holds the abandoned timeline's batches while the table's version
    climbs back to the values that timeline used.  Every read equals
    numpy on both packages: the cache key's flip generation is not
    restored, so no entry of the abandoned timeline matches."""
    for pkg in PKGS:
        d = str(tmp_path / pkg)
        k = np.arange(300, dtype=np.int64)
        v = (k * 7) % 13
        cl = _open(pkg, d, n_nodes=2)
        cl.execute("CREATE TABLE t (k bigint NOT NULL, v bigint)")
        cl.execute("SELECT create_distributed_table('t', 'k', 4)")
        cl.copy_from("t", columns={"k": k, "v": v})
        q = "SELECT count(*), sum(v), min(v), max(k) FROM t"

        def want(kk, vv):
            return [(len(kk), int(vv.sum()), int(vv.min()), int(kk.max()))]
        assert cl.execute(q).rows == want(k, v)
        cl.execute("SELECT citus_create_restore_point('r')")
        k1, v1 = np.arange(300, 400), np.full(100, 5)
        cl.copy_from("t", columns={"k": k1, "v": v1})
        kk, vv = np.concatenate([k, k1]), np.concatenate([v, v1])
        for _ in range(2):  # the second read is served from the cache
            assert cl.execute(q).rows == want(kk, vv)
        if pkg == "citus_tpu_torch":
            mem = cl.execute("SELECT citus_device_memory()").rows
            assert [r[3] for r in mem if r[0] == "total"][0] > 0
        _restore(cl, "r")
        cl.close()
        cl = _open(pkg, d, n_nodes=2)
        assert cl.execute(q).rows == want(k, v)
        if write == "copy":
            k2, v2 = np.arange(500, 600), np.full(100, 11)
            cl.copy_from("t", columns={"k": k2, "v": v2})
            kk, vv = np.concatenate([k, k2]), np.concatenate([v, v2])
        elif write == "update":
            cl.execute("UPDATE t SET v = 12 WHERE k < 100")
            kk, vv = k, np.where(k < 100, 12, v)
        else:
            cl.execute("DELETE FROM t WHERE k >= 250")
            kk, vv = k[k < 250], v[k < 250]
        for _ in range(2):
            assert cl.execute(q).rows == want(kk, vv), (pkg, write)
        cl.close()


# ------------------------------------------------------------------ GUCs

GUCS = [
    ("citus.start_maintenance_daemon", "off"),
    ("citus.distributed_deadlock_detection_interval", "0.5"),
    ("citus.authority_watch_interval", "7"),
    ("citus.defer_drop_after_shard_move", "off"),
    ("citus.shard_move_catchup_threshold", "3"),
    ("citus.shard_move_max_catchup_rounds", "7"),
    ("citus.enable_metadata_sync", "off"),
    ("citus.metadata_sync_interval_ms", "250"),
]


@pytest.mark.parametrize("guc,value", GUCS)
def test_guc_set_and_show(tmp_path, guc, value):
    """SHOW before and after SET, a bad value's error class, and SET
    inside a rolled-back transaction: the same from both packages."""
    p = Pair(tmp_path)
    try:
        p.run(f"SHOW {guc}", f"SET {guc} = {value}", f"SHOW {guc}",
              f"SHOW {guc.split('.', 1)[1]}",
              f"SET {guc} = 'not-a-value'", f"SHOW {guc}",
              "BEGIN", f"SET {guc} = 1", "ROLLBACK", f"SHOW {guc}")
    finally:
        p.close()


def test_show_all_lists_the_new_gucs(tmp_path):
    cl = ctt.Cluster(str(tmp_path / "db"), device="cpu")
    try:
        names = {r[0] for r in cl.execute("SHOW all").rows}
        assert {g for g, _ in GUCS} <= names
    finally:
        cl.close()


def test_metadata_sync_gucs_start_and_stop_the_loop(tmp_path):
    """SET citus.metadata_sync_interval_ms starts the sync loop on an
    attached coordinator, 0 stops it, as in the reference."""
    for pkg in PKGS:
        a, b = _open_pair(tmp_path / pkg, _m(pkg), _m(pkg))
        try:
            b.execute("SET citus.metadata_sync_interval_ms = 50")
            assert b.metadata_sync._thread is not None
            assert b.execute("SELECT citus_sync_metadata()").rows == [(0,)]
            b.execute("SET citus.metadata_sync_interval_ms = 0")
            assert b.metadata_sync._thread is None
        finally:
            b.close()
            a.close()
