"""Global (cross-process) deadlock detection.

Reference: BuildGlobalWaitGraph (transaction/lock_graph.c:142) gathers
per-node wait edges over connections; CheckForDistributedDeadlocks
(distributed_deadlock_detection.c:105) DFSes the merged graph and
cancels the youngest transaction in a cycle.

TPU-native shape: coordinator processes sharing a data dir publish
holder/waiter records beside the flock lockfiles (`.waiters/`), each
tagged with a global id ``pid:session`` and the transaction start time.
The maintenance daemon of any process assembles the cross-process graph
from the records, merges its own in-process LockManager graph, finds
cycles, and requests cancellation of the youngest participant by
dropping a cancel marker.  Flock wait loops poll their marker (they
already poll the lock at 20 ms), so a victim in *any* process aborts
with DeadlockDetected within one detection interval instead of timing
out.
"""

from __future__ import annotations

import json
import os
import time
from citus_tpu_torch.utils.clock import now as wall_now
from typing import Optional

from citus_tpu_torch.transaction.locks import EXCLUSIVE, SHARED, DeadlockDetected


def waiters_dir(data_dir: str) -> str:
    d = os.path.join(data_dir, ".waiters")
    os.makedirs(d, exist_ok=True)
    return d


def make_gpid(lock_sid: int) -> str:
    return f"{os.getpid()}:{lock_sid}"


def _san(res: str) -> str:
    return res.replace(":", "_").replace("/", "_")


def _record_path(data_dir: str, kind: str, gpid: str, res: str) -> str:
    return os.path.join(waiters_dir(data_dir),
                        f"{kind}_{gpid.replace(':', '_')}__{_san(res)}.json")


def _write_record(path: str, rec: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(rec, fh)
    os.replace(tmp, path)


def publish_wait(data_dir: str, gpid: str, res: str, mode: str,
                 started: float, nonce: Optional[str] = None) -> str:
    p = _record_path(data_dir, "w", gpid, res)
    _write_record(p, {"gpid": gpid, "resource": res, "mode": mode,
                      "started": started, "pid": os.getpid(),
                      "nonce": nonce})
    return p


def publish_hold(data_dir: str, gpid: str, res: str, mode: str,
                 started: float) -> str:
    p = _record_path(data_dir, "h", gpid, res)
    _write_record(p, {"gpid": gpid, "resource": res, "mode": mode,
                      "started": started, "pid": os.getpid()})
    return p


def clear_record(path: str) -> None:
    try:
        os.remove(path)
    except OSError:
        pass


def clear_holds(data_dir: str, gpid: str) -> None:
    """Remove every record this transaction published (txn end)."""
    prefix_h = f"h_{gpid.replace(':', '_')}__"
    prefix_w = f"w_{gpid.replace(':', '_')}__"
    d = waiters_dir(data_dir)
    for f in os.listdir(d):
        if f.startswith(prefix_h) or f.startswith(prefix_w):
            clear_record(os.path.join(d, f))


# ---- cancellation markers ------------------------------------------------
# A marker targets one specific WAIT (by nonce), not a gpid: thread-ident
# gpids are recycled, and a marker computed from a stale graph snapshot
# must never abort a later unrelated statement that reuses the id.

def _cancel_path(data_dir: str, gpid: str) -> str:
    return os.path.join(waiters_dir(data_dir),
                        f"cancel_{gpid.replace(':', '_')}")


def request_cancel(data_dir: str, gpid: str,
                   nonce: Optional[str] = None) -> None:
    _write_record(_cancel_path(data_dir, gpid),
                  {"at": wall_now(), "nonce": nonce})


def check_cancelled(data_dir: str, gpid: str,
                    nonce: Optional[str] = None) -> bool:
    """Consume this wait's cancel marker.  A marker with a different
    nonce is stale (aimed at a previous wait of a recycled id): it is
    removed and ignored."""
    p = _cancel_path(data_dir, gpid)
    if not os.path.exists(p):
        return False
    try:
        with open(p) as fh:
            rec = json.load(fh)
    except (OSError, ValueError):
        clear_record(p)
        return False
    clear_record(p)
    return nonce is None or rec.get("nonce") in (None, nonce)


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:
        return True


# ---- the detector --------------------------------------------------------

def _load_records(data_dir: str):
    """-> (holds: {res: [(gpid, mode)]}, waits: [(gpid, res, mode,
    nonce)], started: {gpid: t}), dropping records of dead processes."""
    d = waiters_dir(data_dir)
    holds: dict[str, list] = {}
    waits: list[tuple] = []
    started: dict[str, float] = {}
    for f in os.listdir(d):
        if not (f.startswith("h_") or f.startswith("w_")):
            continue
        p = os.path.join(d, f)
        try:
            with open(p) as fh:
                rec = json.load(fh)
        except (OSError, ValueError):
            continue
        if not _pid_alive(int(rec.get("pid", -1))):
            clear_record(p)  # crashed process: flock auto-released
            continue
        gpid = rec["gpid"]
        started[gpid] = min(started.get(gpid, rec["started"]), rec["started"])
        if f.startswith("h_"):
            holds.setdefault(rec["resource"], []).append((gpid, rec["mode"]))
        else:
            waits.append((gpid, rec["resource"], rec["mode"],
                          rec.get("nonce")))
    return holds, waits, started


# ---- manager-layer graph dumps -------------------------------------------
# In-process LockManager waits never touch the flock layer, so they are
# invisible in the hold/wait records.  Each process's detector dumps its
# local manager graph; every detector merges all live dumps — a cycle
# spanning two processes' manager layers is then visible to both.

def _graph_dump_path(data_dir: str, pid: int) -> str:
    return os.path.join(waiters_dir(data_dir), f"graph_{pid}.json")


def dump_local_graph(data_dir: str, local_graph: dict,
                     local_started: dict) -> None:
    pid = os.getpid()
    p = _graph_dump_path(data_dir, pid)
    if not local_graph:
        clear_record(p)
        return
    _write_record(p, {
        "pid": pid,
        "edges": {str(s): [str(b) for b in blockers]
                  for s, blockers in local_graph.items()},
        "started": {str(s): t for s, t in local_started.items()},
    })


def _load_graph_dumps(data_dir: str, skip_pid: Optional[int] = None):
    """-> (edges {gpid: set}, started {gpid: t}) from every live
    process's manager-graph dump."""
    d = waiters_dir(data_dir)
    edges: dict[str, set] = {}
    started: dict[str, float] = {}
    for f in os.listdir(d):
        if not f.startswith("graph_"):
            continue
        p = os.path.join(d, f)
        try:
            with open(p) as fh:
                rec = json.load(fh)
        except (OSError, ValueError):
            continue
        pid = int(rec.get("pid", -1))
        if pid == skip_pid:
            continue
        if not _pid_alive(pid):
            clear_record(p)
            continue
        for s, blockers in rec.get("edges", {}).items():
            node = f"{pid}:{s}"
            edges.setdefault(node, set()).update(
                f"{pid}:{b}" for b in blockers)
        for s, t in rec.get("started", {}).items():
            started.setdefault(f"{pid}:{s}", t)
    return edges, started


def build_global_graph(data_dir: str,
                       local_graph: Optional[dict] = None,
                       local_prefix: Optional[str] = None,
                       local_started: Optional[dict] = None):
    """-> (edges: {gpid: set(gpid)}, started: {gpid: t}).

    ``local_graph`` is a LockManager.wait_graph() whose integer session
    ids become ``{local_prefix}:{sid}`` nodes — merging the in-process
    manager layer with the cross-process flock layer.  ``local_started``
    supplies their start times so the youngest-dies policy sees manager-
    layer participants too."""
    holds, waits, started = _load_records(data_dir)
    edges: dict[str, set] = {}
    wait_nonces: dict[str, str] = {}
    for gpid, res, mode, nonce in waits:
        if nonce is not None:
            wait_nonces[gpid] = nonce
        for holder, hmode in holds.get(res, ()):
            if holder == gpid:
                continue
            if mode == SHARED and hmode == SHARED:
                continue
            edges.setdefault(gpid, set()).add(holder)
    # other processes' manager-layer graphs (their detectors dump them)
    fedges, fstarted = _load_graph_dumps(data_dir, skip_pid=os.getpid())
    for node, blockers in fedges.items():
        edges.setdefault(node, set()).update(blockers)
    for node, t0 in fstarted.items():
        started.setdefault(node, t0)
    if local_graph:
        pfx = local_prefix or str(os.getpid())
        for sid, blockers in local_graph.items():
            node = f"{pfx}:{sid}"
            for b in blockers:
                edges.setdefault(node, set()).add(f"{pfx}:{b}")
        for sid, t0 in (local_started or {}).items():
            started.setdefault(f"{pfx}:{sid}", t0)
    return edges, started, wait_nonces


def find_cycle_victim(edges: dict, started: dict) -> Optional[str]:
    """DFS cycle search; victim = youngest (latest started) in the first
    cycle found — the CheckForDistributedDeadlocks policy."""
    visited: set = set()

    def dfs(node, stack):
        if node in stack:
            return stack[stack.index(node):]
        if node in visited:
            return None
        visited.add(node)
        stack.append(node)
        for nxt in edges.get(node, ()):
            cyc = dfs(nxt, stack)
            if cyc is not None:
                return cyc
        stack.pop()
        return None

    for start in list(edges):
        cyc = dfs(start, [])
        if cyc:
            return max(cyc, key=lambda g: started.get(g, 0.0))
    return None


def run_detection(cluster) -> Optional[str]:
    """One detection pass (the maintenance-daemon duty).  Returns the
    cancelled gpid, if any."""
    data_dir = cluster.catalog.data_dir
    if not os.path.isdir(os.path.join(data_dir, ".waiters")):
        return None
    local = cluster.locks.wait_graph()
    local_started = cluster.locks.session_starts()
    # share our manager layer with other processes' detectors (a cycle
    # through two processes' manager layers is invisible to either side
    # alone)
    dump_local_graph(data_dir, local, local_started)
    edges, started, wait_nonces = build_global_graph(
        data_dir, local_graph=local, local_started=local_started)
    victim = find_cycle_victim(edges, started)
    if victim is None:
        return None
    pid_s, _, sid_s = victim.partition(":")
    is_local = pid_s == str(os.getpid())
    if victim in wait_nonces:
        # flock-layer waiter (any process): targeted marker
        request_cancel(data_dir, victim, wait_nonces[victim])
    elif is_local:
        # manager-layer waiter of this process: flag it directly
        try:
            cluster.locks.cancel(int(sid_s))
        except ValueError:
            return None
    else:
        # remote manager-layer victim: its own daemon sees the same
        # merged graph (we just dumped ours) and cancels it locally
        return None
    try:
        from citus_tpu_torch.executor.executor import GLOBAL_COUNTERS
        GLOBAL_COUNTERS.bump("deadlocks_cancelled")
    except ImportError:
        pass
    return victim


# ---- instrumented flock wait --------------------------------------------

def flock_wait_instrumented(fd: int, flmode, timeout: float, *,
                            data_dir: str, gpid: str, res: str,
                            mode: str, started: float) -> None:
    """Poll-acquire a flock while advertising the wait and honoring
    cancellation (the cross-process half of the wait graph).  Raises
    DeadlockDetected when a detector in any process picked this
    transaction as the victim, LockTimeout on plain expiry."""
    import fcntl

    from citus_tpu_torch.utils.filelock import LockTimeout

    try:
        fcntl.flock(fd, flmode | fcntl.LOCK_NB)
        return  # uncontended: no record churn
    except OSError:
        pass
    # the nonce scopes cancellation to THIS wait: markers computed from a
    # stale snapshot (or aimed at a previous wait of a recycled thread
    # ident) are discarded, never spuriously aborting a new statement
    nonce = os.urandom(8).hex()
    wait_rec = publish_wait(data_dir, gpid, res, mode, started, nonce)
    try:
        deadline = time.monotonic() + timeout
        while True:
            try:
                fcntl.flock(fd, flmode | fcntl.LOCK_NB)
                # a marker written as we acquired is stale: consume it
                check_cancelled(data_dir, gpid, nonce)
                return
            except OSError:
                if check_cancelled(data_dir, gpid, nonce):
                    raise DeadlockDetected(
                        f"deadlock detected; transaction {gpid} cancelled")
                if time.monotonic() >= deadline:
                    raise LockTimeout(
                        f"could not acquire {res!r} within {timeout}s")
                time.sleep(0.02)
    finally:
        clear_record(wait_rec)
