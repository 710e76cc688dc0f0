"""Deferred resource cleanup.

Reference: pg_dist_cleanup + shard_cleaner.c (TryDropOrphanedResources,
operations/shard_cleaner.c:199).  Operations that replace or move data
never delete the old files inline — they record a cleanup entry that the
maintenance daemon (or an explicit call) processes later, so concurrent
readers holding the old placement finish safely and failed operations
can't leak half-moved state.

The record file is shared by the maintenance daemon thread, foreground
calls, and (in MX setups) other coordinator processes, so every
load-mutate-store runs under a cross-process file lock.  Policies follow
the reference's CLEANUP_* semantics: ALWAYS entries are dropped on every
pass; ON_FAILURE / ON_SUCCESS entries stay parked while their operation
runs and are resolved by complete_operation — or, if the operation died
without resolving them (kill -9 mid-move), adopted by the next pass.

Crash adoption (reference: operation_id + the owning backend's lease in
pg_dist_cleanup): every move/split registers itself in OPERATIONS_FILE
with its pid *before* recording any op-gated entry.  A pass that finds
an op-gated record whose registered pid is dead resolves it by
arbitration against the COMMITTED catalog document — the metadata flip's
atomic commit is the operation's 2PC decision record
(transaction/branches.py doctrine, presumed abort): a path that is now a
live placement was promoted by a committed flip and must be kept; any
other path is orphaned half-moved state and is dropped.  The pass runs
under the cross-process cleanup lock, so two concurrent cleaners adopt
and drop each orphan exactly once.

Repaired against the reference (ROADMAP.md C26): a shard moved back
onto a node reuses its old placement directory, whose deferred drop may
still be pending, so a move claims its target paths
(``claim_resource``) and retires any record still pending for them; a
pushed placement is claimed on the receiving coordinator the same way.
"""

from __future__ import annotations

import json
import os
import shutil
from citus_tpu_torch.utils.clock import now as wall_now

from citus_tpu_torch.catalog import Catalog

CLEANUP_FILE = "cleanup.json"
#: registry of in-flight operations that own op-gated cleanup records:
#: {str(operation_id): {"pid": ..., "kind": ..., "phase": ..., "started_at": ...}}
OPERATIONS_FILE = "operations.json"

# policies (mirroring the reference's CLEANUP_* semantics)
ALWAYS = "always"                 # drop whether the op succeeded or failed
ON_FAILURE = "on_failure"         # drop only if the op failed
ON_SUCCESS = "on_success"         # drop only if the op succeeded
DEFERRED_ON_SUCCESS = "deferred_on_success"  # drop after the op succeeded


def _cleanup_flock(cat: Catalog):
    from citus_tpu_torch.utils.filelock import FileLock
    return FileLock(os.path.join(cat.data_dir, ".cleanup.lock"))


def _path(cat: Catalog) -> str:
    return os.path.join(cat.data_dir, CLEANUP_FILE)


def _ops_path(cat: Catalog) -> str:
    return os.path.join(cat.data_dir, OPERATIONS_FILE)


def _load(cat: Catalog) -> list[dict]:
    p = _path(cat)
    if not os.path.exists(p):
        return []
    with open(p) as fh:
        return json.load(fh)


def _store(cat: Catalog, records: list[dict]) -> None:
    tmp = _path(cat) + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(records, fh)
    os.replace(tmp, _path(cat))


def _load_ops(cat: Catalog) -> dict[str, dict]:
    p = _ops_path(cat)
    if not os.path.exists(p):
        return {}
    with open(p) as fh:
        return json.load(fh)


def _store_ops(cat: Catalog, ops: dict[str, dict]) -> None:
    tmp = _ops_path(cat) + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(ops, fh)
    os.replace(tmp, _ops_path(cat))


def _pid_alive(pid: int) -> bool:
    if pid == os.getpid():
        return True
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:
        return True  # EPERM: exists but owned elsewhere
    return True


def register_operation(cat: Catalog, operation_id: int, kind: str = "",
                       pid: int | None = None) -> None:
    """Register an in-flight operation BEFORE its first op-gated
    record_cleanup, so no pass can ever see an op-gated record without
    a registry row to arbitrate liveness against.  ``pid`` is
    overridable for tests that forge a dead owner."""
    with _cleanup_flock(cat):
        ops = _load_ops(cat)
        ops[str(operation_id)] = {
            "pid": os.getpid() if pid is None else int(pid),
            "kind": kind, "phase": "running", "started_at": wall_now(),
        }
        _store_ops(cat, ops)


def mark_operation_phase(cat: Catalog, operation_id: int, phase: str) -> None:
    """Advance the registry row's phase marker (copy / catchup / decide /
    decided) — observability plus the 2PC decision-window record."""
    with _cleanup_flock(cat):
        ops = _load_ops(cat)
        row = ops.get(str(operation_id))
        if row is not None:
            row["phase"] = phase
            _store_ops(cat, ops)


def operations_view(cat: Catalog) -> dict[str, dict]:
    with _cleanup_flock(cat):
        return _load_ops(cat)


def record_cleanup(cat: Catalog, resource_path: str, policy: str = DEFERRED_ON_SUCCESS,
                   operation_id: int = 0) -> None:
    with _cleanup_flock(cat):
        records = _load(cat)
        records.append({
            "path": resource_path, "policy": policy,
            "operation_id": operation_id, "recorded_at": wall_now(),
        })
        _store(cat, records)


def complete_operation(cat: Catalog, operation_id: int, success: bool) -> None:
    """Resolve an operation's op-gated records and retire its registry
    row.  ON_FAILURE entries (half-copied targets): success discards
    them (the resources are now live data), failure makes them
    unconditionally droppable.  ON_SUCCESS entries (the pre-flip source
    placements): success makes them droppable on the next pass
    (deferred drop), failure discards them (the source is still the
    live placement)."""
    with _cleanup_flock(cat):
        records = _load(cat)
        out = []
        for r in records:
            if r["operation_id"] == operation_id:
                if r["policy"] == ON_FAILURE:
                    if success:
                        continue  # resource promoted to live data
                    r = dict(r, policy=ALWAYS)
                elif r["policy"] == ON_SUCCESS:
                    if not success:
                        continue  # source placement stays live
                    r = dict(r, policy=ALWAYS)
            out.append(r)
        _store(cat, out)
        ops = _load_ops(cat)
        if ops.pop(str(operation_id), None) is not None:
            _store_ops(cat, ops)


def claim_resource(cat: Catalog, resource_path: str,
                   operation_id: int | None = None) -> None:
    """Take over a path an operation is about to fill: every pending
    record of it is retired, and with ``operation_id`` the operation
    records it ON_FAILURE.  A move back onto a node whose old placement
    directory still waits for its deferred drop writes into that same
    path; the reference leaves the old ALWAYS record, so its next pass
    deletes the live placement (ROADMAP.md C26)."""
    path = os.path.normpath(resource_path)
    with _cleanup_flock(cat):
        records = [r for r in _load(cat)
                   if os.path.normpath(r["path"]) != path]
        if operation_id is not None:
            records.append({
                "path": resource_path, "policy": ON_FAILURE,
                "operation_id": operation_id, "recorded_at": wall_now(),
            })
        _store(cat, records)


def pending_cleanup(cat: Catalog) -> list[dict]:
    with _cleanup_flock(cat):
        return _load(cat)


def _live_placement_dirs(cat: Catalog) -> set[str]:
    """Every placement directory the COMMITTED catalog document names —
    re-read from disk, not from this process's in-memory view, because
    the crashed operation may have committed its flip from another
    process an instant before dying."""
    dirs: set[str] = set()
    try:
        with open(cat._path()) as fh:
            doc = json.load(fh)
        tables = doc.get("tables", [])
    except (OSError, ValueError):
        tables = None
    if tables is None:
        # no on-disk document yet: fall back to the live object
        for t in cat.tables.values():
            for s in t.shards:
                for n in s.placements:
                    dirs.add(os.path.normpath(
                        cat.shard_dir(t.name, s.shard_id, n)))
        return dirs
    for td in tables:
        name = td.get("name")
        for sd in td.get("shards", []):
            for n in sd.get("placements", []):
                dirs.add(os.path.normpath(
                    cat.shard_dir(name, sd["shard_id"], n)))
    return dirs


def try_drop_orphaned_resources(cat: Catalog) -> int:
    """Drop every droppable recorded resource; returns how many were
    removed.  Safe to call repeatedly and concurrently (the maintenance
    daemon does).  Op-gated records whose owner died are adopted here:
    the committed catalog decides survivor vs orphan (module doc)."""
    with _cleanup_flock(cat):
        records = _load(cat)
        ops = _load_ops(cat)
        live_dirs: set[str] | None = None
        remaining, dropped = [], 0
        referenced: set[str] = set()
        for r in records:
            if r["policy"] in (ON_FAILURE, ON_SUCCESS):
                row = ops.get(str(r["operation_id"]))
                if row is None or _pid_alive(int(row["pid"])):
                    # owner still running — or unregistered (an API
                    # caller that never registered: only
                    # complete_operation may resolve its records; every
                    # move/split registers before recording, so a crash
                    # always leaves a row with a dead pid)
                    remaining.append(r)
                    referenced.add(str(r["operation_id"]))
                    continue
                # owner is gone without resolving: adopt.  The committed
                # catalog is the decision record — a live placement path
                # was promoted by the flip; anything else is orphaned.
                if live_dirs is None:
                    live_dirs = _live_placement_dirs(cat)
                if os.path.normpath(r["path"]) in live_dirs:
                    continue  # promoted to live data; record retired
            p = r["path"]
            try:
                if os.path.isdir(p):
                    shutil.rmtree(p)
                elif os.path.exists(p):
                    os.remove(p)
                dropped += 1
            except FileNotFoundError:
                dropped += 1  # someone else removed it: success
            except OSError:
                remaining.append(r)  # retry next cycle
                if r["policy"] in (ON_FAILURE, ON_SUCCESS):
                    referenced.add(str(r["operation_id"]))
        _store(cat, remaining)
        # retire registry rows of dead owners with no records left
        stale = [oid for oid, row in ops.items()
                 if oid not in referenced and not _pid_alive(int(row["pid"]))]
        if stale:
            for oid in stale:
                ops.pop(oid, None)
            _store_ops(cat, ops)
        return dropped
