"""Deferred resource cleanup: the recording half and the operation
registry.

Reference: pg_dist_cleanup + shard_cleaner.c.  Operations that replace
data (TRUNCATE here) never delete the old files inline: they record a
cleanup entry, so concurrent readers holding the old stripe list finish
safely.  The records go to the same ``cleanup.json`` the JAX package
writes, under the same cross-process lock, so either package's cleaner
pass drops them; the pass itself (the maintenance daemon's
TryDropOrphanedResources) is not ported yet (ROADMAP.md A14).

Replicated catalog writes (``metadata/quotas.py``) register themselves
in ``operations.json`` with their pid and phase while they run, as the
reference's do, so a crash in the window stays visible to the cleaner.
"""

from __future__ import annotations

import json
import os

from citus_tpu_torch.utils.clock import now as wall_now

CLEANUP_FILE = "cleanup.json"
#: registry of in-flight operations:
#: {str(operation_id): {"pid", "kind", "phase", "started_at"}}
OPERATIONS_FILE = "operations.json"
#: drop after the recording operation succeeded
DEFERRED_ON_SUCCESS = "deferred_on_success"


def _cleanup_flock(cat):
    from citus_tpu_torch.utils.filelock import FileLock
    return FileLock(os.path.join(cat.data_dir, ".cleanup.lock"))


def _path(cat) -> str:
    return os.path.join(cat.data_dir, CLEANUP_FILE)


def record_cleanup(cat, resource_path: str,
                   policy: str = DEFERRED_ON_SUCCESS,
                   operation_id: int = 0) -> None:
    with _cleanup_flock(cat):
        p = _path(cat)
        records = []
        if os.path.exists(p):
            with open(p) as fh:
                records = json.load(fh)
        records.append({
            "path": resource_path, "policy": policy,
            "operation_id": operation_id, "recorded_at": wall_now(),
        })
        tmp = p + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(records, fh)
        os.replace(tmp, p)


def _ops_path(cat) -> str:
    return os.path.join(cat.data_dir, OPERATIONS_FILE)


def _load_ops(cat) -> dict:
    p = _ops_path(cat)
    if not os.path.exists(p):
        return {}
    with open(p) as fh:
        return json.load(fh)


def _store_ops(cat, ops: dict) -> None:
    tmp = _ops_path(cat) + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(ops, fh)
    os.replace(tmp, _ops_path(cat))


def register_operation(cat, operation_id: int, kind: str = "") -> None:
    """Register an in-flight operation (its pid, kind and phase)."""
    with _cleanup_flock(cat):
        ops = _load_ops(cat)
        ops[str(operation_id)] = {"pid": os.getpid(), "kind": kind,
                                  "phase": "running",
                                  "started_at": wall_now()}
        _store_ops(cat, ops)


def mark_operation_phase(cat, operation_id: int, phase: str) -> None:
    """Advance the registry row's phase marker (decide / decided)."""
    with _cleanup_flock(cat):
        ops = _load_ops(cat)
        row = ops.get(str(operation_id))
        if row is not None:
            row["phase"] = phase
            _store_ops(cat, ops)


def complete_operation(cat, operation_id: int, success: bool) -> None:
    """Retire the operation's registry row.  The port records no
    op-gated cleanup entries, so there are none to resolve."""
    with _cleanup_flock(cat):
        ops = _load_ops(cat)
        if ops.pop(str(operation_id), None) is not None:
            _store_ops(cat, ops)
