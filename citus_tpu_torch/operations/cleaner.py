"""Deferred resource cleanup: the recording half.

Reference: pg_dist_cleanup + shard_cleaner.c.  Operations that replace
data (TRUNCATE here) never delete the old files inline: they record a
cleanup entry, so concurrent readers holding the old stripe list finish
safely.  The records go to the same ``cleanup.json`` the JAX package
writes, under the same cross-process lock, so either package's cleaner
pass drops them; the pass itself (the maintenance daemon's
TryDropOrphanedResources) is not ported yet (ROADMAP.md A14).
"""

from __future__ import annotations

import json
import os

from citus_tpu_torch.utils.clock import now as wall_now

CLEANUP_FILE = "cleanup.json"
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
