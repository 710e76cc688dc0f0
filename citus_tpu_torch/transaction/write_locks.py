"""Colocation-group write locks: one lock protocol shared by DML writers
and shard movers/splitters.

Reference: the reference blocks writes with global metadata locks across
a move's final catch-up (operations/shard_transfer.c:472, README
2553-2574) and serializes non-commutative writes per shard
(utils/resource_lock.c LockShardResource).  Here the unit is the
colocation group (colocated shards always move together), and the lock
is two-layer:

- an in-process LockManager acquisition (deadlock detection, lock
  observability views) when a manager is supplied, and
- a cross-process flock in matching shared/exclusive mode, so writers
  and movers in *different* coordinator processes sharing a data dir
  exclude each other too.

In-process contention resolves at the LockManager first, so the flock
only ever blocks on foreign processes.
"""

from __future__ import annotations

import contextlib
import threading

from citus_tpu_torch.transaction.locks import EXCLUSIVE, SHARED  # noqa: F401


def group_resource(table_meta) -> str:
    """Lock resource name for a table's write group."""
    if table_meta.colocation_id:
        return f"coloc:{table_meta.colocation_id}"
    return f"table:{table_meta.name}"


def lockfile_path(data_dir: str, res: str) -> str:
    """Flock file for a write-group resource.  Single source of truth:
    statement writers (here), transactional writers (session.py), and
    shard movers must all compute byte-identical paths or they stop
    excluding each other."""
    import os
    return os.path.join(data_dir, ".wl_" + res.replace(":", "_") + ".lock")


@contextlib.contextmanager
def group_write_lock(cat, table_meta, mode: str, lock_manager=None,
                     timeout: float = 30.0):
    import fcntl
    import os

    from citus_tpu_torch.utils.clock import now as wall_now

    from citus_tpu_torch.transaction.global_deadlock import (
        check_cancelled, clear_record, flock_wait_instrumented, make_gpid,
        publish_hold,
    )
    res = group_resource(table_meta)
    sid = threading.get_ident()
    if lock_manager is not None:
        held = lock_manager.holds(sid, res)
        if held == EXCLUSIVE or held == mode:
            # re-entrant: an outer frame of this thread already holds the
            # manager lock AND the process flock — taking the flock again
            # on a fresh fd would self-deadlock
            yield
            return
        lock_manager.acquire(sid, res, mode, timeout=timeout)
    try:
        # statement-scoped writers participate in the global wait graph
        # too: an autocommit ingest holding FK-parent locks can complete
        # a cycle with a transaction in another process
        gpid = make_gpid(sid)
        lockfile = lockfile_path(cat.data_dir, res)
        fd = os.open(lockfile, os.O_CREAT | os.O_RDWR)
        hold_rec = None
        try:
            flock_wait_instrumented(
                fd, fcntl.LOCK_SH if mode == SHARED else fcntl.LOCK_EX,
                timeout, data_dir=cat.data_dir, gpid=gpid, res=res,
                mode=mode, started=wall_now())
            hold_rec = publish_hold(cat.data_dir, gpid, res, mode,
                                    wall_now())
            yield
        finally:
            try:
                fcntl.flock(fd, fcntl.LOCK_UN)
            except OSError:
                pass
            os.close(fd)
            if hold_rec is not None:
                clear_record(hold_rec)
            # consume any marker that raced our acquisition: thread
            # idents are recycled, a stale marker must never abort a
            # later unrelated statement
            check_cancelled(cat.data_dir, gpid)
    finally:
        if lock_manager is not None:
            lock_manager.release(sid, res)
