"""Interactive multi-statement transactions: BEGIN/COMMIT/ROLLBACK and
savepoints over the staged-write 2PC substrate.

Reference: transaction/transaction_management.c:319
(CoordinatedTransactionCallback — pre-commit PREPARE on every write
connection, then COMMIT PREPARED) and the subtransaction/savepoint
callback at :176.  The TPU-native shape: a transaction's writes stage
per-xid side files (stripes + deletion bitmaps) across placements;
statements of the same session read them through the thread-local
overlay (storage/overlay.py); COMMIT is the familiar
PREPARED -> COMMITTED -> flip -> DONE sequence over *all* placements the
transaction touched, so the whole interactive transaction commits
atomically and recovery (transaction/recovery.py) rolls a mid-commit
kill forward or back exactly like single-statement 2PC.

Savepoints exploit the staged representation directly: because every
pending effect of the transaction lives in small per-placement side
files, a savepoint is a snapshot of those side files' contents, and
ROLLBACK TO restores them (deleting stripe data files staged after the
snapshot).  Locks acquired after the savepoint are released by
ROLLBACK TO, like PostgreSQL's subtransaction abort; the one remaining
divergence is a post-savepoint UPGRADE of an already-held lock, which
keeps the stronger mode until transaction end (conservative).

Two-phase locking: write locks acquired by statements are retained until
COMMIT/ROLLBACK (the reference holds row/shard locks to transaction
end).  Lock identity is the session (not the thread), so concurrent
sessions in one process contend correctly and the in-process deadlock
detector sees them as distinct nodes.
"""

from __future__ import annotations

import itertools
import json
import os
from typing import Optional

from citus_tpu_torch.errors import TransactionError
from citus_tpu_torch.transaction.locks import EXCLUSIVE, SHARED


class InFailedTransaction(TransactionError):
    """A prior statement failed; only ROLLBACK (or ROLLBACK TO a
    savepoint) is accepted — PostgreSQL's 25P02."""


#: session lock ids live far above thread idents so the two id spaces
#: used with the shared LockManager can never collide
_session_ids = itertools.count(1 << 48)


class _HeldLock:
    """A retained two-layer lock: LockManager grant + open flock fd."""

    def __init__(self, mode: str, fd: int):
        self.mode = mode
        self.fd = fd


class OpenTransaction:
    """State of one BEGIN..COMMIT block."""

    def __init__(self, xid: int, lock_sid: int):
        from citus_tpu_torch.utils.clock import now as wall_now
        self.xid = xid
        self.lock_sid = lock_sid
        self.started = wall_now()  # deadlock victim policy: youngest dies
        self.failed = False
        self.ingest_dirs: set[str] = set()   # staged stripes
        self.delete_dirs: set[str] = set()   # staged deletion bitmaps
        self.tables: set[str] = set()        # touched (version bump at commit)
        self.locks: dict[str, _HeldLock] = {}
        self.cdc_events: list[tuple] = []    # deferred to commit
        self.savepoints: list[tuple[str, dict]] = []
        # ---- transactional DDL (reference: citus_ProcessUtility runs
        # DDL inside the coordinated transaction, utility_hook.c:148).
        # DDL statements mutate the in-memory catalog; Catalog.commit()
        # defers persistence here, COMMIT persists once under the DDL
        # lease, ROLLBACK reloads the untouched on-disk document.
        self.catalog_dirty = False
        self.ddl_statements = 0       # bumped per deferred catalog commit
        self.on_commit: list = []     # deferred physical actions (file drops)
        self.on_rollback: list = []   # cleanup of staged physical artifacts
        self.tombstones_snapshot: dict = {}  # restored on rollback
        # ---- cross-host branches (interactive 2PC): endpoints holding
        # an open branch session for this transaction's gxid, and the
        # tables written remotely (reads of those within the block are
        # refused — remote staged state is not visible here)
        self.gxid: "str | None" = None
        self.remote_endpoints: set = set()
        self.remote_written_tables: set = set()

    # ---- write registration -------------------------------------------
    def record_ingest(self, table_name: str, dirs) -> None:
        self.tables.add(table_name)
        self.ingest_dirs.update(dirs)

    def record_deletes(self, table_name: str, dirs) -> None:
        self.tables.add(table_name)
        self.delete_dirs.update(dirs)

    @property
    def has_writes(self) -> bool:
        return bool(self.ingest_dirs or self.delete_dirs)

    # ---- retained locks ------------------------------------------------
    def _release_one(self, cluster, res: str, held: "_HeldLock") -> None:
        """Tear one retained lock down across all layers (flock fd,
        in-process manager, cross-process hold record)."""
        import fcntl

        from citus_tpu_torch.transaction.global_deadlock import (
            _record_path, clear_record, make_gpid,
        )
        try:
            fcntl.flock(held.fd, fcntl.LOCK_UN)
            os.close(held.fd)
        except OSError:
            pass
        cluster.locks.release(self.lock_sid, res)
        clear_record(_record_path(cluster.catalog.data_dir, "h",
                                  make_gpid(self.lock_sid), res))

    def _acquire_res(self, cluster, res: str, mode: str) -> None:
        """Fresh two-layer acquisition of ``res`` into the retained set
        (manager lock, flock on a new fd, hold record)."""
        import fcntl

        from citus_tpu_torch.transaction.global_deadlock import (
            flock_wait_instrumented, make_gpid, publish_hold,
        )
        from citus_tpu_torch.transaction.write_locks import lockfile_path

        timeout = cluster.settings.executor.lock_timeout_s
        data_dir = cluster.catalog.data_dir
        gpid = make_gpid(self.lock_sid)
        cluster.locks.acquire(self.lock_sid, res, mode, timeout=timeout)
        try:
            fd = os.open(lockfile_path(data_dir, res), os.O_CREAT | os.O_RDWR)
            try:
                flock_wait_instrumented(
                    fd, fcntl.LOCK_SH if mode == SHARED else fcntl.LOCK_EX,
                    timeout, data_dir=data_dir, gpid=gpid, res=res,
                    mode=mode, started=self.started)
            except BaseException:
                os.close(fd)
                raise
            self.locks[res] = _HeldLock(mode, fd)
            publish_hold(data_dir, gpid, res, mode, self.started)
        except BaseException:
            cluster.locks.release(self.lock_sid, res)
            raise

    def hold_group_lock(self, cluster, table_meta, mode: str) -> None:
        """Acquire (or upgrade) the colocation-group write lock and
        retain it until transaction end.  Mirrors
        write_locks.group_write_lock but without the statement-scoped
        release."""
        import fcntl
        from citus_tpu_torch.transaction.write_locks import (
            group_resource, lockfile_path,
        )

        from citus_tpu_torch.transaction.global_deadlock import (
            flock_wait_instrumented, make_gpid, publish_hold,
        )

        res = group_resource(table_meta)
        held = self.locks.get(res)
        if held is not None and (held.mode == EXCLUSIVE or held.mode == mode):
            return
        timeout = cluster.settings.executor.lock_timeout_s
        data_dir = cluster.catalog.data_dir
        gpid = make_gpid(self.lock_sid)
        # layer 1: in-process manager (deadlock detection; handles the
        # SHARED -> EXCLUSIVE upgrade as a re-acquire)
        cluster.locks.acquire(self.lock_sid, res, mode, timeout=timeout)
        try:
            flmode = fcntl.LOCK_SH if mode == SHARED else fcntl.LOCK_EX
            if held is not None:
                # SHARED -> EXCLUSIVE upgrade, converted in place on the
                # held fd (a second fd would self-conflict: flock locks
                # exclude between fds of one process).  Linux conversion
                # is not atomic — a failed attempt silently DROPS the
                # shared hold — so a contended upgrade fails CLOSED: one
                # non-blocking attempt; on conflict the lock is released
                # outright and the statement error aborts the block.
                # Waiting here and succeeding later would resume the
                # transaction after a foreign writer mutated the group —
                # a silent 2PL violation.
                try:
                    fcntl.flock(held.fd, flmode | fcntl.LOCK_NB)
                except OSError:
                    del self.locks[res]
                    self._release_one(cluster, res, held)
                    from citus_tpu_torch.errors import TransactionError
                    raise TransactionError(
                        f"could not upgrade write lock on {res!r} "
                        "SHARED -> EXCLUSIVE (concurrent writer); "
                        "transaction aborted — retry")
                held.mode = mode
            else:
                lockfile = lockfile_path(data_dir, res)
                fd = os.open(lockfile, os.O_CREAT | os.O_RDWR)
                try:
                    flock_wait_instrumented(
                        fd, flmode, timeout, data_dir=data_dir, gpid=gpid,
                        res=res, mode=mode, started=self.started)
                except BaseException:
                    os.close(fd)
                    raise
                self.locks[res] = _HeldLock(mode, fd)
            # advertise the hold for cross-process wait graphs
            publish_hold(data_dir, gpid, res, mode, self.started)
        except BaseException:
            if held is None:
                cluster.locks.release(self.lock_sid, res)
            raise
        # a writer that just waited out a foreign mover must see the
        # flipped placements (same rule as Cluster._write_lock).  With
        # staged DDL in memory a full reload would wipe it — merge the
        # foreign document into the staged state instead (same merge the
        # commit path uses): flipped placements arrive, staged objects
        # survive.
        if not self.catalog_dirty:
            cluster._maybe_reload_catalog(force_sync=True)
        else:
            from citus_tpu_torch.catalog.catalog import _catalog_flock
            cat = cluster.catalog
            with cat._lock, _catalog_flock(cat.data_dir):
                cat._merge_foreign_locked()

    def release_locks(self, cluster) -> None:
        from citus_tpu_torch.transaction.global_deadlock import (
            check_cancelled, clear_holds, make_gpid,
        )
        for res, held in list(self.locks.items()):
            self._release_one(cluster, res, held)
        self.locks.clear()
        cluster.locks.release_all(self.lock_sid)
        gpid = make_gpid(self.lock_sid)
        clear_holds(cluster.catalog.data_dir, gpid)
        check_cancelled(cluster.catalog.data_dir, gpid)  # consume stale marker

    # ---- savepoints ----------------------------------------------------
    def snapshot(self, catalog=None) -> dict:
        """Capture the transaction's staged side-file state (savepoint).
        Small by construction: side files are metadata, not data.  With
        ``catalog`` given, also captures the in-memory catalog document
        so ROLLBACK TO can discard DDL staged after the savepoint."""
        from citus_tpu_torch.storage.deletes import _staged_path as _del_staged
        from citus_tpu_torch.storage.writer import _staged_path as _meta_staged

        def read(p):
            if not os.path.exists(p):
                return None
            with open(p) as fh:
                return fh.read()

        return {
            "ingest": {d: read(_meta_staged(d, self.xid))
                       for d in self.ingest_dirs},
            "deletes": {d: read(_del_staged(d, self.xid))
                        for d in self.delete_dirs},
            "ingest_dirs": set(self.ingest_dirs),
            "delete_dirs": set(self.delete_dirs),
            "tables": set(self.tables),
            "n_cdc": len(self.cdc_events),
            "locks": {res: held.mode for res, held in self.locks.items()},
            "catalog_dirty": self.catalog_dirty,
            "ddl_statements": self.ddl_statements,
            "n_on_commit": len(self.on_commit),
            "n_on_rollback": len(self.on_rollback),
            # document captured only when DDL is already staged (a clean
            # transaction restores from disk instead — no O(catalog)
            # copy per savepoint on the DML path).  JSON round-trip:
            # export_document shares mutable lists (indexes,
            # foreign_keys) with the live TableMeta objects.
            "catalog_doc": (json.loads(json.dumps(catalog.export_document()))
                            if catalog is not None and self.catalog_dirty
                            else None),
            "tombstones": (None if catalog is None else
                           {k: set(v)
                            for k, v in catalog._tombstones.items()}),
        }

    def restore(self, snap: dict, cluster=None) -> None:
        """ROLLBACK TO SAVEPOINT: put every staged side file back to its
        snapshot content, deleting stripe files staged since."""
        if cluster is not None and "locks" in snap:
            # PostgreSQL releases locks the rolled-back subtransaction
            # acquired; locks held AT the savepoint are retained (a
            # post-savepoint upgrade of one of those keeps the stronger
            # mode — conservative divergence)
            for res in [r for r in self.locks if r not in snap["locks"]]:
                self._release_one(cluster, res, self.locks.pop(res))
            # a failed post-savepoint upgrade dropped the lock outright;
            # the restored pre-savepoint staged writes need it back —
            # re-acquire at the snapshotted mode (may block; on failure
            # the block stays failed, exactly like any statement error)
            for res, mode in snap["locks"].items():
                if res not in self.locks:
                    self._acquire_res(cluster, res, mode)
        if snap.get("ddl_statements", 0) != self.ddl_statements:
            # DDL staged after the savepoint: undo its physical
            # artifacts, then restore the catalog as of the savepoint
            for act in reversed(self.on_rollback[snap["n_on_rollback"]:]):
                try:
                    act()
                # lint: disable=SWL01 -- savepoint rollback actions are best-effort; orphan files never affect reads
                except Exception:
                    pass
            del self.on_rollback[snap["n_on_rollback"]:]
            del self.on_commit[snap["n_on_commit"]:]
            if cluster is not None:
                cat = cluster.catalog
                if snap.get("catalog_doc") is not None:
                    # mid-transaction DDL state: load the captured doc
                    with cat._lock:
                        cat.load_document(snap["catalog_doc"])
                        cat.ddl_epoch += 1
                else:
                    # no DDL before the savepoint: disk still holds the
                    # savepoint-time state
                    cluster._reload_catalog()
                if snap.get("tombstones") is not None:
                    cat._tombstones = {k: set(v)
                                       for k, v in snap["tombstones"].items()}
            if not snap["catalog_dirty"] and cluster is not None:
                # the staging guard was claimed by post-savepoint DDL
                cluster.catalog._end_staging(self)
            self.catalog_dirty = snap["catalog_dirty"]
            self.ddl_statements = snap["ddl_statements"]
        from citus_tpu_torch.storage.deletes import _staged_path as _del_staged
        from citus_tpu_torch.storage.writer import _staged_path as _meta_staged

        for d in self.ingest_dirs:
            p = _meta_staged(d, self.xid)
            old_text = snap["ingest"].get(d)
            old_files = set()
            if old_text is not None:
                old_files = {s["file"]
                             for s in json.loads(old_text)["stripes"]}
            if os.path.exists(p):
                with open(p) as fh:
                    cur = json.load(fh)
                for s in cur["stripes"]:
                    if s["file"] not in old_files:
                        fp = os.path.join(d, s["file"])
                        if os.path.exists(fp):
                            os.remove(fp)
            self._write_or_remove(p, old_text)
        for d in self.delete_dirs:
            self._write_or_remove(_del_staged(d, self.xid),
                                  snap["deletes"].get(d))
        self.ingest_dirs = set(snap["ingest_dirs"])
        self.delete_dirs = set(snap["delete_dirs"])
        self.tables = set(snap["tables"])
        del self.cdc_events[snap["n_cdc"]:]
        self.failed = False  # PostgreSQL: clears the aborted state

    @staticmethod
    def _write_or_remove(path: str, text: Optional[str]) -> None:
        if text is None:
            if os.path.exists(path):
                os.remove(path)
            return
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            fh.write(text)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)


class Session:
    """One interactive connection to the cluster (the psql-session
    analog).  Outside a BEGIN block every statement autocommits exactly
    as before; inside one, writes stage under the session's xid and
    COMMIT/ROLLBACK decide them atomically."""

    def __init__(self, cluster):
        self._cluster = cluster
        self.lock_sid = next(_session_ids)
        self.txn: Optional[OpenTransaction] = None
        # PREPARE name AS ... statements (per session, like PostgreSQL;
        # NOT transactional — they survive ROLLBACK)
        self.prepared: dict[str, str] = {}

    # -- public surface --------------------------------------------------
    def execute(self, sql: str, params=None, role=None):
        return self._cluster.execute(sql, params=params, role=role,
                                     session=self)

    def copy_from(self, table_name: str, **kw):
        return self._cluster.copy_from(table_name, session=self, **kw)

    @property
    def in_transaction(self) -> bool:
        return self.txn is not None

    def close(self) -> None:
        """Abandoning an open transaction rolls it back (connection
        close semantics)."""
        if self.txn is not None:
            self._cluster._rollback_txn(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
