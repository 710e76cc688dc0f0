"""Write-ahead transaction log + two-phase commit for multi-placement
writes.

Reference mapping:
- LogTransactionRecord before PREPARE  -> append PREPARED record
- COMMIT PREPARED on every worker      -> append COMMITTED, then flip
  each placement's staged shard metadata live (idempotent renames)
- RecoverTwoPhaseCommits               -> recover(): COMMITTED-without-
  DONE transactions are rolled forward; PREPARED-without-COMMITTED are
  rolled back (staged files + orphaned stripes deleted)

The log is an append-only JSONL file, fsync'd per record — the analog of
pg_dist_transaction rows riding PostgreSQL's WAL.

Cross-process safety (the reference's "don't recover transactions that
belong to active backends", transaction_recovery.c): xids are allocated
from per-process *blocks* reserved by an fsync'd log record before use,
so two coordinators sharing a data dir can never reuse each other's
xids.  Each log holds an flock on an owner marker file for its lifetime;
recovery treats a block's transactions as recoverable only once that
lock is released (process exit or crash).  In-process liveness is
tracked by an in-memory in-flight set.
"""

from __future__ import annotations

import json
import os
import threading
import time
from citus_tpu_torch.utils.clock import now as wall_now
import uuid
from typing import Optional


class TxState:
    PREPARED = "prepared"
    COMMITTED = "committed"
    ABORTED = "aborted"
    DONE = "done"
    BLOCK = "block"  # xid-block reservation record, not a transaction


class TransactionLog:
    FILE = "txlog.jsonl"
    BLOCK_SIZE = 4096

    def __init__(self, data_dir: str):
        from citus_tpu_torch.utils.filelock import FileLock
        self.path = os.path.join(data_dir, self.FILE)
        self.data_dir = data_dir
        self._lock = threading.Lock()
        # cross-process serialization of every log mutation: appends must
        # not interleave with truncate_done's rewrite-and-replace (an
        # append through a stale inode would be lost), and block
        # reservation's scan+append must be atomic across coordinators
        self._flock = lambda: FileLock(os.path.join(data_dir, ".txlog.lock"))
        self._inflight: set[int] = set()
        # owner marker: held for the life of this log; other processes
        # test it to decide whether our transactions are recoverable
        self.owner = uuid.uuid4().hex[:16]
        self._owner_fd = os.open(self._owner_path(self.owner),
                                 os.O_CREAT | os.O_RDWR)
        import fcntl
        fcntl.flock(self._owner_fd, fcntl.LOCK_EX)
        self._block_lo = 0
        self._block_hi = 0  # exclusive; 0 means "no block reserved yet"
        self._next_xid = 0

    def _owner_path(self, owner: str) -> str:
        return os.path.join(self.data_dir, f".txowner.{owner}.lock")

    def close(self) -> None:
        """Release the owner marker (a clean shutdown).  After this, any
        transaction of ours without a decided outcome becomes
        recoverable by other processes."""
        if self._owner_fd is not None:
            import fcntl
            fcntl.flock(self._owner_fd, fcntl.LOCK_UN)
            os.close(self._owner_fd)
            self._owner_fd = None
            try:
                os.remove(self._owner_path(self.owner))
            except OSError:
                pass

    def owner_alive(self, owner: str) -> bool:
        """Is the process owning this xid block still running?  (flock
        probe on its marker file — the analog of checking for an active
        backend.)"""
        if owner == self.owner:
            return True
        import fcntl
        p = self._owner_path(owner)
        try:
            fd = os.open(p, os.O_RDWR)
        except OSError:
            return False  # marker gone: owner exited cleanly
        try:
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError:
                return True  # lock held: owner is live
            fcntl.flock(fd, fcntl.LOCK_UN)
            return False
        finally:
            os.close(fd)

    # ---- records -------------------------------------------------------
    def records(self) -> list[dict]:
        if not os.path.exists(self.path):
            return []
        out = []
        with open(self.path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    break  # torn tail write: everything after is invalid
        return out

    def _append_locked(self, rec: dict) -> None:
        with self._flock():
            with open(self.path, "a") as fh:
                fh.write(json.dumps(rec) + "\n")
                fh.flush()
                os.fsync(fh.fileno())

    def _append(self, rec: dict) -> None:
        with self._lock:
            self._append_locked(rec)

    def begin(self) -> int:
        with self._lock:
            if self._next_xid >= self._block_hi:
                self._reserve_block_locked()
            xid = self._next_xid
            self._next_xid += 1
            self._inflight.add(xid)
            return xid

    def _reserve_block_locked(self) -> None:
        """Reserve [frontier, frontier+BLOCK_SIZE) via an fsync'd log
        record, so no other process can ever hand out these xids.  The
        frontier scan and the reservation append are one cross-process
        critical section: two coordinators reserving concurrently must
        see each other's BLOCK records."""
        with self._flock():
            frontier = 1
            for rec in self.records():
                if rec["state"] == TxState.BLOCK:
                    frontier = max(frontier, rec["block"][1])
                else:
                    frontier = max(frontier, rec["xid"] + 1)
            lo, hi = frontier, frontier + self.BLOCK_SIZE
            with open(self.path, "a") as fh:
                fh.write(json.dumps({"xid": -1, "state": TxState.BLOCK,
                                     "block": [lo, hi], "owner": self.owner,
                                     "at": wall_now()}) + "\n")
                fh.flush()
                os.fsync(fh.fileno())
        self._block_lo, self._block_hi = lo, hi
        self._next_xid = lo

    def log(self, xid: int, state: str, payload: Optional[dict] = None) -> None:
        self._append({"xid": xid, "state": state, "at": wall_now(),
                      "payload": payload or {}})
        if state == TxState.DONE:
            with self._lock:
                self._inflight.discard(xid)

    def release(self, xid: int) -> None:
        """Stop driving a transaction from this process (the operation
        failed mid-2PC); recovery may now decide its outcome."""
        with self._lock:
            self._inflight.discard(xid)

    def inflight(self) -> set[int]:
        with self._lock:
            return set(self._inflight)

    def blocks(self) -> list[tuple[int, int, str]]:
        """-> [(lo, hi_exclusive, owner)] for every reserved xid block."""
        out = []
        for rec in self.records():
            if rec["state"] == TxState.BLOCK:
                out.append((rec["block"][0], rec["block"][1], rec["owner"]))
        return out

    def block_owner(self, xid: int) -> Optional[str]:
        for lo, hi, owner in self.blocks():
            if lo <= xid < hi:
                return owner
        return None

    # ---- recovery ------------------------------------------------------
    def outstanding(self) -> list[tuple[int, str, dict]]:
        """-> [(xid, final_state, prepare_payload)] for transactions whose
        outcome still needs applying (no DONE record)."""
        latest: dict[int, str] = {}
        prepared_payload: dict[int, dict] = {}
        for rec in self.records():
            if rec["state"] == TxState.BLOCK:
                continue
            latest[rec["xid"]] = rec["state"]
            if rec["state"] == TxState.PREPARED:
                prepared_payload[rec["xid"]] = rec["payload"]
        out = []
        for xid, state in latest.items():
            if state == TxState.DONE:
                continue
            out.append((xid, state, prepared_payload.get(xid, {})))
        return out

    def truncate_done(self) -> None:
        """Compact the log by dropping fully-DONE transactions and block
        records of dead owners (the maintenance daemon's 2PC-recovery
        duty calls this).  Runs under the log lock so a record appended
        concurrently cannot be dropped by the rewrite."""
        with self._lock, self._flock():
            recs = self.records()
            latest: dict[int, str] = {}
            for rec in recs:
                if rec["state"] == TxState.BLOCK:
                    continue
                latest[rec["xid"]] = rec["state"]
            keep = []
            for r in recs:
                if r["state"] == TxState.BLOCK:
                    if r["owner"] == self.owner or self.owner_alive(r["owner"]):
                        keep.append(r)
                    else:
                        try:
                            os.remove(self._owner_path(r["owner"]))
                        except OSError:
                            pass
                elif latest[r["xid"]] != TxState.DONE:
                    keep.append(r)
            tmp = self.path + ".tmp"
            with open(tmp, "w") as fh:
                for r in keep:
                    fh.write(json.dumps(r) + "\n")
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, self.path)
