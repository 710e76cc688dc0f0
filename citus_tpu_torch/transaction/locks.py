"""Advisory lock manager + deadlock detection.

Reference: the advisory-lock hierarchy in
src/backend/distributed/utils/resource_lock.c (LockShardResource,
SerializeNonCommutativeWrites, colocation locks) and the distributed
deadlock detector (transaction/distributed_deadlock_detection.c:105 —
build the wait graph, DFS for cycles, cancel the youngest transaction).

Sessions here are threads within the coordinator process; the wait-for
graph and youngest-victim policy are the same.  Deadlock checks run on
block (immediately, since the graph is local) rather than on a 2 s
timer — strictly better detection latency with identical semantics.
"""

from __future__ import annotations

import threading
import time
from citus_tpu_torch.utils.clock import now as wall_now
from dataclasses import dataclass, field
from typing import Optional

from citus_tpu_torch.errors import TransactionError
from citus_tpu_torch.stats import begin_wait, end_wait

SHARED = "shared"
EXCLUSIVE = "exclusive"


class DeadlockDetected(TransactionError):
    """This session was chosen as the deadlock victim (youngest wins the
    cancellation, like the reference)."""


class LockTimeout(TransactionError):
    pass


@dataclass
class _Resource:
    holders: dict[int, str] = field(default_factory=dict)  # session -> mode
    waiters: list[tuple[int, str]] = field(default_factory=list)


class LockManager:
    def __init__(self):
        self._mu = threading.Condition()
        self._resources: dict[str, _Resource] = {}
        self._session_started: dict[int, float] = {}
        self._waiting_for: dict[int, str] = {}   # session -> resource name
        self._victims: set[int] = set()

    # ---- session lifecycle ---------------------------------------------
    def begin_session(self, session_id: int) -> None:
        with self._mu:
            # wall clock, not monotonic: start times feed the GLOBAL
            # youngest-dies victim policy, where they compare against
            # other processes' wall-clock records
            self._session_started.setdefault(session_id, wall_now())

    def release_all(self, session_id: int) -> None:
        with self._mu:
            for res in self._resources.values():
                res.holders.pop(session_id, None)
                res.waiters = [(s, m) for s, m in res.waiters if s != session_id]
            self._session_started.pop(session_id, None)
            self._waiting_for.pop(session_id, None)
            self._victims.discard(session_id)
            self._mu.notify_all()

    # ---- acquisition ----------------------------------------------------
    def _compatible(self, res: _Resource, session: int, mode: str) -> bool:
        for holder, hmode in res.holders.items():
            if holder == session:
                continue
            if mode == EXCLUSIVE or hmode == EXCLUSIVE:
                return False
        return True

    def acquire(self, session_id: int, resource: str, mode: str = EXCLUSIVE,
                timeout: float = 10.0) -> None:
        deadline = time.monotonic() + timeout
        with self._mu:
            self.begin_session(session_id)
            res = self._resources.setdefault(resource, _Resource())
            cur = res.holders.get(session_id)
            if cur == EXCLUSIVE or cur == mode:
                return  # re-entrant / already sufficient
            res.waiters.append((session_id, mode))
            self._waiting_for[session_id] = resource
            wtok = None  # wait bracket opens on first actual block
            try:
                while True:
                    if session_id in self._victims:
                        self._victims.discard(session_id)
                        raise DeadlockDetected(
                            f"deadlock detected; session {session_id} cancelled")
                    # FIFO-fair: only the head waiter (or compatible
                    # shared prefix) may grab the lock
                    pos = next(i for i, (s, _) in enumerate(res.waiters) if s == session_id)
                    ahead_exclusive = any(m == EXCLUSIVE for _, m in res.waiters[:pos])
                    if not ahead_exclusive and self._compatible(res, session_id, mode):
                        res.holders[session_id] = mode
                        res.waiters = [(s, m) for s, m in res.waiters if s != session_id]
                        self._waiting_for.pop(session_id, None)
                        return
                    victim = self._find_deadlock_victim_locked()
                    if victim is not None:
                        if victim == session_id:
                            self._victims.discard(victim)
                            res.waiters = [(s, m) for s, m in res.waiters if s != session_id]
                            self._waiting_for.pop(session_id, None)
                            raise DeadlockDetected(
                                f"deadlock detected; session {session_id} cancelled")
                        self._victims.add(victim)
                        self._mu.notify_all()
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        res.waiters = [(s, m) for s, m in res.waiters if s != session_id]
                        self._waiting_for.pop(session_id, None)
                        raise LockTimeout(f"could not acquire {resource!r} within timeout")
                    if wtok is None:
                        wtok = begin_wait("lock")
                    self._mu.wait(timeout=min(remaining, 0.5))
            finally:
                if wtok is not None:
                    end_wait(wtok)
                if self._waiting_for.get(session_id) == resource:
                    self._waiting_for.pop(session_id, None)
                    res.waiters = [(s, m) for s, m in res.waiters if s != session_id]

    def cancel(self, session_id: int) -> None:
        """Mark a session as a deadlock victim (global detector found a
        cross-process cycle through it); its acquire() raises.  Only
        sessions currently waiting at this layer are flagged — a victim
        blocked in the flock layer is cancelled by its file marker, and
        a stale _victims entry would kill the session id's next
        unrelated acquire (thread idents are recycled)."""
        with self._mu:
            if session_id in self._waiting_for:
                self._victims.add(session_id)
                self._mu.notify_all()

    def holds(self, session_id: int, resource: str) -> Optional[str]:
        """Mode this session currently holds on the resource, if any."""
        with self._mu:
            res = self._resources.get(resource)
            return None if res is None else res.holders.get(session_id)

    def release(self, session_id: int, resource: str) -> None:
        with self._mu:
            res = self._resources.get(resource)
            if res is not None:
                res.holders.pop(session_id, None)
            self._mu.notify_all()

    # ---- deadlock detection ----------------------------------------------
    def _wait_graph_locked(self) -> dict[int, set[int]]:
        """session -> sessions it waits on (BuildLocalWaitGraph analog).
        Caller must hold self._mu."""
        graph: dict[int, set[int]] = {}
        for session, resource in self._waiting_for.items():
            res = self._resources.get(resource)
            if res is None:
                continue
            blockers = {h for h in res.holders if h != session}
            if blockers:
                graph[session] = blockers
        return graph

    def wait_graph(self) -> dict[int, set[int]]:
        with self._mu:
            return self._wait_graph_locked()

    def session_starts(self) -> dict[int, float]:
        with self._mu:
            return dict(self._session_started)

    def _find_deadlock_victim_locked(self) -> Optional[int]:
        """DFS cycle search; victim = youngest session in the cycle
        (CheckForDistributedDeadlocks policy).  Runs under self._mu
        (called from acquire); shares the cycle search with the global
        detector so the two layers cannot diverge."""
        from citus_tpu_torch.transaction.global_deadlock import find_cycle_victim
        return find_cycle_victim(self._wait_graph_locked(),
                                 self._session_started)

    # ---- observability ----------------------------------------------------
    def lock_rows(self) -> list[tuple]:
        """(resource, session, mode, granted) — the citus_locks view."""
        with self._mu:
            rows = []
            for name, res in self._resources.items():
                for s, m in res.holders.items():
                    rows.append((name, s, m, True))
                for s, m in res.waiters:
                    rows.append((name, s, m, False))
            return rows
