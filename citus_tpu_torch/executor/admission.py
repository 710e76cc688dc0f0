"""Process-wide task admission control.

Reference: the shared connection pool counters behind
citus.max_shared_pool_size (connection/shared_connection_stats.c) —
shared-memory accounting that bounds the total worker connections every
backend of a node may open, with "optional" acquisitions failing fast
(the caller folds work into an existing connection) and "required" ones
waiting.

Device analog: the scarce resource is concurrent device dispatch
streams, not sockets.  One process-wide pool bounds how many queries
drive device work at once; each executor takes one REQUIRED slot for
its lifetime and may take OPTIONAL extra slots for intra-query
parallelism (denied = do that work serially on the already-held slot).
Per-query in-flight batches stay bounded separately by
ExecutorSettings.max_tasks_in_flight (the prefetch window).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

from citus_tpu_torch.errors import AdmissionTimeoutError


class SharedTaskPool:
    """Ticket-ordered (FIFO) slot pool.  Waiters queue in arrival order
    and a freed slot always goes to the queue head: a new arrival can
    never barge past a thread already waiting (the old notify_all race
    let exactly that happen, starving early waiters under load)."""

    def __init__(self):
        self._cv = threading.Condition()
        self._waiters: deque = deque()  # tickets, arrival order
        self.in_use = 0
        self.high_water = 0
        self.granted = 0
        self.denied_optional = 0
        self.waits = 0
        # required waiters that gave up before a grant: granted-after-
        # wait reconciles as waits - timeouts (waits alone used to read
        # inflated — a timed-out waiter still counted as "served")
        self.timeouts = 0
        # queries served WITHOUT a slot of their own because a megabatch
        # leader's single dispatch carried them (executor/megabatch.py)
        self.coalesced = 0

    def acquire(self, limit: Optional[int], *, optional: bool = False,
                timeout: float = 30.0) -> bool:
        """Take one slot under ``limit`` (None/0 = unlimited).  Optional
        acquisitions never wait: False = denied, fold the work into an
        already-held slot.  Required ones wait up to ``timeout`` in
        strict FIFO order."""
        with self._cv:
            if not limit or limit <= 0:
                self.in_use += 1
                self.high_water = max(self.high_water, self.in_use)
                self.granted += 1
                return True
            if self.in_use >= limit or self._waiters:
                # optional never waits — and never barges the queue
                if optional:
                    self.denied_optional += 1
                    return False
                self.waits += 1
                ticket = object()
                self._waiters.append(ticket)
                deadline = time.monotonic() + timeout
                try:
                    while self.in_use >= limit \
                            or self._waiters[0] is not ticket:
                        rem = deadline - time.monotonic()
                        if rem <= 0:
                            self.timeouts += 1
                            raise AdmissionTimeoutError(
                                f"task admission timed out: {limit} device "
                                "dispatch slots busy (max_shared_pool_size)")
                        self._cv.wait(rem)
                finally:
                    # on grant we ARE the head; on timeout unlink so the
                    # queue never stalls behind a dead ticket — either
                    # way the next waiter must re-check
                    self._waiters.remove(ticket)
                    self._cv.notify_all()
            self.in_use += 1
            self.high_water = max(self.high_water, self.in_use)
            self.granted += 1
            return True

    def release(self) -> None:
        with self._cv:
            self.in_use -= 1
            self._cv.notify_all()

    def slot(self, limit: Optional[int], *, timeout: float = 30.0):
        """Context manager for one required slot."""
        import contextlib

        @contextlib.contextmanager
        def _ctx():
            self.acquire(limit, timeout=timeout)
            try:
                yield
            finally:
                self.release()
        return _ctx()

    def note_coalesced(self, n: int) -> None:
        """Book ``n`` follower queries the holder's one slot is serving."""
        if n <= 0:
            return
        with self._cv:
            self.coalesced += n

    def stats(self) -> dict:
        with self._cv:
            return {"in_use": self.in_use, "high_water": self.high_water,
                    "granted": self.granted,
                    "denied_optional": self.denied_optional,
                    "waits": self.waits, "timeouts": self.timeouts,
                    "coalesced": self.coalesced}


#: the process-wide pool (the shared-memory counters analog)
GLOBAL_POOL = SharedTaskPool()
