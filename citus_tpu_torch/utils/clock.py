"""Hybrid logical cluster clock.

Reference: src/backend/distributed/clock/causal_clock.c — a 64-bit HLC
with 42 bits of wall-clock milliseconds and 22 bits of logical counter
(clock/README.md:27-39), exposed as citus_get_node_clock() and
citus_get_transaction_clock() (the max across nodes, then adjusted
everywhere).  Persistence via a periodically-saved floor so restarts
never go backwards (the reference uses a sequence).
"""

from __future__ import annotations

import json
import os
import threading
import time

COUNTER_BITS = 22
COUNTER_MASK = (1 << COUNTER_BITS) - 1
MAX_COUNTER = COUNTER_MASK

# ------------------------------------------------------------ wall clock
# The package's ONE wall-clock door: cituslint (CONF01) confines
# time.time() to this module, so every TTL, expiry stamp, and activity
# timestamp reads the same swappable clock.  Tests install a fake with
# set_wall_clock() to drive time-dependent logic deterministically.

_wall_clock = time.time


def now() -> float:
    """Wall-clock seconds since the epoch, through the test seam."""
    return _wall_clock()


def set_wall_clock(fn) -> None:
    """Replace the wall clock (tests only); ``None`` restores the real
    one.  Affects every now() caller package-wide."""
    global _wall_clock
    _wall_clock = time.time if fn is None else fn


def pack(ms: int, counter: int) -> int:
    return (ms << COUNTER_BITS) | (counter & COUNTER_MASK)


def unpack(value: int) -> tuple[int, int]:
    return value >> COUNTER_BITS, value & COUNTER_MASK


class CausalClock:
    PERSIST_EVERY = 1 << 16  # persist a future floor every N ticks

    def __init__(self, data_dir: str):
        self._path = os.path.join(data_dir, "cluster_clock.json")
        self._mu = threading.Lock()
        floor = 0
        if os.path.exists(self._path):
            with open(self._path) as fh:
                floor = json.load(fh).get("floor", 0)
        now = pack(int(time.time() * 1000), 0)
        self._last = max(floor, now)
        self._persist_at = self._last + self.PERSIST_EVERY

    def _persist(self) -> None:
        tmp = self._path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump({"floor": self._persist_at}, fh)
        os.replace(tmp, self._path)

    def now(self) -> int:
        """Monotone HLC tick (citus_get_node_clock)."""
        with self._mu:
            wall = pack(int(time.time() * 1000), 0)
            if wall > self._last:
                self._last = wall
            else:
                ms, counter = unpack(self._last)
                if counter >= MAX_COUNTER:
                    self._last = pack(ms + 1, 0)
                else:
                    self._last = pack(ms, counter + 1)
            if self._last >= self._persist_at:
                self._persist_at = self._last + self.PERSIST_EVERY
                self._persist()
            return self._last

    def adjust(self, remote: int) -> int:
        """Merge a remote clock value (PrepareAndSetTransactionClock's
        max-over-nodes step): local clock never goes backwards."""
        with self._mu:
            if remote > self._last:
                self._last = remote
        return self.now()

    def transaction_clock(self) -> int:
        """citus_get_transaction_clock: one tick stamped on the whole
        distributed transaction (single-coordinator: one tick)."""
        return self.now()
