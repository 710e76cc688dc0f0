"""Maintenance daemon.

Reference: the per-database maintenance background worker
(src/backend/distributed/utils/maintenanced.c) that periodically runs
deferred-resource cleanup, 2PC recovery, deadlock detection, and
metadata-sync retries.  Here: one daemon thread per Cluster running a
pluggable list of periodic duties; ships with cleanup and stale-lock
recovery, and later milestones register more duties (transaction
recovery, health checks).
"""

from __future__ import annotations

import threading
from citus_tpu_torch.utils.clock import now as wall_now
from dataclasses import dataclass
from typing import Callable

from citus_tpu_torch.catalog import Catalog
from citus_tpu_torch.operations.cleaner import try_drop_orphaned_resources


@dataclass
class Duty:
    name: str
    fn: Callable[[], object]
    # a float, or a zero-arg callable re-read every tick (so SET-style
    # runtime changes to an interval take effect on a running daemon)
    interval_s: "float | Callable[[], float]"
    # higher runs first within a tick: a due latency-critical duty
    # (deadlock detection) must never wait behind a long-running
    # housekeeping duty that happened to register earlier
    priority: int = 0
    last_run: float = 0.0
    runs: int = 0
    errors: int = 0


class MaintenanceDaemon:
    def __init__(self, cat: Catalog, *, cleanup_interval_s: float = 5.0):
        self.cat = cat
        self._duties: list[Duty] = []
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.register("deferred_cleanup",
                      lambda: try_drop_orphaned_resources(cat),
                      cleanup_interval_s)

    def register(self, name: str, fn: Callable[[], object], interval_s: float,
                 priority: int = 0) -> None:
        self._duties.append(Duty(name, fn, interval_s, priority=priority))

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="citus-tpu-maintenanced")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def run_once(self) -> None:
        """Run every duty immediately (tests + explicit triggers)."""
        for d in self._ordered():
            self._run_duty(d)

    def _ordered(self) -> list[Duty]:
        """Duties in execution order: priority desc, then registration
        order (sorted() is stable, so equal priorities keep their
        historical ordering)."""
        return sorted(self._duties, key=lambda d: -d.priority)

    @staticmethod
    def _interval(d: Duty) -> float:
        return d.interval_s() if callable(d.interval_s) else d.interval_s

    def status(self) -> list[tuple]:
        return [(d.name, self._interval(d), d.runs, d.errors)
                for d in self._duties]

    def _run_duty(self, d: Duty) -> None:
        try:
            d.fn()
            d.runs += 1
        except Exception:
            d.errors += 1
        d.last_run = wall_now()

    def _loop(self) -> None:
        while not self._stop.is_set():
            now = wall_now()
            for d in self._ordered():
                if now - d.last_run >= self._interval(d):
                    self._run_duty(d)
            self._stop.wait(timeout=0.2)
