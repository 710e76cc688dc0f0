"""Fault injection points.

Reference: the mitmproxy harness
(src/test/regress/mitmscripts/fluent.py) that kills/delays coordinator↔
worker traffic per query pattern, driven by the citus.mitmproxy() UDF.
Our transport is in-process, so the equivalent is named injection points
compiled into the hot paths (task dispatch, placement read, catalog
commit, shard-move copy); tests arm them with kill/delay/error actions.

Usage:
    FAULTS.arm("dispatch_task", error=ExecutionError("boom"), times=1)
    FAULTS.arm("read_placement", delay_s=0.05, match="lineitem")
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Optional


class FaultError(Exception):
    pass


@dataclass
class _Arm:
    error: Optional[BaseException] = None
    delay_s: float = 0.0
    times: int = -1          # -1 = unlimited
    match: Optional[str] = None
    after: int = 0           # skip the first N hits
    kill: bool = False       # os._exit(1): SIGKILL-equivalent, no handlers
    hits: int = 0


class FaultInjector:
    def __init__(self):
        self._mu = threading.Lock()
        self._arms: dict[str, _Arm] = {}

    def arm(self, point: str, *, error: Optional[BaseException] = None,
            delay_s: float = 0.0, times: int = -1,
            match: Optional[str] = None, after: int = 0,
            kill: bool = False) -> None:
        with self._mu:
            self._arms[point] = _Arm(error=error, delay_s=delay_s, times=times,
                                     match=match, after=after, kill=kill)

    def disarm(self, point: Optional[str] = None) -> None:
        with self._mu:
            if point is None:
                self._arms.clear()
            else:
                self._arms.pop(point, None)

    def hit(self, point: str, context: str = "") -> None:
        """Called from production code at each injection point; no-op
        unless a test armed the point."""
        with self._mu:
            arm = self._arms.get(point)
            if arm is None:
                return
            if arm.match is not None and arm.match not in context:
                return
            arm.hits += 1
            if arm.hits <= arm.after:
                return
            if arm.times >= 0 and (arm.hits - arm.after) > arm.times:
                return
            delay = arm.delay_s
            error = arm.error
            kill = arm.kill
        if delay:
            time.sleep(delay)
        if kill:
            # crash-recovery tests: die like SIGKILL — no except blocks,
            # no finally clauses, no atexit — so the survivors (cleaner
            # adoption, registry pid liveness) are what gets exercised
            import os
            os._exit(1)
        if error is not None:
            raise error


FAULTS = FaultInjector()
