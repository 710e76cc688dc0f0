"""Cross-process file lock (flock) used to serialize shared-data-dir
mutations between coordinator processes — the single implementation
behind catalog commits, dictionary growth, the transaction log, the
cleanup registry, and shard-group write locks.  Supports shared
(LOCK_SH) and exclusive (LOCK_EX) modes and an acquisition timeout.
Not re-entrant; create one instance per critical section."""

from __future__ import annotations

import os
import time


class LockTimeout(OSError):
    pass


class FileLock:
    def __init__(self, path: str, shared: bool = False,
                 timeout: float | None = None):
        self._path = path
        self._shared = shared
        self._timeout = timeout
        self._fd = None

    def __enter__(self):
        import fcntl
        mode = fcntl.LOCK_SH if self._shared else fcntl.LOCK_EX
        self._fd = os.open(self._path, os.O_CREAT | os.O_RDWR)
        if self._timeout is None:
            fcntl.flock(self._fd, mode)
            return self
        deadline = time.monotonic() + self._timeout
        while True:
            try:
                fcntl.flock(self._fd, mode | fcntl.LOCK_NB)
                return self
            except OSError:
                if time.monotonic() >= deadline:
                    os.close(self._fd)
                    self._fd = None
                    raise LockTimeout(
                        f"could not lock {self._path!r} within {self._timeout}s")
                time.sleep(0.02)

    def __exit__(self, *exc):
        import fcntl
        if self._fd is not None:
            fcntl.flock(self._fd, fcntl.LOCK_UN)
            os.close(self._fd)
            self._fd = None
        return False
