"""Runtime concurrency sanitizer — citussan's dynamic half.

Enabled by ``CITUS_SANITIZE=1`` (record findings) or
``CITUS_SANITIZE=raise`` (raise ``SanitizerError`` in the offending
thread).  When enabled, ``install()`` — called from the package root
BEFORE any submodule import — replaces ``threading.Lock`` /
``threading.RLock`` with factories that wrap every lock the package
creates (callers outside ``citus_tpu_torch`` get real locks, untouched).

Each wrapped lock is identified by its CREATION SITE (file:line), so
all instances of e.g. ``RemoteTaskDispatch._mu`` collapse onto one
node.  The sanitizer maintains:

- a per-thread held-set (which wrapped locks this thread holds now);
- a global acquisition-order graph: an edge a→b is recorded the first
  time any thread acquires b while holding a.  Acquiring b while a
  path b→…→a already exists is an observed lock-order inversion — two
  threads interleaving those two code paths can deadlock — and is
  reported with the full prior path;
- a blocking re-acquire of a non-reentrant Lock the same thread
  already holds ALWAYS raises (recording it and hanging would lose
  the report);
- ``begin_wait`` seam entries (see stats.py) while holding any
  non-condition-backing lock are reported as wait-under-lock —
  ``threading.Condition`` waiting is exempt because ``cv.wait``
  releases its lock while parked (the factory marks backing locks);
- threads registered through ``register_loop_thread()`` (the
  RpcEventLoop service thread) must never block: a lock acquire that
  stalls past the ``_LOOP_GRACE_S`` window (microsecond bookkeeping
  holders clear well inside it) or any ``begin_wait`` entry on such a
  thread is reported.

Everything is a no-op until ``install()`` activates: module state is
plain constants, ``on_begin_wait`` is guarded by the ``_ACTIVE`` flag
at the call site, and ``threading.Lock`` stays the C fast path — the
off mode is zero-cost by construction (bench.py's BENCH_SANITIZE
section asserts it).
"""
from __future__ import annotations

import os
import sys
import threading
from typing import Optional

__all__ = [
    "SanitizerError", "install", "enabled", "report", "reset",
    "on_begin_wait", "register_loop_thread", "unregister_loop_thread",
]

_ACTIVE = False
_MODE = "off"  # off | record | raise
#: a lock the event-loop thread wants may be contended by design for
#: the length of a bookkeeping microsection; a hold that keeps the
#: loop parked past this is a genuine stall
_LOOP_GRACE_S = 0.1

# real factories captured at import time, before install() repoints
# the threading module attributes
_real_Lock = threading.Lock
_real_RLock = threading.RLock
_real_Condition = threading.Condition

_state_mu = _real_Lock()  # guards _graph/_findings/_reported
_graph: dict = {}         # site -> set of sites acquired while held
_reported: set = set()    # (held_site, acq_site) pairs already reported
_findings: list = []
_loop_threads: set = set()
_tls = threading.local()  # .held: list[(wrapper, site)] in acquire order


class SanitizerError(RuntimeError):
    """A concurrency hazard observed at runtime (raise mode only)."""


def _held() -> list:
    h = getattr(_tls, "held", None)
    if h is None:
        h = _tls.held = []
    return h


def _site_of(frame) -> str:
    fn = frame.f_code.co_filename
    cut = fn.rfind("citus_tpu_torch")
    if cut >= 0:
        fn = fn[cut:]
    return "%s:%d" % (fn, frame.f_lineno)


def _record(kind: str, detail: str) -> None:
    entry = {"kind": kind, "detail": detail,
             "thread": threading.current_thread().name}
    with _state_mu:
        _findings.append(entry)
    if _MODE == "raise":
        raise SanitizerError("[%s] %s" % (kind, detail))


def _path_locked(src: str, dst: str) -> Optional[list]:
    """Path src→…→dst in the order graph, or None (caller holds
    _state_mu)."""
    parent = {src: None}
    stack = [src]
    while stack:
        node = stack.pop()
        if node == dst:
            path = [node]
            while parent[node] is not None:
                node = parent[node]
                path.append(node)
            return path[::-1]
        for nxt in _graph.get(node, ()):
            if nxt not in parent:
                parent[nxt] = node
                stack.append(nxt)
    return None


class _SanLock:
    """Order-tracking proxy around one threading.Lock/RLock."""

    __slots__ = ("_inner", "_site", "_reentrant", "_cv_backed")

    def __init__(self, inner, site: str, reentrant: bool):
        self._inner = inner
        self._site = site
        self._reentrant = reentrant
        self._cv_backed = False

    # -- hazard checks happen BEFORE the real acquire ------------------
    def acquire(self, blocking: bool = True, timeout: float = -1):
        held = _held()
        already = any(entry[0] is self for entry in held)
        if already and not self._reentrant and blocking:
            # recording + proceeding would hang the suite right here
            _record("self-deadlock",
                    "blocking re-acquire of %s by its holder" % self._site)
            raise SanitizerError(
                "self-deadlock: blocking re-acquire of %s" % self._site)
        pending = []
        if not already and held:
            with _state_mu:
                for _lk, held_site in held:
                    if held_site == self._site:
                        continue
                    succ = _graph.setdefault(held_site, set())
                    if self._site not in succ:
                        inv = _path_locked(self._site, held_site)
                        if inv is not None:
                            key = (held_site, self._site)
                            if key not in _reported:
                                _reported.add(key)
                                pending.append(
                                    "lock-order inversion: holding %s, "
                                    "acquiring %s, but the opposite order "
                                    "%s was observed earlier"
                                    % (held_site, self._site,
                                       " -> ".join(inv)))
                        succ.add(self._site)
        for detail in pending:  # outside _state_mu: _record re-takes it
            _record("lock-order-cycle", detail)
        if blocking and threading.get_ident() in _loop_threads:
            got = self._inner.acquire(False)
            if not got:
                # bounded bookkeeping microsections (queue swaps,
                # done_cb accounting) contend for microseconds by
                # design; only a stall outliving the grace window
                # means the loop thread is parked behind real work
                got = self._inner.acquire(True, _LOOP_GRACE_S)
            if not got:
                _record("loop-thread-block",
                        "acquire of %s stalled the event-loop thread "
                        "for > %dms" % (self._site,
                                        int(_LOOP_GRACE_S * 1000)))
                got = self._inner.acquire(True, timeout)
        else:
            got = self._inner.acquire(blocking, timeout)
        if got:
            held.append((self, self._site))
        return got

    def release(self) -> None:
        held = _held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] is self:
                del held[i]
                break
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def _is_owned(self) -> bool:
        # threading.Condition probes ownership through this seam
        inner = self._inner
        if hasattr(inner, "_is_owned"):
            return inner._is_owned()
        if inner.acquire(False):
            inner.release()
            return False
        return True

    def __repr__(self) -> str:
        return "<SanLock %s %r>" % (self._site, self._inner)


def _wrap_for_caller(make, reentrant: bool):
    caller = sys._getframe(2)
    if caller.f_globals.get("__name__", "").startswith("citus_tpu_torch"):
        return _SanLock(make(), _site_of(caller), reentrant)
    return make()


def _lock_factory():
    return _wrap_for_caller(_real_Lock, False)


def _rlock_factory():
    return _wrap_for_caller(_real_RLock, True)


def _condition_factory(lock=None):
    # cv.wait RELEASES its backing lock while parked, so begin_wait
    # brackets opened under it are not wait-under-lock: mark the
    # wrapper exempt.  The Condition itself gets the wrapper, keeping
    # the held-set exact across wait()'s release/re-acquire.
    if isinstance(lock, _SanLock):
        lock._cv_backed = True
    return _real_Condition(lock)


# ---------------------------------------------------------------- API


def install() -> bool:
    """Activate if CITUS_SANITIZE is set; returns whether active.
    Must run before any citus_tpu_torch submodule creates a lock."""
    global _ACTIVE, _MODE
    mode = os.environ.get("CITUS_SANITIZE", "").strip().lower()
    if mode in ("", "0", "off", "false", "no"):
        return False
    _MODE = "raise" if mode == "raise" else "record"
    _ACTIVE = True
    threading.Lock = _lock_factory
    threading.RLock = _rlock_factory
    threading.Condition = _condition_factory
    return True


def enabled() -> bool:
    return _ACTIVE


def on_begin_wait(event: str) -> None:
    """stats.begin_wait seam: the calling thread is ABOUT to block on
    ``event``.  Callers gate on ``_ACTIVE`` so the off mode costs one
    attribute read."""
    if not _ACTIVE:
        return
    blocking_held = sorted({site for lk, site in _held()
                            if not lk._cv_backed})
    if blocking_held:
        _record("wait-under-lock",
                "begin_wait(%r) while holding %s"
                % (event, ", ".join(blocking_held)))
    if threading.get_ident() in _loop_threads:
        _record("loop-thread-block",
                "begin_wait(%r) on the event-loop thread" % event)


def register_loop_thread() -> None:
    """Mark the CURRENT thread as a never-block event-loop thread."""
    if _ACTIVE:
        _loop_threads.add(threading.get_ident())


def unregister_loop_thread() -> None:
    _loop_threads.discard(threading.get_ident())


def report() -> list:
    """Findings recorded so far (copies; empty when off or clean)."""
    with _state_mu:
        return [dict(f) for f in _findings]


def reset() -> None:
    """Drop findings AND the learned order graph (tests only)."""
    with _state_mu:
        _findings.clear()
        _graph.clear()
        _reported.clear()
