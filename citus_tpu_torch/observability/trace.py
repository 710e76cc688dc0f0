"""Dapper-style span trees with cross-RPC context propagation.

One query = one ``Trace``: a flat, lock-guarded list of ``Span``s
linked by parent ids —
``query -> parse -> plan(bind/auto_param/prune) -> kernel(compile|hit)
-> execute(device_round xN / host_agg / shuffle) -> remote_task xM ->
finalize`` plus 2PC phases on writes.  Remote ``execute_task`` spans
are recorded on the worker against the SAME trace_id (the context
rides in the RPC payload) and grafted back under the coordinator's
``remote_task`` span from the RPC response, so the tree stays single-
rooted across hosts.

Sampling (citus.trace_sample_rate) decides at the root: an unsampled
query never allocates a Span — ``span()`` returns a process-wide no-op
singleton and ``span_allocations()`` lets tests assert the hot path
stayed allocation-free.  ``citus.log_min_duration_ms >= 0`` force-
samples every query so the tree exists by the time the threshold
verdict is known (the slow-query ring keeps it, fast queries drop it).

This module is ALSO the package's single span-timing clock: every
subsystem times through ``clock`` (CI-enforced — no other module under
citus_tpu_torch/ may call time.perf_counter).

On close, spans fold their duration into StatCounters deltas so the
aggregate view (citus_stat_counters) stays consistent with the trees.
"""

from __future__ import annotations

import contextlib
import os
import random
import threading
import time

from citus_tpu_torch.utils.clock import now as wall_now
import uuid
from typing import Optional

#: the package-wide span-timing clock (monotonic seconds).
clock = time.perf_counter

_tls = threading.local()

#: Span objects ever constructed in this process; the sample_rate=0
#: regression test asserts query execution leaves this untouched.
_span_allocations = 0


def span_allocations() -> int:
    return _span_allocations


def _counters():
    from citus_tpu_torch.executor.executor import GLOBAL_COUNTERS
    return GLOBAL_COUNTERS


#: span name -> StatCounters bucket its duration folds into on close
#: (keeps citus_stat_counters consistent with the trees; names here
#: satisfy the dead-counter lint by construction)
_SPAN_MS = {
    "parse": "span_parse_ms",
    "plan": "span_plan_ms",
    "execute": "span_execute_ms",
    "finalize": "span_finalize_ms",
    "remote_task": "span_remote_task_ms",
    "megabatch": "span_megabatch_ms",
}


class Span:
    """One timed node of a trace.  Context manager: ``__enter__``
    activates it for the current thread, ``__exit__`` closes it (and
    folds the duration into the counters)."""

    __slots__ = ("name", "span_id", "parent_id", "t0", "t1", "attrs",
                 "_trace")

    def __init__(self, trace: "Trace", name: str,
                 parent_id: Optional[str], attrs: dict):
        global _span_allocations
        _span_allocations += 1
        self._trace = trace
        self.name = name
        self.span_id = os.urandom(4).hex()
        self.parent_id = parent_id
        self.t0 = clock()
        self.t1: Optional[float] = None
        self.attrs = attrs

    # recording is always True on real spans; the no-op twin reports
    # False so callers can skip attribute computation entirely
    recording = True

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    @property
    def duration_ms(self) -> float:
        end = self.t1 if self.t1 is not None else clock()
        return (end - self.t0) * 1000.0

    def __enter__(self) -> "Span":
        _stack().append((self._trace, self))
        return self

    def __exit__(self, *exc) -> bool:
        st = _stack()
        if st and st[-1][1] is self:
            st.pop()
        self._trace.close_span(self)
        return False


class _NoopSpan:
    """Allocation-free stand-in returned when no trace is active."""

    __slots__ = ()
    recording = False
    name = ""
    span_id = ""
    parent_id = None
    attrs: dict = {}
    duration_ms = 0.0

    def set(self, **attrs) -> "_NoopSpan":
        return self

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NOOP_SPAN = _NoopSpan()


class Trace:
    """All spans of one query, on one or many hosts.  Span open/close
    is lock-guarded: remote-dispatch threads record concurrently."""

    def __init__(self, trace_id: Optional[str] = None):
        self.trace_id = trace_id or uuid.uuid4().hex[:16]
        self.spans: list[Span] = []
        # wall anchor for exporters: span.t0 - self.t0 offsets t0_wall
        self.t0_wall = wall_now()
        self.t0 = clock()
        self._mu = threading.Lock()
        self.reasons: set[str] = set()

    # ---- span lifecycle ----
    def open_span(self, name: str, parent_id: Optional[str],
                  attrs: Optional[dict] = None) -> Span:
        s = Span(self, name, parent_id, attrs if attrs is not None else {})
        with self._mu:
            self.spans.append(s)
        return s

    def close_span(self, s: Span, end: Optional[float] = None) -> None:
        if s.t1 is not None:
            return
        s.t1 = end if end is not None else clock()
        c = _counters()
        c.bump("trace_spans_recorded")
        bucket = _SPAN_MS.get(s.name)
        if bucket is not None:
            c.bump(bucket, max(1, int((s.t1 - s.t0) * 1000)))

    def add_closed(self, name: str, parent_id: Optional[str],
                   t0: float, t1: float,
                   attrs: Optional[dict] = None) -> Span:
        """Retroactive span from already-measured endpoints (e.g. a
        compile detected only after the jitted call returned)."""
        s = Span(self, name, parent_id, attrs if attrs is not None else {})
        s.t0 = t0
        with self._mu:
            self.spans.append(s)
        self.close_span(s, end=t1)
        return s

    # ---- structure ----
    def root(self) -> Optional[Span]:
        ids = {s.span_id for s in self.spans}
        for s in self.spans:
            if s.parent_id is None or s.parent_id not in ids:
                return s
        return None

    def children(self, span_id: str) -> list[Span]:
        return [s for s in self.spans if s.parent_id == span_id]

    def find(self, name: str) -> Optional[Span]:
        for s in self.spans:
            if s.name == name:
                return s
        return None

    def find_all(self, name: str) -> list[Span]:
        return [s for s in self.spans if s.name == name]

    # ---- cross-RPC ----
    def export_spans(self) -> list[dict]:
        """Serialize for the execute_task RPC response: times relative
        to this trace's start (the coordinator re-anchors on graft)."""
        with self._mu:
            return [{"name": s.name, "sid": s.span_id, "pid": s.parent_id,
                     "t0": s.t0 - self.t0,
                     "t1": (s.t1 if s.t1 is not None else clock()) - self.t0,
                     "attrs": dict(s.attrs)} for s in self.spans]

    def graft(self, span_dicts: list[dict], anchor: Span) -> None:
        """Stitch worker-side spans under ``anchor`` (the coordinator's
        remote_task span).  The worker clock is unrelated to ours, so
        the subtree is re-anchored: its root starts where the RPC's
        non-network time plausibly began (centered inside the anchor)."""
        if not span_dicts:
            return
        ids = {d["sid"] for d in span_dicts}
        roots = [d for d in span_dicts
                 if d["pid"] is None or d["pid"] not in ids]
        rel0 = min(d["t0"] for d in span_dicts)
        remote_dur = max(d["t1"] for d in span_dicts) - rel0
        anchor_end = anchor.t1 if anchor.t1 is not None else clock()
        slack = max(0.0, (anchor_end - anchor.t0) - remote_dur) / 2.0
        base = anchor.t0 + slack - rel0
        grafted = []
        for d in span_dicts:
            s = Span(self, str(d["name"]), d["pid"], dict(d["attrs"]))
            s.span_id = str(d["sid"])
            s.t0 = base + float(d["t0"])
            s.t1 = base + float(d["t1"])
            grafted.append(s)
        for d, s in zip(span_dicts, grafted):
            if d in roots:
                s.parent_id = anchor.span_id
        with self._mu:
            self.spans.extend(grafted)


# --------------------------------------------------- thread-local ctx


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def current() -> Optional[tuple[Trace, Span]]:
    """(trace, span) active on this thread, or None."""
    st = getattr(_tls, "stack", None)
    return st[-1] if st else None


def span(name: str, **attrs):
    """Child span of the thread's current span; the no-op singleton
    when no trace is active (zero allocation on the unsampled path)."""
    st = getattr(_tls, "stack", None)
    if not st:
        return NOOP_SPAN
    trace, parent = st[-1]
    return trace.open_span(name, parent.span_id, attrs)


@contextlib.contextmanager
def activate(trace: Trace, span_: Span):
    """Install (trace, span) as this thread's current context — used
    where the context cannot ride the call stack: worker-side RPC
    handlers and remote-dispatch threads."""
    st = _stack()
    st.append((trace, span_))
    try:
        yield span_
    finally:
        if st and st[-1] == (trace, span_):
            st.pop()


def capture() -> Optional[tuple[Trace, Span]]:
    """Snapshot the current context for handoff to another thread."""
    return current()


# ------------------------------------------------------- live phases


def push_phase_sink(sink) -> None:
    """Install a callable(phase: str) receiving live-phase updates for
    the statement this thread is executing (cluster.execute wires it to
    ActivityTracker.set_phase).  Stacked: nested execute() restores."""
    sinks = getattr(_tls, "phase_sinks", None)
    if sinks is None:
        sinks = _tls.phase_sinks = []
    sinks.append(sink)


def pop_phase_sink() -> None:
    sinks = getattr(_tls, "phase_sinks", None)
    if sinks:
        sinks.pop()


def set_phase(phase: str) -> None:
    """Report the executing statement's current phase (plan / compile /
    device / remote-wait / finalize).  Cheap no-op when no sink is
    installed; never raises into the executor."""
    sinks = getattr(_tls, "phase_sinks", None)
    if sinks:
        try:
            sinks[-1](phase)
        # lint: disable=SWL01 -- observability sink must never raise into the executor hot path
        except Exception:
            pass


# ------------------------------------------------------- query roots


class QueryTrace:
    """Root handle for one traced query: owns the Trace, its root
    ``query`` span, and the thread-context push/pop."""

    __slots__ = ("trace", "root", "_entered")

    def __init__(self, trace: Trace, root: Span):
        self.trace = trace
        self.root = root
        self._entered = False

    @property
    def sampled(self) -> bool:
        """True when the trace should outlive the query regardless of
        duration (rate-sampled or explicitly forced)."""
        return bool(self.trace.reasons & {"rate", "forced"})

    def enter(self) -> None:
        _stack().append((self.trace, self.root))
        self._entered = True

    def finish(self) -> float:
        """Close the root, restore the thread context; returns the
        query duration in ms."""
        if self._entered:
            st = _stack()
            if st and st[-1] == (self.trace, self.root):
                st.pop()
            self._entered = False
        self.trace.close_span(self.root)
        return (self.root.t1 - self.root.t0) * 1000.0


def begin_query(sql: str, obs, force: bool = False) -> Optional[QueryTrace]:
    """Start a traced query if the sampling gate opens; None otherwise.

    ``obs`` is the ObservabilitySettings section.  Reasons: "rate"
    (trace_sample_rate admitted it), "forced" (EXPLAIN ANALYZE and
    tests), "slow_watch" (log_min_duration_ms >= 0 force-samples so the
    tree exists when the threshold verdict lands at close)."""
    reasons = set()
    if force:
        reasons.add("forced")
    rate = obs.trace_sample_rate
    if rate > 0.0 and (rate >= 1.0 or random.random() < rate):
        reasons.add("rate")
    if obs.log_min_duration_ms >= 0:
        reasons.add("slow_watch")
    if not reasons:
        return None
    tr = Trace()
    tr.reasons = reasons
    _counters().bump("trace_queries_sampled")
    root = tr.open_span("query", None, {"sql": sql[:500]})
    qt = QueryTrace(tr, root)
    qt.enter()
    return qt


#: most recently finished sampled trace (debug/test hook; also what
#: ``citus_last_trace()`` would serve if we ever add it)
_last: Optional[Trace] = None


def set_last(trace: Trace) -> None:
    global _last
    _last = trace


def last_trace() -> Optional[Trace]:
    return _last
