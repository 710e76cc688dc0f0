"""Observability: stat counters, per-query statistics, activity view.

Reference analogs:
- citus_stat_counters  (src/backend/distributed/stats/stat_counters.c —
  lock-free per-backend slots; here a lock-guarded counter dict)
- citus_stat_statements (stats/query_stats.c — shmem hash by queryId;
  here keyed by normalized SQL text, with log-scale latency histograms
  for p50/p95/p99)
- citus_stat_activity  (transaction/backend_data.c global pids; here
  live statements with a global id and a live execution phase fed by
  the tracer, observability/trace.py)
"""

from __future__ import annotations

import itertools
import re
import threading
import time
from citus_tpu_torch.utils import sanitizer as _san
from citus_tpu_torch.utils.clock import now as wall_now
from bisect import bisect_left
from collections import OrderedDict
from dataclasses import dataclass, field


class StatCounters:
    COUNTERS = [
        "queries_executed",
        "router_queries",
        "multi_shard_queries",
        "join_queries",
        "tasks_dispatched",
        "rows_ingested",
        "rows_returned",
        "chunks_total",
        "chunks_selected",
        "bytes_scanned",
        "plan_cache_hits",
        "plan_cache_misses",
        "connection_failovers",
        # remote SELECT task push (executor/worker_tasks.py) vs the
        # sync_placement pull path: result bytes shipped per pushed
        # task against stripe bytes mirrored per pulled placement
        "remote_tasks_pushed",
        "remote_task_fallbacks",
        "remote_task_result_bytes",
        "placement_sync_bytes",
        # pipelined executor (executor/pipeline.py): stalls of the host
        # decode / device dispatch halves, the high-water mark of
        # concurrent remote-task RPCs, and remote wait hidden behind
        # local work
        "pipeline_host_stalls",
        "pipeline_device_stalls",
        "remote_tasks_inflight_peak",
        "remote_task_wait_overlapped_ms",
        # surgical plan-cache invalidation (planner/plan_cache.py):
        # targeted entry drops and LRU pressure
        "plan_cache_invalidations",
        "plan_cache_evictions",
        # process-wide compiled-kernel LRU keyed by structural plan
        # fingerprint (executor/kernel_cache.py); compile_ms books the
        # trace+compile wall time XLA spends on true misses
        "kernel_cache_hits",
        "kernel_cache_misses",
        "kernel_compile_ms",
        # HBM-resident batch cache (executor/device_cache.py)
        "device_cache_hits",
        "device_cache_misses",
        "device_cache_evicted_bytes",
        # distributed tracing (observability/): sampled query roots,
        # spans recorded, slow-ring entries, and per-phase wall time
        # folded from span close (observability/trace.py _SPAN_MS)
        "trace_queries_sampled",
        "trace_spans_recorded",
        "slow_queries_logged",
        "span_parse_ms",
        "span_plan_ms",
        "span_execute_ms",
        "span_finalize_ms",
        "span_remote_task_ms",
        # cross-host ingest routed through the data plane (cluster.py)
        "rows_ingested_remote",
        # data-plane connection pool: send/recv/connect failures that
        # trigger a reconnect or failover (net/data_plane.py) — silent
        # before, every swallow now counts here
        "data_plane_pool_errors",
        # authority failovers that ended in self-promotion
        # (net/control_plane.py ensure_authority)
        "authority_promotions",
        # per-stripe secondary-index probes served (storage/reader.py)
        "index_lookups",
        # victims cancelled by the global deadlock detector
        # (transaction/global_deadlock.py)
        "deadlocks_cancelled",
        # cumulative per-event blocked time from the wait-event seam
        # (begin_wait/end_wait below; WaitEventSet analog, SURVEY §2.5)
        "wait_remote_rpc_ms",
        "wait_lock_ms",
        "wait_prefetch_stall_ms",
        "wait_device_round_ms",
        "wait_2pc_decision_ms",
        "wait_megabatch_ms",
        # same-family query coalescing (executor/megabatch.py):
        # queries that rode a batch, device dispatches issued for them,
        # and groups that fell back to the serial path; span_megabatch_ms
        # folds each query's enqueue->scatter stretch from its trace span
        "megabatch_queries",
        "megabatch_batches",
        "megabatch_fallbacks",
        "span_megabatch_ms",
        # cluster stat fan-out (observability/cluster_stats.py): probes
        # issued and per-node failures degraded to node_unreachable rows
        "stat_fanout_probes",
        "stat_fanout_unreachable",
        # workload scheduler (workload/scheduler.py): queries fast-
        # failed by tenant queue-depth/rate limits, the high-water mark
        # of queued admissions, and cumulative fair-share queue wait
        "tenant_shed",
        "admission_queue_depth_peak",
        "wait_admission_ms",
        # wire format A/B (net/data_plane.py): bytes decoded from
        # zero-copy columnar frames vs the legacy npz container, so
        # SHOW STATS exposes which codec actually carried the traffic
        "wire_frame_bytes",
        "wire_npz_bytes",
        # non-blocking shard moves (operations/shard_transfer.py):
        # catch-up rounds run across all moves, cumulative wall time the
        # colocation group's writers were actually blocked (the final
        # micro-catch-up + flip window only), and time the mover spent
        # parked between catch-up rounds
        "shard_move_catchup_rounds",
        "shard_move_blocked_write_ms",
        "wait_shard_move_catchup_ms",
        # cluster flight recorder (observability/flight_recorder.py):
        # sampler ticks taken, disk-segment rotations, errors swallowed
        # by the sampler loop, and typed events the health engine raised
        "flight_recorder_ticks",
        "flight_recorder_rotations",
        "flight_recorder_errors",
        "health_events_emitted",
        # HBM bytes a query actually touched on device: cache hits book
        # the resident entry's size, streaming scans book the transfer
        # (executor/device_cache.py, executor/executor.py, megabatch.py);
        # EXPLAIN ANALYZE's Memory: line is this counter's delta
        "device_hbm_touched_bytes",
        # continuous aggregation (rollup/manager.py, rollup/routing.py):
        # refresh-loop ticks, source rows folded into rollup state,
        # errors swallowed by the loop, CDC changes a merge-only rollup
        # could not fold (update/delete ops, NULL group keys), queries
        # the planner answered from a rollup instead of a raw scan, and
        # the loop's parked-between-ticks wall time
        "rollup_refresh_ticks",
        "rollup_rows_folded",
        "rollup_refresh_errors",
        "rollup_skipped_changes",
        "rollup_queries_served",
        "wait_rollup_refresh_ms",
        # multi-coordinator metadata sync (metadata/sync.py): catalog
        # bytes shipped as CTFR frames, pull-on-mismatch rounds run,
        # statements that observed a stale catalog before converging,
        # and wall time blocked on a sync round trip
        "metadata_sync_bytes",
        "metadata_sync_rounds",
        "metadata_stale_reads",
        "wait_metadata_sync_ms",
        # fused single-dispatch hot loop (executor/executor.py,
        # executor/megabatch.py): kernel rounds issued with the running
        # partial-agg registers donated in (1 per batch — the staged
        # worker+merge pair would be 2), and rows in chunks the footer
        # min/max admission refuted BEFORE their streams were read or
        # decompressed (storage/reader.py)
        "fused_dispatches",
        "fused_rows_skipped",
        # streaming fused hash aggregation (executor/executor.py,
        # executor/megabatch.py, ops/hash_agg.py): fused hash-table
        # kernel rounds (1 per batch, table donated in), rows that lost
        # a fingerprint-collision probe and drained into the exact host
        # accumulator, and remote hash-table partials merged back
        # through the device merge door (executor/pipeline.py push path)
        "hash_fused_dispatches",
        "hash_spill_rows",
        "hash_partials_pushed",
        # pull-path placement syncs skipped because the control plane's
        # data-invalidation epoch proved the local mirror current
        # (net/data_plane.py sync_placement fast path)
        "placement_sync_elided",
        # autopilot control loop (services/autopilot.py): evaluation
        # ticks, and decisions by outcome — executed a rebalance action,
        # observed one (citus.autopilot=observe logs without acting),
        # declined one (hysteresis / cooldown / in-flight guard)
        "autopilot_ticks",
        "autopilot_actions_executed",
        "autopilot_actions_observed",
        "autopilot_actions_declined",
    ]

    def __init__(self):
        self._mu = threading.Lock()
        self._c = {name: 0 for name in self.COUNTERS}
        self._reset_hooks: list = []

    def bump(self, name: str, by: int = 1) -> None:
        with self._mu:
            self._c[name] = self._c.get(name, 0) + by

    def bump_max(self, name: str, value: int) -> None:
        """High-water-mark counters: keep the max seen, not a sum."""
        with self._mu:
            self._c[name] = max(self._c.get(name, 0), value)

    def snapshot(self) -> dict[str, int]:
        with self._mu:
            return dict(self._c)

    def add_reset_hook(self, fn) -> None:
        """Register a callable invoked after every reset() — consumers
        holding derived state keyed to counter values (the flight
        recorder's rate baselines) re-zero with the counters instead of
        differencing across the reset."""
        with self._mu:
            if fn not in self._reset_hooks:
                self._reset_hooks.append(fn)

    def remove_reset_hook(self, fn) -> None:
        with self._mu:
            if fn in self._reset_hooks:
                self._reset_hooks.remove(fn)

    def reset(self) -> None:
        with self._mu:
            for k in self._c:
                self._c[k] = 0
            hooks = list(self._reset_hooks)
        # hooks run AFTER the counter lock is released: a hook may take
        # its own lock while a concurrent sampler holding that lock
        # calls snapshot() — nesting here would deadlock
        for fn in hooks:
            try:
                fn()
            except Exception:  # lint: disable=SWL01 -- one broken consumer must not block the reset for the rest
                continue


# ---------------------------------------------------------- wait events
#
# WaitEventSet analog (SURVEY §2.5): a backend entering a blocking
# branch brackets it with begin_wait/end_wait.  The event name feeds the
# activity view's wait_event column through a thread-local sink stack
# (mirroring trace.py's phase sinks — nested execute() restores), and
# the blocked wall time folds into a cumulative wait_*_ms counter.  The
# seam costs nothing on non-blocking paths: call sites only reach it
# AFTER the fast path (queue non-empty, lock granted first try) failed.

#: registered wait events -> their cumulative counters.  cituslint CNT03
#: cross-checks every begin_wait("...") literal in the package against
#: these keys, both directions.
WAIT_COUNTERS = {
    "remote_rpc": "wait_remote_rpc_ms",
    "lock": "wait_lock_ms",
    "prefetch_stall": "wait_prefetch_stall_ms",
    "device_round": "wait_device_round_ms",
    "2pc_decision": "wait_2pc_decision_ms",
    # parked in a coalescing window (executor/megabatch.py) — a
    # scheduling stall, deliberately distinct from device_round
    "megabatch_wait": "wait_megabatch_ms",
    # queued in the workload scheduler's fair-share admission queue
    # (workload/scheduler.py) — waiting for a slot grant, not holding
    # one; distinct from megabatch_wait (already admitted, coalescing)
    "admission_wait": "wait_admission_ms",
    # a shard mover draining replication lag between catch-up passes
    # (operations/shard_transfer.py) — the mover waits, writers do not
    "shard_move_catchup": "wait_shard_move_catchup_ms",
    # the rollup refresh loop parked between ticks (rollup/manager.py)
    # — the background consumer waits, ingest and queries do not
    "rollup_refresh": "wait_rollup_refresh_ms",
    # a coordinator pulling mismatched catalog objects from the
    # metadata authority (metadata/sync.py) — version-vector fetch +
    # CTFR frame pull round trips
    "metadata_sync": "wait_metadata_sync_ms",
}

WAIT_EVENTS = tuple(sorted(WAIT_COUNTERS))

_wait_tls = threading.local()


def _counters():
    from citus_tpu_torch.executor.executor import GLOBAL_COUNTERS
    return GLOBAL_COUNTERS


def push_wait_sink(sink) -> None:
    """Install a wait-event sink for this thread (cluster.execute binds
    ActivityTracker.set_wait).  Stacked: nested execute() restores."""
    sinks = getattr(_wait_tls, "sinks", None)
    if sinks is None:
        sinks = _wait_tls.sinks = []
    sinks.append(sink)


def pop_wait_sink() -> None:
    sinks = getattr(_wait_tls, "sinks", None)
    if sinks:
        sinks.pop()


def begin_wait(event: str):
    """Mark this backend blocked in ``event``; returns the token
    end_wait() needs.  The event name must be a key of WAIT_COUNTERS
    (lint-enforced at literal call sites)."""
    sinks = getattr(_wait_tls, "sinks", None)
    if sinks:
        try:
            sinks[-1](event)
        # lint: disable=SWL01 -- a broken sink must not break the waiting backend
        except Exception:
            pass
    if _san._ACTIVE:  # one attribute read when the sanitizer is off
        _san.on_begin_wait(event)
    from citus_tpu_torch.observability.trace import clock
    return event, clock()


def end_wait(token) -> float:
    """Close a begin_wait() bracket: clear the backend's wait_event and
    fold the blocked wall time into the event's counter.  Returns ms."""
    event, t0 = token
    from citus_tpu_torch.observability.trace import clock
    ms = (clock() - t0) * 1000.0
    _counters().bump(WAIT_COUNTERS[event], max(1, int(ms)))
    sinks = getattr(_wait_tls, "sinks", None)
    if sinks:
        try:
            sinks[-1]("")
        # lint: disable=SWL01 -- a broken sink must not break the waiting backend
        except Exception:
            pass
    return ms


_WS = re.compile(r"\s+")
# One scanner, ordered alternation: double-quoted identifiers and $N
# parameter markers are PRESERVED (a bare \b\d+\b pass used to rewrite
# digits inside them — '"t 1"' -> '"t ?"', '$1' -> '$?' — merging stats
# buckets across distinct relations/params); single-quoted strings and
# free-standing numeric literals become "?".  The lookaround keeps
# digits glued to identifier characters (t1, k_2, x2y) untouched.
_TOKEN = re.compile(
    r'"(?:[^"]|"")*"'               # quoted identifier — keep verbatim
    r"|'(?:[^']|'')*'"              # string literal    -> ?
    r"|\$\d+"                       # parameter marker  — keep verbatim
    r"|(?<![\w$])\d+(?:\.\d+)?(?![\w.])"  # numeric literal -> ?
)


def _token_sub(m: re.Match) -> str:
    t = m.group(0)
    if t.startswith('"') or t.startswith("$"):
        return t
    return "?"


def normalize_query(sql: str) -> str:
    """Replace literals with placeholders so executions of the same shape
    share one statistics bucket (queryId analog)."""
    out = _TOKEN.sub(_token_sub, sql)
    return _WS.sub(" ", out).strip().lower()


class LatencyHistogram:
    """Bounded log-scale latency histogram: 18 power-of-two buckets
    from 0.25 ms to ~32.8 s plus overflow — fixed memory per query
    family, good-enough p50/p95/p99 by linear interpolation inside the
    winning bucket (reference: pg_stat_statements keeps only mean/min/
    max; the histogram is what the Prometheus exporter wants)."""

    #: inclusive upper bounds (ms) of the finite buckets
    BOUNDS_MS = [0.25 * (2 ** i) for i in range(18)]

    __slots__ = ("counts", "count", "sum_ms")

    def __init__(self):
        self.counts = [0] * (len(self.BOUNDS_MS) + 1)  # + overflow
        self.count = 0
        self.sum_ms = 0.0

    def record(self, ms: float) -> None:
        self.counts[bisect_left(self.BOUNDS_MS, ms)] += 1
        self.count += 1
        self.sum_ms += ms

    def percentile(self, p: float) -> float:
        """Estimated latency (ms) at quantile ``p`` in [0, 1]."""
        if self.count == 0:
            return 0.0
        target = p * self.count
        cum = 0
        for i, n in enumerate(self.counts):
            if n == 0:
                continue
            if cum + n >= target:
                hi = (self.BOUNDS_MS[i] if i < len(self.BOUNDS_MS)
                      else self.BOUNDS_MS[-1] * 2)
                lo = self.BOUNDS_MS[i - 1] if i > 0 else 0.0
                frac = (target - cum) / n
                return lo + (hi - lo) * frac
            cum += n
        return self.BOUNDS_MS[-1] * 2


@dataclass
class QueryStat:
    calls: int = 0
    total_time_s: float = 0.0
    rows: int = 0
    executor: str = ""
    partition_key: str = ""
    hist: LatencyHistogram = field(default_factory=LatencyHistogram)


class QueryStats:
    """Normalized-query statistics with an O(1) LFU eviction: keys live
    in per-call-count buckets (insertion-ordered, so ties evict the
    stalest), and a ``_min_calls`` cursor tracks the coldest bucket.
    The old least-called min-scan was O(n) per insert once the table
    filled — every new query family paid a full-table walk."""

    def __init__(self, max_entries: int = 5000):
        self._mu = threading.Lock()
        self._stats: dict[str, QueryStat] = {}
        # calls -> keys at that call count (LFU frequency buckets)
        self._freq: dict[int, OrderedDict] = {}
        self._min_calls = 1
        self.max_entries = max_entries

    def record(self, sql: str, elapsed_s: float, rows: int, executor: str,
               partition_key: str = "") -> None:
        key = normalize_query(sql)
        with self._mu:
            st = self._stats.get(key)
            if st is None:
                if len(self._stats) >= self.max_entries:
                    self._evict_locked()
                st = self._stats[key] = QueryStat(executor=executor,
                                                  partition_key=partition_key)
            else:
                bucket = self._freq.get(st.calls)
                if bucket is not None:
                    bucket.pop(key, None)
                    if not bucket:
                        del self._freq[st.calls]
                        if self._min_calls == st.calls:
                            self._min_calls = st.calls + 1
            st.calls += 1
            if st.calls == 1:
                self._min_calls = 1
            self._freq.setdefault(st.calls, OrderedDict())[key] = None
            st.total_time_s += elapsed_s
            st.rows += rows
            st.executor = executor
            st.hist.record(elapsed_s * 1000.0)

    def _evict_locked(self) -> None:
        # reference evicts by LRU on its dump cycle; least-called
        # (oldest within the coldest bucket) is close enough here
        while self._min_calls not in self._freq:
            self._min_calls += 1  # defensive; invariant keeps this O(1)
        bucket = self._freq[self._min_calls]
        victim, _ = bucket.popitem(last=False)
        if not bucket:
            del self._freq[self._min_calls]
        del self._stats[victim]

    def rows_view(self) -> list[tuple]:
        with self._mu:
            return [(q, s.executor, s.partition_key, s.calls,
                     round(s.total_time_s * 1000, 3), s.rows,
                     round(s.hist.percentile(0.50), 3),
                     round(s.hist.percentile(0.95), 3),
                     round(s.hist.percentile(0.99), 3))
                    for q, s in sorted(self._stats.items(),
                                       key=lambda kv: -kv[1].total_time_s)]

    def histograms_view(self) -> list[tuple]:
        """(normalized query, LatencyHistogram) pairs for exporters."""
        with self._mu:
            return [(q, s.hist) for q, s in self._stats.items()]

    def reset(self) -> None:
        with self._mu:
            self._stats.clear()
            self._freq.clear()
            self._min_calls = 1


class TenantStats:
    """Per-tenant (distribution key value) attribution for router
    queries (reference: citus_stat_tenants, stats/stat_tenants.c) with a
    coarse sliding window."""

    WINDOW_S = 60.0

    def __init__(self, max_tenants: int = 1000):
        self._mu = threading.Lock()
        self._t: dict[str, list] = {}  # key -> [count, total_time, window_start]
        self.max_tenants = max_tenants

    def record(self, tenant: str, elapsed_s: float) -> None:
        now = wall_now()
        with self._mu:
            st = self._t.get(tenant)
            if st is None:
                if len(self._t) >= self.max_tenants:
                    victim = min(self._t, key=lambda k: self._t[k][0])
                    del self._t[victim]
                st = self._t[tenant] = [0, 0.0, now]
            if now - st[2] > self.WINDOW_S:
                st[0], st[1], st[2] = 0, 0.0, now
            st[0] += 1
            st[1] += elapsed_s

    def rows_view(self) -> list[tuple]:
        now = wall_now()
        with self._mu:
            # expire at read time: a tenant whose window elapsed with no
            # new record would otherwise show its stale count forever
            for k in [k for k, st in self._t.items()
                      if now - st[2] > self.WINDOW_S]:
                del self._t[k]
            return [(k, c, round(t * 1000, 3))
                    for k, (c, t, _) in sorted(self._t.items(),
                                               key=lambda kv: -kv[1][0])]


_GPID = itertools.count(1)


@dataclass
class Activity:
    gpid: int
    sql: str
    started_at: float
    state: str = "active"
    # live execution phase (plan / compile / device / remote-wait /
    # finalize), fed by observability/trace.py's phase sink
    phase: str = ""
    # current blocking wait event (a WAIT_COUNTERS key, "" when not
    # blocked), fed by the begin_wait/end_wait sink above
    wait_event: str = ""


class ActivityTracker:
    def __init__(self):
        self._mu = threading.Lock()
        self._live: dict[int, Activity] = {}

    def enter(self, sql: str) -> int:
        gpid = next(_GPID)
        with self._mu:
            self._live[gpid] = Activity(gpid, sql, wall_now())
        return gpid

    def exit(self, gpid: int) -> None:
        with self._mu:
            self._live.pop(gpid, None)

    def set_phase(self, gpid: int, phase: str) -> None:
        with self._mu:
            a = self._live.get(gpid)
            if a is not None:
                a.phase = phase

    def set_wait(self, gpid: int, event: str) -> None:
        with self._mu:
            a = self._live.get(gpid)
            if a is not None:
                a.wait_event = event

    def rows_view(self) -> list[tuple]:
        now = wall_now()
        with self._mu:
            return [(a.gpid, a.state, round(now - a.started_at, 3), a.sql,
                     a.phase, a.wait_event)
                    for a in self._live.values()]
