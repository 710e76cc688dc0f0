"""Pipelined adaptive executor: the two wall-clock overlaps the
reference's adaptive executor gets from connection-level concurrency.

Reference: AdaptiveExecutor (adaptive_executor.c:775) keeps one
connection pool PER WORKER NODE, growing each pool from one connection
toward citus.max_adaptive_executor_pool_size by slow-start (README:
1670-1688), all pools bounded globally by citus.max_shared_pool_size's
shared-memory counters — so a multi-host query costs the *max* of the
per-host times, not the sum.  SURVEY §2.4 maps "intra-node multi-core
parallelism / pipelined ingest" to XLA async streams; this module is
the host half of that lowering.

Two pieces, as in the reference (``citus_tpu/executor/pipeline.py``):

- ``dispatch_remote_tasks`` / ``RemoteTaskDispatch``: fan out
  ``execute_task`` RPCs through the coordinator's single event loop
  (net/event_loop.py, the WaitEventSet analog — O(1) dispatcher
  threads no matter how wide the fan-out) with a per-node in-flight
  window (slow-start: each node starts at 1 and ramps toward
  ``citus.max_adaptive_executor_pool_size`` on successes), each extra
  concurrent RPC taking an OPTIONAL slot from the cross-query
  ``citus.max_shared_pool_size`` pool (denied = stay at the current
  width).  The caller dispatches first, scans local placements while
  the RPCs fly, and collects as they complete — result decode happens
  on the collecting thread, not the loop; per-task failures fall back
  to the local pull path exactly like the serial dispatcher did.
- ``prefetch_batches`` / ``HostPrefetcher``: a bounded read-ahead
  queue fed by a background decode worker producing padded
  ``ShardBatch``es (chunk decompress, null decode, pad, stack) while
  the device executes the previous round — backpressure at
  ``citus.executor_prefetch_depth``, errors from the decode thread
  re-raised at the consumer, prompt cancellation when the consumer
  dies.  Depth 0 decodes inline (the pre-pipeline serial behavior).
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from typing import Iterator, Optional

from citus_tpu_torch.errors import ExecutionError
from citus_tpu_torch.observability import trace as _trace
from citus_tpu_torch.observability.trace import clock as _perf
from citus_tpu_torch.stats import begin_wait, end_wait


class PipelineStats:
    """Per-query pipeline accounting.  The decode thread owns
    host_decode_s/device_stalls, the consumer owns the rest — disjoint
    writers, read only after the pipeline is joined."""

    def __init__(self) -> None:
        self.host_decode_s = 0.0   # time inside the host decode iterator
        self.device_s = 0.0        # H2D transfer + kernel dispatch + sync
        self.h2d_bytes = 0         # bytes shipped host -> device
        self.host_stalls = 0       # consumer found the queue empty
        self.device_stalls = 0     # producer found the queue full

    def as_dict(self) -> dict:
        return {
            "host_decode_ms": round(self.host_decode_s * 1000, 3),
            "device_ms": round(self.device_s * 1000, 3),
            "h2d_bytes": int(self.h2d_bytes),
            "host_stalls": int(self.host_stalls),
            "device_stalls": int(self.device_stalls),
        }

    def publish(self, plan) -> None:
        """Merge into the plan's EXPLAIN surface and the global
        counters (the citus_stat_counters analog)."""
        from citus_tpu_torch.executor.executor import GLOBAL_COUNTERS
        plan.runtime_cache.setdefault("pipeline", {}).update(self.as_dict())
        if self.host_stalls:
            GLOBAL_COUNTERS.bump("pipeline_host_stalls", self.host_stalls)
        if self.device_stalls:
            GLOBAL_COUNTERS.bump("pipeline_device_stalls",
                                 self.device_stalls)


def read_ahead_depth(settings) -> int:
    """Host read-ahead queue depth (citus.executor_prefetch_depth);
    0 disables the decode thread entirely."""
    return max(0, settings.executor.executor_prefetch_depth)


# ------------------------------------------------- host/device overlap


class _InlineHostIter:
    """Depth-0 degenerate prefetcher: decode inline on the consumer
    thread (the serial pre-pipeline behavior), still timing the host
    half so EXPLAIN stays comparable."""

    def __init__(self, source: Iterator, stats: Optional[PipelineStats]):
        self._source = iter(source)
        self._stats = stats

    def __iter__(self):
        return self

    def __next__(self):
        t0 = _perf()
        try:
            return next(self._source)
        finally:
            if self._stats is not None:
                self._stats.host_decode_s += _perf() - t0

    def close(self) -> None:
        close = getattr(self._source, "close", None)
        if close is not None:
            close()


class HostPrefetcher:
    """Bounded read-ahead over a host batch iterator, fed by one
    background decode worker.  The queue depth IS the backpressure:
    the decode thread blocks when the device is ``depth`` batches
    behind, so host memory stays bounded no matter how large the scan.

    Exceptions raised by the source (fault injections included) are
    re-raised at the consumer's next ``__next__``.  ``close()``
    cancels the worker promptly even when it is blocked on a full
    queue (consumer died mid-scan)."""

    _ITEM, _DONE, _ERR = 0, 1, 2

    def __init__(self, source: Iterator, depth: int,
                 stats: Optional[PipelineStats] = None):
        from citus_tpu_torch.storage.overlay import current_overlay
        self._source = iter(source)
        self._stats = stats
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._cancel = threading.Event()
        # the transaction overlay is thread-local: the decode thread
        # must see the consumer's staged writes, not a bare snapshot
        self._txn = current_overlay()
        self._thread = threading.Thread(target=self._produce, daemon=True,
                                        name="citus-host-decode")
        self._finished = False
        self._thread.start()

    # ---- producer (decode thread) ----
    def _put(self, item) -> bool:
        stalled = False
        while not self._cancel.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                if not stalled and self._stats is not None:
                    # device behind: backpressure holds the decode
                    self._stats.device_stalls += 1
                    stalled = True
        return False

    def _produce(self) -> None:
        from citus_tpu_torch.storage.overlay import transaction_overlay
        with transaction_overlay(self._txn):
            self._produce_inner()

    def _produce_inner(self) -> None:
        try:
            while not self._cancel.is_set():
                t0 = _perf()
                try:
                    batch = next(self._source)
                except StopIteration:
                    self._put((self._DONE, None))
                    return
                finally:
                    if self._stats is not None:
                        self._stats.host_decode_s += _perf() - t0
                if not self._put((self._ITEM, batch)):
                    return
        except BaseException as e:  # surfaces at the consumer
            self._put((self._ERR, e))

    # ---- consumer ----
    def __iter__(self):
        return self

    def __next__(self):
        if self._finished:
            raise StopIteration
        try:
            kind, val = self._q.get_nowait()
        except queue.Empty:
            if self._stats is not None:
                # host behind: the device would starve here
                self._stats.host_stalls += 1
            wtok = begin_wait("prefetch_stall")
            try:
                while True:
                    try:
                        kind, val = self._q.get(timeout=0.5)
                        break
                    except queue.Empty:
                        if not self._thread.is_alive() and self._q.empty():
                            raise ExecutionError(
                                "host decode worker died without a result")
            finally:
                end_wait(wtok)
        if kind == self._ITEM:
            return val
        self._finished = True
        if kind == self._ERR:
            raise val
        raise StopIteration

    def close(self) -> None:
        """Cancel the decode worker and drain; idempotent, safe to call
        from a ``finally`` around the consumer loop."""
        self._cancel.set()
        while self._thread.is_alive():
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)
        close = getattr(self._source, "close", None)
        if close is not None:
            try:
                close()
            # lint: disable=SWL01 -- source close at shutdown is best-effort; batches already delivered
            except Exception:
                pass


def prefetch_batches(source: Iterator, depth: int,
                     stats: Optional[PipelineStats] = None):
    """Wrap a host batch iterator in the read-ahead pipeline (depth >=
    1) or the inline fallback (depth 0)."""
    if depth <= 0:
        return _InlineHostIter(source, stats)
    return HostPrefetcher(source, depth, stats)


# ------------------------------------------------ remote task dispatch


class _NodePool:
    """Per-worker-node dispatch window (the WorkerPool analog): starts
    at one in-flight RPC and ramps by one per success toward the
    citus.max_adaptive_executor_pool_size cap — slow start."""

    __slots__ = ("window", "inflight", "pending")

    def __init__(self):
        self.window = 1
        self.inflight = 0
        self.pending: deque = deque()


class RemoteTaskDispatch:
    """In-flight remote execute_task fan-out.  Construction starts the
    RPCs; ``collect()`` blocks until every task settled and returns
    ``(fallback_shard_indexes, results)`` — failed tasks fall back to
    the local pull path, successes carry decoded partials/batches.
    ``abort()`` (error path) drops undispatched tasks and waits out the
    in-flight ones so no thread outlives the query attempt."""

    def __init__(self, cat, plan, settings, tasks, payload_kind: str):
        self.cat = cat
        self.plan = plan
        self.cap = max(1, settings.executor.max_adaptive_pool_size)
        self.shared_limit = settings.executor.max_shared_pool_size
        self.wire = settings.executor.wire_format
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        self._nodes: dict[int, _NodePool] = {}
        # "agg" -> decode_partials, "hash" -> decode_hash_partials,
        # anything else -> decode_batch (projection rows)
        self._payload_kind = payload_kind
        # si -> (node, meta, blob, rpc_s, rspan): raw response frames,
        # decoded on the COLLECTING thread so the event loop never
        # serializes decode work behind socket readiness
        self._raw: dict[int, tuple] = {}
        self._fallback: list[int] = []
        self._total = len(tasks)
        self._settled = 0
        self._inflight_total = 0
        self._inflight_peak = 0
        self._aborted = False
        # ONE dispatcher drives the whole fan-out (started lazily; a
        # local-only query never spins it up)
        self._loop = cat.remote_data.event_loop() if tasks else None
        # trace context captured BEFORE the RPCs start: spans opened
        # for them attach to the dispatching query's tree, and the
        # (trace_id, parent span_id) pair rides in each task payload
        self._trace_ctx = _trace.capture()
        self._t_start = _perf()
        self._t_last_done = self._t_start
        for si, node, ep, task in tasks:
            pool = self._nodes.setdefault(int(node), _NodePool())
            pool.pending.append((si, node, ep, task))
        self._launch()

    # ---- scheduling (caller holds self._mu) ----
    def _plan_locked(self) -> list:
        """Pick every launchable task and bump the in-flight
        accounting; returns fully-built submit descriptors.  The
        actual ``submit`` (JSON encode + wake) happens OUTSIDE the
        lock in ``_launch`` — under the old hold-``_mu``-across-submit
        shape, the event-loop thread's completion callback blocked on
        ``_mu`` for as long as a submitting caller spent encoding,
        stalling every other in-flight RPC behind one thread's CPU
        work (the citussan BLK01 loop-thread hazard)."""
        from citus_tpu_torch.workload import GLOBAL_SCHEDULER
        batch = []
        progress = True
        while progress:
            progress = False
            for pool in self._nodes.values():
                if not pool.pending or pool.inflight >= pool.window:
                    continue
                if self._inflight_total == 0:
                    holds_slot = False  # rides the query's required slot
                elif GLOBAL_SCHEDULER.try_extra(self.shared_limit):
                    holds_slot = True
                else:
                    return batch  # pool saturated; retry on completion
                si, node, ep, task = pool.pending.popleft()
                pool.inflight += 1
                self._inflight_total += 1
                self._inflight_peak = max(self._inflight_peak,
                                          self._inflight_total)
                rspan = None
                if self._trace_ctx is not None:
                    tr, parent = self._trace_ctx
                    rspan = tr.open_span(
                        "remote_task", parent.span_id,
                        {"shard_index": int(si), "node": int(node)})
                    # span context rides in the payload; the worker
                    # records its half against the same trace_id and
                    # returns it in the meta
                    task = dict(task, trace={
                        "trace_id": tr.trace_id,
                        "parent_span_id": rspan.span_id})
                batch.append((ep, task, pool, si, node, rspan,
                              holds_slot))
                progress = True
        return batch

    def _launch(self) -> None:
        """Launch until no pool can accept more work: plan under the
        (bookkeeping-only) lock, submit outside it.  Safe concurrently
        from callers and the loop-thread done_cb: the accounting a plan
        bumps is committed before ``_mu`` is released, so a racing plan
        never double-launches a task."""
        while True:
            # lint: disable=BLK01 -- bookkeeping-only microsection: planning never encodes, submits, or blocks
            with self._mu:
                batch = self._plan_locked()
            if not batch:
                return
            for ep, task, pool, si, node, rspan, holds_slot in batch:
                t0 = _perf()
                # done_cb runs ON the loop thread (never inline here),
                # so a caller may hold its own locks across _launch
                self._loop.submit(
                    ep, "execute_task", task,
                    done_cb=lambda fut, pool=pool, si=si, node=node,
                    rspan=rspan, holds_slot=holds_slot, t0=t0:
                    # lint: disable=BLK01 -- done_cb fires post-settle; _on_done's result()/lock never block the loop
                    self._on_done(fut, pool, si, node, rspan,
                                  holds_slot, t0))

    # ---- one RPC settled (event-loop thread) ----
    def _on_done(self, fut, pool, si, node, rspan, holds_slot,
                 t0) -> None:
        from citus_tpu_torch.executor.executor import GLOBAL_COUNTERS
        from citus_tpu_torch.workload import GLOBAL_SCHEDULER
        rpc_s = _perf() - t0
        meta = blob = None
        ok = True
        try:
            # lint: disable=BLK01 -- done_cb fires after the future settles; result() returns immediately
            meta, blob = fut.result()
        # lint: disable=SWL01 -- failure is counted below as remote_task_fallbacks; shard rescans locally
        except Exception:
            # worker dead, version skew, codec refused server-side:
            # this shard scans locally through the pull path instead
            ok = False
        if blob is None:
            ok = False  # a pushed task must return a binary frame
        nbytes = len(blob) if blob is not None else 0
        if rspan is not None:
            tr, _parent = self._trace_ctx
            # dec_ms lands later, from the collecting thread's decode
            rspan.set(ok=ok, bytes=int(nbytes),
                      rpc_ms=round(rpc_s * 1000, 3), dec_ms=0.0)
            tr.close_span(rspan)
            if ok and isinstance(meta, dict) and meta.get("spans"):
                tr.graft(meta["spans"], rspan)
        if holds_slot:
            GLOBAL_SCHEDULER.release_extra()
        # lint: disable=BLK01 -- bookkeeping-only microsection on the loop thread; no holder blocks inside it
        with self._mu:
            pool.inflight -= 1
            self._inflight_total -= 1
            if ok:
                pool.window = min(self.cap, pool.window + 1)  # slow start
                self._raw[si] = (int(node), meta, blob, rpc_s, rspan)
                GLOBAL_COUNTERS.bump("remote_tasks_pushed")
                GLOBAL_COUNTERS.bump("remote_task_result_bytes", nbytes)
            else:
                self._fallback.append(si)
                GLOBAL_COUNTERS.bump("remote_task_fallbacks")
            self._settled += 1
            self._t_last_done = _perf()
            relaunch = not self._aborted
            if self._settled >= self._total and self._inflight_total == 0:
                self._cv.notify_all()
        if relaunch:
            self._launch()

    # ---- caller side ----
    def collect(self) -> tuple[list[int], list]:
        """Wait for every in-flight task; returns (fallback shard
        indexes, successful results in shard-index order) and publishes
        the overlap/peak stats.  Decode runs here, on the caller — the
        event loop only moves bytes."""
        from citus_tpu_torch.executor.executor import GLOBAL_COUNTERS
        from citus_tpu_torch.net.data_plane import (decode_batch,
                                              decode_hash_partials,
                                              decode_partials)
        if self._total:
            _trace.set_phase("remote-wait")
        t_enter = _perf()
        with self._cv:
            if self._settled < self._total or self._inflight_total:
                # only a real block opens a wait bracket: a fan-out that
                # finished behind local work must not book phantom ms
                wtok = begin_wait("remote_rpc")
                try:
                    while self._settled < self._total or self._inflight_total:
                        self._cv.wait(0.5)
                finally:
                    end_wait(wtok)
            fallback = list(self._fallback)
            raw = dict(self._raw)
            peak = self._inflight_peak
            t_last = self._t_last_done
        wait_s = _perf() - t_enter
        results, tlog = [], []
        for si in sorted(raw):
            node, meta, blob, rpc_s, rspan = raw[si]
            t1 = _perf()
            try:
                if self._payload_kind == "agg":
                    payload = decode_partials(blob)
                elif self._payload_kind == "hash":
                    payload = decode_hash_partials(blob)
                else:
                    payload = decode_batch(blob)
            # lint: disable=SWL01 -- counted as remote_task_fallbacks below; shard rescans locally
            except Exception:
                # decode failed after a successful RPC (codec skew):
                # the shard rescans locally.  remote_tasks_pushed was
                # already bumped when the frame landed — an accepted
                # asymmetry for this rare path.
                fallback.append(si)
                GLOBAL_COUNTERS.bump("remote_task_fallbacks")
                continue
            dec_s = _perf() - t1
            if rspan is not None:
                rspan.set(dec_ms=round(dec_s * 1000, 3))
            results.append(payload)
            tlog.append((si, node, len(blob), rpc_s, dec_s))
        fallback = sorted(fallback)
        # the stretch of remote in-flight time the caller spent doing
        # local work instead of blocking — the overlap win itself
        overlapped_s = max(0.0, min(t_enter, t_last) - self._t_start)
        self.plan.runtime_cache["remote_tasks"] = tlog
        if self._total:
            pl = self.plan.runtime_cache.setdefault("pipeline", {})
            pl["remote_wait_ms"] = round(wait_s * 1000, 3)
            pl["remote_overlapped_ms"] = round(overlapped_s * 1000, 3)
            pl["remote_inflight_peak"] = peak
            pl["wire_format"] = self.wire
            GLOBAL_COUNTERS.bump_max("remote_tasks_inflight_peak", peak)
            GLOBAL_COUNTERS.bump("remote_task_wait_overlapped_ms",
                                 int(overlapped_s * 1000))
        return fallback, results

    def abort(self) -> None:
        """Error path: stop launching, count nothing, wait out the
        in-flight RPCs so no worker thread outlives the attempt."""
        with self._cv:
            self._aborted = True
            for pool in self._nodes.values():
                self._settled += len(pool.pending)
                pool.pending.clear()
            while self._inflight_total:
                self._cv.wait(0.5)


def dispatch_remote_tasks(cat, plan, settings, params=((), ())
                          ) -> tuple[list[int], RemoteTaskDispatch]:
    """Start the remote fan-out for every remote-only placement of
    ``plan`` and return immediately: ``(local_shard_indexes,
    dispatch)``.  The caller scans the local shards while the RPCs are
    in flight, then ``dispatch.collect()``s.  Inexpressible plans (or
    policy "pull") push nothing — everything stays local."""
    from citus_tpu_torch.executor.executor import GLOBAL_COUNTERS
    from citus_tpu_torch.executor.worker_tasks import encode_task, split_pushable
    plan.runtime_cache["pipeline"] = {}
    local, remote = split_pushable(cat, plan, settings)
    if not remote:
        plan.runtime_cache["remote_tasks"] = []
        return list(local), RemoteTaskDispatch(cat, plan, settings, [], "")
    template = encode_task(plan, params)
    if template is not None:
        # the coordinator's citus.wire_format decides how the WORKER
        # encodes its result; a worker that predates the key defaults
        # to npz, and decode always sniffs the magic — either way the
        # response decodes
        template = dict(template, wire=settings.executor.wire_format)
    if template is None:
        GLOBAL_COUNTERS.bump("remote_task_fallbacks", len(remote))
        plan.runtime_cache["remote_tasks"] = []
        return (sorted(local + [si for si, _, _ in remote]),
                RemoteTaskDispatch(cat, plan, settings, [], ""))
    tasks = [(si, node,
              ep, dict(template,
                       shard_id=plan.bound.table.shards[si].shard_id,
                       node=node))
             for si, node, ep in remote]
    return list(local), RemoteTaskDispatch(
        cat, plan, settings, tasks, template["kind"])
