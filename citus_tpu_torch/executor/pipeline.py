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

Two pieces in the reference; the first is stubbed here to "all shards
local" until ROADMAP.md A13:

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
from typing import Iterator, Optional

from citus_tpu_torch.errors import ExecutionError
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


class LocalOnlyDispatch:
    """The remote fan-out of the reference (``execute_task`` RPCs to the
    coordinators owning remote-only placements) is not ported yet
    (ROADMAP.md A13): every shard scans locally, and ``collect()``
    returns no fallbacks and no remote results."""

    def collect(self) -> tuple[list[int], list]:
        return [], []

    def abort(self) -> None:
        pass


def dispatch_remote_tasks(cat, plan, settings, params=((), ())
                          ) -> tuple[list[int], LocalOnlyDispatch]:
    """-> ``(local_shard_indexes, dispatch)``: all shards local."""
    plan.runtime_cache["pipeline"] = {}
    plan.runtime_cache["remote_tasks"] = []
    return list(plan.shard_indexes), LocalOnlyDispatch()
