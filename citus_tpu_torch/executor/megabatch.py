"""Query megabatching: coalesce same-family queries into ONE dispatch.

The kernel cache (executor/kernel_cache.py) already collapses literal
variants of a query into one plan family via ``plan_fingerprint``; this
module collapses their *executions*.  Queries whose plans share a
fingerprint and arrive within ``citus.megabatch_window_ms`` (bounded by
``citus.megabatch_max_size``) share one scan of the family's shard
batches, and each batch goes through ONE launch of each batched kernel
for all of them:

- ``filter_mask_batched`` (ops/filter_mask.py): every query's WHERE, with
  its own parameters, into row q of a bool [Q, N] mask — the columns
  are read once whatever Q is;
- ``scan_agg_fold_batched`` (ops/scan_agg_fold.py): scalar and direct
  aggregation into [Q, G] registers;
- ``hash_agg_insert_batched`` (ops/hash_agg_insert.py): hash GROUP BY
  into Q stacked tables, spilled rows drained per query on the host.

They replace the JAX package's ``batched:`` slots, where ``jax.vmap``
lifts the serial kernels over a query axis padded to a power of two so
that one compile serves a bucket of occupancies.  Here Q is a runtime
argument of each kernel: no padding, no padded lanes to compute.  The
group keys and aggregate arguments reference no parameter (auto-param
hoists filter literals only), so they are computed once per batch and
shared by every query; a plan whose keys or arguments do reference one
raises instead of silently taking the serial path.

Leader/follower protocol (no background thread): the first arrival for
a family becomes the batch leader, parks on the window (cut short when
the batch fills), pops the queue and executes; followers park on a
per-waiter event.  Both park under the ``megabatch_wait`` wait event —
a coalescing stall is scheduling, not device backpressure, so it must
never masquerade as ``device_round`` in the activity view.  The leader
synchronises the device before it wakes anyone: the followers read the
results on their own threads.

Scatter keeps everything per-QUERY: the leader produces per-query
partial states (agg), table slices and spill accumulators (hash agg) or
row masks (projection); each caller then combines/finalizes/orders **on
its own thread**, so per-query errors isolate to their caller and
citus_stat_statements / tenant stats book one entry per query exactly
as on the serial path.

Correctness is never traded for occupancy:

- queries whose bind-time pruning diverged sub-batch by shard set;
- the shared scan drops per-literal chunk intervals and index probes
  (each query's own predicate re-applies on device with its own
  params), trading skip-list pruning for occupancy — results are
  identical either way;
- a shared-infrastructure failure (admission timeout or shedding,
  shard-map flip, snapshot lock timeout, storage error) falls the
  whole group back to the serial path on the callers' own threads;
  any other failure of the dispatch (a batched kernel that does not
  build or launch) reaches every rider as its error;
- ``citus.megabatch_window_ms = 0`` (the default) short-circuits in
  execute_select before this module is even imported: byte-identical
  serial behavior.
"""

from __future__ import annotations

import copy
import dataclasses
import threading

import numpy as np

from citus_tpu_torch.errors import (
    AdmissionShedError, AdmissionTimeoutError, ExecutionError,
    StorageError, UnsupportedFeatureError,
)
from citus_tpu_torch.observability import trace as _trace
from citus_tpu_torch.observability.trace import clock
from citus_tpu_torch.stats import begin_wait, end_wait


def _counters():
    from citus_tpu_torch.executor.executor import GLOBAL_COUNTERS
    return GLOBAL_COUNTERS


# expected inter-arrival gap (s) beyond which an auto-sized window
# treats a plan family as sparse and stops waiting
_AUTO_SPARSE_S = 0.025

#: device bytes the Q stacked hash tables of one dispatch may take; a
#: larger group splits into sub-batches that each scan the shards once
#: (2^20 slots of 48 to 88-byte slot records, ops/hash_agg.py
#: record_layout: 46 to 85 queries fit)
HASH_TABLES_BUDGET_BYTES = 4 << 30


class ShardMapChanged(RuntimeError):
    """The table's shard map changed under the cached plan."""


def _infrastructure_errors() -> tuple:
    """Failures of what the group shares rather than of the batched
    kernels: the group retries serially, each query re-planned and
    admitted on its own."""
    from citus_tpu_torch.utils.filelock import LockTimeout
    return (AdmissionTimeoutError, AdmissionShedError, ShardMapChanged,
            LockTimeout, StorageError)


class _Waiter:
    """One query parked in a dispatch queue: its full execution context
    plus the scatter slots the leader fills."""

    __slots__ = ("cat", "bound", "settings", "plan", "params", "device",
                 "done", "payload", "serial", "error", "occupancy",
                 "dispatches", "t_enq")

    def __init__(self, cat, bound, settings, plan, params, device):
        self.cat = cat
        self.bound = bound
        self.settings = settings
        self.plan = plan
        self.params = params
        self.device = device
        self.done = threading.Event()
        # ("agg", [partial tuple]), ("hash_agg", (table slice, acc)) or
        # ("proj", env_batches)
        self.payload = None
        self.serial = False
        # a failure of the shared dispatch, raised on this rider's thread
        self.error: BaseException | None = None
        self.occupancy = 0
        self.dispatches = 0
        self.t_enq = clock()


class _Queue:
    __slots__ = ("waiters", "full", "sealed")

    def __init__(self):
        self.waiters: list[_Waiter] = []
        self.full = threading.Event()
        self.sealed = False


class MegabatchDispatcher:
    """Per-fingerprint dispatch queues + process-wide occupancy stats
    (rendered by SELECT citus_megabatch_stats())."""

    def __init__(self):
        self._mu = threading.Lock()
        self._queues: dict[tuple, _Queue] = {}
        # auto-window state: plan family -> (last arrival t, EWMA gap s)
        self._arrivals: dict[tuple, tuple[float, float]] = {}
        self.batches = 0
        self.queries = 0
        self.fallbacks = 0
        # shard batches the batched runners scanned: one launch of each
        # batched kernel of the family's mode per dispatch
        self.dispatches = 0
        # batch-level view: dispatch occupancy -> batch count
        self.occupancy_hist: dict[int, int] = {}
        # query-level view (fed from cluster.execute, one note per user
        # statement): occupancy a query rode in -> query count
        self.query_occupancy_hist: dict[int, int] = {}
        # reason -> queries that could not coalesce (window != 0)
        self.ineligible: dict[str, int] = {}

    # ------------------------------------------------------- protocol

    def submit(self, w: _Waiter, key: tuple, window_s: float,
               max_size: int) -> None:
        """Enqueue ``w``; returns once ``w`` carries a payload or a
        serial verdict.  The first arrival for ``key`` leads the batch:
        it parks on the window (cut short when the queue fills), seals
        the queue and executes for everyone."""
        with self._mu:
            q = self._queues.get(key)
            if q is not None and not q.sealed and len(q.waiters) < max_size:
                q.waiters.append(w)
                if len(q.waiters) >= max_size:
                    q.full.set()
                leader = False
            else:
                q = _Queue()
                q.waiters.append(w)
                self._queues[key] = q
                leader = True
        if not leader:
            wtok = begin_wait("megabatch_wait")
            try:
                # generous bound: the leader always sets done (finally
                # below); the timeout only guards a leader thread dying
                # to an un-catchable exception
                ok = w.done.wait(window_s
                                 + w.settings.executor.lock_timeout_s + 30.0)
            finally:
                end_wait(wtok)
            if not ok:
                w.serial = True
            return
        wtok = begin_wait("megabatch_wait")
        try:
            if max_size > 1:
                q.full.wait(window_s)
        finally:
            end_wait(wtok)
        with self._mu:
            q.sealed = True
            if self._queues.get(key) is q:
                del self._queues[key]
            batch = list(q.waiters)
        try:
            self._dispatch(batch)
        finally:
            # never leave a caller parked: anything unserved and not
            # failed retries serially on its own thread
            for x in batch:
                if x.payload is None and x.error is None:
                    x.serial = True
                x.done.set()

    # ------------------------------------------------- adaptive window

    def resolve_window(self, key: tuple, window_ms: float) -> float:
        """Window (seconds) for this submission.  A fixed setting
        passes through; negative (SET citus.megabatch_window_ms =
        auto) sizes the window from the family's inter-arrival EWMA:
        wait ~4 expected gaps (bounded to 0.5-10 ms) while arrivals
        are bursty, and don't wait at all once the family goes sparse
        (expected gap above _AUTO_SPARSE_S) — a sparse family would
        pay the whole window's latency for an empty batch."""
        if window_ms >= 0:
            return window_ms / 1000.0
        now = clock()
        with self._mu:
            prev = self._arrivals.get(key)
            if prev is None:
                if len(self._arrivals) >= 4096:
                    self._arrivals.clear()
                self._arrivals[key] = (now, _AUTO_SPARSE_S)
                return 0.0
            t_last, ewma = prev
            ewma = 0.8 * ewma + 0.2 * (now - t_last)
            self._arrivals[key] = (now, ewma)
        if ewma > _AUTO_SPARSE_S:
            return 0.0
        return min(max(4.0 * ewma, 0.0005), 0.010)

    # ------------------------------------------------------- execution

    def _dispatch(self, batch: list[_Waiter]) -> None:
        # divergent bind-time pruning sub-batches by placement: only
        # queries scanning the SAME shard set share a device dispatch
        groups: dict[tuple, list[_Waiter]] = {}
        for w in batch:
            groups.setdefault(tuple(w.plan.shard_indexes), []).append(w)
        for group in groups.values():
            try:
                self._run_group(group)
            except _infrastructure_errors():
                # the whole group retries serially — the serial path
                # re-plans and attributes any real error to its own
                # caller
                _counters().bump("megabatch_fallbacks", len(group))
                with self._mu:
                    self.fallbacks += len(group)
                for w in group:
                    w.serial = True
            except Exception as e:
                # a batched kernel that does not build or launch is a
                # fault of this path: every rider sees it, none quietly
                # runs the serial kernels instead
                for w in group:
                    w.error = e
            except BaseException:
                for w in group:
                    w.serial = True
                raise

    def _run_group(self, group: list[_Waiter]) -> None:
        from citus_tpu_torch.transaction.snapshot import snapshot_read
        from citus_tpu_torch.workload import GLOBAL_SCHEDULER, tenant_key
        w0 = group[0]
        cat, settings, plan = w0.cat, w0.settings, w0.plan
        bound = plan.bound
        occ = len(group)
        if plan.table_shard_count not in (-1, len(bound.table.shards)):
            # shard map changed under the cached plan (split/rebalance
            # racing the window): serial path re-plans per query
            raise ShardMapChanged("megabatch: shard map changed")
        # the shared scan reads every chunk of the group's shards; each
        # query's own predicate (with its own params) re-applies on
        # device, so per-literal interval/index pruning can be dropped
        # without changing any result
        scan_plan = dataclasses.replace(plan, intervals=[], index_eq=None)
        # ONE admission slot per device dispatch, admitted under the
        # batch LEADER's tenant; coalesced followers (who may belong
        # to other tenants) are bookkept against their own tenants,
        # not admitted
        with GLOBAL_SCHEDULER.slot(settings, tenant_key(plan.router_key),
                                   timeout=settings.executor.lock_timeout_s):
            GLOBAL_SCHEDULER.note_coalesced(
                [tenant_key(x.plan.router_key) for x in group[1:]])

            def _attempt():
                if bound.has_aggs:
                    if plan.group_mode.kind == "hash_host":
                        return _batched_hash_agg(cat, scan_plan, settings,
                                                 group, w0.device)
                    return _batched_agg(cat, scan_plan, settings, group,
                                        w0.device)
                return _batched_projection(cat, scan_plan, settings, group,
                                           w0.device)
            payloads, n_dispatch = snapshot_read(
                cat.data_dir, bound.table, _attempt,
                timeout=settings.executor.lock_timeout_s)
        c = _counters()
        c.bump("megabatch_batches")
        c.bump("megabatch_queries", occ)
        with self._mu:
            self.batches += 1
            self.queries += occ
            self.dispatches += n_dispatch
            self.occupancy_hist[occ] = self.occupancy_hist.get(occ, 0) + 1
        for w, payload in zip(group, payloads):
            w.occupancy = occ
            w.dispatches = n_dispatch
            w.payload = payload

    # ------------------------------------------------------- stats

    def note_query_occupancy(self, occ: int) -> None:
        """Per-query attribution (called from cluster.execute once per
        user statement that rode a batch)."""
        with self._mu:
            self.query_occupancy_hist[occ] = \
                self.query_occupancy_hist.get(occ, 0) + 1

    def note_ineligible(self, reason: str) -> None:
        _counters().bump("megabatch_ineligible")
        with self._mu:
            self.ineligible[reason] = self.ineligible.get(reason, 0) + 1

    def stats(self) -> dict:
        with self._mu:
            return {
                "batches": self.batches,
                "queries": self.queries,
                "fallbacks": self.fallbacks,
                "dispatches": self.dispatches,
                "avg_occupancy": (self.queries / self.batches)
                if self.batches else 0.0,
                "occupancy_hist": dict(self.occupancy_hist),
                "query_occupancy_hist": dict(self.query_occupancy_hist),
                "ineligible": dict(self.ineligible),
            }


GLOBAL_MEGABATCH = MegabatchDispatcher()


# --------------------------------------------------- batched kernels


def _filter_program(plan, params, device):
    """The family's ``FilterProgram``: the serial projection path's, so
    one generated source (both kernels) serves both paths."""
    from citus_tpu_torch.executor.executor import _build_filter_mask
    from citus_tpu_torch.executor.kernel_cache import get_kernel
    return get_kernel(plan, f"filter:{device}",
                      lambda: _build_filter_mask(plan, params),
                      extra=(str(device),))


def _fold_program(plan, params, device, key_dtypes=None):
    """The family's ``FoldProgram`` (its fold, or with ``key_dtypes`` its
    hash insert): its keys and arguments reference no parameter, so one
    generated source serves every rider."""
    from citus_tpu_torch.executor.executor import _param_dtypes
    from citus_tpu_torch.executor.kernel_cache import get_kernel
    from citus_tpu_torch.ops.scan_agg_fold import FoldProgram
    slot = "batched_fold" if key_dtypes is None else "batched_hash"
    return get_kernel(
        plan, f"{slot}:{device}",
        lambda: FoldProgram.of_plan(plan, _param_dtypes(plan, params),
                                    key_dtypes),
        extra=(str(device),) + tuple(str(d) for d in key_dtypes or ()))


def _stacked_params(plan, group: list[_Waiter], prog):
    """Each rider's parameter values, stacked for the batched predicate
    (one [Q, P] copy to the device for the whole scan)."""
    from citus_tpu_torch.executor.executor import _params_env
    from citus_tpu_torch.ops.filter_mask import stack_params
    return stack_params(prog, [_params_env(plan, w.params) for w in group],
                        group[0].device)


def _batch_masks(plan, prog, stacked, cols, valids, row_mask):
    """-> bool [Q, N]: every rider's WHERE over one device batch (scan
    columns in ``plan.scan_columns`` order), one ``filter_mask_batched``
    launch over only the predicate's columns."""
    from citus_tpu_torch.ops.filter_mask import filter_mask_batched
    env = dict(zip(plan.scan_columns, zip(cols, valids)))
    return filter_mask_batched(prog, {c: env[c] for c in prog.columns},
                               stacked, row_mask)


def _empty_stacked_partials(plan, q: int, device):
    """[Q, G] registers seeded like ``_empty_partials`` (scalar mode:
    G = 1; a sketch's [Q, M]), and the [Q, G] group-row counts in direct
    mode."""
    import torch
    from citus_tpu_torch.executor.executor import _empty_partials
    seeds = _empty_partials(plan, np)
    direct = plan.group_mode.kind == "direct"
    n_ops = len(plan.partial_ops)
    regs = [torch.from_numpy(np.repeat(np.asarray(p).reshape(1, -1), q,
                                       axis=0)).to(device)
            for p in seeds[:n_ops]]
    rows = None
    if direct:
        rows = torch.from_numpy(np.zeros((q, seeds[n_ops].size),
                                         np.int64)).to(device)
    return regs, rows


def _batched_agg(cat, plan, settings, group: list[_Waiter], device):
    """Scan the group's shards ONCE; per batch one
    ``filter_mask_batched`` and one ``scan_agg_fold_batched`` launch
    for every rider, into [Q, G] registers that stay on the device.
    -> (one ("agg", [partial tuple]) payload per waiter, batches);
    combine + finalize happen on the callers' threads."""
    from citus_tpu_torch.executor.device_cache import plan_cache_key
    from citus_tpu_torch.executor.executor import (
        _block_ready, _stream_device_batches,
    )
    from citus_tpu_torch.executor.pipeline import PipelineStats
    from citus_tpu_torch.ops.scan_agg_fold import scan_agg_fold_batched
    import torch

    device = torch.device(device)
    q = len(group)
    prog = _filter_program(plan, group[0].params, device)
    stacked = _stacked_params(plan, group, prog)
    fold = _fold_program(plan, group[0].params, device)
    regs, rows = _empty_stacked_partials(plan, q, device)
    pstats = PipelineStats()
    _trace.set_phase("device")

    def _launch(db, hb):
        masks = _batch_masks(plan, prog, stacked, db.cols, db.valids,
                             db.row_mask)
        scan_agg_fold_batched(fold, regs, rows,
                              dict(zip(plan.scan_columns,
                                       zip(db.cols, db.valids))), masks)

    # the family-wide cache entry is shared across every literal
    # variant: charged to the shared tenant bucket, not one rider
    st = _stream_device_batches(
        cat, plan, settings, device, _launch, pstats,
        cache_key=plan_cache_key(plan, cat.data_dir) + (str(device),))
    # the followers read the results on their own threads
    t_dev = clock()
    _block_ready(device)
    host = [r.cpu().numpy() for r in regs]
    host_rows = None if rows is None else rows.cpu().numpy()
    pstats.device_s += clock() - t_dev
    if st.n_dispatch:
        _counters().bump("fused_dispatches", st.n_dispatch)
    st.publish(plan, pstats)
    payloads = []
    from citus_tpu_torch.ops.scan_agg_fold import SKETCH_M
    sketch = [op.kind in SKETCH_M for op in plan.partial_ops]
    for qi in range(q):
        if rows is None:
            # scalar mode: 0-d registers, a sketch's [M]
            parts = tuple(h[qi] if sk else np.asarray(h[qi, 0])
                          for h, sk in zip(host, sketch))
        else:
            parts = tuple(h[qi] for h in host) + (host_rows[qi],)
        payloads.append(("agg", [parts]))
    return payloads, st.n_dispatch


def _batched_hash_agg(cat, plan, settings, group: list[_Waiter], device):
    """Shared scan + ONE ``filter_mask_batched`` and ONE
    ``hash_agg_insert_batched`` launch per batch into [Q, S]-stacked
    tables that stay on the device.  Spill masks [Q, N] drain at each
    sync point into per-query HostGroupAccumulators, the spilled rows'
    keys and arguments evaluated again with numpy from the host batch;
    scatter hands every waiter its table slice + accumulator and the
    exact host merge + finalize run on the callers' threads.  A group
    whose stacked tables pass ``HASH_TABLES_BUDGET_BYTES`` runs in
    sub-batches, each with its own scan."""
    from citus_tpu_torch.executor.executor import (
        _hash_key_dtypes, _hash_slots, _params_env,
    )
    from citus_tpu_torch.ops.hash_agg import hash_slot_bytes
    S = _hash_slots(cat, plan, settings)
    key_dtypes = _hash_key_dtypes(plan, _params_env(plan, group[0].params))
    cap = max(1, HASH_TABLES_BUDGET_BYTES
              // (S * hash_slot_bytes(plan, key_dtypes)))
    payloads, n_dispatch = [], 0
    for lo in range(0, len(group), cap):
        p, n = _batched_hash_chunk(cat, plan, settings, group[lo:lo + cap],
                                   device, S, key_dtypes)
        payloads += p
        n_dispatch += n
    return payloads, n_dispatch


def _batched_hash_chunk(cat, plan, settings, group: list[_Waiter], device,
                        S: int, key_dtypes: tuple):
    import torch
    from citus_tpu_torch.executor.executor import (
        _SpillDrain, _stream_device_batches,
    )
    from citus_tpu_torch.executor.host_agg import HostGroupAccumulator
    from citus_tpu_torch.executor.pipeline import PipelineStats
    from citus_tpu_torch.ops.hash_agg import empty_hash_state
    from citus_tpu_torch.ops.hash_agg_insert import hash_agg_insert_batched

    device = torch.device(device)
    q = len(group)
    prog = _filter_program(plan, group[0].params, device)
    stacked = _stacked_params(plan, group, prog)
    insert = _fold_program(plan, group[0].params, device, key_dtypes)
    # keys and arguments reference no parameter: one numpy evaluation of
    # a spilled batch serves every rider
    accs = [HostGroupAccumulator(len(plan.bound.group_keys),
                                 plan.partial_ops) for _ in group]
    drain = _SpillDrain(plan, accs, {})
    table = empty_hash_state(plan, S, key_dtypes, device, n_queries=q)
    pstats = PipelineStats()
    _trace.set_phase("device")

    def _launch(db, hb):
        masks = _batch_masks(plan, prog, stacked, db.cols, db.valids,
                             db.row_mask)
        drain.add(hb, hash_agg_insert_batched(
            insert, table, dict(zip(plan.scan_columns,
                                    zip(db.cols, db.valids))), masks))

    st = _stream_device_batches(cat, plan, settings, device, _launch, pstats,
                                on_sync=drain)
    # the followers read the results on their own threads: the copy to
    # the host waits for the device
    t_dev = clock()
    key_tables, partials, rows = table.to_host()
    pstats.device_s += clock() - t_dev
    if st.n_dispatch:
        _counters().bump("hash_fused_dispatches", st.n_dispatch)
    st.publish(plan, pstats)
    pl = plan.runtime_cache["pipeline"]
    pl["hash_slots"] = S
    pl["hash_spilled_rows"] = drain.rows
    pl["hash_spill_merge_ms"] = round(drain.seconds * 1e3, 3)
    return [("hash_agg",
             (([(v[qi], f[qi]) for v, f in key_tables],
               tuple(p[qi] for p in partials), rows[qi]), accs[qi]))
            for qi in range(q)], st.n_dispatch


def _batched_projection(cat, plan, settings, group: list[_Waiter], device):
    """Shared scan + ONE ``filter_mask_batched`` launch per batch over
    only the predicate's columns -> per-query (env, mask) batches.  Row
    extraction (project_rows) happens per query on the callers'
    threads."""
    import torch
    from citus_tpu_torch.executor.executor import _host_batches, _params_env
    from citus_tpu_torch.testing.faults import FAULTS

    device = torch.device(device)
    q = len(group)
    penvs = [_params_env(plan, w.params) for w in group]
    prog = _filter_program(plan, group[0].params, device)
    stacked = _stacked_params(plan, group, prog)
    _trace.set_phase("device")
    per_query: list[list] = [[] for _ in group]
    n_dispatch = 0
    for cols, valids, n in _host_batches(cat, plan):
        FAULTS.hit("device_round", plan.bound.table.name)
        dcols = [tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                       for a in (c, v)) if name in prog.columns else (c, v)
                 for name, c, v in zip(plan.scan_columns, cols, valids)]
        row_mask = torch.ones(n, dtype=torch.bool, device=device)
        qmasks = _batch_masks(plan, prog, stacked, [c for c, _ in dcols],
                              [v for _, v in dcols], row_mask).cpu().numpy()
        n_dispatch += 1
        base = dict(zip(plan.scan_columns, zip(cols, valids)))
        for qi in range(q):
            env = dict(base)
            env.update(penvs[qi])
            per_query[qi].append((env, qmasks[qi]))
    return [("proj", batches) for batches in per_query], n_dispatch


# --------------------------------------------------- caller-side entry


def _references_param(exprs) -> bool:
    from citus_tpu_torch.planner.bound import BParam, walk
    return any(isinstance(n, BParam) for e in exprs if e is not None
               for n in walk(e))


def _ineligible(reason: str) -> bool:
    GLOBAL_MEGABATCH.note_ineligible(reason)
    return False


def megabatch_eligible(cat, bound, settings, plan, params, device) -> bool:
    """A query may coalesce when the batched runners can reproduce the
    serial result exactly: parameterized single-table plan, scalar /
    direct-gid / hash_host aggregation or projection, no open
    transaction overlay (staged writes are per-session state the shared
    scan must not see), no shard that only another coordinator hosts,
    and a WHERE the predicate generator takes.  Each
    refusal is counted by reason (``megabatch_ineligible``).  Keys or
    aggregate arguments that reference a parameter raise: the batched
    kernels share them across riders, and such a query must not slip
    onto the serial path unnoticed."""
    ex = settings.executor
    if ex.megabatch_window_ms == 0:
        return False
    if ex.task_executor_backend == "cpu":
        return _ineligible("cpu_backend")
    if not bound.param_specs or not plan.shard_indexes:
        return _ineligible("no_parameters_or_shards")
    if bound.has_aggs:
        from citus_tpu_torch.executor.executor import _hash_has_exact
        if plan.group_mode.kind == "hash_host":
            # exact value sets / sketches accumulate on the host per
            # query and gain nothing from a shared dispatch
            if _hash_has_exact(plan):
                return _ineligible("host_partials")
        elif plan.group_mode.kind not in ("scalar", "direct"):
            return _ineligible("group_mode")
        if _references_param(list(bound.group_keys) + list(plan.agg_args)):
            raise UnsupportedFeatureError(
                "megabatching a query whose group keys or aggregate "
                "arguments reference a parameter is not ported yet "
                "(ROADMAP.md B5)")
    from citus_tpu_torch.storage.overlay import current_overlay
    if current_overlay() is not None:
        return _ineligible("transaction_overlay")
    from citus_tpu_torch.executor.worker_tasks import split_pushable
    _local, remote = split_pushable(cat, plan, settings)
    if remote:
        # shards hosted by another coordinator run there as pushed
        # tasks: the serial path owns that fan-out
        return _ineligible("remote_shards")
    if bound.filter is None:
        # parameters come from hoisted WHERE literals; without a WHERE
        # there is nothing per query to batch
        return _ineligible("no_filter")
    try:
        _filter_program(plan, params, device).predicate
    except UnsupportedFeatureError:
        return _ineligible("predicate_codegen")
    return True


def _finalize_agg(cat, plan, batch_partials, params) -> list[tuple]:
    """Per-query combine + finalize — the exact tail of the serial
    _run_agg, run on the caller's own thread."""
    from citus_tpu_torch.executor.executor import (
        _decode_direct_keys, _params_env,
    )
    from citus_tpu_torch.executor.finalize import finalize_groups
    from citus_tpu_torch.ops.scan_agg import combine_partials_host
    penv = _params_env(plan, params)
    partials = combine_partials_host(plan, batch_partials)
    if plan.group_mode.kind == "scalar":
        partials = tuple(
            np.asarray(p).reshape(1) if np.asarray(p).ndim == 0
            else np.asarray(p)[None, ...] for p in partials)
        return finalize_groups(plan, cat, [], partials, params_env=penv)
    *parts, grows = partials
    keys, occupied = _decode_direct_keys(plan, grows)
    if occupied.size == 0:
        return []
    sel = tuple(np.asarray(p)[occupied] for p in parts)
    return finalize_groups(plan, cat, keys, sel, params_env=penv)


def _finalize_hash_agg(cat, plan, data, params) -> list[tuple]:
    """Per-query exact merge + finalize of a hash_host rider's table
    slice — the exact tail of the serial _run_agg_hash_host, run on the
    caller's own thread."""
    from citus_tpu_torch.executor.executor import _params_env
    from citus_tpu_torch.executor.finalize import finalize_groups
    from citus_tpu_torch.ops.hash_agg import merge_hash_tables_into
    state, acc = data
    key_tables, partials, rows = state
    penv = _params_env(plan, params)
    merge_hash_tables_into(acc, plan, key_tables, partials, rows)
    key_arrays, parts = acc.finalize(
        [k.type for k in plan.bound.group_keys],
        scalar=not plan.bound.group_keys)
    if parts is None:
        return []
    return finalize_groups(plan, cat, key_arrays, parts, params_env=penv)


def _rider_error(e: BaseException) -> BaseException:
    """A rider's own copy of the dispatch's failure (one exception
    object is never raised on several threads), chained to it."""
    try:
        err = copy.copy(e)
    except Exception:  # noqa: BLE001 - an exception copy cannot rebuild
        err = ExecutionError(f"megabatch dispatch failed: {e!r}")
    err.__cause__ = e
    return err


def maybe_megabatch(cat, bound, settings, plan, params, t0, exec_span,
                    device):
    """Coalescing gate called from execute_select after bind-time
    pruning.  Returns a Result when this query rode a batch, or None —
    caller continues on the (unchanged) serial path."""
    if not megabatch_eligible(cat, bound, settings, plan, params, device):
        return None
    from citus_tpu_torch.executor.executor import (
        GLOBAL_COUNTERS, _finish_select,
    )
    from citus_tpu_torch.executor.finalize import project_rows
    from citus_tpu_torch.executor.kernel_cache import plan_fingerprint
    from citus_tpu_torch.testing.faults import FAULTS
    ex = settings.executor
    w = _Waiter(cat, bound, settings, plan, params, device)
    key = (cat.data_dir, bound.table.name, plan_fingerprint(plan),
           str(device))
    window_s = GLOBAL_MEGABATCH.resolve_window(key, ex.megabatch_window_ms)
    if window_s <= 0.0 and ex.megabatch_window_ms < 0:
        # auto judged this family sparse: run serial, pay no window
        return None
    GLOBAL_MEGABATCH.submit(w, key, window_s,
                            max(1, ex.megabatch_max_size))
    if w.error is not None:
        raise _rider_error(w.error)
    if w.serial or w.payload is None:
        return None
    # ---- per-query scatter, on this caller's own thread ----
    GLOBAL_COUNTERS.bump("queries_executed")
    if plan.is_router:
        GLOBAL_COUNTERS.bump("router_queries")
    elif len(plan.shard_indexes) > 1:
        GLOBAL_COUNTERS.bump("multi_shard_queries")
    # deterministic per-query failure injection for the isolation tests
    FAULTS.hit("megabatch_finalize",
               f"{bound.table.name}:{plan.router_key}")
    kind, data = w.payload
    if kind == "agg":
        rows = _finalize_agg(cat, plan, data, params)
    elif kind == "hash_agg":
        rows = _finalize_hash_agg(cat, plan, data, params)
    else:
        rows = project_rows(plan, cat, data)
    wait_ms = (clock() - w.t_enq) * 1000.0
    info = {"occupancy": w.occupancy,
            "window_ms": round(window_s * 1000.0, 3),
            "wait_ms": round(wait_ms, 3),
            "dispatches": w.dispatches}
    ctx = _trace.current()
    if ctx is not None:
        tr, parent = ctx
        tr.add_closed("megabatch", parent.span_id, w.t_enq, clock(),
                      dict(info))
    return _finish_select(bound, plan, rows, t0, exec_span, megabatch=info)
