"""Executor orchestration.

Maps a PhysicalPlan onto the available backend:

- ``cpu``: numpy worker per shard — the bit-exact oracle path (and the
  moral equivalent of the reference's local_executor.c in-process path)
- ``gpu``: the single-device streaming scan on the Cluster's torch
  device: host decode on a prefetch thread, pinned host-to-device
  copies, and one ``scan_agg_fold`` per batch into accumulators that
  stay on the device until the final copy back

Partial states from multiple rounds merge on the host, exactly like the
reference merges per-task tuples on the coordinator.  The multi-device
mesh path of the reference (shard_map + psum) is not ported: it needs
more than one device (ROADMAP.md queue B, B6).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from citus_tpu_torch import types as T
from citus_tpu_torch.catalog import Catalog
from citus_tpu_torch.config import Settings
from citus_tpu_torch.errors import ExecutionError, UnsupportedFeatureError
from citus_tpu_torch.executor.batches import (
    ShardBatch, bucket_rows, load_shard_batches, pad_to_batch,
)
from citus_tpu_torch.executor.finalize import finalize_groups, order_and_limit
from citus_tpu_torch.executor.kernel_cache import get_kernel
from citus_tpu_torch.observability import trace as _trace
from citus_tpu_torch.observability.trace import clock
from citus_tpu_torch.ops.scan_agg import (
    build_fused_worker_fn, build_worker_fn, combine_partials_host,
    empty_device_partials,
)
from citus_tpu_torch.planner.auto_param import PHYSICAL_SRC, substitute_params
from citus_tpu_torch.planner.bind import BoundSelect
from citus_tpu_torch.planner.physical import (
    PhysicalPlan, _index_eq, extract_intervals, plan_select, prune_shards,
)
from citus_tpu_torch.stats import StatCounters, begin_wait, end_wait

# process-wide counters (the citus_stat_counters analog); Cluster exposes
# a view over this
GLOBAL_COUNTERS = StatCounters()


def _block_ready(device) -> None:
    """Wait for the device's queued work under a device_round wait
    bracket: the stretch the backend spends blocked on device
    backpressure shows up in the activity view and the
    wait_device_round_ms counter."""
    if device.type != "cuda":
        return
    import torch
    wtok = begin_wait("device_round")
    try:
        torch.cuda.current_stream(device).synchronize()
    finally:
        end_wait(wtok)


@dataclass
class Result:
    columns: list[str]
    rows: list[tuple]
    explain: dict = field(default_factory=dict)
    # per-visible-column ColumnType where the planner knows them
    types: Optional[list] = None

    @property
    def rowcount(self) -> int:
        return len(self.rows)

    def __iter__(self):
        return iter(self.rows)


# ------------------------------------------------------------ agg paths


def encode_params(cat: Catalog, bound, values: Optional[list]):
    """$N python values -> (tuple of 0-d value arrays, tuple of 0-d
    valid arrays) per bound.param_specs.  Text parameters resolve
    through the column's dictionary; unseen strings map to -1 (match
    nothing, like a nonexistent id)."""
    if not bound.param_specs:
        return (), ()
    if values is None or len(values) < len(bound.param_specs):
        raise ExecutionError(
            f"query requires {len(bound.param_specs)} parameters")
    pcols, pvalids = [], []
    for (ptype, src), v in zip(bound.param_specs, values):
        is_uuid = ptype.kind == T.UUID
        if v is None:
            # a uuid parameter occupies two env slots (hi + lo lanes)
            for _ in range(2 if is_uuid else 1):
                pcols.append(np.zeros((), np.int64 if is_uuid
                                      else ptype.device_dtype))
                pvalids.append(np.zeros((), bool))
            continue
        if src == PHYSICAL_SRC:
            # auto-parameterized literal: value is already bound-level
            # physical (dates, scaled decimals, dictionary ids)
            pcols.append(np.asarray(v, ptype.device_dtype))
            pvalids.append(np.ones((), bool))
            continue
        if ptype.is_text:
            pid = cat.lookup_string_id(src[0], src[1], str(v))
            phys = -1 if pid is None else pid
        elif is_uuid:
            hi, lo = T.uuid_int_to_lanes(ptype.to_physical(v))
            for lane in (hi, lo):
                pcols.append(np.asarray(lane, np.int64))
                pvalids.append(np.ones((), bool))
            continue
        else:
            phys = ptype.to_physical(v)
        pcols.append(np.asarray(phys, ptype.device_dtype))
        pvalids.append(np.ones((), bool))
    return tuple(pcols), tuple(pvalids)


def _run_partials_cpu(cat: Catalog, plan: PhysicalPlan, settings: Settings,
                      params=((), ()), device=None):
    worker = build_worker_fn(plan, np)
    pcols, pvalids = params
    shard_results = []
    for si in plan.shard_indexes:
        for values, masks, n in load_shard_batches(
                cat, plan, si, min_batch_rows=1):
            cols = tuple(values[c].astype(
                plan.bound.table.schema.scan_dtype(c, device=True),
                copy=False) for c in plan.scan_columns)
            valids = tuple(masks[c] for c in plan.scan_columns)
            shard_results.append(worker(cols + pcols, valids + pvalids,
                                        np.ones(n, bool)))
    if not shard_results:
        shard_results.append(_empty_partials(plan, np))
    return combine_partials_host(plan, shard_results)


def _empty_partials(plan: PhysicalPlan, xp):
    """Zero-row partial states (so empty tables still produce a row for
    global aggregates)."""
    from citus_tpu_torch.ops.scan_agg import _sentinel
    G = plan.group_mode.n_groups if plan.group_mode.kind == "direct" else None
    outs = []
    for op in plan.partial_ops:
        dt = np.dtype(op.dtype)
        if op.kind == "hll":
            from citus_tpu_torch.planner.aggregates import HLL_M
            outs.append(np.zeros((HLL_M,), np.int32))
        elif op.kind == "ddsk":
            from citus_tpu_torch.planner.aggregates import DDSK_M
            outs.append(np.zeros((DDSK_M,), np.int64))
        elif op.kind == "topk":
            from citus_tpu_torch.planner.aggregates import TOPK_M
            outs.append(np.zeros((TOPK_M,), np.int64))
        elif op.kind == "topkv":
            from citus_tpu_torch.planner.aggregates import TOPK_M
            outs.append(np.full((TOPK_M,), np.iinfo(np.int64).min, np.int64))
        elif op.kind in ("sum", "count"):
            base = np.int64(0) if op.kind == "count" else dt.type(0)
            outs.append(np.zeros((G,), dt) if G else np.asarray(base, dt))
        else:
            sent = dt.type(_sentinel(op.kind, dt))
            outs.append(np.full((G,), sent, dt) if G else np.asarray(sent, dt))
    if G:
        outs.append(np.zeros((G,), np.int64))
    return tuple(outs)


def _prefetch_depth(settings: Settings) -> int:
    """Device-side in-flight window: streaming mode keeps at most this
    many batches un-synced ahead of the kernel consuming them.
    Governed by SET citus.executor_prefetch_depth (floor of 1 so the
    depth-0 'decode inline' setting still double-buffers the device);
    max_tasks_in_flight raises the window further."""
    return max(1, settings.executor.executor_prefetch_depth,
               settings.executor.max_tasks_in_flight)


def _iter_padded_batches(cat: Catalog, plan: PhysicalPlan, settings: Settings):
    """Lazily yield host ShardBatches, each padded to its own
    power-of-two bucket.  Nothing is materialized up front — the
    streaming scan path's host half (reference analog:
    ColumnarReadNextRow never materializes a stripe,
    columnar_reader.c:323)."""
    from citus_tpu_torch.testing.faults import FAULTS
    for si in plan.shard_indexes:
        FAULTS.hit("dispatch_task", f"{plan.bound.table.name}:{si}")
        GLOBAL_COUNTERS.bump("tasks_dispatched")
        for values, masks, n in load_shard_batches(
                cat, plan, si,
                min_batch_rows=settings.executor.min_batch_rows,
                prefer_secondary=settings.executor.use_secondary_nodes):
            bucket = bucket_rows(n, settings.executor.min_batch_rows)
            yield pad_to_batch(plan.bound.table, plan, values, masks, n,
                               bucket, si)


class _Staging:
    """Host -> device copies of padded batches.

    On a CUDA device every array goes through a page-locked staging
    buffer and an asynchronous (``non_blocking``) copy on the current
    stream.  A staging buffer is reused only after the event recorded
    behind its copy has completed, so no buffer is rewritten or freed
    while the card still reads it.  On the CPU the arrays are wrapped
    without a copy."""

    def __init__(self, device, slots: int):
        self.device = device
        self._slots = max(2, slots)
        # each slot: (event or None, {(dtype, n, i): pinned tensor})
        self._ring: list = []

    def to_device(self, hb: ShardBatch) -> ShardBatch:
        import torch
        from citus_tpu_torch.ops.xp_torch import torch_dtype
        arrays = list(hb.cols) + list(hb.valids) + [hb.row_mask]
        if self.device.type != "cuda":
            out = [torch.from_numpy(a if a.flags.writeable else a.copy())
                   for a in arrays]
        else:
            event, bufs = self._take_slot()
            out = []
            for i, a in enumerate(arrays):
                key = (a.dtype.str, a.shape[0], i)
                buf = bufs.get(key)
                if buf is None:
                    buf = torch.empty(a.shape[0], dtype=torch_dtype(a.dtype),
                                      pin_memory=True)
                    bufs[key] = buf
                buf.numpy()[:] = a
                out.append(buf.to(self.device, non_blocking=True))
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
            self._ring.append((event, bufs))
        k = len(hb.cols)
        return ShardBatch(tuple(out[:k]), tuple(out[k:2 * k]), out[-1],
                          hb.n_rows, hb.padded_rows, hb.shard_index)

    def _take_slot(self):
        if len(self._ring) < self._slots:
            return None, {}
        event, bufs = self._ring.pop(0)
        event.synchronize()  # the copy out of these buffers is done
        return event, bufs


def _device_params(xp, pcols, pvalids):
    """0-d parameter arrays -> strongly typed [1] device constants."""
    return (tuple(xp.asarray(p) for p in pcols),
            tuple(xp.asarray(v) for v in pvalids))


def _run_partials_device(cat: Catalog, plan: PhysicalPlan, settings: Settings,
                         params=((), ()), device=None):
    import torch
    from citus_tpu_torch.executor.device_cache import (
        GLOBAL_CACHE, plan_cache_key,
    )
    from citus_tpu_torch.executor.pipeline import (
        PipelineStats, prefetch_batches, read_ahead_depth,
    )
    from citus_tpu_torch.ops.xp_torch import TorchNamespace
    from citus_tpu_torch.testing.faults import FAULTS

    if device is None:
        raise ExecutionError("the gpu backend needs the Cluster's device")
    device = torch.device(device)
    xp = TorchNamespace(device)
    pstats = PipelineStats()
    _trace.set_phase("device")
    key = plan_cache_key(plan, cat.data_dir) + (str(device),)
    cached = GLOBAL_CACHE.get(key)
    # one fold per batch into device-resident registers, updated in
    # place (the port's donate_argnums): one scan_agg_fold launch per
    # batch, no merge dispatch, no host round-trip until the end
    fused = get_kernel(plan, f"fused:{device}",
                       lambda: build_fused_worker_fn(plan, xp),
                       extra=(str(device),))
    pcols, pvalids = _device_params(xp, *params)
    acc = empty_device_partials(plan, device)
    task_times: list = []
    task_bytes: list = []
    n_dispatch = 0
    window_peak = 0
    if cached is not None:
        for b in cached:
            t0 = clock()
            fused(acc, b.cols + pcols, b.valids + pvalids, b.row_mask)
            n_dispatch += 1
            task_times.append((b.shard_index, b.n_rows, clock() - t0))
    else:
        # stream: the decode thread prepares batch i+1 on the host while
        # batch i copies and folds; pinned staging keeps the copies
        # asynchronous.  Device batches are kept for the cache only if
        # the whole working set fits it — past capacity, throughput
        # degrades to the pipeline rate instead of collapsing
        collect: Optional[list] = []
        nbytes = 0
        depth = _prefetch_depth(settings)
        window_bytes = 0       # un-synced streamed bytes on device
        since_sync = 0
        staging = _Staging(device, depth + 1)
        host_iter = prefetch_batches(
            _iter_padded_batches(cat, plan, settings),
            read_ahead_depth(settings), pstats)
        try:
            for hb in host_iter:
                t_dev = clock()
                FAULTS.hit("device_round", plan.bound.table.name)
                db = staging.to_device(hb)
                t0 = clock()
                fused(acc, db.cols + pcols, db.valids + pvalids,
                      db.row_mask)
                n_dispatch += 1
                task_times.append((db.shard_index, db.n_rows,
                                   clock() - t0))
                bb = (sum(c.nbytes for c in hb.cols)
                      + sum(v.nbytes for v in hb.valids)
                      + hb.row_mask.nbytes)
                nbytes += bb
                task_bytes.append((db.shard_index, bb))
                if collect is not None:
                    collect.append(db)
                    if nbytes > GLOBAL_CACHE.capacity:
                        collect = None  # working set exceeds the cache
                if collect is None:
                    # bound in-flight device memory: the registers order
                    # every fold, so waiting for the stream retires all
                    # admitted batches — at most `depth` are un-synced
                    window_bytes += bb
                    window_peak = max(window_peak, window_bytes)
                    since_sync += 1
                    if since_sync >= depth:
                        _block_ready(device)
                        since_sync = 0
                        window_bytes = 0
                pstats.device_s += clock() - t_dev
                ctx = _trace.current()
                if ctx is not None:
                    tr, parent = ctx
                    tr.add_closed(
                        "device_round", parent.span_id, t_dev, clock(),
                        {"shard_index": int(hb.shard_index),
                         "rows": int(hb.n_rows)})
        finally:
            host_iter.close()
        if n_dispatch == 0:
            return combine_partials_host(plan, [_empty_partials(plan, np)])
        if collect is not None:
            GLOBAL_CACHE.put(key, collect, nbytes)
        pstats.h2d_bytes = nbytes
        GLOBAL_COUNTERS.bump("bytes_scanned", nbytes)
        GLOBAL_COUNTERS.bump("device_hbm_touched_bytes", nbytes)
    t_dev = clock()
    partials = tuple(a.cpu().numpy() for a in acc)
    pstats.device_s += clock() - t_dev
    if cached is None:
        pstats.publish(plan)
    GLOBAL_COUNTERS.bump("fused_dispatches", n_dispatch)
    pl = plan.runtime_cache.setdefault("pipeline", {})
    pl["fused_dispatches"] = n_dispatch
    pl["stream_window_peak_bytes"] = window_peak
    plan.runtime_cache["task_times"] = task_times
    plan.runtime_cache["task_bytes"] = task_bytes
    return partials


def _decode_direct_keys(plan: PhysicalPlan, rows: np.ndarray):
    """Occupied gids -> per-key (values, valid) arrays + occupancy index."""
    occupied = np.nonzero(rows > 0)[0]
    keys = []
    for d, stride in zip(plan.group_mode.domains, plan.group_mode.strides):
        codes = (occupied // stride) % d.size
        valid = codes > 0
        vals = np.where(valid, d.lo + (codes - 1) * d.step, 0)
        keys.append((vals.astype(np.int64), valid))
    return keys, occupied


def _run_agg(cat: Catalog, plan: PhysicalPlan, settings: Settings,
             params=((), ()), device=None) -> list[tuple]:
    backend = settings.executor.task_executor_backend
    mode = plan.group_mode.kind
    penv = _params_env(plan, params)
    if mode not in ("scalar", "direct"):
        raise UnsupportedFeatureError(
            "GROUP BY without a small proven key domain (hash mode) is not "
            "ported yet (ROADMAP.md A7)")
    if backend not in ("cpu", "gpu"):
        raise ExecutionError(
            f"unknown task_executor_backend {backend!r} (cpu | gpu)")
    from citus_tpu_torch.executor.pipeline import dispatch_remote_tasks
    run = _run_partials_cpu if backend == "cpu" else _run_partials_device
    local, _dispatch = dispatch_remote_tasks(cat, plan, settings, params)
    partials = run(cat, plan, settings, params, device)
    if mode == "scalar":
        # one group: scalars become length-1 arrays; vector partials
        # (HLL registers) gain a leading group axis
        partials = tuple(
            np.asarray(p).reshape(1) if np.asarray(p).ndim == 0
            else np.asarray(p)[None, ...] for p in partials)
        return finalize_groups(plan, cat, [], partials, params_env=penv)
    *parts, rows = partials
    keys, occupied = _decode_direct_keys(plan, rows)
    if occupied.size == 0:
        return []
    sel_parts = tuple(np.asarray(p)[occupied] for p in parts)
    return finalize_groups(plan, cat, keys, sel_parts, params_env=penv)


def _params_env(plan, params) -> dict:
    from citus_tpu_torch.planner.bound import param_env_names
    pcols, pvalids = params
    return dict(zip(param_env_names(plan.bound.param_specs),
                    zip(pcols, pvalids)))


# ---------------------------------------------------------------- entry


def _bind_time_prune(plan: PhysicalPlan, params) -> PhysicalPlan:
    """Custom-plan pruning for one execution of a generic plan: the
    bind-time physical param values are substituted back into the filter
    and the shard set, chunk intervals, tenant router key and index
    fast-path are re-derived — a cached generic plan prunes exactly like
    a freshly-planned literal query (reference: deferred pruning on
    Job->deferredPruning).  The shared runtime_cache dict rides along,
    so built workers are reused across parameter values."""
    bound = plan.bound
    pcols, pvalids = params
    phys = [pcols[i].item() if bool(pvalids[i]) else None
            for i in range(len(pcols))]
    sub = substitute_params(bound.filter, phys)
    shard_indexes, router_key = prune_shards(bound.table, sub, return_key=True)
    if plan.router_param is not None and phys[plan.router_param] is None:
        shard_indexes = []  # dist = NULL matches nothing
    import dataclasses
    return dataclasses.replace(
        plan, shard_indexes=shard_indexes, router_key=router_key,
        intervals=extract_intervals(sub),
        index_eq=_index_eq(bound.table, sub))


def execute_select(cat: Catalog, bound: BoundSelect, settings: Settings,
                   plan: Optional[PhysicalPlan] = None,
                   param_values: Optional[list] = None,
                   device=None) -> Result:
    """Run one bound SELECT with aggregates.  ``device`` is the torch
    device of the ``gpu`` backend (the Cluster's)."""
    t0 = clock()
    if not bound.has_aggs:
        raise UnsupportedFeatureError(
            "SELECT without aggregates (projection) is not ported yet "
            "(ROADMAP.md A7-A8, queue B B4)")
    if settings.executor.megabatch_window_ms != 0:
        raise UnsupportedFeatureError(
            "citus.megabatch_window_ms is not ported yet (ROADMAP.md B5)")
    if plan is None:
        plan = plan_select(cat, bound, direct_limit=settings.planner.direct_gid_limit)
    params = encode_params(cat, bound, param_values)
    with _trace.span("execute") as exec_span:
        if bound.param_specs:
            # deferred pruning: re-derive the shard/interval view of the
            # cached generic plan for THESE parameter values
            with _trace.span("prune"):
                plan = _bind_time_prune(plan, params)
        GLOBAL_COUNTERS.bump("queries_executed")
        if plan.is_router:
            GLOBAL_COUNTERS.bump("router_queries")
        elif len(plan.shard_indexes) > 1:
            GLOBAL_COUNTERS.bump("multi_shard_queries")
        # snapshot read: never blocks behind writers — the scan is
        # validated against the table's flip generation and retried if
        # a multi-file metadata flip overlapped (transaction/snapshot.py)
        from citus_tpu_torch.transaction.snapshot import snapshot_read
        run_plan = plan

        def _attempt():
            nonlocal run_plan
            if run_plan.table_shard_count not in (-1,
                                                  len(bound.table.shards)):
                # the table's shard map changed since this plan was
                # built: re-plan before (re)trying
                run_plan = plan_select(
                    cat, bound,
                    direct_limit=settings.planner.direct_gid_limit)
                if bound.param_specs:
                    run_plan = _bind_time_prune(run_plan, params)
            return _run_agg(cat, run_plan, settings, params, device)
        rows = snapshot_read(cat.data_dir, bound.table, _attempt,
                             timeout=settings.executor.lock_timeout_s)
        return _finish_select(bound, run_plan, rows, t0, exec_span)


def _finish_select(bound: BoundSelect, plan: PhysicalPlan, rows: list[tuple],
                   t0: float, exec_span) -> Result:
    """ORDER/LIMIT + hidden-output trim, result-shape counters, span
    attrs and the explain dict."""
    _trace.set_phase("finalize")
    with _trace.span("finalize"):
        rows = order_and_limit(plan, rows)
        if bound.hidden_outputs:
            keep = len(bound.output_names) - bound.hidden_outputs
            rows = [r[:keep] for r in rows]
    GLOBAL_COUNTERS.bump("rows_returned", len(rows))
    elapsed = clock() - t0
    if exec_span.recording:
        exec_span.set(strategy=plan.group_mode.kind,
                      shards=len(plan.shard_indexes),
                      router=bool(plan.is_router), rows=len(rows))
        pipe = plan.runtime_cache.get("pipeline") or {}
        if pipe:
            exec_span.attrs["pipeline"] = dict(pipe)
    visible = list(bound.output_names)
    if bound.hidden_outputs:
        visible = visible[:len(visible) - bound.hidden_outputs]
    task_times = plan.runtime_cache.pop("task_times", [])
    plan.runtime_cache.pop("task_bytes", None)
    explain = {
        "strategy": plan.group_mode.kind,
        "shards": len(plan.shard_indexes),
        "router": plan.is_router,
        "intervals": [c.column for c in plan.intervals],
        "elapsed_s": elapsed,
        "tasks": task_times,
        "remote_tasks": [],
        "pipeline": plan.runtime_cache.get("pipeline", {}),
        "router_key": plan.router_key,
    }
    return Result(
        columns=visible,
        rows=rows,
        types=[e.type for e in bound.final_exprs][:len(visible)],
        explain=explain,
    )
