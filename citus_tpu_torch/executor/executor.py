"""Executor orchestration.

Maps a PhysicalPlan onto the available backend:

- ``cpu``: numpy worker per shard — the bit-exact oracle path (and the
  moral equivalent of the reference's local_executor.c in-process path)
- ``gpu``: the single-device streaming scan on the Cluster's torch
  device: host decode on a prefetch thread, pinned host-to-device
  copies, and one ``scan_agg_fold`` per batch into accumulators that
  stay on the device until the final copy back; GROUP BY without a
  small key domain streams into one device hash table instead (one
  ``hash_agg_insert`` per batch, spills merged exactly on the host),
  and a projection's WHERE runs as one generated ``filter_mask``
  kernel per batch; with ``citus.megabatch_window_ms`` != 0, literal
  variants of one query arriving together share one scan and one launch
  of each batched kernel per batch (executor/megabatch.py)

Partial states from multiple rounds merge on the host, exactly like the
reference merges per-task tuples on the coordinator.  Shards hosted only
by another coordinator run there: the worker half of the plan ships as
an ``execute_task`` RPC (executor/worker_tasks.py, executor/pipeline.py)
while the local shards scan here, and the returned partial states,
hash tables (re-inserted through one ``hash_agg_merge`` each) or
filtered rows join the local ones; a task that fails falls back to
pulling the placement's files.

With a mesh of more than one member (the Cluster's ``mesh_devices``), a
scalar or direct aggregate over two batches or more takes the mesh
branch, as the reference's shard_map + psum path does: batches go in
rounds of one per member, each member folds its batch into its own
registers on its own device (one ``scan_agg_fold`` per member per
round), and ``mesh_combine`` (B6) combines the members' registers.
Unlike the reference, which combines every round in the mesh and then
the rounds on the host, a member keeps its registers across rounds and
the combine runs once per query: the rows are the same, integers
exactly, float sums up to summation order.  Hash GROUP BY, projections
and megabatches stay on the single stream, as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from citus_tpu_torch import types as T
from citus_tpu_torch.catalog import Catalog
from citus_tpu_torch.config import Settings
from citus_tpu_torch.errors import ExecutionError
from citus_tpu_torch.executor.batches import (
    ShardBatch, bucket_rows, empty_batch, load_shard_batches, pad_to_batch,
)
from citus_tpu_torch.executor.finalize import finalize_groups, order_and_limit
from citus_tpu_torch.executor.kernel_cache import get_kernel
from citus_tpu_torch.observability import trace as _trace
from citus_tpu_torch.observability.trace import clock
from citus_tpu_torch.ops.scan_agg import (
    build_fused_worker_fn, build_worker_fn, combine_kinds,
    combine_partials_host, empty_device_partials,
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


def _host_batches(cat: Catalog, plan: PhysicalPlan):
    """Every shard's unpadded batches on the host: (scan columns cast to
    their device dtypes, validity masks, rows), in plan.scan_columns
    order."""
    schema = plan.bound.table.schema
    for si in plan.shard_indexes:
        for values, masks, n in load_shard_batches(
                cat, plan, si, min_batch_rows=1):
            cols = tuple(values[c].astype(schema.scan_dtype(c, device=True),
                                          copy=False)
                         for c in plan.scan_columns)
            yield cols, tuple(masks[c] for c in plan.scan_columns), n


def _run_partials_cpu(cat: Catalog, plan: PhysicalPlan, settings: Settings,
                      params=((), ()), device=None, mesh=None):
    worker = build_worker_fn(plan, np)
    pcols, pvalids = params
    shard_results = []
    for cols, valids, n in _host_batches(cat, plan):
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


def _param_dtypes(plan: PhysicalPlan, params) -> dict:
    """Parameter env name -> dtype of a query's encoded parameters: the
    generated kernels take them in their parameter block."""
    from citus_tpu_torch.planner.bound import param_env_names
    return {n: np.asarray(v).dtype for n, v in
            zip(param_env_names(plan.bound.param_specs), params[0])}


@dataclass
class _StreamStats:
    """What one ``_stream_device_batches`` pass did: launches, streamed
    bytes, the un-synced window's peak and per-task times."""
    cached: bool = False
    n_dispatch: int = 0
    nbytes: int = 0
    window_peak: int = 0
    task_times: list = field(default_factory=list)
    task_bytes: list = field(default_factory=list)

    def extend(self, other: "_StreamStats") -> None:
        """Add a second pass over other shards (push fallbacks)."""
        self.cached = self.cached and other.cached
        self.n_dispatch += other.n_dispatch
        self.nbytes += other.nbytes
        self.window_peak = max(self.window_peak, other.window_peak)
        self.task_times += other.task_times
        self.task_bytes += other.task_bytes

    def publish(self, plan: PhysicalPlan, pstats) -> None:
        """Into the plan's EXPLAIN surface: pipeline stats of a streamed
        pass, launches, window peak and per-task times."""
        if not self.cached:
            pstats.h2d_bytes = self.nbytes
            pstats.publish(plan)
        pl = plan.runtime_cache.setdefault("pipeline", {})
        pl["fused_dispatches"] = self.n_dispatch
        if not self.cached:
            # a pass served from the device cache streams no window
            pl["stream_window_peak_bytes"] = self.window_peak
        plan.runtime_cache["task_times"] = self.task_times
        plan.runtime_cache["task_bytes"] = self.task_bytes


#: ``_stream_device_batches``'s default: look the cache key up itself
_LOOKUP = object()


def _stream_device_batches(cat: Catalog, plan: PhysicalPlan,
                           settings: Settings, device, launch, pstats, *,
                           cache_key: Optional[tuple] = None,
                           cache_tenant: Optional[str] = None,
                           on_sync=None, cached=_LOOKUP,
                           host_batches=None) -> _StreamStats:
    """Call ``launch(db, hb)`` once for each padded shard batch of the
    plan: ``db`` on ``device``, ``hb`` its host batch.

    With ``cache_key`` the device cache's entry is replayed when it
    holds one (``hb`` is None then), and a streamed scan is kept for the
    cache while its working set fits.  Otherwise the decode thread
    prepares batch i+1 on the host while batch i copies and launches;
    pinned staging keeps the copies asynchronous.  Past the cache,
    throughput degrades to the pipeline rate instead of collapsing: at
    most ``depth`` batches stay un-synced, then the stream waits for the
    device (the launches are ordered on one stream, so that retires all
    of them) and calls ``on_sync()`` — and once more after the last
    batch.  Each streamed batch is one ``device_round`` span.
    ``cached`` is the entry of ``cache_key`` when the caller looked it up
    already, and ``host_batches`` the padded host batches when the
    caller has them (else the plan's)."""
    from citus_tpu_torch.executor.device_cache import GLOBAL_CACHE
    from citus_tpu_torch.executor.pipeline import (
        prefetch_batches, read_ahead_depth,
    )
    from citus_tpu_torch.testing.faults import FAULTS

    st = _StreamStats()
    if cached is _LOOKUP:
        cached = None if cache_key is None else GLOBAL_CACHE.get(cache_key)
    if cached is not None:
        st.cached = True
        for b in cached:
            t0 = clock()
            launch(b, None)
            st.n_dispatch += 1
            st.task_times.append((b.shard_index, b.n_rows, clock() - t0))
        return st
    collect: Optional[list] = [] if cache_key is not None else None
    depth = _prefetch_depth(settings)
    window_bytes = 0       # un-synced streamed bytes on device
    since_sync = 0
    staging = _Staging(device, depth + 1)
    if host_batches is None:
        host_batches = _iter_padded_batches(cat, plan, settings)
    host_iter = prefetch_batches(host_batches, read_ahead_depth(settings),
                                 pstats)
    try:
        for hb in host_iter:
            t_dev = clock()
            FAULTS.hit("device_round", plan.bound.table.name)
            db = staging.to_device(hb)
            t0 = clock()
            launch(db, hb)
            st.n_dispatch += 1
            st.task_times.append((db.shard_index, db.n_rows, clock() - t0))
            bb = (sum(c.nbytes for c in hb.cols)
                  + sum(v.nbytes for v in hb.valids) + hb.row_mask.nbytes)
            st.nbytes += bb
            st.task_bytes.append((db.shard_index, bb))
            if collect is not None:
                collect.append(db)
                if st.nbytes > GLOBAL_CACHE.capacity:
                    collect = None  # working set exceeds the cache
            if collect is None:
                window_bytes += bb
                st.window_peak = max(st.window_peak, window_bytes)
                since_sync += 1
                if since_sync >= depth:
                    _block_ready(device)
                    if on_sync is not None:
                        on_sync()
                    since_sync = 0
                    window_bytes = 0
            pstats.device_s += clock() - t_dev
            ctx = _trace.current()
            if ctx is not None:
                tr, parent = ctx
                tr.add_closed("device_round", parent.span_id, t_dev, clock(),
                              {"shard_index": int(hb.shard_index),
                               "rows": int(hb.n_rows)})
    finally:
        host_iter.close()
    if on_sync is not None:
        on_sync()
    if st.n_dispatch:
        if collect:
            GLOBAL_CACHE.put(cache_key, collect, st.nbytes,
                             tenant=cache_tenant)
        GLOBAL_COUNTERS.bump("bytes_scanned", st.nbytes)
        GLOBAL_COUNTERS.bump("device_hbm_touched_bytes", st.nbytes)
    return st


def _repad_batch(b: ShardBatch, bucket: int) -> ShardBatch:
    """Grow a padded host batch to a larger bucket (a mesh round's
    members share one shape)."""
    pad = bucket - b.padded_rows
    if pad <= 0:
        return b
    cols = tuple(np.concatenate([c, np.zeros(pad, c.dtype)]) for c in b.cols)
    valids = tuple(np.concatenate([v, np.ones(pad, bool)]) for v in b.valids)
    mask = np.concatenate([b.row_mask, np.zeros(pad, bool)])
    return ShardBatch(cols, valids, mask, b.n_rows, bucket, b.shard_index)


def _run_mesh_round(plan: PhysicalPlan, mesh, buf: list, stagings: dict,
                    launch, collect: Optional[list]) -> int:
    """One round onto the mesh: ``buf``'s host batches (filled in place
    with empty ones, shard index -1, to one per member) re-padded to the
    round's largest bucket, copied to their members' devices and folded
    there (``launch(m, db)``); the device batches are kept in
    ``collect`` for the device cache.  -> the round's bytes."""
    from citus_tpu_torch.parallel.mesh import shard_axis_size
    from citus_tpu_torch.testing.faults import FAULTS
    # delay injections here model device-side round latency for the
    # host/device overlap tests (the decode half is decode_batch)
    FAULTS.hit("device_round", plan.bound.table.name)
    t0 = clock()
    n_real = len(buf)
    bucket = max(b.padded_rows for b in buf)
    while len(buf) < shard_axis_size(mesh):
        buf.append(empty_batch(plan.bound.table, plan, bucket, -1))
    nbytes = 0
    dbs = []
    for m, hb in enumerate(_repad_batch(b, bucket) for b in buf):
        db = stagings[mesh.device_of(m)].to_device(hb)
        launch(m, db)
        dbs.append(db)
        nbytes += (sum(c.nbytes for c in hb.cols)
                   + sum(v.nbytes for v in hb.valids) + hb.row_mask.nbytes)
    if collect is not None:
        collect.append(dbs)
    ctx = _trace.current()
    if ctx is not None:
        tr, parent = ctx
        tr.add_closed("device_round", parent.span_id, t0, clock(),
                      {"batches": n_real, "bytes": int(nbytes)})
    return nbytes


def _book_mesh_round(buf: list, nb: int, task_bytes: list) -> None:
    """Split one mesh round's H2D bytes across the round's REAL shard
    members for attribution (``_run_mesh_round`` appends shard_index=-1
    pad batches into ``buf`` in place; their padding overhead belongs to
    the shards that forced the round).  The byte remainder lands on the
    first member so the ledger total stays exactly equal to the
    bytes_scanned counter bump.  (The reference also splits the round's
    time into ``mesh_task_times``, which nothing reads.)"""
    real = [mb for mb in buf if mb.shard_index >= 0] or buf
    share, rem = divmod(int(nb), len(real))
    for i, mb in enumerate(real):
        task_bytes.append((mb.shard_index, share + (rem if i == 0 else 0)))


def mesh_layout(plan: PhysicalPlan, n: int):
    """-> (the plan's ``RegisterLayout`` over ``n`` members, its seed
    arena's bytes: ``_empty_partials`` packed), cached on the plan."""
    key = ("mesh_layout", n)
    hit = plan.runtime_cache.get(key)
    if hit is None:
        import torch
        from citus_tpu_torch.parallel.mesh import RegisterLayout
        seeds = _empty_partials(plan, np)
        layout = RegisterLayout(
            combine_kinds(plan),
            [torch.from_numpy(np.asarray(s)).dtype for s in seeds],
            [np.shape(s) for s in seeds], n)
        hit = (layout, torch.from_numpy(layout.pack(seeds)))
        plan.runtime_cache[key] = hit
    return hit


def _mesh_folds(plan: PhysicalPlan, mesh, params):
    """-> (``launch(m, db)`` folding a device batch into member m's
    registers, the plan's ``RegisterLayout``, the members' register
    arenas).  Each member's registers are one fresh allocation on its
    device, the layout's views of it; its parameters ride each launch's
    parameter block (replicated, as the reference's ``p_stack``)."""
    from citus_tpu_torch.ops.xp_torch import TorchNamespace
    from citus_tpu_torch.parallel.mesh import on_member, shard_axis_size
    penv = _params_env(plan, params)
    folds = {}
    for dev in set(mesh.devices):
        folds[dev] = get_kernel(
            plan, f"fused:{dev}",
            lambda dev=dev: build_fused_worker_fn(
                plan, TorchNamespace(dev), _param_dtypes(plan, params)),
            extra=(str(dev),))
    layout, seed = mesh_layout(plan, shard_axis_size(mesh))
    # one host-to-device copy of the seeds per device; the other
    # members on it start from device-side clones, before any fold
    seeds: dict = {}
    arenas = []
    for m in range(shard_axis_size(mesh)):
        dev = mesh.device_of(m)
        if dev in seeds:
            arenas.append(seeds[dev].clone())
        else:
            seeds[dev] = seed.to(dev, copy=True)
            arenas.append(seeds[dev])
    accs = [layout.views(a) for a in arenas]

    def launch(m, db):
        dev = mesh.device_of(m)
        with on_member(dev):
            folds[dev](accs[m], db.cols, db.valids, db.row_mask, penv)
    return launch, layout, arenas


def _run_partials_mesh(cat: Catalog, plan: PhysicalPlan, settings: Settings,
                       params, mesh, mkey: Optional[tuple], cache_tenant,
                       pstats, batches=None, cached_rounds=None):
    """The mesh branch of ``_run_partials_device`` (the reference's
    ``_run_partials_jax`` over more than one device): ``batches`` (two or
    more padded host batches, lazily) go in rounds of one per member, or
    ``cached_rounds``, the mesh cache entry, replays its rounds (each
    member's device batches); each member folds
    into its own registers, and one ``mesh_combine_arenas`` gives the
    partials in one allocation, copied to the host in one copy.  A streamed scan is kept for the cache while its working
    set fits; past it, at most ``depth`` rounds stay un-synced."""
    from citus_tpu_torch.executor.device_cache import GLOBAL_CACHE
    from citus_tpu_torch.executor.pipeline import (
        prefetch_batches, read_ahead_depth,
    )
    from citus_tpu_torch.parallel.mesh import (
        mesh_combine_arenas, shard_axis_size,
    )
    n_dev = shard_axis_size(mesh)
    launch, layout, arenas = _mesh_folds(plan, mesh, params)
    devices = list(dict.fromkeys(mesh.devices))
    rounds = 0
    if cached_rounds is not None:
        for dbs in cached_rounds:
            for m, db in enumerate(dbs):
                launch(m, db)
            rounds += 1
    else:
        depth = _prefetch_depth(settings)
        stagings = {d: _Staging(d, (depth + 1) * n_dev) for d in devices}
        collect: Optional[list] = [] if mkey is not None else None
        nbytes = 0
        since_sync = 0
        task_bytes: list = []

        def step(buf):
            """One round, booked; past the cache, at most ``depth``
            rounds stay un-synced."""
            nonlocal nbytes, collect, since_sync, rounds
            t_dev = clock()
            nb = _run_mesh_round(plan, mesh, buf, stagings, launch, collect)
            nbytes += nb
            rounds += 1
            _book_mesh_round(buf, nb, task_bytes)
            if collect is not None and nbytes > GLOBAL_CACHE.capacity:
                collect = None  # working set exceeds the cache: stream
            if collect is None:
                since_sync += 1
                if since_sync >= depth:
                    for d in devices:
                        _block_ready(d)
                    since_sync = 0
            pstats.device_s += clock() - t_dev
        # host/device overlap: the decode thread prepares the NEXT round
        # (up to read_ahead_depth rounds of n_dev batches) while the
        # devices fold the current one
        host_iter = prefetch_batches(batches, read_ahead_depth(settings)
                                     * n_dev, pstats)
        buf: list = []
        try:
            for hb in host_iter:
                buf.append(hb)
                if len(buf) == n_dev:
                    step(buf)
                    buf = []
            if buf:
                step(buf)
        finally:
            host_iter.close()
        if collect:
            GLOBAL_CACHE.put(mkey, collect, nbytes, tenant=cache_tenant)
        pstats.h2d_bytes = nbytes
        GLOBAL_COUNTERS.bump("bytes_scanned", nbytes)
        GLOBAL_COUNTERS.bump("device_hbm_touched_bytes", nbytes)
        plan.runtime_cache["task_bytes"] = task_bytes
        pstats.publish(plan)
    t_dev = clock()
    # one combine into one output allocation, one copy to the host
    partials = layout.host_outputs(
        mesh_combine_arenas(layout, arenas).cpu().numpy())
    pstats.device_s += clock() - t_dev
    GLOBAL_COUNTERS.bump("fused_dispatches", rounds * n_dev)
    pl = plan.runtime_cache.setdefault("pipeline", {})
    pl["fused_dispatches"] = rounds * n_dev
    pl["mesh_members"] = n_dev
    pl["mesh_rounds"] = rounds
    return partials


def _run_partials_device(cat: Catalog, plan: PhysicalPlan, settings: Settings,
                         params=((), ()), device=None, mesh=None):
    import torch
    from citus_tpu_torch.executor.device_cache import (
        GLOBAL_CACHE, plan_cache_key,
    )
    from citus_tpu_torch.executor.pipeline import PipelineStats
    from citus_tpu_torch.ops.xp_torch import TorchNamespace
    from citus_tpu_torch.workload import tenant_key

    if device is None:
        raise ExecutionError("the gpu backend needs the Cluster's device")
    device = torch.device(device)
    xp = TorchNamespace(device)
    pstats = PipelineStats()
    _trace.set_phase("device")
    # an open transaction's staged writes change what a scan sees
    # without bumping table.version: bypass the device cache for the
    # tables it touched.  A cache entry is charged to the tenant whose
    # query pinned it (the shared bucket for non-router scans)
    from citus_tpu_torch.storage.overlay import current_overlay
    txn = current_overlay()
    overlaid = txn is not None and plan.bound.table.name in txn.tables
    key = None if overlaid \
        else plan_cache_key(plan, cat.data_dir) + (str(device),)
    cache_tenant = tenant_key(plan.router_key)
    cached = None if key is None else GLOBAL_CACHE.get(key)
    host_batches = None
    # a single-batch table cached under the one-device key serves from
    # the single stream below without touching disk: only enter the mesh
    # branch when no such entry exists
    if mesh is not None and mesh.shape["shard"] > 1 and cached is None:
        # mesh entries hold each member's device batches per round, a
        # different structure than the single stream's: they key apart
        mkey = None if key is None else key + (
            "mesh", mesh.shape["shard"], tuple(map(str, mesh.devices)))
        mcached = None if mkey is None else GLOBAL_CACHE.get(mkey)
        if mcached is not None:
            return _run_partials_mesh(cat, plan, settings, params, mesh,
                                      mkey, cache_tenant, pstats,
                                      cached_rounds=mcached)
        import itertools
        stream = _iter_padded_batches(cat, plan, settings)
        t_peek = clock()
        first = next(stream, None)
        second = None if first is None else next(stream, None)
        pstats.host_decode_s += clock() - t_peek
        if first is None:
            return combine_partials_host(plan, [_empty_partials(plan, np)])
        if second is not None:
            return _run_partials_mesh(
                cat, plan, settings, params, mesh, mkey, cache_tenant,
                pstats, itertools.chain([first, second], stream))
        host_batches = iter([first])  # one batch: the single stream
    # one fold per batch into device-resident registers, updated in
    # place (the port's donate_argnums): one scan_agg_fold launch per
    # batch -- the plan's WHERE, keys and arguments generated into it,
    # its parameters in the launch's parameter block -- no merge
    # dispatch, no host round-trip until the end
    fused = get_kernel(plan, f"fused:{device}",
                       lambda: build_fused_worker_fn(
                           plan, xp, _param_dtypes(plan, params)),
                       extra=(str(device),))
    penv = _params_env(plan, params)
    acc = empty_device_partials(plan, device)
    st = _stream_device_batches(
        cat, plan, settings, device,
        lambda db, hb: fused(acc, db.cols, db.valids, db.row_mask, penv),
        pstats, cache_key=key, cache_tenant=cache_tenant, cached=cached,
        host_batches=host_batches)
    if st.n_dispatch == 0:
        return combine_partials_host(plan, [_empty_partials(plan, np)])
    t_dev = clock()
    partials = tuple(a.cpu().numpy() for a in acc)
    pstats.device_s += clock() - t_dev
    GLOBAL_COUNTERS.bump("fused_dispatches", st.n_dispatch)
    st.publish(plan, pstats)
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
             params=((), ()), device=None, mesh=None) -> list[tuple]:
    backend = settings.executor.task_executor_backend
    mode = plan.group_mode.kind
    penv = _params_env(plan, params)
    if backend not in ("cpu", "gpu"):
        raise ExecutionError(
            f"unknown task_executor_backend {backend!r} (cpu | gpu)")
    if mode not in ("scalar", "direct"):
        # unbounded-cardinality GROUP BY: the device table and the spills
        # merge on the host, so the whole strategy renders as one
        # host_agg span
        with _trace.span("host_agg", shards=len(plan.shard_indexes)):
            return _run_agg_hash_host(cat, plan, settings, params, device)
    # push the worker half to the coordinators OWNING remote-only
    # placements (ship partial-agg states, not stripe files) and overlap
    # the remote waits with the local shard scan: dispatch first, scan
    # while the RPCs fly, collect as they complete.  Push fallbacks scan
    # locally in a second pass; combine is associative, so the split
    # changes nothing in the result.
    from citus_tpu_torch.executor.pipeline import dispatch_remote_tasks
    run = _run_partials_cpu if backend == "cpu" else _run_partials_device
    local, dispatch = dispatch_remote_tasks(cat, plan, settings, params)
    try:
        partials = run(cat, _with_shards(plan, local), settings, params,
                       device, mesh)
    except BaseException:
        dispatch.abort()  # no RPC thread outlives the attempt
        raise
    fallback, remote_partials = dispatch.collect()
    if fallback:
        tt = list(plan.runtime_cache.get("task_times", []))
        tb = list(plan.runtime_cache.get("task_bytes", []))
        remote_partials = [*remote_partials,
                           run(cat, _with_shards(plan, fallback), settings,
                               params, device, mesh)]
        plan.runtime_cache["task_times"] = (
            tt + list(plan.runtime_cache.get("task_times", [])))
        plan.runtime_cache["task_bytes"] = (
            tb + list(plan.runtime_cache.get("task_bytes", [])))
    if remote_partials:
        partials = combine_partials_host(plan, [partials, *remote_partials])
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


def _with_shards(plan: PhysicalPlan, shard_indexes) -> PhysicalPlan:
    """``plan`` restricted to ``shard_indexes`` (sharing its
    runtime_cache), or ``plan`` itself when that is all of them."""
    if list(shard_indexes) == list(plan.shard_indexes):
        return plan
    import dataclasses
    return dataclasses.replace(plan, shard_indexes=list(shard_indexes))


def _params_env(plan, params) -> dict:
    from citus_tpu_torch.planner.bound import param_env_names
    pcols, pvalids = params
    return dict(zip(param_env_names(plan.bound.param_specs),
                    zip(pcols, pvalids)))


# ------------------------------------------------------- hash GROUP BY


def _hash_has_exact(plan: PhysicalPlan) -> bool:
    """distinct/collect partial states are exact value (multi)sets and
    sketch registers have their own merge laws: only the host
    accumulation path can carry them."""
    return any(op.kind in ("distinct", "collect", "collect_set", "hll",
                           "ddsk", "topk", "topkv")
               for op in plan.partial_ops)


def _hash_slots(cat: Catalog, plan: PhysicalPlan, settings: Settings) -> int:
    """citus.hash_agg_slots; 0 (= auto) sizes the table from catalog
    row-count stats — next power of two, clamped [1024, 1<<20] — so
    small tables don't pay a megaslot fetch and big ones don't spill
    every other row."""
    S = settings.planner.hash_agg_slots
    if S > 0:
        return S
    from citus_tpu_torch.catalog.stats import table_row_count
    n = max(1, int(table_row_count(cat, cat.table(plan.bound.table.name))))
    return min(1 << 20, max(1024, 1 << (n - 1).bit_length()))


def _hash_key_dtypes(plan: PhysicalPlan, penv: dict) -> tuple:
    """Device dtype of each group-key expression, probed by evaluating
    the compiled key on a zero-row scan env (uuid lanes, casts and
    dictionary remaps all resolve without trusting declared types)."""
    from citus_tpu_torch.planner.bound import compile_expr
    schema = plan.bound.table.schema
    env = {c: (np.zeros(0, schema.scan_dtype(c, device=True)),
               np.zeros(0, bool))
           for c in plan.scan_columns}
    env.update(penv)
    dts = []
    for k in plan.bound.group_keys:
        kv, _ = compile_expr(k, np)(env)
        dts.append(np.asarray(kv).dtype)
    return tuple(dts)


class _SpillDrain:
    """Spill masks of launched hash inserts, drained into host
    accumulators at the stream's sync points (per prefetch window, not
    per batch), so the device holds O(slots) plus depth x batch bytes
    and the host never materializes the scan.  A mask is [N] for one
    accumulator or [Q, N] for Q of them.  A spilled row's keys and
    arguments are evaluated again with numpy from its host batch, which
    is kept until its spill is drained."""

    def __init__(self, plan: PhysicalPlan, accs: list, penv: dict):
        from citus_tpu_torch.planner.bound import compile_expr
        self.plan = plan
        self.accs = accs
        self.penv = penv
        self.key_fns = [compile_expr(k, np) for k in plan.bound.group_keys]
        self.arg_fns = [compile_expr(a, np) for a in plan.agg_args]
        self.pending: list = []   # (host batch, device spill mask)
        self.rows = 0
        self.seconds = 0.0

    def add(self, hb: ShardBatch, spill) -> None:
        self.pending.append((hb, spill))

    def __call__(self) -> None:
        t0 = clock()
        for hb, sp in self.pending:
            sp = sp.cpu().numpy().reshape(len(self.accs), -1)
            if not sp.any():
                continue
            env = {n: (np.asarray(c), np.asarray(v))
                   for n, c, v in zip(self.plan.scan_columns, hb.cols,
                                      hb.valids)}
            env.update(self.penv)
            keys = [f(env) for f in self.key_fns]
            args = [f(env) for f in self.arg_fns]
            for acc, m in zip(self.accs, sp):
                if m.any():
                    n_sp = int(m.sum())
                    GLOBAL_COUNTERS.bump("hash_spill_rows", n_sp)
                    self.rows += n_sp
                    acc.add_batch(m, keys, args)
        self.pending.clear()
        self.seconds += clock() - t0


def _stage_to_device(arrays, device) -> list:
    """Host arrays (possibly read-only views into a received frame) ->
    tensors on ``device``.  On a card each goes through a page-locked
    buffer and an asynchronous copy on the current stream (the caching
    host allocator keeps the buffer until the copy is done); on the CPU
    each is copied once, since a tensor must not alias a read-only
    frame."""
    import torch
    from citus_tpu_torch.ops.xp_torch import torch_dtype
    out = []
    for a in arrays:
        a = np.asarray(a)
        if device.type != "cuda":
            out.append(torch.from_numpy(np.array(a)))
            continue
        buf = torch.empty(a.shape, dtype=torch_dtype(a.dtype),
                          pin_memory=True)
        buf.numpy()[...] = a
        out.append(buf.to(device, non_blocking=True))
    return out


def _merge_remote_table(table, plan: PhysicalPlan, entries, device):
    """Re-insert a peer's shipped hash table (``entries`` = (key
    tables, partial tables, rows) as host arrays) into ``table`` through
    one ``hash_agg_merge``; -> the host mask of entries that lost both
    probes."""
    from citus_tpu_torch.ops.hash_agg_merge import hash_agg_merge
    key_e, part_e, row_e = entries
    flat = [a for kv, kf in key_e for a in (kv, kf)] + list(part_e) + [row_e]
    dev = _stage_to_device(flat, device)
    k = 2 * len(key_e)
    keys = [(dev[i].to(table.key_values[i // 2].dtype), dev[i + 1])
            for i in range(0, k, 2)]
    parts = [t.to(p.dtype) for t, p in zip(dev[k:-1], table.partials)]
    spill = hash_agg_merge(table, keys, parts, dev[-1],
                           [op.kind for op in plan.partial_ops])
    return spill.cpu().numpy()


def _run_hash_device(cat: Catalog, plan: PhysicalPlan, settings: Settings,
                     params, acc, penv, device, push_remote: bool = False):
    """Device half of a hash_host plan: stream every local shard batch
    into ONE device-resident hash table (one ``hash_agg_insert`` per
    batch, updated in place), draining spills into ``acc`` exactly.
    With ``push_remote``, remote-only shards ship as hash tasks first;
    each table a peer returns re-inserts into this one through one
    ``hash_agg_merge`` launch (its losers and the peer's host-exact
    spill merge on the host), and push fallbacks re-stream locally.
    Returns the fetched (key_tables, partials, rows) host arrays."""
    import torch
    from citus_tpu_torch.executor.pipeline import PipelineStats
    from citus_tpu_torch.ops.hash_agg import (
        build_fused_hash_worker, empty_hash_state, merge_hash_tables_into,
    )

    if device is None:
        raise ExecutionError("the gpu backend needs the Cluster's device")
    device = torch.device(device)
    pstats = PipelineStats()
    _trace.set_phase("device")
    S = _hash_slots(cat, plan, settings)
    key_dtypes = _hash_key_dtypes(plan, penv)
    fused = get_kernel(
        plan, f"hash_fused:{device}",
        lambda: build_fused_hash_worker(plan, key_dtypes,
                                        _param_dtypes(plan, params)),
        extra=(str(device),))
    drain = _SpillDrain(plan, [acc], penv)
    table = empty_hash_state(plan, S, key_dtypes, device)

    def stream(shards) -> _StreamStats:
        return _stream_device_batches(
            cat, _with_shards(plan, shards), settings, device,
            lambda db, hb: drain.add(hb, fused(
                table, db.cols, db.valids, db.row_mask, penv)),
            pstats, on_sync=drain)

    local, dispatch = plan.shard_indexes, None
    if push_remote:
        from citus_tpu_torch.executor.pipeline import dispatch_remote_tasks
        local, dispatch = dispatch_remote_tasks(cat, plan, settings, params)
    try:
        st = stream(local)
    except BaseException:
        if dispatch is not None:
            dispatch.abort()  # no RPC thread outlives the attempt
        raise
    merge_s = 0.0
    if dispatch is not None:
        fallback, remote = dispatch.collect()
        if fallback:
            st.extend(stream(fallback))
        t0 = clock()
        for entries, spilled in remote:
            if entries is not None:
                espill = _merge_remote_table(table, plan, entries, device)
                if espill.any():
                    # fingerprint-collision losers among the peer's
                    # entries: merge exactly on the host
                    merge_hash_tables_into(acc, plan, *entries,
                                           entry_mask=espill)
            if spilled is not None:
                merge_hash_tables_into(acc, plan, *spilled)
            GLOBAL_COUNTERS.bump("hash_partials_pushed")
        merge_s = clock() - t0
    t_dev = clock()
    h_keys, h_partials, h_rows = table.to_host()
    pstats.device_s += clock() - t_dev
    GLOBAL_COUNTERS.bump("hash_fused_dispatches", st.n_dispatch)
    st.publish(plan, pstats)
    pl = plan.runtime_cache["pipeline"]
    pl["stream_window_peak_bytes"] = st.window_peak
    pl["hash_slots"] = S
    pl["hash_occupancy_pct"] = round(100.0 * int((h_rows > 0).sum()) / S, 1)
    pl["hash_spilled_rows"] = drain.rows
    pl["hash_spill_merge_ms"] = round(drain.seconds * 1e3, 3)
    if dispatch is not None:
        pl["hash_remote_merge_ms"] = round(merge_s * 1e3, 3)
    return h_keys, h_partials, h_rows


def _run_hash_partial_state(cat: Catalog, plan: PhysicalPlan,
                            settings: Settings, params=((), ()),
                            device=None):
    """Worker half of a pushed hash task: -> (table | None, spilled |
    None) where ``table`` is the merged device hash table's host arrays
    and ``spilled`` re-renders the host accumulator's exact groups as
    entry arrays (key values, int8 flags [valid+1], partial values, one
    synthetic row per group).  cpu-backend workers ship spill-only."""
    from citus_tpu_torch.executor.host_agg import HostGroupAccumulator

    acc = HostGroupAccumulator(len(plan.bound.group_keys), plan.partial_ops)
    penv = _params_env(plan, params)
    table = None
    if settings.executor.task_executor_backend != "cpu":
        table = _run_hash_device(cat, plan, settings, params, acc, penv,
                                 device)
    else:
        _host_group(cat, plan, params, acc)
    key_arrays, partials = acc.finalize(
        [k.type for k in plan.bound.group_keys])
    spilled = None
    if key_arrays:
        G = int(np.asarray(key_arrays[0][0]).shape[0])
        keys_w = [(np.asarray(vals),
                   np.asarray(valid).astype(np.int8) + 1)
                  for vals, valid in key_arrays]
        spilled = (keys_w, tuple(np.asarray(p) for p in partials or ()),
                   np.ones(G, np.int64))
    return table, spilled


def _host_group(cat: Catalog, plan: PhysicalPlan, params, acc) -> None:
    """Every shard's rows grouped on the host into ``acc`` (the cpu
    backend, and partials only the host accumulates)."""
    pcols, pvalids = params
    worker = build_worker_fn(plan, np)
    for cols, valids, n in _host_batches(cat, plan):
        mask, keys, args = worker(cols + pcols, valids + pvalids,
                                  np.ones(n, bool))
        acc.add_batch(np.asarray(mask),
                      [(np.asarray(v), m if isinstance(m, bool)
                        else np.asarray(m)) for v, m in keys],
                      [(np.asarray(v), m if isinstance(m, bool)
                        else np.asarray(m)) for v, m in args])


def _run_agg_hash_host(cat: Catalog, plan: PhysicalPlan, settings: Settings,
                       params=((), ()), device=None) -> list[tuple]:
    """Unbounded GROUP BY cardinality.

    gpu backend: streaming device hash aggregation (ops/hash_agg.py) —
    one device-resident table, one ``hash_agg_insert`` per batch, exact
    host merge of the final table and of spilled rows; remote-only
    shards push hash tasks and their tables merge in through
    ``hash_agg_merge``.  cpu backend (and exact value-set or sketch
    partials): full host grouping over the pull path."""
    from citus_tpu_torch.executor.host_agg import HostGroupAccumulator
    from citus_tpu_torch.executor.worker_tasks import note_inexpressible

    backend = settings.executor.task_executor_backend
    acc = HostGroupAccumulator(len(plan.bound.group_keys), plan.partial_ops)
    penv = _params_env(plan, params)

    if backend != "cpu" and not _hash_has_exact(plan):
        from citus_tpu_torch.ops.hash_agg import merge_hash_tables_into
        h_keys, h_partials, h_rows = _run_hash_device(
            cat, plan, settings, params, acc, penv, device,
            push_remote=True)
        t0 = clock()
        merge_hash_tables_into(acc, plan, h_keys, h_partials, h_rows)
        key_arrays, partials = acc.finalize(
            [k.type for k in plan.bound.group_keys],
            scalar=not plan.bound.group_keys)
        plan.runtime_cache["pipeline"]["host_merge_ms"] = round(
            (clock() - t0) * 1e3, 3)
        if partials is None:
            return []
        return finalize_groups(plan, cat, key_arrays, partials,
                               params_env=penv)

    # exact value-set partials (or the cpu oracle backend) stay host-only
    # and are not elementwise-combinable — remote-only shards pull
    note_inexpressible(cat, plan, settings)
    _host_group(cat, plan, params, acc)
    key_arrays, partials = acc.finalize([k.type for k in plan.bound.group_keys],
                                        scalar=not plan.bound.group_keys)
    if partials is None:
        return []
    return finalize_groups(plan, cat, key_arrays, partials, params_env=penv)


# ----------------------------------------------------------- projection


def _build_filter_mask(plan: PhysicalPlan, params):
    """The plan's WHERE as a ``FilterProgram`` over the device dtypes of
    its columns and parameters."""
    from citus_tpu_torch.ops.filter_mask import FilterProgram
    schema = plan.bound.table.schema
    return FilterProgram(
        plan.bound.filter,
        {c: schema.scan_dtype(c, device=True) for c in plan.scan_columns},
        _param_dtypes(plan, params))


class _ProjectionMask:
    """The WHERE of a projection as the row mask of one host batch: on
    the gpu backend one generated ``filter_mask`` launch over only the
    predicate's columns, with no row mask (every row of a host batch is
    real), read back to the host; on the cpu backend the numpy
    predicate.  ``launches`` counts the kernel launches."""

    def __init__(self, plan: PhysicalPlan, settings: Settings, params,
                 device):
        backend = settings.executor.task_executor_backend
        if backend not in ("cpu", "gpu"):
            raise ExecutionError(
                f"unknown task_executor_backend {backend!r} (cpu | gpu)")
        self.plan = plan
        self.penv = _params_env(plan, params)
        self.prog = None
        self.launches = 0
        if backend == "gpu" and plan.bound.filter is not None:
            import torch
            if device is None:
                raise ExecutionError(
                    "the gpu backend needs the Cluster's device")
            self.device = torch.device(device)
            self.prog = get_kernel(
                plan, f"filter:{self.device}",
                lambda: _build_filter_mask(plan, params),
                extra=(str(self.device),))

    def __call__(self, env: dict, n: int) -> np.ndarray:
        plan = self.plan
        if self.prog is not None:
            import torch
            from citus_tpu_torch.ops.filter_mask import filter_mask
            dcols = {c: tuple(torch.from_numpy(np.ascontiguousarray(a))
                              .to(self.device) for a in env[c])
                     for c in self.prog.columns}
            # every row of the batch: no row mask (a predicate of no
            # column takes one, for the batch's device)
            row_mask = None if dcols else torch.ones(
                n, dtype=torch.bool, device=self.device)
            self.launches += 1
            return filter_mask(self.prog, dcols, self.penv, row_mask,
                               n).cpu().numpy()
        if plan.bound.filter is None:
            return np.ones(n, bool)
        from citus_tpu_torch.planner.bound import compile_expr, predicate_mask
        cfn_np = plan.runtime_cache.get("np_filter")
        if cfn_np is None:
            cfn_np = compile_expr(plan.bound.filter, np)
            plan.runtime_cache["np_filter"] = cfn_np
        return np.asarray(predicate_mask(np, cfn_np, env, np.ones(n, bool))) \
            & np.ones(n, bool)


def _run_projection(cat: Catalog, plan: PhysicalPlan, settings: Settings,
                    params=((), ()), device=None) -> list[tuple]:
    """SELECT without aggregates: scan every local shard, mask its rows
    by the WHERE clause (``_ProjectionMask``) and project the kept rows
    on the host.  Remote-only placements run scan and filter where the
    data lives and return compacted rows; the local shards stream here
    while those RPCs are in flight."""
    from citus_tpu_torch.executor.finalize import project_rows
    from citus_tpu_torch.executor.pipeline import dispatch_remote_tasks

    masker = _ProjectionMask(plan, settings, params, device)
    penv = masker.penv

    def scan(shards, out: list) -> None:
        for cols, valids, n in _host_batches(cat, _with_shards(plan, shards)):
            env = dict(zip(plan.scan_columns, zip(cols, valids)))
            env.update(penv)
            out.append((env, masker(env, n)))

    local, dispatch = dispatch_remote_tasks(cat, plan, settings, params)
    local_batches: list = []
    try:
        scan(local, local_batches)
    except BaseException:
        dispatch.abort()  # no RPC thread outlives the attempt
        raise
    fallback, remote_batches = dispatch.collect()
    env_batches = []
    schema = plan.bound.table.schema
    for values, validity in remote_batches:
        if not plan.scan_columns:
            continue
        n = len(values[plan.scan_columns[0]])
        if n == 0:
            continue
        env = {c: (values[c].astype(schema.scan_dtype(c, device=True),
                                    copy=False), validity[c])
               for c in plan.scan_columns}
        env.update(penv)
        env_batches.append((env, np.ones(n, bool)))
    env_batches.extend(local_batches)
    if fallback:
        scan(fallback, env_batches)
    plan.runtime_cache["pipeline"]["filter_dispatches"] = masker.launches
    return project_rows(plan, cat, env_batches)


# ---------------------------------------------------------------- entry


def _guard_remote_written(cat, table_names) -> None:
    """Refuse reads of tables whose REMOTE shards this transaction
    wrote: the staged state would live in branch sessions on other
    hosts, invisible to local scans.  Cross-host DML is not ported
    (ROADMAP.md A13), so no transaction of this package records such
    writes today; the check stays at the executor door, as in the
    reference, for when it is."""
    from citus_tpu_torch.storage.overlay import current_overlay
    txn = current_overlay()
    if txn is None or not getattr(txn, "remote_written_tables", None):
        return
    hit = set(table_names) & txn.remote_written_tables
    if hit:
        from citus_tpu_torch.errors import UnsupportedFeatureError
        raise UnsupportedFeatureError(
            f"cannot read {sorted(hit)[0]!r} in this transaction after "
            "writing its remote-hosted shards (remote staged state is "
            "not visible here); COMMIT first")


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
                   device=None, mesh=None) -> Result:
    """Run one bound SELECT.  ``device`` is the torch device of the
    ``gpu`` backend (the Cluster's), ``mesh`` the Cluster's
    ``DeviceMesh`` (None: the single stream on ``device``)."""
    t0 = clock()
    _guard_remote_written(cat, [bound.table.name])
    if plan is None:
        plan = plan_select(cat, bound, direct_limit=settings.planner.direct_gid_limit)
    params = encode_params(cat, bound, param_values)
    with _trace.span("execute") as exec_span:
        if bound.param_specs:
            # deferred pruning: re-derive the shard/interval view of the
            # cached generic plan for THESE parameter values
            with _trace.span("prune"):
                plan = _bind_time_prune(plan, params)
            # window != 0 opts parameterized queries into same-family
            # coalescing (negative = auto-sized from the plan family's
            # arrival rate); at 0 (default) the module is never imported
            # and the serial path below is byte-identical to before
            if settings.executor.megabatch_window_ms != 0:
                from citus_tpu_torch.executor.megabatch import (
                    maybe_megabatch,
                )
                r = maybe_megabatch(cat, bound, settings, plan, params, t0,
                                    exec_span, device)
                if r is not None:
                    return r
        return _execute_select_serial(cat, bound, settings, plan, params,
                                      t0, exec_span, device, mesh)


def _execute_select_serial(cat: Catalog, bound: BoundSelect,
                           settings: Settings, plan: PhysicalPlan, params,
                           t0: float, exec_span, device,
                           mesh=None) -> Result:
    GLOBAL_COUNTERS.bump("queries_executed")
    if plan.is_router:
        GLOBAL_COUNTERS.bump("router_queries")
    elif len(plan.shard_indexes) > 1:
        GLOBAL_COUNTERS.bump("multi_shard_queries")
    # admission control: one device-dispatch slot per executing query
    # (the citus.max_shared_pool_size analog; 0 = unlimited), granted
    # through the tenant-aware fair-share scheduler — router queries
    # are charged to their distribution-key tenant, multi-shard
    # analytics to the shared "*" tenant
    from citus_tpu_torch.transaction.snapshot import snapshot_read
    from citus_tpu_torch.workload import GLOBAL_SCHEDULER, tenant_key
    with GLOBAL_SCHEDULER.slot(settings, tenant_key(plan.router_key),
                               timeout=settings.executor.lock_timeout_s):
        # snapshot read: never blocks behind writers — the scan is
        # validated against the table's flip generation and retried if
        # a multi-file metadata flip overlapped (transaction/snapshot.py)
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
            if bound.has_aggs:
                return _run_agg(cat, run_plan, settings, params, device,
                                mesh)
            return _run_projection(cat, run_plan, settings, params, device)
        rows = snapshot_read(cat.data_dir, bound.table, _attempt,
                             timeout=settings.executor.lock_timeout_s)
    return _finish_select(bound, run_plan, rows, t0, exec_span)


def _finish_select(bound: BoundSelect, plan: PhysicalPlan, rows: list[tuple],
                   t0: float, exec_span, megabatch: Optional[dict] = None
                   ) -> Result:
    """Shared tail of the serial and megabatched paths: ORDER/LIMIT +
    hidden-output trim, result-shape counters, span attrs and the
    explain dict.  Runs on the issuing caller's own thread either way
    (``megabatch`` adds the occupancy attrs)."""
    _trace.set_phase("finalize")
    with _trace.span("finalize"):
        rows = order_and_limit(plan, rows)
        if bound.hidden_outputs:
            keep = len(bound.output_names) - bound.hidden_outputs
            rows = [r[:keep] for r in rows]
    GLOBAL_COUNTERS.bump("rows_returned", len(rows))
    elapsed = clock() - t0
    strategy = plan.group_mode.kind if bound.has_aggs else "projection"
    if exec_span.recording:
        exec_span.set(strategy=strategy,
                      shards=len(plan.shard_indexes),
                      router=bool(plan.is_router), rows=len(rows))
        pipe = plan.runtime_cache.get("pipeline") or {}
        if pipe:
            exec_span.attrs["pipeline"] = dict(pipe)
        if megabatch:
            exec_span.attrs["megabatch"] = dict(megabatch)
    visible = list(bound.output_names)
    if bound.hidden_outputs:
        visible = visible[:len(visible) - bound.hidden_outputs]
    # attribution books the per-execution task logs exactly once (pop,
    # not get): a later execution of this cached plan served from the
    # device cache re-books nothing stale
    task_times = plan.runtime_cache.pop("task_times", [])
    task_bytes = plan.runtime_cache.pop("task_bytes", [])
    remote_tasks = plan.runtime_cache.pop("remote_tasks", [])
    from citus_tpu_torch.observability.load_attribution import (
        GLOBAL_ATTRIBUTION,
    )
    from citus_tpu_torch.workload import tenant_key
    GLOBAL_ATTRIBUTION.book_query(
        bound.table, tenant_key(plan.router_key), task_times, task_bytes,
        len(rows), remote_tasks,
        head_si=plan.shard_indexes[0] if plan.shard_indexes else None)
    explain = {
        "strategy": strategy,
        "shards": len(plan.shard_indexes),
        "router": plan.is_router,
        "intervals": [c.column for c in plan.intervals],
        "elapsed_s": elapsed,
        "tasks": task_times,
        "remote_tasks": remote_tasks,
        "pipeline": plan.runtime_cache.get("pipeline", {}),
        "router_key": plan.router_key,
    }
    if megabatch:
        explain["megabatch"] = dict(megabatch)
    return Result(
        columns=visible,
        rows=rows,
        types=[e.type for e in bound.final_exprs][:len(visible)],
        explain=explain,
    )
