"""Remote task execution: push the worker half of a SELECT to the
coordinator that owns the shard placement, ship back only results.

Reference: the JAX package's ``citus_tpu/executor/worker_tasks.py``,
the analog of Citus's adaptive executor running each shard's worker
query ON the node owning the shard and streaming task results back to
the coordinator (adaptive_executor.c:775, worker_sql_task_protocol.c) —
O(partial-agg bytes) over the wire instead of mirroring the placement's
stripe files (``sync_placement``, the pull path).

Three pieces, each wire-identical to the reference's:

- the task codec: the worker half of a PhysicalPlan (scan columns,
  filter, pruning intervals, group-key domains, partial-agg ops)
  serialized as a compact JSON-safe dict, ``TASK_VERSION`` 3.  Text
  predicates and group keys travel as dictionary ids: dictionaries are
  table-global and authority-mirrored, so ids agree across hosts.
  hash_host GROUP BY ships as a "hash" task whose result is the
  worker's merged device hash table + host-exact spilled entries as
  CTFR frame columns.  Shapes the codec cannot carry (distinct/collect
  partials, sketch states under hash_host, combine-phase expressions)
  return None and take the pull path.
- ``run_worker_task`` — the worker side: rebuild a synthetic
  BoundSelect + PhysicalPlan and run it through this host's own batch
  pipeline on its own device (the ``gpu`` backend: the fold, hash
  insert and predicate kernels; the device cache included), returning
  partial-agg states, the hash table, or filtered projection rows as
  one binary frame.
- ``split_pushable`` / ``note_inexpressible`` — the coordinator side's
  placement split; the fan-out itself is executor/pipeline.py
  ``dispatch_remote_tasks``.  Failures and inexpressible shapes fall
  back to the pull path, governed by ``SET citus.remote_task_execution
  = push|pull|auto``.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from citus_tpu_torch.errors import ExecutionError
from citus_tpu_torch.net.data_plane import encode_partials
from citus_tpu_torch.observability import trace as _trace
from citus_tpu_torch.observability.trace import clock
from citus_tpu_torch.planner import bound as B
from citus_tpu_torch.planner.bind import BoundSelect
from citus_tpu_torch.planner.physical import (
    GroupMode, KeyDomain, PartialOp, PhysicalPlan,
)
from citus_tpu_torch.storage.reader import Interval
from citus_tpu_torch.types import ColumnType

TASK_VERSION = 3

#: partial-op kinds whose cross-host combine is a pure elementwise
#: sum/min/max (combine_partials_host) — the only states worth shipping
_COMBINABLE_KINDS = {"sum", "count", "min", "max", "hll", "ddsk",
                     "topk", "topkv"}

#: partial-op kinds a hash-table SLOT can merge (device entry-merge door
#: and HostGroupAccumulator.merge_partials share these semantics) — the
#: shippable subset for hash_host tasks
_HASH_MERGE_KINDS = {"sum", "count", "min", "max"}


class TaskCodecError(Exception):
    """The plan shape is not expressible as a remote task (internal —
    callers see it as `encode_task` returning None)."""


# ------------------------------------------------------------- codec


def _enc_type(t: ColumnType) -> dict:
    return {"k": t.kind, "p": t.precision, "s": t.scale, "e": t.elem}


def _dec_type(d: dict) -> ColumnType:
    return ColumnType(str(d["k"]), int(d["p"]), int(d["s"]),
                      None if d["e"] is None else str(d["e"]))


def _json_scalar(v):
    """Physical-encoded constants must cross the wire as plain JSON
    numbers; anything else is inexpressible."""
    if v is None or isinstance(v, bool):
        return v
    if isinstance(v, (int, float)):
        return v
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    raise TaskCodecError(f"non-physical constant {type(v).__name__}")


def _enc_param(v):
    """Bind-time constants (BMathFunc.param): nested tuples of scalars.
    Tuples become lists on the wire and back to tuples on decode."""
    if isinstance(v, (tuple, list)):
        return [_enc_param(x) for x in v]
    if isinstance(v, str):
        return v
    return _json_scalar(v)


def _dec_param(v):
    if isinstance(v, list):
        return tuple(_dec_param(x) for x in v)
    return v


def _enc_expr(e: B.BExpr) -> dict:
    if isinstance(e, B.BColumn):
        return {"n": "col", "name": e.name, "t": _enc_type(e.type)}
    if isinstance(e, B.BLiteral):
        return {"n": "lit", "v": _json_scalar(e.value),
                "t": _enc_type(e.type)}
    if isinstance(e, B.BParam):
        return {"n": "param", "i": e.index, "t": _enc_type(e.type),
                "lane": e.lane}
    if isinstance(e, B.BBinOp):
        return {"n": "bin", "op": e.op, "l": _enc_expr(e.left),
                "r": _enc_expr(e.right), "t": _enc_type(e.type)}
    if isinstance(e, B.BUnOp):
        return {"n": "un", "op": e.op, "o": _enc_expr(e.operand),
                "t": _enc_type(e.type)}
    if isinstance(e, B.BScale):
        return {"n": "scale", "o": _enc_expr(e.operand), "p": e.power,
                "t": _enc_type(e.type)}
    if isinstance(e, B.BCast):
        return {"n": "cast", "o": _enc_expr(e.operand),
                "t": _enc_type(e.type)}
    if isinstance(e, B.BIsNull):
        return {"n": "isnull", "o": _enc_expr(e.operand),
                "neg": e.negated}
    if isinstance(e, B.BCase):
        return {"n": "case",
                "whens": [[_enc_expr(c), _enc_expr(v)]
                          for c, v in e.whens],
                "else": None if e.else_ is None else _enc_expr(e.else_),
                "t": _enc_type(e.type)}
    if isinstance(e, B.BDictRemap):
        return {"n": "remap", "o": _enc_expr(e.operand),
                "map": [int(x) for x in e.mapping]}
    if isinstance(e, B.BDictLookup):
        return {"n": "dlookup", "o": _enc_expr(e.operand),
                "tab": [_json_scalar(x) for x in e.table]}
    if isinstance(e, B.BDictMask):
        return {"n": "dmask", "o": _enc_expr(e.operand),
                "mask": [bool(x) for x in e.mask]}
    if isinstance(e, B.BMathFunc):
        return {"n": "math", "name": e.name,
                "ops": [_enc_expr(o) for o in e.operands],
                "t": _enc_type(e.type), "param": _enc_param(e.param)}
    if isinstance(e, B.BDateTrunc):
        return {"n": "dtrunc", "unit": e.unit,
                "o": _enc_expr(e.operand), "t": _enc_type(e.type)}
    if isinstance(e, B.BDateTruncCivil):
        return {"n": "dtruncciv", "unit": e.unit,
                "o": _enc_expr(e.operand), "t": _enc_type(e.type)}
    if isinstance(e, B.BExtract):
        return {"n": "extract", "field": e.field,
                "o": _enc_expr(e.operand)}
    if isinstance(e, B.BAddMonths):
        return {"n": "addmonths", "o": _enc_expr(e.operand),
                "months": e.months, "t": _enc_type(e.type)}
    # BAggRef / BKeyRef belong to the combine/final phase and must
    # never appear in the worker half; anything unknown is a new node
    # the codec does not understand yet — fall back rather than ship a
    # wrong plan
    raise TaskCodecError(f"inexpressible node {type(e).__name__}")


def _dec_expr(d: dict) -> B.BExpr:
    n = d["n"]
    if n == "col":
        return B.BColumn(str(d["name"]), _dec_type(d["t"]))
    if n == "lit":
        return B.BLiteral(d["v"], _dec_type(d["t"]))
    if n == "param":
        return B.BParam(int(d["i"]), _dec_type(d["t"]),
                        str(d.get("lane", "")))
    if n == "bin":
        return B.BBinOp(str(d["op"]), _dec_expr(d["l"]),
                        _dec_expr(d["r"]), _dec_type(d["t"]))
    if n == "un":
        return B.BUnOp(str(d["op"]), _dec_expr(d["o"]), _dec_type(d["t"]))
    if n == "scale":
        return B.BScale(_dec_expr(d["o"]), int(d["p"]), _dec_type(d["t"]))
    if n == "cast":
        return B.BCast(_dec_expr(d["o"]), _dec_type(d["t"]))
    if n == "isnull":
        return B.BIsNull(_dec_expr(d["o"]), bool(d["neg"]))
    if n == "case":
        return B.BCase(tuple((_dec_expr(c), _dec_expr(v))
                             for c, v in d["whens"]),
                       None if d["else"] is None else _dec_expr(d["else"]),
                       _dec_type(d["t"]))
    if n == "remap":
        return B.BDictRemap(_dec_expr(d["o"]),
                            tuple(int(x) for x in d["map"]))
    if n == "dlookup":
        return B.BDictLookup(_dec_expr(d["o"]), tuple(d["tab"]))
    if n == "dmask":
        return B.BDictMask(_dec_expr(d["o"]),
                           tuple(bool(x) for x in d["mask"]))
    if n == "math":
        return B.BMathFunc(str(d["name"]),
                           tuple(_dec_expr(o) for o in d["ops"]),
                           _dec_type(d["t"]), _dec_param(d["param"]))
    if n == "dtrunc":
        return B.BDateTrunc(str(d["unit"]), _dec_expr(d["o"]),
                            _dec_type(d["t"]))
    if n == "dtruncciv":
        return B.BDateTruncCivil(str(d["unit"]), _dec_expr(d["o"]),
                                 _dec_type(d["t"]))
    if n == "extract":
        return B.BExtract(str(d["field"]), _dec_expr(d["o"]))
    if n == "addmonths":
        return B.BAddMonths(_dec_expr(d["o"]), int(d["months"]),
                            _dec_type(d["t"]))
    raise ExecutionError(f"unknown task expression node {n!r}")


def _enc_params(params) -> list:
    """Already-encoded $N values (0-d arrays from encode_params) as
    JSON scalars; text values already resolved to dictionary ids."""
    pcols, pvalids = params
    out = []
    for c, m in zip(pcols, pvalids):
        a = np.asarray(c)
        out.append({"dtype": str(a.dtype), "v": _json_scalar(a.item()),
                    "valid": bool(np.asarray(m).item())})
    return out


def encode_task(plan: PhysicalPlan, params=((), ())) -> Optional[dict]:
    """Shard-independent task template for the worker half of ``plan``
    (the caller adds shard_id/node per placement), or None when the
    codec cannot express the shape — the caller then takes the pull
    path (reference analog: aggregates that cannot be pushed down pull
    worker rows instead, multi_logical_optimizer.c)."""
    try:
        return _encode_task(plan, params)
    except TaskCodecError:
        return None


def _encode_task(plan: PhysicalPlan, params) -> dict:
    from citus_tpu_torch.workload import tenant_key
    bound = plan.bound
    task = {
        "v": TASK_VERSION,
        # tenant attribution rides the wire so the worker's scheduler
        # books whose query its device time served
        "tenant": tenant_key(plan.router_key),
        "table": bound.table.name,
        "table_version": bound.table.version,
        "scan_columns": list(plan.scan_columns),
        "filter": None if bound.filter is None else _enc_expr(bound.filter),
        "intervals": [[iv.column, _json_scalar(iv.lo), _json_scalar(iv.hi),
                       bool(iv.lo_inclusive), bool(iv.hi_inclusive)]
                      for iv in plan.intervals],
        "params": _enc_params(params),
        # logical $N types (uuid spans TWO positional "params" lanes):
        # the worker rebuilds param_specs from these so env names and
        # the plan fingerprint's parameter count match the coordinator
        "param_specs": [_enc_type(pt)
                        for pt, _src in plan.bound.param_specs],
    }
    try:
        task["index_eq"] = (None if plan.index_eq is None else
                            [plan.index_eq[0], _json_scalar(plan.index_eq[1]),
                             plan.index_eq[2]])
    except TaskCodecError:
        task["index_eq"] = None  # index lookup is an optimization only
    if bound.has_aggs:
        gm = plan.group_mode
        if gm.kind in ("scalar", "direct"):
            kind = "agg"
            for op in plan.partial_ops:
                if op.kind not in _COMBINABLE_KINDS or op.extra_args:
                    raise TaskCodecError(f"uncombinable partial {op.kind!r}")
        elif gm.kind == "hash_host":
            # the merged device hash table is fixed-shape arrays: ships
            # whenever every partial state merges slot-wise (exact value
            # sets and sketch registers stay on the pull path)
            kind = "hash"
            for op in plan.partial_ops:
                if op.kind not in _HASH_MERGE_KINDS or op.extra_args:
                    raise TaskCodecError(
                        f"unshippable hash partial {op.kind!r}")
        else:
            raise TaskCodecError(f"unknown group mode {gm.kind!r}")
        task.update({
            "kind": kind,
            "group_keys": [_enc_expr(k) for k in bound.group_keys],
            "agg_args": [_enc_expr(a) for a in plan.agg_args],
            "partial_ops": [[op.kind, op.arg_index, op.dtype]
                            for op in plan.partial_ops],
            "group_mode": {
                "kind": gm.kind,
                "domains": [[int(d.lo), int(d.size), int(d.step)]
                            for d in gm.domains],
                "strides": [int(s) for s in gm.strides],
                "n_groups": int(gm.n_groups)},
        })
        return task
    if not plan.scan_columns:
        raise TaskCodecError("projection without scan columns")
    lim = None
    if bound.limit is not None and not bound.order_by and not bound.distinct:
        # without ORDER BY/DISTINCT any `limit` rows suffice per shard;
        # the coordinator's order_and_limit trims the concatenation
        lim = bound.limit + (bound.offset or 0)
    task.update({"kind": "projection", "limit": lim})
    return task


# ------------------------------------------------- coordinator side


def split_pushable(cat, plan: PhysicalPlan, settings):
    """Partition plan.shard_indexes into (local, remote) where remote
    entries are (shard_index, node, endpoint) for placements hosted
    ONLY on other coordinators.  Policy "pull" keeps everything local
    (the sync_placement path in executor/batches.py serves them)."""
    policy = settings.executor.remote_task_execution
    if policy == "pull" or cat.remote_data is None:
        return list(plan.shard_indexes), []
    local, remote = [], []
    for si in plan.shard_indexes:
        pls = plan.bound.table.shards[si].placements
        ep = None
        if pls and all(cat.is_remote_node(n) for n in pls):
            ep = cat.node_endpoint(pls[0])
        if ep is None:
            local.append(si)
        else:
            remote.append((si, pls[0], ep))
    return local, remote


def note_inexpressible(cat, plan: PhysicalPlan, settings) -> None:
    """Account would-be pushes for plan shapes the executor never even
    offers to the codec (exact value-set partials, cpu-oracle hash
    grouping): each remote-only shard counts as a fallback so the stat
    views show the pull traffic's cause."""
    from citus_tpu_torch.executor.executor import GLOBAL_COUNTERS
    _, remote = split_pushable(cat, plan, settings)
    if remote:
        GLOBAL_COUNTERS.bump("remote_task_fallbacks", len(remote))
    plan.runtime_cache["remote_tasks"] = []
    plan.runtime_cache["pipeline"] = {}


# ------------------------------------------------------ worker side


def _decode_plan(t, p: dict, shard_index: int):
    """Rebuild the synthetic BoundSelect + PhysicalPlan for one task."""
    filter_ = None if p["filter"] is None else _dec_expr(p["filter"])
    # logical specs travel in the task: a uuid spec owns two entries of
    # p["params"] (hi + lo lanes), so param_env_names on this side
    # yields the same env layout encode_params produced on the pusher
    param_specs = [(_dec_type(d), "task")
                   for d in p.get("param_specs", [])]
    if p["kind"] in ("agg", "hash"):
        group_keys = [_dec_expr(k) for k in p["group_keys"]]
        agg_args = [_dec_expr(a) for a in p["agg_args"]]
        partial_ops = [PartialOp(str(k), int(ai), str(dt))
                       for k, ai, dt in p["partial_ops"]]
        gm = p["group_mode"]
        group_mode = GroupMode(
            kind=str(gm["kind"]),
            domains=[KeyDomain(int(lo), int(size), int(step))
                     for lo, size, step in gm["domains"]],
            strides=[int(s) for s in gm["strides"]],
            n_groups=int(gm["n_groups"]))
    else:
        group_keys, agg_args, partial_ops = [], [], []
        group_mode = GroupMode(kind="scalar")
    bound = BoundSelect(
        table=t, filter=filter_, group_keys=group_keys, aggs=[],
        final_exprs=[], output_names=[], having=None, order_by=[],
        limit=None, offset=None, distinct=False,
        param_specs=param_specs)
    intervals = [Interval(str(c), lo, hi, bool(li), bool(hi_inc))
                 for c, lo, hi, li, hi_inc in p.get("intervals", [])]
    index_eq = p.get("index_eq")
    plan = PhysicalPlan(
        bound=bound, scan_columns=[str(c) for c in p["scan_columns"]],
        intervals=intervals, shard_indexes=[shard_index],
        group_mode=group_mode, agg_args=agg_args,
        partial_ops=partial_ops, agg_extract=[],
        index_eq=None if index_eq is None else tuple(index_eq),
        table_shard_count=len(t.shards))
    pcols, pvalids = [], []
    for spec in p.get("params", []):
        dt = np.dtype(str(spec["dtype"]))
        pcols.append(np.asarray(0 if spec["v"] is None else spec["v"], dt))
        pvalids.append(np.asarray(bool(spec["valid"])))
    return plan, (tuple(pcols), tuple(pvalids))


def _run_task_projection(cat, plan: PhysicalPlan, settings, params,
                         limit: Optional[int], device):
    """Scan + filter + compact one shard, returning physical column
    arrays (values, validity, n_rows).  The WHERE runs as the
    coordinator's own projection scan runs it: on the ``gpu`` backend one
    generated ``filter_mask`` launch per batch."""
    from citus_tpu_torch.executor.executor import (
        _host_batches, _params_env, _ProjectionMask,
    )
    t = plan.bound.table
    penv = _params_env(plan, params)
    masker = _ProjectionMask(plan, settings, params, device)
    vals: dict = {c: [] for c in plan.scan_columns}
    masks_out: dict = {c: [] for c in plan.scan_columns}
    total = 0
    for cols, valids, n in _host_batches(cat, plan):
        env = dict(zip(plan.scan_columns, zip(cols, valids)))
        env.update(penv)
        idx = np.nonzero(masker(env, n))[0]
        if idx.size == 0:
            continue
        for i, c in enumerate(plan.scan_columns):
            vals[c].append(cols[i][idx])
            masks_out[c].append(np.asarray(valids[i])[idx])
        total += idx.size
        if limit is not None and total >= limit:
            break
    values_out, validity_out = {}, {}
    for c in plan.scan_columns:
        dt = t.schema.scan_dtype(c, device=True)
        values_out[c] = (np.concatenate(vals[c]) if vals[c]
                         else np.zeros(0, dt))
        validity_out[c] = (np.concatenate(masks_out[c]) if masks_out[c]
                           else np.zeros(0, bool))
    return values_out, validity_out, total


def run_worker_task(cluster, p: dict) -> tuple[dict, bytes]:
    """Execute one pushed task against a locally-hosted placement.

    Returns (meta, blob): for agg tasks the blob holds the partial
    states (a__0..a__N in partial-op order, plus the trailing group-row
    counts in direct mode); for hash tasks an encode_hash_partials frame
    (merged device hash table + host-exact spilled entries); for
    projection tasks an encode_batch of the filtered scan columns.  The
    task's "wire" key (the PUSHING coordinator's citus.wire_format)
    picks the codec — columnar frame by default, npz when absent.
    Raising here surfaces as an RpcError at the coordinator, which falls
    back to the pull path for this shard.

    It runs on an RPC server thread: on a card, the thread is bound to
    the Cluster's device, and the kernels launch on that device's
    current stream."""
    if cluster.device.type != "cuda":
        return _run_worker_task(cluster, p)
    import torch
    with torch.cuda.device(cluster.device):
        return _run_worker_task(cluster, p)


def _run_worker_task(cluster, p: dict) -> tuple[dict, bytes]:
    from citus_tpu_torch.executor.executor import (
        _run_partials_cpu, _run_partials_device,
    )
    t0 = clock()
    if int(p.get("v", -1)) != TASK_VERSION:
        raise ExecutionError(
            f"task version {p.get('v')!r} != {TASK_VERSION}")
    name = str(p["table"])
    version = int(p["table_version"])
    cat = cluster.catalog
    if not cat.has_table(name) or cat.table(name).version != version:
        # the pushing coordinator may run ahead of our catalog mirror
        cluster._maybe_reload_catalog(force_sync=True)
        cat = cluster.catalog
    if not cat.has_table(name):
        raise ExecutionError(f"unknown table {name!r} in pushed task")
    t = cat.table(name)
    if t.version != version:
        raise ExecutionError(
            f"table {name!r} version skew: task has {version}, "
            f"catalog has {t.version}")
    shard_id = int(p["shard_id"])
    node = int(p["node"])
    si = next((i for i, s in enumerate(t.shards)
               if s.shard_id == shard_id), None)
    if si is None:
        raise ExecutionError(f"unknown shard {shard_id} of {name!r}")
    if cat.is_remote_node(node):
        raise ExecutionError(
            f"placement {shard_id}@{node} is not hosted here")
    plan, params = _decode_plan(t, p, si)
    settings = cluster.settings
    from citus_tpu_torch.transaction.snapshot import snapshot_read
    wire = str(p.get("wire", "npz"))
    n_rows = 0
    device = cluster.device
    if p["kind"] == "agg":
        backend = settings.executor.task_executor_backend
        run = _run_partials_cpu if backend == "cpu" else _run_partials_device

        def _attempt():
            return run(cat, plan, settings, params, device, cluster.mesh)
        with _trace.span("worker_scan", shard_id=shard_id, kind="agg"):
            partials = snapshot_read(
                cat.data_dir, t, _attempt,
                timeout=settings.executor.lock_timeout_s)
        with _trace.span("worker_encode"):
            blob = encode_partials(partials, wire)
    elif p["kind"] == "hash":
        from citus_tpu_torch.executor.executor import _run_hash_partial_state
        from citus_tpu_torch.net.data_plane import encode_hash_partials

        def _attempt():
            return _run_hash_partial_state(cat, plan, settings, params,
                                           device)
        with _trace.span("worker_scan", shard_id=shard_id, kind="hash"):
            table, spilled = snapshot_read(
                cat.data_dir, t, _attempt,
                timeout=settings.executor.lock_timeout_s)
        with _trace.span("worker_encode"):
            blob = encode_hash_partials(table, spilled, wire)
    else:
        def _attempt():
            return _run_task_projection(cat, plan, settings, params,
                                        p.get("limit"), device)
        with _trace.span("worker_scan", shard_id=shard_id, kind="projection"):
            values, validity, n_rows = snapshot_read(
                cat.data_dir, t, _attempt,
                timeout=settings.executor.lock_timeout_s)
        from citus_tpu_torch.net.data_plane import encode_batch
        with _trace.span("worker_encode"):
            blob = encode_batch(values, validity, wire)
    stripe_bytes = 0
    d = cat.shard_dir(name, shard_id, node)
    if os.path.isdir(d):
        for fn in os.listdir(d):
            fp = os.path.join(d, fn)
            if os.path.isfile(fp):
                stripe_bytes += os.path.getsize(fp)
    # pushed-execution attribution: the placement's own host books the
    # device work its scan did (popped from the inner run's task logs,
    # so the worker-local ledger stays balanced against the worker's
    # own bytes_scanned counter); query/row counts stay with the
    # pushing coordinator — they are booked once at its _finish_select
    from citus_tpu_torch.observability.load_attribution import GLOBAL_ATTRIBUTION
    att_times = plan.runtime_cache.pop("task_times", [])
    att_bytes = plan.runtime_cache.pop("task_bytes", [])
    dev_ms = sum(s for _si, _n, s in att_times) * 1000.0
    if not att_times:
        dev_ms = (clock() - t0) * 1000.0  # host-only task: wall fallback
    GLOBAL_ATTRIBUTION.book(name, shard_id, node, str(p.get("tenant", "*")),
                            device_ms=dev_ms,
                            bytes_scanned=sum(b for _si, b in att_bytes))
    meta = {"ok": True, "node": node, "n_rows": int(n_rows),
            "stripe_bytes": int(stripe_bytes),
            "elapsed_s": clock() - t0}
    return meta, blob
