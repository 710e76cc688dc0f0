"""SET/SHOW (GUC analog) for the settings the port's slice reads,
RETURNING evaluation, ANALYZE, REINDEX and extended-statistics
ndistinct.

Reference: the ~139 citus.* GUCs (shared_library_init.c:980+);
commands/vacuum.c ANALYZE; commands/index.c REINDEX.  The port accepts
the GUCs its slices read; the others of the JAX package's table are
not ported yet (ROADMAP.md A14c-2).  Settings apply to this Cluster
handle.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from citus_tpu_torch.commands.registry import handles
from citus_tpu_torch.errors import CatalogError, UnsupportedFeatureError
from citus_tpu_torch.executor import Result
from citus_tpu_torch.planner import ast as A


def _backend(v) -> str:
    """citus.task_executor_backend = cpu (numpy oracle) | gpu (torch on
    the Cluster's device)."""
    s = str(v).lower()
    if s not in ("cpu", "gpu"):
        raise ValueError(s)
    return s


def _plan_cache_mode(v) -> str:
    s = str(v).lower()
    if s not in ("auto", "force_generic", "force_custom"):
        raise ValueError(s)
    return s


def _ms_duration(v) -> float:
    """bare numbers are milliseconds (PostgreSQL); 's'/'ms' suffixes."""
    s = str(v).strip().lower()
    if s.endswith("ms"):
        return float(s[:-2]) / 1000.0
    if s.endswith("s"):
        return float(s[:-1])
    return float(s) / 1000.0


def _hash_slots(v) -> int:
    """citus.hash_agg_slots = <slots> | auto (stored as 0: sized from
    catalog row-count stats at execution)."""
    if str(v).lower() == "auto":
        return 0
    n = int(v)
    if n < 0:
        raise ValueError(v)
    return n


def _bool(v) -> bool:
    """PostgreSQL boolean spellings."""
    if isinstance(v, bool):
        return v
    s = str(v).lower()
    if s in ("true", "on", "1", "yes"):
        return True
    if s in ("false", "off", "0", "no"):
        return False
    raise ValueError(s)


def _percentile_backend(v) -> str:
    """citus.percentile_backend = ddsketch | tdigest (the sketch kind
    approx_percentile rollup columns store, rollup/sketches.py)."""
    s = str(v).lower()
    if s not in ("ddsketch", "tdigest"):
        raise ValueError(s)
    return s


def _remote_task_mode(v) -> str:
    """citus.remote_task_execution = push | pull | auto: whether the
    worker half of a query runs where a remote-only placement lives
    (push, executor/worker_tasks.py) or the placement's files are
    mirrored here (pull)."""
    s = str(v).lower()
    if s not in ("push", "pull", "auto"):
        raise ValueError(s)
    return s


def _wire_format(v) -> str:
    """citus.wire_format = frame | npz (net/data_plane.py codecs)."""
    s = str(v).lower()
    if s not in ("frame", "npz"):
        raise ValueError(s)
    return s


def _window_ms(v) -> float:
    """citus.megabatch_window_ms = <ms> | auto (stored as -1)."""
    if str(v).lower() == "auto":
        return -1.0
    return float(v)


#: GUC name -> (settings section, field, coercion)
_GUCS = {
    "citus.task_executor_backend": ("executor", "task_executor_backend", _backend),
    "citus.max_tasks_in_flight": ("executor", "max_tasks_in_flight", int),
    "citus.executor_prefetch_depth": ("executor", "executor_prefetch_depth", int),
    "citus.executor_min_batch_rows": ("executor", "min_batch_rows", int),
    "citus.kernel_cache_size": ("executor", "kernel_cache_size", int),
    "citus.plan_cache_mode": ("planner", "plan_cache_mode", _plan_cache_mode),
    "citus.direct_gid_limit": ("planner", "direct_gid_limit", int),
    "citus.hash_agg_slots": ("planner", "hash_agg_slots", _hash_slots),
    "citus.max_shared_pool_size": ("executor", "max_shared_pool_size", int),
    # same-family query coalescing (executor/megabatch.py): dispatch
    # window in ms (0 = off, auto = sized from the family's arrival
    # rate) and the most queries one dispatch carries
    "citus.megabatch_window_ms": ("executor", "megabatch_window_ms", _window_ms),
    "citus.megabatch_max_size": ("executor", "megabatch_max_size", int),
    # tenant-aware admission defaults (workload/scheduler.py)
    "citus.tenant_default_weight": ("workload", "tenant_default_weight", float),
    "citus.tenant_queue_depth": ("workload", "tenant_queue_depth", int),
    "citus.tenant_rate_limit_qps": ("workload", "tenant_rate_limit_qps", float),
    "citus.tenant_default_priority_class": ("workload",
                                            "tenant_default_priority_class",
                                            str),
    # continuous aggregation (rollup/): refresh-loop cadence (ms; 0 =
    # loop off, refresh via citus_refresh_rollups()), percentile sketch
    # backend for NEW rollups, the per-batch source-row bound, routing
    "citus.rollup_refresh_interval_ms": ("rollup",
                                         "rollup_refresh_interval_ms",
                                         float),
    "citus.percentile_backend": ("rollup", "percentile_backend",
                                 _percentile_backend),
    "citus.rollup_max_batch_rows": ("rollup", "rollup_max_batch_rows",
                                    int),
    "citus.enable_rollup_routing": ("rollup", "enable_rollup_routing",
                                    _bool),
    # change data capture (cdc.py): every table's changes go to its
    # stream (publications cover single tables)
    "citus.enable_change_data_capture": (None, "enable_change_data_capture",
                                         _bool),
    # several coordinators (net/, executor/worker_tasks.py): push or
    # pull remote-only placements, and the wire codec of pushed results
    "citus.remote_task_execution": ("executor", "remote_task_execution",
                                    _remote_task_mode),
    "citus.wire_format": ("executor", "wire_format", _wire_format),
    "citus.shard_count": ("sharding", "shard_count", int),
    "citus.shard_replication_factor": ("sharding", "shard_replication_factor", int),
    # joins (executor/join_executor.py): repartition or pull, and the
    # host buckets of the cpu backend's shuffle
    "citus.enable_repartition_joins": ("planner", "enable_repartition_joins",
                                       _bool),
    "citus.repartition_bucket_count_per_device": (
        "planner", "repartition_bucket_count_per_device", int),
    # non-blocking shard moves (operations/shard_transfer.py): lag bar
    # the catch-up loop must get under before taking the write lock,
    # the bound on catch-up rounds, and whether the source placement
    # drop is deferred to the cleaner or done inline after the flip
    "citus.shard_move_catchup_threshold": (
        "sharding", "shard_move_catchup_threshold", int),
    "citus.shard_move_max_catchup_rounds": (
        "sharding", "shard_move_max_catchup_rounds", int),
    "citus.defer_drop_after_shard_move": (
        "sharding", "defer_drop_after_shard_move", _bool),
    # the maintenance daemon (services/maintenance.py) and its duties'
    # intervals (seconds)
    "citus.start_maintenance_daemon": (None, "start_maintenance_daemon",
                                       _bool),
    "citus.distributed_deadlock_detection_interval": (
        None, "deadlock_detection_interval_s", float),
    "citus.authority_watch_interval": (None, "authority_watch_interval_s",
                                       float),
    # multi-coordinator metadata sync (metadata/sync.py): background
    # pull-on-mismatch cadence (ms; 0 = loop off) and the
    # incremental-sync master switch
    "citus.metadata_sync_interval_ms": ("metadata",
                                        "metadata_sync_interval_ms", float),
    "citus.enable_metadata_sync": ("metadata", "enable_metadata_sync",
                                   _bool),
    "lock_timeout": ("executor", "lock_timeout_s", _ms_duration),
}


def _guc_key(name: str) -> str:
    name = name.lower()
    for key in (name, f"citus.{name}"):
        if key in _GUCS:
            return key
    raise UnsupportedFeatureError(
        f'configuration parameter "{name}" is not ported yet '
        "(ROADMAP.md A14c-2)")


def _guc_value(cl, key: str) -> str:
    section, field_, coerce = _GUCS[key]
    v = getattr(cl.settings, field_) if section is None \
        else getattr(getattr(cl.settings, section), field_)
    if coerce is _ms_duration:
        return f"{v * 1000:g}ms"
    if isinstance(v, bool):
        return "on" if v else "off"  # PostgreSQL boolean rendering
    return str(v)


@handles(A.SetConfig)
def execute_set(cl, stmt: A.SetConfig) -> Result:
    key = _guc_key(stmt.name)
    section, field_, coerce = _GUCS[key]
    try:
        v = coerce(stmt.value)
    except (TypeError, ValueError):
        raise CatalogError(
            f'invalid value for parameter "{stmt.name}": {stmt.value!r}')
    from citus_tpu_torch.storage.overlay import current_overlay
    txn = current_overlay()
    if txn is not None:
        # PostgreSQL: a non-LOCAL SET is undone if the transaction aborts
        prev_settings, prev_cdc = cl.settings, cl.cdc.enabled

        def _restore(prev_settings=prev_settings, prev_cdc=prev_cdc):
            cl.settings = prev_settings
            cl.cdc.enabled = prev_cdc
            cl._plan_cache.clear()
        txn.on_rollback.append(_restore)
    if section is None:
        cl.settings = dataclasses.replace(cl.settings, **{field_: v})
    else:
        sec = dataclasses.replace(getattr(cl.settings, section),
                                  **{field_: v})
        cl.settings = dataclasses.replace(cl.settings, **{section: sec})
    if key == "citus.kernel_cache_size":
        from citus_tpu_torch.executor.kernel_cache import GLOBAL_KERNELS
        GLOBAL_KERNELS.set_capacity(int(v))
    elif key == "citus.enable_change_data_capture":
        cl.cdc.enabled = bool(v)
    elif key == "citus.rollup_refresh_interval_ms":
        cl.rollup_manager.apply()  # start/stop the refresh loop
    elif key in ("citus.metadata_sync_interval_ms",
                 "citus.enable_metadata_sync"):
        cl.metadata_sync.apply()  # start/stop the sync loop to match
    cl._plan_cache.clear()  # backend/knob changes invalidate plans
    return Result(columns=[], rows=[])


@handles(A.ShowConfig)
def execute_show(cl, stmt: A.ShowConfig) -> Result:
    if stmt.name == "all":
        return Result(columns=["name", "setting"],
                      rows=[(k, _guc_value(cl, k)) for k in sorted(_GUCS)])
    key = _guc_key(stmt.name)
    return Result(columns=[stmt.name], rows=[(_guc_value(cl, key),)])


def _returning_result(cl, table_name, where, items, subst=None):
    """Evaluate a RETURNING clause as a distributed SELECT over the
    affected rows (pre-image WHERE); for UPDATE, assignment
    expressions are substituted into the items so the NEW values are
    returned (reference: adaptive_executor.c DML RETURNING tuples)."""
    from citus_tpu_torch.cluster import _eval_const, _expand_returning_items
    t = cl.catalog.table(table_name)
    expanded = _expand_returning_items(t, items, subst)
    # constant items (e.g. SET c = 'z' substituted into RETURNING c)
    # cannot ride the distributed select: fold them on the host and
    # splice one copy per affected row
    consts, sel_items = {}, []
    for idx, (e, alias) in enumerate(expanded):
        try:
            consts[idx] = _eval_const(e)
        except Exception:  # noqa: BLE001 -- not a constant: selected below
            sel_items.append((idx, A.SelectItem(e, alias)))
    if sel_items:
        inner = cl._execute_stmt(A.Select(
            [si for _, si in sel_items], A.TableRef(table_name), where))
        inner_rows = inner.rows
    else:
        cnt = A.Select([A.SelectItem(A.FuncCall("count", (A.Star(),)))],
                       A.TableRef(table_name), where)
        nrows = int(cl._execute_stmt(cnt).rows[0][0] or 0)
        inner_rows = [()] * nrows
    rows = []
    for r in inner_rows:
        full, j = [None] * len(expanded), 0
        for idx in range(len(expanded)):
            if idx in consts:
                full[idx] = consts[idx]
            else:
                full[idx] = r[j]
                j += 1
        rows.append(tuple(full))
    return Result(columns=[a for _, a in expanded], rows=rows)


def _compute_ndistinct(cl, table: str, columns: list) -> int:
    """count(DISTINCT (cols)) — the extended-statistics ndistinct."""
    sel = A.Select(
        [A.SelectItem(A.FuncCall("count", (A.Star(),)))],
        A.SubqueryRef(A.Select(
            [A.SelectItem(A.ColumnRef(c)) for c in columns],
            A.TableRef(table), distinct=True), "d"))
    return int(cl._execute_stmt(sel).rows[0][0])


def _execute_analyze(cl, table: Optional[str]) -> Result:
    """ANALYZE [table]: recompute extended-statistics ndistinct
    (column min/max stats are always skip-list-live here, so there
    is no per-column histogram pass to run)."""
    if table is not None:
        cl.catalog.table(table)  # PostgreSQL: unknown relation errors
    refreshed = 0
    for name, st in cl.catalog.statistics.items():
        if table is not None and st["table"] != table:
            continue
        if not cl.catalog.has_table(st["table"]):
            continue
        st["ndistinct"] = _compute_ndistinct(cl, st["table"], st["columns"])
        refreshed += 1
    if refreshed:
        cl.catalog.commit()
    return Result(columns=[], rows=[],
                  explain={"statistics_refreshed": refreshed})


def _execute_reindex(cl, stmt: A.Reindex) -> Result:
    """REINDEX INDEX name | REINDEX TABLE name: rebuild segment
    files from the stripe data (recovers from lost/corrupted
    segments; a missing segment is only a slow path, never wrong)."""
    from citus_tpu_torch.storage.index import backfill_index
    from citus_tpu_torch.transaction.locks import EXCLUSIVE
    if stmt.kind == "index":
        t, ix = cl._find_index(stmt.name)
        if ix is None:
            raise CatalogError(f'index "{stmt.name}" does not exist')
        targets = [(t, [ix["column"]])]
    else:
        t = cl.catalog.table(stmt.name)
        if t.is_partitioned:
            targets = [(p, p.index_columns)
                       for p in cl.catalog.partitions_of(t.name)
                       if p.indexes]
        else:
            targets = [(t, t.index_columns)] if t.indexes else []
    rebuilt = 0
    for tt, cols in targets:
        with cl._write_lock(tt, EXCLUSIVE):
            for col in cols:
                cl._drop_index_segments(tt, col)
            rebuilt += backfill_index(cl.catalog, tt, list(cols))
            tt.version += 1
    if targets:
        cl.catalog.ddl_epoch += 1
        cl.catalog.commit()
        for tt, _cols in targets:
            cl._plan_cache.invalidate_table(tt.name)
    return Result(columns=[], rows=[],
                  explain={"segments_rebuilt": rebuilt})
