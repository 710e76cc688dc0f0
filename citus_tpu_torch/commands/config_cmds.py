"""SET/SHOW (GUC analog) for the settings the port's slice reads.

Reference: the ~139 citus.* GUCs (shared_library_init.c:980+).  The
port accepts the GUCs its slices read; the others of the JAX
package's table are not ported yet (ROADMAP.md queue A).  Settings
apply to this Cluster handle.
"""

from __future__ import annotations

import dataclasses

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
    "citus.shard_count": ("sharding", "shard_count", int),
    "citus.shard_replication_factor": ("sharding", "shard_replication_factor", int),
    "lock_timeout": ("executor", "lock_timeout_s", _ms_duration),
}


def _guc_key(name: str) -> str:
    name = name.lower()
    for key in (name, f"citus.{name}"):
        if key in _GUCS:
            return key
    raise UnsupportedFeatureError(
        f'configuration parameter "{name}" is not ported yet '
        "(ROADMAP.md queue A)")


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
    cl._plan_cache.clear()  # backend/knob changes invalidate plans
    return Result(columns=[], rows=[])


@handles(A.ShowConfig)
def execute_show(cl, stmt: A.ShowConfig) -> Result:
    if stmt.name == "all":
        return Result(columns=["name", "setting"],
                      rows=[(k, _guc_value(cl, k)) for k in sorted(_GUCS)])
    key = _guc_key(stmt.name)
    return Result(columns=[stmt.name], rows=[(_guc_value(cl, key),)])
