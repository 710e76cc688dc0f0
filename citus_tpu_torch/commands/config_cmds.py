"""SET/SHOW (GUC analog) for the settings the port's slice reads.

Reference: the ~139 citus.* GUCs (shared_library_init.c:980+).  The
port accepts the GUCs its first slice reads; the others of the JAX
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


#: GUC name -> (settings section, field, coercion)
_GUCS = {
    "citus.task_executor_backend": ("executor", "task_executor_backend", _backend),
    "citus.max_tasks_in_flight": ("executor", "max_tasks_in_flight", int),
    "citus.executor_prefetch_depth": ("executor", "executor_prefetch_depth", int),
    "citus.executor_min_batch_rows": ("executor", "min_batch_rows", int),
    "citus.kernel_cache_size": ("executor", "kernel_cache_size", int),
    "citus.plan_cache_mode": ("planner", "plan_cache_mode", _plan_cache_mode),
    "citus.direct_gid_limit": ("planner", "direct_gid_limit", int),
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
    v = getattr(getattr(cl.settings, section), field_)
    if coerce is _ms_duration:
        return f"{v * 1000:g}ms"
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
    sec = dataclasses.replace(getattr(cl.settings, section), **{field_: v})
    cl.settings = dataclasses.replace(cl.settings, **{section: sec})
    if key == "citus.kernel_cache_size":
        from citus_tpu_torch.executor.kernel_cache import GLOBAL_KERNELS
        GLOBAL_KERNELS.set_capacity(int(v))
    cl._plan_cache.clear()  # backend/knob changes invalidate plans
    return Result(columns=[], rows=[])


@handles(A.ShowConfig)
def execute_show(cl, stmt: A.ShowConfig) -> Result:
    if stmt.name == "all":
        return Result(columns=["name", "setting"],
                      rows=[(k, _guc_value(cl, k)) for k in sorted(_GUCS)])
    key = _guc_key(stmt.name)
    return Result(columns=[stmt.name], rows=[(_guc_value(cl, key),)])
