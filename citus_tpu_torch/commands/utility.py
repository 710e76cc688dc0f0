"""UDF-style admin calls (``SELECT create_distributed_table(...)``).

Reference: the UDFs under src/backend/distributed/sql/udfs/.  The port
carries create_distributed_table and the stat views of its slices
(counters, statements, tenants, the admission pool, megabatching); the
other utilities are not ported yet (ROADMAP.md queue A).
"""

from __future__ import annotations

from citus_tpu_torch.commands.registry import UTILITY_HANDLERS, utility
from citus_tpu_torch.errors import UnsupportedFeatureError
from citus_tpu_torch.executor import Result


def execute_utility(cl, stmt) -> Result:
    fn = UTILITY_HANDLERS.get(stmt.name)
    if fn is None:
        raise UnsupportedFeatureError(
            f"utility {stmt.name}() is not ported yet (ROADMAP.md queue A)")
    return fn(cl, stmt.name, stmt.args)


@utility("create_distributed_table")
def _create_distributed_table(cl, name, args):
    shard_count = int(args[2]) if len(args) > 2 else None
    cl.create_distributed_table(args[0], args[1], shard_count)
    return Result(columns=[name], rows=[(None,)])


# ------------------------------------------------------- stats/monitoring

@utility("citus_stat_pool")
def _citus_stat_pool(cl, name, args):
    # shared task-pool admission counters (the citus.max_shared_pool_size
    # / shared_connection_stats view)
    from citus_tpu_torch.executor.admission import GLOBAL_POOL
    st = GLOBAL_POOL.stats()
    st["pool_size"] = cl.settings.executor.max_shared_pool_size
    cols = ["pool_size", "in_use", "high_water", "granted",
            "denied_optional", "waits", "coalesced", "timeouts"]
    return Result(columns=cols, rows=[tuple(st[c] for c in cols)])


@utility("citus_megabatch_stats")
def _citus_megabatch_stats(cl, name, args):
    # same-family coalescing view (executor/megabatch.py): dispatch and
    # occupancy accounting next to the knobs that shape it; the port
    # adds the shard batches dispatched and the ineligibility reasons
    from citus_tpu_torch.executor.megabatch import GLOBAL_MEGABATCH
    st = GLOBAL_MEGABATCH.stats()

    def _hist(h: dict) -> str:
        return ", ".join(f"{k}:{v}" for k, v in sorted(h.items()))
    ex = cl.settings.executor
    return Result(
        columns=["window_ms", "max_size", "batches", "queries",
                 "fallbacks", "avg_occupancy", "occupancy_hist",
                 "query_occupancy_hist", "dispatches", "ineligible"],
        rows=[(ex.megabatch_window_ms, ex.megabatch_max_size,
               st["batches"], st["queries"], st["fallbacks"],
               round(st["avg_occupancy"], 2),
               _hist(st["occupancy_hist"]),
               _hist(st["query_occupancy_hist"]), st["dispatches"],
               _hist(st["ineligible"]))])


@utility("citus_stat_counters")
def _citus_stat_counters(cl, name, args):
    snap = cl.counters.snapshot()
    return Result(columns=["counter", "value"], rows=sorted(snap.items()))


@utility("citus_stat_counters_reset")
def _citus_stat_counters_reset(cl, name, args):
    # one observability reset: counters zero, then their reset hooks,
    # then the per-family latency histograms drop
    cl.counters.reset()
    cl.query_stats.reset()
    return Result(columns=[name], rows=[(None,)])


@utility("citus_stat_statements")
def _citus_stat_statements(cl, name, args):
    return Result(columns=["query", "executor", "partition_key",
                           "calls", "total_time_ms", "rows",
                           "p50_ms", "p95_ms", "p99_ms"],
                  rows=cl.query_stats.rows_view())


@utility("citus_stat_statements_reset")
def _citus_stat_statements_reset(cl, name, args):
    cl.query_stats.reset()
    return Result(columns=[name], rows=[(None,)])


@utility("citus_stat_tenants")
def _citus_stat_tenants(cl, name, args):
    # live view: the 60 s sliding window (router attribution) joined
    # with the workload scheduler's admission accounting and latency
    # percentiles; "*" is the shared class (multi-shard analytics)
    from citus_tpu_torch.workload import GLOBAL_SCHEDULER
    window = {r[0]: r for r in cl.tenant_stats.rows_view()}
    sched = {r[0]: r for r in GLOBAL_SCHEDULER.rows_view()}
    rows = []
    for t in set(window) | set(sched):
        _, qc, tt = window.get(t, (t, 0, 0.0))
        (_, running, queued, granted, shed, coalesced, remote,
         p50, p99) = sched.get(t, (t, 0, 0, 0, 0, 0, 0, 0.0, 0.0))
        rows.append((t, qc, tt, running, queued, granted, shed,
                     coalesced, remote, p50, p99))
    rows.sort(key=lambda r: (-r[5], -r[1], str(r[0])))
    return Result(columns=["tenant", "query_count", "total_time_ms",
                           "running", "queued", "granted", "shed",
                           "coalesced", "remote_tasks", "p50_ms",
                           "p99_ms"],
                  rows=rows)
