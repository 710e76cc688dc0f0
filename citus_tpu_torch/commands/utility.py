"""UDF-style admin calls (``SELECT create_distributed_table(...)``).

Reference: the UDFs under src/backend/distributed/sql/udfs/.  The port
carries create_distributed_table, the rollup calls (create, drop,
refresh, the citus_rollups() view), the stat views of its slices
(counters, statements, tenants, the admission pool, megabatching, the
data plane's transfers), node topology (citus_add_node,
citus_remove_node), the replicated tenant quotas, the time-partition
helpers (create_time_partitions, drop_old_time_partitions,
time_partitions), sequences (nextval, currval, setval,
citus_sequences), the catalog-object inventories (citus_extensions,
citus_domains, citus_collations, citus_publications,
citus_statistics_objects, citus_types, citus_views, citus_schemas),
run_command_on_shards / _placements,
master_get_table_ddl_events, and the redistributions
undistribute_table and alter_distributed_table (refused, naming
ROADMAP.md A13, for a table with shards another coordinator hosts); the
other utilities are not ported yet (ROADMAP.md A13 for
recover_prepared_transactions, A14b for the inventories of roles,
grants, policies, triggers and text-search configurations, A14c for
the rest).
"""

from __future__ import annotations

from citus_tpu_torch.commands.registry import UTILITY_HANDLERS, utility
from citus_tpu_torch.errors import UnsupportedFeatureError
from citus_tpu_torch.executor import Result


#: the unported UDFs of cross-host transactions (ROADMAP.md A13) and of
#: roles, row-level security and triggers (A14b); the rest are
#: operations, services and observability (A14c)
_CROSS_HOST_UTILITIES = frozenset({"recover_prepared_transactions"})
_RLS_UTILITIES = frozenset({"citus_roles", "citus_grants", "citus_policies",
                            "citus_triggers", "citus_text_search_configs"})


def execute_utility(cl, stmt) -> Result:
    fn = UTILITY_HANDLERS.get(stmt.name)
    if fn is None:
        item = "A13" if stmt.name in _CROSS_HOST_UTILITIES else \
            "A14b" if stmt.name in _RLS_UTILITIES else "A14c"
        raise UnsupportedFeatureError(
            f"utility {stmt.name}() is not ported yet (ROADMAP.md {item})")
    return fn(cl, stmt.name, stmt.args)


@utility("create_distributed_table")
def _create_distributed_table(cl, name, args):
    shard_count = int(args[2]) if len(args) > 2 else None
    cl.create_distributed_table(args[0], args[1], shard_count)
    return Result(columns=[name], rows=[(None,)])


@utility("create_reference_table")
def _create_reference_table(cl, name, args):
    cl.create_reference_table(args[0])
    return Result(columns=[name], rows=[(None,)])


@utility("create_time_partitions")
def _create_time_partitions(cl, name, args):
    from citus_tpu_torch.partitioning import create_time_partitions
    n = create_time_partitions(
        cl, args[0], args[1], args[2],
        args[3] if len(args) > 3 else None)
    return Result(columns=[name], rows=[(n > 0,)],
                  explain={"partitions_created": n})


@utility("drop_old_time_partitions")
def _drop_old_time_partitions(cl, name, args):
    from citus_tpu_torch.partitioning import drop_old_time_partitions
    n = drop_old_time_partitions(cl, args[0], args[1])
    return Result(columns=[name], rows=[(n,)],
                  explain={"partitions_dropped": n})


@utility("time_partitions")
def _time_partitions(cl, name, args):
    # the time_partitions view (reference: a SQL view over pg_class +
    # partition bounds)
    rows = []
    for t in cl.catalog.tables.values():
        if t.partition_of is not None:
            rows.append((t.partition_of["parent"], t.name,
                         t.partition_of["lo"], t.partition_of["hi"]))
    return Result(
        columns=["parent_table", "partition", "from_value", "to_value"],
        rows=sorted(rows))


# -------------------------------------------------------------- sequences

@utility("nextval")
def _nextval(cl, name, args):
    return Result(columns=["nextval"],
                  rows=[(cl.catalog.nextval(str(args[0])),)])


@utility("currval")
def _currval(cl, name, args):
    return Result(columns=["currval"],
                  rows=[(cl.catalog.currval(str(args[0])),)])


@utility("setval")
def _setval(cl, name, args):
    v = cl.catalog.setval(str(args[0]), int(args[1]))
    return Result(columns=["setval"], rows=[(v,)])


@utility("citus_sequences")
def _citus_sequences(cl, name, args):
    rows = [(n, s["value"], s["increment"], s["start"])
            for n, s in sorted(cl.catalog.sequences.items())]
    return Result(columns=["sequence_name", "next_block_start",
                           "increment", "start"], rows=rows)


# ----------------------------------------------------- object inventories

@utility("citus_extensions")
def _citus_extensions(cl, name, args):
    return Result(columns=["name", "version"],
                  rows=sorted((k, v.get("version"))
                              for k, v in cl.catalog.extensions.items()))


@utility("citus_domains")
def _citus_domains(cl, name, args):
    return Result(
        columns=["name", "base_type", "not_null", "check"],
        rows=sorted((k, v["base"], v["not_null"], v.get("check"))
                    for k, v in cl.catalog.domains.items()))


@utility("citus_collations")
def _citus_collations(cl, name, args):
    return Result(columns=["name", "locale", "provider"],
                  rows=sorted((k, v.get("locale"), v.get("provider"))
                              for k, v in cl.catalog.collations.items()))


@utility("citus_publications")
def _citus_publications(cl, name, args):
    rows = []
    for k, v in sorted(cl.catalog.publications.items()):
        tl = v.get("tables")
        rows.append((k, "ALL TABLES" if tl == "all" else ", ".join(tl)))
    return Result(columns=["name", "tables"], rows=rows)


@utility("citus_statistics_objects")
def _citus_statistics_objects(cl, name, args):
    return Result(
        columns=["name", "table", "columns", "ndistinct"],
        rows=sorted((k, v["table"], ", ".join(v["columns"]), v["ndistinct"])
                    for k, v in cl.catalog.statistics.items()))


@utility("citus_types")
def _citus_types(cl, name, args):
    return Result(columns=["type_name", "labels"],
                  rows=[(n, ",".join(ls)) for n, ls in
                        sorted(cl.catalog.types.items())])


@utility("citus_views")
def _citus_views(cl, name, args):
    return Result(columns=["view_name", "definition"],
                  rows=sorted(cl.catalog.views.items()))


@utility("citus_schemas")
def _citus_schemas(cl, name, args):
    rows = []
    for sname, info in cl.catalog.schemas.items():
        members = [t for t in cl.catalog.tables if t.startswith(sname + ".")]
        size = sum(cl._table_size(m) for m in members)
        rows.append((sname, info["colocation_id"], info["home_node"],
                     len(members), size))
    return Result(columns=["schema_name", "colocation_id", "node",
                           "table_count", "schema_size"], rows=rows)


# ------------------------------------------------------------ shard tools

@utility("run_command_on_shards", "run_command_on_placements")
def _run_command_on_shards(cl, name, args):
    return cl._run_command_on_shards(
        str(args[0]), str(args[1]),
        per_placement=(name == "run_command_on_placements"))


@utility("master_get_table_ddl_events")
def _master_get_table_ddl_events(cl, name, args):
    return Result(columns=["master_get_table_ddl_events"],
                  rows=[(d,) for d in cl._table_ddl(str(args[0]))])


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


# -------------------------------------------------- continuous aggregation


@utility("citus_create_rollup")
def _citus_create_rollup(cl, name, args):
    """SELECT citus_create_rollup(name, source, 'g1, g2',
    'count(*), sum(x), approx_count_distinct(y)') — register a
    re-mergeable rollup table colocated with its source and backfill it
    from the current contents (rollup/manager.py)."""
    if len(args) != 4:
        raise UnsupportedFeatureError(
            "citus_create_rollup(name, source, group_cols, aggs)")
    cl.rollup_manager.create_rollup(str(args[0]), str(args[1]),
                                    str(args[2]), str(args[3]))
    return Result(columns=[name], rows=[(None,)])


@utility("citus_drop_rollup")
def _citus_drop_rollup(cl, name, args):
    cl.rollup_manager.drop_rollup(str(args[0]))
    return Result(columns=[name], rows=[(None,)])


@utility("citus_refresh_rollups")
def _citus_refresh_rollups(cl, name, args):
    """Synchronously drain every rollup to its CDC head (the manual
    door; the background loop does the same on a cadence)."""
    folded = cl.rollup_manager.run_once()
    return Result(columns=["rows_folded"], rows=[(folded,)],
                  explain={"rollup_rows_folded": folded})


@utility("citus_rollups")
def _citus_rollups(cl, name, args):
    """One row per registered rollup with its durable watermark, the
    source's CDC head, and the refresh lag in pending change records."""
    return Result(
        columns=["name", "source", "rollup_table", "backend",
                 "watermark", "head_lsn", "pending_changes"],
        rows=[tuple(r) for r in cl.rollup_manager.rollup_rows()])


# ------------------------------------------------- cluster topology

@utility("citus_add_node")
def _citus_add_node(cl, name, args):
    """citus_add_node([nodename, nodeport]): with arguments, the node
    advertises a data-plane endpoint (pg_dist_node nodename/nodeport);
    without, a local-placement node."""
    from citus_tpu_torch.catalog.catalog import NodeMeta
    nid = max(cl.catalog.nodes, default=-1) + 1
    host = str(args[0]) if len(args) > 0 else None
    port = int(args[1]) if len(args) > 1 else None
    cl.catalog.nodes[nid] = NodeMeta(nid, True, host, port)
    cl.catalog.ddl_epoch += 1
    cl.catalog.commit()
    return Result(columns=["citus_add_node"], rows=[(nid,)])


@utility("citus_remote_stats")
def _citus_remote_stats(cl, name, args):
    """Data-plane transfer counters (files/bytes fetched, batches
    shipped, placement syncs) — the cross-host analog of the
    connection-level stats views."""
    rd = cl.catalog.remote_data
    st = dict(rd.stats) if rd is not None else {}
    cols = ["files_fetched", "bytes_fetched", "batches_shipped",
            "remote_syncs"]
    return Result(columns=cols,
                  rows=[tuple(st.get(c, 0) for c in cols)])


@utility("citus_remove_node")
def _citus_remove_node(cl, name, args):
    from citus_tpu_torch.errors import CatalogError
    nid = int(args[0]) if args else None
    if nid is None or nid not in cl.catalog.nodes:
        raise CatalogError(f"node {nid} does not exist")
    for t in cl.catalog.tables.values():
        for s in t.shards:
            if nid in s.placements:
                raise CatalogError(
                    f"cannot remove node {nid}: it still has shard placements")
    del cl.catalog.nodes[nid]
    cl.catalog.ddl_epoch += 1
    cl.catalog.commit()
    return Result(columns=["citus_remove_node"], rows=[(None,)])


# --------------------------------------------- replicated tenant quotas

@utility("citus_add_tenant_quota")
def _citus_add_tenant_quota(cl, name, args):
    # SELECT citus_add_tenant_quota(tenant, weight [, max_concurrency
    # [, rate_limit_qps [, queue_depth [, priority_class]]]]) — a
    # replicated catalog write (metadata/quotas.py): every coordinator's
    # registry mirrors it, so admission decisions match cluster-wide
    from citus_tpu_torch.metadata import replicated_set_quota
    replicated_set_quota(
        cl, str(args[0]),
        weight=float(args[1]) if len(args) > 1 else 0.0,
        max_concurrency=int(args[2]) if len(args) > 2 else 0,
        rate_limit_qps=float(args[3]) if len(args) > 3 else 0.0,
        queue_depth=int(args[4]) if len(args) > 4 else 0,
        priority_class=str(args[5]) if len(args) > 5 else "")
    return Result(columns=[name], rows=[(str(args[0]),)])


@utility("citus_remove_tenant_quota")
def _citus_remove_tenant_quota(cl, name, args):
    from citus_tpu_torch.metadata import replicated_remove_quota
    return Result(columns=[name],
                  rows=[(replicated_remove_quota(cl, str(args[0])),)])


@utility("citus_tenant_quotas")
def _citus_tenant_quotas(cl, name, args):
    from citus_tpu_torch.workload import GLOBAL_TENANTS
    return Result(columns=["tenant", "weight", "max_concurrency",
                           "rate_limit_qps", "queue_depth", "pinned_node",
                           "priority_class"],
                  rows=GLOBAL_TENANTS.rows_view())


@utility("citus_add_priority_class")
def _citus_add_priority_class(cl, name, args):
    # a class node in the scheduler's two-level stride tree, replicated
    # like a quota
    from citus_tpu_torch.metadata import replicated_set_class
    replicated_set_class(cl, str(args[0]),
                         float(args[1]) if len(args) > 1 else 1.0)
    return Result(columns=[name], rows=[(str(args[0]),)])


@utility("citus_priority_classes")
def _citus_priority_classes(cl, name, args):
    from citus_tpu_torch.workload import GLOBAL_TENANTS
    return Result(columns=["class", "weight"],
                  rows=GLOBAL_TENANTS.classes_view())


@utility("undistribute_table")
def _undistribute_table(cl, name, args):
    from citus_tpu_torch.commands.dml import refuse_remote_placements
    from citus_tpu_torch.operations.alter_table import undistribute_table
    # the re-ingest reads local placements only: a remote-hosted shard's
    # rows would be lost (ROADMAP.md C18)
    refuse_remote_placements(cl, cl.catalog.table(args[0]),
                             "undistribute_table",
                             "moving another coordinator's placements")
    undistribute_table(cl.catalog, args[0], txlog=cl.txlog)
    cl._plan_cache.clear()
    return Result(columns=[name], rows=[(None,)])


@utility("alter_distributed_table")
def _alter_distributed_table(cl, name, args):
    from citus_tpu_torch.commands.dml import refuse_remote_placements
    from citus_tpu_torch.operations.alter_table import alter_distributed_table
    refuse_remote_placements(cl, cl.catalog.table(args[0]),
                             "alter_distributed_table",
                             "moving another coordinator's placements")
    kw = {}
    if len(args) > 1:
        kw["shard_count"] = int(args[1])
    if len(args) > 2:
        kw["distribution_column"] = str(args[2])
    alter_distributed_table(cl.catalog, args[0], txlog=cl.txlog, **kw)
    cl._plan_cache.clear()
    return Result(columns=[name], rows=[(None,)])
