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
citus_statistics_objects, citus_types, citus_views, citus_schemas,
citus_roles, citus_grants, citus_policies, citus_triggers,
citus_text_search_configs), recover_prepared_transactions,
run_command_on_shards / _placements,
master_get_table_ddl_events, the redistributions
undistribute_table and alter_distributed_table (refused, naming
ROADMAP.md C18, for a table with shards another coordinator hosts), and
the shard operations and services: shard sizes and inventories, node
activation, shard moves and copies, splits, tenant isolation, the
rebalancer with its plan and background jobs, the cleaner and restore
points.  The observability utilities are not ported yet (ROADMAP.md
A14c-2).
"""

from __future__ import annotations

from citus_tpu_torch.commands.registry import UTILITY_HANDLERS, utility
from citus_tpu_torch.errors import UnsupportedFeatureError
from citus_tpu_torch.executor import Result


def execute_utility(cl, stmt) -> Result:
    fn = UTILITY_HANDLERS.get(stmt.name)
    if fn is None:
        # observability: metrics, slow queries, activity, locks, clocks,
        # health, history, autopilot, CDC events
        raise UnsupportedFeatureError(
            f"utility {stmt.name}() is not ported yet (ROADMAP.md A14c-2)")
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


@utility("citus_roles")
def _citus_roles(cl, name, args):
    return Result(columns=["role_name"],
                  rows=[(r,) for r in sorted(cl.catalog.roles)])


@utility("citus_grants")
def _citus_grants(cl, name, args):
    rows = []
    for tbl, by_role in sorted(cl.catalog.grants.items()):
        for r, privs in sorted(by_role.items()):
            rows.append((tbl, r, ",".join(privs)))
    return Result(columns=["table_name", "role_name", "privileges"],
                  rows=rows)


@utility("citus_policies")
def _citus_policies(cl, name, args):
    rows = []
    for tbl in sorted(cl.catalog.policies):
        for p in cl.catalog.policies[tbl]:
            rows.append((tbl, p["name"], p["cmd"], ",".join(p["roles"]),
                         p.get("using"), p.get("check")))
    return Result(columns=["table_name", "policy_name", "cmd", "roles",
                           "using_expr", "check_expr"], rows=rows)


@utility("citus_triggers")
def _citus_triggers(cl, name, args):
    return Result(
        columns=["trigger_name", "table_name", "event", "function"],
        rows=[(n, t["table"], t["event"], t["function"])
              for n, t in sorted(cl.catalog.triggers.items())])


@utility("citus_text_search_configs")
def _citus_text_search_configs(cl, name, args):
    return Result(
        columns=["config_name", "parser"],
        rows=[(n, c.get("parser", "default"))
              for n, c in sorted(cl.catalog.ts_configs.items())])


@utility("recover_prepared_transactions")
def _recover_prepared_transactions(cl, name, args):
    from citus_tpu_torch.transaction.recovery import recover_transactions
    st = recover_transactions(cl.catalog, cl.txlog,
                              peer_inflight=cl._peer_inflight(),
                              gxid_outcome=cl._gxid_outcome)
    return Result(columns=["recover_prepared_transactions"],
                  rows=[(st["rolled_forward"] + st["rolled_back"],)])


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


# ------------------------------------------- shard operations and services


@utility("citus_shard_load")
def _citus_shard_load(cl, name, args):
    """The per-placement attribution ledger, cluster-wide: every node's
    booked (table, shard, placement, tenant) load fanned in through
    get_node_stats — ``observer`` is the node that did the work.
    Optional arg: table-name filter."""
    from citus_tpu_torch.observability.cluster_stats import (
        cluster_node_stats, payload_node,
    )
    table = str(args[0]) if args else None
    rows = []
    for p in cluster_node_stats(cl):
        if p.get("unreachable"):
            continue
        observer = payload_node(p)
        for r in p.get("shard_load", []):
            if table is not None and r[0] != table:
                continue
            rows.append((observer, *r))
    rows.sort(key=lambda r: (-r[6], r[1], r[2], r[3], str(r[4]), r[0]))
    return Result(columns=["observer", "table_name", "shard_id", "node",
                           "tenant", "queries", "device_ms",
                           "bytes_scanned", "rows_returned",
                           "remote_wait_ms", "ewma_ms_per_s"],
                  rows=rows)


@utility("citus_rebalance_plan")
def _citus_rebalance_plan(cl, name, args):
    """Dry-run rebalance plan (operations/rebalance_plan.py): ordered
    move/split/isolate steps with expected-benefit scores.  Executes
    nothing.  Args: strategy (default by_observed_load), optional
    imbalance threshold."""
    from citus_tpu_torch.operations.rebalance_plan import (
        PLAN_COLUMNS, build_rebalance_plan, plan_rows,
    )
    strategy = str(args[0]) if args else "by_observed_load"
    threshold = float(args[1]) if len(args) > 1 else 0.1
    steps = build_rebalance_plan(cl.catalog, strategy, threshold=threshold)
    return Result(columns=list(PLAN_COLUMNS), rows=plan_rows(steps))


@utility("citus_device_memory")
def _citus_device_memory(cl, name, args):
    """Device-memory ledger of the batch cache: one row per (table,
    tenant) attribution plus total/high-water/capacity rows (entry rows
    sum exactly to the total)."""
    from citus_tpu_torch.executor.device_cache import GLOBAL_CACHE
    mv = GLOBAL_CACHE.memory_view()
    rows = [("entry", table, tenant, b)
            for table, tenant, b in mv["by_owner"]]
    rows.append(("total", None, None, mv["live_bytes"]))
    rows.append(("high_water", None, None, mv["high_water_bytes"]))
    rows.append(("capacity", None, None, mv["capacity_bytes"]))
    return Result(columns=["scope", "table", "tenant", "bytes"], rows=rows)


@utility("get_rebalance_progress")
def _get_rebalance_progress(cl, name, args):
    rows = []
    if cl._background_jobs is not None:
        jobs = [j["job_id"] for j in cl._background_jobs.jobs_view()["jobs"]]
        for jid in jobs:
            rows.extend(cl._background_jobs.job_progress(jid))
    return Result(columns=["task_id", "op", "args", "status", "attempts",
                           "phase", "bytes_done", "bytes_total",
                           "started_at", "eta_s"],
                  rows=rows)


@utility("citus_table_size", "citus_relation_size",
         "citus_total_relation_size")
def _citus_table_size(cl, name, args):
    return Result(columns=[name], rows=[(cl._table_size(str(args[0])),)])


@utility("citus_shard_sizes")
def _citus_shard_sizes(cl, name, args):
    import os

    from citus_tpu_torch.operations.rebalancer import placement_bytes
    rows = []
    for t in cl.catalog.tables.values():
        for s_ in t.shards:
            for node in s_.placements:
                d = cl.catalog.shard_dir(t.name, s_.shard_id, node)
                size = placement_bytes(d) if os.path.isdir(d) else 0
                rows.append((t.name, s_.shard_id, node, size))
    return Result(columns=["table_name", "shardid", "node", "size"],
                  rows=rows)


@utility("citus_shards")
def _citus_shards(cl, name, args):
    rows = []
    for t in cl.catalog.tables.values():
        for s_ in t.shards:
            for node in s_.placements:
                rows.append((t.name, s_.shard_id, t.method, t.colocation_id,
                             node, s_.hash_min, s_.hash_max))
    return Result(columns=["table_name", "shardid", "citus_table_type",
                           "colocation_id", "nodename", "shardminvalue",
                           "shardmaxvalue"], rows=rows)


@utility("citus_tables")
def _citus_tables(cl, name, args):
    from citus_tpu_torch.catalog.stats import table_row_count
    rows = []
    for t in cl.catalog.tables.values():
        rows.append((t.name, t.method, t.dist_column, t.colocation_id,
                     cl._table_size(t.name), t.shard_count,
                     table_row_count(cl.catalog, t)))
    return Result(columns=["table_name", "citus_table_type",
                           "distribution_column", "colocation_id",
                           "table_size", "shard_count", "row_count"],
                  rows=rows)


@utility("get_shard_id_for_distribution_column")
def _get_shard_id_for_distribution_column(cl, name, args):
    from citus_tpu_torch.catalog.hashing import hash_int64_scalar
    t2 = cl.catalog.table(str(args[0]))
    if not t2.is_distributed:
        return Result(columns=[name], rows=[(t2.shards[0].shard_id,)])
    h = hash_int64_scalar(int(args[1]))
    return Result(columns=[name],
                  rows=[(t2.shards[t2.route_hash(h)].shard_id,)])


@utility("master_get_active_worker_nodes", "citus_get_active_worker_nodes")
def _active_worker_nodes(cl, name, args):
    return Result(columns=["node_id"],
                  rows=[(nid,) for nid in cl.catalog.active_node_ids()])


def _set_node_active(cl, args, active: bool) -> int:
    from citus_tpu_torch.errors import CatalogError
    nid = int(args[0])
    if nid not in cl.catalog.nodes:
        raise CatalogError(f"node {nid} does not exist")
    cl.catalog.nodes[nid].is_active = active
    cl.catalog.ddl_epoch += 1
    cl.catalog.commit()
    cl._plan_cache.clear()
    return nid


@utility("citus_disable_node")
def _citus_disable_node(cl, name, args):
    _set_node_active(cl, args, False)
    return Result(columns=[name], rows=[(None,)])


@utility("citus_activate_node")
def _citus_activate_node(cl, name, args):
    return Result(columns=[name], rows=[(_set_node_active(cl, args, True),)])


@utility("citus_activate_node_metadata")
def _citus_activate_node_metadata(cl, name, args):
    # mark the node a full metadata peer (pg_dist_node.hasmetadata); the
    # sync engine keeps its catalog converged
    from citus_tpu_torch.errors import CatalogError
    nid = int(args[0])
    if nid not in cl.catalog.nodes:
        raise CatalogError(f"node {nid} does not exist")
    cl.catalog.nodes[nid].metadata_synced = True
    cl.catalog.ddl_epoch += 1
    cl.catalog.commit()
    return Result(columns=[name], rows=[(nid,)])


@utility("citus_sync_metadata")
def _citus_sync_metadata(cl, name, args):
    # one on-demand pull-on-mismatch round against the metadata
    # authority: how many catalog objects were applied (0 = converged)
    return Result(columns=["objects_applied"],
                  rows=[(cl.metadata_sync.sync_once(),)])


@utility("citus_coordinator_nodeid")
def _citus_coordinator_nodeid(cl, name, args):
    nids = sorted(cl.catalog.active_node_ids())
    return Result(columns=["citus_coordinator_nodeid"],
                  rows=[(nids[0] if nids else 0,)])


@utility("citus_move_shard_placement")
def _citus_move_shard_placement(cl, name, args):
    from citus_tpu_torch.operations import move_shard_placement
    move_shard_placement(cl.catalog, int(args[0]), int(args[1]),
                         int(args[2]), lock_manager=cl.locks,
                         settings=cl.settings)
    cl._plan_cache.clear()
    return Result(columns=[name], rows=[(None,)])


@utility("citus_shard_move_stats")
def _citus_shard_move_stats(cl, name, args):
    # per-move view of the non-blocking sequence: catch-up rounds and
    # the milliseconds writers were actually excluded, beside the total
    from citus_tpu_torch.operations import MOVE_STATS
    cols = ["op", "shard_id", "source", "target", "bytes_copied",
            "catchup_rounds", "blocked_write_ms", "total_ms"]
    return Result(columns=cols,
                  rows=[tuple(r.get(c) for c in cols)
                        for r in MOVE_STATS.rows()])


@utility("get_rebalance_table_shards_plan")
def _get_rebalance_table_shards_plan(cl, name, args):
    from citus_tpu_torch.operations import get_rebalance_plan
    moves = get_rebalance_plan(
        cl.catalog, args[0] if args else None,
        strategy=str(args[1]) if len(args) > 1 else "by_disk_size")
    return Result(columns=["shardid", "sourcenode", "targetnode"],
                  rows=[m.to_row() for m in moves])


@utility("rebalance_table_shards")
def _rebalance_table_shards(cl, name, args):
    from citus_tpu_torch.operations import rebalance_table_shards
    moves = rebalance_table_shards(
        cl.catalog, args[0] if args else None,
        strategy=str(args[1]) if len(args) > 1 else "by_disk_size",
        lock_manager=cl.locks, settings=cl.settings)
    cl._plan_cache.clear()
    return Result(columns=["rebalance_table_shards"], rows=[(len(moves),)])


@utility("citus_rebalance_start")
def _citus_rebalance_start(cl, name, args):
    from citus_tpu_torch.operations import get_rebalance_plan
    moves = get_rebalance_plan(cl.catalog)
    jid = cl.background_jobs.create_job("Rebalance all colocation groups")
    prev = None
    for m in moves:
        prev = cl.background_jobs.add_task(
            jid, "move_shard",
            {"shard_id": m.shard_id, "source": m.source_node,
             "target": m.target_node},
            depends_on=[prev] if prev is not None else None,
            node=m.target_node)
    return Result(columns=["citus_rebalance_start"], rows=[(jid,)])


@utility("citus_job_wait")
def _citus_job_wait(cl, name, args):
    status = cl.background_jobs.wait_for_job(int(args[0]))
    cl._plan_cache.clear()
    return Result(columns=["citus_job_wait"], rows=[(status,)])


@utility("citus_cleanup_orphaned_resources")
def _citus_cleanup_orphaned_resources(cl, name, args):
    from citus_tpu_torch.operations import try_drop_orphaned_resources
    n = try_drop_orphaned_resources(cl.catalog)
    return Result(columns=["citus_cleanup_orphaned_resources"], rows=[(n,)])


@utility("citus_copy_shard_placement")
def _citus_copy_shard_placement(cl, name, args):
    from citus_tpu_torch.operations import copy_shard_placement
    copy_shard_placement(cl.catalog, int(args[0]), int(args[1]),
                         int(args[2]))
    cl._plan_cache.clear()
    return Result(columns=[name], rows=[(None,)])


@utility("citus_split_shard_by_split_points")
def _citus_split_shard_by_split_points(cl, name, args):
    from citus_tpu_torch.operations.shard_split import split_shard
    points = [int(a) for a in args[1:]
              if not isinstance(a, str) or a.lstrip("-").isdigit()]
    new_ids = split_shard(cl.catalog, int(args[0]), points,
                          lock_manager=cl.locks, settings=cl.settings)
    cl._plan_cache.clear()
    return Result(columns=["new_shard_ids"], rows=[(i,) for i in new_ids])


@utility("isolate_tenant_to_new_shard")
def _isolate_tenant_to_new_shard(cl, name, args):
    # put one distribution-key value in its own shard by splitting
    # around its hash (reference: isolate_shards.c)
    from citus_tpu_torch.catalog.hashing import hash_int64_scalar
    from citus_tpu_torch.operations.shard_split import split_shard
    t = cl.catalog.table(args[0])
    h = hash_int64_scalar(int(args[1]))
    shard = t.shards[t.route_hash(h)]
    points = []
    if h - 1 >= shard.hash_min:
        points.append(h - 1)
    if h < shard.hash_max:
        points.append(h)
    new_ids = split_shard(cl.catalog, shard.shard_id, points,
                          lock_manager=cl.locks, settings=cl.settings)
    cl._plan_cache.clear()
    return Result(columns=["isolate_tenant_to_new_shard"],
                  rows=[(new_ids[1 if h - 1 >= shard.hash_min else 0],)])


@utility("citus_isolate_tenant_to_node")
def _citus_isolate_tenant_to_node(cl, name, args):
    # isolate_tenant_to_new_shard + move_shard_placement in one call,
    # with the pin recorded in the tenant registry
    from citus_tpu_torch.workload.isolation import isolate_tenant_to_node
    shard_id = isolate_tenant_to_node(cl, str(args[0]), args[1],
                                      int(args[2]))
    return Result(columns=[name], rows=[(shard_id,)])


@utility("citus_create_restore_point")
def _citus_create_restore_point(cl, name, args):
    from citus_tpu_torch.operations.restore import create_restore_point
    create_restore_point(cl.catalog, str(args[0]))
    return Result(columns=["citus_create_restore_point"],
                  rows=[(str(args[0]),)])


@utility("citus_list_restore_points")
def _citus_list_restore_points(cl, name, args):
    from citus_tpu_torch.operations.restore import list_restore_points
    return Result(columns=["name", "created_at"],
                  rows=list_restore_points(cl.catalog))
