"""Tenant isolation: pin one tenant's router traffic to a dedicated
host.

Reference: isolate_tenant_to_new_shard (isolate_shards.c) splits a hot
distribution-key value into its own shard; the operational playbook
then moves that shard to a node reserved for the tenant.  This module
composes both halves behind one call — SELECT
citus_isolate_tenant_to_node('t', <value>, <node>) — and records the
pin in the tenant registry so citus_tenant_quotas() shows where the
tenant now lives.  After the move every router query for that key
resolves to a placement on the dedicated host, so the tenant's device
dispatches stop competing with the rest of the cluster's.
"""

from __future__ import annotations

from citus_tpu_torch.errors import AnalysisError
from citus_tpu_torch.workload.registry import GLOBAL_TENANTS


def isolate_tenant_to_node(cl, table: str, tenant_value, node: int) -> int:
    """Give ``tenant_value`` its own shard (splitting if it shares one)
    and move that shard's placement to ``node``.  Returns the isolated
    shard id."""
    from citus_tpu_torch.catalog.hashing import hash_int64_scalar
    from citus_tpu_torch.operations import move_shard_placement
    from citus_tpu_torch.operations.shard_split import split_shard

    t = cl.catalog.table(table)
    if not t.is_distributed:
        raise AnalysisError(f"{table} is not a distributed table")
    if node not in cl.catalog.active_node_ids():
        raise AnalysisError(f"node {node} is not an active cluster node")
    h = hash_int64_scalar(int(tenant_value))
    shard = t.shards[t.route_hash(h)]
    points = []
    if h - 1 >= shard.hash_min:
        points.append(h - 1)
    if h < shard.hash_max:
        points.append(h)
    if points:
        new_ids = split_shard(cl.catalog, shard.shard_id, points,
                              lock_manager=cl.locks, settings=cl.settings)
        shard_id = new_ids[1 if h - 1 >= shard.hash_min else 0]
    else:
        shard_id = shard.shard_id  # already alone in its shard
    t = cl.catalog.table(table)
    target = next(s for s in t.shards if s.shard_id == shard_id)
    for src in list(target.placements):
        if src != node:
            move_shard_placement(cl.catalog, shard_id, src, node,
                                 lock_manager=cl.locks,
                                 settings=cl.settings)
    GLOBAL_TENANTS.pin(str(tenant_value), int(node))
    cl._plan_cache.clear()
    return shard_id
