"""This coordinator's observability payload, as the ``get_node_stats``
RPC answers it (reference: ``citus_tpu/observability/cluster_stats.py``
``local_node_stats``).

The port answers with the parts it has: the hosted node ids, the
counters and the per-placement load ledger.  The reference's gauges,
activity rows, slow-query log, background-job progress, autopilot log
and flight-recorder series come with the rest of observability
(ROADMAP.md A14), as does the cluster-wide fan-in over every node.
"""

from __future__ import annotations


def local_node_stats(cluster) -> dict:
    """JSON-safe: the payload crosses the wire verbatim."""
    from citus_tpu_torch.observability.load_attribution import (
        GLOBAL_ATTRIBUTION,
    )
    cat = cluster.catalog
    hosted = cat.hosted_nodes
    node_ids = (sorted(hosted) if hosted is not None
                else cat.active_node_ids())
    return {
        "node_ids": node_ids,
        "counters": cluster.counters.snapshot(),
        "shard_load": [list(r) for r in GLOBAL_ATTRIBUTION.rows_view()],
    }
