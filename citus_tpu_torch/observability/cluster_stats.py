"""This coordinator's observability payload, as the ``get_node_stats``
RPC answers it (reference: ``citus_tpu/observability/cluster_stats.py``
``local_node_stats``).

The port answers with the parts it has: the hosted node ids, the
counters and the per-placement load ledger.  The reference's gauges,
activity rows, slow-query log, background-job progress, autopilot log
and flight-recorder series come with the rest of observability
(ROADMAP.md A14c-2).  ``cluster_node_stats`` is the reference's
cluster-wide fan-in over every coordinator (``citus_shard_load`` reads
it): each remote endpoint is probed on its own thread with a per-node
timeout (``citus.stat_fanout_timeout_s``), and a dead peer degrades to
an ``unreachable`` payload instead of failing the view.
"""

from __future__ import annotations

import threading
from typing import Optional

from citus_tpu_torch.net.rpc import RpcClient


def _counters():
    from citus_tpu_torch.executor.executor import GLOBAL_COUNTERS
    return GLOBAL_COUNTERS


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


def _probe(endpoint: tuple, secret: Optional[bytes],
           timeout_s: float) -> dict:
    """One get_node_stats round trip on a dedicated connection."""
    c = RpcClient(endpoint[0], int(endpoint[1]), timeout=timeout_s,
                  secret=secret)
    try:
        return c.call("get_node_stats")
    finally:
        c.close()


def cluster_node_stats(cluster, timeout_s: Optional[float] = None
                       ) -> list[dict]:
    """Fan out get_node_stats to every live endpoint and merge: one
    payload per coordinator process, the local process served in-line.
    Unreachable peers yield ``{"unreachable": True, "node_ids": [...],
    "error": ...}`` payloads."""
    if timeout_s is None:
        timeout_s = cluster.settings.observability.stat_fanout_timeout_s
    cat = cluster.catalog
    payloads = [local_node_stats(cluster)]
    # group remote logical nodes by the coordinator endpoint hosting them
    by_endpoint: dict[tuple, list[int]] = {}
    for nid in cat.active_node_ids():
        if cat.is_remote_node(nid):
            ep = cat.node_endpoint(nid)
            if ep is not None:
                by_endpoint.setdefault((ep[0], int(ep[1])), []).append(nid)
    if not by_endpoint:
        return payloads
    secret = getattr(cat.remote_data, "secret", None)
    results: dict[tuple, dict] = {}
    results_mu = threading.Lock()

    def probe_one(ep: tuple) -> None:
        try:
            r = _probe(ep, secret, timeout_s)
        except Exception as e:  # noqa: BLE001 -- a dead peer is a row
            r = {"unreachable": True, "error": str(e)}
        with results_mu:
            results[ep] = r

    threads = []
    for ep in sorted(by_endpoint):
        _counters().bump("stat_fanout_probes")
        th = threading.Thread(target=probe_one, args=(ep,), daemon=True,
                              name=f"stat-fanout-{ep[0]}:{ep[1]}")
        th.start()
        threads.append((ep, th))
    for ep, th in threads:
        th.join(timeout=timeout_s + 0.5)
    for ep, th in threads:
        with results_mu:
            r = results.get(ep)
        if r is None:
            r = {"unreachable": True, "error": "probe timed out"}
        r.setdefault("node_ids", sorted(by_endpoint[ep]))
        r["endpoint"] = f"{ep[0]}:{ep[1]}"
        if r.get("unreachable"):
            _counters().bump("stat_fanout_unreachable")
            # the data-plane pools keep idle sockets to this endpoint:
            # evict them so the next RPC reconnects
            rd = getattr(cluster.catalog, "remote_data", None)
            if rd is not None:
                rd.evict_endpoint(ep)
        payloads.append(r)
    return payloads


def payload_node(payload: dict) -> int:
    """The node id a merged payload's rows are attributed to: the lowest
    logical node the coordinator hosts (a process may host several)."""
    ids = payload.get("node_ids") or []
    return min(ids) if ids else -1
