"""Shard rebalancer.

Reference: the greedy rebalance algorithm in
src/backend/distributed/operations/shard_rebalancer.c
(GetRebalanceSteps :532, RebalancePlacementUpdates :635) with
per-strategy cost/capacity hooks from pg_dist_rebalance_strategy.

Algorithm (same shape as the reference's): compute each node's total
cost (here: placement disk bytes, min 1 per placement so empty shards
still spread), then repeatedly move the best-fitting shard group from
the most-utilized node to the least-utilized node while the improvement
exceeds ``threshold`` of the mean utilization.  Colocation groups move
as one unit, exactly like the reference.  A placement another
coordinator hosts is sized over the data plane (ROADMAP.md C24: the
reference weighs it 1 byte).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from citus_tpu_torch.catalog import Catalog
from citus_tpu_torch.operations.shard_transfer import move_shard_placement


@dataclass
class RebalanceMove:
    shard_id: int
    source_node: int
    target_node: int
    cost: float

    def to_row(self):
        return (self.shard_id, self.source_node, self.target_node)


def _placement_cost(cat: Catalog, table, shard, node: int,
                    strategy: str = "by_disk_size") -> float:
    if strategy == "by_shard_count":
        return 1.0  # every shard group weighs the same
    if cat.is_remote_node(node) and cat.remote_data is not None:
        return _remote_placement_cost(cat, table, shard, node)
    d = cat.shard_dir(table.name, shard.shard_id, node)
    if not os.path.isdir(d):
        return 1.0
    return max(1.0, float(placement_bytes(d)))


def placement_bytes(d: str) -> int:
    """The bytes of the files in a placement directory.  A file its
    writer removes between the listing and its size (a transaction's
    staged side file, a ``.tmp`` renamed into place) counts 0; the
    reference sizes it and fails (ROADMAP.md C27)."""
    total = 0
    for f in os.listdir(d):
        try:
            total += os.path.getsize(os.path.join(d, f))
        except FileNotFoundError:
            pass
    return total


def _remote_placement_cost(cat: Catalog, table, shard, node: int) -> float:
    """The bytes of a placement another coordinator hosts, sized over
    the data plane (``list_placement``, as the move's progress total is).
    The reference looks for the directory in its own data dir, so it
    weighs such a placement 1 byte and plans no move toward a
    coordinator whose shards are all remote (ROADMAP.md C24)."""
    try:
        r = cat.remote_data.call(
            cat.node_endpoint(node), "list_placement",
            {"table": table.name, "shard_id": shard.shard_id, "node": node})
    except Exception:  # noqa: BLE001 -- an unreachable host weighs 1
        return 1.0
    return max(1.0, float(sum(int(f["size"]) for f in r.get("files", []))))


def _group_costs(cat: Catalog, table_name: str | None = None,
                 strategy: str = "by_disk_size"):
    """-> (cost per colocation-group-slot keyed by (colocation_id, index),
    node loads, representative shard per group slot)."""
    groups: dict[tuple, float] = {}
    rep: dict[tuple, tuple] = {}
    loads: dict[int, float] = {n: 0.0 for n in cat.active_node_ids()}
    for t in cat.tables.values():
        if not t.is_distributed:
            continue
        if table_name is not None and t.colocation_id != cat.table(table_name).colocation_id:
            continue
        for s in t.shards:
            node = s.placements[0]
            key = (t.colocation_id, s.index)
            c = _placement_cost(cat, t, s, node, strategy)
            groups[key] = groups.get(key, 0.0) + c
            if key not in rep:
                rep[key] = (s.shard_id, node)
            loads[node] = loads.get(node, 0.0) + c
    return groups, loads, rep


REBALANCE_STRATEGIES = ("by_disk_size", "by_shard_count")


def get_rebalance_plan(cat: Catalog, table_name: str | None = None,
                       threshold: float = 0.1,
                       max_moves: int = 1000,
                       strategy: str = "by_disk_size") -> list[RebalanceMove]:
    """Greedy improvement plan; does not execute anything.  ``strategy``
    mirrors pg_dist_rebalance_strategy's built-ins: by_disk_size
    (placement bytes) or by_shard_count (uniform weights)."""
    if strategy not in REBALANCE_STRATEGIES:
        from citus_tpu_torch.errors import CatalogError
        raise CatalogError(f"unknown rebalance strategy {strategy!r}")
    groups, loads, rep = _group_costs(cat, table_name, strategy)
    if not loads:
        return []
    # group slot -> current node (simulated as moves are planned)
    location = {key: rep[key][1] for key in groups}
    moves: list[RebalanceMove] = []
    mean = sum(loads.values()) / len(loads)
    for _ in range(max_moves):
        hi = max(loads, key=lambda n: loads[n])
        lo = min(loads, key=lambda n: loads[n])
        gap = loads[hi] - loads[lo]
        if gap <= max(threshold * max(mean, 1.0), 1e-9):
            break
        # best candidate on hi: largest group that still improves balance
        candidates = [(key, c) for key, c in groups.items()
                      if location[key] == hi and c < gap]
        if not candidates:
            break
        key, cost = max(candidates, key=lambda kc: kc[1])
        shard_id, _ = rep[key]
        moves.append(RebalanceMove(shard_id, hi, lo, cost))
        loads[hi] -= cost
        loads[lo] += cost
        location[key] = lo
    return moves


def rebalance_table_shards(cat: Catalog, table_name: str | None = None,
                           threshold: float = 0.1,
                           strategy: str = "by_disk_size",
                           lock_manager=None,
                           settings=None) -> list[RebalanceMove]:
    """Plan + execute (reference: rebalance_table_shards / the background
    variant citus_rebalance_start — each move runs the non-blocking
    catch-up sequence, so a foreground rebalance only blocks writers
    for the per-move flip windows)."""
    moves = get_rebalance_plan(cat, table_name, threshold, strategy=strategy)
    for m in moves:
        move_shard_placement(cat, m.shard_id, m.source_node, m.target_node,
                             lock_manager=lock_manager, settings=settings)
    return moves
