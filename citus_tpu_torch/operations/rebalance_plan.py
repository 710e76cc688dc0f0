"""Dry-run rebalance planning: cost strategies over observed state.

Reference: pg_dist_rebalance_strategy's pluggable cost functions
(SURVEY §2.10's strategy table — by-shard-count, by-disk-size,
by-observed-load) feeding the same greedy balance loop as
operations/rebalancer.py, but *never executing anything*: the output is
an ordered list of move/split/isolate steps with per-step
expected-benefit scores, surfaced as ``SELECT
citus_rebalance_plan(strategy)`` (the reference's autopilot consumes it
too; the port's comes with ROADMAP.md A14c-2).

Strategies
----------
``by_shard_count``
    every colocation group slot weighs 1.0 — pure placement spreading.
``by_bytes``
    placement stripe bytes on disk (the reference's by_disk_size).
``by_observed_load``
    EWMA'd device-ms/s rates from the per-placement attribution ledger
    (observability/load_attribution.py) — the load actually observed
    landing on each placement, not a proxy for it.

Beyond moves, the planner recognizes two shapes a move cannot fix:

* a single group slot so heavy that no move narrows the gap — the
  hottest shard itself must **split** (actuator: split_shard);
* one tenant dominating the hottest placement under
  ``by_observed_load`` — that tenant should be **isolated** to its own
  placement (actuator: isolate_tenant_to_node) rather than dragging
  every colocated tenant through a move.

Determinism: for a fixed catalog + attribution snapshot the plan is a
pure function — every choice breaks ties on (cost, node id, slot key),
and reading attribution rates never advances them (``tick()`` is
sampler-driven).  Calling this module has no side effects whatsoever.
"""

from __future__ import annotations

from dataclasses import dataclass

from citus_tpu_torch.catalog import Catalog
from citus_tpu_torch.operations.rebalancer import _placement_cost

PLAN_STRATEGIES = ("by_shard_count", "by_bytes", "by_observed_load")

#: a lone tenant carrying at least this share of the hottest
#: placement's device ms is an isolation candidate, not a move
ISOLATE_TENANT_SHARE = 0.6


@dataclass(frozen=True)
class PlanStep:
    """One dry-run action.  ``score`` is the expected benefit: the
    fraction of the current hi-lo load gap this step closes (1.0 =
    perfectly balancing), so steps compare across strategies."""
    action: str            # "move" | "split" | "isolate"
    table: str
    shard_id: int
    source_node: int
    target_node: int
    cost: float            # strategy units moved / split / isolated
    score: float
    reason: str

    def to_row(self, seq: int):
        return (seq, self.action, self.table, self.shard_id,
                self.source_node, self.target_node,
                round(float(self.cost), 3), round(float(self.score), 4),
                self.reason)


PLAN_COLUMNS = ("step", "action", "table_name", "shard_id", "source_node",
                "target_node", "cost", "score", "reason")


def _slot_costs(cat: Catalog, strategy: str, load_scores):
    """-> (cost per colocation slot, node loads, representative
    (table, shard_id, node) per slot) — the rebalancer's _group_costs
    generalized over the strategy's cost source."""
    groups: dict[tuple, float] = {}
    rep: dict[tuple, tuple] = {}
    loads: dict[int, float] = {n: 0.0 for n in cat.active_node_ids()}
    for tname in sorted(cat.tables):
        t = cat.tables[tname]
        if not t.is_distributed:
            continue
        for s in t.shards:
            node = s.placements[0]
            key = (t.colocation_id, s.index)
            if strategy == "by_observed_load":
                c = float(load_scores.get((t.name, s.shard_id, node), 0.0))
            elif strategy == "by_shard_count":
                c = 1.0
            else:  # by_bytes
                c = _placement_cost(cat, t, s, node, "by_disk_size")
            groups[key] = groups.get(key, 0.0) + c
            if key not in rep:
                rep[key] = (t.name, s.shard_id, node)
            loads[node] = loads.get(node, 0.0) + c
    return groups, loads, rep


def _dominant_tenant(attribution_rows, table: str, shard_id: int,
                     node: int):
    """-> (tenant, share of the placement's device ms) from the
    attribution ledger's rows_view, or (None, 0.0)."""
    total = 0.0
    per: dict[str, float] = {}
    for r in attribution_rows:
        if (r[0], r[1], r[2]) == (table, shard_id, node):
            total += float(r[5])
            per[str(r[3])] = per.get(str(r[3]), 0.0) + float(r[5])
    if total <= 0.0:
        return None, 0.0
    tenant = max(sorted(per), key=lambda k: per[k])
    return tenant, per[tenant] / total


def build_rebalance_plan(cat: Catalog, strategy: str = "by_observed_load",
                         threshold: float = 0.1, max_steps: int = 16,
                         load_scores=None, attribution_rows=None
                         ) -> list[PlanStep]:
    """Pure planning: simulate greedy hi→lo group moves until balanced,
    recognizing split/isolate shapes.  ``load_scores`` /
    ``attribution_rows`` default to the global attribution ledger's
    current snapshot; pass explicit snapshots for deterministic tests."""
    if strategy not in PLAN_STRATEGIES:
        from citus_tpu_torch.errors import CatalogError
        raise CatalogError(
            f"unknown rebalance strategy {strategy!r} "
            f"(expected one of {', '.join(PLAN_STRATEGIES)})")
    if strategy == "by_observed_load":
        from citus_tpu_torch.observability.load_attribution import (
            GLOBAL_ATTRIBUTION,
        )
        if load_scores is None:
            load_scores = GLOBAL_ATTRIBUTION.load_scores()
        if attribution_rows is None:
            attribution_rows = GLOBAL_ATTRIBUTION.rows_view()
    groups, loads, rep = _slot_costs(cat, strategy, load_scores or {})
    if len(loads) < 2:
        return []
    steps: list[PlanStep] = []
    location = {key: rep[key][2] for key in groups}
    mean = sum(loads.values()) / len(loads)
    floor = max(threshold * max(mean, 1.0), 1e-9)
    while len(steps) < max_steps:
        # deterministic hi/lo: load desc/asc, node id as tie-break
        hi = min(loads, key=lambda n: (-loads[n], n))
        lo = min(loads, key=lambda n: (loads[n], n))
        gap = loads[hi] - loads[lo]
        if gap <= floor:
            break
        movable = [(key, c) for key, c in groups.items()
                   if location[key] == hi and 0.0 < c < gap]
        if not movable:
            # nothing movable narrows the gap: the heaviest slot on hi
            # IS the imbalance — a split (and possibly an isolation)
            # is the only fix.  Terminal either way: a dry run cannot
            # simulate past a split's unknown post-split costs.
            stuck = [(key, c) for key, c in groups.items()
                     if location[key] == hi and c > 0.0]
            if not stuck:
                break
            key, cost = min(stuck, key=lambda kc: (-kc[1], kc[0]))
            if cost < loads[hi] * 0.99:
                # hi carries several slots, none individually movable:
                # that's placement parity (e.g. 4 shards on 3 nodes),
                # not a hot slot — splitting would just mint shards
                break
            table, shard_id, _ = rep[key]
            if strategy == "by_observed_load" and attribution_rows:
                tenant, share = _dominant_tenant(
                    attribution_rows, table, shard_id, hi)
                if tenant and tenant != "*" and share >= ISOLATE_TENANT_SHARE:
                    steps.append(PlanStep(
                        "isolate", table, shard_id, hi, lo,
                        cost * share, share,
                        f"tenant {tenant!r} carries "
                        f"{share:.0%} of the hottest placement"))
                    break
            steps.append(PlanStep(
                "split", table, shard_id, hi, lo, cost,
                min(1.0, cost / max(gap, 1e-9)),
                "heaviest group exceeds the node gap; no move helps"))
            break
        key, cost = min(movable, key=lambda kc: (-kc[1], kc[0]))
        table, shard_id, _ = rep[key]
        # moving cost c from hi to lo closes the gap by 2c (capped at
        # the gap itself): score 1.0 = this single move balances hi/lo
        steps.append(PlanStep(
            "move", table, shard_id, hi, lo, cost,
            min(1.0, 2.0 * cost / gap),
            f"{strategy}: narrows hi-lo gap {gap:.1f} by {2 * cost:.1f}"))
        loads[hi] -= cost
        loads[lo] += cost
        location[key] = lo
    return steps


def plan_rows(steps: list[PlanStep]) -> list[tuple]:
    return [s.to_row(i + 1) for i, s in enumerate(steps)]
