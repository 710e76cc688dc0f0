"""Physical distributed planning.

From a BoundSelect this derives everything the executor needs:

- shard pruning: equality on the distribution column routes to one shard
  (reference: shard_pruning.c's PruneShards + the fast-path router)
- chunk pruning intervals from WHERE conjuncts (reference: the columnar
  CustomScan's ExtractPushdownClause + BuildBaseConstraint)
- the worker/combine aggregate split: every SQL aggregate lowers to a set
  of combinable partial ops — sum/count/min/max over expressions
  (reference: multi_logical_optimizer.c WorkerExtendedOpNode /
  MasterExtendedOpNode; avg becomes sum+count exactly as there)
- the GROUP BY strategy:
    * scalar  — no GROUP BY, one global group
    * direct  — composite key domain provably small (from skip-list
                stats / text dictionary sizes): exact gid scatter-add,
                combinable with a single psum — the north-star lowering
    * hash_host — unbounded key domain: the device still does scan,
                filter and agg-input evaluation; grouping happens on the
                host per shard and merges on the coordinator (analog of
                the reference pulling worker rows when aggregates can't
                be pushed down)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from citus_tpu_torch import types as T
from citus_tpu_torch.catalog import Catalog, TableMeta
from citus_tpu_torch.catalog.hashing import hash_int64_scalar
from citus_tpu_torch.catalog.stats import column_bounds
from citus_tpu_torch.planner.bind import AggSpec, BoundSelect
from citus_tpu_torch.planner.bound import (
    BBinOp, BCast, BColumn, BDateTrunc, BExpr, BLiteral, BScale, BUnOp,
)
from citus_tpu_torch.storage.reader import Interval


@dataclass(frozen=True)
class PartialOp:
    """One combinable per-shard accumulator."""
    kind: str        # sum | count | min | max | distinct | collect
    arg_index: int   # index into PhysicalPlan.agg_args; -1 = count rows
    dtype: str       # numpy dtype name of the accumulator
    # collect only: additional agg_arg indexes gathered alongside the
    # value (ordered aggregates collect (value, sortkey...) tuples)
    extra_args: tuple = ()


@dataclass
class AggExtract:
    """How to produce one SQL aggregate's value from partial slots."""
    kind: str        # sum | count | count_star | avg | min | max | registry
    slots: list[int] # indexes into partial op results
    out_type: T.ColumnType
    param: object = None  # registry-aggregate parameter (fraction, delim, ...)


@dataclass
class KeyDomain:
    lo: int          # physical minimum (code 0 is reserved for NULL)
    size: int        # number of codes including the NULL slot
    step: int = 1    # code stride in physical space (e.g. date_trunc unit)


@dataclass
class GroupMode:
    kind: str                      # scalar | direct | hash_host
    domains: list[KeyDomain] = field(default_factory=list)
    strides: list[int] = field(default_factory=list)
    n_groups: int = 1


@dataclass
class PhysicalPlan:
    bound: BoundSelect
    scan_columns: list[str]
    intervals: list[Interval]
    shard_indexes: list[int]        # shards that survived pruning
    group_mode: GroupMode
    agg_args: list[BExpr]           # deduped aggregate input expressions
    partial_ops: list[PartialOp]
    agg_extract: list[AggExtract]
    # executor-populated cache of jitted kernels; lives with the plan so a
    # plan cache hit skips XLA recompilation (the analog of the reference's
    # prepared-statement local plan cache, local_plan_cache.c)
    runtime_cache: dict = field(default_factory=dict)
    # distribution-key literal when the router path was chosen (tenant id)
    router_key: Optional[object] = None
    # deferred router pruning (reference: Job->deferredPruning): the
    # filter pins the distribution column to $N — the executor prunes to
    # one shard once the parameter value is bound, reusing this plan and
    # its jitted kernels across values
    router_param: Optional[int] = None
    # (column, physical value, index name) when an equality conjunct hits
    # a secondary index: the scan gathers exact rows via per-stripe
    # segments instead of reading every chunk
    index_eq: Optional[tuple] = None
    # shard-map size at plan time: a mismatch against the live table at
    # execution detects a shard split's catalog flip racing the scan
    # (shard_indexes would resolve against the NEW list) -> re-plan
    table_shard_count: int = -1

    @property
    def is_router(self) -> bool:
        return len(self.shard_indexes) == 1 and self.bound.table.is_distributed

    def resolve_shards(self, param_values: Optional[list]) -> list[int]:
        """Shard indexes for one execution; applies deferred pruning."""
        if self.router_param is None or param_values is None:
            return self.shard_indexes
        v = param_values[self.router_param]
        if v is None:
            return []  # dist = NULL matches nothing
        h = hash_int64_scalar(int(v))
        return [self.bound.table.route_hash(h)]


# ------------------------------------------------------------ pruning


def _conjuncts(e: Optional[BExpr]) -> list[BExpr]:
    if e is None:
        return []
    if isinstance(e, BBinOp) and e.op == "and":
        return _conjuncts(e.left) + _conjuncts(e.right)
    return [e]


def _strip_scale(e: BExpr) -> tuple[BExpr, int]:
    """Peel BScale so `col` compared at an adjusted scale still prunes."""
    if isinstance(e, BScale):
        return e.operand, e.power
    return e, 0


def extract_intervals(filter_: Optional[BExpr]) -> list[Interval]:
    """Chunk-pruning intervals from top-level AND conjuncts of the form
    column <op> literal (possibly scale-adjusted)."""
    out: list[Interval] = []
    for c in _conjuncts(filter_):
        if not (isinstance(c, BBinOp) and c.op in ("=", "<", "<=", ">", ">=")):
            continue
        left, lpow = _strip_scale(c.left)
        right, rpow = _strip_scale(c.right)
        col, lit, op = None, None, c.op
        if isinstance(left, BColumn) and isinstance(right, BLiteral):
            col, lit, colpow, litpow = left, right, lpow, rpow
        elif isinstance(right, BColumn) and isinstance(left, BLiteral):
            col, lit, colpow, litpow = right, left, rpow, lpow
            op = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}.get(op, op)
        if col is None or lit is None or lit.value is None:
            continue
        if col.type.is_text:
            continue  # dictionary ids are not value-ordered
        # value seen by comparison = col * 10^colpow vs lit * 10^litpow
        # -> compare col against lit * 10^(litpow - colpow); only safe when
        # the adjustment is an integer scale-up of the literal
        shift = litpow - colpow
        v = lit.value
        if shift > 0:
            v = v * (10 ** shift)
        elif shift < 0:
            continue
        if op == "=":
            out.append(Interval(col.name, lo=v, hi=v))
        elif op == "<":
            out.append(Interval(col.name, hi=v, hi_inclusive=False))
        elif op == "<=":
            out.append(Interval(col.name, hi=v))
        elif op == ">":
            out.append(Interval(col.name, lo=v, lo_inclusive=False))
        elif op == ">=":
            out.append(Interval(col.name, lo=v))
    return out


def prune_shards(table: TableMeta, filter_: Optional[BExpr],
                 return_key: bool = False):
    """Route to a single shard on distcol = const (reference fast path:
    fast_path_router_planner.c); otherwise all shards."""
    all_idx = list(range(table.shard_count))
    key = None
    if not table.is_distributed or table.dist_column is None:
        return (all_idx, key) if return_key else all_idx
    for c in _conjuncts(filter_):
        if not (isinstance(c, BBinOp) and c.op == "="):
            continue
        left, right = c.left, c.right
        if isinstance(right, BColumn) and isinstance(left, BLiteral):
            left, right = right, left
        if (isinstance(left, BColumn) and left.name == table.dist_column
                and isinstance(right, BLiteral) and right.value is not None
                and not isinstance(right.value, float)):
            h = hash_int64_scalar(int(right.value))
            idx = table.route_hash(h)
            return ([idx], right.value) if return_key else [idx]
    return (all_idx, key) if return_key else all_idx


# ------------------------------------------------------ group strategy


def _key_domain(cat: Catalog, table: TableMeta, key: BExpr,
                bounds: dict[str, tuple]) -> Optional[KeyDomain]:
    """Provable physical domain of a group key, or None."""
    if isinstance(key, BColumn):
        if key.type.kind == T.UUID or T.is_uuid_lane(key.name):
            # 128-bit lane pairs have no enumerable domain
            return None
        if key.type.is_text:
            size = len(cat.dictionary(table.name, key.name))
            return KeyDomain(lo=0, size=size + 1)
        if key.type.kind == T.BOOL:
            return KeyDomain(lo=0, size=3)
        if key.type.is_float:
            # never direct-encode floats: -0.0/0.0 and NaN payloads
            # need the hash path's canonical equality, and NaN poisons
            # min/max stats (which would masquerade as "all null" here)
            return None
        b = bounds.get(key.name)
        if b is None:
            return KeyDomain(lo=0, size=1)  # no rows / all null
        lo, hi, _ = b
        return KeyDomain(lo=int(lo), size=int(hi) - int(lo) + 2)
    if isinstance(key, BDateTrunc):
        inner = _key_domain(cat, table, key.operand, bounds)
        if inner is None:
            return None
        units_date = {"day": 1, "week": 7}
        units_ts = {"minute": 60_000_000, "hour": 3_600_000_000,
                    "day": 86_400_000_000, "week": 7 * 86_400_000_000}
        unit = (units_date if key.operand.type.kind == T.DATE else units_ts).get(key.unit)
        if unit is None:
            return None
        off = 3 * (1 if key.operand.type.kind == T.DATE else 86_400_000_000) if key.unit == "week" else 0
        lo_t = ((inner.lo + off) // unit) * unit - off
        hi_raw = inner.lo + inner.size - 2
        hi_t = ((hi_raw + off) // unit) * unit - off
        n = (hi_t - lo_t) // unit + 1
        return KeyDomain(lo=int(lo_t), size=int(n) + 1, step=int(unit))
    return None


def choose_group_mode(cat: Catalog, bound: BoundSelect, direct_limit: int) -> GroupMode:
    # distinct and collect-based aggregates need exact value multisets:
    # only the host grouping path carries them (reference:
    # worker_partial_agg cannot combine DISTINCT either and falls back to
    # pulling rows)
    from citus_tpu_torch.planner.aggregates import AGG_REGISTRY
    if any(a.distinct or (a.kind in AGG_REGISTRY
                          and AGG_REGISTRY[a.kind].needs_exact)
           for a in bound.aggs):
        return GroupMode(kind="hash_host")
    if not bound.group_keys:
        return GroupMode(kind="scalar")
    # sketch partials whose device shape exists only ungrouped route
    # grouped queries through host grouping
    if any(a.kind in AGG_REGISTRY and AGG_REGISTRY[a.kind].host_grouped
           for a in bound.aggs):
        return GroupMode(kind="hash_host")
    bounds = column_bounds(cat, bound.table)
    domains: list[KeyDomain] = []
    for key in bound.group_keys:
        d = _key_domain(cat, bound.table, key, bounds)
        if d is None:
            return GroupMode(kind="hash_host")
        domains.append(d)
    total = 1
    for d in domains:
        total *= d.size
        if total > direct_limit:
            return GroupMode(kind="hash_host")
    strides = []
    acc = 1
    for d in reversed(domains):
        strides.append(acc)
        acc *= d.size
    strides.reverse()
    return GroupMode(kind="direct", domains=domains, strides=strides, n_groups=total)


# ------------------------------------------------------ aggregate split


def lower_aggregates(aggs: list[AggSpec]) -> tuple[list[BExpr], list[PartialOp], list[AggExtract]]:
    """SQL aggregates -> deduped partial ops (the worker half) and
    extraction recipes (the combine/final half)."""
    agg_args: list[BExpr] = []
    partials: list[PartialOp] = []
    extracts: list[AggExtract] = []

    def arg_slot(e: BExpr) -> int:
        for i, a in enumerate(agg_args):
            if a == e:
                return i
        agg_args.append(e)
        return len(agg_args) - 1

    def partial_slot(kind: str, arg_index: int, dtype: str,
                     extra_args: tuple = ()) -> int:
        op = PartialOp(kind, arg_index, dtype, tuple(extra_args))
        for i, p in enumerate(partials):
            if p == op:
                return i
        partials.append(op)
        return len(partials) - 1

    for spec in aggs:
        if spec.kind == "count_star":
            s = partial_slot("count", -1, "int64")
            extracts.append(AggExtract("count_star", [s], spec.out_type))
            continue
        ai = arg_slot(spec.arg)
        acc_dtype = "float64" if spec.arg.type.is_float else "int64"
        if spec.kind == "count" and spec.distinct:
            s = partial_slot("distinct", ai, "int64")
            extracts.append(AggExtract("count_distinct", [s], spec.out_type))
        elif spec.kind == "count":
            s = partial_slot("count", ai, "int64")
            extracts.append(AggExtract("count", [s], spec.out_type))
        elif spec.kind in ("sum", "avg"):
            s = partial_slot("sum", ai, acc_dtype)
            c = partial_slot("count", ai, "int64")
            slots = [s, c]
            if acc_dtype == "int64" and spec.arg.type.is_numeric:
                # overflow guard (round-4 weak #7): an int64 partial sum
                # wraps silently; a float64 SHADOW sum of the same
                # argument rides alongside — int64 addition is exact mod
                # 2^64, so the final value is correct iff the true sum
                # fits, and |shadow| >= 2^62 proves it cannot (float
                # error is relative, far below the 2x margin).  The
                # reference's NUMERIC never overflows; we error instead
                # of silently wrapping.
                from citus_tpu_torch.planner.bound import BCast
                fa = arg_slot(BCast(spec.arg, T.FLOAT64_T))
                slots.append(partial_slot("sum", fa, "float64"))
            extracts.append(AggExtract(spec.kind, slots, spec.out_type))
        elif spec.kind in ("min", "max"):
            dt = str(spec.arg.type.device_dtype)
            s = partial_slot(spec.kind, ai, dt)
            c = partial_slot("count", ai, "int64")
            extracts.append(AggExtract(spec.kind, [s, c], spec.out_type))
        else:
            from citus_tpu_torch.planner.aggregates import AGG_REGISTRY
            defn = AGG_REGISTRY.get(spec.kind)
            if defn is None:
                raise AssertionError(spec.kind)
            extracts.append(defn.lower(spec, arg_slot, partial_slot))
    return agg_args, partials, extracts


# ------------------------------------------------------------ entry


def _deferred_router_param(table: TableMeta, filter_: Optional[BExpr]) -> Optional[int]:
    """distcol = $N in the filter -> parameter index for deferred pruning."""
    from citus_tpu_torch.planner.bound import BParam
    if not table.is_distributed or table.dist_column is None:
        return None
    for c in _conjuncts(filter_):
        if not (isinstance(c, BBinOp) and c.op == "="):
            continue
        left, right = c.left, c.right
        if isinstance(right, BColumn) and isinstance(left, BParam):
            left, right = right, left
        if (isinstance(left, BColumn) and left.name == table.dist_column
                and isinstance(right, BParam) and not right.type.is_float):
            return right.index
    return None


def _index_eq(table: TableMeta, filter_: Optional[BExpr]):
    """(column, physical value, index name) when an AND conjunct pins an
    indexed column to a literal — the index point-lookup path (reference:
    an index path winning over ColumnarScan in the planner,
    columnar_customscan.c costing vs btree)."""
    for c in _conjuncts(filter_):
        if not (isinstance(c, BBinOp) and c.op == "="):
            continue
        left, right = c.left, c.right
        if isinstance(right, BColumn) and isinstance(left, BLiteral):
            left, right = right, left
        if not (isinstance(left, BColumn) and isinstance(right, BLiteral)
                and right.value is not None):
            continue
        ix = table.index_on(left.name)
        if ix is not None:
            return (left.name, right.value, ix["name"])
    return None


def plan_select(cat: Catalog, bound: BoundSelect, *, direct_limit: int = 65536) -> PhysicalPlan:
    intervals = extract_intervals(bound.filter)
    shard_indexes, router_key = prune_shards(bound.table, bound.filter, return_key=True)
    group_mode = choose_group_mode(cat, bound, direct_limit)
    agg_args, partial_ops, agg_extract = lower_aggregates(bound.aggs)
    return PhysicalPlan(
        bound=bound,
        scan_columns=bound.scan_columns,
        intervals=intervals,
        shard_indexes=shard_indexes,
        group_mode=group_mode,
        agg_args=agg_args,
        partial_ops=partial_ops,
        agg_extract=agg_extract,
        router_key=router_key,
        router_param=_deferred_router_param(bound.table, bound.filter),
        index_eq=_index_eq(bound.table, bound.filter),
        table_shard_count=len(bound.table.shards),
    )
