"""Join planning.

The reference supports three physical join strategies for distributed
relations (src/backend/distributed/planner/ — query_pushdown_planning.c,
multi_join_order.c, multi_physical_planner.c MapMergeJob):

1. *colocated* joins — equality on distribution columns within one
   colocation group: each shard joins locally with its colocated peers.
2. *broadcast* joins — reference/local tables are replicated, so any
   relation can join against them shard-locally.
3. *repartition* joins — equality on non-distribution columns: both
   sides are re-hashed on the join key (MapMergeJob / all_to_all).

This planner classifies a left-deep join tree into those strategies and
pushes single-relation WHERE conjuncts down to each scan (with chunk
pruning intervals), mirroring the reference's qual pushdown.  When
colocation cannot be proven, the executor falls back to a repartitioned
or pull-to-coordinator join — same degradation ladder as the reference.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from citus_tpu_torch import types as T
from citus_tpu_torch.catalog import Catalog, TableMeta
from citus_tpu_torch.errors import AnalysisError, UnsupportedFeatureError
from citus_tpu_torch.planner import ast_nodes as A
from citus_tpu_torch.planner.bind import AggSpec, Binder, _contains_agg, _default_name
from citus_tpu_torch.planner.bound import (
    BBinOp, BColumn, BExpr, BKeyRef, BLiteral, walk,
)
from citus_tpu_torch.planner.physical import (
    AggExtract, PartialOp, extract_intervals, lower_aggregates,
)
from citus_tpu_torch.storage.reader import Interval


@dataclass
class RelPlan:
    """Per-relation scan spec."""
    alias: str
    table: TableMeta
    columns: list[str] = field(default_factory=list)   # unqualified
    filter: Optional[BExpr] = None                     # single-rel conjuncts
    intervals: list[Interval] = field(default_factory=list)


@dataclass
class JoinStep:
    right_alias: str
    kind: str                                   # inner | left | right | full | cross
    left_keys: list[BExpr] = field(default_factory=list)
    right_keys: list[BExpr] = field(default_factory=list)
    residual: Optional[BExpr] = None            # non-equi ON conjuncts


@dataclass
class BoundJoinSelect:
    rels: list[tuple[str, TableMeta]]
    rel_plans: dict[str, RelPlan]
    steps: list[JoinStep]
    post_filter: Optional[BExpr]                # cross-rel WHERE conjuncts
    group_keys: list[BExpr]
    aggs: list[AggSpec]
    final_exprs: list[BExpr]
    output_names: list[str]
    having: Optional[BExpr]
    order_by: list[tuple[int, bool, Optional[bool]]]
    limit: Optional[int]
    offset: Optional[int]
    distinct: bool
    agg_args: list[BExpr] = field(default_factory=list)
    partial_ops: list[PartialOp] = field(default_factory=list)
    agg_extract: list[AggExtract] = field(default_factory=list)
    strategy: str = "colocated"                 # colocated | repartition | pull
    # for repartition: (left_alias, right_alias, left_keys, right_keys)
    # of the step connecting the two distributed relations
    repartition_spec: Optional[tuple] = None
    binder: Optional[Binder] = None
    hidden_outputs: int = 0

    @property
    def has_aggs(self) -> bool:
        return bool(self.aggs) or bool(self.group_keys)


def _flatten_joins(item) -> tuple[list[A.TableRef], list[tuple[A.TableRef, str, Optional[A.Expr]]]]:
    """Left-deep join tree -> (base rel, [(right rel, kind, on-cond)...])."""
    if isinstance(item, A.TableRef):
        return [item], []
    if isinstance(item, A.Join):
        refs, steps = _flatten_joins(item.left)
        if not isinstance(item.right, A.TableRef):
            raise UnsupportedFeatureError("right-nested joins are not supported")
        steps.append((item.right, item.kind, item.condition))
        refs.append(item.right)
        return refs, steps
    raise AnalysisError("bad FROM item")


def _rel_of(e: BExpr, qualified: bool) -> Optional[str]:
    """The single relation alias an expression references, or None."""
    aliases = set()
    for n in walk(e):
        if isinstance(n, BColumn):
            aliases.add(n.name.split(".", 1)[0] if qualified and "." in n.name else n.name)
    if not qualified:
        return None
    return aliases.pop() if len(aliases) == 1 else None


def _conjuncts(e: Optional[BExpr]) -> list[BExpr]:
    if e is None:
        return []
    if isinstance(e, BBinOp) and e.op == "and":
        return _conjuncts(e.left) + _conjuncts(e.right)
    return [e]


def _and_all(parts: list[BExpr]) -> Optional[BExpr]:
    out = None
    for p in parts:
        out = p if out is None else BBinOp("and", out, p, T.BOOL_T)
    return out


def bind_join_select(catalog: Catalog, stmt: A.Select) -> BoundJoinSelect:
    refs, raw_steps = _flatten_joins(stmt.from_)
    rels: list[tuple[str, TableMeta]] = []
    seen = set()
    for r in refs:
        alias = r.alias or r.name
        if alias in seen:
            raise AnalysisError(f"duplicate relation alias {alias!r}")
        seen.add(alias)
        rels.append((alias, catalog.table(r.name)))
    binder = Binder(catalog, rels[0][1], rels=rels)

    def rel_alias_of_col(e: BExpr) -> Optional[str]:
        return _rel_of(e, binder.qualified)

    # ---- join steps: split ON into equi-pairs and residual ------------
    joined: list[str] = [rels[0][0]]
    steps: list[JoinStep] = []
    for (r, kind, cond) in raw_steps:
        alias = r.alias or r.name
        step = JoinStep(right_alias=alias, kind=kind)
        residual = []
        if cond is not None:
            for c in _conjuncts(binder.bind_scalar(cond)):
                ok = False
                if isinstance(c, BBinOp) and c.op == "=":
                    la, ra = rel_alias_of_col(c.left), rel_alias_of_col(c.right)
                    if la == alias and ra in joined:
                        step.left_keys.append(c.right)
                        step.right_keys.append(c.left)
                        ok = True
                    elif ra == alias and la in joined:
                        step.left_keys.append(c.left)
                        step.right_keys.append(c.right)
                        ok = True
                if not ok:
                    residual.append(c)
        if residual:
            if kind != "inner":
                raise UnsupportedFeatureError(
                    "non-equi ON conditions on outer joins are not supported yet")
            step.residual = _and_all(residual)
        if kind != "cross" and not step.left_keys and step.residual is None:
            raise AnalysisError("JOIN requires an ON condition")
        steps.append(step)
        joined.append(alias)

    # ---- WHERE: push single-relation conjuncts to scans ----------------
    where = binder.bind_scalar(stmt.where) if stmt.where is not None else None
    rel_plans = {alias: RelPlan(alias, t) for alias, t in rels}
    cross_conjuncts: list[BExpr] = []
    outer_right = {s.right_alias for s in steps if s.kind in ("left", "full")}
    left_of_right_join = set()
    for s in steps:
        if s.kind in ("right", "full"):
            left_of_right_join.update(a for a in joined if a != s.right_alias)
    for c in _conjuncts(where):
        alias = rel_alias_of_col(c)
        # pushing a filter below an outer join's null-supplying side would
        # change semantics; keep those conjuncts post-join
        if alias is not None and alias not in outer_right and alias not in left_of_right_join:
            rp = rel_plans[alias]
            rp.filter = c if rp.filter is None else BBinOp("and", rp.filter, c, T.BOOL_T)
        else:
            cross_conjuncts.append(c)
    post_filter = _and_all(cross_conjuncts)
    for rp in rel_plans.values():
        # intervals operate on unqualified column names within the relation
        rp.intervals = [Interval(c.column.split(".", 1)[-1], c.lo, c.hi,
                                 c.lo_inclusive, c.hi_inclusive)
                        for c in extract_intervals(rp.filter)]

    # ---- outputs / aggregates ------------------------------------------
    items: list[A.SelectItem] = []
    for item in stmt.items:
        if isinstance(item.expr, A.Star):
            for alias, t in rels:
                for col in t.schema:
                    items.append(A.SelectItem(A.ColumnRef(col.name, table=alias), col.name))
        else:
            items.append(item)

    group_keys = [binder.bind_scalar(g) for g in stmt.group_by]
    key_map = {k: i for i, k in enumerate(group_keys)}
    binder._ast_key_map = {}
    binder._ast_key_types = [k.type for k in group_keys]
    for i, g in enumerate(stmt.group_by):
        try:
            binder._ast_key_map.setdefault(g, i)
        except TypeError:
            pass
    has_aggs = any(_contains_agg(i.expr) for i in items) or stmt.having is not None or bool(group_keys)

    aggs: list[AggSpec] = []
    final_exprs: list[BExpr] = []
    output_names: list[str] = []
    having = None
    if has_aggs:
        for i, item in enumerate(items):
            final_exprs.append(binder.bind_select_expr(item.expr, key_map, aggs))
            output_names.append(item.alias or _default_name(item.expr, i))
        if stmt.having is not None:
            having = binder.bind_select_expr(stmt.having, key_map, aggs)
    else:
        for i, item in enumerate(items):
            final_exprs.append(binder.bind_scalar(item.expr))
            output_names.append(item.alias or _default_name(item.expr, i))

    order_by = []
    hidden = 0
    for oi in stmt.order_by:
        try:
            idx = _resolve_order(oi.expr, items, output_names, binder,
                                 final_exprs, key_map, aggs)
        except AnalysisError:
            if stmt.distinct:
                raise
            bound_e = (binder.bind_select_expr(oi.expr, key_map, aggs)
                       if has_aggs else binder.bind_scalar(oi.expr))
            final_exprs.append(bound_e)
            output_names.append(f"__order_{hidden}")
            idx = len(final_exprs) - 1
            hidden += 1
        order_by.append((idx, oi.ascending, oi.nulls_first))

    # enum ORDER BY keys sort by declaration rank (enumsortorder) — same
    # redirect as bind_select's: hidden rank column, functionally
    # dependent on the enum value
    from citus_tpu_torch.planner.bound import BDictLookup, BKeyRef
    for oi_pos, (idx, asc, nf) in enumerate(order_by):
        e_b = final_exprs[idx]
        under = e_b
        if isinstance(e_b, BKeyRef) and group_keys:
            under = group_keys[e_b.index]
        if not (isinstance(under, BColumn) and under.type.is_text):
            continue
        info = binder.enum_info(under)
        if info is None:
            continue
        final_exprs.append(BDictLookup(e_b, binder.enum_rank_lut(info)))
        output_names.append(f"__order_{hidden}")
        order_by[oi_pos] = (len(final_exprs) - 1, asc, nf)
        hidden += 1

    agg_args, partial_ops, agg_extract = lower_aggregates(aggs)

    # ---- column requirements per relation ------------------------------
    def note_columns(e: Optional[BExpr]):
        if e is None:
            return
        for n in walk(e):
            if isinstance(n, BColumn):
                if binder.qualified and "." in n.name:
                    alias, col = n.name.split(".", 1)
                else:
                    # resolve bare name (only possible when unambiguous)
                    _, c, alias, _t = binder.resolve_column(n.name)
                    col = c.name
                rp = rel_plans[alias]
                if col not in rp.columns:
                    rp.columns.append(col)

    for rp in rel_plans.values():
        note_columns(rp.filter)
    note_columns(post_filter)
    for s in steps:
        for e in s.left_keys + s.right_keys:
            note_columns(e)
        note_columns(s.residual)
    for e in group_keys + agg_args:
        note_columns(e)
    if not has_aggs:
        for e in final_exprs:
            note_columns(e)
    if having is not None:
        note_columns(having)
    # (hidden ORDER BY columns were appended to final_exprs above and are
    # covered by the loop when not aggregating; grouped hidden outputs
    # reference keys/aggs already noted)

    bj = BoundJoinSelect(
        rels=rels, rel_plans=rel_plans, steps=steps, post_filter=post_filter,
        group_keys=group_keys, aggs=aggs, final_exprs=final_exprs,
        output_names=output_names, having=having, order_by=order_by,
        limit=stmt.limit, offset=stmt.offset, distinct=stmt.distinct,
        agg_args=agg_args, partial_ops=partial_ops, agg_extract=agg_extract,
        binder=binder, hidden_outputs=hidden,
    )
    bj.strategy = _choose_strategy(bj)
    return bj


def _resolve_order(e: A.Expr, items, names, binder, final_exprs, key_map, aggs) -> int:
    if isinstance(e, A.Literal) and isinstance(e.value, int):
        idx = e.value - 1
        if not (0 <= idx < len(items)):
            raise AnalysisError(f"ORDER BY position {e.value} out of range")
        return idx
    if isinstance(e, A.ColumnRef) and e.table is None and e.name in names:
        return names.index(e.name)
    for i, item in enumerate(items):
        if item.expr == e:
            return i
    # try binding and matching structurally against final exprs
    try:
        bound = binder.bind_select_expr(e, key_map, list(aggs)) if aggs or key_map \
            else binder.bind_scalar(e)
    except Exception:
        bound = None
    if bound is not None:
        for i, fe in enumerate(final_exprs):
            if fe == bound:
                return i
    raise AnalysisError("ORDER BY expression must be an output column, alias, or position")


def _dist_col_expr(alias: str, t: TableMeta, qualified: bool) -> Optional[BColumn]:
    if not t.is_distributed or t.dist_column is None:
        return None
    col = t.schema.column(t.dist_column)
    name = f"{alias}.{col.name}" if qualified else col.name
    return BColumn(name, col.type)


def _choose_strategy(bj: BoundJoinSelect) -> str:
    """colocated: every distributed relation is equi-joined on its
    distribution column to an already-aligned distributed relation in the
    same colocation group (reference/local relations are replicated and
    always alignable).  Otherwise: pull (repartition on the coordinator).
    """
    qualified = bj.binder.qualified
    dist_rels = [(a, t) for a, t in bj.rels if t.is_distributed]
    if not dist_rels:
        return "colocated"  # everything replicated/local: single task
    anchor_alias, anchor = dist_rels[0]
    aligned = {anchor_alias}
    # iterate to fixpoint over join steps
    changed = True
    while changed:
        changed = False
        for s in bj.steps:
            t_right = dict(bj.rels)[s.right_alias]
            if not t_right.is_distributed or s.right_alias in aligned:
                continue
            rd = _dist_col_expr(s.right_alias, t_right, qualified)
            for lk, rk in zip(s.left_keys, s.right_keys):
                other = None
                if rk == rd:
                    other = lk
                elif lk == rd:
                    other = rk
                if other is None:
                    continue
                oa = _rel_of(other, qualified)
                if oa is None or oa not in aligned:
                    continue
                t_other = dict(bj.rels)[oa]
                od = _dist_col_expr(oa, t_other, qualified)
                if od is not None and other == od and \
                        t_other.colocation_id == t_right.colocation_id and \
                        t_other.shard_count == t_right.shard_count:
                    aligned.add(s.right_alias)
                    changed = True
    if all(a in aligned for a, t in dist_rels):
        return "colocated"
    spec = _repartition_spec(bj)
    if spec is not None:
        bj.repartition_spec = spec
        return "repartition"
    if any(s.left_keys for s in bj.steps):
        # general case: step-wise shuffle DAG (each equi step partitions
        # both sides on its keys, joins per bucket) — always correct,
        # bounds each join's working set; repartition_spec stays None
        return "repartition"
    return "pull"


def _repartition_spec(bj: BoundJoinSelect) -> Optional[tuple]:
    """Eligibility for the hash-repartition (all_to_all) join — the
    analog of the reference's single-repartition MapMergeJob
    (multi_physical_planner.h:160): exactly two distributed relations,
    connected by an equi-join step whose keys live one per side; every
    other relation replicated (reference/local) and inner-joined.  Rows
    then match only within a hash bucket, so per-bucket joins are exact
    — including an outer dist-dist step (NULL-key rows never match and
    are preserved bucket-locally).

    Returns (left_alias, right_alias, left_key_exprs, right_key_exprs)
    or None."""
    qualified = bj.binder.qualified
    dist = [(a, t) for a, t in bj.rels if t.is_distributed]
    if len(dist) != 2:
        return None
    d_aliases = {a for a, _ in dist}
    connecting = None
    for s in bj.steps:
        if s.right_alias in d_aliases and s.left_keys:
            lks, rks = [], []
            for lk, rk in zip(s.left_keys, s.right_keys):
                la, ra = _rel_of(lk, qualified), _rel_of(rk, qualified)
                if la in d_aliases and ra in d_aliases and la != ra:
                    lks.append(lk)
                    rks.append(rk)
            if lks:
                if connecting is not None:
                    return None  # two dist-dist steps: not single-repartition
                connecting = (s, lks, rks)
        elif s.right_alias in d_aliases:
            return None  # dist rel joined without usable equi keys
        elif s.kind in ("right", "full"):
            # preserved unmatched rows of a replicated right side would
            # re-appear in every bucket
            return None
    if connecting is None:
        return None
    s, lks, rks = connecting
    left_alias = _rel_of(lks[0], qualified)
    return (left_alias, s.right_alias, lks, rks)
