"""EXPLAIN of a single-table aggregate SELECT.

Reference: the distributed EXPLAIN of multi_explain.c.  The port shows
the plan of the slice it runs: a partitioned parent's surviving
partitions (``Append``) over one of them, the scan with its shard
pruning, index lookup, chunk pruning and the partial aggregate with its
partial ops; EXPLAIN ANALYZE and the other statement kinds are not
ported yet (ROADMAP.md A14).
"""

from __future__ import annotations

from citus_tpu_torch.commands.registry import handles
from citus_tpu_torch.errors import UnsupportedFeatureError
from citus_tpu_torch.executor import Result
from citus_tpu_torch.planner import ast as A
from citus_tpu_torch.planner.bind import bind_select
from citus_tpu_torch.planner.physical import plan_select


@handles(A.Explain)
def execute_explain(cl, stmt: A.Explain) -> Result:
    sel = stmt.statement
    if stmt.analyze:
        raise UnsupportedFeatureError(
            "EXPLAIN ANALYZE is not ported yet (ROADMAP.md A14)")
    if not (isinstance(sel, A.Select) and isinstance(sel.from_, A.TableRef)):
        raise UnsupportedFeatureError(
            "EXPLAIN supports single-table SELECT in this port")
    if cl.catalog.has_table(sel.from_.name) \
            and cl.catalog.table(sel.from_.name).is_partitioned:
        import dataclasses

        from citus_tpu_torch.partitioning import prune_partitions
        pt = cl.catalog.table(sel.from_.name)
        parts = cl.catalog.partitions_of(pt.name)
        surv = prune_partitions(cl.catalog, pt, sel.where)
        lines = [f"Append on {pt.name} "
                 f"(partitions: {len(surv)}/{len(parts)})"]
        if surv:
            rep = dataclasses.replace(sel, from_=A.TableRef(
                surv[0].name, sel.from_.alias or pt.name))
            sub = execute_explain(cl, A.Explain(rep, analyze=False))
            lines.append(f"  Partitions Shown: One of {len(surv)}")
            lines.extend("  " + r[0] for r in sub.rows)
        return Result(columns=["QUERY PLAN"], rows=[(ln,) for ln in lines])
    bound = bind_select(cl.catalog, sel)
    plan = plan_select(cl.catalog, bound,
                       direct_limit=cl.settings.planner.direct_gid_limit)
    t = bound.table
    kind = ("Router" if plan.is_router else "Distributed") \
        if t.is_distributed else "Local"
    lines = [f"{kind} Scan on {t.name} "
             f"(shards: {len(plan.shard_indexes)}/{t.shard_count})"]
    if plan.index_eq is not None:
        icol, ival, iname = plan.index_eq
        if t.schema.scan_column(icol).type.is_text:
            # the literal was bound to its dictionary id: show the string
            decoded = cl.catalog.decode_strings(t.name, icol, [int(ival)])
            ival = decoded[0] if decoded else ival
        lines.append(f"  Index Lookup: {icol} = {ival!r} using {iname}")
    if plan.intervals:
        lines.append("  Chunk Pruning: " +
                     ", ".join(sorted({c.column for c in plan.intervals})))
    if bound.has_aggs:
        mode = plan.group_mode
        desc = {"scalar": "Global Aggregate",
                "direct": f"Direct GroupBy (groups: {mode.n_groups}, "
                          "combine: host)",
                "hash_host": "Hash GroupBy (host combine)"}[mode.kind]
        lines.append(f"  Partial Aggregate per shard -> {desc}")
        lines.append("    Partials: " + ", ".join(
            f"{op.kind}[{op.dtype}]" for op in plan.partial_ops))
    return Result(columns=["QUERY PLAN"], rows=[(ln,) for ln in lines])
