"""DML statement handlers: COPY to and from files, DELETE, UPDATE,
MERGE, TRUNCATE, VACUUM [ANALYZE], ANALYZE and REINDEX.

Reference: the modify paths of multi_router_planner.c
(CreateModifyPlan), commands/multi_copy.c, merge_planner/executor,
and commands/truncate.c / vacuum.c; each handler drives the columnar
DML executors (executor/dml.py, executor/merge_executor.py) under the
colocation-group write lock, invalidates the table's cached plans and
emits its change to the CDC stream.  This is the local half of
citus_tpu/commands/dml.py: RETURNING, the foreign-key actions of a
parent's DELETE and UPDATE (RESTRICT / CASCADE / SET NULL), CHECK,
domain, unique and partition-bound checks on UPDATE, and DML, TRUNCATE and
VACUUM on partitioned parents by fan-out.  A modify of a table that
another coordinator hosts shards of (its forwarding and cross-host 2PC),
and a COPY TO of one, raise, naming ROADMAP.md A13.
"""

from __future__ import annotations

import contextlib

from citus_tpu_torch.commands.registry import handles
from citus_tpu_torch.errors import AnalysisError, UnsupportedFeatureError
from citus_tpu_torch.executor import Result
from citus_tpu_torch.planner import ast as A


def refuse_remote_placements(
        cl, t, what: str,
        work: str = "cross-host DML and its two-phase commit") -> None:
    """A modify of a table some of whose placements another coordinator
    hosts would be forwarded there and committed by cross-host 2PC
    (the reference's ``_forward_remote_dml``/``_two_phase_remote_dml``):
    not ported yet.  ``work`` names what the statement would need."""
    cat = cl.catalog
    if cat.remote_data is not None and any(
            cat.is_remote_node(nd) for s in t.shards for nd in s.placements):
        raise UnsupportedFeatureError(
            f"{what} of a table with shards hosted by another coordinator "
            f"({work}) is not ported yet (ROADMAP.md A13)")


@handles(A.CopyTo)
def copy_to(cl, stmt):
    from citus_tpu_torch.cluster import _option_bool
    # both exports read local placements only: a remote-hosted shard's
    # rows would be missing from the file (ROADMAP.md C18)
    refuse_remote_placements(cl, cl.catalog.table(stmt.table), "COPY TO",
                             "reading another coordinator's placements")
    if str(stmt.options.get("format", "csv")).lower() == "binary":
        from citus_tpu_torch.commands.copy_binary import copy_to_binary
        n = copy_to_binary(cl, stmt.table, stmt.path)
        return Result(columns=[], rows=[], explain={"copied": n})
    n = cl.copy_to_csv(
        stmt.table, stmt.path,
        delimiter=stmt.options.get("delimiter", ","),
        header=_option_bool(stmt.options.get("header", "false")),
        null_string=stmt.options.get("null", ""))
    return Result(columns=[], rows=[], explain={"copied": n})


@handles(A.CopyQueryTo)
def copy_query_to(cl, stmt):
    from citus_tpu_torch.cluster import _option_bool
    r = cl._execute_stmt(stmt.select)
    nulls = stmt.options.get("null", "")
    with open(stmt.path, "w", newline="") as fh:
        w = cl._open_csv_writer(
            fh, r.columns,
            delimiter=stmt.options.get("delimiter", ","),
            header=_option_bool(stmt.options.get("header", "false")))
        for row in r.rows:
            w.writerow([nulls if v is None else v for v in row])
    return Result(columns=[], rows=[], explain={"copied": len(r.rows)})


@handles(A.CopyFrom)
def copy_from(cl, stmt):
    from citus_tpu_torch.cluster import _option_bool
    if str(stmt.options.get("format", "csv")).lower() == "binary":
        from citus_tpu_torch.commands.copy_binary import copy_from_binary
        n = copy_from_binary(cl, stmt.table, stmt.path)
        return Result(columns=[], rows=[], explain={"copied": n})
    n = cl.copy_from_csv(
        stmt.table, stmt.path,
        delimiter=stmt.options.get("delimiter", ","),
        header=_option_bool(stmt.options.get("header", "false")),
        null_string=stmt.options.get("null", ""))
    return Result(columns=[], rows=[], explain={"copied": n})


@handles(A.Delete)
def delete(cl, stmt):
    from citus_tpu_torch.executor.dml import execute_delete
    from citus_tpu_torch.planner.bind import Binder
    from citus_tpu_torch.storage.overlay import current_overlay
    from citus_tpu_torch.transaction.locks import EXCLUSIVE
    t = cl.catalog.table(stmt.table)
    if t.is_partitioned:
        return cl._partition_dml(stmt, t)
    refuse_remote_placements(cl, t, "DELETE")
    where = Binder(cl.catalog, t).bind_scalar(stmt.where) \
        if stmt.where is not None else None
    with cl._write_lock(t, EXCLUSIVE):
        if cl.catalog.referencing_fks(stmt.table):
            # RESTRICT / CASCADE / SET NULL on referencing tables
            # before the parent rows disappear
            from citus_tpu_torch.integrity import on_parent_delete
            on_parent_delete(cl, stmt.table, stmt.where)
        # RETURNING reads the pre-image under the same lock so the rows
        # returned are exactly the rows deleted
        ret = cl._returning_result(stmt.table, stmt.where,
                                   stmt.returning) \
            if stmt.returning else None
        t = cl.catalog.table(stmt.table)  # re-fetch: fresh placements
        n = execute_delete(cl.catalog, cl.txlog, t, where,
                           txn=current_overlay())
    cl._plan_cache.invalidate_table(t.name)
    if cl._cdc_captures(t.name) and n:
        cl._emit_cdc(t.name, "delete", count=n)
    if ret is not None:
        ret.explain["deleted"] = n
        return ret
    return Result(columns=[], rows=[], explain={"deleted": n})


@handles(A.Update)
def update(cl, stmt):
    from citus_tpu_torch.executor.dml import execute_update
    from citus_tpu_torch.planner.bind import Binder
    from citus_tpu_torch.planner.bound import BCast, BLiteral
    from citus_tpu_torch.storage.overlay import current_overlay
    from citus_tpu_torch.transaction.locks import EXCLUSIVE
    t = cl.catalog.table(stmt.table)
    if t.is_partitioned:
        return cl._partition_dml(stmt, t)
    refuse_remote_placements(cl, t, "UPDATE")
    b = Binder(cl.catalog, t)
    assignments = []
    for col, e in stmt.assignments:
        target = t.schema.column(col)
        bound = b.bind_scalar(e)
        if target.type.kind == "uuid":
            # fold a string literal to the physical 128-bit value here;
            # the executor splits it into int64 lanes
            if isinstance(bound, BLiteral) and isinstance(bound.value, str):
                bound = BLiteral(target.type.to_physical(bound.value),
                                 target.type)
            elif bound.type.kind != "uuid":
                raise AnalysisError(
                    f"cannot assign {bound.type} to {col} ({target.type})")
            assignments.append((col, bound))
            continue
        if target.type.is_text:
            if isinstance(bound, BLiteral) and isinstance(bound.value, str):
                did = cl.catalog.encode_strings(t.name, col, [bound.value])[0]
                bound = BLiteral(int(did), target.type)
            elif not bound.type.is_text:
                raise AnalysisError(
                    f"cannot assign {bound.type} to {col} ({target.type})")
        elif bound.type.is_text:
            raise AnalysisError(
                f"cannot assign text to {col} ({target.type})")
        elif bound.type != target.type:
            bound = BCast(bound, target.type)
        assignments.append((col, bound))
    where = b.bind_scalar(stmt.where) if stmt.where is not None else None
    with cl._write_lock(t, EXCLUSIVE):
        assigned_cols = {c for c, _e in stmt.assignments}
        if cl.catalog.referencing_fks(stmt.table):
            from citus_tpu_torch.integrity import on_parent_update
            on_parent_update(cl, stmt.table, assigned_cols,
                             stmt.where, stmt.assignments)
        if t.foreign_keys:
            from citus_tpu_torch.integrity import check_child_update
            check_child_update(cl, t, stmt.assignments)
        ret = None
        if stmt.returning:
            # new values = assignments substituted into the items,
            # evaluated over the pre-image under the same lock
            subst = {}
            for col, e in stmt.assignments:
                subst[A.ColumnRef(col)] = e
                subst[A.ColumnRef(col, stmt.table)] = e
            ret = cl._returning_result(stmt.table, stmt.where,
                                       stmt.returning, subst)
        t = cl.catalog.table(stmt.table)  # re-fetch: fresh placements
        assigned = {c for c, _e in stmt.assignments}
        checks = []
        if any(c in assigned
               for c, _dn, _d in cl._domain_columns_of(t)):
            # a domain's CHECK runs over the re-inserted rows' new values
            checks.append(
                lambda v, m: cl._check_domains_physical(t, v, m))
        if t.partition_of is not None:
            from citus_tpu_torch.partitioning import check_partition_bounds
            checks.append(
                lambda v, m: check_partition_bounds(cl.catalog, t, v, m))
        if t.check_constraints:
            from citus_tpu_torch.integrity import enforce_check_constraints
            checks.append(
                lambda v, m: enforce_check_constraints(cl.catalog, t, v, m))
        check = None
        if checks:
            check = lambda v, m: [c(v, m) for c in checks]  # noqa: E731
        n = execute_update(cl.catalog, cl.txlog, t, assignments, where,
                           txn=current_overlay(), check=check)
    cl._plan_cache.invalidate_table(t.name)
    if cl._cdc_captures(t.name) and n:
        cl._emit_cdc(t.name, "update", count=n)
    if ret is not None:
        ret.explain["updated"] = n
        return ret
    return Result(columns=[], rows=[], explain={"updated": n})


@handles(A.Truncate)
def truncate(cl, stmt):
    from citus_tpu_torch.integrity import forbid_truncate_referenced
    from citus_tpu_torch.transaction.locks import EXCLUSIVE
    from citus_tpu_torch.transaction.write_locks import group_resource
    # validate EVERY relation up front (existence + FK rule with
    # list-awareness: a referenced parent is fine when all its children
    # are in the same list, like PostgreSQL): truncation deletes files
    # irreversibly, so a bad later name must not leave earlier tables
    # already emptied
    names = (stmt.table,) + tuple(stmt.more)
    expanded = []
    for name in names:
        t0 = cl.catalog.table(name)
        expanded.append(name)
        if t0.is_partitioned:
            expanded += [p.name for p in cl.catalog.partitions_of(name)]
    for name in expanded:
        forbid_truncate_referenced(cl.catalog, name,
                                   also_truncated=set(expanded))
    # every relation's EXCLUSIVE lock (sorted: no lock-order inversion)
    # before the first irreversible flip, so TRUNCATE a, b is
    # all-or-nothing against a lock timeout
    metas = {}
    for name in expanded:
        t0 = cl.catalog.table(name)
        if not t0.is_partitioned:
            refuse_remote_placements(cl, t0, "TRUNCATE")
            metas.setdefault(group_resource(t0), t0)
    with contextlib.ExitStack() as stack:
        for res in sorted(metas):
            stack.enter_context(cl._write_lock(metas[res], EXCLUSIVE))
        for name in names:
            cl._truncate_one(name)
    return Result(columns=[], rows=[])


@handles(A.Vacuum)
def vacuum(cl, stmt):
    from citus_tpu_torch.executor.dml import execute_vacuum
    from citus_tpu_torch.transaction.locks import EXCLUSIVE
    t = cl.catalog.table(stmt.table)
    if t.is_partitioned:
        # the parent holds no data: vacuum every partition
        return cl._fanout_partitions(stmt, aggregate_explain=True)
    refuse_remote_placements(cl, t, "VACUUM")
    with cl._write_lock(t, EXCLUSIVE):
        st = execute_vacuum(cl.catalog, cl.catalog.table(stmt.table))
    cl._plan_cache.invalidate_table(t.name)
    return Result(columns=[], rows=[], explain=st)


@handles(A.Merge)
def merge(cl, stmt):
    from citus_tpu_torch.executor.merge_executor import execute_merge
    from citus_tpu_torch.transaction.locks import EXCLUSIVE
    _mt = cl.catalog.table(stmt.target.name)
    # the merge executor reads and writes placements directly: a
    # remote-hosted shard would look empty
    refuse_remote_placements(cl, _mt, "MERGE")
    if _mt.foreign_keys or cl.catalog.referencing_fks(_mt.name):
        # the merge executor writes through the storage layer directly;
        # fail closed rather than bypass FK enforcement
        raise UnsupportedFeatureError(
            "MERGE on tables with foreign key constraints is not "
            "supported")
    # unique indexes are enforced inside execute_merge (pre-commit
    # delete-aware probe); FK targets stay refused above
    with cl._write_lock(cl.catalog.table(stmt.target.name), EXCLUSIVE):
        st = execute_merge(
            cl.catalog, cl.txlog, stmt,
            encode_value=lambda tbl, col, v:
                int(cl.catalog.encode_strings(tbl, col, [v])[0]))
    cl._plan_cache.invalidate_table(stmt.target.name)
    if cl._cdc_captures(stmt.target.name):
        cl.cdc.emit(stmt.target.name, "merge",
                    cl.clock.transaction_clock(), force=True,
                    count=sum(st.values()))
    return Result(columns=[], rows=[], explain=st)


@handles(A.VacuumAnalyze)
def vacuum_analyze(cl, stmt):
    cl._execute_stmt(A.Vacuum(stmt.table, stmt.full))
    return cl._execute_analyze(stmt.table)


@handles(A.Analyze)
def analyze(cl, stmt):
    return cl._execute_analyze(stmt.table)


@handles(A.Reindex)
def reindex(cl, stmt):
    return cl._execute_reindex(stmt)
