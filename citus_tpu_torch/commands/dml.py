"""DML statement handlers: DELETE, UPDATE, TRUNCATE.

Reference: the modify paths of multi_router_planner.c
(CreateModifyPlan) and commands/truncate.c; each handler drives the
columnar DML executors (executor/dml.py) under the colocation-group
write lock, invalidates the table's cached plans and emits its change
to the CDC stream.  This is the local half of citus_tpu/commands/dml.py:
a modify of a table that another coordinator hosts shards of (its
forwarding and cross-host 2PC) raises, naming ROADMAP.md A11; RETURNING,
foreign-key actions, partitioned tables, CHECK/domain constraints and
MERGE are not ported yet (ROADMAP.md A11).
"""

from __future__ import annotations

import contextlib

from citus_tpu_torch.commands.registry import handles
from citus_tpu_torch.errors import AnalysisError, UnsupportedFeatureError
from citus_tpu_torch.executor import Result
from citus_tpu_torch.planner import ast as A


def refuse_remote_placements(cl, t, what: str) -> None:
    """A modify of a table some of whose placements another coordinator
    hosts would be forwarded there and committed by cross-host 2PC
    (the reference's ``_forward_remote_dml``/``_two_phase_remote_dml``):
    not ported yet."""
    cat = cl.catalog
    if cat.remote_data is not None and any(
            cat.is_remote_node(nd) for s in t.shards for nd in s.placements):
        raise UnsupportedFeatureError(
            f"{what} of a table with shards hosted by another coordinator "
            "(cross-host DML and its two-phase commit) is not ported yet "
            "(ROADMAP.md A11)")


def _refuse_unported(cl, stmt, t) -> None:
    refuse_remote_placements(cl, t, type(stmt).__name__.upper())
    if getattr(stmt, "returning", None):
        raise UnsupportedFeatureError(
            "RETURNING is not ported yet (ROADMAP.md A11)")
    if t.is_partitioned or t.partition_of is not None:
        raise UnsupportedFeatureError(
            "DML on partitioned tables is not ported yet (ROADMAP.md A11)")
    if t.foreign_keys or cl.catalog.referencing_fks(t.name) \
            or t.check_constraints:
        raise UnsupportedFeatureError(
            "DML on tables with foreign keys or CHECK constraints is not "
            "ported yet (ROADMAP.md A11)")


@handles(A.Delete)
def delete(cl, stmt):
    from citus_tpu_torch.executor.dml import execute_delete
    from citus_tpu_torch.planner.bind import Binder
    from citus_tpu_torch.storage.overlay import current_overlay
    from citus_tpu_torch.transaction.locks import EXCLUSIVE
    t = cl.catalog.table(stmt.table)
    _refuse_unported(cl, stmt, t)
    where = Binder(cl.catalog, t).bind_scalar(stmt.where) \
        if stmt.where is not None else None
    with cl._write_lock(t, EXCLUSIVE):
        t = cl.catalog.table(stmt.table)  # re-fetch: fresh placements
        n = execute_delete(cl.catalog, cl.txlog, t, where,
                           txn=current_overlay())
    cl._plan_cache.invalidate_table(t.name)
    if cl._cdc_captures(t.name) and n:
        cl._emit_cdc(t.name, "delete", count=n)
    return Result(columns=[], rows=[], explain={"deleted": n})


@handles(A.Update)
def update(cl, stmt):
    from citus_tpu_torch.executor.dml import execute_update
    from citus_tpu_torch.planner.bind import Binder
    from citus_tpu_torch.planner.bound import BCast, BLiteral
    from citus_tpu_torch.storage.overlay import current_overlay
    from citus_tpu_torch.transaction.locks import EXCLUSIVE
    t = cl.catalog.table(stmt.table)
    _refuse_unported(cl, stmt, t)
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
    if any(f"{t.name}.{c}" in cl.catalog.domain_columns
           for c, _e in stmt.assignments):
        raise UnsupportedFeatureError(
            "UPDATE of a domain-typed column is not ported yet "
            "(ROADMAP.md A11)")
    with cl._write_lock(t, EXCLUSIVE):
        t = cl.catalog.table(stmt.table)  # re-fetch: fresh placements
        n = execute_update(cl.catalog, cl.txlog, t, assignments, where,
                           txn=current_overlay())
    cl._plan_cache.invalidate_table(t.name)
    if cl._cdc_captures(t.name) and n:
        cl._emit_cdc(t.name, "update", count=n)
    return Result(columns=[], rows=[], explain={"updated": n})


@handles(A.Truncate)
def truncate(cl, stmt):
    from citus_tpu_torch.transaction.locks import EXCLUSIVE
    from citus_tpu_torch.transaction.write_locks import group_resource
    # validate EVERY relation up front: truncation deletes files
    # irreversibly, so a bad later name must not leave earlier tables
    # already emptied
    names = (stmt.table,) + tuple(stmt.more)
    metas = {}
    for name in names:
        t0 = cl.catalog.table(name)
        if t0.is_partitioned:
            raise UnsupportedFeatureError(
                "TRUNCATE of a partitioned table is not ported yet "
                "(ROADMAP.md A11)")
        refs = {r for r, _fk in cl.catalog.referencing_fks(name)}
        if refs - set(names):
            raise UnsupportedFeatureError(
                "TRUNCATE of a table other tables reference by foreign "
                "key is not ported yet (ROADMAP.md A11)")
        refuse_remote_placements(cl, t0, "TRUNCATE")
        metas.setdefault(group_resource(t0), t0)
    # every relation's EXCLUSIVE lock (sorted: no lock-order inversion)
    # before the first irreversible flip, so TRUNCATE a, b is
    # all-or-nothing against a lock timeout
    with contextlib.ExitStack() as stack:
        for res in sorted(metas):
            stack.enter_context(cl._write_lock(metas[res], EXCLUSIVE))
        for name in names:
            cl._truncate_one(name)
    return Result(columns=[], rows=[])
