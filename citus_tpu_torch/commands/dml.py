"""DML statement handlers: COPY to and from files, DELETE, UPDATE,
MERGE, TRUNCATE, VACUUM [ANALYZE], ANALYZE and REINDEX.

Reference: the modify paths of multi_router_planner.c
(CreateModifyPlan), commands/multi_copy.c, merge_planner/executor,
and commands/truncate.c / vacuum.c; each handler drives the columnar
DML executors (executor/dml.py, executor/merge_executor.py) under the
colocation-group write lock, invalidates the table's cached plans and
emits its change to the CDC stream.  The port of
citus_tpu/commands/dml.py: RETURNING, the foreign-key actions of a
parent's DELETE and UPDATE (RESTRICT / CASCADE / SET NULL), CHECK,
domain, unique and partition-bound checks on UPDATE, and DML, TRUNCATE and
VACUUM on partitioned parents by fan-out.  A DELETE or UPDATE whose
surviving shards another coordinator hosts is forwarded as its SQL text
(``execute_sql``) to a single owner, or runs as a cross-host two-phase
commit (``dml_prepare`` on every owner, the outcome recorded at the
metadata authority, ``dml_decide``); inside BEGIN..COMMIT it opens a
branch session on each owner (``txn_stmt``) that COMMIT prepares and
decides (transaction/branches.py).  TRUNCATE forwards to each host.
A COPY TO of such a table is refused (ROADMAP.md C18), and so is a
MERGE into one, as in the reference.
"""

from __future__ import annotations

import contextlib

from citus_tpu_torch.commands.registry import handles
from citus_tpu_torch.errors import (
    AnalysisError, ExecutionError, UnsupportedFeatureError,
)
from citus_tpu_torch.executor import Result
from citus_tpu_torch.observability import trace as _trace
from citus_tpu_torch.planner import ast as A
from citus_tpu_torch.stats import begin_wait, end_wait


def remote_hosted(cat, t) -> bool:
    """Whether another coordinator hosts a placement of table ``t``."""
    return cat.remote_data is not None and any(
        cat.is_remote_node(nd) for s in t.shards for nd in s.placements)


def refuse_remote_placements(cl, t, what: str, work: str) -> None:
    """A statement that would read or move only the local placements of
    a table some of whose placements another coordinator hosts: the
    reference loses the remote rows without an error (ROADMAP.md C18),
    the port refuses.  ``work`` names what the statement would need."""
    if remote_hosted(cl.catalog, t):
        raise UnsupportedFeatureError(
            f"{what} of a table with shards hosted by another coordinator "
            f"({work}) is not supported: the reference loses their rows "
            "(ROADMAP.md C18)")


def _forward_remote_dml(cl, stmt, t, where):
    """A modify statement whose surviving shards live on other
    coordinators: a single remote owner gets the whole statement
    forwarded (the router path — reference: deparsed SQL shipped to the
    owning worker over libpq); shards spanning several hosts run as a
    cross-host 2PC (_two_phase_remote_dml).  Returns a Result when
    handled remotely, None when every surviving shard is local."""
    if cl.catalog.remote_data is None \
            or getattr(cl._remote_exec_guard, "v", False):
        return None
    if not t.is_distributed:
        # a reference table's replicas span hosts: a local-only modify
        # would diverge them — refuse until replicated cross-host DML
        # exists (the reference runs these under 2PC to every node)
        if any(cl.catalog.is_remote_node(nd)
               for s in t.shards for nd in s.placements):
            raise UnsupportedFeatureError(
                "modifying a reference table with remote-hosted replicas "
                "is not supported yet")
        return None
    from citus_tpu_torch.planner.physical import prune_shards
    surviving = prune_shards(t, where)
    # replicated shards spanning hosts: the modify would run against
    # one placement only, silently diverging the replica on the other
    # host — fail closed, mirroring the reference-table guard above
    if any(len(t.shards[si].placements) > 1
           and any(cl.catalog.is_remote_node(nd)
                   for nd in t.shards[si].placements)
           for si in surviving):
        raise UnsupportedFeatureError(
            "modifying a distributed table whose replicated shard "
            "placements span hosts is not supported yet (only one "
            "placement would see the modify, diverging replicas)")
    owners = {t.shards[si].placements[0] for si in surviving}
    remote = {o for o in owners if cl.catalog.is_remote_node(o)}
    if not remote:
        return None
    from citus_tpu_torch.storage.overlay import current_overlay
    endpoints = {cl.catalog.node_endpoint(o) for o in remote}
    if getattr(stmt, "returning", None):
        raise UnsupportedFeatureError(
            "RETURNING is not supported on forwarded remote DML yet")
    sql = getattr(cl._stmt_sql, "v", None)
    if sql is None:
        raise UnsupportedFeatureError(
            "cannot forward this modify statement to its remote host "
            "(no original SQL text — issue it as a single statement)")
    txn = current_overlay()
    if txn is not None:
        return _txn_remote_dml(cl, stmt, t, sql, sorted(endpoints), txn,
                               has_local=(owners != remote))
    if owners == remote and len(endpoints) == 1:
        # router case: one remote owner, no local shards — forward the
        # whole statement, its host's own 2PC makes it atomic
        r = cl.catalog.remote_data.call(next(iter(endpoints)),
                                        "execute_sql", {"sql": sql})
        cl._plan_cache.invalidate_table(t.name)
        return Result(columns=r.get("columns", []),
                      rows=[tuple(row) for row in r.get("rows", [])],
                      explain=r.get("explain", {}))
    return _two_phase_remote_dml(cl, stmt, t, sql, sorted(endpoints),
                                 has_local=(owners != remote))


def _txn_remote_dml(cl, stmt, t, sql: str, endpoints: list, txn,
                    has_local: bool):
    """A modify inside BEGIN..COMMIT touching remote-hosted shards:
    each remote owner gets the statement in a PERSISTENT branch session
    keyed by the transaction's gxid (the reference's worker session of
    a coordinated transaction); COMMIT later drives the branch 2PC
    (cluster._commit_txn).  Returns a Result when no local shards
    survive, else None (local execution continues, remote counts merge
    via cl._remote_counts)."""
    import uuid as _uuid
    if cl._control is None:
        raise UnsupportedFeatureError(
            "a transaction touching remote-hosted shards needs a "
            "metadata authority (the durable outcome store)")
    if txn.catalog_dirty:
        raise UnsupportedFeatureError(
            "DDL and remote-shard DML cannot mix in one transaction yet")
    if txn.savepoints:
        raise UnsupportedFeatureError(
            "savepoints with remote-shard DML are not supported yet")
    if txn.gxid is None:
        txn.gxid = _uuid.uuid4().hex
    counts: dict = {}
    try:
        for ep in endpoints:
            r = cl.catalog.remote_data.call(
                ep, "txn_stmt", {"gxid": txn.gxid, "sql": sql})
            txn.remote_endpoints.add(ep)
            for k, v in (r.get("explain") or {}).items():
                if isinstance(v, (int, float)):
                    counts[k] = counts.get(k, 0) + v
    except BaseException:
        txn.failed = True  # the block must roll back (branches too)
        raise
    txn.remote_written_tables.add(t.name)
    if has_local:
        # local part runs normally; the handler adds these in
        cl._remote_counts.v = counts
        return None
    cl._plan_cache.invalidate_table(t.name)
    return Result(columns=[], rows=[], explain=counts)


def _two_phase_remote_dml(cl, stmt, t, sql: str, endpoints: list,
                          has_local: bool) -> Result:
    """Cross-host 2PC for a modify spanning several hosts (reference:
    PREPARE TRANSACTION on every write connection + COMMIT PREPARED,
    transaction_management.c:319 / remote_transaction.c):

    1. dml_prepare on every remote owner (statement runs there against
       its placements, branch stays staged+locked, PREPARED durable);
       a local branch prepares the same way when local shards survive;
    2. the outcome is recorded DURABLY at the metadata authority
       (gxid_outcomes store — the pg_dist_transaction analog); this is
       the commit point: a branch that misses phase 2 resolves from it
       (absent = presumed abort);
    3. dml_decide(commit) everywhere + local finish."""
    import uuid as _uuid
    if cl._control is None:
        raise UnsupportedFeatureError(
            "a modify spanning several hosts needs a metadata authority "
            "(the durable transaction-outcome store); attach the "
            "coordinators via serve_port/coordinator")
    gxid = _uuid.uuid4().hex
    prepared: list = []
    local_session = None
    local_prepared = False
    counts: dict = {}

    def _abort_everything() -> str:
        # claim abort in the decision register first, so any branch
        # that expires concurrently agrees; then best-effort decides.
        # Returns the REGISTER's winner: 'commit' means our own commit
        # record already landed (response lost) and the caller must
        # complete the commit instead; 'in-doubt' means the claim never
        # reached the register (authority unreachable) — a prepared
        # branch must then be LEFT ALONE: deciding abort on it without
        # a durable claim could diverge from a commit record that did
        # (or will) land, so prepared branches resolve against the
        # outcome register instead (absent record = presumed abort).
        try:
            winner = cl._control.record_txn_outcome(gxid, "abort")
        except Exception:
            # the abort claim is NOT durable; only a local branch that
            # never prepared is unambiguous and safe to roll back
            if local_session is not None \
                    and local_session.txn is not None \
                    and not local_prepared:
                try:
                    cl._rollback_txn(local_session)
                # lint: disable=SWL01 -- in-doubt path: recovery resolves the branch; rollback is opportunistic
                except Exception:
                    pass
            return "in-doubt"
        if winner == "commit":
            return "commit"
        for ep in prepared:
            try:
                cl.catalog.remote_data.call(
                    ep, "dml_decide", {"gxid": gxid, "commit": False})
            # lint: disable=SWL01 -- abort already durable in the outcome store; branch expiry resolves it
            except Exception:  # noqa: BLE001 -- branch expiry resolves it
                pass
        if local_session is not None and local_session.txn is not None:
            try:
                if local_prepared:
                    cl._finish_branch(local_session, False)
                else:
                    # statement failed BEFORE prepare: the txn is a
                    # plain open transaction — normal rollback cleans
                    # its staged files (finish_branch's empty payload
                    # would leak them)
                    cl._rollback_txn(local_session)
            # lint: disable=SWL01 -- abort outcome already durable; local cleanup failure surfaces via recovery
            except Exception:
                pass
        return "abort"


    def _complete_commit() -> None:
        # local branch finishes FIRST (its outcome can never change
        # now; raising before it would strand a committed prepared
        # branch), then the remote decides — divergence surfaces after
        # local state is consistent
        _c_span = _trace.span("2pc_decide", participants=len(endpoints))
        _c_span.__enter__()
        wtok = begin_wait("2pc_decision")
        try:
            _complete_commit_body()
        finally:
            end_wait(wtok)
            _c_span.__exit__(None, None, None)

    def _complete_commit_body() -> None:
        if local_session is not None and local_session.txn is not None:
            cl._finish_branch(local_session, True)
        cl._plan_cache.clear()
        divergence = None
        for ep in endpoints:
            try:
                r = cl.catalog.remote_data.call(
                    ep, "dml_decide", {"gxid": gxid, "commit": True})
                if not r.get("ok") and r.get("resolved") != "commit":
                    divergence = (ep, r.get("resolved"))
            # lint: disable=SWL01 -- commit already durable; an unreachable peer resolves from the outcome store
            except Exception:
                pass  # resolves to commit from the outcome store
        if divergence is not None:
            raise ExecutionError(
                f"cross-host branch on {divergence[0]} diverged: "
                f"resolved={divergence[1]!r} after a committed outcome")

    try:
        with _trace.span("2pc_prepare", participants=len(endpoints),
                         local=bool(has_local)):
            for ep in endpoints:
                r = cl.catalog.remote_data.call(
                    ep, "dml_prepare", {"gxid": gxid, "sql": sql})
                prepared.append(ep)
                for k, v in (r.get("explain") or {}).items():
                    if isinstance(v, (int, float)):
                        counts[k] = counts.get(k, 0) + v
            if has_local:
                local_session = cl.session()
                guard = cl._remote_exec_guard
                prev = getattr(guard, "v", False)
                guard.v = True
                try:
                    local_session.execute("BEGIN")
                    r = local_session.execute(sql)
                    cl._prepare_branch(local_session, gxid)
                    local_prepared = True
                finally:
                    guard.v = prev
                for k, v in (r.explain or {}).items():
                    if isinstance(v, (int, float)):
                        counts[k] = counts.get(k, 0) + v
        # THE commit point: first writer into the durable decision
        # register wins — if a participant's presumed-abort claim got
        # there first, WE must abort
        with _trace.span("2pc_commit_point"):
            wtok = begin_wait("2pc_decision")
            try:
                winner = cl._control.record_txn_outcome(gxid, "commit")
            finally:
                end_wait(wtok)
        if winner != "commit":
            raise ExecutionError(
                "cross-host transaction aborted by a participant "
                "(branch timed out before the commit decision)")
    except BaseException as exc:
        outcome = _abort_everything()
        if outcome == "commit":
            # our commit record already landed (response lost): the
            # transaction IS committed — complete it, don't diverge
            _complete_commit()
            counts["gxid"] = gxid
            return Result(columns=[], rows=[], explain=counts)
        if outcome == "in-doubt":
            from citus_tpu_torch.errors import TransactionError
            raise TransactionError(
                f"cross-host transaction {gxid} is in doubt: the abort "
                f"decision could not be durably recorded (metadata "
                f"authority unreachable); prepared branches are left to "
                f"resolve against the outcome register") from exc
        raise
    _complete_commit()
    counts["gxid"] = gxid
    return Result(columns=[], rows=[], explain=counts)


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
    where = Binder(cl.catalog, t).bind_scalar(stmt.where) \
        if stmt.where is not None else None
    cl._remote_counts.v = None
    fwd = _forward_remote_dml(cl, stmt, t, where)
    if fwd is not None:
        return fwd
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
        try:
            n = execute_delete(cl.catalog, cl.txlog, t, where,
                               txn=current_overlay())
        finally:
            pend = getattr(cl._remote_counts, "v", None)
            cl._remote_counts.v = None  # never leak into a later statement
    if pend:
        n += int(pend.get("deleted", 0))
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
    b = Binder(cl.catalog, t)
    cl._remote_counts.v = None
    if cl.catalog.remote_data is not None:
        bw = b.bind_scalar(stmt.where) if stmt.where is not None else None
        fwd = _forward_remote_dml(cl, stmt, t, bw)
        if fwd is not None:
            return fwd
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
        try:
            n = execute_update(cl.catalog, cl.txlog, t, assignments, where,
                               txn=current_overlay(), check=check)
        finally:
            pend = getattr(cl._remote_counts, "v", None)
            cl._remote_counts.v = None  # never leak into a later statement
    if pend:
        n += int(pend.get("updated", 0))
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
            metas.setdefault(group_resource(t0), t0)
    # placements other coordinators host: the statement is forwarded to
    # each owning host (it truncates ITS placements; the guard stops it
    # forwarding back), then the local ones are truncated.  Not atomic
    # across hosts, as in the reference, but never the resurrection of
    # rows that truncating only the local directories would be.
    if cl.catalog.remote_data is not None \
            and not getattr(cl._remote_exec_guard, "v", False):
        eps = {cl.catalog.node_endpoint(nd)
               for t0 in metas.values()
               for s in t0.shards for nd in s.placements
               if cl.catalog.is_remote_node(nd)}
        if eps:
            sql = getattr(cl._stmt_sql, "v", None)
            if sql is None:
                raise UnsupportedFeatureError(
                    "cannot forward TRUNCATE to remote placement hosts "
                    "(no original SQL text — issue it as a single "
                    "statement)")
            for ep in sorted(eps):
                cl.catalog.remote_data.call(ep, "execute_sql",
                                            {"sql": sql})
    with contextlib.ExitStack() as stack:
        for res in sorted(metas):
            stack.enter_context(cl._write_lock(metas[res], EXCLUSIVE))
        for name in names:
            cl._truncate_one(name)
    if cl.catalog.remote_data is not None:
        for t0 in metas.values():
            cl.catalog.remote_data.invalidate_cache(t0.name)
    return Result(columns=[], rows=[])


@handles(A.Vacuum)
def vacuum(cl, stmt):
    from citus_tpu_torch.executor.dml import execute_vacuum
    from citus_tpu_torch.transaction.locks import EXCLUSIVE
    t = cl.catalog.table(stmt.table)
    if t.is_partitioned:
        # the parent holds no data: vacuum every partition
        return cl._fanout_partitions(stmt, aggregate_explain=True)
    # the local placements only, as in the reference
    with cl._write_lock(t, EXCLUSIVE):
        st = execute_vacuum(cl.catalog, cl.catalog.table(stmt.table))
    cl._plan_cache.invalidate_table(t.name)
    return Result(columns=[], rows=[], explain=st)


@handles(A.Merge)
def merge(cl, stmt):
    from citus_tpu_torch.executor.merge_executor import execute_merge
    from citus_tpu_torch.transaction.locks import EXCLUSIVE
    _mt = cl.catalog.table(stmt.target.name)
    if remote_hosted(cl.catalog, _mt):
        # the merge executor reads and writes placements directly: a
        # remote shard would look empty (matched rows re-inserted, then
        # dropped by the remote-skipping ingest), so fail closed
        raise UnsupportedFeatureError(
            "MERGE into a table with remote-hosted shards is not "
            "supported yet (no cross-host 2PC)")
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
