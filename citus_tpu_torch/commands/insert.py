"""INSERT ... VALUES, INSERT ... SELECT and upsert (ON CONFLICT) handlers.

Reference: multi-row INSERT routing (multi_router_planner.c
BuildRoutesForInsert), ON CONFLICT within one shard group, and the
INSERT ... SELECT strategy ladder (insert_select_planner.c:
colocated pushdown / repartition / pull to the coordinator), as
citus_tpu/commands/insert.py has them.  Literal rows route through
``Cluster.copy_from``, their DEFAULTs (serial ids included) resolved up
front so ON CONFLICT and RETURNING see what is stored; ``nextval`` and
``currval`` may stand in VALUES.  ``ON CONFLICT (cols) DO NOTHING | DO
UPDATE SET ...`` takes ``excluded.`` references and the rollup
refresh's ``sketch_merge(col, excluded.col)`` assignments, under the
colocation group's EXCLUSIVE write lock.

INSERT ... SELECT takes the array path when the SELECT is a plain
single-table projection whose outputs match the target's types: each
source batch is masked by the WHERE (``_ProjectionMask``, the generated
predicate kernel B4 on the gpu backend, numpy on the cpu backend), the
projected values are computed on the host, and the columns go straight
to the target's placements (``colocated``: source shard i is target
shard i) or through the hash-routing ingest (``repartition``).  Any
other SELECT (aggregates, joins, a constrained or partitioned target or
source) runs through ``_execute_stmt`` and its rows through
``copy_from`` (``pull``; ``upsert_pull`` with ON CONFLICT).
``explain["strategy"]`` names the rung, as in the reference.

Two differences from the reference, neither visible in the rows:
- the conflict probe filters by the distribution column's IN-list only
  for up to ``_PROBE_IN_MAX`` values and scans the table otherwise (the
  reference binds every value into one OR chain, which overflows
  Python's recursion limit at about a thousand values: ROADMAP.md C4);
- a DO UPDATE whose assignments the host evaluates exactly
  (``sketch_merge(c, excluded.c)``, ``excluded.c``, ``c + excluded.c``
  on bigint or double) replaces all conflicting rows in one
  delete-and-reinsert transaction (``executor/dml.py execute_replace``)
  where the reference runs one UPDATE statement per conflicting row;
  any other DO UPDATE, or one with a WHERE, a role's under an UPDATE
  policy, or one into a table with shards another coordinator hosts,
  runs the reference's per-row UPDATEs.  The CDC stream gets the same
  per-row update events.
INSERT ... SELECT into a table with shards another coordinator hosts
takes the pull path, whose rows ``copy_from`` routes to their hosts.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional

import numpy as np

from citus_tpu_torch.cluster import (
    _eval_const, _expand_returning_items, _pylit, _subst_excluded,
)
from citus_tpu_torch.commands.dml import remote_hosted
from citus_tpu_torch.commands.registry import handles
from citus_tpu_torch.errors import (
    AnalysisError, ExecutionError, UnsupportedFeatureError,
)
from citus_tpu_torch.executor import Result
from citus_tpu_torch.ingest import TableIngestor, rows_to_columns
from citus_tpu_torch.planner import ast as A
from citus_tpu_torch.planner.bind import bind_select

#: distinct distribution-column values the conflict probe filters by;
#: above it the probe scans the table
_PROBE_IN_MAX = 64
_INT64 = 1 << 64


@handles(A.Insert)
def execute_insert(cl, stmt: A.Insert) -> Result:
    t = cl.catalog.table(stmt.table)
    if stmt.select is not None:
        return _execute_insert_select(cl, t, stmt)
    rows = []
    for row_exprs in stmt.rows:
        row = []
        for e in row_exprs:
            if isinstance(e, A.Literal):
                row.append(e.value)
            elif isinstance(e, A.UnOp) and e.op == "-" \
                    and isinstance(e.operand, A.Literal):
                row.append(-e.operand.value)
            elif isinstance(e, A.FuncCall) \
                    and e.name in ("nextval", "currval") \
                    and e.args and isinstance(e.args[0], A.Literal):
                seq = str(e.args[0].value)
                row.append(cl.catalog.nextval(seq) if e.name == "nextval"
                           else cl.catalog.currval(seq))
            else:
                raise UnsupportedFeatureError("INSERT VALUES must be literals")
        rows.append(row)
    # resolve DEFAULTs up front (serial ids included) so ON CONFLICT
    # and RETURNING see exactly what gets stored: copy_from then
    # receives the complete batch and never draws defaults again
    names = list(t.schema.names if stmt.columns is None else stmt.columns)
    if rows and any(c.default_sql and c.name not in names for c in t.schema):
        listed = set(names)
        columns = {c: v for c, v in
                   rows_to_columns(t.schema.names, rows, names).items()
                   if c in listed or not t.schema.column(c).default_sql}
        columns = cl._fill_defaults(t, columns)
        names = [c for c in t.schema.names if c in columns]
        rows = [tuple(columns[c][i] for c in names)
                for i in range(len(rows))]
        stmt = dataclasses.replace(stmt, columns=names)
    if stmt.on_conflict is not None:
        return _execute_upsert(cl, t, stmt, rows, names)
    n = cl.copy_from(stmt.table, rows=rows, column_names=names)
    if stmt.returning:
        return _insert_returning(t, stmt, rows, names, n)
    return Result(columns=[], rows=[], explain={"inserted": n})


def _insert_returning(t, stmt: A.Insert, rows: list, names: list,
                      n: int) -> Result:
    """RETURNING of INSERT VALUES: the items evaluated on the host over
    each row as a later SELECT reads it back."""
    out_rows = []
    for row in rows:
        m = {}
        for cn, v in zip(names, row):
            typ = t.schema.column(cn).type
            if v is not None and not typ.is_text:
                # what a subsequent SELECT would read back
                v = typ.from_physical(typ.to_physical(v))
            lit = A.Literal(v, "null" if v is None else
                            "string" if isinstance(v, str) else "int")
            m[A.ColumnRef(cn)] = lit
            m[A.ColumnRef(cn, stmt.table)] = lit
        for cn in t.schema.names:
            m.setdefault(A.ColumnRef(cn), A.Literal(None, "null"))
            m.setdefault(A.ColumnRef(cn, stmt.table), A.Literal(None, "null"))
        exp = _expand_returning_items(t, stmt.returning, m)
        out_rows.append(tuple(_eval_const(e) for e, _ in exp))
    cols = [a for _, a in _expand_returning_items(t, stmt.returning)]
    return Result(columns=cols, rows=out_rows, explain={"inserted": n})


def _execute_insert_select(cl, t, stmt: A.Insert) -> Result:
    """The strategy ladder: ``upsert_pull`` with ON CONFLICT; else the
    array path (``colocated`` or ``repartition``) where it applies;
    else ``pull``."""
    if stmt.returning:
        raise UnsupportedFeatureError(
            "RETURNING on INSERT..SELECT is not supported")
    names = list(t.schema.names if stmt.columns is None else stmt.columns)
    if stmt.on_conflict is not None:
        # pull the source rows, then run the same upsert machinery row
        # literals take (reference: INSERT..SELECT ON CONFLICT goes
        # through the pull / colocated-intermediate-results strategy)
        inner = cl._execute_stmt(stmt.select)
        r = _execute_upsert(cl, t, stmt, [list(x) for x in inner.rows],
                            names)
        r.explain["strategy"] = "insert_select:upsert_pull"
        return r

    def refs_partitioned(item) -> bool:
        if isinstance(item, A.Join):
            return refs_partitioned(item.left) or refs_partitioned(item.right)
        return (isinstance(item, A.TableRef)
                and cl.catalog.has_table(item.name)
                and cl.catalog.table(item.name).is_partitioned)

    # FK-constrained, unique-indexed and partitioned targets, and
    # partitioned sources, take the pull path: copy_from's probes and
    # partition routing only run there, and a partitioned source must
    # expand through _execute_stmt
    direct_ok = not (t.foreign_keys or t.unique_indexes or t.is_partitioned
                     or any(k.startswith(t.name + ".")
                            for k in cl.catalog.domain_columns))
    if direct_ok and isinstance(stmt.select, A.Select) \
            and stmt.select.from_ is not None:
        direct_ok = not refs_partitioned(stmt.select.from_)
    res = _insert_select_arrays(cl, t, stmt.select, names) \
        if direct_ok else None
    if res is None:
        # materialize rows through the coordinator (reference: the
        # pull-to-coordinator strategy, insert_select_executor.c)
        inner = cl._execute_stmt(stmt.select)
        n = cl.copy_from(stmt.table, rows=inner.rows, column_names=names)
        strategy = "pull"
    else:
        n, strategy = res
    return Result(columns=[], rows=[],
                  explain={"inserted": n,
                           "strategy": f"insert_select:{strategy}"})


def _merge_columns(t, oc) -> list:
    """The sketch_merge(col, excluded.col) assignment targets."""
    out = []
    for c, e in oc.assignments:
        if not (isinstance(e, A.FuncCall) and e.name == "sketch_merge"):
            continue
        if t.schema.column(c).type.kind != "sketch":
            raise AnalysisError(
                f"sketch_merge() target column {c!r} is not a sketch column")
        if len(e.args) != 2 \
                or not (isinstance(e.args[0], A.ColumnRef)
                        and e.args[0].name == c
                        and e.args[0].table in (None, t.name)) \
                or not (isinstance(e.args[1], A.ColumnRef)
                        and e.args[1].table == "excluded"
                        and e.args[1].name == c):
            raise AnalysisError(
                "sketch_merge() must be written as sketch_merge(col, "
                "excluded.col) on the assigned column")
        out.append(c)
    return out


def _host_exact(t, oc, names: list, rows: list) -> bool:
    """Whether every DO UPDATE assignment is one the host evaluates
    bit-exactly as the engine's UPDATE would (see the module note): a
    bigint sum also needs integer proposed values."""
    if oc.where is not None:
        return False
    for c, e in oc.assignments:
        kind = t.schema.column(c).type.kind
        excl = A.ColumnRef(c, "excluded")
        if isinstance(e, A.FuncCall) and e.name == "sketch_merge":
            continue
        if e == excl:
            continue
        if isinstance(e, A.BinOp) and e.op == "+" \
                and kind in ("int64", "float64") \
                and {e.left, e.right} == {excl, A.ColumnRef(c)} \
                and (kind == "float64" or c in names and all(
                    r[names.index(c)] is None
                    or type(r[names.index(c)]) is int for r in rows)):
            continue
        return False
    return not any(t.schema.column(c).type.kind in ("uuid", "bytea", "array")
                   for c in oc.targets)


def _execute_upsert(cl, t, stmt: A.Insert, rows: list, names: list) -> Result:
    """INSERT ... ON CONFLICT: the conflict target is the declared key
    (it must include the distribution column, so conflicts resolve
    within one shard group — multi_router_planner.c rejects others).
    Runs under the colocation group's EXCLUSIVE write lock so probe and
    write are atomic against concurrent writers."""
    from citus_tpu_torch.transaction.locks import EXCLUSIVE
    oc = stmt.on_conflict
    if stmt.returning:
        raise UnsupportedFeatureError(
            "RETURNING with ON CONFLICT is not supported")
    if not oc.targets:
        raise UnsupportedFeatureError(
            "ON CONFLICT requires an explicit (column, ...) target")
    for c in oc.targets:
        if not t.schema.has(c):
            raise AnalysisError(f"column {c!r} does not exist")
        if c not in names:
            raise AnalysisError(
                "ON CONFLICT target columns must be inserted columns")
    if t.is_distributed and t.dist_column not in oc.targets:
        raise UnsupportedFeatureError(
            "ON CONFLICT target must include the distribution column")
    for c, _e in oc.assignments:
        if not t.schema.has(c):
            raise AnalysisError(f"column {c!r} does not exist")
        if t.is_distributed and c == t.dist_column:
            raise UnsupportedFeatureError(
                "ON CONFLICT DO UPDATE cannot modify the distribution "
                "column")
    merge_cols = _merge_columns(t, oc)
    key_idx = [names.index(c) for c in oc.targets]

    def norm_key(vals) -> tuple:
        """Proposed key values as a SELECT reads them back, so they
        compare equal to probed rows: 5.0 -> Decimal('5.00')."""
        out = []
        for c, v in zip(oc.targets, vals):
            typ = t.schema.column(c).type
            if v is None:
                out.append(v)
            elif typ.is_text:
                out.append(typ.render_word(typ.normalize_word(v))
                           if typ.kind != "text" else v)
            else:
                out.append(typ.from_physical(typ.to_physical(v)))
        return tuple(out)

    if oc.action == "update":
        # PostgreSQL raises 21000 whenever two proposed rows would affect
        # the same target row; checking up front keeps the statement
        # all-or-nothing
        seen: set = set()
        for row in rows:
            raw = tuple(row[i] for i in key_idx)
            if any(v is None for v in raw):
                continue
            key = norm_key(raw)
            if key in seen:
                raise ExecutionError(
                    "ON CONFLICT DO UPDATE command cannot affect row a "
                    "second time")
            seen.add(key)
    # the executing role: each conflicting row must pass its UPDATE
    # policies, checked per row by the reference's path below (the
    # batched update is the superuser's, or a role's without a policy)
    exec_role = cl._exec_roles.get(threading.get_ident())
    upd_policy = None if exec_role is None else \
        cl._policy_predicate(exec_role, t.name, "update")
    # the batched update rewrites local placements in place: a table
    # with remote-hosted shards takes the per-row UPDATEs, which forward
    batched = oc.action == "update" and upd_policy is None \
        and not remote_hosted(cl.catalog, t) and _host_exact(t, oc, names, rows)
    inserted = updated = skipped = 0
    with cl._write_lock(t, EXCLUSIVE):
        probe_rows = [row for row in rows
                      if not any(row[i] is None for i in key_idx)]
        # conflict key -> stored values of the sketch-merge columns; the
        # batched update also keeps every stored row per key
        existing: dict = {}
        stored: dict = {}
        cols = list(t.schema.names) if batched \
            else list(oc.targets) + merge_cols
        if probe_rows:
            where = None
            if t.is_distributed and t.dist_column in names:
                di = names.index(t.dist_column)
                dvals = sorted({row[di] for row in probe_rows})
                if len(dvals) <= _PROBE_IN_MAX:
                    where = A.InList(A.ColumnRef(t.dist_column),
                                     tuple(_pylit(v) for v in dvals), False)
            chk = A.Select([A.SelectItem(A.ColumnRef(c)) for c in cols],
                           A.TableRef(t.name), where)
            ki = [cols.index(c) for c in oc.targets]
            mi = [cols.index(c) for c in merge_cols]
            for r in cl._execute_stmt(chk).rows:
                key = tuple(r[i] for i in ki)
                existing[key] = tuple(r[i] for i in mi)
                if batched:
                    stored.setdefault(key, []).append(dict(zip(cols, r)))
        to_insert: list = []
        replaced: list = []   # (conflict key, [new rows]) of the batched path
        affected: set = set()  # keys inserted/updated by this command
        for row in rows:
            raw = tuple(row[i] for i in key_idx)
            if any(v is None for v in raw):
                # NULL never equals NULL: no conflict possible
                to_insert.append(row)
                inserted += 1
                continue
            key = norm_key(raw)
            if key in affected:
                skipped += 1  # only reachable for DO NOTHING
                continue
            if key not in existing:
                affected.add(key)
                to_insert.append(row)
                inserted += 1
                continue
            if oc.action == "nothing":
                skipped += 1
                continue
            affected.add(key)
            excl = {c: _pylit(v) for c, v in zip(names, row)}
            cur_words = dict(zip(merge_cols, existing[key]))
            assignments = []
            for c, e in oc.assignments:
                e2 = _subst_excluded(e, excl)
                if c in cur_words and isinstance(e2, A.FuncCall) \
                        and e2.name == "sketch_merge":
                    from citus_tpu_torch.rollup.sketches import (
                        merge_sketch_words,
                    )
                    cur = cur_words[c]
                    new = e2.args[1].value \
                        if isinstance(e2.args[1], A.Literal) else None
                    if cur is None or new is None:
                        merged = new if cur is None else cur
                    else:
                        merged = merge_sketch_words(str(cur), str(new))
                    e2 = A.Literal(merged,
                                   "null" if merged is None else "string")
                assignments.append((c, e2))
            if batched:
                proposed = dict(zip(names, row))
                replaced.append((key, [_assign(t, r, assignments, proposed)
                                       for r in stored[key]]))
                continue
            cond = None
            for c, v in zip(oc.targets, raw):
                eq = A.BinOp("=", A.ColumnRef(c), _pylit(v))
                cond = eq if cond is None else A.BinOp("and", cond, eq)
            where = cond
            if oc.where is not None:
                where = A.BinOp("and", cond, _subst_excluded(oc.where, excl))
            upd: A.Statement = A.Update(t.name, assignments, where)
            if exec_role is not None:
                if upd_policy is not None:
                    # PostgreSQL raises the RLS violation whenever the
                    # existing row fails USING, whatever the conflict
                    # WHERE says
                    vis = A.Select(
                        [A.SelectItem(A.FuncCall("count", (A.Star(),)))],
                        A.TableRef(t.name), A.BinOp("and", cond, upd_policy))
                    if not cl._execute_stmt(vis).rows[0][0]:
                        raise AnalysisError(
                            f'new row violates row-level security '
                            f'policy for table "{t.name}"')
                upd, _ = cl._apply_rls(exec_role, upd)
            n_upd = cl._execute_stmt(upd).explain.get("updated", 0)
            updated += n_upd
            skipped += 0 if n_upd else 1  # DO UPDATE ... WHERE filtered
        if replaced:
            updated += _replace_rows(cl, t, list(oc.targets), replaced)
        if to_insert:
            cl.copy_from(t.name, rows=to_insert, column_names=names)
    if oc.action == "update":
        # PostgreSQL fires statement-level UPDATE triggers whenever DO
        # UPDATE is specified (the INSERT triggers fire in execute())
        cl._fire_triggers_for(t.name, "update", 0)
    return Result(columns=[], rows=[],
                  explain={"inserted": inserted, "updated": updated,
                           "skipped": skipped, "strategy": "upsert"})


def _assign(t, row: dict, assignments, proposed: dict) -> dict:
    """One stored row with the DO UPDATE assignments applied, as the
    engine's UPDATE computes them (``_host_exact`` forms only): a merged
    sketch word, ``excluded.c``, or ``c + excluded.c`` in float64 (the
    literal cast first) or in int64 (wrapping)."""
    new = dict(row)
    for c, e in assignments:
        if isinstance(e, A.Literal):  # the merged sketch word
            new[c] = e.value
            continue
        add = isinstance(e, A.BinOp)
        a, b = row[c], proposed.get(c)
        if not add:
            new[c] = b
        elif a is None or b is None:
            new[c] = None
        elif t.schema.column(c).type.kind == "float64":
            new[c] = float(a) + float(b)
        else:
            new[c] = (int(a) + int(b) + (1 << 63)) % _INT64 - (1 << 63)
    return new


def _replace_rows(cl, t, targets: list, replaced: list) -> int:
    """Replace the stored rows of every conflicting key with their
    updated copies in one transaction; one CDC update event per key, as
    the reference's per-row UPDATE statements emit."""
    from citus_tpu_torch.executor.dml import execute_replace
    from citus_tpu_torch.ingest import encode_columns
    from citus_tpu_torch.storage.overlay import current_overlay
    names = list(t.schema.names)
    new_rows = [r for _k, rs in replaced for r in rs]
    values, validity = encode_columns(
        cl.catalog, t, {c: [r[c] for r in new_rows] for c in names})
    keys = {k for k, _rs in replaced}
    cols = [t.schema.column(c) for c in targets]

    def row_filter(env, n):
        decoded = []
        for c in cols:
            v, valid = env[c.name]
            valid = [True] * n if valid is True else list(valid)
            if c.type.is_text:
                vals = cl.catalog.decode_strings(t.name, c.name, v.tolist())
            else:
                vals = [c.type.from_physical(x.item()) for x in v]
            decoded.append([x if ok else None for x, ok in zip(vals, valid)])
        return [k in keys for k in zip(*decoded)]

    n = execute_replace(cl.catalog, cl.txlog, t, row_filter, targets,
                        values, validity, txn=current_overlay())
    cl._plan_cache.invalidate_table(t.name)
    if cl._cdc_captures(t.name):
        for _k, rs in replaced:
            cl._emit_cdc(t.name, "update", count=len(rs))
    return n


def _insert_select_arrays(cl, target, sel: A.Select,
                          names: list[str]) -> Optional[tuple]:
    """Array-streaming INSERT..SELECT (reference: insert_select_planner.c
    IsRedistributablePlan): when the SELECT is a plain single-table
    projection whose output types match the target physically, move
    numpy columns straight from the scan into the ingest, with no
    Python row materialization.  -> (rows, strategy), or None when
    ineligible."""
    if not isinstance(sel, A.Select) or not isinstance(sel.from_, A.TableRef):
        return None
    if sel.group_by or sel.having or sel.order_by or sel.limit \
            or sel.distinct or sel.distinct_on or sel.offset:
        return None
    if remote_hosted(cl.catalog, target):
        # the array strategies write placements directly: only the pull
        # path routes rows to another coordinator's shards
        return None
    try:
        bound = bind_select(cl.catalog, sel)
    except Exception:  # noqa: BLE001 -- the pull path binds (and raises) it
        return None
    if bound.has_aggs or len(bound.final_exprs) != len(names):
        return None
    if remote_hosted(cl.catalog, bound.table):
        return None  # a remote source pushes its scan: the pull path
    from citus_tpu_torch.planner.bound import BColumn, BDictRemap, compile_expr
    from citus_tpu_torch.planner.physical import plan_select
    final_exprs = list(bound.final_exprs)
    for i, (e, cname) in enumerate(zip(final_exprs, names)):
        tgt = target.schema.column(cname).type
        if e.type != tgt:
            return None
        if tgt.kind == "uuid":
            # uuid lanes travel in pairs; the pull path rematerializes
            # canonical strings and re-encodes both lanes on ingest
            return None
        if tgt.is_text:
            if not isinstance(e, BColumn):
                return None
            if bound.table.name != target.name or e.name != cname:
                # re-encode source dictionary ids into the target's
                # dictionary space (grows the target dictionary)
                src_words = cl.catalog.dictionary(bound.table.name, e.name)
                mapping = tuple(int(x) for x in cl.catalog.encode_strings(
                    target.name, cname, src_words))
                final_exprs[i] = BDictRemap(e, mapping)
    plan = plan_select(cl.catalog, bound,
                       direct_limit=cl.settings.planner.direct_gid_limit)
    from citus_tpu_torch.transaction.locks import SHARED
    fns = [compile_expr(e, np) for e in final_exprs]
    strategy = _insert_select_strategy(target, bound, final_exprs, names)
    with cl._write_lock(target, SHARED):
        n = _run_insert_select_arrays(cl, target, plan, fns, names, strategy)
    return n, strategy


def _insert_select_strategy(target, bound, final_exprs, names) -> str:
    """The reference's strategy ladder (insert_select_planner.c,
    README:1187-1238): *colocated* when source and target share a
    colocation group and the target's distribution column is fed
    directly by the source's (rows already live on the right shard: no
    re-hash, no routing); else *repartition* (array-streaming re-hash
    through the hash-routing ingest)."""
    from citus_tpu_torch.planner.bound import BColumn
    src = bound.table
    if not (src.is_distributed and target.is_distributed):
        return "repartition"
    if src.colocation_id != target.colocation_id:
        return "repartition"
    if target.dist_column is None or target.dist_column not in names:
        return "repartition"
    e = final_exprs[names.index(target.dist_column)]
    # plain column (no dict remap / cast) referencing the source's
    # distribution column: hash(source row) == hash(target row)
    if isinstance(e, BColumn) and e.name == src.dist_column:
        return "colocated"
    return "repartition"


def _run_insert_select_arrays(cl, target, plan, fns, names,
                              strategy) -> int:
    from citus_tpu_torch.storage.overlay import current_overlay
    txn = current_overlay()
    if txn is not None:
        # inside BEGIN..COMMIT: stage under the transaction's xid.  On
        # failure, register staged dirs (never abort the xid: that
        # would destroy earlier statements' staged rows)
        ing = TableIngestor(cl.catalog, target, txlog=None)
        ing.xid = txn.xid
        try:
            total = _stream_insert_select(cl, ing, target, plan, fns,
                                          names, strategy)
            for w in ing._writers.values():
                w.flush()
        finally:
            txn.record_ingest(
                target.name, [w.directory for w in ing._writers.values()])
    else:
        ing = TableIngestor(cl.catalog, target, txlog=cl.txlog)
        try:
            total = _stream_insert_select(cl, ing, target, plan, fns,
                                          names, strategy)
        except BaseException:
            ing.abort()  # failure during scan/append: staged files dropped
            raise
        # finish() manages its own failure path (releases the xid so
        # recovery decides; aborting here could roll back a logged COMMIT)
        ing.finish()
    cl.counters.bump("rows_ingested", total)
    cl._plan_cache.invalidate_table(target.name)
    return total


def _stream_insert_select(cl, ing, target, plan, fns, names,
                          strategy) -> int:
    """Each source batch: the WHERE's row mask (``_ProjectionMask``:
    the generated predicate kernel on the gpu backend, numpy on the cpu
    backend), the projected columns computed on the host over the kept
    rows, appended to the target."""
    from citus_tpu_torch.executor.batches import load_shard_batches
    from citus_tpu_torch.executor.executor import _ProjectionMask
    from citus_tpu_torch.integrity import enforce_check_constraints
    from citus_tpu_torch.partitioning import check_partition_bounds
    masker = _ProjectionMask(plan, cl.settings, ((), ()), cl.device)
    schema = plan.bound.table.schema
    total = 0
    for si in plan.shard_indexes:
        for values, masks, n in load_shard_batches(
                cl.catalog, plan, si, min_batch_rows=1):
            env = {c: (values[c].astype(schema.scan_dtype(c, device=True),
                                        copy=False), masks[c])
                   for c in plan.scan_columns}
            idx = np.nonzero(masker(env, n))[0]
            if idx.size == 0:
                continue
            out_v, out_m = {}, {}
            for fn, cname in zip(fns, names):
                v, valid = fn(env)
                v = np.asarray(v)
                if v.ndim == 0:
                    v = np.broadcast_to(v, (n,))
                if valid is True:
                    valid = np.ones(n, bool)
                elif valid is False:
                    valid = np.zeros(n, bool)
                st = target.schema.column(cname).type.storage_dtype
                out_v[cname] = v[idx].astype(st)
                out_m[cname] = np.asarray(valid)[idx]
            for cname in target.schema.names:
                if cname not in out_v:
                    out_v[cname] = np.zeros(
                        idx.size, target.schema.column(cname).type.storage_dtype)
                    out_m[cname] = np.zeros(idx.size, bool)
            # the reference's array path skips these two checks; the
            # port keeps them (ROADMAP.md C13)
            if target.partition_of is not None:
                check_partition_bounds(cl.catalog, target, out_v, out_m)
            if target.check_constraints:
                enforce_check_constraints(cl.catalog, target, out_v, out_m)
            if strategy == "colocated":
                # pushdown: rows of source shard si belong to target
                # shard si by construction: straight to its placements
                shard = target.shards[si]
                for node in shard.placements:
                    ing._writer(shard.shard_id, node).append_batch(out_v, out_m)
            else:
                ing.append(out_v, out_m)
            total += idx.size
    return total
