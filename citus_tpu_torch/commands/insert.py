"""INSERT ... VALUES and upsert (ON CONFLICT) handlers.

Reference: multi-row INSERT routing (multi_router_planner.c
BuildRoutesForInsert) and ON CONFLICT within one shard group
(citus_tpu/commands/insert.py).  Literal rows route through
``Cluster.copy_from``.  ``ON CONFLICT (cols) DO NOTHING | DO UPDATE SET
...`` takes ``excluded.`` references and the rollup refresh's
``sketch_merge(col, excluded.col)`` assignments, under the colocation
group's EXCLUSIVE write lock.

Two differences from the reference, neither visible in the rows:
- the conflict probe filters by the distribution column's IN-list only
  for up to ``_PROBE_IN_MAX`` values and scans the table otherwise (the
  reference binds every value into one OR chain, which overflows
  Python's recursion limit at about a thousand values: ROADMAP.md C);
- a DO UPDATE whose assignments the host evaluates exactly
  (``sketch_merge(c, excluded.c)``, ``excluded.c``, ``c + excluded.c``
  on bigint or double) replaces all conflicting rows in one
  delete-and-reinsert transaction (``executor/dml.py execute_replace``)
  where the reference runs one UPDATE statement per conflicting row;
  any other DO UPDATE, or one with a WHERE, runs the reference's
  per-row UPDATEs.  The CDC stream gets the same per-row update events.
INSERT ... SELECT, RETURNING and column defaults are not ported yet
(ROADMAP.md queue A).
"""

from __future__ import annotations

from citus_tpu_torch.cluster import _pylit, _subst_excluded
from citus_tpu_torch.commands.registry import handles
from citus_tpu_torch.errors import (
    AnalysisError, ExecutionError, UnsupportedFeatureError,
)
from citus_tpu_torch.executor import Result
from citus_tpu_torch.planner import ast as A

#: distinct distribution-column values the conflict probe filters by;
#: above it the probe scans the table
_PROBE_IN_MAX = 64
_INT64 = 1 << 64


@handles(A.Insert)
def execute_insert(cl, stmt: A.Insert) -> Result:
    if stmt.select is not None or stmt.returning:
        raise UnsupportedFeatureError(
            "INSERT ... SELECT / RETURNING are not ported yet "
            "(ROADMAP.md queue A)")
    t = cl.catalog.table(stmt.table)
    rows = []
    for row_exprs in stmt.rows:
        row = []
        for e in row_exprs:
            if isinstance(e, A.UnOp) and e.op == "-" \
                    and isinstance(e.operand, A.Literal):
                row.append(-e.operand.value)
            elif isinstance(e, A.Literal):
                row.append(e.value)
            else:
                raise UnsupportedFeatureError("INSERT VALUES must be literals")
        rows.append(row)
    names = list(t.schema.names if stmt.columns is None else stmt.columns)
    if stmt.on_conflict is not None:
        return _execute_upsert(cl, t, stmt, rows, names)
    n = cl.copy_from(stmt.table, rows=rows, column_names=names)
    return Result(columns=[], rows=[], explain={"inserted": n})


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
    batched = oc.action == "update" and _host_exact(t, oc, names, rows)
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
            n_upd = cl._execute_stmt(
                A.Update(t.name, assignments, where)).explain.get("updated", 0)
            updated += n_upd
            skipped += 0 if n_upd else 1  # DO UPDATE ... WHERE filtered
        if replaced:
            updated += _replace_rows(cl, t, list(oc.targets), replaced)
        if to_insert:
            cl.copy_from(t.name, rows=to_insert, column_names=names)
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
