"""SELECT execution machinery above the physical planner: window
functions, DISTINCT ON, derived tables, set operations, CTE scaffolding
(WITH and WITH RECURSIVE), GROUPING SETS, unnest and constant selects.
Each is host work on the coordinator around sub-statements that run
through ``Cluster._execute_stmt``, so every device step is one of the
ported kernels (scan, fold, hash insert, predicate, join).  A view
named in FROM becomes a derived table over its stored SELECT
(``_expand_views``: materialized once for each reference, as in the
reference), and a user SQL function call is replaced by its body with
the arguments substituted (``_expand_functions_stmt``), so the body is
generated into the fold, insert or predicate kernel like any written-out
expression.

Reference: the coordinator-side combine/query shaping the reference
does in combine_query_planner.c + multi_logical_optimizer.c's master
query, plus cte_inline.c (WITH), setop handling in recursive planning,
and window/distinct paths the reference pushes down when partitioned by
the distribution column.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from citus_tpu_torch.errors import (
    AnalysisError, CitusTpuError, ExecutionError, UnsupportedFeatureError,
)
from citus_tpu_torch.executor import Result, execute_select
from citus_tpu_torch.planner import ast as A
from citus_tpu_torch.planner.bind import bind_select
from citus_tpu_torch.schema import Column, Schema

from citus_tpu_torch.cluster import (  # noqa: E402  (loaded post-cluster)
    _eval_const, _from_relations, _infer_column_type, _replace_exprs,
    _sort_rows, _srf_result, _subst_args,
)


def _resolve_window_ref(wc: A.WindowCall, windows: dict,
                        _seen: Optional[set] = None) -> A.WindowCall:
    """Resolve OVER w / OVER (w ...) against the WINDOW clause,
    following PostgreSQL's copy rules: the referencing spec may not
    re-partition, may order only when the base does not, and always
    uses its own frame (the base may not define one when copied);
    OVER w uses the named window verbatim, frame included."""
    if wc.ref_name is None:
        return wc
    if _seen is None:
        _seen = set()
    if wc.ref_name in _seen:
        raise AnalysisError(
            f'circular reference in window "{wc.ref_name}"')
    _seen.add(wc.ref_name)
    base = windows.get(wc.ref_name)
    if base is None:
        raise AnalysisError(f'window "{wc.ref_name}" does not exist')
    if base.ref_name is not None:
        base = _resolve_window_ref(base, windows, _seen)
    if wc.ref_verbatim:
        return A.WindowCall(wc.func, base.partition_by, base.order_by,
                            base.frame)
    if wc.partition_by:
        raise AnalysisError(
            "cannot override PARTITION BY of a named window")
    if wc.order_by and base.order_by:
        raise AnalysisError(
            "cannot override ORDER BY of a named window that has one")
    if base.frame is not None:
        raise AnalysisError(
            "cannot copy a named window that has a frame clause")
    return A.WindowCall(wc.func, base.partition_by,
                        wc.order_by or base.order_by, wc.frame)


def _execute_distinct_on(cl, stmt: A.Select) -> Result:
    """SELECT DISTINCT ON (exprs): keep the first row of each key
    group in ORDER BY order (PostgreSQL semantics — planned as
    Unique over Sort).  The key expressions run as trailing hidden
    outputs of the inner query; deduplication happens on the
    coordinator, then LIMIT/OFFSET apply to the deduplicated rows."""
    on = list(stmt.distinct_on)

    def resolve(e):
        # ordinals and output aliases resolve to their select item
        if isinstance(e, A.Literal) and isinstance(e.value, int) \
                and not isinstance(e.value, bool):
            idx = e.value - 1
            if 0 <= idx < len(stmt.items):
                return stmt.items[idx].expr
        if isinstance(e, A.ColumnRef) and e.table is None:
            for it in stmt.items:
                if it.alias == e.name:
                    return it.expr
        return e

    for i, e in enumerate(on):
        if i < len(stmt.order_by) \
                and resolve(stmt.order_by[i].expr) != resolve(e):
            raise AnalysisError(
                "SELECT DISTINCT ON expressions must match initial "
                "ORDER BY expressions")
    order_by = list(stmt.order_by) \
        or [A.OrderItem(e, True, None) for e in on]
    hidden = [A.SelectItem(resolve(e), f"__distinct_on_{i}")
              for i, e in enumerate(on)]
    inner = dataclasses.replace(stmt, items=list(stmt.items) + hidden,
                        order_by=order_by, limit=None, offset=None,
                        distinct_on=())
    r = cl._execute_stmt(inner)
    k = len(on)
    seen, rows = set(), []
    for row in r.rows:
        key = row[-k:]
        if key in seen:
            continue
        seen.add(key)
        rows.append(row[:-k])
    if stmt.offset:
        rows = rows[stmt.offset:]
    if stmt.limit is not None:
        rows = rows[:stmt.limit]
    return Result(columns=r.columns[:-k], rows=rows,
                  explain={**(r.explain or {}),
                           "strategy": "distinct_on"},
                  types=r.types[:-k] if r.types else r.types)


def _execute_window(cl, stmt: A.Select) -> Result:
    """Window functions: run the base projection (or grouped
    aggregation) distributed, apply the window pass on the
    coordinator (pull strategy)."""
    from citus_tpu_torch.executor.window import AGGS, NAVIGATION, compute_window
    if stmt.distinct:
        raise UnsupportedFeatureError(
            "window functions with DISTINCT not supported yet")
    if stmt.windows or any(isinstance(i.expr, A.WindowCall)
                           and i.expr.ref_name is not None
                           for i in stmt.items):
        wmap = dict(stmt.windows)
        stmt = dataclasses.replace(stmt, items=[
            A.SelectItem(_resolve_window_ref(i.expr, wmap)
                         if isinstance(i.expr, A.WindowCall) else i.expr,
                         i.alias)
            for i in stmt.items])
    base_items: list[A.SelectItem] = []

    def base_slot(e: A.Expr) -> int:
        base_items.append(A.SelectItem(e, f"__w{len(base_items)}"))
        return len(base_items) - 1

    def literal_value(a: A.Expr):
        if isinstance(a, A.Literal):
            return a.value
        if isinstance(a, A.UnOp) and a.op == "-" \
                and isinstance(a.operand, A.Literal):
            return -a.operand.value
        raise UnsupportedFeatureError(
            "window function extra arguments must be literals")

    outputs = []  # ("col", slot) | ("win", fn, arg_slots, part, order, frame, params)
    names = []
    for i, item in enumerate(stmt.items):
        e = item.expr
        if isinstance(e, A.WindowCall):
            fn = e.func.name
            if e.func.filter is not None:
                if fn not in AGGS:
                    raise AnalysisError(
                        "FILTER is only allowed for aggregate window "
                        "functions")
                # same CASE desugar as plain aggregates: the window
                # aggregates above skip NULL inputs
                from citus_tpu_torch.planner.bind import rewrite_agg_filter
                e = dataclasses.replace(e, func=rewrite_agg_filter(e.func))
            args = [a for a in e.func.args if not isinstance(a, A.Star)]
            if fn in NAVIGATION:
                arg_slots = [base_slot(args[0])] if args else []
                params = tuple(literal_value(a) for a in args[1:])
            elif fn == "ntile":
                arg_slots = []
                params = tuple(literal_value(a) for a in args[:1])
            else:
                arg_slots = [base_slot(a) for a in args]
                params = ()
            part_slots = [base_slot(p) for p in e.partition_by]
            order_specs = [(base_slot(oe), asc) for oe, asc in e.order_by]
            outputs.append(("win", fn, arg_slots, part_slots, order_specs,
                            e.frame, params))
            names.append(item.alias or fn)
        else:
            outputs.append(("col", base_slot(e)))
            names.append(item.alias or (e.name if isinstance(e, A.ColumnRef)
                                        else f"column{i + 1}"))
    # the base query keeps GROUP BY/HAVING: windows then run over the
    # grouped rows (PostgreSQL semantics — windows after aggregation)
    base = A.Select(base_items, stmt.from_, stmt.where,
                    stmt.group_by, stmt.having)
    def window_pass(rows_in: list) -> list[tuple]:
        """Apply every window spec over one row set -> output rows."""
        n = len(rows_in)
        cols = [[row[j] for row in rows_in] for j in range(len(base_items))]
        out_cols = []
        for spec in outputs:
            if spec[0] == "col":
                out_cols.append(cols[spec[1]])
            else:
                _, fn, arg_slots, part_slots, order_specs, frame, params = spec
                out_cols.append(compute_window(
                    n, fn, [cols[s] for s in arg_slots],
                    [cols[s] for s in part_slots],
                    [(cols[s], asc) for s, asc in order_specs],
                    frame=frame, params=params))
        return [tuple(c[i] for c in out_cols) for i in range(n)]

    strategy = "window:pull"
    if _window_pushdown_eligible(cl, stmt, outputs):
        # every window partitions by the distribution column, so no
        # partition spans shards: the whole window computation runs
        # per shard and results concatenate (reference: pushdown when
        # partitioned by the distribution column, multi_explain/
        # query_pushdown_planning safety proof)
        from citus_tpu_torch.planner.physical import plan_select
        bound = bind_select(cl.catalog, base)
        plan = plan_select(cl.catalog, bound,
                           direct_limit=cl.settings.planner.direct_gid_limit)
        rows = []
        for si in plan.shard_indexes:
            shard_plan = dataclasses.replace(plan, shard_indexes=[si])
            shard_rows = execute_select(cl.catalog, bound, cl.settings,
                                        plan=shard_plan, device=cl.device,
                                        mesh=cl.mesh).rows
            rows.extend(window_pass(shard_rows))
        strategy = "window:pushdown"
    else:
        rows = window_pass(cl._execute_stmt(base).rows)
    # outer ORDER BY / LIMIT over the final outputs (name or position)
    for oi in reversed(stmt.order_by):
        idx = None
        if isinstance(oi.expr, A.Literal) and isinstance(oi.expr.value, int):
            idx = oi.expr.value - 1
        elif isinstance(oi.expr, A.ColumnRef) and oi.expr.name in names:
            idx = names.index(oi.expr.name)
        if idx is None or not (0 <= idx < len(names)):
            raise AnalysisError(
                "ORDER BY with window functions must reference an output "
                "name or position")
        nf = oi.nulls_first if oi.nulls_first is not None else (not oi.ascending)
        nulls = [x for x in rows if x[idx] is None]
        vals = [x for x in rows if x[idx] is not None]
        vals.sort(key=lambda x, j=idx: x[j], reverse=not oi.ascending)
        rows = (nulls + vals) if nf else (vals + nulls)
    if stmt.offset:
        rows = rows[stmt.offset:]
    if stmt.limit is not None:
        rows = rows[:stmt.limit]
    return Result(columns=names, rows=rows,
                  explain={"strategy": strategy})


def _injective_in_column(e: A.Expr, col: str, alias: str) -> bool:
    """True when ``e`` is an injective function of the column: equal
    outputs imply equal column values, so partitioning by it can
    never group rows from different shards.  Covers the column
    itself and +/- of a constant, * by a nonzero constant, and
    unary minus, composed."""
    if isinstance(e, A.ColumnRef):
        return e.name == col and (e.table is None or e.table == alias)
    if isinstance(e, A.UnOp) and e.op == "-":
        return _injective_in_column(e.operand, col, alias)
    if isinstance(e, A.BinOp) and e.op in ("+", "-", "*"):
        def const_val(x):
            # integers only: float +/× is NOT injective over bigints
            # (rounding collapses distinct inputs at large magnitude)
            if isinstance(x, A.Literal) and isinstance(x.value, int) \
                    and not isinstance(x.value, bool):
                return x.value
            if isinstance(x, A.UnOp) and x.op == "-":
                v = const_val(x.operand)
                return -v if v is not None else None
            return None
        for side, other in ((e.left, e.right), (e.right, e.left)):
            c = const_val(other)
            if c is None:
                continue
            if e.op == "*" and c == 0:
                return False
            if e.op == "-" and side is e.right and other is e.left:
                # const - expr: still injective
                pass
            if _injective_in_column(side, col, alias):
                return True
    return False


def _window_pushdown_eligible(cl, stmt: A.Select, outputs) -> bool:
    """Safe to compute windows per shard: single distributed table,
    no GROUP BY, and every window's PARTITION BY includes the
    distribution column or an injective expression over it (equal
    partition values then imply equal distribution values, and hash
    partitions never span shards)."""
    if stmt.group_by or stmt.having:
        return False
    if not isinstance(stmt.from_, A.TableRef):
        return False
    if not cl.catalog.has_table(stmt.from_.name):
        return False
    t = cl.catalog.table(stmt.from_.name)
    if not t.is_distributed or t.dist_column is None:
        return False
    alias = stmt.from_.alias or stmt.from_.name
    for item in stmt.items:
        e = item.expr
        if not isinstance(e, A.WindowCall):
            continue
        if not any(_injective_in_column(p, t.dist_column, alias)
                   for p in e.partition_by):
            return False
    return True


_CTE_SEQ = [0]


#: intermediate results at/above this row count distribute back out
#: over the mesh instead of staying coordinator-local (reference:
#: RedistributeTaskListResults / distributed_intermediate_results.c)
DISTRIBUTED_INTERMEDIATE_ROWS = 4096


def _schema_from_result(cl, r: Result, *, strict_empty: bool = False):
    """(deduped column names, column types) for materializing a
    query result as a table.  Planner types win; otherwise infer
    from values.  ``strict_empty``: refuse to guess types for an
    empty untyped result (a PERSISTENT table must not silently get
    bigint columns; throwaway intermediates tolerate the default)."""
    names, seen = [], set()
    for i, n in enumerate(r.columns):
        base = n or f"column{i + 1}"
        cand, k = base, 1
        while cand in seen:
            k += 1
            cand = f"{base}_{k}"
        seen.add(cand)
        names.append(cand)
    types = list(r.types) if r.types else [None] * len(names)
    for i, ct_ in enumerate(types):
        if ct_ is None:
            if strict_empty and not r.rows:
                raise UnsupportedFeatureError(
                    f"cannot infer the type of column {names[i]!r} "
                    "from an empty result; create the table "
                    "explicitly and INSERT instead")
            types[i] = _infer_column_type([row[i] for row in r.rows])
    return names, types


def _create_temp_from_result(cl, prefix: str, label: str, r: Result) -> str:
    """Store a query result as an intermediate-result table (the
    read_intermediate_result analog for CTEs / derived tables / set
    operations).  Small results stay local; large ones hash-
    distribute on their first integer-typed column so downstream
    joins and aggregations run sharded."""
    from citus_tpu_torch import types as T
    names, types = _schema_from_result(cl, r)
    _CTE_SEQ[0] += 1
    tmp = f"__{prefix}_{_CTE_SEQ[0]}_{label}"
    cl.catalog.create_table(
        tmp, Schema([Column(cn, ct_) for cn, ct_ in zip(names, types)]))
    if len(r.rows) >= DISTRIBUTED_INTERMEDIATE_ROWS:
        dist_col = next(
            (cn for cn, ct_ in zip(names, types)
             if ct_.is_integer or ct_.kind in (T.DATE,)), None)
        if dist_col is not None:
            cl.catalog.distribute_table(
                tmp, dist_col, cl.settings.sharding.shard_count,
                cl.catalog.active_node_ids())
            cl.catalog.commit()
    if r.rows:
        # the rows as columns by one transposition (a result's rows all
        # hold one value a column)
        cl.copy_from(tmp, columns={c: list(v) for c, v in
                                   zip(names, zip(*r.rows))})
    return tmp


def _drop_intermediates(cl, names) -> None:
    """Drop a statement's intermediate tables.  It runs in ``finally``:
    a drop that fails (the table gone with a rolled-back transaction's
    catalog, a file that would not go) must not hide the statement's
    own outcome, so its error is dropped and the table stays until a
    DROP TABLE names it."""
    for name in names:
        try:
            cl.drop_table(name)
        except (CitusTpuError, OSError):
            pass


def _execute_derived(cl, stmt: A.Select) -> Result:
    """Derived tables: execute each FROM-subquery, materialize it as
    an intermediate result, rewrite the FROM item to reference it
    (reference: RecursivelyPlanSubqueryWalker,
    recursive_planning.c:1303)."""
    temps: list[str] = []

    def repl(item):
        if isinstance(item, A.SubqueryRef):
            r = cl._execute_stmt(item.select)
            if item.alias.startswith("__corr1row_") \
                    and "__cnt" in r.columns:
                # decorrelated NON-aggregate scalar subquery: enforce
                # PostgreSQL's runtime rule that it yields at most
                # one row per outer key.  Stricter than PostgreSQL:
                # we check every inner key, including ones no outer
                # row probes — a conservative error, never a silent
                # wrong answer
                ci = r.columns.index("__cnt")
                ni = (r.columns.index("__cntnull")
                      if "__cntnull" in r.columns else None)
                for row in r.rows:
                    eff = row[ci] or 0
                    if ni is not None and (row[ni] or 0) > 0:
                        eff += 1  # NULL is one distinct row
                    if eff > 1:
                        raise AnalysisError(
                            "more than one row returned by a subquery "
                            "used as an expression")
            tmp = _create_temp_from_result(cl, "derived", item.alias, r)
            temps.append(tmp)
            return A.TableRef(tmp, item.alias)
        if isinstance(item, A.FunctionRef):
            r = _srf_result(item.name, item.args, item.alias)
            label = item.alias or item.name
            tmp = _create_temp_from_result(cl, "srf", label, r)
            temps.append(tmp)
            return A.TableRef(tmp, item.alias or item.name)
        if isinstance(item, A.Join):
            return A.Join(repl(item.left), repl(item.right),
                          item.kind, item.condition)
        return item

    try:
        new_stmt = A.Select(stmt.items, repl(stmt.from_), stmt.where,
                            stmt.group_by, stmt.having, stmt.order_by,
                            stmt.limit, stmt.offset, stmt.distinct,
                            stmt.windows)
        return cl._execute_stmt(new_stmt)
    finally:
        _drop_intermediates(cl, temps)


#: the deepest nesting of SQL-function calls that expansion follows (a
#: function that calls itself fails here, not with a RecursionError)
_MAX_FUNCTION_DEPTH = 8


def _expand_functions_stmt(cl, stmt, depth: int = 0):
    """Inline user SQL functions (expression macros) everywhere in a
    SELECT or set operation: the planning-time analog of delegating a
    distributed function call next to the data
    (function_call_delegation.c)."""
    if depth > _MAX_FUNCTION_DEPTH:
        raise AnalysisError("SQL function expansion too deep (recursive?)")
    from citus_tpu_torch.planner.parser import Parser
    fns = cl.catalog.functions

    def rw(e, d):
        if e is None or not isinstance(e, A.Expr):
            return e
        if isinstance(e, A.FuncCall) and e.name in fns:
            spec = fns[e.name]
            if spec.get("kind") == "statement":
                raise AnalysisError(
                    f'{e.name}() is a trigger function and cannot be '
                    "called in an expression")
            if len(e.args) != len(spec["args"]):
                raise AnalysisError(
                    f'{e.name}() expects {len(spec["args"])} arguments')
            if d > _MAX_FUNCTION_DEPTH:
                raise AnalysisError(
                    "SQL function expansion too deep (recursive?)")
            body = Parser(spec["body"]).parse_expr()
            sub = {n: rw(a, d) for n, a in zip(spec["args"], e.args)}
            return rw(_subst_args(body, sub), d + 1)
        if isinstance(e, A.BinOp):
            return A.BinOp(e.op, rw(e.left, d), rw(e.right, d))
        if isinstance(e, A.UnOp):
            return A.UnOp(e.op, rw(e.operand, d))
        if isinstance(e, A.Between):
            return A.Between(rw(e.expr, d), rw(e.lo, d), rw(e.hi, d),
                             e.negated)
        if isinstance(e, A.InList):
            return A.InList(rw(e.expr, d), tuple(rw(i, d) for i in e.items),
                            e.negated)
        if isinstance(e, A.IsNull):
            return A.IsNull(rw(e.expr, d), e.negated)
        if isinstance(e, A.Cast):
            return A.Cast(rw(e.expr, d), e.type_name, e.type_args)
        if isinstance(e, A.CaseExpr):
            return A.CaseExpr(tuple((rw(c, d), rw(v, d)) for c, v in e.whens),
                              rw(e.else_, d) if e.else_ is not None else None)
        if isinstance(e, A.FuncCall):
            return dataclasses.replace(
                e, args=tuple(rw(a, d) for a in e.args),
                agg_order=tuple((rw(oe, d), asc)
                                for oe, asc in e.agg_order),
                filter=rw(e.filter, d) if e.filter is not None else None)
        if isinstance(e, A.WindowCall):
            return A.WindowCall(
                rw(e.func, d) if e.func is not None else None,
                tuple(rw(p, d) for p in e.partition_by),
                tuple((rw(oe, d), asc) for oe, asc in e.order_by),
                e.frame, e.ref_name, e.ref_verbatim)
        return e

    if isinstance(stmt, A.SetOp):
        return A.SetOp(stmt.op, stmt.all,
                       _expand_functions_stmt(cl, stmt.left, depth + 1),
                       _expand_functions_stmt(cl, stmt.right, depth + 1),
                       stmt.order_by, stmt.limit, stmt.offset)
    return A.Select(
        [A.SelectItem(rw(i.expr, 0), i.alias) for i in stmt.items],
        stmt.from_, rw(stmt.where, 0),
        [rw(g, 0) for g in stmt.group_by], rw(stmt.having, 0),
        [A.OrderItem(rw(o.expr, 0), o.ascending, o.nulls_first)
         for o in stmt.order_by],
        stmt.limit, stmt.offset, stmt.distinct,
        tuple((wn, rw(spec, 0)) for wn, spec in stmt.windows),
        tuple(rw(e, 0) for e in stmt.distinct_on))


def _expand_views(cl, item):
    """FROM references to views become derived tables over the view's
    stored SELECT (reference: views as distributed objects,
    commands/view.c; executed through recursive planning)."""
    from citus_tpu_torch.planner import parse_sql
    if isinstance(item, A.TableRef) and item.name in cl.catalog.views:
        sel = parse_sql(cl.catalog.views[item.name])[0]
        return A.SubqueryRef(sel, item.alias or item.name)
    if isinstance(item, A.Join):
        left = _expand_views(cl, item.left)
        right = _expand_views(cl, item.right)
        if left is not item.left or right is not item.right:
            return A.Join(left, right, item.kind, item.condition)
    return item


def _execute_constant_select(cl, stmt: A.Select) -> Result:
    """SELECT without FROM: constant expressions evaluated on the
    coordinator (one row), including scalar subqueries."""
    from citus_tpu_torch.planner.recursive import rewrite_subqueries
    stmt = rewrite_subqueries(stmt, lambda sub: cl._execute_stmt(sub))
    if stmt.group_by or stmt.having or stmt.distinct:
        raise UnsupportedFeatureError(
            "GROUP BY/HAVING/DISTINCT need a FROM clause")
    row, names = [], []
    for i, item in enumerate(stmt.items):
        row.append(_eval_const(item.expr))
        names.append(item.alias or (item.expr.name
                                    if isinstance(item.expr, A.ColumnRef)
                                    else f"column{i + 1}"))
    rows = [tuple(row)]
    if stmt.where is not None:
        if _eval_const(stmt.where) is not True:
            rows = []
    if stmt.offset:
        rows = rows[stmt.offset:]
    if stmt.limit is not None:
        rows = rows[:stmt.limit]
    return Result(columns=names, rows=rows,
                  explain={"strategy": "constant"})


def _execute_grouping_sets(cl, stmt: A.Select, sets) -> Result:
    """ROLLUP/CUBE/GROUPING SETS: one grouped execution per set,
    select items that are grouping expressions of an absent set pad
    to NULL, results concatenate (reference: native grouping-set
    execution; here composed over the standard grouped pipeline)."""
    all_keys = set()
    for s_ in sets:
        all_keys.update(s_)
    names = []
    for i, item in enumerate(stmt.items):
        names.append(item.alias or (item.expr.name
                                    if isinstance(item.expr, A.ColumnRef)
                                    else f"column{i + 1}"))
    rows_all: list[tuple] = []
    types_first = None
    for s_ in sets:
        keep_pos, sub_items = [], []
        grouping_marks = {}  # position -> 0/1 constant for this set
        for i, item in enumerate(stmt.items):
            e = item.expr
            if isinstance(e, A.FuncCall) and e.name == "grouping" \
                    and len(e.args) == 1:
                # GROUPING(col): 1 when the column is rolled up
                # (absent from this set), 0 when grouped by
                grouping_marks[i] = 0 if e.args[0] in s_ else 1
                continue
            if e in all_keys and e not in s_:
                continue  # key absent from this set: pad NULL
            keep_pos.append(i)
            sub_items.append(item)
        # HAVING may reference rolled-up columns: they are NULL in
        # this set (PostgreSQL semantics)
        having = stmt.having
        if having is not None:
            absent = {k for k in all_keys if k not in s_}
            if absent:
                having = _replace_exprs(
                    having, {k: A.Literal(None, "null") for k in absent})
        if not sub_items:
            # only grouping columns selected and this is the empty
            # set: the grand-total group is one all-NULL row
            probe = A.Select([A.SelectItem(
                A.FuncCall("count", (A.Star(),)))],
                stmt.from_, stmt.where, list(s_), having)
            if cl._execute_stmt(probe).rows:
                full = [None] * len(stmt.items)
                for pos, mark in grouping_marks.items():
                    full[pos] = mark
                rows_all.append(tuple(full))
            continue
        sub = A.Select(sub_items, stmt.from_, stmt.where, list(s_),
                       having)
        r = cl._execute_stmt(sub)
        if types_first is None and not any(
                i not in keep_pos for i in range(len(stmt.items))):
            types_first = r.types
        for row in r.rows:
            full = [None] * len(stmt.items)
            for j, pos in enumerate(keep_pos):
                full[pos] = row[j]
            for pos, mark in grouping_marks.items():
                full[pos] = mark
            rows_all.append(tuple(full))
    if stmt.distinct:
        rows_all = list(dict.fromkeys(rows_all))
    rows_all = _sort_rows(rows_all, names, stmt.order_by)
    if stmt.offset:
        rows_all = rows_all[stmt.offset:]
    if stmt.limit is not None:
        rows_all = rows_all[:stmt.limit]
    return Result(columns=names, rows=rows_all, types=types_first,
                  explain={"strategy": "grouping_sets",
                           "sets": len(sets)})


def _execute_setop(cl, stmt: A.SetOp) -> Result:
    """UNION / INTERSECT / EXCEPT [ALL]: execute both sides, combine
    on the coordinator with SQL bag/set semantics (NULLs compare
    equal, like DISTINCT).  Reference: set operations that cannot be
    pushed down run through recursive planning
    (recursive_planning.c:223)."""
    from collections import Counter
    if stmt.op == "union" and stmt.all and _union_all_chain(stmt.left):
        return _execute_union_all_chain(cl, stmt)
    lres = cl._execute_stmt(stmt.left)
    rres = cl._execute_stmt(stmt.right)
    if len(lres.columns) != len(rres.columns):
        raise AnalysisError(
            "each side of a set operation must return the same number "
            "of columns")
    lrows, rrows = list(lres.rows), list(rres.rows)
    if stmt.op == "union":
        rows = lrows + rrows
        if not stmt.all:
            rows = list(dict.fromkeys(rows))
    elif stmt.op == "intersect":
        rc = Counter(rrows)
        if stmt.all:
            rows, used = [], Counter()
            for row in lrows:
                if used[row] < rc.get(row, 0):
                    used[row] += 1
                    rows.append(row)
        else:
            rows = [row for row in dict.fromkeys(lrows) if rc.get(row, 0)]
    else:  # except
        if stmt.all:
            rc = Counter(rrows)
            rows, used = [], Counter()
            for row in lrows:
                if used[row] < rc.get(row, 0):
                    used[row] += 1
                else:
                    rows.append(row)
        else:
            rset = set(rrows)
            rows = [row for row in dict.fromkeys(lrows) if row not in rset]
    rows = _sort_rows(rows, lres.columns, stmt.order_by)
    if stmt.offset:
        rows = rows[stmt.offset:]
    if stmt.limit is not None:
        rows = rows[:stmt.limit]
    return Result(columns=lres.columns, rows=rows,
                  types=lres.types or rres.types,
                  explain={"strategy": f"setop:{stmt.op}"})


def _union_all_chain(node) -> bool:
    """Whether ``node`` is an inner link of a left-deep UNION ALL chain
    (no ORDER BY, LIMIT or OFFSET of its own)."""
    return (isinstance(node, A.SetOp) and node.op == "union" and node.all
            and not node.order_by and node.limit is None
            and not node.offset)


def _execute_union_all_chain(cl, stmt: A.SetOp) -> Result:
    """A left-deep UNION ALL chain (a partitioned parent's surviving
    partitions, ``partitioning.expand_from``) run arm by arm: the rows of
    the nested evaluation, in its order, at one statement of depth where
    the nested one takes one per arm.  The reference nests, so a parent
    with more than about 60 surviving partitions passes its statement
    depth limit of 64 there (ROADMAP.md C14)."""
    arms = [stmt.right]
    node = stmt.left
    while _union_all_chain(node):
        arms.append(node.right)
        node = node.left
    arms.append(node)
    arms.reverse()
    first = None
    rows: list = []
    types = None
    for arm in arms:
        r = cl._execute_stmt(arm)
        if first is None:
            first = r
        elif len(r.columns) != len(first.columns):
            raise AnalysisError(
                "each side of a set operation must return the same number "
                "of columns")
        types = types or r.types
        rows.extend(r.rows)
    rows = _sort_rows(rows, first.columns, stmt.order_by)
    if stmt.offset:
        rows = rows[stmt.offset:]
    if stmt.limit is not None:
        rows = rows[:stmt.limit]
    return Result(columns=first.columns, rows=rows, types=types,
                  explain={"strategy": "setop:union"})


def _execute_with(cl, stmt: A.WithSelect) -> Result:
    """Materialize each CTE as a temporary local table (the
    intermediate-result strategy of recursive_planning.c), rewrite
    references in later CTEs and the body, execute, drop."""
    mapping: dict[str, str] = {}
    temps: list[str] = []

    def remap_from(item):
        if isinstance(item, A.TableRef):
            if item.name in mapping:
                return A.TableRef(mapping[item.name], item.alias or item.name)
            return item
        if isinstance(item, A.Join):
            return A.Join(remap_from(item.left), remap_from(item.right),
                          item.kind, item.condition)
        if isinstance(item, A.SubqueryRef):
            return A.SubqueryRef(remap_select(item.select), item.alias)
        return item

    def remap_select(sel):
        if isinstance(sel, A.SetOp):
            return A.SetOp(sel.op, sel.all, remap_select(sel.left),
                           remap_select(sel.right), sel.order_by,
                           sel.limit, sel.offset)
        # dataclasses.replace carries every other field (windows,
        # future additions) — positional rebuilds have dropped
        # fields here before
        return dataclasses.replace(sel, from_=remap_from(sel.from_))

    try:
        for name, sel in stmt.ctes:
            if stmt.recursive and name in _from_relations(sel):
                r = _iterate_recursive_cte(cl, name, sel, remap_select,
                                           stmt.cte_cols.get(name))
            else:
                r = cl._execute_stmt(remap_select(sel))
                cols = stmt.cte_cols.get(name)
                if cols is not None:
                    if len(cols) != len(r.columns):
                        raise AnalysisError(
                            f'CTE "{name}" has {len(r.columns)} columns, '
                            f"{len(cols)} aliases given")
                    r = Result(columns=list(cols), rows=r.rows,
                               types=r.types)
            tmp = _create_temp_from_result(cl, "cte", name, r)
            mapping[name] = tmp
            temps.append(tmp)
        body = remap_select(stmt.body)
        return cl._execute_stmt(body)
    finally:
        _drop_intermediates(cl, temps)


#: safety caps for WITH RECURSIVE (the reference relies on PostgreSQL's
#: executor, which iterates unboundedly; a runaway recursion here would
#: eat the coordinator, so both depth and total rows are capped)
RECURSIVE_MAX_ITERATIONS = 500
RECURSIVE_MAX_ROWS = 1_000_000


def _iterate_recursive_cte(cl, name: str, sel, remap_select, cols):
    """WITH RECURSIVE iteration, coordinator-materialized: the CTE must
    be ``base UNION [ALL] recursive_term``; each round the recursive
    term runs with the CTE name bound to the PREVIOUS round's rows (the
    PostgreSQL working-table semantics), until a round yields nothing
    new.  Reference: recursive_planning.c:1175-1181 supports recursive
    CTEs through exactly this materialize-and-iterate shape."""
    if not (isinstance(sel, A.SetOp) and sel.op == "union"):
        raise UnsupportedFeatureError(
            "a recursive CTE must be 'base UNION [ALL] recursive-term'")
    base, rec = sel.left, sel.right
    if name in _from_relations(base):
        raise UnsupportedFeatureError(
            "the recursive reference must be in the second UNION arm")
    dedup = not sel.all  # UNION distinct: drop already-seen rows
    base_r = cl._execute_stmt(remap_select(base))
    out_cols = list(cols) if cols is not None else list(base_r.columns)
    if cols is not None and len(cols) != len(base_r.columns):
        raise AnalysisError(
            f'CTE "{name}" has {len(base_r.columns)} columns, '
            f"{len(cols)} aliases given")
    seen = set(base_r.rows) if dedup else None
    working = list(dict.fromkeys(base_r.rows)) if dedup else list(base_r.rows)
    result = list(working)
    iterations = 0
    while working:
        iterations += 1
        if iterations > RECURSIVE_MAX_ITERATIONS:
            raise ExecutionError(
                f"recursive CTE {name!r} exceeded "
                f"{RECURSIVE_MAX_ITERATIONS} iterations")
        wr = Result(columns=out_cols, rows=working, types=base_r.types)
        wtmp = _create_temp_from_result(cl, "rcte", name, wr)
        try:
            def bind_working(item):
                if isinstance(item, A.TableRef):
                    if item.name == name:
                        return A.TableRef(wtmp, item.alias or name)
                    return item
                if isinstance(item, A.Join):
                    return dataclasses.replace(
                        item, left=bind_working(item.left),
                        right=bind_working(item.right))
                if isinstance(item, A.SubqueryRef):
                    return dataclasses.replace(item, select=dataclasses.replace(
                        item.select, from_=bind_working(item.select.from_)))
                return item

            step = remap_select(rec)
            step = dataclasses.replace(step, from_=bind_working(step.from_))
            rr = cl._execute_stmt(step)
        finally:
            _drop_intermediates(cl, [wtmp])
        fresh = []
        for row in rr.rows:
            if dedup:
                if row in seen:
                    continue
                seen.add(row)
            fresh.append(row)
        result.extend(fresh)
        if len(result) > RECURSIVE_MAX_ROWS:
            raise ExecutionError(
                f"recursive CTE {name!r} exceeded {RECURSIVE_MAX_ROWS} rows")
        working = fresh
    return Result(columns=out_cols, rows=result, types=base_r.types)


def _execute_unnest(cl, stmt):
    """SELECT ... unnest(arr_expr) ... FROM ...: run the query with the
    array expression in the unnest's place, then explode each row once
    per element, repeating the other output columns (PostgreSQL's
    SRF-in-target-list expansion for a single SRF).

    Reference: unnest(anyarray); multiple SRFs in one target list (PG's
    lock-step expansion) are not supported."""

    srf_idx = [i for i, it in enumerate(stmt.items)
               if isinstance(it.expr, A.FuncCall) and it.expr.name == "unnest"]
    if len(srf_idx) != 1:
        raise UnsupportedFeatureError(
            "only one unnest() per target list is supported")
    i = srf_idx[0]
    call = stmt.items[i].expr
    if len(call.args) != 1:
        raise AnalysisError("unnest(array) expects one argument")
    if stmt.group_by or stmt.having or stmt.distinct:
        raise UnsupportedFeatureError(
            "unnest() cannot be combined with GROUP BY/HAVING/DISTINCT")
    inner_items = list(stmt.items)
    inner_items[i] = A.SelectItem(call.args[0],
                                  stmt.items[i].alias or "unnest")
    inner = dataclasses.replace(stmt, items=inner_items,
                                order_by=[], limit=None, offset=None)
    r = cl._execute_stmt(inner)
    out_rows = []
    for row in r.rows:
        arr = row[i]
        if arr is None:
            continue  # PG: NULL array contributes no rows
        if not isinstance(arr, (list, tuple)):
            raise AnalysisError(
                f"unnest requires an array column (got {type(arr).__name__})")
        for v in arr:
            out_rows.append(row[:i] + (v,) + row[i + 1:])
    cols = list(r.columns)
    cols[i] = stmt.items[i].alias or "unnest"
    if stmt.order_by:
        out_rows = _sort_rows(out_rows, cols, stmt.order_by)
    if stmt.offset:
        out_rows = out_rows[stmt.offset:]
    if stmt.limit is not None:
        out_rows = out_rows[:stmt.limit]
    return Result(columns=cols, rows=out_rows)
