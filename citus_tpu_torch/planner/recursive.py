"""Recursive planning: subqueries as intermediate results.

Reference: src/backend/distributed/planner/recursive_planning.c — a
subquery that can't be pushed down executes as an independent plan and
its result replaces the subquery via read_intermediate_result().  Here
the same two phases: execute each A.Subquery first (through the full
planner/executor), then rewrite the outer AST with the materialized
result — a literal for scalar context, a literal list for IN.
"""

from __future__ import annotations

import datetime
import decimal
from dataclasses import replace as _dc_replace

from citus_tpu_torch.errors import AnalysisError
from citus_tpu_torch.planner import ast_nodes as A


def _value_to_literal(v) -> A.Literal:
    if v is None:
        return A.Literal(None, "null")
    if isinstance(v, bool):
        return A.Literal(v, "bool")
    if isinstance(v, int):
        return A.Literal(v, "int")
    if isinstance(v, decimal.Decimal):
        return A.Literal(v, "decimal")
    if isinstance(v, float):
        return A.Literal(v, "float")
    if isinstance(v, str):
        return A.Literal(v, "string")
    if isinstance(v, (datetime.date, datetime.datetime)):
        return A.Literal(v.isoformat(sep=" ") if isinstance(v, datetime.datetime)
                         else v.isoformat(), "string")
    raise AnalysisError(f"cannot use subquery value {v!r} as a literal")


def has_subquery(e) -> bool:
    return any(True for _ in _walk_expr(e))


def _walk_expr(e):
    if isinstance(e, (A.Subquery, A.Exists)):
        yield e
        return
    if isinstance(e, A.BinOp):
        yield from _walk_expr(e.left)
        yield from _walk_expr(e.right)
    elif isinstance(e, A.UnOp):
        yield from _walk_expr(e.operand)
    elif isinstance(e, A.Between):
        yield from _walk_expr(e.expr)
        yield from _walk_expr(e.lo)
        yield from _walk_expr(e.hi)
    elif isinstance(e, A.InList):
        yield from _walk_expr(e.expr)
        for it in e.items:
            yield from _walk_expr(it)
    elif isinstance(e, A.IsNull):
        yield from _walk_expr(e.expr)
    elif isinstance(e, A.Cast):
        yield from _walk_expr(e.expr)
    elif isinstance(e, A.CaseExpr):
        for c, v in e.whens:
            yield from _walk_expr(c)
            yield from _walk_expr(v)
        if e.else_ is not None:
            yield from _walk_expr(e.else_)
    elif isinstance(e, A.FuncCall):
        for a in e.args:
            yield from _walk_expr(a)


def bind_params(e, params):
    """Replace $N placeholders with literal values."""
    if e is None:
        return None
    if isinstance(e, A.Param):
        if params is None or not (1 <= e.index <= len(params)):
            raise AnalysisError(f"no value supplied for parameter ${e.index}")
        return _value_to_literal(params[e.index - 1])
    if isinstance(e, A.BinOp):
        return A.BinOp(e.op, bind_params(e.left, params), bind_params(e.right, params))
    if isinstance(e, A.UnOp):
        return A.UnOp(e.op, bind_params(e.operand, params))
    if isinstance(e, A.Between):
        return A.Between(bind_params(e.expr, params), bind_params(e.lo, params),
                         bind_params(e.hi, params), e.negated)
    if isinstance(e, A.InList):
        return A.InList(bind_params(e.expr, params),
                        tuple(bind_params(i, params) for i in e.items), e.negated)
    if isinstance(e, A.IsNull):
        return A.IsNull(bind_params(e.expr, params), e.negated)
    if isinstance(e, A.Cast):
        return A.Cast(bind_params(e.expr, params), e.type_name, e.type_args)
    if isinstance(e, A.CaseExpr):
        return A.CaseExpr(tuple((bind_params(c, params), bind_params(v, params))
                                for c, v in e.whens),
                          bind_params(e.else_, params) if e.else_ is not None else None)
    if isinstance(e, A.WindowCall):
        return A.WindowCall(
            bind_params(e.func, params),
            tuple(bind_params(p, params) for p in e.partition_by),
            tuple((bind_params(oe, params), asc) for oe, asc in e.order_by),
            e.frame, e.ref_name, e.ref_verbatim)
    if isinstance(e, A.FuncCall):
        import dataclasses
        return dataclasses.replace(
            e, args=tuple(bind_params(a, params) for a in e.args),
            agg_order=tuple((bind_params(oe, params), asc)
                            for oe, asc in e.agg_order),
            filter=bind_params(e.filter, params)
            if e.filter is not None else None)
    if isinstance(e, A.Subquery):
        return A.Subquery(rewrite_params(e.select, params))
    if isinstance(e, A.Exists):
        return A.Exists(rewrite_params(e.select, params), e.negated)
    return e


def has_params(e) -> bool:
    if e is None:
        return False
    if isinstance(e, A.Param):
        return True
    if isinstance(e, A.BinOp):
        return has_params(e.left) or has_params(e.right)
    if isinstance(e, (A.UnOp,)):
        return has_params(e.operand)
    if isinstance(e, A.Between):
        return has_params(e.expr) or has_params(e.lo) or has_params(e.hi)
    if isinstance(e, A.InList):
        return has_params(e.expr) or any(has_params(i) for i in e.items)
    if isinstance(e, (A.IsNull, A.Cast)):
        return has_params(e.expr)
    if isinstance(e, A.CaseExpr):
        return any(has_params(c) or has_params(v) for c, v in e.whens) or             has_params(e.else_)
    if isinstance(e, A.FuncCall):
        return any(has_params(a) for a in e.args)
    return False


def rewrite_params(stmt, params):
    """Substitute $N placeholders throughout a statement."""
    import dataclasses
    if isinstance(stmt, A.Select):
        return A.Select(
            items=[A.SelectItem(bind_params(i.expr, params), i.alias)
                   for i in stmt.items],
            from_=stmt.from_,
            where=bind_params(stmt.where, params),
            group_by=[bind_params(g, params) for g in stmt.group_by],
            having=bind_params(stmt.having, params),
            order_by=[A.OrderItem(bind_params(o.expr, params), o.ascending,
                                  o.nulls_first) for o in stmt.order_by],
            limit=stmt.limit, offset=stmt.offset, distinct=stmt.distinct,
            windows=tuple((wn, bind_params(spec, params))
                          for wn, spec in stmt.windows),
            distinct_on=tuple(bind_params(e, params)
                              for e in stmt.distinct_on))
    if isinstance(stmt, A.Delete):
        return A.Delete(stmt.table, bind_params(stmt.where, params),
                        stmt.returning)
    if isinstance(stmt, A.Update):
        return A.Update(stmt.table,
                        [(c, bind_params(e, params)) for c, e in stmt.assignments],
                        bind_params(stmt.where, params), stmt.returning)
    if isinstance(stmt, A.Insert) and stmt.rows:
        oc = stmt.on_conflict
        if oc is not None:
            oc = dataclasses.replace(
                oc,
                assignments=tuple((c, bind_params(e, params))
                                  for c, e in oc.assignments),
                where=bind_params(oc.where, params)
                if oc.where is not None else None)
        return A.Insert(stmt.table, stmt.columns,
                        [[bind_params(e, params) for e in row] for row in stmt.rows],
                        stmt.select, stmt.returning, oc)
    return stmt


def _from_aliases(item) -> set:
    if isinstance(item, A.TableRef):
        return {item.alias or item.name}
    if isinstance(item, A.SubqueryRef):
        return {item.alias}
    if isinstance(item, A.Join):
        return _from_aliases(item.left) | _from_aliases(item.right)
    return set()


def _split_and(e):
    if isinstance(e, A.BinOp) and e.op == "and":
        return _split_and(e.left) + _split_and(e.right)
    return [e] if e is not None else []


def _and_all(parts):
    out = None
    for p in parts:
        out = p if out is None else A.BinOp("and", out, p)
    return out


def _outer_refs(e, outer: set, inner: set) -> bool:
    """Does the expression reference a column qualified by an OUTER
    relation alias?  (Unqualified references are assumed inner.)"""
    for n in _walk_columns(e):
        if n.table is not None and n.table in outer and n.table not in inner:
            return True
    return False


def _walk_columns(e):
    if isinstance(e, A.ColumnRef):
        yield e
    elif isinstance(e, A.BinOp):
        yield from _walk_columns(e.left)
        yield from _walk_columns(e.right)
    elif isinstance(e, A.UnOp):
        yield from _walk_columns(e.operand)
    elif isinstance(e, A.Between):
        yield from _walk_columns(e.expr)
        yield from _walk_columns(e.lo)
        yield from _walk_columns(e.hi)
    elif isinstance(e, A.InList):
        yield from _walk_columns(e.expr)
        for it in e.items:
            yield from _walk_columns(it)
    elif isinstance(e, (A.IsNull, A.Cast)):
        yield from _walk_columns(e.expr)
    elif isinstance(e, A.CaseExpr):
        for c, v in e.whens:
            yield from _walk_columns(c)
            yield from _walk_columns(v)
        if e.else_ is not None:
            yield from _walk_columns(e.else_)
    elif isinstance(e, A.FuncCall):
        for a in e.args:
            yield from _walk_columns(a)


def decorrelate_exists(sub: A.Exists, outer_aliases: set,
                       negated: bool):
    """Equality-correlated EXISTS -> semi/anti-join rewrite (reference:
    recursive planning converts correlated sublinks it can pull up,
    recursive_planning.c).  EXISTS (SELECT .. FROM u WHERE u.x = t.y AND
    <inner preds>) becomes t.y IN (SELECT x FROM u WHERE <inner preds>);
    NOT EXISTS additionally preserves NULL outer keys (they can never
    match, so NOT EXISTS is true for them — unlike NOT IN).  Returns the
    rewritten expression or None when the shape is not supported."""
    sel = sub.select
    if not isinstance(sel, A.Select) or not isinstance(sel.from_, A.TableRef):
        return None
    if sel.group_by or sel.having or sel.limit is not None or sel.offset:
        return None
    from citus_tpu_torch.planner.bind import _contains_agg
    if any(_contains_agg(it.expr) for it in sel.items
           if isinstance(it.expr, A.Expr)):
        # an ungrouped aggregate query returns exactly one row, so
        # EXISTS over it is unconditionally true (PostgreSQL semantics)
        return A.Literal(not negated, "bool")
    inner = {sel.from_.alias or sel.from_.name}
    # outer refs anywhere outside WHERE make the shape unsupported
    for it in sel.items:
        if _outer_refs(it.expr, outer_aliases, inner):
            return None
    split = _collect_equality_corr(sel.where, outer_aliases, inner)
    if split is None or len(split[0]) != 1:
        return None
    corr, inner_only = split
    outer_e, inner_e = corr[0]
    inner_sel = A.Select([A.SelectItem(inner_e)], sel.from_,
                         _and_all(inner_only))
    if not negated:
        return A.InList(outer_e, (A.Subquery(inner_sel),), negated=False)
    return A.BinOp("or",
                   A.InList(outer_e, (A.Subquery(inner_sel),), negated=True),
                   A.IsNull(outer_e))


def _collect_equality_corr(where, outer: set, inner: set):
    """Split WHERE into (corr pairs [(outer_e, inner_e)], inner-only
    conjuncts); None when any correlated conjunct is not a simple
    outer=inner equality."""
    corr, inner_only = [], []
    for c in _split_and(where):
        if not _outer_refs(c, outer, inner):
            inner_only.append(c)
            continue
        if not (isinstance(c, A.BinOp) and c.op == "="):
            return None
        l_out = _outer_refs(c.left, outer, inner)
        r_out = _outer_refs(c.right, outer, inner)
        if l_out and not r_out:
            corr.append((c.left, c.right))
        elif r_out and not l_out:
            corr.append((c.right, c.left))
        else:
            return None
    return corr, inner_only


def decorrelate_scalars(stmt: A.Select) -> A.Select:
    """Equality-correlated scalar subqueries in the select list / WHERE
    become LEFT JOINs against a grouped derived table (reference:
    sublink pull-up in recursive planning):

        SELECT (SELECT max(x) FROM u WHERE u.k = t.k) FROM t
        -> SELECT __corr_1.__cv FROM t
           LEFT JOIN (SELECT u.k AS __ck1, max(x) AS __cv
                      FROM u GROUP BY u.k) __corr_1 ON t.k = __corr_1.__ck1

    Multi-key correlation joins on every key.  Aggregates guarantee one
    row per key; a missing key yields NULL (count() additionally
    coalesces to 0, matching scalar-subquery semantics over an empty
    set).  NON-aggregate scalars group as max(expr) with a count(*)
    rider; the materialization layer raises when any key saw more than
    one row (PostgreSQL's runtime error for multi-row scalar
    subqueries — see Cluster._execute_derived).  Returns the original
    statement when nothing matches."""
    if stmt.from_ is None or stmt.group_by or stmt.having or stmt.distinct:
        return stmt
    if any(isinstance(i.expr, A.WindowCall) for i in stmt.items):
        return stmt
    outer = _from_aliases(stmt.from_)
    counter = [0]
    joins: list = []

    def maybe_rewrite(sub: A.Subquery, agg_only: bool = False):
        from citus_tpu_torch.planner.bind import _contains_agg
        sel = sub.select
        if not isinstance(sel, A.Select) or not isinstance(sel.from_, A.TableRef):
            return None
        if sel.group_by or sel.having or sel.limit is not None \
                or sel.offset or len(sel.items) != 1:
            return None
        item = sel.items[0]
        has_agg = _contains_agg(item.expr)
        if agg_only and not has_agg:
            return None
        inner = {sel.from_.alias or sel.from_.name}
        if _outer_refs(item.expr, outer, inner):
            return None
        split = _collect_equality_corr(sel.where, outer, inner)
        if split is None or not split[0]:
            return None
        corr, inner_only = split
        counter[0] += 1
        key_items = [A.SelectItem(ie, f"__ck{i + 1}")
                     for i, (_oe, ie) in enumerate(corr)]
        if has_agg:
            alias = f"__corr_{counter[0]}"
            derived = A.Select(
                key_items + [A.SelectItem(item.expr, "__cv")],
                sel.from_, _and_all(inner_only),
                group_by=[ie for _oe, ie in corr])
        else:
            # single-row scalar: max() over one row IS the row; the
            # __cnt rider lets materialization enforce single-row-ness.
            # For SELECT DISTINCT, count distinct non-null values and
            # let the materialization check add one when NULL rows are
            # present (a NULL is one distinct row to PG) — DISTINCT
            # dedups before the one-row rule applies
            alias = f"__corr1row_{counter[0]}"
            extra = [A.SelectItem(A.FuncCall("max", (item.expr,)), "__cv")]
            if sel.distinct:
                extra += [
                    A.SelectItem(A.FuncCall("count", (item.expr,),
                                            distinct=True), "__cnt"),
                    A.SelectItem(A.BinOp(
                        "-", A.FuncCall("count", (A.Star(),)),
                        A.FuncCall("count", (item.expr,))), "__cntnull")]
            else:
                extra += [A.SelectItem(A.FuncCall("count", (A.Star(),)),
                                       "__cnt")]
            derived = A.Select(
                key_items + extra,
                sel.from_, _and_all(inner_only),
                group_by=[ie for _oe, ie in corr])
        joins.append((alias, derived, [oe for oe, _ie in corr]))
        repl: A.Expr = A.ColumnRef("__cv", table=alias)
        if has_agg and isinstance(item.expr, A.FuncCall) \
                and item.expr.name == "count":
            repl = A.FuncCall("coalesce", (repl, A.Literal(0, "int")))
        return repl

    def rwx(e):
        if e is None:
            return None
        if isinstance(e, A.Subquery):
            r = maybe_rewrite(e)
            return r if r is not None else e
        if isinstance(e, A.BinOp):
            return A.BinOp(e.op, rwx(e.left), rwx(e.right))
        if isinstance(e, A.UnOp):
            return A.UnOp(e.op, rwx(e.operand))
        if isinstance(e, A.Between):
            return A.Between(rwx(e.expr), rwx(e.lo), rwx(e.hi), e.negated)
        if isinstance(e, A.InList):
            # IN-list subqueries are SET-valued UNLESS the item is an
            # ungrouped aggregate (exactly one value): only the
            # aggregate shape may decorrelate as a scalar here; true
            # set subqueries go to the correlated-IN (decorrelate_where)
            # / materialize (rewrite_subqueries) paths
            items = []
            for i in e.items:
                if isinstance(i, A.Subquery):
                    r = maybe_rewrite(i, agg_only=True)
                    items.append(r if r is not None else i)
                else:
                    items.append(rwx(i))
            return A.InList(rwx(e.expr), tuple(items), e.negated)
        if isinstance(e, A.IsNull):
            return A.IsNull(rwx(e.expr), e.negated)
        if isinstance(e, A.Cast):
            return A.Cast(rwx(e.expr), e.type_name, e.type_args)
        if isinstance(e, A.CaseExpr):
            return A.CaseExpr(tuple((rwx(c), rwx(v)) for c, v in e.whens),
                              rwx(e.else_) if e.else_ is not None else None)
        if isinstance(e, A.FuncCall):
            import dataclasses
            return dataclasses.replace(
                e, args=tuple(rwx(a) for a in e.args),
                agg_order=tuple((rwx(oe), asc) for oe, asc in e.agg_order),
                filter=rwx(e.filter) if e.filter is not None else None)
        return e

    new_items = [A.SelectItem(rwx(i.expr), i.alias) for i in stmt.items]
    new_where = rwx(stmt.where)
    if not joins:
        return stmt
    new_from = stmt.from_
    for alias, derived, outer_es in joins:
        cond = _and_all([
            A.BinOp("=", oe, A.ColumnRef(f"__ck{i + 1}", table=alias))
            for i, oe in enumerate(outer_es)])
        new_from = A.Join(new_from, A.SubqueryRef(derived, alias),
                          "left", cond)
    return A.Select(new_items, new_from, new_where, [], None,
                    stmt.order_by, stmt.limit, stmt.offset, stmt.distinct,
                    stmt.windows)


def _sub_outer_refs(sel: A.Select, outer: set) -> bool:
    """Does the subquery reference any outer alias anywhere?"""
    if not isinstance(sel, A.Select):
        return False
    inner = _from_aliases(sel.from_) if sel.from_ is not None else set()
    exprs = ([i.expr for i in sel.items] + [sel.where, sel.having]
             + list(sel.group_by))
    return any(e is not None and _outer_refs(e, outer, inner) for e in exprs)


def decorrelate_where(stmt: A.Select) -> A.Select:
    """Multi-key equality-correlated [NOT] EXISTS and positive
    correlated IN in top-level WHERE conjuncts become semi/anti joins
    on distinct derived tables (reference: sublink-to-join pull-up,
    recursive_planning.c):

        WHERE EXISTS (SELECT 1 FROM u WHERE u.a = t.a AND u.b = t.b)
        -> JOIN (SELECT DISTINCT a __ck1, b __ck2 FROM u) __semi_1
           ON t.a = __semi_1.__ck1 AND t.b = __semi_1.__ck2

    NOT EXISTS LEFT-JOINs the same derived and keeps only unmatched
    rows (anti join; NULL outer keys never match and are preserved).
    Correlated ``expr IN (SELECT x ...)`` desugars to EXISTS with the
    extra equality ``x = expr`` first — sound in WHERE context, where
    NULL and FALSE both filter.  Single-key EXISTS elsewhere (under OR
    etc.) keeps the expression-level IN rewrite."""
    if stmt.from_ is None or stmt.where is None:
        return stmt
    outer = _from_aliases(stmt.from_)
    counter = [0]
    joins: list = []   # (alias, derived, [outer keys], anti)
    new_conjs: list = []
    changed = False
    for c in _split_and(stmt.where):
        # correlated IN -> EXISTS desugar (positive conjuncts only)
        if isinstance(c, A.InList) and not c.negated and len(c.items) == 1 \
                and isinstance(c.items[0], A.Subquery):
            from citus_tpu_torch.planner.bind import _contains_agg
            sub = c.items[0].select
            if isinstance(sub, A.Select) and isinstance(sub.from_, A.TableRef) \
                    and len(sub.items) == 1 and not sub.group_by \
                    and not sub.having and sub.limit is None \
                    and not sub.offset and not sub.distinct \
                    and not _contains_agg(sub.items[0].expr) \
                    and _sub_outer_refs(sub, outer):
                c = A.Exists(A.Select(
                    [A.SelectItem(A.Literal(1, "int"))], sub.from_,
                    _and_all(_split_and(sub.where)
                             + [A.BinOp("=", sub.items[0].expr, c.expr)])))
        neg, e = False, c
        if isinstance(e, A.UnOp) and e.op == "not" \
                and isinstance(e.operand, A.Exists):
            neg, e = True, e.operand
        if isinstance(e, A.Exists):
            from citus_tpu_torch.planner.bind import _contains_agg
            sel = e.select
            if isinstance(sel, A.Select) and isinstance(sel.from_, A.TableRef) \
                    and not sel.group_by and not sel.having \
                    and sel.limit is None and not sel.offset:
                if any(isinstance(i.expr, A.Expr) and _contains_agg(i.expr)
                       for i in sel.items):
                    # ungrouped aggregate: exactly one row, EXISTS is
                    # unconditionally true (PostgreSQL semantics)
                    new_conjs.append(A.Literal(not neg, "bool"))
                    changed = True
                    continue
                inner = {sel.from_.alias or sel.from_.name}
                items_ok = not any(_outer_refs(i.expr, outer, inner)
                                   for i in sel.items)
                split = _collect_equality_corr(sel.where, outer, inner) \
                    if items_ok else None
                if split is not None and split[0]:
                    corr, inner_only = split
                    counter[0] += 1
                    alias = f"__semi_{counter[0]}"
                    derived = A.Select(
                        [A.SelectItem(ie, f"__ck{i + 1}")
                         for i, (_oe, ie) in enumerate(corr)],
                        sel.from_, _and_all(inner_only), distinct=True)
                    joins.append((alias, derived,
                                  [oe for oe, _ie in corr], neg))
                    if neg:
                        new_conjs.append(A.IsNull(
                            A.ColumnRef("__ck1", table=alias)))
                    changed = True
                    continue
        new_conjs.append(c)
    if not changed:
        return stmt
    import dataclasses
    new_from = stmt.from_
    for alias, derived, outer_es, anti in joins:
        cond = _and_all([
            A.BinOp("=", oe, A.ColumnRef(f"__ck{i + 1}", table=alias))
            for i, oe in enumerate(outer_es)])
        new_from = A.Join(new_from, A.SubqueryRef(derived, alias),
                          "left" if anti else "inner", cond)
    return dataclasses.replace(stmt, from_=new_from,
                               where=_and_all(new_conjs))


def rewrite_subqueries(stmt: A.Select, run_select) -> A.Select:
    """Execute every subquery in the statement via ``run_select`` and
    substitute its result.  Returns a new Select (or the original when
    there was nothing to do)."""
    outer_aliases = _from_aliases(stmt.from_) if stmt.from_ is not None else set()

    def exec_scalar(sub: A.Subquery) -> A.Literal:
        r = run_select(sub.select)
        if len(r.columns) != 1 and len(r.rows) and len(r.rows[0]) != 1:
            raise AnalysisError("scalar subquery must return one column")
        if len(r.rows) == 0:
            return A.Literal(None, "null")
        if len(r.rows) > 1:
            raise AnalysisError("scalar subquery returned more than one row")
        return _value_to_literal(r.rows[0][0])

    def exec_in(sub: A.Subquery) -> tuple:
        r = run_select(sub.select)
        if r.rows and len(r.rows[0]) != 1:
            raise AnalysisError("IN subquery must return one column")
        # NULL elements can never match under IN's equality semantics
        return tuple(_value_to_literal(row[0]) for row in r.rows
                     if row[0] is not None)

    def exec_exists(sub: A.Exists) -> A.Literal:
        import dataclasses
        sel = sub.select
        if isinstance(sel, A.Select) and sel.limit is None and not sel.group_by \
                and sel.having is None and not sel.distinct:
            sel = dataclasses.replace(sel, limit=1)  # LIMIT 1 semantics
        r = run_select(sel)
        return A.Literal(len(r.rows) > 0, "bool")

    def rw(e):
        if e is None:
            return None
        if isinstance(e, A.Exists):
            dec = decorrelate_exists(e, outer_aliases, negated=False)
            if dec is not None:
                return rw(dec)
            return exec_exists(e)
        if isinstance(e, A.Subquery):
            return exec_scalar(e)
        if isinstance(e, A.BinOp):
            return A.BinOp(e.op, rw(e.left), rw(e.right))
        if isinstance(e, A.UnOp):
            if e.op == "not" and isinstance(e.operand, A.Exists):
                dec = decorrelate_exists(e.operand, outer_aliases, negated=True)
                if dec is not None:
                    return rw(dec)
            return A.UnOp(e.op, rw(e.operand))
        if isinstance(e, A.Between):
            return A.Between(rw(e.expr), rw(e.lo), rw(e.hi), e.negated)
        if isinstance(e, A.InList):
            items = []
            for it in e.items:
                if isinstance(it, A.Subquery):
                    items.extend(exec_in(it))
                else:
                    items.append(rw(it))
            return A.InList(rw(e.expr), tuple(items), e.negated)
        if isinstance(e, A.IsNull):
            return A.IsNull(rw(e.expr), e.negated)
        if isinstance(e, A.Cast):
            return A.Cast(rw(e.expr), e.type_name, e.type_args)
        if isinstance(e, A.CaseExpr):
            return A.CaseExpr(tuple((rw(c), rw(v)) for c, v in e.whens),
                              rw(e.else_) if e.else_ is not None else None)
        if isinstance(e, A.FuncCall):
            import dataclasses
            return dataclasses.replace(
                e, args=tuple(rw(a) for a in e.args),
                agg_order=tuple((rw(oe), asc) for oe, asc in e.agg_order),
                filter=rw(e.filter) if e.filter is not None else None)
        return e

    exprs = ([i.expr for i in stmt.items] + [stmt.where, stmt.having]
             + stmt.group_by + [o.expr for o in stmt.order_by])
    if not any(e is not None and has_subquery(e) for e in exprs):
        return stmt

    return A.Select(
        items=[A.SelectItem(rw(i.expr), i.alias) for i in stmt.items],
        from_=stmt.from_,
        where=rw(stmt.where),
        group_by=[rw(g) for g in stmt.group_by],
        having=rw(stmt.having),
        order_by=[A.OrderItem(rw(o.expr), o.ascending, o.nulls_first)
                  for o in stmt.order_by],
        limit=stmt.limit, offset=stmt.offset, distinct=stmt.distinct,
    )
