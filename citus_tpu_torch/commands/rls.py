"""Row-level security, statement triggers and privilege checks.

Reference: commands/policy.c (RLS policies), commands/trigger.c,
commands/grant.c / standard PostgreSQL ACL checks; policies rewrite the
statement tree before planning (the planner-level USING/CHECK injection
PostgreSQL does in the rewriter).  The port of
``citus_tpu/commands/rls.py``.  A policy adds no kernel: a read of an
RLS table becomes a derived table whose WHERE is the policy, which B10
generates into the predicate (B4) or the fold row (B1, B2) of the
sub-statement that materializes it; a modify's policy is ANDed into its
WHERE, which B4 evaluates.  Trigger bodies run as superuser through
``_execute_stmt``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from citus_tpu_torch.cluster import _eval_const, _subst_args
from citus_tpu_torch.errors import (
    AnalysisError, CatalogError, ExecutionError, UnsupportedFeatureError,
)
from citus_tpu_torch.planner import ast as A
from citus_tpu_torch.planner import parse_sql
from citus_tpu_torch.planner.parser import Parser
from citus_tpu_torch.planner.recursive import _walk_columns, _walk_expr


def _policy_predicate(cl, role: str, table: str, cmd: str,
                      kind: str = "using") -> Optional[A.Expr]:
    """RLS predicate for (role, table, command): None when RLS is
    off for the table; FALSE when enabled with no applicable policy
    (default deny); else the OR of applicable policies' expressions
    (permissive policies, PostgreSQL default).  ``kind`` selects
    USING or WITH CHECK (check falls back to using, as PG does)."""
    if not cl.catalog.rls.get(table):
        return None
    texts = []
    for p in cl.catalog.policies.get(table, ()):
        if p["cmd"] not in ("all", cmd):
            continue
        if "public" not in p["roles"] and role not in p["roles"]:
            continue
        text = p.get(kind) or (p.get("using") if kind == "check" else None)
        if text:
            texts.append(text)
    if not texts:
        return A.Literal(False, "bool")
    cache = getattr(cl, "_policy_expr_cache", None)
    if cache is None:
        cache = cl._policy_expr_cache = {}
    exprs = []
    for t in texts:
        parsed = cache.get(t)
        if parsed is None:
            parsed = cache[t] = Parser(t).parse_expr()
        exprs.append(parsed)
    out = exprs[0]
    for e in exprs[1:]:
        out = A.BinOp("or", out, e)
    return out

def _apply_rls(cl, role: str, stmt: A.Statement):
    """Row-level security rewrite for a non-superuser role ->
    (statement, changed).  Every table reference of an RLS-enabled
    table — in FROM (incl. joins/derived tables), set operations,
    CTEs, and expression subqueries (scalar/IN/EXISTS) — wraps in a
    policy-filtered derived table; UPDATE/DELETE additionally AND
    the predicate into WHERE and enforce WITH CHECK on assignments;
    INSERT VALUES rows evaluate WITH CHECK per row (reference:
    commands/policy.c; superuser role=None bypasses, like table
    owners in PG)."""
    changed = [False]
    EMPTY = frozenset()

    def rew_from(item, shadow):
        if isinstance(item, A.TableRef):
            if item.name in shadow:
                return item  # resolves to a CTE, not the base table
            if not cl.catalog.has_table(item.name):
                return item
            f = _policy_predicate(cl, role, item.name, "select")
            if f is None:
                return item
            changed[0] = True
            sel = A.Select([A.SelectItem(A.Star())],
                           A.TableRef(item.name), f)
            return A.SubqueryRef(sel,
                                 item.alias or item.name.split(".")[-1])
        if isinstance(item, A.Join):
            return A.Join(rew_from(item.left, shadow),
                          rew_from(item.right, shadow),
                          item.kind, item.condition)
        if isinstance(item, A.SubqueryRef):
            return A.SubqueryRef(rew_stmt(item.select, shadow),
                                 item.alias)
        return item

    def rew_expr(e, shadow):
        if e is None or not isinstance(e, A.Expr):
            return e
        if isinstance(e, A.Subquery):
            return A.Subquery(rew_stmt(e.select, shadow))
        if isinstance(e, A.Exists):
            return A.Exists(rew_stmt(e.select, shadow))
        if isinstance(e, A.BinOp):
            return A.BinOp(e.op, rew_expr(e.left, shadow),
                           rew_expr(e.right, shadow))
        if isinstance(e, A.UnOp):
            return A.UnOp(e.op, rew_expr(e.operand, shadow))
        if isinstance(e, A.Between):
            return A.Between(rew_expr(e.expr, shadow),
                             rew_expr(e.lo, shadow),
                             rew_expr(e.hi, shadow), e.negated)
        if isinstance(e, A.InList):
            return A.InList(rew_expr(e.expr, shadow),
                            tuple(rew_expr(i, shadow) for i in e.items),
                            e.negated)
        if isinstance(e, A.IsNull):
            return A.IsNull(rew_expr(e.expr, shadow), e.negated)
        if isinstance(e, A.Cast):
            return A.Cast(rew_expr(e.expr, shadow), e.type_name,
                          e.type_args)
        if isinstance(e, A.CaseExpr):
            return A.CaseExpr(
                tuple((rew_expr(c, shadow), rew_expr(v, shadow))
                      for c, v in e.whens),
                rew_expr(e.else_, shadow) if e.else_ is not None
                else None)
        if isinstance(e, A.FuncCall):
            return dataclasses.replace(
                e, args=tuple(rew_expr(a, shadow) for a in e.args),
                agg_order=tuple((rew_expr(oe, shadow), asc)
                                for oe, asc in e.agg_order),
                filter=rew_expr(e.filter, shadow)
                if e.filter is not None else None)
        if isinstance(e, A.WindowCall):
            return A.WindowCall(
                rew_expr(e.func, shadow) if e.func is not None else None,
                tuple(rew_expr(p, shadow) for p in e.partition_by),
                tuple((rew_expr(oe, shadow), asc)
                      for oe, asc in e.order_by),
                e.frame, e.ref_name, e.ref_verbatim)
        return e

    def rew_stmt(s, shadow):
        if isinstance(s, A.SetOp):
            return dataclasses.replace(s, left=rew_stmt(s.left, shadow),
                                       right=rew_stmt(s.right, shadow))
        if isinstance(s, A.WithSelect):
            # a CTE's definition may reference only EARLIER CTE
            # names; later refs resolve to the base relations
            seen = set(shadow)
            new_ctes = []
            for n, sel in s.ctes:
                new_ctes.append((n, rew_stmt(sel, frozenset(seen))))
                seen.add(n)
            return A.WithSelect(new_ctes,
                                rew_stmt(s.body, frozenset(seen)),
                                s.recursive, s.cte_cols)
        if not isinstance(s, A.Select):
            return s
        return dataclasses.replace(
            s,
            items=[A.SelectItem(rew_expr(i.expr, shadow), i.alias)
                   for i in s.items],
            from_=rew_from(s.from_, shadow) if s.from_ is not None
            else None,
            where=rew_expr(s.where, shadow),
            group_by=[rew_expr(g, shadow) for g in s.group_by],
            having=rew_expr(s.having, shadow),
            order_by=[A.OrderItem(rew_expr(o.expr, shadow), o.ascending,
                                  o.nulls_first) for o in s.order_by])

    if isinstance(stmt, (A.Select, A.SetOp, A.WithSelect)):
        new_stmt = rew_stmt(stmt, EMPTY)
        return (new_stmt, True) if changed[0] else (stmt, False)
    if isinstance(stmt, (A.Update, A.Delete)):
        cmd = "update" if isinstance(stmt, A.Update) else "delete"
        f = _policy_predicate(cl, role, stmt.table, cmd)
        # embedded subqueries (WHERE / SET) read through RLS too,
        # regardless of whether the TARGET table has policies
        new_where = rew_expr(stmt.where, EMPTY)
        if isinstance(stmt, A.Update):
            new_assign = [(c, rew_expr(e, EMPTY))
                          for c, e in stmt.assignments]
        if f is None:
            if isinstance(stmt, A.Update):
                return (dataclasses.replace(
                    stmt, assignments=new_assign, where=new_where),
                    changed[0])
            return dataclasses.replace(stmt, where=new_where), changed[0]
        if isinstance(stmt, A.Update):
            _rls_check_update(cl, role, stmt)
        where = f if new_where is None else A.BinOp("and", new_where, f)
        if isinstance(stmt, A.Update):
            return (dataclasses.replace(
                stmt, assignments=new_assign, where=where), True)
        return dataclasses.replace(stmt, where=where), True
    if isinstance(stmt, A.Insert):
        # the SELECT source / row expressions read through RLS
        new_select = (rew_stmt(stmt.select, EMPTY)
                      if stmt.select is not None else None)
        new_rows = ([[rew_expr(v, EMPTY) for v in row]
                     for row in stmt.rows] if stmt.rows else stmt.rows)
        f = _policy_predicate(cl, role, stmt.table, "insert",
                                   kind="check")
        if f is None:
            if changed[0]:
                return dataclasses.replace(
                    stmt, select=new_select, rows=new_rows), True
            return stmt, False
        if stmt.select is not None or not stmt.rows:
            raise UnsupportedFeatureError(
                "INSERT ... SELECT under row-level security is not "
                "supported")
        t = cl.catalog.table(stmt.table)
        cols = stmt.columns or t.schema.names
        for row in stmt.rows:
            subst = {c: v for c, v in zip(cols, row)}
            checked = _subst_args(f, subst)
            try:
                ok = _eval_const(checked)
            except Exception:
                raise UnsupportedFeatureError(
                    "row-level security WITH CHECK over non-constant "
                    "inserts is not supported")
            if ok is not True:
                raise AnalysisError(
                    f'new row violates row-level security policy for '
                    f'table "{stmt.table}"')
        return (dataclasses.replace(stmt, rows=new_rows), True) \
            if changed[0] else (stmt, False)
    return stmt, False

def _rls_check_update(cl, role: str, stmt: A.Update) -> None:
    """WITH CHECK enforcement for UPDATE: the NEW row must satisfy
    the policy (PostgreSQL raises when an update rewrites a row out
    of policy scope).  Assigned-constant columns substitute into the
    check expression; a fully-constant result enforces directly;
    assignments that don't touch any check column are safe when the
    check falls back to USING (the untouched columns already passed
    it); anything else fails closed."""
    eff = _policy_predicate(cl, role, stmt.table, "update",
                                 kind="check")
    if eff is None:
        return
    check_cols = {c.name for c in _walk_columns(eff)
                  if c.table is None}
    assigned = dict(stmt.assignments)
    subst = {}
    for col, val in assigned.items():
        if col in check_cols:
            subst[col] = val
    if subst:
        checked = _subst_args(eff, subst)
        remaining = {c.name for c in _walk_columns(checked)}
        if remaining:
            raise UnsupportedFeatureError(
                "cannot verify row-level security WITH CHECK for this "
                "UPDATE (non-constant or mixed-column assignment)")
        try:
            ok = _eval_const(checked)
        except Exception:
            raise UnsupportedFeatureError(
                "cannot verify row-level security WITH CHECK for this "
                "UPDATE (non-constant assignment)")
        if ok is not True:
            raise AnalysisError(
                "new row violates row-level security policy for "
                f'table "{stmt.table}"')
        return
    # no check column assigned: safe only when check == using (the
    # unchanged columns already satisfied USING via the row filter)
    using = _policy_predicate(cl, role, stmt.table, "update",
                                   kind="using")
    if repr(eff) != repr(using):
        raise UnsupportedFeatureError(
            "cannot verify row-level security WITH CHECK for this "
            "UPDATE (policy has a distinct WITH CHECK expression)")

def _fire_triggers(cl, stmt: A.Statement, depth: int = 0) -> None:
    """Statement-level AFTER triggers: run each matching trigger's
    function body after a DML statement completes (reference:
    commands/trigger.c; bodies are stored SQL statements)."""
    if isinstance(stmt, A.Insert):
        table, event = stmt.table, "insert"
    elif isinstance(stmt, A.Update):
        table, event = stmt.table, "update"
    elif isinstance(stmt, A.Delete):
        table, event = stmt.table, "delete"
    elif isinstance(stmt, A.Merge):
        # MERGE may insert, update, or delete: fire all three
        for evt in ("insert", "update", "delete"):
            _fire_triggers_for(cl, stmt.target.name, evt, depth)
        return
    else:
        return
    _fire_triggers_for(cl, table, event, depth)

def _fire_triggers_for(cl, table: str, event: str, depth: int) -> None:
    matching = [t for t in cl.catalog.triggers.values()
                if t["table"] == table and t["event"] == event]
    if not matching:
        return
    if depth >= 8:
        raise ExecutionError(
            "trigger recursion limit exceeded (8 levels)")
    for trig in matching:
        fn = cl.catalog.functions.get(trig["function"])
        if fn is None:
            continue
        for body_stmt in parse_sql(fn["body"]):
            cl._execute_stmt(body_stmt)
            _fire_triggers(cl, body_stmt, depth + 1)

def _check_privileges(cl, role: str, stmt: A.Statement) -> None:
    """Table-level privilege enforcement for a non-superuser role
    (reference: standard ACLs propagated by commands/grant.c; a
    missing grant denies).  DDL and utility statements require
    superuser (role=None)."""
    if role not in cl.catalog.roles:
        raise CatalogError(f'role "{role}" does not exist')

    def deny(priv, table):
        raise CatalogError(
            f'permission denied for {table}: role "{role}" lacks {priv}')

    def tables_of(item):
        if isinstance(item, A.TableRef):
            return [item.name]
        if isinstance(item, A.SubqueryRef):
            return stmt_tables(item.select)
        if isinstance(item, A.Join):
            return tables_of(item.left) + tables_of(item.right)
        return []

    def expr_subselects(e):
        if e is None or not isinstance(e, A.Expr):
            return []
        return [n.select for n in _walk_expr(e)]

    def stmt_tables(s):
        if isinstance(s, A.SetOp):
            return stmt_tables(s.left) + stmt_tables(s.right)
        if not isinstance(s, A.Select):
            return []
        out = tables_of(s.from_) if s.from_ is not None else []
        # subqueries anywhere in expressions read tables too
        exprs = ([i.expr for i in s.items] + [s.where, s.having]
                 + list(s.group_by) + [o.expr for o in s.order_by])
        for e in exprs:
            for sub in expr_subselects(e):
                out.extend(stmt_tables(sub))
        return out

    def check_read(s, skip=frozenset()):
        for t in stmt_tables(s):
            if t in skip:
                continue  # CTE name, not a real relation
            if not cl.catalog.has_privilege(role, t, "select"):
                deny("SELECT", t)

    if isinstance(stmt, (A.Select, A.SetOp)):
        check_read(stmt)
    elif isinstance(stmt, A.WithSelect):
        # a CTE's definition may reference only EARLIER CTE names —
        # a same-named reference inside its own body resolves to the
        # real relation and must be privilege-checked as one
        seen: set = set()
        for n, sel in stmt.ctes:
            check_read(sel, skip=frozenset(seen))
            seen.add(n)
        check_read(stmt.body, skip=frozenset(seen))
    elif isinstance(stmt, A.Insert):
        if not cl.catalog.has_privilege(role, stmt.table, "insert"):
            deny("INSERT", stmt.table)
        if stmt.on_conflict is not None \
                and stmt.on_conflict.action == "update" \
                and not cl.catalog.has_privilege(role, stmt.table,
                                                   "update"):
            # DO UPDATE modifies existing rows (PostgreSQL requires
            # UPDATE privilege in addition to INSERT)
            deny("UPDATE", stmt.table)
        if stmt.select is not None:
            check_read(stmt.select)
    elif isinstance(stmt, A.Update):
        if not cl.catalog.has_privilege(role, stmt.table, "update"):
            deny("UPDATE", stmt.table)
        for _c, e in stmt.assignments:
            for sub in expr_subselects(e):
                check_read(sub)
        for sub in expr_subselects(stmt.where):
            check_read(sub)
    elif isinstance(stmt, A.Delete):
        if not cl.catalog.has_privilege(role, stmt.table, "delete"):
            deny("DELETE", stmt.table)
        for sub in expr_subselects(stmt.where):
            check_read(sub)
    elif isinstance(stmt, A.Truncate):
        for name in (stmt.table,) + tuple(stmt.more):
            if not cl.catalog.has_privilege(role, name, "truncate"):
                deny("TRUNCATE", name)
    elif isinstance(stmt, (A.Prepare, A.ExecutePrepared, A.Deallocate)):
        # any role may manage prepared statements (PostgreSQL);
        # EXECUTE re-enters execute() with the same role, which
        # checks privileges on the underlying statement
        pass
    else:
        raise CatalogError(f'permission denied: role "{role}" cannot run '
                  f'{type(stmt).__name__} statements')
