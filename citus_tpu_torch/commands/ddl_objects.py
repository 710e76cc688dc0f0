"""Catalog-object DDL handlers: schemas, enum types, SQL functions,
roles and grants, policies and row-level security, statement triggers,
text-search configurations, views, sequences, extensions, domains,
collations, publications and statistics.

Reference: the per-object-type handlers under
src/backend/distributed/commands/ (type.c, function.c, role.c, view.c,
sequence.c, extension.c, domain.c, collation.c, publication.c,
statistics.c, policy.c, trigger.c, text_search.c, schema.c) dispatched
through DistributeObjectOps
(``citus_tpu/commands/ddl_objects.py``).  Every object here is catalog
metadata: a view expands into a derived table and an SQL function into
its body when a statement names it (``commands/select_exec.py``), so
their rows come from the kernels that run the expanded statement.
Policies, grants and triggers are enforced by ``commands/rls.py``.
"""

from __future__ import annotations

from citus_tpu_torch.commands.registry import handles
from citus_tpu_torch.errors import AnalysisError, CatalogError
from citus_tpu_torch.executor import Result
from citus_tpu_torch.planner import ast as A
from citus_tpu_torch.planner import parse_sql
from citus_tpu_torch.types import type_from_sql


@handles(A.CreateSchema)
def create_schema(cl, stmt):
    if stmt.if_not_exists and stmt.name in cl.catalog.schemas:
        return Result(columns=[], rows=[])
    cl.catalog.create_schema(stmt.name)
    cl.catalog.commit()
    return Result(columns=[], rows=[])


@handles(A.DropSchema)
def drop_schema(cl, stmt):
    members = cl.catalog.drop_schema(stmt.name, cascade=stmt.cascade)
    for m in members:
        cl.catalog.drop_table(m)
    cl.catalog.commit()
    cl._plan_cache.clear()
    return Result(columns=[], rows=[])


@handles(A.CreateType)
def create_type(cl, stmt):
    if stmt.name in cl.catalog.types:
        raise CatalogError(f'type "{stmt.name}" already exists')
    if not stmt.labels or len(set(stmt.labels)) != len(stmt.labels):
        raise AnalysisError("enum labels must be unique and non-empty")
    cl.catalog.types[stmt.name] = list(stmt.labels)
    cl.catalog.ddl_epoch += 1
    cl.catalog.commit()
    return Result(columns=[], rows=[])


@handles(A.DropType)
def drop_type(cl, stmt):
    if stmt.if_exists and stmt.name not in cl.catalog.types:
        return Result(columns=[], rows=[])
    if stmt.name not in cl.catalog.types:
        raise CatalogError(f'type "{stmt.name}" does not exist')
    users = [k for k, v in cl.catalog.enum_columns.items()
             if v == stmt.name]
    if users:
        raise CatalogError(
            f'cannot drop type "{stmt.name}": used by {users[0]}')
    del cl.catalog.types[stmt.name]
    cl.catalog.tombstone("types", stmt.name)
    cl.catalog.ddl_epoch += 1
    cl.catalog.commit()
    return Result(columns=[], rows=[])


@handles(A.CreateFunction)
def create_function(cl, stmt):
    from citus_tpu_torch.planner.aggregates import AGG_REGISTRY
    from citus_tpu_torch.planner.bind import AGG_FUNCS
    from citus_tpu_torch.planner.parser import Parser
    if stmt.name in AGG_FUNCS or stmt.name in AGG_REGISTRY:
        raise CatalogError(
            f'cannot replace built-in function "{stmt.name}"')
    if stmt.name in cl.catalog.functions and not stmt.or_replace:
        raise CatalogError(f'function "{stmt.name}" already exists')
    if stmt.returns != "trigger" and any(
            t.get("function") == stmt.name
            for t in cl.catalog.triggers.values()):
        raise CatalogError(
            f'cannot replace "{stmt.name}": trigger(s) depend on it '
            "remaining a trigger function")
    # an expression macro validates as an expression; a trigger
    # function (RETURNS trigger) holds a SQL statement body, which
    # commands/rls.py _fire_triggers runs
    entry = {"args": list(stmt.arg_names),
             "arg_types": list(stmt.arg_types),
             "returns": stmt.returns, "body": stmt.body}
    if stmt.returns == "trigger":
        parse_sql(stmt.body)
        entry["kind"] = "statement"
    else:
        Parser(stmt.body).parse_expr()
    cl.catalog.functions[stmt.name] = entry
    cl.catalog.ddl_epoch += 1
    cl.catalog.commit()
    # the inlined body is part of every bound tree that calls it: the
    # cached plans (text-keyed and $n generic ones) are stale now
    cl._plan_cache.clear()
    return Result(columns=[], rows=[])


@handles(A.DropFunction)
def drop_function(cl, stmt):
    if stmt.if_exists and stmt.name not in cl.catalog.functions:
        return Result(columns=[], rows=[])
    if stmt.name not in cl.catalog.functions:
        raise CatalogError(f'function "{stmt.name}" does not exist')
    users = [n for n, t in cl.catalog.triggers.items()
             if t.get("function") == stmt.name]
    if users:
        raise CatalogError(
            f'cannot drop function "{stmt.name}": trigger(s) '
            f'{", ".join(sorted(users))} depend on it')
    del cl.catalog.functions[stmt.name]
    cl.catalog.tombstone("functions", stmt.name)
    cl.catalog.ddl_epoch += 1
    cl.catalog.commit()
    cl._plan_cache.clear()
    return Result(columns=[], rows=[])


@handles(A.CreateRole)
def create_role(cl, stmt):
    if stmt.if_not_exists and stmt.name in cl.catalog.roles:
        return Result(columns=[], rows=[])
    cl.catalog.create_role(stmt.name)
    cl.catalog.commit()
    return Result(columns=[], rows=[])


@handles(A.DropRole)
def drop_role(cl, stmt):
    if stmt.if_exists and stmt.name not in cl.catalog.roles:
        return Result(columns=[], rows=[])
    cl.catalog.drop_role(stmt.name)
    cl.catalog.commit()
    return Result(columns=[], rows=[])


@handles(A.Grant)
def grant(cl, stmt):
    if stmt.revoke:
        cl.catalog.revoke(stmt.table, stmt.role, stmt.privileges)
    else:
        cl.catalog.grant(stmt.table, stmt.role, stmt.privileges)
    cl.catalog.commit()
    return Result(columns=[], rows=[])


@handles(A.CreatePolicy)
def create_policy(cl, stmt):
    cl.catalog.table(stmt.table)  # must exist
    pols = cl.catalog.policies.setdefault(stmt.table, [])
    if any(p["name"] == stmt.name for p in pols):
        raise CatalogError(
            f'policy "{stmt.name}" for table "{stmt.table}" '
            "already exists")
    from citus_tpu_torch.planner.parser import Parser
    for text in (stmt.using_sql, stmt.check_sql):
        if text is not None:
            Parser(text).parse_expr()  # validate
    pols.append({"name": stmt.name, "cmd": stmt.cmd,
                 "roles": list(stmt.roles),
                 "using": stmt.using_sql, "check": stmt.check_sql})
    cl.catalog.commit()
    return Result(columns=[], rows=[])


@handles(A.DropPolicy)
def drop_policy(cl, stmt):
    pols = cl.catalog.policies.get(stmt.table, [])
    kept = [p for p in pols if p["name"] != stmt.name]
    if len(kept) == len(pols):
        if stmt.if_exists:
            return Result(columns=[], rows=[])
        raise CatalogError(
            f'policy "{stmt.name}" for table "{stmt.table}" '
            "does not exist")
    if kept:
        cl.catalog.policies[stmt.table] = kept
    else:
        del cl.catalog.policies[stmt.table]
    # per-policy tombstone: the commit-time merge is per policy
    cl.catalog.tombstone("policies", f"{stmt.table}.{stmt.name}")
    cl.catalog.commit()
    return Result(columns=[], rows=[])


@handles(A.AlterTableRls)
def alter_table_rls(cl, stmt):
    cl.catalog.table(stmt.table)
    if stmt.enable:
        cl.catalog.rls[stmt.table] = True
    elif cl.catalog.rls.pop(stmt.table, None) is not None:
        cl.catalog.tombstone("rls", stmt.table)
    cl.catalog.commit()
    return Result(columns=[], rows=[])


@handles(A.CreateTrigger)
def create_trigger(cl, stmt):
    cl.catalog.table(stmt.table)
    if stmt.name in cl.catalog.triggers:
        raise CatalogError(f'trigger "{stmt.name}" already exists')
    fn = cl.catalog.functions.get(stmt.function)
    if fn is None or fn.get("kind") != "statement":
        raise CatalogError(
            f'"{stmt.function}" is not a trigger function '
            "(CREATE FUNCTION ... RETURNS trigger)")
    cl.catalog.triggers[stmt.name] = {
        "table": stmt.table, "event": stmt.event,
        "function": stmt.function}
    cl.catalog.commit()
    return Result(columns=[], rows=[])


@handles(A.DropTrigger)
def drop_trigger(cl, stmt):
    t = cl.catalog.triggers.get(stmt.name)
    if t is None or t.get("table") != stmt.table:
        if stmt.if_exists:
            return Result(columns=[], rows=[])
        raise CatalogError(
            f'trigger "{stmt.name}" on "{stmt.table}" does not exist')
    del cl.catalog.triggers[stmt.name]
    cl.catalog.tombstone("triggers", stmt.name)
    cl.catalog.commit()
    return Result(columns=[], rows=[])


@handles(A.CreateTsConfig)
def create_ts_config(cl, stmt):
    if stmt.name in cl.catalog.ts_configs:
        raise CatalogError(
            f'text search configuration "{stmt.name}" already exists')
    src = stmt.options.get("copy")
    if src is not None and src not in cl.catalog.ts_configs \
            and src != "simple":
        raise CatalogError(
            f'text search configuration "{src}" does not exist')
    base = (dict(cl.catalog.ts_configs.get(src, {}))
            if src is not None else {})
    base["parser"] = stmt.options.get("parser",
                                      base.get("parser", "default"))
    cl.catalog.ts_configs[stmt.name] = base
    cl.catalog.commit()
    return Result(columns=[], rows=[])


@handles(A.DropTsConfig)
def drop_ts_config(cl, stmt):
    if stmt.name not in cl.catalog.ts_configs:
        if stmt.if_exists:
            return Result(columns=[], rows=[])
        raise CatalogError(
            f'text search configuration "{stmt.name}" does not exist')
    del cl.catalog.ts_configs[stmt.name]
    cl.catalog.tombstone("ts_configs", stmt.name)
    cl.catalog.commit()
    return Result(columns=[], rows=[])


@handles(A.CreateView)
def create_view(cl, stmt):
    import dataclasses

    from citus_tpu_torch.cluster import _from_relations, _limit0
    from citus_tpu_torch.planner.parser import parse_statement
    # validate the body against current metadata (a LIMIT 0 run)
    probe = dataclasses.replace(stmt.select, limit=0) \
        if isinstance(stmt.select, A.Select) else stmt.select
    replacing = stmt.or_replace and stmt.name in cl.catalog.views
    if replacing and stmt.name in _from_relations(stmt.select):
        raise AnalysisError(
            f'view "{stmt.name}" cannot reference itself')
    new_r = cl._execute_stmt(probe)
    if replacing:
        # PostgreSQL: a replace may only ADD columns at the end,
        # keeping existing names AND types
        old_sel = parse_statement(cl.catalog.views[stmt.name])
        old_r = cl._execute_stmt(_limit0(old_sel))
        old_cols = old_r.columns
        if new_r.columns[:len(old_cols)] != old_cols:
            raise AnalysisError(
                "cannot drop, rename, or reorder columns of "
                f'view "{stmt.name}" with CREATE OR REPLACE')
        if old_r.types and new_r.types:
            for i, (ot, nt) in enumerate(zip(old_r.types, new_r.types)):
                if ot is not None and nt is not None \
                        and ot.kind != nt.kind:
                    raise AnalysisError(
                        "cannot change data type of view column "
                        f'"{old_cols[i]}"')
    cl.catalog.create_view(stmt.name, stmt.sql, or_replace=stmt.or_replace)
    cl.catalog.commit()
    cl._plan_cache.clear()
    return Result(columns=[], rows=[])


@handles(A.DropView)
def drop_view(cl, stmt):
    if stmt.if_exists and stmt.name not in cl.catalog.views:
        return Result(columns=[], rows=[])
    cl.catalog.drop_view(stmt.name)
    cl.catalog.commit()
    cl._plan_cache.clear()
    return Result(columns=[], rows=[])


@handles(A.CreateSequence)
def create_sequence(cl, stmt):
    if stmt.if_not_exists and stmt.name in cl.catalog.sequences:
        return Result(columns=[], rows=[])
    cl.catalog.create_sequence(stmt.name, stmt.start, stmt.increment)
    cl.catalog.commit()
    return Result(columns=[], rows=[])


@handles(A.DropSequence)
def drop_sequence(cl, stmt):
    if stmt.if_exists and stmt.name not in cl.catalog.sequences:
        return Result(columns=[], rows=[])
    cl.catalog.drop_sequence(stmt.name)
    cl.catalog.commit()
    return Result(columns=[], rows=[])


@handles(A.CreateExtension)
def create_extension(cl, stmt):
    if stmt.name in cl.catalog.extensions:
        if stmt.if_not_exists:
            return Result(columns=[], rows=[])
        raise CatalogError(f'extension "{stmt.name}" already exists')
    cl.catalog.extensions[stmt.name] = {
        "version": stmt.version or "1.0"}
    cl.catalog.ddl_epoch += 1
    cl.catalog.commit()
    return Result(columns=[], rows=[])


@handles(A.DropExtension)
def drop_extension(cl, stmt):
    return cl._drop_catalog_object("extensions", stmt)


@handles(A.CreateDomain)
def create_domain(cl, stmt):
    from citus_tpu_torch.planner.parser import Parser
    if stmt.name in cl.catalog.domains:
        raise CatalogError(f'domain "{stmt.name}" already exists')
    type_from_sql(stmt.base, stmt.type_args or None)  # must resolve
    if stmt.check_sql is not None:
        Parser(stmt.check_sql).parse_expr()  # validate
    cl.catalog.domains[stmt.name] = {
        "base": stmt.base, "args": list(stmt.type_args or []),
        "not_null": stmt.not_null, "check": stmt.check_sql}
    cl.catalog.ddl_epoch += 1
    cl.catalog.commit()
    return Result(columns=[], rows=[])


@handles(A.DropDomain)
def drop_domain(cl, stmt):
    users = [k for k, v in cl.catalog.domain_columns.items()
             if v == stmt.name]
    if users and stmt.name in cl.catalog.domains:
        raise CatalogError(
            f'cannot drop domain "{stmt.name}": column {users[0]} '
            "depends on it")
    return cl._drop_catalog_object("domains", stmt)


@handles(A.CreateCollation)
def create_collation(cl, stmt):
    if stmt.name in cl.catalog.collations:
        raise CatalogError(f'collation "{stmt.name}" already exists')
    cl.catalog.collations[stmt.name] = dict(stmt.options)
    cl.catalog.ddl_epoch += 1
    cl.catalog.commit()
    return Result(columns=[], rows=[])


@handles(A.DropCollation)
def drop_collation(cl, stmt):
    return cl._drop_catalog_object("collations", stmt)


@handles(A.CreatePublication)
def create_publication(cl, stmt):
    """A publication turns on change capture for its tables
    (``Cluster._cdc_captures`` reads ``catalog.publications``)."""
    if stmt.name in cl.catalog.publications:
        raise CatalogError(
            f'publication "{stmt.name}" already exists')
    if isinstance(stmt.tables, list):
        for tn in stmt.tables:
            cl.catalog.table(tn)  # must exist
    cl.catalog.publications[stmt.name] = {"tables": stmt.tables}
    cl.catalog.ddl_epoch += 1
    cl.catalog.commit()
    return Result(columns=[], rows=[])


@handles(A.DropPublication)
def drop_publication(cl, stmt):
    return cl._drop_catalog_object("publications", stmt)


@handles(A.CreateStatistics)
def create_statistics(cl, stmt):
    if stmt.name in cl.catalog.statistics:
        raise CatalogError(
            f'statistics object "{stmt.name}" already exists')
    t = cl.catalog.table(stmt.table)
    for c in stmt.columns:
        t.schema.column(c)
    # extended statistics: n-distinct over the column combination
    # (reference: CREATE STATISTICS ndistinct; computed eagerly — our
    # ANALYZE analog)
    nd = cl._compute_ndistinct(stmt.table, list(stmt.columns))
    cl.catalog.statistics[stmt.name] = {
        "table": stmt.table, "columns": list(stmt.columns),
        "ndistinct": nd}
    cl.catalog.ddl_epoch += 1
    cl.catalog.commit()
    return Result(columns=[], rows=[])


@handles(A.DropStatistics)
def drop_statistics(cl, stmt):
    return cl._drop_catalog_object("statistics", stmt)
