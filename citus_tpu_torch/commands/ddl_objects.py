"""Catalog-object DDL handlers: CREATE / DROP SEQUENCE and STATISTICS.

Reference: commands/sequence.c and statistics.c dispatched through
DistributeObjectOps (``citus_tpu/commands/ddl_objects.py``).  The port
carries sequences and extended statistics (n-distinct, refreshed by
ANALYZE); the other objects of that file (schemas, views, SQL
functions, types and domains, roles and grants, policies, triggers,
extensions, collations, publications) are not ported yet and raise
UnsupportedFeatureError naming ROADMAP.md A14.
"""

from __future__ import annotations

from citus_tpu_torch.commands.registry import handles
from citus_tpu_torch.errors import CatalogError
from citus_tpu_torch.executor import Result
from citus_tpu_torch.planner import ast as A


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
