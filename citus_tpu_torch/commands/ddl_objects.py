"""Catalog-object DDL handlers: CREATE / DROP SEQUENCE.

Reference: commands/sequence.c dispatched through DistributeObjectOps
(``citus_tpu/commands/ddl_objects.py``).  The port carries sequences;
the other objects of that file (schemas, views, SQL functions, types
and domains, roles and grants, policies, triggers, extensions,
collations, publications, statistics) are not ported yet and raise
UnsupportedFeatureError naming ROADMAP.md A14.
"""

from __future__ import annotations

from citus_tpu_torch.commands.registry import handles
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
