"""Table DDL handlers: CREATE TABLE, DROP TABLE.

Reference: commands/table.c dispatched through DistributeObjectOps.
The port creates plain columnar tables; constraints, serial columns,
enum and domain types, foreign keys and partitioning are not ported yet
(ROADMAP.md queue A) and raise UnsupportedFeatureError.
"""

from __future__ import annotations

from citus_tpu_torch.commands.registry import handles
from citus_tpu_torch.errors import CatalogError, UnsupportedFeatureError
from citus_tpu_torch.executor import Result
from citus_tpu_torch.planner import ast as A
from citus_tpu_torch.schema import Column, Schema
from citus_tpu_torch.types import type_from_sql


def _refuse(what: str):
    raise UnsupportedFeatureError(
        f"CREATE TABLE with {what} is not ported yet (ROADMAP.md queue A)")


@handles(A.CreateTable)
def create_table(cl, stmt):
    if stmt.partition_of is not None or stmt.partition_by is not None:
        _refuse("partitioning")
    if stmt.foreign_keys:
        _refuse("foreign keys")
    if stmt.checks:
        _refuse("CHECK constraints")
    cols = []
    for c in stmt.columns:
        if c.primary_key or c.unique:
            _refuse("PRIMARY KEY / UNIQUE")
        if c.default_sql or c.type_name in ("smallserial", "serial",
                                            "bigserial"):
            _refuse("column defaults")
        if c.type_name in cl.catalog.types or c.type_name in cl.catalog.domains:
            _refuse("enum or domain types")
        cols.append(Column(c.name,
                           type_from_sql(c.type_name, c.type_args or None),
                           c.not_null))
    if cl.catalog.has_table(stmt.name):
        if stmt.if_not_exists:
            return Result(columns=[], rows=[])
        raise CatalogError(f'relation "{stmt.name}" already exists')
    opts = {k: v for k, v in stmt.options.items() if k != "access_method"}
    cl.create_table(stmt.name, Schema(cols), **opts)
    return Result(columns=[], rows=[])


@handles(A.DropTable)
def drop_table(cl, stmt):
    cl.drop_table(stmt.name, if_exists=stmt.if_exists)
    return Result(columns=[], rows=[])
