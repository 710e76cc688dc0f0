"""run_command_on_shards/_placements and table-DDL reconstruction.

Reference: operations/citus_tools.c (run_command_on_*) and
operations/node_protocol.c (master_get_table_ddl_events).  The port of
``citus_tpu/commands/shard_cmds.py``: each shard's SELECT runs on the
Cluster's device.
"""

from __future__ import annotations

from citus_tpu_torch.errors import AnalysisError, UnsupportedFeatureError
from citus_tpu_torch.executor import Result, execute_select
from citus_tpu_torch.planner import ast as A
from citus_tpu_torch.planner import parse_sql
from citus_tpu_torch.planner.bind import bind_select


def _run_command_on_shards(cl, table_name: str, command: str,
                           per_placement: bool = False) -> Result:
    """reference: citus_tools.c run_command_on_shards/_placements —
    the %s placeholder becomes the shard; here the command is a
    SELECT template executed with the plan restricted to one shard
    (the shard-suffix-name trick has no meaning without SQL-visible
    shard relations)."""
    import dataclasses as _dc

    from citus_tpu_torch.planner.physical import plan_select
    t = cl.catalog.table(table_name)
    sql = command.replace("%s", table_name)
    stmt = parse_sql(sql)[0]
    if not isinstance(stmt, A.Select):
        raise UnsupportedFeatureError(
            "run_command_on_shards supports SELECT commands")
    if not (isinstance(stmt.from_, A.TableRef)
            and stmt.from_.name == t.name):
        raise AnalysisError(
            "run_command_on_shards command must read the named table "
            "(use %s as the relation)")
    bound = bind_select(cl.catalog, stmt)
    plan = plan_select(cl.catalog, bound,
                       direct_limit=cl.settings.planner.direct_gid_limit)
    rows = []
    # one row per shard of the table (reference behavior), even when
    # the command's WHERE clause would prune some shards
    for si in range(len(t.shards)):
        shard = t.shards[si]
        targets = shard.placements if per_placement else [None]
        for node in targets:
            try:
                sp = _dc.replace(plan, shard_indexes=[si])
                r = execute_select(cl.catalog, bound, cl.settings,
                                   plan=sp, device=cl.device, mesh=cl.mesh)
                cell = r.rows[0][0] if r.rows and r.rows[0] else ""
                row = (shard.shard_id, True, str(cell))
            except Exception as exc:
                row = (shard.shard_id, False, str(exc))
            if per_placement:
                row = (row[0], node) + row[1:]
            rows.append(row)
    cols = ["shardid", "nodeid", "success", "result"] if per_placement \
        else ["shardid", "success", "result"]
    return Result(columns=cols, rows=rows)

def _table_ddl(cl, name: str) -> list[str]:
    """Reconstruct the DDL statements that recreate a table
    (reference: master_get_table_ddl_events,
    operations/node_protocol.c)."""
    t = cl.catalog.table(name)
    sql_names = {"bool": "boolean", "int16": "smallint", "int32": "int",
                 "int64": "bigint", "float32": "real",
                 "float64": "double", "date": "date",
                 "timestamp": "timestamp", "text": "text"}
    cols = []
    for c in t.schema:
        enum_t = cl.catalog.enum_columns.get(f"{name}.{c.name}")
        tn = enum_t if enum_t else sql_names.get(c.type.kind, str(c.type))
        if c.type.is_decimal:
            tn = str(c.type)  # decimal(p,s) spells itself
        cols.append(f"{c.name} {tn}"
                    + (" NOT NULL" if c.not_null else ""))
    for fk in t.foreign_keys:
        action = "" if fk["on_delete"] == "restrict" \
            else f" ON DELETE {fk['on_delete'].upper()}"
        cols.append(
            f"FOREIGN KEY ({', '.join(fk['columns'])}) REFERENCES "
            f"{fk['ref_table']} ({', '.join(fk['ref_columns'])})"
            + action)
    out = [f"CREATE TABLE {name} ({', '.join(cols)})"]
    if t.is_distributed:
        out.append(f"SELECT create_distributed_table('{name}', "
                   f"'{t.dist_column}', {t.shard_count})")
    elif t.is_reference:
        out.append(f"SELECT create_reference_table('{name}')")
    return out
