"""INSERT ... VALUES.

Reference: the INSERT path of commands/multi_copy.c / the router
executor.  The port accepts literal rows (negated numeric literals
included) and routes them through ``Cluster.copy_from``; INSERT ...
SELECT, ON CONFLICT, RETURNING and DEFAULT columns are not ported yet
(ROADMAP.md queue A).
"""

from __future__ import annotations

from citus_tpu_torch.commands.registry import handles
from citus_tpu_torch.errors import UnsupportedFeatureError
from citus_tpu_torch.executor import Result
from citus_tpu_torch.planner import ast as A


@handles(A.Insert)
def execute_insert(cl, stmt: A.Insert) -> Result:
    if stmt.select is not None or stmt.on_conflict is not None \
            or stmt.returning:
        raise UnsupportedFeatureError(
            "INSERT ... SELECT / ON CONFLICT / RETURNING are not ported yet "
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
    n = cl.copy_from(stmt.table, rows=rows, column_names=names)
    return Result(columns=[], rows=[], explain={"inserted": n})
