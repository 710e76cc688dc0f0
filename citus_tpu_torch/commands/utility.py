"""UDF-style admin calls (``SELECT create_distributed_table(...)``).

Reference: the UDFs under src/backend/distributed/sql/udfs/.  The port
carries create_distributed_table; the other utilities are not ported
yet (ROADMAP.md queue A).
"""

from __future__ import annotations

from citus_tpu_torch.commands.registry import UTILITY_HANDLERS, utility
from citus_tpu_torch.errors import UnsupportedFeatureError
from citus_tpu_torch.executor import Result


def execute_utility(cl, stmt) -> Result:
    fn = UTILITY_HANDLERS.get(stmt.name)
    if fn is None:
        raise UnsupportedFeatureError(
            f"utility {stmt.name}() is not ported yet (ROADMAP.md queue A)")
    return fn(cl, stmt.name, stmt.args)


@utility("create_distributed_table")
def _create_distributed_table(cl, name, args):
    shard_count = int(args[2]) if len(args) > 2 else None
    cl.create_distributed_table(args[0], args[1], shard_count)
    return Result(columns=[name], rows=[(None,)])
