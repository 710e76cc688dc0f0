"""SQL planner stack.

Mirrors the reference's layered planner (src/backend/distributed/planner/,
see planner/README.md there): parse -> analyze/bind -> logical plan ->
worker/combine aggregate split (multi_logical_optimizer.c) -> physical
distributed plan (shard pruning + per-shard task list).  The output is a
DistributedPlan consumed by citus_tpu_torch.executor.
"""

from citus_tpu_torch.planner.parser import parse_sql, parse_statement
from citus_tpu_torch.planner import ast_nodes as ast

__all__ = ["parse_sql", "parse_statement", "ast"]
