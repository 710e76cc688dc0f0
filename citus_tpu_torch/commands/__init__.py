"""Per-statement command handlers.

Reference: src/backend/distributed/commands/ — the DistributeObjectOps
registry (distribute_object_ops.c:1-2307) maps every parse-tree node
type to its handler set; utility_hook.c dispatches through it.  Here the
same shape: ``registry`` keys AST statement types to handler functions,
``utility`` keys UDF-style admin calls by name.  ``cluster.Cluster``
owns the runtime (catalog, locks, executor wiring) and delegates
statement execution here.  The port carries the handlers of its first
slice: CREATE TABLE, create_distributed_table(), INSERT ... VALUES and
EXPLAIN; everything else raises UnsupportedFeatureError.
"""

from citus_tpu_torch.commands.registry import STATEMENT_HANDLERS, handles  # noqa: F401
