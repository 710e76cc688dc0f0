"""Cluster operations: node management, shard transfer, rebalancing,
deferred cleanup (reference: src/backend/distributed/operations/)."""

from citus_tpu_torch.operations.shard_transfer import (
    MOVE_STATS, move_shard_placement, copy_shard_placement,
)
from citus_tpu_torch.operations.rebalancer import (
    RebalanceMove, get_rebalance_plan, rebalance_table_shards,
)
from citus_tpu_torch.operations.cleaner import (
    record_cleanup, try_drop_orphaned_resources, pending_cleanup,
    register_operation, complete_operation, operations_view,
)

__all__ = [
    "MOVE_STATS", "move_shard_placement", "copy_shard_placement",
    "RebalanceMove", "get_rebalance_plan", "rebalance_table_shards",
    "record_cleanup", "try_drop_orphaned_resources", "pending_cleanup",
    "register_operation", "complete_operation", "operations_view",
]
