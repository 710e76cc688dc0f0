"""Metadata catalog.

Host-resident equivalents of the reference's pg_dist_* catalogs
(src/backend/distributed/metadata/ — pg_dist_partition, pg_dist_shard,
pg_dist_placement, pg_dist_colocation, pg_dist_node) plus the text
dictionaries that make TEXT columns kernel-friendly.
"""

from citus_tpu_torch.catalog.hashing import hash_int64, shard_index_for_hash, shard_hash_ranges
from citus_tpu_torch.catalog.catalog import (
    Catalog, TableMeta, ShardMeta, DistributionMethod, NodeMeta,
)

__all__ = [
    "hash_int64", "shard_index_for_hash", "shard_hash_ranges",
    "Catalog", "TableMeta", "ShardMeta", "DistributionMethod", "NodeMeta",
]
