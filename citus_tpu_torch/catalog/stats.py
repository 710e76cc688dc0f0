"""Table statistics from stripe footers.

The columnar skip list already stores per-chunk min/max (reference:
ColumnChunkSkipNode, src/include/columnar/columnar.h:85-111); aggregating
it per table gives free global column bounds.  The planner uses these to
prove a GROUP BY key domain small enough for the exact direct-gid
aggregation strategy (the TPU analog of choosing a hash-agg vs sort-agg
plan from relation statistics).
"""

from __future__ import annotations

import os
from typing import Optional

from citus_tpu_torch.catalog.catalog import Catalog, TableMeta
from citus_tpu_torch.storage.format import read_stripe_footer
from citus_tpu_torch.storage.writer import _load_meta

# cache key: (data_dir, table, version) — version bumps on every ingest
# and DDL, which is exactly the invalidation we want; data_dir isolates
# distinct clusters in one process
_CACHE: dict[tuple, dict[str, tuple]] = {}


def table_row_count(cat: Catalog, table: TableMeta) -> int:
    total = 0
    for shard in table.shards:
        node = shard.placements[0]
        d = cat.shard_dir(table.name, shard.shard_id, node)
        if os.path.isdir(d):
            total += _load_meta(d)["row_count"]
    return total


def column_bounds(cat: Catalog, table: TableMeta) -> dict[str, tuple]:
    """{column: (min, max, has_nulls)} over all shards (physical values);
    columns with no stats (all-null or empty table) are absent."""
    key = (cat.data_dir, table.name, table.version)
    hit = _CACHE.get(key)
    if hit is not None:
        return hit
    out: dict[str, list] = {}
    nulls: dict[str, bool] = {}
    for shard in table.shards:
        node = shard.placements[0]
        d = cat.shard_dir(table.name, shard.shard_id, node)
        if not os.path.isdir(d):
            continue
        for stripe in _load_meta(d)["stripes"]:
            footer = read_stripe_footer(os.path.join(d, stripe["file"]))
            for col, chunks in footer.columns.items():
                for cs in chunks:
                    nulls[col] = nulls.get(col, False) or cs.has_nulls
                    if cs.minimum is None:
                        continue
                    cur = out.get(col)
                    if cur is None:
                        out[col] = [cs.minimum, cs.maximum]
                    else:
                        cur[0] = min(cur[0], cs.minimum)
                        cur[1] = max(cur[1], cs.maximum)
    result = {col: (v[0], v[1], nulls.get(col, False)) for col, v in out.items()}
    _CACHE[key] = result
    return result


def column_minmax(cat: Catalog, table: TableMeta, column: str) -> Optional[tuple]:
    return column_bounds(cat, table).get(column)
