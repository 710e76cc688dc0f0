"""Table redistribution: undistribute_table / alter_distributed_table.

Reference: src/backend/distributed/commands/alter_table.c —
alter_distributed_table (change shard count / distribution column /
colocation) and undistribute_table both work by creating a new table,
moving the data, and swapping names under locks.  Here the swap is a
catalog update: read every live row, rewrite the shard layout, re-ingest
(hash routing handles the new layout), then defer-clean the old files.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from citus_tpu_torch.catalog import Catalog, DistributionMethod
from citus_tpu_torch.errors import CatalogError
from citus_tpu_torch.operations.cleaner import DEFERRED_ON_SUCCESS, record_cleanup
from citus_tpu_torch.storage import ShardReader


def _collect_all_rows(cat: Catalog, table) -> tuple[dict, dict, int]:
    """Read every live row of a table into column arrays (PHYSICAL
    column space: uuid columns carry their lane stream alongside)."""
    names = table.schema.physical_names()
    vals = {c: [] for c in names}
    valid = {c: [] for c in names}
    total = 0
    for shard in table.shards:
        d = cat.shard_dir(table.name, shard.shard_id, shard.placements[0])
        if not os.path.isdir(d):
            continue
        reader = ShardReader(d, table.schema)
        for batch in reader.scan(names):
            for c in names:
                vals[c].append(batch.values[c])
                m = batch.validity[c]
                valid[c].append(np.ones(batch.row_count, bool) if m is None else m)
            total += batch.row_count
    out_v = {c: (np.concatenate(v) if v else
                 np.zeros(0, table.schema.scan_dtype(c)))
             for c, v in vals.items()}
    out_m = {c: (np.concatenate(m) if m else np.zeros(0, bool))
             for c, m in valid.items()}
    return out_v, out_m, total


def _record_old_placements(cat: Catalog, table) -> None:
    for shard in table.shards:
        for node in shard.placements:
            d = cat.shard_dir(table.name, shard.shard_id, node)
            if os.path.isdir(d):
                record_cleanup(cat, d, DEFERRED_ON_SUCCESS)


def _reingest(cat: Catalog, table, values, validity, txlog) -> None:
    from citus_tpu_torch.ingest import TableIngestor
    if len(next(iter(values.values()), [])) == 0:
        return
    ing = TableIngestor(cat, table, txlog=txlog)
    ing.append(values, validity)
    ing.finish()


def undistribute_table(cat: Catalog, name: str, txlog=None) -> None:
    t = cat.table(name)
    if t.method == DistributionMethod.LOCAL:
        raise CatalogError(f'table "{name}" is not distributed')
    values, validity, _ = _collect_all_rows(cat, t)
    import contextlib as _ctxlib

    from citus_tpu_torch.transaction.snapshot import flip_generation
    from citus_tpu_torch.transaction.write_locks import group_resource
    # the whole shard-map swap + re-ingest is one flip to readers: a
    # scan overlapping it retries (and re-plans on the shard-count
    # change) instead of seeing empty new shards (executor/executor.py).
    # The swap changes the colocation group, so hold BOTH identities.
    with _ctxlib.ExitStack() as _flips:
        _flips.enter_context(flip_generation(cat.data_dir, t))
        old_res = group_resource(t)
        # post-swap identity is knowable upfront (local => colocation 0):
        # register its flip BEFORE the mutation is reader-visible, or a
        # reader binding mid-swap validates a quiet new group and scans
        # the still-empty local shard as a consistent image
        from types import SimpleNamespace
        new_ident = SimpleNamespace(name=name, colocation_id=0)
        if group_resource(new_ident) != old_res:
            _flips.enter_context(flip_generation(cat.data_dir, new_ident))
        _record_old_placements(cat, t)
        from citus_tpu_torch.catalog.catalog import ShardMeta
        t.method = DistributionMethod.LOCAL
        t.dist_column = None
        t.colocation_id = 0
        t.shards = [ShardMeta(cat._alloc_shard_id(), 0, placements=[0])]
        t.version += 1
        cat.ddl_epoch += 1
        cat.commit()
        _reingest(cat, t, values, validity, txlog)


def alter_distributed_table(cat: Catalog, name: str, *,
                            shard_count: Optional[int] = None,
                            distribution_column: Optional[str] = None,
                            colocate_with: Optional[str] = None,
                            txlog=None) -> None:
    t = cat.table(name)
    if not t.is_distributed:
        raise CatalogError(f'table "{name}" is not distributed')
    new_count = shard_count or t.shard_count
    new_col = distribution_column or t.dist_column
    values, validity, _ = _collect_all_rows(cat, t)
    import contextlib as _ctxlib

    from citus_tpu_torch.transaction.snapshot import flip_generation
    from citus_tpu_torch.transaction.write_locks import group_resource
    # the swap CHANGES the table's colocation group, so readers may
    # validate against either identity: hold the flip bracket on BOTH
    # (old group entered first, new group entered as soon as it exists)
    # for the whole swap + re-ingest window
    with _ctxlib.ExitStack() as _flips:
        _flips.enter_context(flip_generation(cat.data_dir, t))
        old_res = group_resource(t)
        # register the flip on the POST-swap identity BEFORE mutating:
        # the shared TableMeta is reader-visible the instant
        # distribute_table assigns the new shard list, and a reader
        # binding in that window validates against the NEW colocation
        # group — it must already see a writer mid-flip there, or it
        # reads the not-yet-reingested (empty) shards as a clean scan
        from types import SimpleNamespace
        new_id = cat.resolve_colocation_id(name, new_col, new_count,
                                           colocate_with)
        new_ident = SimpleNamespace(name=name, colocation_id=new_id)
        if group_resource(new_ident) != old_res:
            _flips.enter_context(flip_generation(cat.data_dir, new_ident))
        _record_old_placements(cat, t)
        cat.distribute_table(name, new_col, new_count,
                             cat.active_node_ids(),
                             colocate_with=colocate_with,
                             colocation_id=new_id)
        t.version += 1
        cat.commit()
        _reingest(cat, t, values, validity, txlog)
