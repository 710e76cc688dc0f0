"""Shard data -> padded device batches.

The host-side half of the scan: read pruned chunks (decompressed on the
host), concatenate, and pad to a power-of-two row bucket so XLA sees a
small, stable set of shapes (the recompile-pressure discipline the
reference gets from prepared-statement plan caching).  Padding rows carry
``row_mask=False`` and zeroed values.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from citus_tpu_torch.catalog import Catalog, TableMeta
from citus_tpu_torch.planner.physical import PhysicalPlan
from citus_tpu_torch.storage import ShardReader
from citus_tpu_torch.storage.writer import _load_meta
import os


@dataclass
class ShardBatch:
    cols: tuple[np.ndarray, ...]    # device dtypes, padded
    valids: tuple[np.ndarray, ...]
    row_mask: np.ndarray
    n_rows: int                      # real rows
    padded_rows: int
    shard_index: int


def bucket_rows(n: int, min_rows: int) -> int:
    b = max(min_rows, 1)
    while b < n:
        b *= 2
    return b


def _pull_placement_fallback(cat: Catalog, table: TableMeta, shard,
                             node: int) -> Optional[str]:
    """PULL path: mirror a remote placement's files into the local
    cache and scan them here — O(placement bytes) over DCN (reference:
    shard reads over libpq, executor/transmit.c).  This is the
    executor's ONLY sync_placement call site; the preferred PUSH path
    (executor/worker_tasks.py) ships the worker plan to the owning
    coordinator instead and only lands here on fallback, per the
    citus.remote_task_execution policy."""
    return cat.remote_data.sync_placement(
        table.name, shard.shard_id, node, cat.node_endpoint(node))


def load_shard_batches(
    cat: Catalog, plan: PhysicalPlan, shard_index: int, *,
    min_batch_rows: int = 8192, max_batch_rows: int = 1 << 22,
    node_override: Optional[int] = None,
    prefer_secondary: bool = False,
) -> Iterator[tuple[dict[str, np.ndarray], dict[str, np.ndarray], int]]:
    """Yield (values, valids, n_rows) raw column groups of at most
    max_batch_rows rows for one shard placement."""
    table = plan.bound.table
    shard = table.shards[shard_index]
    from citus_tpu_torch.testing.faults import FAULTS
    if node_override is not None:
        nodes = [node_override]
    else:
        # prefer active nodes (citus_disable_node semantics): a disabled
        # node's placement is only read when no active replica exists;
        # with prefer_secondary (citus.use_secondary_nodes='always'),
        # replica placements outrank the primary for reads
        def order(n):
            meta = cat.nodes.get(n)
            inactive = meta is not None and not meta.is_active
            is_primary = n == shard.placements[0]
            return (inactive, is_primary if prefer_secondary else False)
        nodes = sorted(shard.placements, key=order)
    # read tasks fail over to other placements, like the reference's
    # PlacementExecutionDone failover (adaptive_executor.c:96-100).  A
    # MISSING placement directory is a failed placement, not an empty
    # shard — only when no placement exists at all is the shard empty.
    reader = None
    for attempt, node in enumerate(nodes):
        d = cat.shard_dir(table.name, shard.shard_id, node)
        try:
            FAULTS.hit("read_placement", f"{table.name}:{shard.shard_id}:{node}")
            if not os.path.isdir(d) and cat.is_remote_node(node) \
                    and cat.remote_data is not None:
                rd = _pull_placement_fallback(cat, table, shard, node)
                if rd is not None:
                    d = rd
            if not os.path.isdir(d):
                if attempt + 1 < len(nodes):
                    from citus_tpu_torch.executor.executor import GLOBAL_COUNTERS
                    GLOBAL_COUNTERS.bump("connection_failovers")
                    continue
                return  # never written on any placement: empty shard
            from citus_tpu_torch.storage.overlay import visible_meta
            if visible_meta(d)["row_count"] == 0:
                return  # authoritative: the shard is empty
            reader = ShardReader(d, table.schema)
            break
        except Exception:
            if attempt + 1 < len(nodes):
                from citus_tpu_torch.executor.executor import GLOBAL_COUNTERS
                GLOBAL_COUNTERS.bump("connection_failovers")
                continue
            raise
    if reader is None:
        return
    cols = plan.scan_columns
    pend_v: dict[str, list[np.ndarray]] = {c: [] for c in cols}
    pend_m: dict[str, list[np.ndarray]] = {c: [] for c in cols}
    pend_rows = 0
    if plan.index_eq is not None:
        col, value, _name = plan.index_eq
        source = reader.lookup_eq(cols, col, value, plan.intervals)
    else:
        source = reader.scan(cols, plan.intervals)
    # NOTE: under the pipelined executor this generator runs on the
    # host decode thread (executor/pipeline.py HostPrefetcher), so the
    # decode_batch fault point below fires there — delays injected on
    # it model slow host-side decompression overlapping device compute
    for batch in source:
        for c in cols:
            pend_v[c].append(batch.values[c])
            m = batch.validity[c]
            pend_m[c].append(np.ones(batch.row_count, bool) if m is None else m)
        pend_rows += batch.row_count
        if pend_rows >= max_batch_rows:
            FAULTS.hit("decode_batch", f"{table.name}:{shard.shard_id}")
            yield _drain(cols, pend_v, pend_m, pend_rows)
            pend_v = {c: [] for c in cols}
            pend_m = {c: [] for c in cols}
            pend_rows = 0
    if pend_rows:
        FAULTS.hit("decode_batch", f"{table.name}:{shard.shard_id}")
        yield _drain(cols, pend_v, pend_m, pend_rows)


def _drain(cols, pend_v, pend_m, pend_rows):
    values = {c: np.concatenate(pend_v[c]) if len(pend_v[c]) > 1 else pend_v[c][0] for c in cols}
    masks = {c: np.concatenate(pend_m[c]) if len(pend_m[c]) > 1 else pend_m[c][0] for c in cols}
    return values, masks, pend_rows


def pad_to_batch(table: TableMeta, plan: PhysicalPlan, values: dict, masks: dict,
                 n_rows: int, padded_rows: int, shard_index: int) -> ShardBatch:
    cols_out, valids_out = [], []
    for c in plan.scan_columns:
        dt = table.schema.scan_dtype(c, device=True)
        v = values[c].astype(dt, copy=False)
        m = masks[c]
        if padded_rows != n_rows:
            v = np.concatenate([v, np.zeros(padded_rows - n_rows, dt)])
            m = np.concatenate([m, np.ones(padded_rows - n_rows, bool)])
        cols_out.append(v)
        valids_out.append(m)
    row_mask = np.zeros(padded_rows, bool)
    row_mask[:n_rows] = True
    return ShardBatch(tuple(cols_out), tuple(valids_out), row_mask,
                      n_rows, padded_rows, shard_index)


def empty_batch(table: TableMeta, plan: PhysicalPlan, padded_rows: int,
                shard_index: int) -> ShardBatch:
    cols, valids = [], []
    for c in plan.scan_columns:
        dt = table.schema.scan_dtype(c, device=True)
        cols.append(np.zeros(padded_rows, dt))
        valids.append(np.ones(padded_rows, bool))
    return ShardBatch(tuple(cols), tuple(valids), np.zeros(padded_rows, bool),
                      0, padded_rows, shard_index)
