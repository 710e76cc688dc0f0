"""DML execution: DELETE / UPDATE / TRUNCATE / VACUUM.

Reference mapping:
- DELETE/UPDATE on distributed tables: the router/multi-shard modify
  path (multi_router_planner.c CreateModifyPlan) — here evaluated
  per shard against the columnar scan, producing deletion bitmaps
  (storage/deletes.py) under 2PC.
- UPDATE = delete + re-insert through the hash-routing ingest, which
  also covers updates that change the distribution column (the
  reference forbids those; we allow them since rows re-route).
- TRUNCATE: metadata flip + deferred file cleanup.

The port of ``citus_tpu/executor/dml.py``: the same per-placement
deletion bitmaps, re-insert and 2PC log, so a data directory written by
either package reads in the other.  Every write bumps the table's
version inside a flip-generation bracket, the two things the device
cache keys on (executor/device_cache.py plan_cache_key), so a warm scan
after a DELETE never replays the old batches.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from citus_tpu_torch.catalog import Catalog, TableMeta
from citus_tpu_torch.errors import UnsupportedFeatureError
from citus_tpu_torch.planner.bound import BExpr, compile_expr, predicate_mask
from citus_tpu_torch.planner.physical import extract_intervals, prune_shards
from citus_tpu_torch.storage import ShardReader, ShardWriter
from citus_tpu_torch.storage.deletes import (
    clear_deletes, commit_staged_deletes, stage_deletes,
)
from citus_tpu_torch.storage.writer import _load_meta
from citus_tpu_torch.transaction.manager import TransactionLog, TxState
from citus_tpu_torch.operations.cleaner import (
    DEFERRED_ON_SUCCESS, record_cleanup,
)


def _placement_dirs(cat: Catalog, table: TableMeta, shard_indexes) -> list[str]:
    out = []
    for si in shard_indexes:
        shard = table.shards[si]
        for node in shard.placements:
            d = cat.shard_dir(table.name, shard.shard_id, node)
            if os.path.isdir(d):
                out.append(d)
    return out


def _matched_rows_per_stripe(cat: Catalog, table: TableMeta, directory: str,
                             where: Optional[BExpr], columns: list[str],
                             row_filter=None):
    """-> {stripe_file: (row_indexes, stripe_rows)}, matched env batches.
    ``row_filter(env, n)`` -> bool [n] replaces ``where`` when given."""
    reader = ShardReader(directory, table.schema)
    intervals = extract_intervals(where) if where is not None else []
    fn = compile_expr(where, np) if where is not None else None
    per_stripe: dict[str, list] = {}
    stripe_rows: dict[str, int] = {s["file"]: 0 for s in reader.meta["stripes"]}
    matched_batches = []
    for s in reader.meta["stripes"]:
        stripe_rows[s["file"]] = s["row_count"]
    from citus_tpu_torch.storage.deletes import deleted_mask
    from citus_tpu_torch.storage.overlay import visible_deletes
    dcache = visible_deletes(directory)
    for batch in reader.scan(columns, intervals, apply_deletes=False):
        env = {c: (batch.values[c],
                   batch.validity[c] if batch.validity[c] is not None else True)
               for c in columns}
        if row_filter is not None:
            mask = np.array(row_filter(env, batch.row_count), bool)
        elif fn is None:
            mask = np.ones(batch.row_count, bool)
        else:
            mask = np.asarray(predicate_mask(np, fn, env, np.ones(batch.row_count, bool)))
            if mask.shape == ():
                mask = np.full(batch.row_count, bool(mask))
        dm = deleted_mask(directory, batch.stripe_file,
                          stripe_rows[batch.stripe_file], dcache)
        if dm is not None:
            mask &= ~dm[batch.chunk_row_offset:batch.chunk_row_offset + batch.row_count]
        idx = np.nonzero(mask)[0]
        if idx.size:
            per_stripe.setdefault(batch.stripe_file, []).append(batch.chunk_row_offset + idx)
            matched_batches.append((batch, mask))
    merged = {sf: (np.concatenate(parts), stripe_rows[sf])
              for sf, parts in per_stripe.items()}
    return merged, matched_batches


def _uuid_assignment(e: BExpr, env: dict, n: int):
    """UPDATE SET <uuid_col> = <expr>: evaluate to (hi, lo, valid) int64
    lane arrays — compile_expr cannot carry the 128-bit literal."""
    from citus_tpu_torch import types as T
    from citus_tpu_torch.planner.bound import BColumn, BLiteral
    if isinstance(e, BLiteral):
        if e.value is None:
            z = np.zeros(n, np.int64)
            return z, z, np.zeros(n, bool)
        hi, lo = T.uuid_int_to_lanes(int(e.value))
        return (np.full(n, hi, np.int64), np.full(n, lo, np.int64),
                np.ones(n, bool))
    if isinstance(e, BColumn) and e.type.kind == T.UUID:
        hv, hm = env[e.name]
        lv, _lm = env[T.uuid_lane_name(e.name)]
        m = np.ones(n, bool) if hm is True else np.asarray(hm)
        return np.asarray(hv), np.asarray(lv), m
    raise UnsupportedFeatureError(
        "UPDATE of a uuid column requires a uuid literal or column")


def execute_delete(cat: Catalog, txlog: TransactionLog, table: TableMeta,
                   where: Optional[BExpr], txn=None) -> int:
    """``txn``: an open interactive transaction (transaction/session.py)
    — stage under its xid and leave the commit to its COMMIT."""
    shard_indexes = prune_shards(table, where)
    columns = _where_columns(table, where)
    xid = txn.xid if txn is not None else txlog.begin()
    try:
        staged_dirs = []
        total = 0
        # stage AND count in one pass: an open transaction's overlay
        # makes staged deletes visible, so a second scan after staging
        # would see the rows as already gone
        for si in shard_indexes:
            shard = table.shards[si]
            primary = shard.placements[0]
            for node in shard.placements:
                d = cat.shard_dir(table.name, shard.shard_id, node)
                if not os.path.isdir(d):
                    continue
                merged, _ = _matched_rows_per_stripe(cat, table, d, where,
                                                     columns)
                if not merged:
                    continue
                if node == primary:
                    # count once per shard (placements are replicas)
                    total += sum(len(ix) for ix, _ in merged.values())
                stage_deletes(d, xid, merged)
                staged_dirs.append(d)
                if txn is not None:
                    # register per-dir as staged, so a mid-statement
                    # failure leaves nothing outside the transaction's
                    # bookkeeping (ROLLBACK [TO SAVEPOINT] must clean it)
                    txn.record_deletes(table.name, [d])
        if txn is not None:
            return total
        if not staged_dirs:
            txlog.release(xid)
            return 0
        # catalog persisted before the commit record (durability ordering:
        # a roll-forward must find every id/version it references on disk)
        table.version += 1
        cat.commit()
        txlog.log(xid, TxState.PREPARED,
                  {"kind": "delete", "table": table.name, "placements": staged_dirs})
        txlog.log(xid, TxState.COMMITTED, {"table": table.name})
        from citus_tpu_torch.transaction.snapshot import flip_generation
        with flip_generation(cat.data_dir, table):
            for d in staged_dirs:
                commit_staged_deletes(d, xid)
        txlog.log(xid, TxState.DONE)
        return total
    except BaseException:
        # stop driving the transaction; recovery decides its outcome
        txlog.release(xid)
        raise


def _where_columns(table: TableMeta, where: Optional[BExpr]) -> list[str]:
    from citus_tpu_torch.planner.bound import referenced_columns
    if where is None:
        # need at least one column to drive the scan
        return [table.schema.columns[0].name]
    cols = referenced_columns(where)
    return cols or [table.schema.columns[0].name]


def execute_update(cat: Catalog, txlog: TransactionLog, table: TableMeta,
                   assignments: list[tuple[str, BExpr]],
                   where: Optional[BExpr], txn=None, check=None) -> int:
    """delete matched rows + re-insert with assignments applied, one 2PC
    (or staged under ``txn``'s xid when inside an open transaction).
    ``check(values, validity)`` validates the replacement batch before
    it is written (domain CHECK enforcement)."""
    shard_indexes = prune_shards(table, where)
    all_columns = table.schema.names
    xid = txn.xid if txn is not None else txlog.begin()
    try:
        return _execute_update_tx(cat, txlog, table, assignments, where,
                                  shard_indexes, all_columns, xid, txn,
                                  check=check)
    except BaseException:
        if txn is None:
            # stop driving the transaction; recovery decides its outcome
            txlog.release(xid)
        raise


def _execute_update_tx(cat, txlog, table, assignments, where,
                       shard_indexes, all_columns, xid, txn=None,
                       check=None) -> int:
    staged_delete_dirs = []
    # scan and rebuild in PHYSICAL column space: a uuid column is two
    # int64 lane streams on disk, and the re-insert writer expects both
    all_columns = table.schema.physical_names(all_columns)
    new_values = {c: [] for c in all_columns}
    new_valid = {c: [] for c in all_columns}
    assign_map = dict(assignments)
    replaced: dict = {}  # {primary_dir: {stripe_file: positions}} for unique probe
    total = 0
    for si in shard_indexes:
        shard = table.shards[si]
        primary = shard.placements[0]
        d = cat.shard_dir(table.name, shard.shard_id, primary)
        if not os.path.isdir(d):
            continue
        merged, matched = _matched_rows_per_stripe(cat, table, d, where, all_columns)
        if not merged:
            continue
        replaced[d] = {sf: set(ix.tolist()) for sf, (ix, _) in merged.items()}
        total += sum(len(ix) for ix, _ in merged.values())
        # stage the deletion on every placement of this shard
        for node in shard.placements:
            pd = cat.shard_dir(table.name, shard.shard_id, node)
            if os.path.isdir(pd):
                m2, _ = _matched_rows_per_stripe(cat, table, pd, where, all_columns)
                if m2:
                    stage_deletes(pd, xid, m2)
                    staged_delete_dirs.append(pd)
                    if txn is not None:
                        # register immediately: a later failure in this
                        # statement must leave nothing unregistered
                        txn.record_deletes(table.name, [pd])
        # build replacement rows
        from citus_tpu_torch import types as T
        assigned_lanes = {
            T.uuid_lane_name(c) for c in assign_map
            if table.schema.column(c).type.kind == T.UUID}
        for batch, mask in matched:
            idx = np.nonzero(mask)[0]
            env = {c: (batch.values[c],
                       batch.validity[c] if batch.validity[c] is not None else True)
                   for c in all_columns}
            for c in all_columns:
                if c in assigned_lanes:
                    continue  # filled alongside its base uuid column
                if c in assign_map and not T.is_uuid_lane(c) \
                        and table.schema.column(c).type.kind == T.UUID:
                    hi, lo, valid = _uuid_assignment(assign_map[c], env,
                                                     batch.row_count)
                    new_values[c].append(hi[idx])
                    new_valid[c].append(valid[idx])
                    lane = T.uuid_lane_name(c)
                    new_values[lane].append(lo[idx])
                    new_valid[lane].append(valid[idx])
                    continue
                if c in assign_map:
                    v, valid = compile_expr(assign_map[c], np)(env)
                    v = np.asarray(v)
                    if v.ndim == 0:
                        v = np.broadcast_to(v, (batch.row_count,))
                    if valid is True:
                        valid = np.ones(batch.row_count, bool)
                    elif valid is False:
                        valid = np.zeros(batch.row_count, bool)
                    new_values[c].append(np.asarray(v)[idx])
                    new_valid[c].append(np.asarray(valid)[idx])
                else:
                    new_values[c].append(batch.values[c][idx])
                    m = batch.validity[c]
                    new_valid[c].append(np.ones(idx.size, bool) if m is None else m[idx])
    if total == 0:
        if txn is None:
            txlog.release(xid)
        return 0
    values = {c: np.concatenate(new_values[c]).astype(table.schema.scan_dtype(c))
              for c in all_columns}
    validity = {c: np.concatenate(new_valid[c]) for c in all_columns}
    if table.unique_indexes:
        from citus_tpu_torch.integrity import check_unique_update
        check_unique_update(cat, table, values, validity,
                            set(assign_map), replaced)
    if check is not None:
        check(values, validity)
    _write_replacement(cat, txlog, table, xid, txn, values, validity,
                       staged_delete_dirs)
    return total


def _write_replacement(cat, txlog, table, xid, txn, values, validity,
                       staged_delete_dirs) -> None:
    """Insert an UPDATE's replacement rows under ``xid`` beside its
    staged deletes: left staged inside an open transaction ``txn``
    (COMMIT flips them), else committed as one 2PC with one flip
    bracket over deletes and re-inserted stripes."""
    from citus_tpu_torch.ingest import TableIngestor
    ing = TableIngestor(cat, table, txlog=None)
    ing.xid = xid  # share the DML transaction
    ing._writers = {}
    if txn is not None:
        # interactive transaction: leave everything staged; COMMIT
        # flips.  Register even on failure so rollback cleans it.
        try:
            ing.append(values, validity)
            for w in ing._writers.values():
                w.flush()
        finally:
            txn.record_ingest(table.name,
                              [w.directory for w in ing._writers.values()])
        return
    ing.append(values, validity)
    for w in ing._writers.values():
        w.flush()
    ingest_dirs = [w.directory for w in ing._writers.values()]
    # catalog persisted before the commit record (durability ordering)
    table.version += 1
    cat.commit()
    txlog.log(xid, TxState.PREPARED,
              {"kind": "update", "table": table.name,
               "placements": staged_delete_dirs, "ingest_placements": ingest_dirs})
    txlog.log(xid, TxState.COMMITTED,
              {"table": table.name, "placements": staged_delete_dirs,
               "ingest_placements": ingest_dirs})
    from citus_tpu_torch.storage.writer import commit_staged
    from citus_tpu_torch.transaction.snapshot import flip_generation
    # one flip bracket over deletes + re-insert stripes: a snapshot read
    # can never observe the deletion without the replacement rows
    with flip_generation(cat.data_dir, table):
        for d in staged_delete_dirs:
            commit_staged_deletes(d, xid)
        for d in ingest_dirs:
            commit_staged(d, xid)
    txlog.log(xid, TxState.DONE)


def execute_replace(cat: Catalog, txlog: TransactionLog, table: TableMeta,
                    row_filter, filter_columns: list[str], values: dict,
                    validity: dict, txn=None) -> int:
    """Delete the rows ``row_filter(env, n)`` selects (over the physical
    ``filter_columns``) and insert the physical batch ``values`` /
    ``validity`` in their place, as ONE transaction: the batched form of
    a run of single-row UPDATEs (the port's ON CONFLICT DO UPDATE, whose
    new rows are computed on the host).  Staged under ``txn`` inside an
    open transaction, else its own 2PC.  -> rows deleted."""
    xid = txn.xid if txn is not None else txlog.begin()
    try:
        staged = []
        total = 0
        for shard in table.shards:
            primary = shard.placements[0]
            for node in shard.placements:
                d = cat.shard_dir(table.name, shard.shard_id, node)
                if not os.path.isdir(d):
                    continue
                merged, _ = _matched_rows_per_stripe(
                    cat, table, d, None, filter_columns, row_filter)
                if not merged:
                    continue
                if node == primary:
                    total += sum(len(ix) for ix, _ in merged.values())
                stage_deletes(d, xid, merged)
                staged.append(d)
                if txn is not None:
                    txn.record_deletes(table.name, [d])
        _write_replacement(cat, txlog, table, xid, txn, values, validity,
                           staged)
        return total
    except BaseException:
        if txn is None:
            # stop driving the transaction; recovery decides its outcome
            txlog.release(xid)
        raise


def execute_truncate(cat: Catalog, table: TableMeta) -> None:
    from citus_tpu_torch.transaction.snapshot import flip_generation
    # flip-generation bracket: a concurrent snapshot read that overlaps
    # these per-shard metadata rewrites detects the generation change
    # and retries — it sees every shard pre-truncate or every shard
    # post-truncate, never a torn mixture, and never waits on us
    with flip_generation(cat.data_dir, table):
        for shard in table.shards:
            for node in shard.placements:
                d = cat.shard_dir(table.name, shard.shard_id, node)
                if not os.path.isdir(d):
                    continue
                meta = _load_meta(d)
                for s in meta["stripes"]:
                    record_cleanup(cat, os.path.join(d, s["file"]),
                                   DEFERRED_ON_SUCCESS)
                from citus_tpu_torch.storage.writer import _store_meta
                _store_meta(d, {"stripes": [], "row_count": 0,
                                "next_stripe_id": meta["next_stripe_id"]})
                clear_deletes(d)
        table.version += 1
    cat.commit()


def execute_vacuum(cat: Catalog, table: TableMeta) -> dict:
    """Rewrite placements without deleted rows; merge small stripes."""
    import shutil
    rewritten = reclaimed = 0
    for shard in table.shards:
        for node in shard.placements:
            d = cat.shard_dir(table.name, shard.shard_id, node)
            if not os.path.isdir(d):
                continue
            reader = ShardReader(d, table.schema)
            from citus_tpu_torch.storage.deletes import load_deletes
            if not load_deletes(d) and len(reader.stripe_files) <= 1:
                continue  # nothing to reclaim or merge
            tmp = d + ".vacuum"
            if os.path.isdir(tmp):
                shutil.rmtree(tmp)
            w = ShardWriter(tmp, table.schema,
                            chunk_row_limit=table.chunk_row_limit,
                            stripe_row_limit=table.stripe_row_limit,
                            codec=table.compression,
                            level=table.compression_level,
                            index_columns=tuple(table.index_columns))
            live = 0
            pnames = table.schema.physical_names()
            for batch in reader.scan(pnames):
                vals = {c: batch.values[c] for c in pnames}
                valid = {c: (batch.validity[c] if batch.validity[c] is not None
                             else np.ones(batch.row_count, bool))
                         for c in pnames}
                w.append_batch(vals, valid)
                live += batch.row_count
            w.flush()
            reclaimed += reader.meta["row_count"] - live
            old = d + ".old"
            if os.path.isdir(old):
                shutil.rmtree(old)
            from citus_tpu_torch.transaction.snapshot import flip_generation
            with flip_generation(cat.data_dir, table):
                # the swap window (placement briefly absent) is inside
                # the flip bracket: an overlapping snapshot read retries
                os.rename(d, old)
                os.rename(tmp, d)
            record_cleanup(cat, old, DEFERRED_ON_SUCCESS)
            rewritten += 1
    table.version += 1
    cat.commit()
    return {"placements_rewritten": rewritten, "rows_reclaimed": reclaimed}
