"""Shard splitting.

Reference: citus_split_shard_by_split_points / SplitShard
(src/backend/distributed/operations/shard_split.c:441) — a shard's hash
range splits at given points; colocated shards split together; data
redistributes into the new shards; old shards are deferred-dropped.

The split rides the same non-blocking sequence as a shard move
(operations/shard_transfer.py, reference: NonBlockingShardSplit,
shard_split.c:1100): the snapshot redistribute runs with writers live,
then catch-up rounds route only the stripes that appeared since the
last pass (stripes are immutable-append, so new data IS new stripe
files, scanned via ``only_stripes``), and only the final micro
catch-up + catalog flip runs under the colocation group's EXCLUSIVE
write lock.  Deletion bitmaps are the one mutable input: every routed
stripe is read against the bitmap snapshot taken when it was
processed, and a later DELETE against an already-routed stripe marks
the redistribute dirty — rows can't be un-routed, so the pass restarts
from a fresh snapshot (unlocked, bounded by the catch-up round budget)
or redoes the redistribute under the lock as the blocking fallback.
Failure/crash recovery is the move's: operation registry + ON_FAILURE
targets + pre-flip ON_SUCCESS sources, resolved by complete_operation
or adopted by the cleaner against the committed catalog.

A split over a placement another coordinator hosts is refused
(``_guard_remote_hosted``, ROADMAP.md C23): the reference loses its rows.
"""

from __future__ import annotations

import os

import numpy as np

from citus_tpu_torch.catalog import Catalog
from citus_tpu_torch.catalog.hashing import hash_int64
from citus_tpu_torch.errors import CatalogError
from citus_tpu_torch.operations.cleaner import (
    ON_FAILURE, ON_SUCCESS, complete_operation, mark_operation_phase,
    record_cleanup, register_operation, try_drop_orphaned_resources,
)
from citus_tpu_torch.operations.shard_transfer import (
    MOVE_STATS, _colocated_shards, _counters, _find_shard, run_catchup_loop,
)
from citus_tpu_torch.services.background_jobs import report_progress
from citus_tpu_torch.storage import ShardReader, ShardWriter
from citus_tpu_torch.storage.deletes import _decode, load_deletes


def _snapshot_mask(src: str, batch, snapshot: dict[str, str]):
    """Deleted-rows mask for one chunk batch, decoded from the bitmap
    SNAPSHOT recorded when this pass started — not the live file — so
    every stripe is routed against exactly one point-in-time bitmap
    and a racing DELETE can only surface as a dirty restart, never as
    a half-applied mask."""
    h = snapshot.get(batch.stripe_file)
    if h is None:
        return None
    n = batch.chunk_row_offset + batch.row_count
    m = _decode(h, n)
    if m.size < n:  # defensive: bitmap shorter than the stripe grew
        m = np.pad(m, (0, n - m.size))
    return m[batch.chunk_row_offset:]


def _route_pass(cat: Catalog, t, src: str, new_files: list[str],
                snapshot: dict[str, str], bounds, news,
                target_nodes) -> int:
    """Route ``new_files``'s rows of one source placement into the new
    sub-range shards; returns stripe bytes processed.  Writers append
    to the target placements (ShardWriter continues an existing dir),
    so each catch-up round only pays for the delta."""
    reader = ShardReader(src, t.schema)
    writers = {}
    for bi, ns in enumerate(news):
        writers[bi] = ShardWriter(
            cat.shard_dir(t.name, ns.shard_id, target_nodes[bi]),
            t.schema, chunk_row_limit=t.chunk_row_limit,
            stripe_row_limit=t.stripe_row_limit,
            codec=t.compression, level=t.compression_level,
            index_columns=tuple(t.index_columns))
    only = set(new_files)
    pnames = t.schema.physical_names()
    for batch in reader.scan(pnames, apply_deletes=False,
                             only_stripes=only):
        keep = _snapshot_mask(src, batch, snapshot)
        h = hash_int64(batch.values[t.dist_column].astype(np.int64))
        alive = ~keep if keep is not None else None
        for bi, (blo, bhi) in enumerate(bounds):
            sel = (h >= blo) & (h <= bhi)
            if alive is not None:
                sel = sel & alive
            if not sel.any():
                continue
            vals = {c: batch.values[c][sel] for c in pnames}
            valid = {c: (batch.validity[c][sel]
                         if batch.validity[c] is not None
                         else np.ones(int(sel.sum()), bool))
                     for c in pnames}
            writers[bi].append_batch(vals, valid)
    for w in writers.values():
        w.flush()
    bytes_done = sum(os.path.getsize(os.path.join(src, n))
                     for n in new_files
                     if os.path.exists(os.path.join(src, n)))
    report_progress(add_bytes=bytes_done)
    return bytes_done


def _clear_targets(cat: Catalog, plan, target_nodes) -> None:
    """Dirty restart: drop everything routed so far (a DELETE landed on
    an already-routed stripe; its rows can't be un-routed in place)."""
    import shutil
    for t, _s, news in plan:
        for bi, ns in enumerate(news):
            d = cat.shard_dir(t.name, ns.shard_id, target_nodes[bi])
            if os.path.isdir(d):
                shutil.rmtree(d)


def _redistribute_pass(cat: Catalog, plan, bounds, target_nodes,
                       state: dict, *, locked: bool) -> int | str:
    """One incremental redistribute pass over every member table.
    ``state`` maps source dir -> {stripe_file: deletes hex (or None) at
    the time the stripe was routed}.  Returns bytes processed, or the
    sentinel "dirty" when an already-routed stripe's bitmap changed and
    the caller must restart from scratch (unlocked) — under the lock
    the restart happens inline, writers are already excluded."""
    processed = 0
    for t, s, news in plan:
        if t.dist_column is None:
            raise CatalogError(f"table {t.name} has no distribution column")
        for node in s.placements:
            src = cat.shard_dir(t.name, s.shard_id, node)
            if not os.path.isdir(src):
                continue
            seen = state.setdefault(src, {})
            live = load_deletes(src)
            if any(live.get(f) != h for f, h in seen.items()):
                if not locked:
                    return "dirty"
                _clear_targets(cat, plan, target_nodes)
                state.clear()
                return _redistribute_pass(cat, plan, bounds, target_nodes,
                                          state, locked=True)
            stripes = [st["file"] for st in ShardReader(src, t.schema)
                       .meta["stripes"]]
            new_files = [f for f in stripes if f not in seen]
            if new_files:
                processed += _route_pass(cat, t, src, new_files, live,
                                         bounds, news, target_nodes)
                for f in new_files:
                    seen[f] = live.get(f)
            break  # one placement is the source of truth; replicas re-copy later
    return processed


def _guard_remote_hosted(cat: Catalog, group, target_nodes) -> None:
    """Refuse a split that reads or writes a placement another
    coordinator hosts: the redistribute reads and writes local
    placement directories only, so the remote rows would be missing
    from the new shards, as they are from the reference's
    (ROADMAP.md C23).  Move the shard here first."""
    from citus_tpu_torch.errors import UnsupportedFeatureError
    remote = [n for t, s in group for n in s.placements
              if cat.is_remote_node(n)]
    remote += [n for n in target_nodes if cat.is_remote_node(n)]
    if remote:
        raise UnsupportedFeatureError(
            f"a split over node {remote[0]}, which another coordinator "
            "hosts, is not supported: the reference loses its rows "
            "(ROADMAP.md C23)")


def split_shard(cat: Catalog, shard_id: int, split_points: list[int],
                target_nodes: list[int] | None = None,
                lock_manager=None, settings=None) -> list[int]:
    """Split a hash shard at ``split_points`` (inclusive upper bounds of
    the leading sub-ranges).  Returns the new shard ids of the first
    table in the colocation group.  Non-blocking (module doc): writers
    are excluded only for the final micro catch-up + catalog flip."""
    from citus_tpu_torch.observability.trace import clock
    from citus_tpu_torch.testing.faults import FAULTS
    from citus_tpu_torch.transaction.branches import commit_metadata_flip
    from citus_tpu_torch.transaction.snapshot import flip_generation
    from citus_tpu_torch.transaction.write_locks import EXCLUSIVE, group_write_lock
    if settings is None:
        from citus_tpu_torch.config import current_settings
        settings = current_settings()

    table, shard = _find_shard(cat, shard_id)
    if not table.is_distributed:
        raise CatalogError("can only split shards of hash-distributed tables")
    lo, hi = shard.hash_min, shard.hash_max
    points = sorted(set(int(p) for p in split_points))
    for p in points:
        if not (lo <= p < hi):
            raise CatalogError(
                f"split point {p} outside shard range [{lo}, {hi})")
    if not points:
        raise CatalogError("no split points given")
    bounds = []
    cur = lo
    for p in points:
        bounds.append((cur, p))
        cur = p + 1
    bounds.append((cur, hi))
    n_new = len(bounds)
    if target_nodes is None:
        target_nodes = [shard.placements[0]] * n_new
    if len(target_nodes) != n_new:
        raise CatalogError(f"expected {n_new} target nodes")
    for nid in target_nodes:
        if nid not in cat.nodes:
            raise CatalogError(f"node {nid} does not exist")

    group = _colocated_shards(cat, table, shard)
    _guard_remote_hosted(cat, group, target_nodes)
    new_ids_first: list[int] = []
    # allocate new shard ids per table, identical sub-range layout
    plan = []  # (t, old_shard, [new ShardMeta])
    from citus_tpu_torch.catalog.catalog import ShardMeta
    for t, s in group:
        news = []
        for bi, (blo, bhi) in enumerate(bounds):
            news.append(ShardMeta(cat._alloc_shard_id(), 0, blo, bhi,
                                  [target_nodes[bi]]))
        plan.append((t, s, news))
        if t.name == table.name:
            new_ids_first = [n.shard_id for n in news]

    import uuid
    op_id = uuid.uuid4().int & ((1 << 62) - 1)
    register_operation(cat, op_id, kind="split_shard")
    for t, _s, news in plan:
        for bi, ns in enumerate(news):
            d = cat.shard_dir(t.name, ns.shard_id, target_nodes[bi])
            if not os.path.isdir(d):
                record_cleanup(cat, d, ON_FAILURE, operation_id=op_id)

    bytes_total = 0
    for t, s, _news in plan:
        for node in s.placements:
            src = cat.shard_dir(t.name, s.shard_id, node)
            if os.path.isdir(src):
                bytes_total += sum(
                    os.path.getsize(os.path.join(src, n))
                    for n in os.listdir(src) if n.endswith(".cts"))
                break  # mirror the single-source redistribute
    report_progress(phase="copy", bytes_done=0, bytes_total=bytes_total)
    t_start = clock()
    catchup_rounds = 0
    blocked_ms = 0.0
    state: dict = {}  # source dir -> {stripe_file: routed-against bitmap}
    try:
        # phase 1: snapshot redistribute with writers live
        FAULTS.hit("shard_move_copy", f"split:{table.name}:{shard_id}")
        _redistribute_pass(cat, plan, bounds, target_nodes, state,
                           locked=False)
        # phase 2: catch-up rounds — new stripes only; a dirty bitmap
        # restarts the snapshot (still unlocked, still bounded)
        report_progress(phase="catchup")
        mark_operation_phase(cat, op_id, "catchup")
        member_tables = sorted({t.name for t, _ in group})

        def _catchup_pass() -> int:
            r = _redistribute_pass(cat, plan, bounds, target_nodes, state,
                                   locked=False)
            if r == "dirty":
                _clear_targets(cat, plan, target_nodes)
                state.clear()
                r = _redistribute_pass(cat, plan, bounds, target_nodes,
                                       state, locked=False)
            return r if isinstance(r, int) else 1  # dirty again: not converged

        catchup_rounds = run_catchup_loop(
            cat, _catchup_pass, member_tables, settings=settings,
            fault_context=f"split:{table.name}:{shard_id}")
        # phase 3: exclude writers for the final micro catch-up + flip
        report_progress(phase="flip")
        with group_write_lock(cat, table, EXCLUSIVE,
                              lock_manager=lock_manager):
            t_block = clock()
            FAULTS.hit("shard_move_flip", f"split:{table.name}:{shard_id}")
            _redistribute_pass(cat, plan, bounds, target_nodes, state,
                               locked=True)
            # pre-flip ON_SUCCESS records for the old placements: the
            # decision record (the committed flip) then owns their fate
            for t, s, _news in plan:
                for node in s.placements:
                    d = cat.shard_dir(t.name, s.shard_id, node)
                    if os.path.isdir(d):
                        record_cleanup(cat, d, ON_SUCCESS,
                                       operation_id=op_id)

            def _flip():
                for t, s, news in plan:
                    idx = t.shards.index(s)
                    t.shards = t.shards[:idx] + news + t.shards[idx + 1:]
                    for i, sh in enumerate(t.shards):
                        sh.index = i
                    t.version += 1
                cat.ddl_epoch += 1

            # Bracketed in the snapshot flip generation: a reader whose
            # scan overlaps the shard-map swap would otherwise resolve
            # its planned shard indexes against the NEW shard list
            # (torn: half-shards read as whole, the tail shard missed)
            # — the generation bump makes it retry with a re-planned
            # shard set (executor/executor.py).
            with flip_generation(cat.data_dir, table):
                commit_metadata_flip(cat, op_id, _flip)
            blocked_ms = (clock() - t_block) * 1000.0
    except BaseException:
        complete_operation(cat, op_id, success=False)  # cleaner drops targets
        raise
    complete_operation(cat, op_id, success=True)
    _counters().bump("shard_move_blocked_write_ms", max(1, int(blocked_ms)))
    MOVE_STATS.record(
        op="split", shard_id=shard_id, source=shard.placements[0],
        target=-1 if len(set(target_nodes)) > 1 else target_nodes[0],
        bytes_copied=bytes_total, catchup_rounds=catchup_rounds,
        blocked_write_ms=round(blocked_ms, 3),
        total_ms=round((clock() - t_start) * 1000.0, 3))
    # phase 4: deferred drop of the old placements (ON_SUCCESS → ALWAYS)
    report_progress(phase="cleanup")
    if not settings.sharding.defer_drop_after_shard_move:
        try_drop_orphaned_resources(cat)
    return new_ids_first
