"""Shard transfer: move/copy a shard placement between nodes.

Reference: citus_move_shard_placement / TransferShards
(src/backend/distributed/operations/shard_transfer.c:351,472) — the
13-step non-blocking move.  Mapped onto immutable-append stripes and a
single-source-of-truth catalog it becomes:

  1. register the operation (pid + op id) and park every target dir
     ON_FAILURE in the cleaner — a kill at ANY later step leaves
     records the next cleaner pass adopts and resolves against the
     committed catalog (operations/cleaner.py)
  2. bulk snapshot copy of the placement's files — writers keep writing
  3. CDC catch-up loop: re-run the (incremental) copy until the
     replication lag — change records committed after the last pass
     started (cdc.py pending_count) — falls under
     citus.shard_move_catchup_threshold, bounded by
     citus.shard_move_max_catchup_rounds, parked between rounds in the
     shard_move_catchup wait event.  Each pass only ships stripes the
     target doesn't already have (size-verified: a truncated file from
     a killed earlier pass is re-shipped, never trusted), so a round
     costs O(delta) not O(placement)
  4. under the colocation group's EXCLUSIVE write lock: final micro
     catch-up (O(last-delta)), pre-flip ON_SUCCESS records for the
     source dirs, then the 2PC metadata flip
     (transaction/branches.py commit_metadata_flip +
     Catalog.flip_placement) — blocked-write time is the micro
     catch-up + one atomic commit, measured per move into
     shard_move_blocked_write_ms and citus_shard_move_stats()
  5. deferred source drop via the cleaner
     (citus.defer_drop_after_shard_move=false drops inline)

Colocated shards move together, like the reference.  Deletion bitmaps
are snapshotted under the placement's delete lock (they mutate in
place; an uncoordinated copy can tear against a concurrent DELETE) and
published at the target by rename.

Repaired against the reference (ROADMAP.md C26): a copy for another
coordinator is staged outside the placement tree (``_target_dir``), a
remote-hosted source is always pulled from its coordinator and dropped
by RPC, and each target path is claimed from the cleaner before the
copy.  (C27) A remote-hosted source's coordinator holds its own write
lock of the group across the final pull and the flip
(``_source_write_lock``).
"""

from __future__ import annotations

import contextlib
import os
import shutil
import threading
import time

from citus_tpu_torch.catalog import Catalog
from citus_tpu_torch.errors import CatalogError
from citus_tpu_torch.operations.cleaner import (
    ON_SUCCESS, claim_resource, complete_operation,
    mark_operation_phase, record_cleanup, register_operation,
    try_drop_orphaned_resources,
)
from citus_tpu_torch.services.background_jobs import report_progress
from citus_tpu_torch.stats import begin_wait, end_wait
from citus_tpu_torch.storage.deletes import DELETES_FILE
from citus_tpu_torch.storage.writer import SHARD_META

#: ceiling of the between-rounds backoff (doubles from 10 ms)
_BACKOFF_MAX_S = 0.16


class ShardMoveStats:
    """Per-move operational stats ring, the EXPLAIN-able side of the
    non-blocking move (SELECT citus_shard_move_stats()): how many
    catch-up rounds each move ran and — the availability headline — how
    long its writers were actually blocked."""

    def __init__(self, cap: int = 256):
        self._mu = threading.Lock()
        self._cap = cap
        self._rows: list[dict] = []

    def record(self, **row) -> None:
        with self._mu:
            self._rows.append(row)
            if len(self._rows) > self._cap:
                self._rows = self._rows[-self._cap:]

    def rows(self) -> list[dict]:
        with self._mu:
            return list(self._rows)

    def reset(self) -> None:
        with self._mu:
            self._rows = []


MOVE_STATS = ShardMoveStats()


def _counters():
    from citus_tpu_torch.executor.executor import GLOBAL_COUNTERS
    return GLOBAL_COUNTERS


def _snapshot_deletes_file(src: str, dst: str) -> None:
    """Copy the placement's deletion bitmaps without tearing.  The file
    mutates in place (merge-under-flock + rename publish,
    storage/deletes.py), so the snapshot takes the same lock a
    committing DELETE holds, reads the published bytes, and republishes
    them at the target by rename — a reader at the target can never see
    a half-written bitmap."""
    import fcntl
    sp = os.path.join(src, DELETES_FILE)
    dp = os.path.join(dst, DELETES_FILE)
    lock_fd = os.open(os.path.join(src, ".deletes.lock"),
                      os.O_CREAT | os.O_RDWR)
    try:
        fcntl.flock(lock_fd, fcntl.LOCK_SH)
        try:
            with open(sp, "rb") as fh:
                data = fh.read()
        except FileNotFoundError:
            data = None
    finally:
        fcntl.flock(lock_fd, fcntl.LOCK_UN)
        os.close(lock_fd)
    if data is None:
        # deletes cleared at the source (VACUUM) after an earlier pass
        # copied them: the stale target copy must not survive the move
        try:
            os.remove(dp)
        except FileNotFoundError:
            pass
        return
    tmp = dp + ".part"
    with open(tmp, "wb") as fh:
        fh.write(data)
    os.replace(tmp, dp)


def _copy_atomic(src_path: str, dst_path: str) -> None:
    tmp = dst_path + ".part"
    shutil.copy2(src_path, tmp)
    os.replace(tmp, dst_path)


def _copy_placement_files(src: str, dst: str) -> int:
    """One (incremental) copy pass of a local placement; returns stripe
    bytes actually shipped — zero means the pass found nothing new, the
    converged signal of the catch-up loop when no CDC stream exists."""
    from citus_tpu_torch.testing.faults import FAULTS
    FAULTS.hit("shard_move_copy", src)
    os.makedirs(dst, exist_ok=True)
    copied = 0
    # stripes are immutable: copy data files first, the meta file last so
    # a crash mid-copy leaves a readable (possibly shorter) placement
    names = sorted(n for n in os.listdir(src) if n.endswith(".cts"))
    for n in names:
        sp, dp = os.path.join(src, n), os.path.join(dst, n)
        try:
            src_size = os.path.getsize(sp)
        except OSError:
            continue  # vanished under VACUUM; the meta copy decides
        if os.path.exists(dp) and os.path.getsize(dp) == src_size:
            # complete stripe from an earlier pass (size-verified: mere
            # existence could be a truncation left by a killed pass,
            # which silently kept would corrupt the target)
            continue
        _copy_atomic(sp, dp)
        copied += src_size
        # stripes actually shipped count toward the move's byte
        # progress; skipped (already-present) files were booked by
        # the pass that copied them
        report_progress(add_bytes=src_size)
    # deletion bitmaps travel with the placement on every pass (unlike
    # stripes they mutate in place) — snapshotted, not raw-copied
    _snapshot_deletes_file(src, dst)
    _copy_atomic(os.path.join(src, SHARD_META), os.path.join(dst, SHARD_META))
    return copied


def _find_shard(cat: Catalog, shard_id: int):
    for t in cat.tables.values():
        for s in t.shards:
            if s.shard_id == shard_id:
                return t, s
    raise CatalogError(f"shard {shard_id} does not exist")


def _colocated_shards(cat: Catalog, table, shard):
    """Shards that must move together: same colocation group, same index."""
    out = []
    for t in cat.tables.values():
        if t.colocation_id != table.colocation_id or t.colocation_id == 0:
            continue
        if t.is_distributed or t.method == "tenant":
            out.append((t, t.shards[shard.index]))
    return out


def copy_shard_placement(cat: Catalog, shard_id: int, source_node: int,
                         target_node: int) -> None:
    """Add a replica of a shard placement on target_node (reference:
    citus_copy_shard_placement)."""
    table, shard = _find_shard(cat, shard_id)
    if source_node not in shard.placements:
        raise CatalogError(f"shard {shard_id} has no placement on node {source_node}")
    if target_node in shard.placements:
        raise CatalogError(f"shard {shard_id} already placed on node {target_node}")
    if target_node not in cat.nodes:
        raise CatalogError(f"node {target_node} does not exist")
    for t, s in _colocated_shards(cat, table, shard):
        src = cat.shard_dir(t.name, s.shard_id, source_node)
        dst = cat.shard_dir(t.name, s.shard_id, target_node)
        if os.path.isdir(src):
            _copy_placement_files(src, dst)
        s.placements.append(target_node)
        t.version += 1
    cat.commit()


def _stripe_bytes_total(cat: Catalog, group, source_node: int) -> int:
    """Total stripe (.cts) bytes the move will ship, summed across the
    colocation group — the denominator of the move's progress record.
    Remote-hosted sources are sized over the data plane; an unreachable
    source just leaves the total at whatever was countable."""
    total = 0
    remote = cat.is_remote_node(source_node) and cat.remote_data is not None
    for t, s in group:
        src = cat.shard_dir(t.name, s.shard_id, source_node)
        if os.path.isdir(src) and not remote:
            for n in os.listdir(src):
                if n.endswith(".cts"):
                    total += os.path.getsize(os.path.join(src, n))
        elif remote:
            try:
                r = cat.remote_data.call(
                    cat.node_endpoint(source_node), "list_placement",
                    {"table": t.name, "shard_id": s.shard_id,
                     "node": source_node})
                total += sum(int(f["size"]) for f in r.get("files", [])
                             if f["name"].endswith(".cts"))
            # lint: disable=SWL01 -- sizing is advisory; the copy itself surfaces a dead source
            except Exception:
                pass
    return total


def _pull_one(cat: Catalog, t, s, source_node: int, dst: str) -> int:
    """One placement's bulk/catch-up copy pass: shared filesystem when
    the source directory is local, the RPC data plane when the source
    node is hosted by another coordinator (reference: the COPY-protocol
    file pull of executor/transmit.c + worker_shard_copy.c).  Returns
    stripe bytes shipped this pass."""
    if cat.is_remote_node(source_node) and cat.remote_data is not None:
        # the placement itself (the reference copies a directory at its
        # path in our data dir when there is one: the staging copy of an
        # earlier push, which misses the other coordinator's writes since,
        # C26)
        return cat.remote_data.pull_placement(
            t.name, s.shard_id, source_node,
            cat.node_endpoint(source_node), dst)
    src = cat.shard_dir(t.name, s.shard_id, source_node)
    if os.path.isdir(src):
        return _copy_placement_files(src, dst)
    return 0


def _target_dir(cat: Catalog, t, s, target_node: int) -> str:
    """Where a move's copy lands: the placement directory for a node
    this coordinator hosts; for a node another coordinator hosts, a
    staging directory outside the placement tree, pushed from there.
    The reference stages at the remote node's placement path in its own
    data dir, where its readers and its next pull of that shard take the
    stale copy for the placement (ROADMAP.md C26)."""
    if cat.is_remote_node(target_node):
        return os.path.join(cat.data_dir, ".move_staging", t.name,
                            str(s.shard_id), str(target_node))
    return cat.shard_dir(t.name, s.shard_id, target_node)


def _cdc(cat: Catalog):
    from citus_tpu_torch.cdc import ChangeDataCapture
    return ChangeDataCapture(cat.data_dir, enabled=False)


def _cdc_frontier(cat: Catalog, tables) -> dict[str, int]:
    """Per-table newest change lsn at the start of a copy pass: every
    record at or below it is covered by the stripes that pass ships."""
    cdc = _cdc(cat)
    return {name: cdc.last_lsn(name) for name in tables}


def _cdc_lag(cat: Catalog, frontier: dict[str, int]) -> int | None:
    """Replication lag: change records committed after the frontier.
    None when no member table has a change stream (CDC off and no
    publications) — the caller falls back to the bytes-copied proxy."""
    cdc = _cdc(cat)
    total, have_stream = 0, False
    for name, lsn0 in frontier.items():
        if cdc.has_stream(name):
            have_stream = True
            total += cdc.pending_count(name, lsn0)
    return total if have_stream else None


def run_catchup_loop(cat: Catalog, copy_pass, tables, *,
                     settings, fault_context: str = "") -> int:
    """The bounded catch-up loop shared by shard moves and splits.

    ``copy_pass()`` ships one incremental delta to the target(s) and
    returns bytes shipped.  Rounds repeat while the replication lag
    (CDC records committed after the round's copy started; bytes
    shipped when no stream exists) exceeds
    citus.shard_move_catchup_threshold, up to
    citus.shard_move_max_catchup_rounds — then the caller takes the
    write lock and the final micro catch-up is O(whatever is left).
    The mover parks (not the writers) between rounds under the
    shard_move_catchup wait event, backing off 10 ms → 160 ms.
    Returns the number of rounds run (>= 1: the first round doubles as
    the convergence probe after the bulk copy)."""
    from citus_tpu_torch.testing.faults import FAULTS
    threshold = settings.sharding.shard_move_catchup_threshold
    max_rounds = settings.sharding.shard_move_max_catchup_rounds
    rounds = 0
    backoff = 0.01
    while rounds < max_rounds:
        FAULTS.hit("shard_move_catchup", fault_context)
        frontier = _cdc_frontier(cat, tables)
        copied = copy_pass()
        rounds += 1
        _counters().bump("shard_move_catchup_rounds")
        lag = _cdc_lag(cat, frontier)
        if lag is None:
            # no change stream to measure against: converged when a
            # whole pass found nothing new to ship
            if copied == 0:
                break
        elif lag <= threshold:
            break
        if rounds >= max_rounds:
            break  # bounded: stop chasing, let the locked pass finish
        tok = begin_wait("shard_move_catchup")
        try:
            time.sleep(backoff)
        finally:
            end_wait(tok)
        backoff = min(backoff * 2, _BACKOFF_MAX_S)
    return rounds


@contextlib.contextmanager
def _source_write_lock(cat: Catalog, table, source_node: int, settings):
    """The write lock of the colocation group on the coordinator that
    hosts a remote source, taken over the data plane after our own: its
    writers commit to the source placement, and a stripe they add after
    the final pull would be dropped with it.  The reference locks only
    its own data dir (ROADMAP.md C27).  A ``citus_tpu`` peer has no such
    call, and the move goes on without it."""
    if not (cat.is_remote_node(source_node) and cat.remote_data is not None):
        yield
        return
    from citus_tpu_torch.transaction.write_locks import EXCLUSIVE
    ep = cat.node_endpoint(source_node)
    token = cat.remote_data.lock_group(
        ep, table.name, EXCLUSIVE, settings.executor.lock_timeout_s)
    try:
        yield
    finally:
        if token is not None:
            from citus_tpu_torch.net.rpc import RpcError
            try:
                cat.remote_data.unlock_group(ep, token)
            except RpcError:
                pass  # the peer releases the lock when its lease ends


def move_shard_placement(cat: Catalog, shard_id: int, source_node: int,
                         target_node: int, lock_manager=None,
                         settings=None) -> None:
    """Move a shard placement (and its colocated peers) between nodes
    without blocking writers for the data copy (module doc: the
    non-blocking sequence).

    Only the final micro catch-up and the catalog flip run under the
    colocation group's EXCLUSIVE write lock — the same lock every DML
    writer holds while committing — so a stripe can never land on the
    source placement after the final catch-up but before the flip
    (that write would be silently lost when the source is dropped),
    and the blocked-write window is O(last-delta), not O(diff).

    Cross-host: a source placement hosted by another coordinator is
    pulled over the data plane; a remote target is pushed the same way,
    and the source drop becomes a drop_placement RPC.  The catalog flip
    still travels through the metadata authority, so every coordinator
    observes the new placement map."""
    from citus_tpu_torch.observability.trace import clock
    from citus_tpu_torch.testing.faults import FAULTS
    from citus_tpu_torch.transaction.branches import commit_metadata_flip
    from citus_tpu_torch.transaction.write_locks import EXCLUSIVE, group_write_lock
    if settings is None:
        from citus_tpu_torch.config import current_settings
        settings = current_settings()

    table, shard = _find_shard(cat, shard_id)
    if source_node not in shard.placements:
        raise CatalogError(f"shard {shard_id} has no placement on node {source_node}")
    if target_node in shard.placements:
        raise CatalogError(f"shard {shard_id} already placed on node {target_node}")
    if target_node not in cat.nodes:
        raise CatalogError(f"node {target_node} does not exist")
    group = _colocated_shards(cat, table, shard)
    target_remote = cat.is_remote_node(target_node)
    import uuid
    op_id = uuid.uuid4().int & ((1 << 62) - 1)  # collision-free across movers
    # registry row first, THEN the op-gated records: no cleaner pass can
    # see a record without a pid to arbitrate liveness against
    register_operation(cat, op_id, kind="move_shard")
    for t, s in group:
        # claimed even when the directory exists: it is then an old
        # placement or staging copy whose deferred drop is still
        # pending, and that record must not outlive the move (C26)
        claim_resource(cat, _target_dir(cat, t, s, target_node),
                       operation_id=op_id)
    report_progress(phase="copy", bytes_done=0,
                    bytes_total=_stripe_bytes_total(cat, group, source_node))
    t_start = clock()
    bytes_copied = 0
    catchup_rounds = 0
    blocked_ms = 0.0
    try:
        # phase 1: bulk snapshot copy with writers still running
        for t, s in group:
            bytes_copied += _pull_one(
                cat, t, s, source_node,
                _target_dir(cat, t, s, target_node))
        # phase 2: CDC catch-up — drain the replication lag in O(delta)
        # passes while writers still run
        report_progress(phase="catchup")
        mark_operation_phase(cat, op_id, "catchup")
        member_tables = sorted({t.name for t, _ in group})

        def _catchup_pass() -> int:
            shipped = 0
            for t, s in group:
                shipped += _pull_one(
                    cat, t, s, source_node,
                    _target_dir(cat, t, s, target_node))
            return shipped

        catchup_rounds = run_catchup_loop(
            cat, _catchup_pass, member_tables, settings=settings,
            fault_context=f"{table.name}:{shard_id}")
        # phase 3: block writers for the final micro catch-up + flip only
        report_progress(phase="flip")
        with group_write_lock(cat, table, EXCLUSIVE, lock_manager=lock_manager), \
                _source_write_lock(cat, table, source_node, settings):
            t_block = clock()
            FAULTS.hit("shard_move_flip", f"{table.name}:{shard_id}")
            for t, s in group:
                dst = _target_dir(cat, t, s, target_node)
                _pull_one(cat, t, s, source_node, dst)  # final catch-up
                if target_remote and os.path.isdir(dst):
                    # staged locally, now push to the hosting coordinator
                    cat.remote_data.push_placement(
                        dst, t.name, s.shard_id, target_node,
                        cat.node_endpoint(target_node))
            # pre-flip ON_SUCCESS records for the source dirs: written
            # BEFORE the decision so a kill right after the commit still
            # leaves the cleaner everything it needs to finish the drop
            for t, s in group:
                src = cat.shard_dir(t.name, s.shard_id, source_node)
                if os.path.isdir(src):
                    record_cleanup(cat, src, ON_SUCCESS, operation_id=op_id)
                if target_remote:
                    # the staging copy in OUR data dir is not a placement —
                    # the hosting coordinator owns the real one now
                    dst = _target_dir(cat, t, s, target_node)
                    if os.path.isdir(dst):
                        record_cleanup(cat, dst, ON_SUCCESS,
                                       operation_id=op_id)

            def _flip():
                # re-resolve under the lock: the catalog may have been
                # reloaded (MX invalidation) since the move started, and
                # the flip must land on the live objects
                ft, fs = _find_shard(cat, shard_id)
                for gt, gs in _colocated_shards(cat, ft, fs):
                    cat.flip_placement(gt, gs, source_node, target_node)

            commit_metadata_flip(cat, op_id, _flip)
            blocked_ms = (clock() - t_block) * 1000.0
    except BaseException:
        complete_operation(cat, op_id, success=False)  # cleaner drops targets
        raise
    complete_operation(cat, op_id, success=True)
    _counters().bump("shard_move_blocked_write_ms", max(1, int(blocked_ms)))
    MOVE_STATS.record(
        op="move", shard_id=shard_id, source=source_node,
        target=target_node, bytes_copied=bytes_copied,
        catchup_rounds=catchup_rounds,
        blocked_write_ms=round(blocked_ms, 3),
        total_ms=round((clock() - t_start) * 1000.0, 3))
    # phase 4: deferred source drop (RPC for a remote-hosted source);
    # the local dirs were parked ON_SUCCESS pre-flip and are now ALWAYS
    report_progress(phase="cleanup")
    for t, s in group:
        # a remote-hosted source is dropped by RPC always (the reference
        # skips it when a directory sits at its path here: its own
        # staging copy of an earlier push, C26)
        if cat.is_remote_node(source_node) and cat.remote_data is not None:
            try:
                cat.remote_data.drop_placement(
                    cat.node_endpoint(source_node), t.name, s.shard_id,
                    source_node)
            # lint: disable=SWL01 -- deferred cleanup is best-effort; the cleaner duty re-runs it
            except Exception:
                pass  # deferred cleanup is best-effort; cleaner re-runs
        if cat.remote_data is not None:
            cat.remote_data.invalidate_cache(t.name)
    if not settings.sharding.defer_drop_after_shard_move:
        # inline drop requested: run the cleaner pass now instead of
        # leaving the source for the maintenance daemon
        try_drop_orphaned_resources(cat)
