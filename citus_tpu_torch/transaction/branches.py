"""Cross-host transaction branches: the 2PC building blocks.

Reference: PREPARE TRANSACTION / COMMIT PREPARED driven per worker
connection (transaction/remote_transaction.c) + the coordinated
pre-commit (transaction_management.c:319).  A branch = one host's slice
of a cross-host transaction: prepared durably (PREPARED record carrying
the gxid) with its locks held, decided by phase 2 or — when the decide
never arrives — by the authority's first-writer-wins outcome register
(net/control_plane.py; the pg_dist_transaction reconciliation analog).
The port of ``citus_tpu/transaction/branches.py``; its records and the
data-plane payloads that drive it are the reference's, so a
``citus_tpu`` coordinator and a port coordinator commit one transaction
together.
"""

from __future__ import annotations

from citus_tpu_torch.errors import (
    ExecutionError, TransactionError, UnsupportedFeatureError,
)


# ---- cross-host two-phase branches (reference: PREPARE TRANSACTION
# on each worker + COMMIT PREPARED driven by the coordinator,
# transaction/remote_transaction.c) -------------------------------
def prepare_branch(cl, session, gxid: str) -> None:
    """Phase 1 of a cross-host transaction branch: persist the
    catalog version bumps and a durable PREPARED record carrying
    the global transaction id, keeping the staged state and the
    write locks.  The branch survives a crash of this process: its
    PREPARED+gxid record resolves through the authority's outcome
    store at recovery (presumed abort when no outcome exists)."""
    from citus_tpu_torch.transaction.manager import TxState
    txn = session.txn
    if txn.catalog_dirty or txn.on_commit:
        raise UnsupportedFeatureError(
            "DDL cannot ride a cross-host transaction branch")
    for name in sorted(txn.tables):
        if cl.catalog.has_table(name):
            cl.catalog.table(name).version += 1
    cl.catalog._end_staging(txn)
    cl.catalog.commit()
    payload = {"kind": "txn", "gxid": gxid,
               "placements": sorted(txn.delete_dirs),
               "ingest_placements": sorted(txn.ingest_dirs),
               "tables": sorted(txn.tables)}
    cl.txlog.log(txn.xid, TxState.PREPARED, payload)
    txn.branch_payload = payload

def finish_branch(cl, session, commit: bool) -> None:
    """Phase 2: COMMITTED + flip (or abort staged), DONE, release."""
    import contextlib as _ctxlib

    from citus_tpu_torch.storage.deletes import (
        abort_staged_deletes, commit_staged_deletes,
    )
    from citus_tpu_torch.storage.writer import abort_staged, commit_staged
    from citus_tpu_torch.transaction.manager import TxState
    from citus_tpu_torch.transaction.snapshot import flip_generation
    from citus_tpu_torch.transaction.write_locks import group_resource
    txn = session.txn
    payload = getattr(txn, "branch_payload", None) or {}
    try:
        if commit:
            cl.txlog.log(txn.xid, TxState.COMMITTED, payload)
            groups = {}
            for name in payload.get("tables", ()):
                if cl.catalog.has_table(name):
                    t0 = cl.catalog.table(name)
                    groups.setdefault(group_resource(t0), t0)
            with _ctxlib.ExitStack() as _flips:
                for res in sorted(groups):
                    _flips.enter_context(flip_generation(
                        cl.catalog.data_dir, groups[res]))
                for d in payload.get("placements", ()):
                    commit_staged_deletes(d, txn.xid)
                for d in payload.get("ingest_placements", ()):
                    commit_staged(d, txn.xid)
            cl.txlog.log(txn.xid, TxState.DONE)
            cl._plan_cache.clear()
            # this host just flipped new data into placements other
            # coordinators may mirror: expire elision tokens everywhere
            for name in sorted(payload.get("tables", ())):
                cl._publish_data_changed(name)
            if txn.cdc_events:
                clock = cl.clock.transaction_clock()
                for table, op, kw in txn.cdc_events:
                    cl.cdc.emit(table, op, clock, force=True, **kw)
        else:
            for d in payload.get("ingest_placements", ()):
                abort_staged(d, txn.xid)
            for d in payload.get("placements", ()):
                abort_staged_deletes(d, txn.xid)
            cl.txlog.log(txn.xid, TxState.ABORTED, payload)
            cl.txlog.log(txn.xid, TxState.DONE)
            cl._plan_cache.clear()
    finally:
        cl.catalog._end_staging(txn)
        txn.release_locks(cl)
        session.txn = None

def commit_txn_cross_host(cl, session) -> None:
    """COMMIT of a transaction with open remote branches: prepare
    every branch (remote sessions + the local one), record the
    outcome in the authority's first-writer-wins register, decide
    everywhere (reference: the coordinated-transaction pre-commit
    PREPARE on all write connections, transaction_management.c:319)."""
    txn = session.txn
    gxid = txn.gxid
    rd = cl.catalog.remote_data
    local_prepared = False
    try:
        for ep in sorted(txn.remote_endpoints):
            rd.call(ep, "txn_branch_prepare", {"gxid": gxid})
        if txn.has_writes or txn.catalog_dirty or txn.on_commit:
            prepare_branch(cl, session, gxid)
            local_prepared = True
        winner = cl._control.record_txn_outcome(gxid, "commit")
        if winner != "commit":
            raise TransactionError(
                "cross-host transaction aborted by a participant "
                "(branch timed out before the commit decision)")
    except BaseException as exc:
        try:
            winner = cl._control.record_txn_outcome(gxid, "abort")
        except Exception:
            # the abort claim never reached the register (authority
            # unreachable): the outcome is IN DOUBT.  A commit record
            # may have landed unseen (our record_txn_outcome response
            # lost) — sending txn_branch_abort to already-PREPARED
            # branches here could diverge from that committed outcome.
            # Leave every prepared branch to resolve against the
            # register (absent record = presumed abort on expiry); only
            # an un-prepared local txn is unambiguous to roll back.
            if session.txn is not None and not local_prepared:
                try:
                    txn.remote_endpoints = set()  # branches stay put
                    cl._rollback_txn(session)
                # lint: disable=SWL01 -- in-doubt path: TransactionError below surfaces the state; rollback is opportunistic
                except Exception:
                    pass
            elif local_prepared:
                # detach: the prepared local branch outlives the
                # session and resolves with the others
                session.txn = None
            raise TransactionError(
                f"cross-host transaction {gxid} is in doubt: the abort "
                f"decision could not be durably recorded (metadata "
                f"authority unreachable); prepared branches are left "
                f"to resolve against the outcome register") from exc
        if winner == "commit":
            # our own commit record already landed (its RPC response
            # was lost): the transaction IS durably committed —
            # complete the commit instead of diverging
            complete_cross_host_commit(cl, session, txn, gxid,
                                             local_prepared)
            return
        for ep in sorted(txn.remote_endpoints):
            try:
                rd.call(ep, "txn_branch_abort", {"gxid": gxid})
            # lint: disable=SWL01 -- abort already durable; an unreachable branch expires against the register
            except Exception:
                pass
        if session.txn is not None:
            try:
                if local_prepared:
                    finish_branch(cl, session, False)
                else:
                    txn.remote_endpoints = set()  # already aborted
                    cl._rollback_txn(session)
            # lint: disable=SWL01 -- original failure re-raised below; local cleanup failure resolves via recovery
            except Exception:
                pass
        raise
    complete_cross_host_commit(cl, session, txn, gxid,
                                     local_prepared)

def complete_cross_host_commit(cl, session, txn, gxid: str,
                                local_prepared: bool) -> None:
    """Phase 2 after a durably-recorded commit: finish the LOCAL
    branch first (its outcome can never change now; raising before
    it would strand a prepared branch a later ROLLBACK could abort
    against the committed outcome), then decide every remote branch,
    surfacing any divergence AFTER local state is consistent."""
    rd = cl.catalog.remote_data
    if local_prepared:
        finish_branch(cl, session, True)
    else:
        cl.txlog.release(txn.xid)
        cl.catalog._end_staging(txn)
        txn.release_locks(cl)
        session.txn = None
    cl._plan_cache.clear()
    divergence = None
    for ep in sorted(txn.remote_endpoints):
        try:
            r = rd.call(ep, "dml_decide",
                        {"gxid": gxid, "commit": True})
            if not r.get("ok") and r.get("resolved") != "commit":
                divergence = (ep, r.get("resolved"))
        # lint: disable=SWL01 -- commit already durable; an unreachable peer resolves from the outcome store
        except Exception:
            pass  # branch resolves to commit from the outcome store
    if divergence is not None:
        raise ExecutionError(
            f"cross-host branch on {divergence[0]} diverged: "
            f"resolved={divergence[1]!r} after a committed outcome")


# ---- metadata-flip branch (shard moves / splits) -----------------
def commit_metadata_flip(cat, operation_id: int, mutate) -> None:
    """The 2PC shape of a shard move's catalog flip, without a remote
    participant: the operation registry row is the prepared branch, the
    committed catalog document is the outcome register.

    PREPARE — the registry row (operations/cleaner.py) enters the
    ``decide`` phase with the mover's op-gated cleanup records already
    durable: the half-moved target dirs parked ON_FAILURE, the source
    placements parked ON_SUCCESS.  DECIDE — ``mutate()`` retargets the
    placements in memory and ``cat.commit()`` publishes the flip in one
    atomic document swap (cross-host through the metadata authority).
    RESOLVE — a crash anywhere in the window follows presumed abort,
    exactly like an in-doubt branch above: the next cleaner pass adopts
    the dead operation's records and arbitrates each path against the
    committed document — flip landed: targets are live placements
    (kept) and sources are orphans (dropped); flip never landed: the
    reverse.  Either way the cluster keeps serving from whichever side
    the decision record names."""
    from citus_tpu_torch.operations.cleaner import mark_operation_phase
    mark_operation_phase(cat, operation_id, "decide")
    mutate()
    cat.commit()
    mark_operation_phase(cat, operation_id, "decided")
