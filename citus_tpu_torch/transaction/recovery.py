"""2PC recovery.

Reference: RecoverTwoPhaseCommits
(src/backend/distributed/transaction/transaction_recovery.c) — a
transaction with a log record is rolled forward (COMMIT PREPARED);
prepared transactions without one are rolled back.  Runs at cluster open
and periodically from the maintenance daemon.

Like the reference, recovery never touches transactions that still
belong to an active backend: in-process transactions are excluded via
the log's in-flight set, and other processes' transactions via the
owner-liveness probe on their xid block (manager.py).  Staged files
whose xid has no record and no identifiable live owner are swept only
after a grace period, so a coordinator mid-write is never clobbered.
"""

from __future__ import annotations

import os
import re
import time
from citus_tpu_torch.utils.clock import now as wall_now

from citus_tpu_torch.catalog import Catalog
from citus_tpu_torch.storage.writer import SHARD_META, abort_staged, commit_staged
from citus_tpu_torch.transaction.manager import TransactionLog, TxState

_STAGED_RE = re.compile(re.escape(SHARD_META) + r"\.staged\.(\d+)$")
_STAGED_DEL_RE = re.compile(r"deletes\.json\.staged\.(\d+)$")

#: staged files with no log record and no known owner are swept only
#: once they are at least this old (a foreign coordinator may be
#: between writing them and logging PREPARED)
ORPHAN_GRACE_SECONDS = 300.0


def recover_transactions(cat: Catalog, txlog: TransactionLog,
                         grace_seconds: float = ORPHAN_GRACE_SECONDS,
                         peer_inflight: "Optional[set]" = None,
                         gxid_outcome=None) -> dict:
    """Apply every undecided transaction's outcome; returns counts.

    ``peer_inflight``: xids other coordinators report live over the
    control plane (net/control_plane.py) — spared like local in-flight
    transactions.  This is the RPC generalization of the flock liveness
    probe for deployments where flock can't span hosts.

    ``gxid_outcome(gxid) -> 'commit'|'abort'|None``: resolves a
    cross-host transaction BRANCH (a PREPARED record carrying a gxid)
    against the authority's durable outcome store — the reconciliation
    the reference does between pg_dist_transaction and the workers'
    pg_prepared_xacts (transaction_recovery.c): commit if an outcome
    record exists, abort if the store says so, leave in place while
    undecided/unreachable."""
    from citus_tpu_torch.storage.deletes import abort_staged_deletes, commit_staged_deletes

    peer_inflight = peer_inflight or set()
    blocks = txlog.blocks()
    alive_cache: dict[str, bool] = {}

    def owner_alive(owner: str) -> bool:
        if owner not in alive_cache:
            alive_cache[owner] = txlog.owner_alive(owner)
        return alive_cache[owner]

    def xid_active(xid: int) -> bool:
        """Does this transaction still belong to a live backend?  The
        in-flight probe is live (not a snapshot): begin() registers the
        xid before any staged file can exist, so a check at decision
        time can never miss a writer."""
        if xid in txlog.inflight() or xid in peer_inflight:
            return True
        for lo, hi, owner in blocks:
            if lo <= xid < hi:
                # our own block but not in-flight: the driving operation
                # crashed or released it — recoverable
                return owner != txlog.owner and owner_alive(owner)
        return False

    rolled_forward = rolled_back = 0
    for xid, state, payload in txlog.outstanding():
        if xid_active(xid):
            continue  # a live backend will finish it
        kind = payload.get("kind", "ingest")
        placements = payload.get("placements", [])
        ingest_placements = payload.get("ingest_placements", [])
        if state == TxState.PREPARED and payload.get("gxid"):
            # cross-host branch: its outcome lives at the authority,
            # never presumed from local state alone
            outcome = gxid_outcome(payload["gxid"]) \
                if gxid_outcome is not None else None
            if outcome == "commit":
                state = TxState.COMMITTED
            elif outcome != "abort":
                continue  # undecided/unreachable: keep the branch
        if state == TxState.COMMITTED:
            for d in placements:
                if os.path.isdir(d):
                    if kind in ("delete", "update", "txn"):
                        # "txn" (interactive BEGIN..COMMIT): placements
                        # carry staged deletion bitmaps; staged stripes
                        # ride ingest_placements
                        commit_staged_deletes(d, xid)
                    else:
                        commit_staged(d, xid)
            for d in ingest_placements:
                if os.path.isdir(d):
                    commit_staged(d, xid)
            tables = payload.get("tables") or []
            if payload.get("table"):
                tables = tables + [payload["table"]]
            bumped = False
            for table in tables:
                if cat.has_table(table):
                    cat.table(table).version += 1
                    bumped = True
            if bumped:
                cat.commit()
            rolled_forward += 1
        else:  # PREPARED (coordinator died before commit) or ABORTED
            for d in placements:
                if os.path.isdir(d):
                    if kind in ("delete", "update", "txn"):
                        abort_staged_deletes(d, xid)
                    else:
                        abort_staged(d, xid)
            for d in ingest_placements:
                if os.path.isdir(d):
                    abort_staged(d, xid)
            rolled_back += 1
        txlog.log(xid, TxState.DONE)

    # sweep stranded staged files whose xid never reached PREPARED (the
    # owning coordinator died mid-write; nothing references these
    # stripes).  A file is only swept when its xid has no record, is not
    # in-flight here, and its block's owner is provably dead — or, for
    # xids outside any known block, when the file is old enough.
    known = {xid for xid, _, _ in txlog.outstanding()}
    known |= {rec["xid"] for rec in txlog.records()
              if rec["state"] != TxState.BLOCK}
    now = wall_now()

    def sweepable(xid: int, path: str) -> bool:
        if xid in known or xid in txlog.inflight() or xid in peer_inflight:
            return False
        for lo, hi, owner in blocks:
            if lo <= xid < hi:
                return owner == txlog.owner or not owner_alive(owner)
        try:
            age = now - os.path.getmtime(path)
        except OSError:
            return False
        return age > grace_seconds

    swept = 0
    data_root = os.path.join(cat.data_dir, "data")
    if os.path.isdir(data_root):
        for root, _dirs, files in os.walk(data_root):
            for f in files:
                m = _STAGED_RE.match(f)
                if m and sweepable(int(m.group(1)), os.path.join(root, f)):
                    abort_staged(root, int(m.group(1)))
                    swept += 1
                    continue
                m = _STAGED_DEL_RE.match(f)
                if m and sweepable(int(m.group(1)), os.path.join(root, f)):
                    abort_staged_deletes(root, int(m.group(1)))
                    swept += 1
    txlog.truncate_done()
    return {"rolled_forward": rolled_forward, "rolled_back": rolled_back,
            "swept": swept}
