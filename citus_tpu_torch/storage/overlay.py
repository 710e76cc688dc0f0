"""Transaction snapshot overlay: read-your-writes for open transactions.

Reference analog: write_state_management.c — a transaction's pending
columnar writes are visible to its own scans before commit.  Here a
multi-statement transaction stages stripes and deletion bitmaps in
per-xid side files (writer.py / deletes.py); while a statement of that
transaction executes, a thread-local overlay makes read paths merge the
transaction's own staged state into what they see.  Other sessions never
observe the overlay (their threads carry no overlay), which is exactly
the staged-files-invisible-until-commit isolation the 2PC flip relies
on.

Only *read* paths consult the overlay (``visible_meta`` /
``visible_deletes``); writer internals keep using the raw loaders so a
commit can never accidentally persist overlay-merged metadata as live.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Optional

_tls = threading.local()


def current_overlay():
    """The OpenTransaction whose staged writes this thread should see,
    or None."""
    return getattr(_tls, "txn", None)


def current_overlay_xid() -> Optional[int]:
    txn = current_overlay()
    return None if txn is None else txn.xid


@contextlib.contextmanager
def transaction_overlay(txn):
    """Make ``txn``'s staged writes visible to reads on this thread for
    the duration (statements execute synchronously, so nested reads —
    FK probes, subquery materialization, cascades — inherit it)."""
    prev = getattr(_tls, "txn", None)
    _tls.txn = txn
    try:
        yield
    finally:
        _tls.txn = prev


def visible_meta(directory: str) -> dict:
    """Shard metadata as this thread should see it: live stripes plus
    the active transaction's staged stripes for this placement."""
    from citus_tpu_torch.storage.writer import _load_meta, _load_staged

    meta = _load_meta(directory)
    xid = current_overlay_xid()
    if xid is None:
        return meta
    staged = _load_staged(directory, xid)
    if not staged["stripes"]:
        return meta
    live_names = {s["file"] for s in meta["stripes"]}
    merged = dict(meta)
    merged["stripes"] = list(meta["stripes"]) + [
        s for s in staged["stripes"] if s["file"] not in live_names]
    merged["row_count"] = meta["row_count"] + sum(
        s["row_count"] for s in staged["stripes"]
        if s["file"] not in live_names)
    return merged


def visible_deletes(directory: str) -> dict:
    """Deletion bitmaps as this thread should see them: live bitmaps
    with the active transaction's staged bitmaps layered on top (staged
    bitmaps are supersets of live for their stripes — stage_deletes
    merges at stage time)."""
    from citus_tpu_torch.storage.deletes import _staged_path, load_deletes
    import json

    live = load_deletes(directory)
    xid = current_overlay_xid()
    if xid is None:
        return live
    p = _staged_path(directory, xid)
    if not os.path.exists(p):
        return live
    with open(p) as fh:
        staged = json.load(fh)
    merged = dict(live)
    merged.update(staged)
    return merged
