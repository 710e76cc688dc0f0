"""Deletion bitmaps.

The reference's columnar access method rejects UPDATE/DELETE outright
(columnar_tableam.c: columnar_fetch_row_version errors); row tables get
them from PostgreSQL's heap.  We close that capability gap the
columnar-native way: stripes stay immutable, and each placement keeps a
side file mapping stripe -> packed deletion bitmap.  Scans subtract the
bitmap; VACUUM rewrites stripes to reclaim the space.  Updates are
delete + re-insert (the moved-row case falls out naturally because
re-inserted rows re-hash to their shard).

The side file supports the same staged/2PC protocol as shard metadata.
"""

from __future__ import annotations

import json
import os

import numpy as np

DELETES_FILE = "deletes.json"


def _path(directory: str) -> str:
    return os.path.join(directory, DELETES_FILE)


def _staged_path(directory: str, xid: int) -> str:
    return os.path.join(directory, f"{DELETES_FILE}.staged.{xid}")


def _encode(mask: np.ndarray) -> str:
    return np.packbits(mask.astype(np.uint8)).tobytes().hex()


def _decode(hexstr: str, n_rows: int) -> np.ndarray:
    bits = np.frombuffer(bytes.fromhex(hexstr), np.uint8)
    return np.unpackbits(bits)[:n_rows].astype(bool)


def load_deletes(directory: str) -> dict[str, str]:
    p = _path(directory)
    if not os.path.exists(p):
        return {}
    with open(p) as fh:
        return json.load(fh)


def deleted_mask(directory: str, stripe_file: str, n_rows: int,
                 cache: dict | None = None) -> np.ndarray | None:
    d = cache if cache is not None else load_deletes(directory)
    h = d.get(stripe_file)
    if h is None:
        return None
    return _decode(h, n_rows)


def _store(path: str, d: dict[str, str]) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(d, fh)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def stage_deletes(directory: str, xid: int,
                  per_stripe: dict[str, tuple[np.ndarray, int]]) -> None:
    """Stage row deletions: per_stripe[stripe_file] = (row_indexes, n_rows).
    Merges with the placement's existing live bitmap AND with anything
    this transaction already staged (a multi-statement transaction may
    delete from the same stripe twice)."""
    live = load_deletes(directory)
    p = _staged_path(directory, xid)
    if os.path.exists(p):
        with open(p) as fh:
            staged = json.load(fh)
    else:
        staged = {}
    base = dict(live)
    base.update(staged)  # staged bitmaps are supersets of live
    for stripe_file, (idx, n_rows) in per_stripe.items():
        mask = deleted_mask(directory, stripe_file, n_rows, base)
        if mask is None:
            mask = np.zeros(n_rows, bool)
        mask[idx] = True
        staged[stripe_file] = _encode(mask)
    _store(p, staged)


def commit_staged_deletes(directory: str, xid: int) -> None:
    """Merge staged bitmaps into the live file (idempotent).  Deletion
    bits are monotonic, so the merge is a bitwise OR — concurrent DELETE
    transactions staged against the same base bitmap cannot lose each
    other's bits."""
    import fcntl
    p = _staged_path(directory, xid)
    if not os.path.exists(p):
        return
    with open(p) as fh:
        staged = json.load(fh)
    # serialize the read-modify-write across threads AND processes
    lock_fd = os.open(os.path.join(directory, ".deletes.lock"),
                      os.O_CREAT | os.O_RDWR)
    try:
        fcntl.flock(lock_fd, fcntl.LOCK_EX)
        live = load_deletes(directory)
        for stripe_file, h in staged.items():
            cur = live.get(stripe_file)
            if cur is None:
                live[stripe_file] = h
                continue
            a = np.frombuffer(bytes.fromhex(cur), np.uint8)
            b = np.frombuffer(bytes.fromhex(h), np.uint8)
            if len(a) != len(b):  # defensive: pad the shorter side
                n = max(len(a), len(b))
                a = np.pad(a, (0, n - len(a)))
                b = np.pad(b, (0, n - len(b)))
            live[stripe_file] = (a | b).tobytes().hex()
        _store(_path(directory), live)
        os.remove(p)
    finally:
        fcntl.flock(lock_fd, fcntl.LOCK_UN)
        os.close(lock_fd)


def abort_staged_deletes(directory: str, xid: int) -> None:
    p = _staged_path(directory, xid)
    if os.path.exists(p):
        os.remove(p)


def clear_deletes(directory: str) -> None:
    p = _path(directory)
    if os.path.exists(p):
        os.remove(p)


def deleted_count(directory: str, stripe_rows: dict[str, int]) -> int:
    d = load_deletes(directory)
    total = 0
    for stripe_file, h in d.items():
        n = stripe_rows.get(stripe_file)
        if n is not None:
            total += int(_decode(h, n).sum())
    return total
