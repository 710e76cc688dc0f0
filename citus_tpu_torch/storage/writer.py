"""Shard writer: buffers column batches into chunk groups and stripes.

Reference analog: ColumnarBeginWrite/ColumnarWriteRow/FlushStripe
(src/backend/columnar/columnar_writer.c:97,169,392) and the write-state
management that makes a transaction's pending writes visible to its own
scans (src/backend/columnar/write_state_management.c).  Here ingest is
batch-columnar from the start (the distributed COPY path hands us column
arrays), so the writer never sees single rows.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from citus_tpu_torch.errors import StorageError
from citus_tpu_torch.schema import Schema
from citus_tpu_torch.storage.format import write_stripe_file

SHARD_META = "shard_meta.json"


class _meta_flock:
    """Serializes shard-metadata read-modify-write across threads and
    processes (two coordinators may ingest into one placement)."""

    def __init__(self, directory: str):
        self._path = os.path.join(directory, ".meta.lock")
        self._fd = None

    def __enter__(self):
        import fcntl
        self._fd = os.open(self._path, os.O_CREAT | os.O_RDWR)
        fcntl.flock(self._fd, fcntl.LOCK_EX)
        return self

    def __exit__(self, *exc):
        import fcntl
        fcntl.flock(self._fd, fcntl.LOCK_UN)
        os.close(self._fd)
        return False


def _load_meta(directory: str) -> dict:
    p = os.path.join(directory, SHARD_META)
    if not os.path.exists(p):
        return {"stripes": [], "row_count": 0, "next_stripe_id": 1}
    with open(p) as fh:
        return json.load(fh)


def _store_meta(directory: str, meta: dict) -> None:
    p = os.path.join(directory, SHARD_META)
    tmp = p + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(meta, fh)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, p)


# ---- staged (two-phase) metadata ---------------------------------------
# A transactional write appends stripes as usual but records them in a
# per-transaction side file; only commit_staged makes them visible by
# merging into the live metadata (reference analog: the write-visibility
# StripeWriteState machine, columnar.h:190-207, where a stripe exists on
# disk before its catalog row commits).

def _staged_path(directory: str, xid: int) -> str:
    return os.path.join(directory, f"{SHARD_META}.staged.{xid}")


def _load_staged(directory: str, xid: int) -> dict:
    p = _staged_path(directory, xid)
    if not os.path.exists(p):
        return {"stripes": [], "row_count": 0}
    with open(p) as fh:
        return json.load(fh)


def _store_staged(directory: str, xid: int, staged: dict) -> None:
    p = _staged_path(directory, xid)
    tmp = p + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(staged, fh)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, p)


def commit_staged(directory: str, xid: int) -> None:
    """Merge a transaction's staged stripes into the live metadata.
    Idempotent: safe to re-run during 2PC roll-forward."""
    staged = _load_staged(directory, xid)
    p = _staged_path(directory, xid)
    if not staged["stripes"]:
        if os.path.exists(p):
            os.remove(p)
        return
    with _meta_flock(directory):
        meta = _load_meta(directory)
        live_names = {s["file"] for s in meta["stripes"]}
        for s in staged["stripes"]:
            if s["file"] in live_names:
                continue  # already applied
            meta["stripes"].append(s)
            meta["row_count"] += s["row_count"]
            sid = int(s["file"].split("-")[1].split(".")[0])
            meta["next_stripe_id"] = max(meta["next_stripe_id"], sid + 1)
        _store_meta(directory, meta)
    os.remove(p)


def abort_staged(directory: str, xid: int) -> None:
    """Delete a transaction's staged stripes + side file (rollback)."""
    staged = _load_staged(directory, xid)
    if staged["stripes"]:
        listing = os.listdir(directory)
    for s in staged["stripes"]:
        fp = os.path.join(directory, s["file"])
        if os.path.exists(fp):
            os.remove(fp)
        # index segments travel with their stripe file
        for f in listing:
            if f.startswith(s["file"] + ".idx."):
                try:
                    os.remove(os.path.join(directory, f))
                except OSError:
                    pass
    p = _staged_path(directory, xid)
    if os.path.exists(p):
        os.remove(p)


class ShardWriter:
    """Append-only writer for one shard of one table."""

    def __init__(self, directory: str, schema: Schema, *, chunk_row_limit: int,
                 stripe_row_limit: int, codec: str = "zstd", level: int = 3,
                 staged_xid: int | None = None,
                 index_columns: tuple[str, ...] = ()):
        if stripe_row_limit % chunk_row_limit != 0:
            raise StorageError("stripe_row_limit must be a multiple of chunk_row_limit")
        self.directory = directory
        self.schema = schema
        self.chunk_row_limit = chunk_row_limit
        self.stripe_row_limit = stripe_row_limit
        self.codec = codec
        self.level = level
        self.staged_xid = staged_xid
        # columns with a secondary index: each flushed stripe also gets a
        # sorted value->offset segment per indexed column
        self.index_columns = tuple(index_columns)
        os.makedirs(directory, exist_ok=True)
        # sketch columns store dictionary ids whose order says nothing
        # about the state they name — never write min/max skip stats
        from citus_tpu_torch.types import SKETCH
        self._no_stats_columns = frozenset(
            c.storage_name for c in schema if c.type.kind == SKETCH)
        # physical stream names: schema columns plus the int64 lane
        # companion each uuid column carries ("<name>::lo")
        self._names = schema.physical_names()
        self._buf: dict[str, list[np.ndarray]] = {n: [] for n in self._names}
        self._buf_valid: dict[str, list[np.ndarray]] = {n: [] for n in self._names}
        self._buf_rows = 0

    # ------------------------------------------------------------------
    def append_batch(self, values: dict[str, np.ndarray],
                     validity: Optional[dict[str, np.ndarray]] = None) -> None:
        """Append a column batch.  ``values[col]`` are physical-encoded
        arrays, all the same length; ``validity[col]`` bool arrays (missing
        key = all valid)."""
        lengths = {len(v) for v in values.values()}
        if len(lengths) != 1:
            raise StorageError("ragged column batch")
        n = lengths.pop()
        if n == 0:
            return
        if set(values) != set(self._buf):
            raise StorageError(f"batch columns {sorted(values)} != schema {sorted(self._buf)}")
        for col in self._names:
            v = np.asarray(values[col], dtype=self.schema.scan_dtype(col))
            self._buf[col].append(v)
            va = None if validity is None else validity.get(col)
            if va is None and validity is not None:
                # lane streams share the base uuid column's validity
                from citus_tpu_torch.types import is_uuid_lane, uuid_lane_base
                if is_uuid_lane(col):
                    va = validity.get(uuid_lane_base(col))
            self._buf_valid[col].append(
                np.ones(n, dtype=bool) if va is None else np.asarray(va, dtype=bool))
        self._buf_rows += n
        while self._buf_rows >= self.stripe_row_limit:
            self._flush_rows(self.stripe_row_limit)

    def flush(self) -> None:
        """Flush any buffered rows as a (possibly short) final stripe."""
        if self._buf_rows:
            self._flush_rows(self._buf_rows)

    @property
    def row_count(self) -> int:
        return _load_meta(self.directory)["row_count"] + self._buf_rows

    # ------------------------------------------------------------------
    def _take(self, store: dict, col: str, n: int) -> np.ndarray:
        chunks, got, out = store[col], 0, []
        while got < n:
            head = chunks[0]
            take = min(n - got, len(head))
            out.append(head[:take])
            if take == len(head):
                chunks.pop(0)
            else:
                chunks[0] = head[take:]
            got += take
        return np.concatenate(out) if len(out) != 1 else out[0]

    def _flush_rows(self, n: int) -> None:
        column_chunks: dict[str, list] = {}
        chunk_rows: list[int] = []
        col_vals = {c: self._take(self._buf, c, n) for c in self._names}
        col_valid = {c: self._take(self._buf_valid, c, n) for c in self._names}
        for start in range(0, n, self.chunk_row_limit):
            stop = min(start + self.chunk_row_limit, n)
            chunk_rows.append(stop - start)
        for col in self._names:
            chunks = []
            for start in range(0, n, self.chunk_row_limit):
                stop = min(start + self.chunk_row_limit, n)
                vals = col_vals[col][start:stop]
                valid = col_valid[col][start:stop]
                # null slots hold 0 so compression and device kernels see
                # deterministic bytes
                if not valid.all():
                    vals = np.where(valid, vals, vals.dtype.type(0))
                    chunks.append((vals, valid))
                else:
                    chunks.append((vals, None))
            column_chunks[self.schema.scan_storage_name(col)] = chunks
        if self.staged_xid is not None:
            # staged stripes get a transaction-unique name so concurrent
            # ingests into one placement can never collide on a file
            staged = _load_staged(self.directory, self.staged_xid)
            meta = _load_meta(self.directory)
            sid = meta["next_stripe_id"] + len(staged["stripes"])
            fname = f"stripe-{sid:06d}-x{self.staged_xid}-p{os.getpid()}.cts"
            write_stripe_file(
                os.path.join(self.directory, fname), column_chunks, chunk_rows,
                self.chunk_row_limit, self.codec, self.level,
                no_stats_columns=self._no_stats_columns)
            self._build_index_segments(fname, col_vals, col_valid)
            staged["stripes"].append({"file": fname, "row_count": n})
            staged["row_count"] += n
            _store_staged(self.directory, self.staged_xid, staged)
        else:
            with _meta_flock(self.directory):
                meta = _load_meta(self.directory)
                sid = meta["next_stripe_id"]
                fname = f"stripe-{sid:06d}.cts"
                write_stripe_file(
                    os.path.join(self.directory, fname), column_chunks, chunk_rows,
                    self.chunk_row_limit, self.codec, self.level,
                    no_stats_columns=self._no_stats_columns)
                self._build_index_segments(fname, col_vals, col_valid)
                meta["stripes"].append({"file": fname, "row_count": n})
                meta["row_count"] += n
                meta["next_stripe_id"] = sid + 1
                _store_meta(self.directory, meta)
        self._buf_rows -= n

    def _build_index_segments(self, fname: str, col_vals, col_valid) -> None:
        """Write each indexed column's segment beside the new stripe
        (before the stripe enters any metadata, so a reader never sees a
        live stripe whose segment is mid-write)."""
        if not self.index_columns:
            return
        from citus_tpu_torch.storage.index import build_segment
        for col in self.index_columns:
            if col in col_vals:
                build_segment(self.directory, fname, col,
                              col_vals[col], col_valid[col])
