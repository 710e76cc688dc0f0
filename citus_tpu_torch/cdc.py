"""Change data capture.

Reference: the CDC decoder wrapper (src/backend/distributed/cdc/
cdc_decoder.c) that rewrites logical-decoding changes from shard OIDs to
distributed-table OIDs and suppresses internal replication (shard moves)
via the DoNotReplicateId origin.

Here the change stream is written at commit time by the DML/ingest paths
(there is no WAL to decode): one JSONL stream per table, ordered by the
transaction's HLC timestamp.  Internal data movement (shard moves,
rebalances, VACUUM rewrites) bypasses the emit path entirely, giving the
same "changes once, at the distributed-table level" guarantee.

Stream hygiene (round 4): a sparse lsn->byte-offset index grows with the
stream so ``events(from_lsn)`` seeks instead of rescanning history
(O(new records), like a replication slot's confirmed_flush position);
``acknowledge()`` truncates records a consumer has confirmed, keeping
the stream bounded (the slot-advance / WAL-recycling analog).

Gated by ``enable_change_data_capture`` per cluster (reference GUC
citus.enable_change_data_capture).
"""

from __future__ import annotations

import json
import os
import threading
from typing import Iterator, Optional

#: a new index entry per this many appended stream bytes
INDEX_STRIDE_BYTES = 16384


class ChangeDataCapture:
    def __init__(self, data_dir: str, enabled: bool = False):
        self.dir = os.path.join(data_dir, "cdc")
        self.enabled = enabled
        self._mu = threading.Lock()
        # observability: bytes actually read by events() — tests assert
        # seek-reads stay O(new records)
        self.bytes_read = 0
        self._index_cache: dict[str, tuple] = {}  # table -> (sig, entries)
        # table -> (known stream size, max lsn of those bytes): the
        # running prefix-max recorded into index entries so seeks are
        # exact under HLC skew between emitters
        self._prefix_cache: dict[str, tuple[int, int]] = {}

    def _path(self, table: str) -> str:
        return os.path.join(self.dir, f"{table}.changes.jsonl")

    def _index_path(self, table: str) -> str:
        return os.path.join(self.dir, f"{table}.changes.idx.jsonl")

    def _ack_path(self, table: str) -> str:
        return os.path.join(self.dir, f"{table}.ack.json")

    # ------------------------------------------------------------ write
    def emit(self, table: str, op: str, lsn: int, *,
             rows: Optional[list] = None, count: Optional[int] = None,
             columns: Optional[list[str]] = None,
             force: bool = False) -> None:
        """op in {insert, delete, update}; lsn = HLC transaction clock.
        ``force`` bypasses the global switch (publication-covered tables
        capture even when enable_change_data_capture is off)."""
        if not (self.enabled or force):
            return
        os.makedirs(self.dir, exist_ok=True)
        rec = {"lsn": lsn, "op": op, "table": table}
        if columns is not None:
            rec["columns"] = columns
        if rows is not None:
            rec["rows"] = rows
            rec["count"] = len(rows)
        elif count is not None:
            rec["count"] = count
        from citus_tpu_torch.utils.filelock import FileLock
        with self._mu, FileLock(os.path.join(self.dir, ".cdc.lock")):
            # the cross-process lock is shared with acknowledge(): an
            # append racing its read-rewrite-replace would otherwise be
            # dropped by the os.replace
            p = self._path(table)
            size = os.path.getsize(p) if os.path.exists(p) else 0
            entries = self._load_index_locked(table)
            pmax = self._prefix_max_locked(table, size, entries)
            last_off = entries[-1][1] if entries else -INDEX_STRIDE_BYTES
            if size - last_off >= INDEX_STRIDE_BYTES:
                # `size` is a record boundary (appends are whole lines
                # under the lock), so seeking there lands on a record.
                # pmax = max lsn over every byte before `offset`: the
                # seek can then PROVE all earlier records are consumed,
                # exactly, under any HLC skew between emitters
                with open(self._index_path(table), "a") as fh:
                    fh.write(json.dumps({"lsn": lsn, "offset": size,
                                         "pmax": pmax}) + "\n")
                self._index_cache.pop(table, None)
            with open(p, "a") as fh:
                line = json.dumps(rec, default=str) + "\n"
                fh.write(line)
                fh.flush()
            self._prefix_cache[table] = (size + len(line.encode()),
                                         max(pmax, lsn))

    def _prefix_max_locked(self, table: str, size: int, entries) -> int:
        """Max lsn over the stream's first ``size`` bytes.  Cached per
        table; foreign appends (another process emitting into the same
        stream) are folded in by scanning only the grown delta.  Called
        under the cdc lock."""
        known = self._prefix_cache.get(table)
        if known is not None and known[0] == size:
            return known[1]
        if known is not None and 0 < known[0] < size:
            m = max(known[1], self._range_max(table, known[0], size))
        elif size == 0:
            m = 0
        else:
            # cold start over an existing stream: index maxima cover the
            # prefix up to the last entry; scan the remaining (< one
            # stride) tail.  An old-format entry (no pmax) only knows
            # its own record's lsn, so fall back to a full scan once.
            m = 0
            start = 0
            if entries:
                if any(e[2] is None for e in entries):
                    start = 0
                else:
                    m = max(max(e[2] for e in entries),
                            max(e[0] for e in entries))
                    start = entries[-1][1]
            m = max(m, self._range_max(table, start, size))
        self._prefix_cache[table] = (size, m)
        return m

    def _range_max(self, table: str, start: int, end: int) -> int:
        m = 0
        with open(self._path(table), "rb") as fh:
            fh.seek(start)
            data = fh.read(end - start)
        for line in data.splitlines():
            line = line.strip()
            if line:
                try:
                    m = max(m, json.loads(line)["lsn"])
                except ValueError:
                    pass
        return m

    # ------------------------------------------------------------- read
    def _load_index_locked(self, table: str) -> list[tuple[int, int]]:
        """[(lsn, byte offset)] ascending; cached on (mtime, size)."""
        p = self._index_path(table)
        try:
            st = os.stat(p)
            sig = (st.st_mtime_ns, st.st_size)
        except OSError:
            return []
        cached = self._index_cache.get(table)
        if cached is not None and cached[0] == sig:
            return cached[1]
        entries = []
        with open(p) as fh:
            for line in fh:
                line = line.strip()
                if line:
                    d = json.loads(line)
                    entries.append((d["lsn"], d["offset"], d.get("pmax")))
        self._index_cache[table] = (sig, entries)
        return entries

    def _seek_offset(self, table: str, from_lsn: int) -> int:
        """Largest indexed offset provably safe to resume from: an
        entry's ``pmax`` is the max lsn over every record before its
        offset, so pmax <= from_lsn guarantees nothing before the
        offset survives the ``lsn > from_lsn`` filter — exact under any
        HLC skew between concurrent emitters (a heuristic backstep is
        not: bursts compress arbitrarily many skewed records into one
        stride).  Old-format entries without pmax are never trusted."""
        if from_lsn <= 0:
            return 0
        # readers share the cache with emit(): the store below must not
        # race emit's invalidating pop
        with self._mu:
            entries = self._load_index_locked(table)
        best = 0
        for _lsn, off, pmax in entries:
            if pmax is None or pmax > from_lsn:
                break
            best = off
        return best

    def events(self, table: str, from_lsn: int = 0) -> Iterator[dict]:
        """Changes with lsn > from_lsn.  Seeks via the sparse index:
        reading the tail of a long-history stream costs O(new records),
        not O(history) — the confirmed_flush_lsn resume semantics of a
        logical replication slot."""
        p = self._path(table)
        if not os.path.exists(p):
            return
        start = self._seek_offset(table, from_lsn)
        with open(p) as fh:
            if start:
                fh.seek(start)
            for line in fh:
                self.bytes_read += len(line)
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                if rec["lsn"] > from_lsn:
                    yield rec

    def has_stream(self, table: str) -> bool:
        """True when a change stream exists for the table — shard moves
        use it to pick their catch-up lag measure (pending change
        records when a stream exists, bytes-copied otherwise)."""
        return os.path.exists(self._path(table))

    def pending_count(self, table: str, from_lsn: int) -> int:
        """Number of change records with lsn > from_lsn: the replication
        lag a shard move's catch-up loop compares against
        citus.shard_move_catchup_threshold.  Costs O(tail) via the
        sparse index, like events()."""
        return sum(1 for _ in self.events(table, from_lsn))

    def last_lsn(self, table: str) -> int:
        """Newest change lsn — tail-read, O(last records) not
        O(history).  The window grows backwards until it holds at least
        one complete record (a single bulk-ingest record can exceed any
        fixed window)."""
        p = self._path(table)
        try:
            size = os.path.getsize(p)
        except OSError:
            return 0
        if size == 0:
            return 0
        window = 1 << 16
        while True:
            tail = min(size, window)
            with open(p, "rb") as fh:
                fh.seek(size - tail)
                chunk = fh.read(tail)
            self.bytes_read += len(chunk)
            lines = chunk.splitlines()
            if tail < size:
                lines = lines[1:]  # first line of a partial window
            last = 0
            for line in lines:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                last = max(last, rec["lsn"])
            if last or tail == size:
                return last
            window *= 4

    # --------------------------------------------------------- rotation
    def acknowledge(self, table: str, upto_lsn: int) -> int:
        """Consumer confirmation: drop records with lsn <= upto_lsn and
        rebuild the index (slot advance + WAL recycling).  Returns the
        number of records truncated."""
        p = self._path(table)
        if not os.path.exists(p):
            return 0
        from citus_tpu_torch.utils.filelock import FileLock
        with self._mu, FileLock(os.path.join(self.dir, ".cdc.lock")):
            kept, dropped = [], 0
            with open(p) as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    if json.loads(line)["lsn"] <= upto_lsn:
                        dropped += 1
                    else:
                        kept.append(line)
            # the confirmed position advances monotonically even when
            # nothing is truncated (consumer acked past the stream tail)
            if upto_lsn > self.acknowledged_lsn(table):
                with open(self._ack_path(table), "w") as fh:
                    json.dump({"acknowledged_lsn": upto_lsn}, fh)
            if not dropped:
                return 0
            tmp = p + ".tmp"
            idx_tmp = self._index_path(table) + ".tmp"
            off = 0
            running_max = 0
            with open(tmp, "w") as fh, open(idx_tmp, "w") as ix:
                last_indexed = -INDEX_STRIDE_BYTES
                for line in kept:
                    if off - last_indexed >= INDEX_STRIDE_BYTES:
                        ix.write(json.dumps(
                            {"lsn": json.loads(line)["lsn"],
                             "offset": off, "pmax": running_max}) + "\n")
                        last_indexed = off
                    fh.write(line + "\n")
                    off += len(line.encode()) + 1
                    running_max = max(running_max,
                                      json.loads(line)["lsn"])
            os.replace(tmp, p)
            os.replace(idx_tmp, self._index_path(table))
            self._index_cache.pop(table, None)
            self._prefix_cache[table] = (off, running_max)
            return dropped

    def acknowledged_lsn(self, table: str) -> int:
        try:
            with open(self._ack_path(table)) as fh:
                return json.load(fh)["acknowledged_lsn"]
        except (OSError, ValueError, KeyError):
            return 0
