"""Ingest: rows/columns -> physically-encoded, hash-partitioned shard writes.

This is the distributed COPY path (reference:
src/backend/distributed/commands/multi_copy.c — CitusCopyDestReceiver,
ShardIdForTuple).  Tuples are encoded to physical columns on the
coordinator (text columns consult the table-global dictionary), hashed on
the distribution column, split per shard, and appended to each shard's
columnar writer.
"""

from __future__ import annotations

from typing import Any, Iterable, Optional, Sequence

import numpy as np

from citus_tpu_torch.catalog import Catalog, DistributionMethod, TableMeta
from citus_tpu_torch.catalog.hashing import hash_int64
from citus_tpu_torch.errors import AnalysisError
from citus_tpu_torch.storage import ShardWriter
from citus_tpu_torch.types import UUID, uuid_lane_arrays, uuid_lane_name


def encode_columns(
    cat: Catalog, table: TableMeta,
    columns: dict[str, Sequence[Any]],
) -> tuple[dict[str, np.ndarray], dict[str, np.ndarray]]:
    """Python/object columns -> (physical values, validity) arrays."""
    values: dict[str, np.ndarray] = {}
    validity: dict[str, np.ndarray] = {}
    n = None
    for col in table.schema:
        if col.name not in columns:
            raise AnalysisError(f"missing column {col.name!r} in ingest batch")
        data = columns[col.name]
        if n is None:
            n = len(data)
        elif len(data) != n:
            raise AnalysisError("ragged ingest batch")
        if isinstance(data, np.ndarray) and data.dtype != object \
                and not col.type.is_text and col.type.kind != UUID:
            # already-numeric fast path: no per-value conversion
            if col.type.kind == "decimal" and np.issubdtype(data.dtype, np.floating):
                # round half away from zero, matching to_physical's
                # ROUND_HALF_UP (np.round would use banker's rounding)
                x = data * float(10 ** col.type.scale)
                scaled = np.where(x >= 0, np.floor(x + 0.5), np.ceil(x - 0.5)).astype(np.int64)
                values[col.name] = scaled
            else:
                values[col.name] = data.astype(col.type.storage_dtype)
            validity[col.name] = np.ones(n, dtype=bool)
            continue
        valid = np.array([v is not None for v in data], dtype=bool)
        if col.type.is_text:
            enum_t = cat.enum_columns.get(f"{table.name}.{col.name}")
            if enum_t is not None:
                allowed = set(cat.types.get(enum_t, ()))
                for v in data:
                    if v is not None and str(v) not in allowed:
                        raise AnalysisError(
                            f"invalid input value for enum {enum_t}: {v!r}")
            ids = cat.encode_strings(table.name, col.name, list(data))
            values[col.name] = np.asarray(ids, dtype=col.type.storage_dtype)
        elif col.type.kind == UUID:
            # dictionary bypass: the 128-bit value splits into two
            # order-preserving int64 lane streams; no table-global ids
            hi, lo = uuid_lane_arrays(data)
            values[col.name] = hi
            lane = uuid_lane_name(col.name)
            values[lane] = lo
            validity[lane] = valid
        else:
            phys = [col.type.to_physical(v) for v in data]
            values[col.name] = np.asarray(phys, dtype=col.type.storage_dtype)
        validity[col.name] = valid
        if col.not_null and not valid.all():
            raise AnalysisError(f"null value in NOT NULL column {col.name!r}")
    return values, validity


class TableIngestor:
    """Holds per-placement writers for one table; routes encoded batches.

    When constructed with a transaction log, the whole ingest is a
    two-phase commit across placements (reference: the distributed COPY
    path commits per-shard COPY streams under 2PC,
    transaction/transaction_management.c): stripes are written staged,
    a PREPARED record lists every placement, COMMITTED flips them live,
    DONE marks recovery-complete.  A crash at any point either rolls
    forward or rolls back cleanly on the next recover().
    """

    def __init__(self, cat: Catalog, table: TableMeta, txlog=None):
        self.cat = cat
        self.table = table
        self.txlog = txlog
        self.xid = txlog.begin() if txlog is not None else None
        self._writers: dict[tuple[int, int], ShardWriter] = {}

    def _writer(self, shard_id: int, node: int) -> ShardWriter:
        key = (shard_id, node)
        w = self._writers.get(key)
        if w is None:
            w = ShardWriter(
                self.cat.shard_dir(self.table.name, shard_id, node),
                self.table.schema,
                chunk_row_limit=self.table.chunk_row_limit,
                stripe_row_limit=self.table.stripe_row_limit,
                codec=self.table.compression,
                level=self.table.compression_level,
                staged_xid=self.xid,
                index_columns=tuple(self.table.index_columns),
            )
            self._writers[key] = w
        return w

    def append(self, values: dict[str, np.ndarray], validity: dict[str, np.ndarray]) -> None:
        t = self.table
        if t.method == DistributionMethod.HASH:
            dist = values[t.dist_column].astype(np.int64)
            idx = t.route_hashes(hash_int64(dist))
            for si in np.unique(idx):
                sel = idx == si
                shard = t.shards[int(si)]
                sub_v = {c: v[sel] for c, v in values.items()}
                sub_m = {c: m[sel] for c, m in validity.items()}
                for node in shard.placements:
                    if self.cat.is_remote_node(node):
                        # another coordinator hosts this placement: its
                        # bytes arrive over the data plane (ship_batch),
                        # never as a local directory for a foreign node
                        continue
                    self._writer(shard.shard_id, node).append_batch(sub_v, sub_m)
        else:
            # local table: single shard; reference table: replicate to all
            shard = t.shards[0]
            for node in shard.placements:
                if self.cat.is_remote_node(node):
                    continue
                self._writer(shard.shard_id, node).append_batch(values, validity)

    def finish(self) -> int:
        """Flush all writers (2PC when a txlog is attached); returns rows
        written this session."""
        from citus_tpu_torch.storage.writer import commit_staged
        from citus_tpu_torch.transaction.manager import TxState

        try:
            total = 0
            for w in self._writers.values():
                total += w._buf_rows
                w.flush()
            # persist the catalog (version bump; dictionaries are already
            # fsync'd at encode time) BEFORE the COMMITTED record: a
            # crash-recovery roll-forward must never flip stripes live
            # whose dictionary ids exceed the persisted dictionary.
            # Catalog/dictionary growth is monotonic, so persisting early
            # is safe even if the transaction aborts below.
            self.table.version += 1  # invalidate cached plans/statistics
            self.cat.commit()
            if self.txlog is not None:
                dirs = [w.directory for w in self._writers.values()]
                self.txlog.log(self.xid, TxState.PREPARED,
                               {"kind": "ingest", "table": self.table.name,
                                "placements": dirs})
                self.txlog.log(self.xid, TxState.COMMITTED,
                               {"table": self.table.name})
                from citus_tpu_torch.transaction.snapshot import flip_generation
                with flip_generation(self.cat.data_dir, self.table):
                    # a snapshot read sees the whole COPY or none of it
                    for d in dirs:
                        commit_staged(d, self.xid)
                self.txlog.log(self.xid, TxState.DONE)
            return total
        except BaseException:
            # stop driving the transaction; recovery decides its outcome
            if self.txlog is not None:
                self.txlog.release(self.xid)
            raise

    def abort(self) -> None:
        """Roll back a transactional ingest (drops staged stripes)."""
        from citus_tpu_torch.storage.writer import abort_staged
        from citus_tpu_torch.transaction.manager import TxState
        if self.xid is None:
            return
        for w in self._writers.values():
            w._buf_rows = 0
            abort_staged(w.directory, self.xid)
        if self.txlog is not None:
            self.txlog.log(self.xid, TxState.ABORTED)
            self.txlog.log(self.xid, TxState.DONE)


def rows_to_columns(schema_names: list[str], rows: Iterable[Sequence[Any]],
                    columns: Optional[list[str]] = None) -> dict[str, list]:
    """Row tuples -> column lists, filling omitted columns with None.
    An explicit empty column list means every column is omitted
    (INSERT ... DEFAULT VALUES)."""
    cols = schema_names if columns is None else columns
    store: dict[str, list] = {name: [] for name in schema_names}
    for row in rows:
        if len(row) != len(cols):
            raise AnalysisError(f"row has {len(row)} values, expected {len(cols)}")
        seen = dict(zip(cols, row))
        for name in schema_names:
            store[name].append(seen.get(name))
    return store
