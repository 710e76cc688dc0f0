"""Device-resident column batch cache with real device-memory accounting.

The reference keeps hot table blocks in PostgreSQL shared buffers; the
JAX package keeps decompressed, padded column batches resident in TPU
HBM, and this port keeps them as tensors on the Cluster's device, under
the same keys and capacity.  Entries are keyed by (table,
table.version, snapshot flip generation, shard, projected columns,
pruning signature) plus the device — any ingest/DDL bumps the version
and naturally invalidates, and the generation keys out the two windows
version alone misses (the version is committed before the stripe flip,
and a torn scan's put must not satisfy the seqlock retry after it).

A mesh query's entry is keyed by the same key plus ``("mesh", n,
members)`` and holds its rounds, each a list of every member's batch
on that member's device; its bytes are those tensors' bytes, pad
members included, so the accounting stays exact.

A byte-bounded LRU keeps the cache inside device memory; eviction drops
the tensor references and lets PyTorch's allocator reuse the memory.
Beyond the hit/miss/evicted counters the cache keeps a ledger: live
resident bytes, the high-water mark, and per-(table, tenant)
attribution.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional

DEFAULT_CAPACITY_BYTES = 6 << 30

#: attribution bucket for entries cached outside any tenant slot
#: (megabatch family entries shared across tenants, warmup scans)
SHARED_TENANT = "*"


def _counters():
    from citus_tpu_torch.executor.executor import GLOBAL_COUNTERS
    return GLOBAL_COUNTERS


class DeviceBatchCache:
    def __init__(self, capacity_bytes: int = DEFAULT_CAPACITY_BYTES):
        self.capacity = capacity_bytes
        self._mu = threading.Lock()
        # key -> (batches, nbytes, (table, tenant) owner)
        self._entries: OrderedDict[tuple, tuple[list, int, tuple]] = \
            OrderedDict()
        self._bytes = 0
        self._high_water = 0
        # (table, tenant) -> resident bytes attributed to that pair
        self._attr: dict[tuple, int] = {}
        self.hits = 0
        self.misses = 0

    @staticmethod
    def _owner(key: tuple, tenant: Optional[str]) -> tuple:
        # plan_cache_key() puts the table name at index 1 (and the mesh
        # variant only appends suffix elements, so it holds there too)
        table = key[1] if len(key) > 1 else "?"
        return (str(table), tenant if tenant else SHARED_TENANT)

    def get(self, key: tuple) -> Optional[list]:
        touched = 0
        with self._mu:
            e = self._entries.get(key)
            if e is not None:
                self._entries.move_to_end(key)
                self.hits += 1
                touched = e[1]
            else:
                self.misses += 1
        if e is None:
            _counters().bump("device_cache_misses")
            return None
        _counters().bump("device_cache_hits")
        # a hit replays the resident entry's bytes through the device —
        # the same HBM traffic EXPLAIN ANALYZE accounts for streams
        _counters().bump("device_hbm_touched_bytes", touched)
        return e[0]

    def put(self, key: tuple, batches: list, nbytes: int,
            tenant: Optional[str] = None) -> None:
        if nbytes > self.capacity:
            return  # too large to cache; stream it
        evicted = 0
        with self._mu:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old[1]
                self._attr_sub_locked(old[2], old[1])
            while self._bytes + nbytes > self.capacity and self._entries:
                _, (_, old_bytes, old_owner) = \
                    self._entries.popitem(last=False)
                self._bytes -= old_bytes
                self._attr_sub_locked(old_owner, old_bytes)
                evicted += old_bytes
            owner = self._owner(key, tenant)
            self._entries[key] = (batches, nbytes, owner)
            self._bytes += nbytes
            self._attr[owner] = self._attr.get(owner, 0) + nbytes
            self._high_water = max(self._high_water, self._bytes)
        if evicted:
            _counters().bump("device_cache_evicted_bytes", evicted)

    def _attr_sub_locked(self, owner: tuple, nbytes: int) -> None:
        left = self._attr.get(owner, 0) - nbytes
        if left > 0:
            self._attr[owner] = left
        else:
            self._attr.pop(owner, None)

    def memory_view(self) -> dict:
        """HBM ledger snapshot: live/high-water/capacity bytes plus the
        per-(table, tenant) attribution (sums exactly to live_bytes)."""
        with self._mu:
            return {
                "live_bytes": self._bytes,
                "high_water_bytes": self._high_water,
                "capacity_bytes": self.capacity,
                "entries": len(self._entries),
                "by_owner": sorted(
                    (table, tenant, b)
                    for (table, tenant), b in self._attr.items()),
            }

    def drop_table(self, data_dir: str, table: str) -> int:
        """Give back every entry of one table of ``data_dir`` (DROP
        TABLE: the intermediate tables of CTEs, derived tables and set
        operations are dropped after each statement, and their batches
        must not wait for LRU eviction).  -> bytes released."""
        freed = 0
        with self._mu:
            dead = [k for k in self._entries
                    if len(k) > 1 and k[0] == data_dir and k[1] == table]
            for k in dead:
                _, nbytes, owner = self._entries.pop(k)
                self._bytes -= nbytes
                self._attr_sub_locked(owner, nbytes)
                freed += nbytes
        return freed

    def clear(self) -> None:
        with self._mu:
            self._entries.clear()
            self._attr.clear()
            self._bytes = 0  # high-water survives: it is an odometer


GLOBAL_CACHE = DeviceBatchCache()


def plan_cache_key(plan, data_dir: str) -> tuple:
    t = plan.bound.table
    intervals = tuple(sorted(
        ((c.column, repr(c.lo), repr(c.hi), c.lo_inclusive, c.hi_inclusive)
         for c in plan.intervals)))
    # shard ids are allocated monotonically and never reused, so they (plus
    # the data_dir) uniquely identify the relation incarnation — a dropped
    # and recreated table can never alias a cache entry
    shard_ids = tuple(t.shards[i].shard_id for i in plan.shard_indexes)
    # the snapshot flip generation is part of the key, not just
    # table.version: writers commit the version bump BEFORE flipping
    # stripes live, and a torn scan's put must not be served to the
    # seqlock retry that follows it.  Generations are strictly
    # monotonic, so an entry keyed at gen g can only ever be read by
    # an attempt that also validates at gen g — which proves no flip
    # overlapped the span from this key computation to that
    # validation, i.e. the cached scan was consistent.
    from citus_tpu_torch.transaction.snapshot import read_generation
    gen, _busy = read_generation(data_dir, t)
    return (data_dir, t.name, t.version, gen, tuple(plan.scan_columns),
            shard_ids, intervals)
