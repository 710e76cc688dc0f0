"""Distribution hashing.

The reference hashes the distribution column with PostgreSQL's hash
functions and partitions the signed int32 hash space into ``shard_count``
uniform ranges (pg_dist_shard.shardminvalue/shardmaxvalue; pruning in
src/backend/distributed/planner/shard_pruning.c).  We keep the same
structure — a deterministic 64->32 bit hash, uniform contiguous ranges —
with a splitmix64-style finalizer that is cheap both in numpy (ingest,
host pruning) and in XLA (device-side repartition shuffles).
"""

from __future__ import annotations

import numpy as np

_C1 = np.uint64(0xBF58476D1CE4E5B9)
_C2 = np.uint64(0x94D049BB133111EB)
_GOLDEN = np.uint64(0x9E3779B97F4A7C15)

INT32_MIN = -(2**31)
INT32_MAX = 2**31 - 1


def hash_int64(values: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer -> signed int32 hash values."""
    with np.errstate(over="ignore"):
        x = values.astype(np.int64).view(np.uint64) + _GOLDEN
        x ^= x >> np.uint64(30)
        x *= _C1
        x ^= x >> np.uint64(27)
        x *= _C2
        x ^= x >> np.uint64(31)
    return (x >> np.uint64(32)).astype(np.uint32).view(np.int32)


def hash_int64_scalar(value: int) -> int:
    return int(hash_int64(np.array([value], dtype=np.int64))[0])


def shard_hash_ranges(shard_count: int) -> list[tuple[int, int]]:
    """Uniform partition of [INT32_MIN, INT32_MAX] into shard_count ranges,
    identical in spirit to the reference's CreateShardsWithRoundRobin."""
    span = 2**32
    step = span // shard_count
    ranges = []
    lo = INT32_MIN
    for i in range(shard_count):
        hi = INT32_MAX if i == shard_count - 1 else lo + step - 1
        ranges.append((lo, hi))
        lo = hi + 1
    return ranges


def shard_index_for_hash(hashes: np.ndarray, shard_count: int) -> np.ndarray:
    """Map signed int32 hashes to shard indexes under the uniform ranges."""
    span = 2**32
    step = span // shard_count
    u = (hashes.astype(np.int64) - INT32_MIN).astype(np.uint64)
    idx = (u // np.uint64(step)).astype(np.int64)
    return np.minimum(idx, shard_count - 1).astype(np.int32)


def shard_index_for_values(values: np.ndarray, shard_count: int) -> np.ndarray:
    return shard_index_for_hash(hash_int64(values), shard_count)
