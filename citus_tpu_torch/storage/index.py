"""Per-stripe index segments: exact row positions by column value.

Reference: the reference builds btree indexes over columnar via
columnar_index_build_range_scan (columnar_tableam.c:1444) and random
row-number access (columnar_reader.c:370-391); index DDL propagates
through commands/index.c.  The TPU-native shape keeps stripes immutable
and stores, beside each stripe, one segment per indexed column: the
stripe's valid physical values sorted, plus the row offsets that order
them.  Lookups are two binary searches; segments are immutable and
travel with the stripe file (shard moves copy the directory).

A missing segment (stripe written before CREATE INDEX, or by a writer
unaware of the index) degrades to a full read of that stripe's column —
never wrong, just slower; backfill_index() closes the gap.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def segment_path(directory: str, stripe_file: str, column: str) -> str:
    return os.path.join(directory, f"{stripe_file}.idx.{column}.npz")


def build_segment(directory: str, stripe_file: str, column: str,
                  values: np.ndarray, validity: Optional[np.ndarray]) -> None:
    """Persist the sorted (value -> row offset) segment for one stripe.
    ``values`` are the stripe's physical values in row order; invalid
    (NULL) rows are excluded — NULL never equals anything."""
    values = np.asarray(values)
    if validity is not None:
        pos = np.nonzero(np.asarray(validity))[0].astype(np.int64)
        vals = values[pos]
    else:
        pos = np.arange(len(values), dtype=np.int64)
        vals = values
    order = np.argsort(vals, kind="stable")
    p = segment_path(directory, stripe_file, column)
    tmp = p + ".tmp"
    with open(tmp, "wb") as fh:
        # lint: disable=CONF01 -- on-disk index segment format, not wire traffic (the wire codecs live in net/data_plane.py)
        np.savez(fh, sv=vals[order], pos=pos[order])
    os.replace(tmp, p)


def load_segment(directory: str, stripe_file: str, column: str):
    """-> (sorted_values, positions) or None when no segment exists."""
    p = segment_path(directory, stripe_file, column)
    if not os.path.exists(p):
        return None
    # lint: disable=CONF01 -- on-disk index segment format, not wire traffic (the wire codecs live in net/data_plane.py)
    with np.load(p) as z:
        return z["sv"], z["pos"]


def drop_segments(directory: str, column: str) -> None:
    """Remove a column's segments in one placement (DROP INDEX)."""
    suffix = f".idx.{column}.npz"
    for f in os.listdir(directory):
        if f.endswith(suffix):
            try:
                os.remove(os.path.join(directory, f))
            except OSError:
                pass


def positions_eq(directory: str, stripe_file: str, column: str,
                 value) -> Optional[np.ndarray]:
    """Row offsets within the stripe whose column equals ``value``;
    None when the stripe has no segment (caller must scan)."""
    seg = load_segment(directory, stripe_file, column)
    if seg is None:
        return None
    sv, pos = seg
    lo = np.searchsorted(sv, value, "left")
    hi = np.searchsorted(sv, value, "right")
    return pos[lo:hi]


def probe_any(directory: str, stripe_file: str, column: str,
              values: np.ndarray) -> Optional[np.ndarray]:
    """Per-value bool: does the stripe contain this value?  None when no
    segment exists (caller must scan).  Vectorized searchsorted — the
    uniqueness-probe fast path."""
    seg = load_segment(directory, stripe_file, column)
    if seg is None:
        return None
    sv, _pos = seg
    lo = np.searchsorted(sv, values, "left")
    hi = np.searchsorted(sv, values, "right")
    return hi > lo


def matching_positions(directory: str, stripe_file: str, column: str,
                       values: np.ndarray):
    """-> (per-value bool mask, concatenated row offsets) of rows whose
    column equals any of ``values``; None when no segment exists."""
    seg = load_segment(directory, stripe_file, column)
    if seg is None:
        return None
    sv, pos = seg
    lo = np.searchsorted(sv, values, "left")
    hi = np.searchsorted(sv, values, "right")
    found = hi > lo
    if not found.any():
        return found, np.empty(0, np.int64)
    parts = [pos[int(a):int(b)] for a, b in zip(lo[found], hi[found])]
    return found, np.concatenate(parts)


def backfill_index(cat, table, columns: list[str]) -> int:
    """Build missing segments for every stripe of every placement
    (CREATE INDEX on existing data).  Returns segments built."""
    from citus_tpu_torch.schema import Schema  # noqa: F401 (typing aid)
    from citus_tpu_torch.storage.reader import ShardReader

    built = 0
    for shard in table.shards:
        for node in shard.placements:
            d = cat.shard_dir(table.name, shard.shard_id, node)
            if not os.path.isdir(d):
                continue
            reader = ShardReader(d, table.schema)
            for stripe in reader.meta["stripes"]:
                sf = stripe["file"]
                missing = [c for c in columns
                           if not os.path.exists(segment_path(d, sf, c))]
                if not missing:
                    continue
                # accumulate the stripe's full column(s) in row order
                vals = {c: [] for c in missing}
                valid = {c: [] for c in missing}
                for batch in reader.scan(missing, apply_deletes=False,
                                         only_stripes={sf}):
                    for c in missing:
                        vals[c].append(batch.values[c])
                        m = batch.validity[c]
                        valid[c].append(
                            np.ones(batch.row_count, bool) if m is None
                            else m)
                for c in missing:
                    if not vals[c]:
                        continue
                    build_segment(d, sf, c, np.concatenate(vals[c]),
                                  np.concatenate(valid[c]))
                    built += 1
    return built
