"""Columnar storage engine.

TPU-native re-design of the reference columnar table access method
(reference: src/backend/columnar/ — columnar_writer.c, columnar_reader.c,
columnar_metadata.c, columnar_compression.c).  Same structural ideas:

- a shard's data is an append-only sequence of immutable *stripes*
- a stripe holds *chunk groups* of a fixed row limit
- per column per chunk group there are two independently-compressed,
  independently-addressable streams: values and a validity bitmap
- a skip list of per-chunk min/max/null-count enables chunk pruning
  before any decompression happens

Differences by design (TPU-first):

- chunk row limit is a power of two so decompressed chunks form padded
  device batches with no re-layout
- values are fixed-width physical encodings (see citus_tpu_torch.types); text is
  dictionary-encoded at ingest, so kernels only ever see numbers
- stripes are plain files + a JSON footer instead of pages inside
  PostgreSQL's buffer manager; durability is write-temp + rename + catalog
  commit (the catalog, not the data file, is the source of truth —
  mirroring the reference's "metadata is truth, data immutable-append"
  split)
"""

from citus_tpu_torch.storage.format import StripeFooter, ChunkStats, write_stripe_file, read_stripe_footer, read_chunk
from citus_tpu_torch.storage.writer import ShardWriter
from citus_tpu_torch.storage.reader import ShardReader, ChunkBatch, Interval
from citus_tpu_torch.storage.index import (
    backfill_index, build_segment, drop_segments, load_segment,
    matching_positions, positions_eq, probe_any,
)

__all__ = [
    "StripeFooter",
    "ChunkStats",
    "write_stripe_file",
    "read_stripe_footer",
    "read_chunk",
    "ShardWriter",
    "ShardReader",
    "ChunkBatch",
    "Interval",
    "backfill_index",
    "build_segment",
    "drop_segments",
    "load_segment",
    "matching_positions",
    "positions_eq",
    "probe_any",
]
