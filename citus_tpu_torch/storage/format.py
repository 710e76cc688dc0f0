"""On-disk stripe file format.

Layout of a ``stripe-NNNNNN.cts`` file::

    [8-byte magic "CTPUSTR1"]
    [stream bytes ...]           # concatenated compressed streams
    [footer: JSON, utf-8]
    [uint64 LE footer length]
    [8-byte magic "CTPUSTR1"]

Per column per chunk group there are two streams — values (fixed-width
little-endian physical encoding, see citus_tpu_torch.types) and an optional
validity bitmap (np.packbits; absent when the chunk has no nulls).  The
footer carries the skip list: offsets/lengths plus min/max/null_count per
chunk, the analog of the reference's ColumnChunkSkipNode
(src/include/columnar/columnar.h:85-111) kept in the
columnar_internal.chunk catalog (src/backend/columnar/columnar_metadata.c).

Streams are independently addressable so a reader that pruned chunks (or
projected columns) never reads their bytes — same property the reference
gets from per-chunk existsBuffer/valueBuffer offsets.
"""

from __future__ import annotations

import json
import os
import struct
from dataclasses import dataclass, field
from typing import BinaryIO, Optional

import numpy as np

from citus_tpu_torch.errors import StorageError
from citus_tpu_torch.storage import compression as comp

MAGIC = b"CTPUSTR1"
FORMAT_VERSION = 1


@dataclass
class ChunkStats:
    """Skip-list node for one (column, chunk group)."""

    value_offset: int = 0
    value_length: int = 0          # compressed bytes
    value_raw_length: int = 0      # uncompressed bytes
    exists_offset: int = 0
    exists_length: int = 0
    exists_raw_length: int = 0
    has_nulls: bool = False
    null_count: int = 0
    row_count: int = 0
    minimum: Optional[float] = None  # physical value; None if all-null
    maximum: Optional[float] = None

    def to_json(self):
        return {
            "vo": self.value_offset, "vl": self.value_length, "vr": self.value_raw_length,
            "eo": self.exists_offset, "el": self.exists_length, "er": self.exists_raw_length,
            "hn": self.has_nulls, "nc": self.null_count, "rc": self.row_count,
            "mn": self.minimum, "mx": self.maximum,
        }

    @staticmethod
    def from_json(d) -> "ChunkStats":
        return ChunkStats(
            value_offset=d["vo"], value_length=d["vl"], value_raw_length=d["vr"],
            exists_offset=d["eo"], exists_length=d["el"], exists_raw_length=d["er"],
            has_nulls=d["hn"], null_count=d["nc"], row_count=d["rc"],
            minimum=d["mn"], maximum=d["mx"],
        )


@dataclass
class StripeFooter:
    row_count: int
    chunk_row_limit: int
    chunk_row_counts: list[int]
    codec: str
    columns: dict[str, list[ChunkStats]] = field(default_factory=dict)
    format_version: int = FORMAT_VERSION

    @property
    def chunk_count(self) -> int:
        return len(self.chunk_row_counts)

    def to_json(self) -> dict:
        return {
            "format_version": self.format_version,
            "row_count": self.row_count,
            "chunk_row_limit": self.chunk_row_limit,
            "chunk_row_counts": self.chunk_row_counts,
            "codec": self.codec,
            "columns": {name: [c.to_json() for c in chunks] for name, chunks in self.columns.items()},
        }

    @staticmethod
    def from_json(d: dict) -> "StripeFooter":
        f = StripeFooter(
            row_count=d["row_count"],
            chunk_row_limit=d["chunk_row_limit"],
            chunk_row_counts=d["chunk_row_counts"],
            codec=d["codec"],
            format_version=d["format_version"],
        )
        f.columns = {name: [ChunkStats.from_json(c) for c in chunks] for name, chunks in d["columns"].items()}
        return f


def _np_to_jsonable(v):
    if v is None:
        return None
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        fv = float(v)
        if fv != fv:  # NaN has no JSON form; drop the stat
            return None
        return fv
    return v


def write_stripe_file(
    path: str,
    column_chunks: dict[str, list[tuple[np.ndarray, Optional[np.ndarray]]]],
    chunk_row_counts: list[int],
    chunk_row_limit: int,
    codec: str,
    level: int,
    no_stats_columns: frozenset = frozenset(),
) -> StripeFooter:
    """Write one stripe atomically (temp file + rename).

    ``column_chunks[col]`` is a list of (values, validity) per chunk group;
    validity is a bool array or None when the chunk has no nulls.  Min/max
    stats are computed over valid rows only, like the reference's
    UpdateChunkSkipNodeMinMax (columnar_writer.c:664).
    ``no_stats_columns`` suppresses min/max for columns whose physical ids
    carry no value order (sketch state words): a skip node of None means
    "cannot prune", which is the only correct answer there.
    """
    footer = StripeFooter(
        row_count=int(sum(chunk_row_counts)),
        chunk_row_limit=chunk_row_limit,
        chunk_row_counts=[int(c) for c in chunk_row_counts],
        codec=codec,
    )
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(MAGIC)
        offset = len(MAGIC)
        for name, chunks in column_chunks.items():
            stats_list = []
            for (values, validity) in chunks:
                cs = ChunkStats(row_count=int(values.shape[0]))
                raw = np.ascontiguousarray(values).tobytes()
                cdata = comp.compress(raw, codec, level)
                cs.value_offset, cs.value_length, cs.value_raw_length = offset, len(cdata), len(raw)
                fh.write(cdata)
                offset += len(cdata)
                if validity is not None and not bool(validity.all()):
                    bits = np.packbits(validity.astype(np.uint8))
                    braw = bits.tobytes()
                    bdata = comp.compress(braw, codec, level)
                    cs.exists_offset, cs.exists_length, cs.exists_raw_length = offset, len(bdata), len(braw)
                    cs.has_nulls = True
                    cs.null_count = int(values.shape[0] - int(validity.sum()))
                    fh.write(bdata)
                    offset += len(bdata)
                    valid_vals = values[validity]
                else:
                    valid_vals = values
                if valid_vals.size and name not in no_stats_columns:
                    cs.minimum = _np_to_jsonable(valid_vals.min())
                    cs.maximum = _np_to_jsonable(valid_vals.max())
                stats_list.append(cs)
            footer.columns[name] = stats_list
        fj = json.dumps(footer.to_json(), separators=(",", ":")).encode()
        fh.write(fj)
        fh.write(struct.pack("<Q", len(fj)))
        fh.write(MAGIC)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
    return footer


def read_stripe_footer(path: str) -> StripeFooter:
    with open(path, "rb") as fh:
        fh.seek(0, os.SEEK_END)
        size = fh.tell()
        if size < len(MAGIC) * 2 + 8:
            raise StorageError(f"stripe file too small: {path}")
        fh.seek(size - len(MAGIC) - 8)
        tail = fh.read(8 + len(MAGIC))
        if tail[8:] != MAGIC:
            raise StorageError(f"bad trailing magic in {path}")
        (flen,) = struct.unpack("<Q", tail[:8])
        fh.seek(size - len(MAGIC) - 8 - flen)
        fj = fh.read(flen)
        fh.seek(0)
        if fh.read(len(MAGIC)) != MAGIC:
            raise StorageError(f"bad leading magic in {path}")
        return StripeFooter.from_json(json.loads(fj.decode()))


def read_chunk(
    fh: BinaryIO,
    footer: StripeFooter,
    stats: ChunkStats,
    storage_dtype: np.dtype,
) -> tuple[np.ndarray, Optional[np.ndarray]]:
    """Read + decompress one (column, chunk) -> (values, validity|None)."""
    fh.seek(stats.value_offset)
    raw = comp.decompress(fh.read(stats.value_length), footer.codec, stats.value_raw_length)
    values = np.frombuffer(raw, dtype=storage_dtype).copy()
    if values.shape[0] != stats.row_count:
        raise StorageError("chunk row count mismatch")
    validity = None
    if stats.has_nulls:
        fh.seek(stats.exists_offset)
        braw = comp.decompress(fh.read(stats.exists_length), footer.codec, stats.exists_raw_length)
        bits = np.frombuffer(braw, dtype=np.uint8)
        validity = np.unpackbits(bits)[: stats.row_count].astype(bool)
    return values, validity
