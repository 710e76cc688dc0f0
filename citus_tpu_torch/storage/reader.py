"""Shard reader: stripe/chunk iteration with skip-list pruning.

Reference analog: ColumnarBeginRead/ColumnarReadNextRow and chunk skipping
(src/backend/columnar/columnar_reader.c:148-180,323) — but instead of
materializing one row per call, the unit of delivery is a whole chunk
batch (values + validity per projected column), ready to be padded and
shipped to a device kernel.  Pruning happens on the host from footer
min/max stats before any stream bytes are read or decompressed, like
SelectedChunkMask/BuildBaseConstraint in the reference.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from citus_tpu_torch.errors import AnalysisError, StorageError
from citus_tpu_torch.schema import Schema
from citus_tpu_torch.storage.format import read_stripe_footer, read_chunk
from citus_tpu_torch.storage.writer import _load_meta


# SET citus.decode_threads pushes here (the process-wide native pool has
# no cluster handle, like kernel_cache's set_capacity); None = read the
# ambient settings
_DECODE_THREADS: Optional[int] = None


def set_decode_threads(n: int) -> None:
    global _DECODE_THREADS
    _DECODE_THREADS = int(n)


def decode_thread_count() -> int:
    """Threads for the native read+decompress pool — citus.decode_threads
    (0 = auto: min(8, cpu_count))."""
    n = _DECODE_THREADS
    if n is None:
        from citus_tpu_torch.config import current_settings
        n = current_settings().executor.decode_threads
    if n > 0:
        return n
    return min(8, os.cpu_count() or 1)


@dataclass(frozen=True)
class Interval:
    """Closed/open numeric interval constraint on a column's physical
    values — the pruning currency (analog of the reference's base
    constraint over the skip list's min/max)."""

    column: str
    lo: Optional[float] = None
    hi: Optional[float] = None
    lo_inclusive: bool = True
    hi_inclusive: bool = True

    def admits(self, cmin, cmax) -> bool:
        """Could any value in [cmin, cmax] satisfy this constraint?"""
        if cmin is None or cmax is None:
            return True  # no stats -> cannot prune
        if self.lo is not None:
            if cmax < self.lo or (cmax == self.lo and not self.lo_inclusive):
                return False
        if self.hi is not None:
            if cmin > self.hi or (cmin == self.hi and not self.hi_inclusive):
                return False
        return True


@dataclass
class ChunkBatch:
    """One chunk group's worth of projected columns."""

    values: dict[str, np.ndarray]
    validity: dict[str, Optional[np.ndarray]]  # None = all valid
    row_count: int
    stripe_file: str
    chunk_index: int
    # first row's offset within the stripe (position addressing for DML)
    chunk_row_offset: int = 0


class ShardReader:
    """Reads one shard directory written by ShardWriter."""

    def __init__(self, directory: str, schema: Schema):
        from citus_tpu_torch.storage.overlay import visible_meta
        self.directory = directory
        self.schema = schema
        self.meta = visible_meta(directory)

    @property
    def row_count(self) -> int:
        return self.meta["row_count"]

    @property
    def stripe_files(self) -> list[str]:
        return [s["file"] for s in self.meta["stripes"]]

    def scan(
        self,
        columns: list[str],
        constraints: Optional[list[Interval]] = None,
        apply_deletes: bool = True,
        only_stripes: Optional[set] = None,
    ) -> Iterator[ChunkBatch]:
        """Yield chunk batches for the projected ``columns``, skipping
        chunks refuted by ``constraints`` (conjunctive semantics) and
        subtracting deletion bitmaps (unless ``apply_deletes=False``,
        used by DML that needs original row positions).  ``only_stripes``
        restricts to a stripe-file subset (index-lookup fallback)."""
        from citus_tpu_torch.storage.deletes import deleted_mask
        from citus_tpu_torch.storage.overlay import visible_deletes
        constraints = constraints or []
        for col in columns:
            self.schema.scan_column(col)  # validate projection
        delete_cache = visible_deletes(self.directory) if apply_deletes else {}
        for stripe in self.meta["stripes"]:
            if only_stripes is not None and stripe["file"] not in only_stripes:
                continue
            path = os.path.join(self.directory, stripe["file"])
            footer = read_stripe_footer(path)
            selected = self._selected_chunks(footer, constraints)
            try:
                from citus_tpu_torch.executor.executor import GLOBAL_COUNTERS
                GLOBAL_COUNTERS.bump("chunks_total", footer.chunk_count)
                GLOBAL_COUNTERS.bump("chunks_selected", int(selected.sum()))
                # rows refuted by footer min/max BEFORE any stream bytes
                # of theirs are read or decompressed — the fused hot
                # loop's admission win
                skipped = int(np.asarray(
                    footer.chunk_row_counts)[~selected].sum())
                if skipped:
                    GLOBAL_COUNTERS.bump("fused_rows_skipped", skipped)
            except ImportError:
                pass
            if not selected.any():
                continue
            offsets = np.concatenate([[0], np.cumsum(footer.chunk_row_counts)[:-1]])
            del_mask = None
            if apply_deletes and stripe["file"] in delete_cache:
                del_mask = deleted_mask(self.directory, stripe["file"],
                                        footer.row_count, delete_cache)
            sel_idx = [int(i) for i in np.nonzero(selected)[0]]
            native = self._scan_stripe_native(path, footer, columns, sel_idx)
            if native is not None:
                for b in native:
                    b.chunk_row_offset = int(offsets[b.chunk_index])
                    yield self._subtract_deletes(b, del_mask)
                continue
            with open(path, "rb") as fh:
                for ci in sel_idx:
                    vals, valid = {}, {}
                    for col in columns:
                        c = self.schema.scan_column(col)
                        stream = footer.columns.get(
                            self.schema.scan_storage_name(col))
                        if stream is None:
                            # column added after this stripe: all NULL
                            n_ = footer.chunk_row_counts[ci]
                            vals[col] = np.zeros(n_, c.type.storage_dtype)
                            valid[col] = np.zeros(n_, bool)
                            continue
                        v, m = read_chunk(fh, footer, stream[ci], c.type.storage_dtype)
                        vals[col], valid[col] = v, m
                    b = ChunkBatch(
                        values=vals, validity=valid,
                        row_count=footer.chunk_row_counts[ci],
                        stripe_file=stripe["file"], chunk_index=ci,
                        chunk_row_offset=int(offsets[ci]))
                    yield self._subtract_deletes(b, del_mask)

    def lookup_eq(
        self,
        columns: list[str],
        column: str,
        value,
        constraints: Optional[list[Interval]] = None,
    ) -> Iterator[ChunkBatch]:
        """Index-driven point lookup: yield batches holding ONLY the rows
        whose ``column`` equals ``value`` (live rows; deletes applied).
        Stripes without a segment fall back to a pruned full scan —
        never wrong, just slower (reference analog: an index scan over
        columnar random row access, columnar_reader.c:370-391)."""
        from citus_tpu_torch.storage.deletes import deleted_mask
        from citus_tpu_torch.storage.index import positions_eq
        from citus_tpu_torch.storage.overlay import visible_deletes
        try:
            from citus_tpu_torch.executor.executor import GLOBAL_COUNTERS
        except ImportError:
            GLOBAL_COUNTERS = None
        delete_cache = visible_deletes(self.directory)
        fallback: set = set()
        for stripe in self.meta["stripes"]:
            pos = positions_eq(self.directory, stripe["file"], column, value)
            if pos is None:
                fallback.add(stripe["file"])
                continue
            path = os.path.join(self.directory, stripe["file"])
            footer = read_stripe_footer(path)
            if GLOBAL_COUNTERS is not None:
                GLOBAL_COUNTERS.bump("index_lookups")
                GLOBAL_COUNTERS.bump("chunks_total", footer.chunk_count)
            if pos.size == 0:
                continue
            if stripe["file"] in delete_cache:
                dm = deleted_mask(self.directory, stripe["file"],
                                  footer.row_count, delete_cache)
                if dm is not None:
                    pos = pos[~dm[pos]]
                    if pos.size == 0:
                        continue
            bounds = np.concatenate([[0], np.cumsum(footer.chunk_row_counts)])
            chunk_of = np.searchsorted(bounds, pos, "right") - 1
            needed = np.unique(chunk_of)
            if GLOBAL_COUNTERS is not None:
                GLOBAL_COUNTERS.bump("chunks_selected", int(needed.size))
            with open(path, "rb") as fh:
                for ci in needed:
                    local = np.sort(pos[chunk_of == ci]) - bounds[ci]
                    vals, valid = {}, {}
                    for col in columns:
                        c = self.schema.scan_column(col)
                        stream = footer.columns.get(
                            self.schema.scan_storage_name(col))
                        if stream is None:
                            # column added after this stripe: all NULL
                            vals[col] = np.zeros(local.size, c.type.storage_dtype)
                            valid[col] = np.zeros(local.size, bool)
                            continue
                        v, m = read_chunk(fh, footer, stream[int(ci)],
                                          c.type.storage_dtype)
                        vals[col] = v[local]
                        valid[col] = None if m is None else m[local]
                    yield ChunkBatch(values=vals, validity=valid,
                                     row_count=int(local.size),
                                     stripe_file=stripe["file"],
                                     chunk_index=int(ci))
        if fallback:
            yield from self.scan(columns, constraints,
                                 only_stripes=fallback)

    @staticmethod
    def _subtract_deletes(b: ChunkBatch, del_mask) -> ChunkBatch:
        if del_mask is None:
            return b
        sl = del_mask[b.chunk_row_offset:b.chunk_row_offset + b.row_count]
        if not sl.any():
            return b
        keep = ~sl
        b.values = {c: v[keep] for c, v in b.values.items()}
        b.validity = {c: (m[keep] if m is not None else None)
                      for c, m in b.validity.items()}
        b.row_count = int(keep.sum())
        return b

    def _scan_stripe_native(self, path, footer, columns, sel_idx):
        """Batched read+decompress of all selected streams of one stripe
        through the C++ runtime (one call per column); None = unavailable."""
        from citus_tpu_torch.native import CODEC_IDS, get_lib
        lib = get_lib()
        if lib is None or footer.codec not in CODEC_IDS:
            return None
        import ctypes
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        cid = CODEC_IDS[footer.codec]
        # one native call per stripe: every (column, chunk) value stream
        streams = []  # (col, k, stats)
        missing = []  # columns added after this stripe was written
        for col in columns:
            sname = self.schema.scan_storage_name(col)
            if sname not in footer.columns:
                missing.append(col)
                continue
            for k, ci in enumerate(sel_idx):
                streams.append((col, k, footer.columns[sname][ci]))
        offs = np.array([s.value_offset for _, _, s in streams], np.int64)
        clens = np.array([s.value_length for _, _, s in streams], np.int64)
        rlens = np.array([s.value_raw_length for _, _, s in streams], np.int64)
        dsts = np.concatenate([[0], np.cumsum(rlens)[:-1]]).astype(np.int64)
        total = int(rlens.sum())
        out = np.empty(max(total, 1), np.uint8)
        if len(streams) >= 8:
            # thread-pooled read+decompress (each worker owns a file
            # handle + scratch) — saturates cold-scan bandwidth
            nt = decode_thread_count()
            rc = lib.ct_read_streams_mt(
                path.encode(), cid, len(streams),
                offs.ctypes.data_as(i64p), clens.ctypes.data_as(i64p),
                rlens.ctypes.data_as(i64p), dsts.ctypes.data_as(i64p),
                out.ctypes.data_as(u8p), max(total, 1), nt)
        else:
            scratch = np.empty(max(int(clens.max(initial=0)), 1), np.uint8)
            rc = lib.ct_read_streams(
                path.encode(), cid, len(streams),
                offs.ctypes.data_as(i64p), clens.ctypes.data_as(i64p),
                rlens.ctypes.data_as(i64p), dsts.ctypes.data_as(i64p),
                out.ctypes.data_as(u8p), max(total, 1),
                scratch.ctypes.data_as(u8p), len(scratch))
        if rc != 0:
            return None  # fall back to the python reader
        per_col_vals: dict[str, list] = {c: [None] * len(sel_idx) for c in columns}
        per_col_valid: dict[str, list] = {c: [None] * len(sel_idx) for c in columns}
        for si, (col, k, s) in enumerate(streams):
            dt = self.schema.scan_column(col).type.storage_dtype
            arr = out[dsts[si]:dsts[si] + rlens[si]].view(dt)
            if arr.shape[0] != s.row_count:
                return None
            per_col_vals[col][k] = arr
        for col in missing:
            dt = self.schema.scan_column(col).type.storage_dtype
            for k, ci in enumerate(sel_idx):
                n_ = footer.chunk_row_counts[ci]
                per_col_vals[col][k] = np.zeros(n_, dt)
                per_col_valid[col][k] = np.zeros(n_, bool)
        # validity streams (usually few; read individually)
        null_streams = [(col, k, footer.columns[self.schema.scan_storage_name(col)][ci])
                        for col in columns if col not in missing
                        for k, ci in enumerate(sel_idx)
                        if footer.columns[self.schema.scan_storage_name(col)][ci].has_nulls]
        if null_streams:
            from citus_tpu_torch.storage import compression as comp
            with open(path, "rb") as fh:
                for col, k, s in null_streams:
                    fh.seek(s.exists_offset)
                    braw = comp.decompress(fh.read(s.exists_length),
                                           footer.codec, s.exists_raw_length)
                    bits = np.frombuffer(braw, np.uint8)
                    unpacked = np.empty(s.row_count, np.uint8)
                    lib.ct_unpack_bits(
                        bits.ctypes.data_as(u8p), s.row_count,
                        unpacked.ctypes.data_as(u8p))
                    per_col_valid[col][k] = unpacked.astype(bool)
        out_batches = []
        for k, ci in enumerate(sel_idx):
            out_batches.append(ChunkBatch(
                values={c: per_col_vals[c][k] for c in columns},
                validity={c: per_col_valid[c][k] for c in columns},
                row_count=footer.chunk_row_counts[ci],
                stripe_file=os.path.basename(path), chunk_index=ci))
        return out_batches

    def chunk_counts(self, constraints: Optional[list[Interval]] = None) -> tuple[int, int]:
        """(selected_chunks, total_chunks) — for EXPLAIN/statistics."""
        sel = tot = 0
        for stripe in self.meta["stripes"]:
            footer = read_stripe_footer(os.path.join(self.directory, stripe["file"]))
            mask = self._selected_chunks(footer, constraints or [])
            sel += int(mask.sum())
            tot += footer.chunk_count
        return sel, tot

    def _selected_chunks(self, footer, constraints: list[Interval]) -> np.ndarray:
        mask = np.ones(footer.chunk_count, dtype=bool)
        for c in constraints:
            try:
                sname = self.schema.scan_storage_name(c.column)
            except AnalysisError:
                sname = c.column
            chunks = footer.columns.get(sname)
            if chunks is None:
                # column added after this stripe: every row is NULL there,
                # so no range constraint can match
                mask[:] = False
                return mask
            for ci, stats in enumerate(chunks):
                if not mask[ci]:
                    continue
                if stats.row_count == stats.null_count:
                    mask[ci] = False  # all null: no row can match a range
                    continue
                if not c.admits(stats.minimum, stats.maximum):
                    mask[ci] = False
        return mask
