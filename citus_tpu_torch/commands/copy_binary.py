"""COPY ... WITH (format binary): columnar batch frames instead of CSV.

Reference: commands/multi_copy.c forwards PostgreSQL's binary COPY
format between coordinator and shards (:552-); our on-the-wire batch
container (net/data_plane.py npz frames) doubles as the file format —
one serialization for both the DCN data plane and bulk import/export.

File layout: magic line ``CTPUBIN1 <json header>\\n`` (columns + type
spellings + row count per frame), then repeated ``<uint32 length><npz
batch>`` frames.  Numeric columns travel PHYSICAL (scaled decimals, day
/microsecond epochs — lossless and cheap); dictionary kinds (text/uuid/
bytea/arrays) travel as canonical WORDS, so a binary file is
self-contained and portable across clusters with different dictionary
id assignments (unlike raw ids)."""

from __future__ import annotations

import json
import struct

import numpy as np

from citus_tpu_torch.errors import AnalysisError, ExecutionError
from citus_tpu_torch.net.data_plane import _npz_bytes, _npz_load

MAGIC = b"CTPUBIN1"

#: rows per frame (a frame decompresses as one unit)
FRAME_ROWS = 262_144


def copy_to_binary(cl, table_name: str, path: str) -> int:
    from citus_tpu_torch.executor.batches import load_shard_batches
    from citus_tpu_torch.planner.bind import bind_select
    from citus_tpu_torch.planner import ast as A
    from citus_tpu_torch.planner.physical import plan_select

    t = cl.catalog.table(table_name)
    names = t.schema.names
    sel = A.Select([A.SelectItem(A.ColumnRef(c)) for c in names],
                   A.TableRef(table_name))
    bound = bind_select(cl.catalog, sel)
    plan = plan_select(cl.catalog, bound)
    total = 0
    header = {"columns": list(names),
              "types": [str(t.schema.column(c).type) for c in names]}
    with open(path, "wb") as fh:
        fh.write(MAGIC + b" " + json.dumps(header).encode() + b"\n")
        for si in plan.shard_indexes:
            for values, masks, n in load_shard_batches(
                    cl.catalog, plan, si, max_batch_rows=FRAME_ROWS):
                arrays = {}
                for c in names:
                    ct = t.schema.column(c).type
                    if ct.is_text:
                        words = cl.catalog.decode_strings(
                            table_name, c, values[c].tolist())
                        # nulls carry an empty word; validity restores
                        arrays[f"v__{c}"] = np.asarray(
                            [w if (m and w is not None) else ""
                             for w, m in zip(words, masks[c])], dtype=str)
                    elif ct.kind == "uuid":
                        # lanes recombine to canonical words: the file
                        # stays portable and format-compatible
                        from citus_tpu_torch import types as T
                        lane = values[T.uuid_lane_name(c)]
                        arrays[f"v__{c}"] = np.asarray(
                            [T.uuid_from_lane_pair(int(h), int(l)) if m
                             else "" for h, l, m in
                             zip(values[c], lane, masks[c])], dtype=str)
                    else:
                        arrays[f"v__{c}"] = values[c]
                    arrays[f"m__{c}"] = np.asarray(masks[c], bool)
                blob = _npz_bytes(arrays)
                fh.write(struct.pack(">I", len(blob)) + blob)
                total += n
    return total


def copy_from_binary(cl, table_name: str, path: str) -> int:
    t = cl.catalog.table(table_name)
    total = 0
    with open(path, "rb") as fh:
        head = fh.readline()
        if not head.startswith(MAGIC + b" "):
            raise AnalysisError(
                f"{path!r} is not a citus_tpu binary COPY file")
        header = json.loads(head[len(MAGIC) + 1:])
        cols = header["columns"]
        missing = [c for c in t.schema.names if c not in cols]
        if missing:
            raise AnalysisError(
                f"binary file lacks column(s) {missing} of "
                f'"{table_name}"')
        while True:
            lb = fh.read(4)
            if not lb:
                break
            if len(lb) != 4:
                raise ExecutionError(f"truncated binary COPY file {path!r}")
            (n,) = struct.unpack(">I", lb)
            blob = fh.read(n)
            if len(blob) != n:
                raise ExecutionError(f"truncated binary COPY file {path!r}")
            arrays = _npz_load(blob)
            columns = {}
            for c in t.schema.names:
                ct = t.schema.column(c).type
                v = arrays[f"v__{c}"]
                m = np.asarray(arrays[f"m__{c}"], bool)
                if ct.is_text or ct.kind == "uuid":
                    columns[c] = [w if ok else None
                                  for w, ok in zip(v.tolist(), m)]
                elif m.all():
                    # all-valid numerics stay physical: the ingest fast
                    # path adopts integer arrays without re-conversion
                    columns[c] = v
                else:
                    columns[c] = [ct.from_physical(x) if ok else None
                                  for x, ok in zip(v.tolist(), m)]
            total += cl.copy_from(table_name, columns=columns)
    return total
