"""Cross-host bulk data plane: shard files, ingest batches and pushed
worker tasks over RPC.

Reference: the JAX package's ``citus_tpu/net/data_plane.py``, itself the
analog of Citus moving shard bytes between nodes over libpq —
COPY-protocol file transfer (executor/transmit.c), task results as COPY
streams (worker/worker_sql_task_protocol.c).  Every coordinator that
*hosts* shard placements runs a DataPlaneServer; peers reach it through
the endpoint advertised in the node catalog (the pg_dist_node
nodename/nodeport analog) and move bytes as binary RPC frames — no
shared filesystem required.

The CTFR frame codec, the batch/partial/hash-partial encodings and the
RPC methods are byte-compatible with the JAX package's, so a
``citus_tpu`` node and a ``citus_tpu_torch`` node serve each other.
Stripe files are immutable-append, so the reader side caches them by
name and only re-fetches the small mutable files (shard meta, deletion
bitmaps, index segments) per sync.  A forwarded statement
(``execute_sql``), a cross-host modify's branch (``dml_prepare``,
``dml_decide``) and an interactive transaction's branch session
(``txn_stmt``, ``txn_branch_prepare``, ``txn_branch_abort``) run here
with the reference's payloads, so the two packages' coordinators run one
two-phase commit together.
"""

from __future__ import annotations

import io
import json
import os
import struct
import threading
from typing import Optional

import numpy as np

from citus_tpu_torch.errors import ExecutionError
from citus_tpu_torch.net.rpc import RpcClient, RpcError, RpcServer

#: fetch_file chunk size — one RPC round-trip per chunk
CHUNK_BYTES = 4 << 20

# (mutability rule: stripe .cts files are immutable once visible and
# cached forever; every other placement file — meta, deletes, index
# segments — re-fetches when its size/mtime signature moves.  See
# sync_placement.)


def _npz_bytes(arrays: dict) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _npz_load(blob: bytes) -> dict:
    # never allow_pickle: batches are physical (numeric) arrays, and a
    # pickle in a network frame would be remote code execution
    with np.load(io.BytesIO(blob), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


# ---------------------------------------------------------------------
# Zero-copy columnar wire frame ("CTFR", Arrow-style fixed-width).
#
# Layout (all integers little-endian):
#   preamble   b"CTFR" + <B version> + 3 pad + <I ncols>      (12 bytes)
#   directory  per column: <H name_len> + utf8 name
#              + <B dtype_code> + <B ndim> + ndim * <Q dim>
#              + <Q buffer_offset> + <Q buffer_nbytes>
#   buffers    raw little-endian array bytes, each 64-byte aligned
#
# The receiver decodes with np.frombuffer views over the ONE contiguous
# blob — no per-column copy, no zip container, no Python loop over
# elements.  Validity bitmaps travel as ordinary bool columns under the
# same m__ prefix encode_batch already uses.  The dtype table is an
# allowlist: anything outside it (or any malformed offset) raises
# FrameError — decode never falls back to pickle.

FRAME_MAGIC = b"CTFR"
FRAME_VERSION = 1
_FRAME_ALIGN = 64

_FRAME_DTYPES = {
    0: np.dtype(np.bool_),
    1: np.dtype(np.int8), 2: np.dtype(np.int16),
    3: np.dtype(np.int32), 4: np.dtype(np.int64),
    5: np.dtype(np.uint8), 6: np.dtype(np.uint16),
    7: np.dtype(np.uint32), 8: np.dtype(np.uint64),
    9: np.dtype(np.float32), 10: np.dtype(np.float64),
}
_FRAME_CODES = {dt: code for code, dt in _FRAME_DTYPES.items()}


class FrameError(ValueError):
    """Blob is not a well-formed columnar frame (bad magic/version/
    dtype/offset or truncated)."""


def encode_frame(arrays: dict) -> bytes:
    """Encode named fixed-width arrays as one contiguous frame."""
    cols = []
    for name, v in arrays.items():
        a = np.asarray(v)
        if not a.flags.c_contiguous:
            # (ascontiguousarray only off the fast path: it would also
            # promote 0-d scalars to 1-d, changing partial shapes)
            a = np.ascontiguousarray(a)
        dt = a.dtype.newbyteorder("=")
        if dt not in _FRAME_CODES:
            raise FrameError(f"column {name!r}: dtype {a.dtype} has no "
                             f"frame encoding")
        if a.dtype.byteorder == ">":
            a = a.astype(a.dtype.newbyteorder("<"))
        cols.append((name.encode(), _FRAME_CODES[dt], a))
    parts = [FRAME_MAGIC,
             struct.pack("<BxxxI", FRAME_VERSION, len(cols))]
    # directory size is knowable up front, so buffer offsets (absolute
    # into the blob) are computed in the same pass
    dir_len = sum(2 + len(nm) + 2 + 8 * a.ndim + 16
                  for nm, _code, a in cols)
    off = len(FRAME_MAGIC) + 8 + dir_len
    bufs = []
    for nm, code, a in cols:
        pad = (-off) % _FRAME_ALIGN
        if pad:
            bufs.append(b"\x00" * pad)
            off += pad
        parts.append(struct.pack("<H", len(nm)) + nm)
        parts.append(struct.pack("<BB", code, a.ndim))
        for dim in a.shape:
            parts.append(struct.pack("<Q", dim))
        parts.append(struct.pack("<QQ", off, a.nbytes))
        if a.nbytes:  # memoryview can't cast zero-sized shapes
            bufs.append(memoryview(a).cast("B"))
        off += a.nbytes
    return b"".join(parts + bufs)


def decode_frame(blob: bytes) -> dict:
    """Decode a frame into {name: np.ndarray}, every array a READ-ONLY
    np.frombuffer view into ``blob`` — zero host copy."""
    mv = memoryview(blob)
    try:
        if bytes(mv[:4]) != FRAME_MAGIC:
            raise FrameError("bad frame magic")
        version, ncols = struct.unpack_from("<BxxxI", mv, 4)
        if version != FRAME_VERSION:
            raise FrameError(f"unsupported frame version {version}")
        out = {}
        pos = 12
        for _ in range(ncols):
            (name_len,) = struct.unpack_from("<H", mv, pos)
            pos += 2
            name = bytes(mv[pos:pos + name_len]).decode()
            if len(name.encode()) != name_len:
                raise FrameError("truncated column name")
            pos += name_len
            code, ndim = struct.unpack_from("<BB", mv, pos)
            pos += 2
            dt = _FRAME_DTYPES.get(code)
            if dt is None:
                raise FrameError(f"unknown dtype code {code}")
            shape = struct.unpack_from("<" + "Q" * ndim, mv, pos)
            pos += 8 * ndim
            off, nbytes = struct.unpack_from("<QQ", mv, pos)
            pos += 16
            count = 1
            for dim in shape:
                count *= dim
            if count * dt.itemsize != nbytes or off + nbytes > len(mv):
                raise FrameError(f"column {name!r}: bad buffer bounds")
            out[name] = np.frombuffer(
                mv[off:off + nbytes], dtype=dt.newbyteorder("<")
            ).reshape(shape)
        return out
    except struct.error as e:
        raise FrameError(f"truncated frame: {e}") from e
    except UnicodeDecodeError as e:
        raise FrameError(f"bad column name: {e}") from e


def _bump_wire(name: str, by: int) -> None:
    from citus_tpu_torch.executor.executor import GLOBAL_COUNTERS
    GLOBAL_COUNTERS.bump(name, by)


def _encode_arrays(arrays: dict, wire: str) -> bytes:
    """Encode by the session's citus.wire_format; a dtype the frame
    can't express (none today on the physical-encoded paths) falls back
    to npz rather than failing the query."""
    if wire == "frame":
        try:
            return encode_frame(arrays)
        except FrameError:
            pass
    return _npz_bytes(arrays)


def _decode_arrays(blob: bytes) -> dict:
    """Magic-sniffing decode: both codecs are always accepted, so mixed
    citus.wire_format settings across a cluster interoperate."""
    if blob[:4] == FRAME_MAGIC:
        _bump_wire("wire_frame_bytes", len(blob))
        return decode_frame(blob)
    _bump_wire("wire_npz_bytes", len(blob))
    return _npz_load(blob)


def encode_batch(values: dict, validity: dict,
                 wire: str = "frame") -> bytes:
    """Batches cross the wire PHYSICAL-encoded (text already mapped to
    table-global dictionary ids by the sending coordinator), so every
    array is plain numeric — no pickle on either side."""
    arrays = {}
    for c, v in values.items():
        a = np.asarray(v)
        if a.dtype == object:
            raise TypeError(
                f"column {c!r} is not physical-encoded (object dtype)")
        arrays[f"v__{c}"] = a
    for c, m in validity.items():
        arrays[f"m__{c}"] = np.asarray(m, dtype=bool)
    return _encode_arrays(arrays, wire)


def decode_batch(blob: bytes) -> tuple[dict, dict]:
    arrays = _decode_arrays(blob)
    values = {k[3:]: v for k, v in arrays.items() if k.startswith("v__")}
    validity = {k[3:]: v for k, v in arrays.items() if k.startswith("m__")}
    return values, validity


def encode_partials(partials, wire: str = "frame") -> bytes:
    """Encode a worker task's partial-agg state tuple (positional
    arrays) for the wire."""
    return _encode_arrays(
        {f"a__{i}": np.asarray(x) for i, x in enumerate(partials)}, wire)


def decode_partials(blob: bytes) -> tuple:
    arrays = _decode_arrays(blob)
    return tuple(arrays[f"a__{i}"] for i in range(len(arrays)))


def encode_hash_partials(table, spilled, wire: str = "frame") -> bytes:
    """hash_host GROUP BY partial state for the wire (TASK_VERSION 3):
    the worker's merged device hash table — key value tables, int8 key
    flags (1 = stored null, 2 = stored valid), partial tables, per-slot
    row counts — under ``hk__/hkf__/hp__/hr__`` keys, plus the
    host-exact spilled entries (rendered back from the accumulator)
    under ``xk__/xkf__/xp__/xr__``.  Either half may be None: cpu-backend
    workers ship spill-only frames, empty shards ship neither."""
    arrays: dict = {}

    def put(kp, fp, pp, rk, entries):
        keys, partials, rows = entries
        for i, (kv, kf) in enumerate(keys):
            arrays[f"{kp}{i}"] = np.asarray(kv)
            arrays[f"{fp}{i}"] = np.asarray(kf, np.int8)
        for j, p in enumerate(partials):
            arrays[f"{pp}{j}"] = np.asarray(p)
        arrays[rk] = np.asarray(rows, np.int64)

    if table is not None:
        put("hk__", "hkf__", "hp__", "hr__", table)
    if spilled is not None:
        put("xk__", "xkf__", "xp__", "xr__", spilled)
    return _encode_arrays(arrays, wire)


def decode_hash_partials(blob: bytes):
    """Inverse of encode_hash_partials -> (table | None, spilled | None),
    each ``([(key_vals, key_flags)...], partials tuple, rows)``."""
    arrays = _decode_arrays(blob)

    def grab(kp, fp, pp, rk):
        if rk not in arrays:
            return None
        keys = []
        while f"{kp}{len(keys)}" in arrays:
            i = len(keys)
            keys.append((arrays[f"{kp}{i}"], arrays[f"{fp}{i}"]))
        partials = []
        while f"{pp}{len(partials)}" in arrays:
            partials.append(arrays[f"{pp}{len(partials)}"])
        return keys, tuple(partials), arrays[rk]

    return (grab("hk__", "hkf__", "hp__", "hr__"),
            grab("xk__", "xkf__", "xp__", "xr__"))


def sketch_words_to_arrays(name: str, words) -> dict:
    """Pack a column of sketch words (``"kind:ver:b64"`` strings, or None
    for SQL NULL) into fixed-width arrays under the existing frame dtype
    allowlist: one uint8 payload blob, int64 end-offsets, and a bool
    validity mask.  Sketch words are pure ASCII by construction
    (types.py validates the envelope), so no text dictionary is needed —
    the column stays self-contained on the wire."""
    blobs = [b"" if w is None else str(w).encode("ascii") for w in words]
    ends = np.cumsum([len(b) for b in blobs], dtype=np.int64) \
        if blobs else np.zeros(0, dtype=np.int64)
    payload = np.frombuffer(b"".join(blobs), dtype=np.uint8)
    valid = np.array([w is not None for w in words], dtype=bool)
    return {f"sk__{name}": payload, f"sko__{name}": ends,
            f"skm__{name}": valid}


def arrays_to_sketch_words(arrays: dict, name: str) -> list:
    """Inverse of sketch_words_to_arrays -> list of Optional[str]."""
    payload = np.asarray(arrays[f"sk__{name}"], dtype=np.uint8)
    ends = np.asarray(arrays[f"sko__{name}"], dtype=np.int64)
    valid = np.asarray(arrays[f"skm__{name}"], dtype=bool)
    if ends.shape[0] != valid.shape[0]:
        raise FrameError(f"sketch column {name!r}: offsets/validity "
                         f"length mismatch")
    if ends.shape[0] and int(ends[-1]) != payload.shape[0]:
        raise FrameError(f"sketch column {name!r}: payload length "
                         f"mismatch")
    raw = payload.tobytes()
    out, start = [], 0
    for i in range(ends.shape[0]):
        end = int(ends[i])
        out.append(raw[start:end].decode("ascii") if valid[i] else None)
        start = end
    return out


#: ``ingest_batch`` refuses a batch with rows of a shard this
#: coordinator no longer hosts (a move flipped it away after the sender
#: routed the batch); the sender re-routes them
PLACEMENT_MOVED = "placement moved"
#: a remote write-group lock: the longest wait for it (under the RPC
#: socket's 10 s timeout) and its lease, after which the peer releases
#: it unasked (a mover that died must not block writers for good)
GROUP_LOCK_WAIT_MAX_S = 8.0
GROUP_LOCK_LEASE_S = 120.0


def _bump_pool_error() -> None:
    """Count a swallowed data-plane failure (failed close/rollback or an
    unreachable peer on a best-effort path).  These paths deliberately
    keep going — the counter is how the swallow stays visible in SHOW
    STATS and the Prometheus exporter instead of vanishing."""
    from citus_tpu_torch.executor.executor import GLOBAL_COUNTERS
    GLOBAL_COUNTERS.bump("data_plane_pool_errors")


#: the RPC methods that carry a statement for the peer to run
_STATEMENT_METHODS = frozenset({"execute_sql", "dml_prepare", "txn_stmt"})


class DataPlaneServer:
    """Serves this coordinator's locally-hosted placements."""

    def __init__(self, cluster, port: int = 0,
                 secret: Optional[bytes] = None,
                 bind_host: str = "127.0.0.1"):
        self.cluster = cluster
        # bind_host "0.0.0.0" for genuinely cross-machine deployments
        # (the advertised register_node host must then be routable);
        # loopback default keeps single-machine clusters unexposed
        self.server = RpcServer(host=bind_host, port=port, secret=secret)
        s = self.server
        s.register("ping", lambda p: {"ok": True})
        s.register("list_placement", self._on_list_placement)
        s.register("fetch_file", self._on_fetch_file)
        s.register("pull_placement_bundle", self._on_pull_placement_bundle)
        s.register("put_file", self._on_put_file)
        s.register("ingest_batch", self._on_ingest_batch)
        s.register("drop_placement", self._on_drop_placement)
        s.register("lock_group", self._on_lock_group)
        s.register("unlock_group", self._on_unlock_group)
        s.register("execute_sql", self._on_execute_sql)
        s.register("execute_task", self._on_execute_task)
        s.register("dml_prepare", self._on_dml_prepare)
        s.register("dml_decide", self._on_dml_decide)
        s.register("txn_stmt", self._on_txn_stmt)
        s.register("txn_branch_prepare", self._on_txn_branch_prepare)
        s.register("txn_branch_abort", self._on_txn_branch_abort)
        s.register("get_node_stats", self._on_get_node_stats)
        # open cross-host transaction branches:
        # gxid -> {"s": Session, "born": monotonic, "prepared": bool,
        # "mu": Lock}, made before connections are accepted (an early
        # dml_prepare must find them)
        self._branches: dict = {}
        self._branches_mu = threading.Lock()
        # write-group locks held for a mover on another coordinator:
        # token -> (release event, holder thread, its state)
        self._group_locks: dict = {}
        s.start()

    @property
    def port(self) -> int:
        return self.server.port

    def _placement_dir(self, p: dict) -> str:
        cat = self.cluster.catalog
        return cat.shard_dir(str(p["table"]), int(p["shard_id"]),
                             int(p["node"]))

    def _on_get_node_stats(self, p: dict) -> dict:
        """One-payload local stat snapshot for the cluster fan-out
        (observability/cluster_stats.py)."""
        from citus_tpu_torch.observability.cluster_stats import local_node_stats
        return local_node_stats(self.cluster)

    def _on_list_placement(self, p: dict) -> dict:
        d = self._placement_dir(p)
        if not os.path.isdir(d):
            return {"exists": False, "files": []}
        files = []
        for n in sorted(os.listdir(d)):
            fp = os.path.join(d, n)
            try:
                if not os.path.isfile(fp):
                    continue
                st = os.stat(fp)
            except FileNotFoundError:
                continue  # removed by its writer since the listing
            files.append({"name": n, "size": st.st_size,
                          "mtime_ns": st.st_mtime_ns})
        return {"exists": True, "files": files}

    def _on_fetch_file(self, p: dict) -> tuple[dict, bytes]:
        d = self._placement_dir(p)
        name = str(p["name"])
        if "/" in name or name.startswith(".."):
            raise ValueError(f"bad file name {name!r}")
        off = int(p.get("offset", 0))
        with open(os.path.join(d, name), "rb") as fh:
            fh.seek(off)
            data = fh.read(CHUNK_BYTES)
            eof = fh.read(1) == b""
        return {"eof": eof, "offset": off, "n": len(data)}, data

    def _on_pull_placement_bundle(self, p: dict) -> tuple[dict, bytes]:
        """Ship many small placement files as ONE columnar frame (each
        file a uint8 column) — placement sync pays one RPC round-trip
        and one zero-copy decode instead of a fetch_file per file."""
        d = self._placement_dir(p)
        arrays = {}
        for name in p.get("names") or []:
            name = str(name)
            if "/" in name or name.startswith(".."):
                raise ValueError(f"bad file name {name!r}")
            with open(os.path.join(d, name), "rb") as fh:
                arrays[name] = np.frombuffer(fh.read(), dtype=np.uint8)
        return {"n": len(arrays)}, encode_frame(arrays)

    def _on_put_file(self, p: dict, blob: bytes) -> dict:
        """Receive one placement file (shard move push path).  Writes
        are staged to .part and renamed on the final chunk so a reader
        never sees a torn file."""
        d = self._placement_dir(p)
        if not int(p.get("offset", 0)):
            # a pushed placement lands where this coordinator's old one
            # may still wait for its deferred drop (ROADMAP.md C26)
            from citus_tpu_torch.operations.cleaner import claim_resource
            claim_resource(self.cluster.catalog, d)
        os.makedirs(d, exist_ok=True)
        name = str(p["name"])
        if "/" in name or name.startswith(".."):
            raise ValueError(f"bad file name {name!r}")
        part = os.path.join(d, name + ".part")
        mode = "ab" if int(p.get("offset", 0)) else "wb"
        with open(part, mode) as fh:
            fh.write(blob)
        if p.get("last", True):
            os.replace(part, os.path.join(d, name))
        return {"ok": True}

    def _on_ingest_batch(self, p: dict, blob: bytes) -> dict:
        """Ingest a physical-encoded batch whose rows all hash to
        shards this coordinator hosts (the remote half of a distributed
        COPY; reference: per-shard COPY streams to the owning worker,
        commands/multi_copy.c).  Runs a local 2PC through this
        coordinator's transaction log."""
        values, validity = decode_batch(blob)
        n = self.cluster._ingest_local_batch(str(p["table"]), values,
                                             validity)
        return {"inserted": n}

    def _on_execute_sql(self, p: dict) -> dict:
        """Run a forwarded statement on this coordinator (the owner of
        the statement's shards).  This IS the reference's model: the
        worker-facing RPC protocol is SQL itself (SURVEY §1: shard
        queries travel as SQL text over libpq).  The connection is
        HMAC-authenticated; like a PostgreSQL worker, an authenticated
        coordinator may run any statement."""
        guard = self.cluster._remote_exec_guard
        prev = getattr(guard, "v", False)
        guard.v = True  # a forwarded statement must never forward again
        try:
            r = self.cluster.execute(str(p["sql"]))
        finally:
            guard.v = prev
        return {"columns": r.columns,
                "rows": [list(row) for row in r.rows],
                "explain": {k: v for k, v in (r.explain or {}).items()
                            if isinstance(v, (int, float, str))}}

    def _on_execute_task(self, p: dict) -> tuple[dict, bytes]:
        """Run the worker half of a pushed SELECT against a placement
        this coordinator hosts and return the encoded partial states as
        one binary frame (reference: worker_sql_task_protocol.c — the
        task travels as a serialized plan fragment rather than SQL
        text, and results come back as one frame instead of a COPY
        stream).  See executor/worker_tasks.py for the codec.

        When the task carries a trace context ({trace_id, parent
        span_id} injected by the coordinator's RemoteTaskDispatch), the
        worker half records its own spans against that trace_id and
        ships them back in the meta — the coordinator grafts them under
        its remote_task span, so the query tree stays single-rooted
        across hosts."""
        from citus_tpu_torch.executor.worker_tasks import run_worker_task
        from citus_tpu_torch.observability import trace as _trace
        from citus_tpu_torch.testing.faults import FAULTS
        from citus_tpu_torch.workload import GLOBAL_SCHEDULER
        # fault point rides the per-connection SERVER thread: injected
        # delays on concurrent tasks overlap (as real slow workers do)
        # instead of serializing on the coordinator's dispatch loop
        FAULTS.hit("execute_task",
                   f"{p.get('table')}:{p.get('shard_id')}:{p.get('node')}")
        if p.get("tenant"):
            # book the pushed task against the originating tenant so
            # citus_stat_tenants() on THIS host shows who drove it
            GLOBAL_SCHEDULER.note_remote_task(str(p["tenant"]))
        guard = self.cluster._remote_exec_guard
        prev = getattr(guard, "v", False)
        guard.v = True  # a pushed task must never push again
        try:
            tctx = p.get("trace")
            if not isinstance(tctx, dict) or "trace_id" not in tctx:
                return run_worker_task(self.cluster, p)
            wt = _trace.Trace(trace_id=str(tctx["trace_id"]))
            root = wt.open_span(
                "execute_task", tctx.get("parent_span_id"),
                {"host": int(p.get("node", 0)),
                 "shard_id": int(p.get("shard_id", -1)),
                 "table": str(p.get("table", ""))})
            try:
                with _trace.activate(wt, root):
                    meta, blob = run_worker_task(self.cluster, p)
            finally:
                wt.close_span(root)
            root.set(rows=meta.get("n_rows", 0))
            spans = wt.export_spans()
            # every worker span renders on this host's process row
            for d in spans:
                d["attrs"].setdefault("host", int(p.get("node", 0)))
            meta["spans"] = spans
            return meta, blob
        finally:
            guard.v = prev

    #: a branch with no phase-2 decision resolves itself after this
    #: long (via the authority's outcome store; presumed abort)
    BRANCH_EXPIRE_S = 120.0

    def _run_in_branch(self, s, sql: str) -> dict:
        """Execute one statement inside a branch session with
        forwarded-statement (local placements only) semantics."""
        cl = self.cluster
        guard = cl._remote_exec_guard
        prev = getattr(guard, "v", False)
        guard.v = True
        try:
            return s.execute(sql)
        finally:
            guard.v = prev

    def _on_dml_prepare(self, p: dict) -> dict:
        """Phase 1 of a cross-host modify: run the forwarded statement
        against OUR placements inside an open transaction, then make
        the branch durable (PREPARED + gxid) while keeping its locks —
        PostgreSQL's PREPARE TRANSACTION, with the statement shipped as
        SQL like every worker task in the reference."""
        import time as _time
        gxid = str(p["gxid"])
        cl = self.cluster
        self._expire_stale_branches()
        s = cl.session()
        try:
            s.execute("BEGIN")
            r = self._run_in_branch(s, str(p["sql"]))
            cl._prepare_branch(s, gxid)
        except BaseException:
            if s.txn is not None:
                try:
                    s.execute("ROLLBACK")
                except Exception:
                    _bump_pool_error()
            raise
        with self._branches_mu:
            self._branches[gxid] = {"s": s, "born": _time.monotonic(),
                                    "prepared": True,
                                    "mu": threading.Lock()}
        return {"explain": {k: v for k, v in (r.explain or {}).items()
                            if isinstance(v, (int, float, str))}}

    def _on_txn_stmt(self, p: dict) -> dict:
        """One statement of an INTERACTIVE cross-host transaction: the
        branch session persists across RPCs (lazily opened with BEGIN)
        and stays un-prepared until txn_branch_prepare — the worker
        session of the reference's coordinated transaction."""
        import time as _time
        gxid = str(p["gxid"])
        self._expire_stale_branches()
        with self._branches_mu:
            entry = self._branches.get(gxid)
        if entry is None:
            s = self.cluster.session()
            s.execute("BEGIN")
            ours = {"s": s, "born": _time.monotonic(), "prepared": False,
                    "mu": threading.Lock()}
            # insert atomically: two first statements of the same gxid
            # racing here must converge on ONE branch session — the
            # loser rolls its session back instead of leaking an open
            # transaction (whose locks would block until process exit)
            with self._branches_mu:
                entry = self._branches.setdefault(gxid, ours)
            if entry is not ours:
                try:
                    s.execute("ROLLBACK")
                except Exception:
                    _bump_pool_error()
        with entry["mu"]:
            # re-check under the entry lock: the expiry duty resolves
            # branches under the same lock, so a statement can never
            # run on a session expiry just rolled back (it would
            # autocommit outside the transaction)
            with self._branches_mu:
                if self._branches.get(gxid) is not entry:
                    raise ExecutionError(
                        f"transaction branch {gxid} expired")
            r = self._run_in_branch(entry["s"], str(p["sql"]))
            entry["born"] = _time.monotonic()  # activity keeps it alive
        return {"explain": {k: v for k, v in (r.explain or {}).items()
                            if isinstance(v, (int, float, str))}}

    def _on_txn_branch_prepare(self, p: dict) -> dict:
        gxid = str(p["gxid"])
        with self._branches_mu:
            entry = self._branches.get(gxid)
        if entry is None:
            raise KeyError(f"no open branch for gxid {gxid}")
        self.cluster._prepare_branch(entry["s"], gxid)
        entry["prepared"] = True
        return {"ok": True}

    def _on_txn_branch_abort(self, p: dict) -> dict:
        gxid = str(p["gxid"])
        with self._branches_mu:
            entry = self._branches.pop(gxid, None)
        if entry is None:
            return {"ok": True}
        s = entry["s"]
        if entry["prepared"]:
            self.cluster._finish_branch(s, False)
        elif s.txn is not None:
            s.execute("ROLLBACK")
        return {"ok": True}

    def _on_dml_decide(self, p: dict) -> dict:
        gxid = str(p["gxid"])
        with self._branches_mu:
            entry = self._branches.pop(gxid, None)
        if entry is None:
            # already resolved (expiry raced the decide): report what
            # the durable outcome store decided so the coordinator can
            # detect divergence instead of assuming success
            outcome = None
            if self.cluster._control is not None:
                outcome = self.cluster._control.txn_outcome(gxid)
            return {"ok": False, "resolved": outcome}
        self.cluster._finish_branch(entry["s"], bool(p.get("commit")))
        return {"ok": True}

    def _expire_stale_branches(self) -> None:
        """Resolve branches whose coordinator never sent phase 2.

        PREPARED branches presume abort safely: the participant CLAIMS
        abort through the authority's first-writer-wins decision
        register — if the coordinator already recorded commit, the
        claim returns 'commit' and the branch commits; if the claim
        wins, any later coordinator commit gets 'abort' back and aborts
        everywhere.  An UNREACHABLE authority keeps a prepared branch
        (locks held — the blocking nature of 2PC).  UN-prepared
        interactive branches have no durable record and no vote: a
        plain ROLLBACK is always correct for them."""
        import time as _time
        if self.cluster._control is None:
            return
        now = _time.monotonic()
        with self._branches_mu:
            # un-prepared interactive branches idle out on a much longer
            # leash (user think-time is legitimate; activity refreshes
            # born), prepared ones on the 2PC window
            stale = [(g, e) for g, e in self._branches.items()
                     if now - e["born"] > (self.BRANCH_EXPIRE_S
                                           if e["prepared"]
                                           else 10 * self.BRANCH_EXPIRE_S)]
        for gxid, entry in stale:
            with entry["mu"]:
                if not entry["prepared"]:
                    # re-check age under the lock: a statement may have
                    # refreshed the branch while we waited
                    if _time.monotonic() - entry["born"] \
                            <= 10 * self.BRANCH_EXPIRE_S:
                        continue
                    with self._branches_mu:
                        if self._branches.pop(gxid, None) is None:
                            continue
                    s = entry["s"]
                    if s.txn is not None:
                        try:
                            s.execute("ROLLBACK")
                        except Exception:
                            _bump_pool_error()
                    continue
                try:
                    winner = self.cluster._control.record_txn_outcome(
                        gxid, "abort")
                except Exception:
                    _bump_pool_error()
                    continue  # authority unreachable: keep the branch
                with self._branches_mu:
                    if self._branches.pop(gxid, None) is None:
                        continue  # a decide raced us; already resolved
                self.cluster._finish_branch(entry["s"],
                                            winner == "commit")

    def expire_branches(self) -> None:
        """Maintenance-daemon duty: resolve abandoned branches even when
        no further RPC ever arrives (a branch must not hold its write
        locks forever because its coordinator died)."""
        self._expire_stale_branches()

    def _on_drop_placement(self, p: dict) -> dict:
        """Deferred-drop a placement directory after its shard moved
        away (reference: pg_dist_cleanup deferred source drop)."""
        from citus_tpu_torch.operations.cleaner import (
            DEFERRED_ON_SUCCESS, record_cleanup,
        )
        d = self._placement_dir(p)
        if os.path.isdir(d):
            record_cleanup(self.cluster.catalog, d, DEFERRED_ON_SUCCESS)
        return {"ok": True}

    def _on_lock_group(self, p: dict) -> dict:
        """Hold this coordinator's write lock of a table's colocation
        group for a shard move run by another coordinator, from its
        final catch-up to its flip: a writer here cannot commit a stripe
        to the source placement that the move's last pull misses.  The
        lock is held by a thread of its own until ``unlock_group`` or
        the end of the lease; before it lets writers in, this
        coordinator re-reads the catalog, so they route by the flip."""
        import uuid

        from citus_tpu_torch.transaction.write_locks import group_write_lock
        cl = self.cluster
        cl._maybe_reload_catalog(force_sync=True)
        t = cl.catalog.table(str(p["table"]))
        acquired, release = threading.Event(), threading.Event()
        state: dict = {"error": None, "unlocked": False}

        def hold() -> None:
            try:
                with group_write_lock(cl.catalog, t, str(p["mode"]),
                                      lock_manager=cl.locks,
                                      timeout=float(p["wait_s"])):
                    acquired.set()
                    state["unlocked"] = release.wait(float(p["lease_s"]))
                    cl._reload_catalog()
            except BaseException as e:  # noqa: BLE001 -- reported to the mover
                state["error"] = e
                acquired.set()
        th = threading.Thread(target=hold, daemon=True,
                              name="citus-tpu-group-lock")
        th.start()
        acquired.wait()
        if state["error"] is not None:
            th.join()
            raise state["error"]
        token = uuid.uuid4().hex
        with self._branches_mu:
            self._group_locks[token] = (release, th, state)
        return {"token": token}

    def _on_unlock_group(self, p: dict) -> dict:
        """Release a lock taken by ``lock_group``; ``held`` is false when
        its lease had already ended."""
        with self._branches_mu:
            entry = self._group_locks.pop(str(p["token"]), None)
        if entry is None:
            return {"held": False}
        release, th, state = entry
        release.set()
        th.join()
        return {"held": bool(state["unlocked"])}

    def stop(self) -> None:
        self.server.stop()
        with self._branches_mu:
            held = list(self._group_locks.values())
            self._group_locks.clear()
        for release, th, _state in held:
            release.set()
            th.join()


class DataPlaneClient:
    """Connection pool to peer coordinators' data servers, plus the
    remote placement cache (reads) and transfer helpers (moves)."""

    #: idle pooled connections kept per endpoint (beyond the primary);
    #: excess checkins close rather than hoard sockets
    POOL_IDLE_MAX = 8

    def __init__(self, cat, secret: Optional[bytes] = None):
        self.cat = cat
        self.secret = secret
        self._conns: dict[tuple, RpcClient] = {}
        # per-endpoint idle connections for CONCURRENT RPCs to one peer
        # (RpcClient serializes on its socket; the adaptive executor's
        # parallel dispatch needs one socket per in-flight task, like
        # the reference's per-worker connection pools)
        self._idle: dict[tuple, list] = {}
        self._lock = threading.Lock()
        # the single selector-driven dispatcher for concurrent RPCs
        # (net/event_loop.py), created on first use
        self._loop = None
        # statements_forwarded: the statements this coordinator sent a
        # peer to run (execute_sql, dml_prepare, txn_stmt)
        self.stats = {"files_fetched": 0, "bytes_fetched": 0,
                      "batches_shipped": 0, "remote_syncs": 0,
                      "statements_forwarded": 0}
        # per-table data-invalidation epoch plus per-placement sync
        # tokens: a mirror whose token still equals the table's epoch
        # (and whose invalidation stream is live, see
        # ``invalidation_fresh``) is proven current and can skip the
        # list_placement round trip entirely (placement_sync_elided)
        self._sync_epochs: dict[str, int] = {}
        self._sync_tokens: dict[tuple, int] = {}
        # set by the Cluster to a zero-arg probe answering "is the
        # control-plane invalidation stream trusted right now?"; while
        # None (or returning False) every sync pays the full RTT
        self.invalidation_fresh = None

    def event_loop(self):
        """The shared RpcEventLoop for this client (lazily started)."""
        from citus_tpu_torch.net.event_loop import RpcEventLoop
        with self._lock:
            if self._loop is None:
                self._loop = RpcEventLoop(secret=self.secret)
            return self._loop

    def evict_endpoint(self, endpoint: tuple) -> None:
        """Drop every pooled/primary/loop connection to a dead endpoint
        so the next call reconnects instead of inheriting a socket the
        peer already closed (the stat fan-out calls this when a node
        stops answering get_node_stats)."""
        key = (str(endpoint[0]), int(endpoint[1]))
        dead = []
        with self._lock:
            dead.extend(self._idle.pop(key, []))
            for k in [k for k in self._conns
                      if (str(k[0]), int(k[1])) == key]:
                dead.append(self._conns.pop(k))
            loop = self._loop
        for c in dead:
            try:
                c.close()
            except Exception:
                _bump_pool_error()
        if loop is not None:
            loop.evict_endpoint(key)

    def _conn(self, endpoint: tuple) -> RpcClient:
        with self._lock:
            c = self._conns.get(endpoint)
        if c is not None:
            return c
        # connect OUTSIDE the pool lock: one dead peer's connect timeout
        # must not stall calls to every healthy endpoint
        c = RpcClient(endpoint[0], int(endpoint[1]), secret=self.secret)
        with self._lock:
            existing = self._conns.get(endpoint)
            if existing is not None:
                # lost the race: keep the winner's connection
                try:
                    c.close()
                except Exception:
                    _bump_pool_error()
                return existing
            self._conns[endpoint] = c
            return c

    def _drop_conn(self, endpoint: tuple) -> None:
        with self._lock:
            c = self._conns.pop(endpoint, None)
        if c is not None:
            try:
                c.close()
            except Exception:
                _bump_pool_error()

    def call(self, endpoint: tuple, method: str, payload: dict,
             blob: Optional[bytes] = None) -> dict:
        if method in _STATEMENT_METHODS:
            self.stats["statements_forwarded"] += 1
        try:
            return self._conn(endpoint).call(method, payload, blob=blob)
        except RpcError:
            self._drop_conn(endpoint)
            raise

    def call_binary(self, endpoint: tuple, method: str, payload: dict):
        try:
            return self._conn(endpoint).call_binary(method, payload)
        except RpcError:
            self._drop_conn(endpoint)
            raise

    def call_binary_pooled(self, endpoint: tuple, method: str,
                           payload: dict, blob: Optional[bytes] = None):
        """Like call_binary, but on a checked-out pooled connection so
        concurrent calls to the SAME endpoint each get their own socket
        (the primary connection serializes).  Failed connections are
        closed, never returned to the pool."""
        key = (endpoint[0], int(endpoint[1]))
        with self._lock:
            idle = self._idle.get(key)
            c = idle.pop() if idle else None
        if c is None:
            # connect outside the lock, same rationale as _conn
            try:
                c = RpcClient(key[0], key[1], secret=self.secret)
            except OSError:
                # the endpoint refuses connections: its parked idle
                # siblings are stale too — evict rather than hand a
                # dead socket to the next caller
                self.evict_endpoint(key)
                raise
        try:
            out = c.call_binary(method, payload, blob)
        except BaseException:
            try:
                c.close()
            except Exception:
                _bump_pool_error()
            raise
        with self._lock:
            idle = self._idle.setdefault(key, [])
            if len(idle) < self.POOL_IDLE_MAX:
                idle.append(c)
                c = None
        if c is not None:
            try:
                c.close()
            except Exception:
                _bump_pool_error()
        return out

    # ---- read path -----------------------------------------------------
    def cache_dir(self, table: str, shard_id: int, node: int) -> str:
        return os.path.join(self.cat.data_dir, ".remote_cache", table,
                            str(shard_id), str(node))

    def fetch_file(self, endpoint: tuple, spec: dict, dst: str) -> None:
        from citus_tpu_torch.stats import begin_wait, end_wait
        tmp = dst + ".part"
        off = 0
        # the whole chunk loop is one remote_rpc wait: the caller is
        # blocked on peer network/disk until the file lands
        wtok = begin_wait("remote_rpc")
        try:
            with open(tmp, "wb") as fh:
                while True:
                    r, data = self.call_binary(
                        endpoint, "fetch_file", dict(spec, offset=off))
                    fh.write(data or b"")
                    off += len(data or b"")
                    self.stats["bytes_fetched"] += len(data or b"")
                    if r.get("eof", True):
                        break
        finally:
            end_wait(wtok)
        os.replace(tmp, dst)
        self.stats["files_fetched"] += 1

    def fetch_bundle(self, endpoint: tuple, base: dict, names: list,
                     dst_dir: str) -> None:
        """Fetch many small placement files as ONE frame RPC through
        the event loop (each file a uint8 column), writing them
        atomically in the given order.  Raises RpcError/FrameError on
        failure — callers fall back to per-file fetch_file."""
        from citus_tpu_torch.stats import begin_wait, end_wait
        fut = self.event_loop().submit(
            endpoint, "pull_placement_bundle", dict(base, names=list(names)))
        wtok = begin_wait("remote_rpc")
        try:
            _r, blob = fut.result()
        finally:
            end_wait(wtok)
        arrays = decode_frame(blob or b"")
        _bump_wire("wire_frame_bytes", len(blob or b""))
        for name in names:
            a = arrays[name]
            dst = os.path.join(dst_dir, name)
            tmp = dst + ".part"
            with open(tmp, "wb") as fh:
                fh.write(memoryview(a))
            os.replace(tmp, dst)
            self.stats["bytes_fetched"] += a.nbytes
            self.stats["files_fetched"] += 1

    def _fetch_one(self, endpoint: tuple, base: dict, name: str,
                   dst_dir: str, skip_vanished: bool) -> bool:
        """fetch_file; False when ``skip_vanished`` and the source's
        writer removed the file after it was listed."""
        try:
            self.fetch_file(endpoint, dict(base, name=name),
                            os.path.join(dst_dir, name))
        except RpcError as e:
            if skip_vanished and "No such file or directory" in str(e):
                try:
                    os.remove(os.path.join(dst_dir, name) + ".part")
                except FileNotFoundError:
                    pass
                return False
            raise
        return True

    def _fetch_many(self, endpoint: tuple, base: dict, needed: list,
                    dst_dir: str, skip_vanished: bool = False):
        """Fetch (name, tag, size) triples in order: small files
        coalesce into bundle RPCs (≤ CHUNK_BYTES of payload each),
        large files stream chunked through fetch_file, and a failed
        bundle (old peer, truncated frame) degrades to per-file
        fetches.  Yields each triple once its file is on disk; with
        ``skip_vanished`` a file removed since the listing is passed
        over (a live placement's side files come and go)."""
        i = 0
        while i < len(needed):
            if needed[i][2] >= CHUNK_BYTES:
                if self._fetch_one(endpoint, base, needed[i][0], dst_dir,
                                   skip_vanished):
                    yield needed[i]
                i += 1
                continue
            group, total = [], 0
            while i < len(needed) and needed[i][2] < CHUNK_BYTES \
                    and (not group or total + needed[i][2] <= CHUNK_BYTES):
                group.append(needed[i])
                total += needed[i][2]
                i += 1
            if len(group) > 1:
                try:
                    self.fetch_bundle(endpoint, base,
                                      [n for n, _t, _z in group], dst_dir)
                    yield from group
                    continue
                except (RpcError, FrameError, KeyError, OSError):
                    _bump_pool_error()  # visible; per-file path below
            for g in group:
                if self._fetch_one(endpoint, base, g[0], dst_dir,
                                   skip_vanished):
                    yield g

    def sync_placement(self, table: str, shard_id: int, node: int,
                       endpoint: tuple) -> Optional[str]:
        """Mirror a remote placement into the local cache; returns the
        local directory (None when the remote placement does not
        exist).  Immutable stripe files are fetched once; mutable files
        (meta, deletes, index segments) re-fetch when size/mtime moved.

        A mirror already proven current — synced at the table's present
        data epoch, with the control-plane invalidation stream still
        attached — skips even the list_placement round trip (the
        ``placement_sync_elided`` counter tracks the saved RTTs)."""
        d = self.cache_dir(table, shard_id, node)
        with self._lock:
            epoch = self._sync_epochs.get(table, 0)
            token = self._sync_tokens.get((table, shard_id, node))
        fresh = self.invalidation_fresh
        if (token == epoch and fresh is not None and fresh()
                and os.path.isfile(os.path.join(d, ".sync.json"))):
            from citus_tpu_torch.executor.executor import GLOBAL_COUNTERS
            GLOBAL_COUNTERS.bump("placement_sync_elided")
            return d
        r = self.call(endpoint, "list_placement",
                      {"table": table, "shard_id": shard_id, "node": node})
        if not r.get("exists"):
            return None
        self.stats["remote_syncs"] += 1
        bytes_before = self.stats["bytes_fetched"]
        os.makedirs(d, exist_ok=True)
        sig_path = os.path.join(d, ".sync.json")
        try:
            with open(sig_path) as fh:
                sigs = json.load(fh)
        except (OSError, ValueError):
            sigs = {}
        remote_names = set()
        needed = []
        for f in r["files"]:
            name = f["name"]
            remote_names.add(name)
            local = os.path.join(d, name)
            sig = [f["size"], f["mtime_ns"]]
            immutable = name.endswith(".cts")
            if os.path.exists(local) and (
                    immutable or sigs.get(name) == sig):
                continue
            needed.append((name, sig, int(f.get("size", 0))))
        base = {"table": table, "shard_id": shard_id, "node": node}
        for name, sig, _sz in self._fetch_many(endpoint, base, needed, d):
            sigs[name] = sig
        # a file deleted remotely (deletes cleared, meta rewritten by
        # VACUUM/TRUNCATE) must disappear from the mirror too
        for name in list(os.listdir(d)):
            if name.startswith(".sync") or name.endswith(".part"):
                continue
            if name not in remote_names:
                try:
                    os.remove(os.path.join(d, name))
                except OSError:
                    pass
                sigs.pop(name, None)
        with open(sig_path + ".tmp", "w") as fh:
            json.dump(sigs, fh)
        os.replace(sig_path + ".tmp", sig_path)
        from citus_tpu_torch.executor.executor import GLOBAL_COUNTERS
        GLOBAL_COUNTERS.bump("placement_sync_bytes",
                             self.stats["bytes_fetched"] - bytes_before)
        # record the epoch captured BEFORE the list_placement RPC: a
        # write invalidating mid-sync bumps the epoch past this token,
        # so the next sync pays the RTT again (no lost-update window)
        with self._lock:
            self._sync_tokens[(table, shard_id, node)] = epoch
        return d

    # ---- transfer helpers (shard move) ---------------------------------
    def pull_placement(self, table: str, shard_id: int, src_node: int,
                       endpoint: tuple, dst_dir: str) -> int:
        """Copy every file of a remote placement into ``dst_dir``
        (the over-the-wire half of citus_move_shard_placement's bulk
        phase; reference: shard_transfer.c:472).  Returns stripe bytes
        actually fetched this pass — a move's catch-up loop re-runs the
        pull per round and uses the delta as its lag proxy, so stripes
        already complete at the destination (same name AND same size:
        stripes are immutable, but a killed earlier pass can leave a
        short .part-promoted truncation) are skipped, not re-shipped."""
        r = self.call(endpoint, "list_placement",
                      {"table": table, "shard_id": shard_id,
                       "node": src_node})
        if not r.get("exists"):
            return 0
        os.makedirs(dst_dir, exist_ok=True)
        from citus_tpu_torch.storage.writer import SHARD_META
        # meta file last: a crash mid-pull leaves a readable placement
        sizes = {f["name"]: int(f.get("size", 0)) for f in r["files"]}
        names = sorted(sizes)
        names.sort(key=lambda n: n == SHARD_META)
        needed = []
        for name in names:
            if name.endswith((".tmp", ".part")):
                # a file the source's writer is still writing: it is
                # renamed when done, and the next pass ships it (the
                # reference fetches it and fails when it is gone)
                continue
            dst = os.path.join(dst_dir, name)
            if name.endswith(".cts") and os.path.exists(dst) \
                    and os.path.getsize(dst) == sizes[name]:
                continue  # complete immutable stripe from an earlier pass
            needed.append((name, None, sizes[name]))
        stripe_bytes = 0
        base = {"table": table, "shard_id": shard_id, "node": src_node}
        # a file its writer removed since the listing (a transaction's
        # staged side file at its commit) is passed over: the meta file,
        # fetched last, names what is live
        from citus_tpu_torch.services.background_jobs import report_progress
        for name, _tag, sz in self._fetch_many(endpoint, base, needed,
                                               dst_dir, skip_vanished=True):
            if name.endswith(".cts"):
                # stripe bytes shipped feed the owning move's progress
                # record (no-op outside a background task)
                report_progress(add_bytes=sz)
                stripe_bytes += sz
        return stripe_bytes

    def push_placement(self, src_dir: str, table: str, shard_id: int,
                       dst_node: int, endpoint: tuple) -> None:
        from citus_tpu_torch.storage.writer import SHARD_META
        names = sorted(n for n in os.listdir(src_dir)
                       if os.path.isfile(os.path.join(src_dir, n))
                       and not n.endswith(".part"))
        names.sort(key=lambda n: n == SHARD_META)
        for name in names:
            path = os.path.join(src_dir, name)
            size = os.path.getsize(path)
            off = 0
            with open(path, "rb") as fh:
                while True:
                    data = fh.read(CHUNK_BYTES)
                    last = off + len(data) >= size
                    self.call(endpoint, "put_file",
                              {"table": table, "shard_id": shard_id,
                               "node": dst_node, "name": name,
                               "offset": off, "last": last}, blob=data)
                    off += len(data)
                    if last:
                        break

    # ---- write path ----------------------------------------------------
    def ship_batch(self, endpoint: tuple, table: str, values: dict,
                   validity: dict, wire: str = "frame") -> int:
        """Send a physical sub-batch to the coordinator hosting its
        shards, on a socket of its own: the peer's ingest may wait for
        its write lock, which a shard move holds while it calls the
        same peer."""
        r, _ = self.call_binary_pooled(
            endpoint, "ingest_batch", {"table": table},
            blob=encode_batch(values, validity, wire))
        self.stats["batches_shipped"] += 1
        return int(r.get("inserted", 0))

    def lock_group(self, endpoint: tuple, table: str, mode: str,
                   wait_s: float) -> Optional[str]:
        """Take the peer's write lock of ``table``'s colocation group
        (``DataPlaneServer._on_lock_group``); -> its token, or None from
        a ``citus_tpu`` peer, which has no such call (ROADMAP.md C27).
        The wait stays under the socket's 10 s timeout."""
        try:
            r, _ = self.call_binary_pooled(
                endpoint, "lock_group",
                {"table": table, "mode": mode,
                 "wait_s": min(wait_s, GROUP_LOCK_WAIT_MAX_S),
                 "lease_s": GROUP_LOCK_LEASE_S})
        except RpcError as e:
            if "unknown method 'lock_group'" in str(e):
                return None
            raise
        return str(r["token"])

    def unlock_group(self, endpoint: tuple, token: str) -> bool:
        """Release a ``lock_group`` lock; False when its lease ran out
        first."""
        return bool(self.call(endpoint, "unlock_group",
                              {"token": token}).get("held"))

    def drop_placement(self, endpoint: tuple, table: str, shard_id: int,
                       node: int) -> None:
        self.call(endpoint, "drop_placement",
                  {"table": table, "shard_id": shard_id, "node": node})

    def note_data_changed(self, table: str) -> None:
        """A committed write landed in this table somewhere in the
        cluster: every mirrored placement may now trail its source, so
        expire the elision tokens by bumping the table's data epoch."""
        with self._lock:
            self._sync_epochs[table] = self._sync_epochs.get(table, 0) + 1

    def invalidate_cache(self, table: str) -> None:
        import shutil
        d = os.path.join(self.cat.data_dir, ".remote_cache", table)
        shutil.rmtree(d, ignore_errors=True)
        self.note_data_changed(table)

    def close(self) -> None:
        with self._lock:
            conns = list(self._conns.values())
            self._conns.clear()
            for idle in self._idle.values():
                conns.extend(idle)
            self._idle.clear()
            loop, self._loop = self._loop, None
        for c in conns:
            try:
                c.close()
            except Exception:
                _bump_pool_error()
        if loop is not None:
            loop.close()
