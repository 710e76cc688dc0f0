"""Metadata sync engine: query-from-any-node catalog convergence.

Reference: Citus MX ships the distributed catalog to every node so any
of them can plan and route (metadata_sync.c, start_metadata_sync_to_node
/ citus_activate_node); pg_dist_* rows stream over the existing libpq
connections rather than a bespoke channel.  Here the same shape rides
the framework's own planes: the authority answers a cheap per-object
version vector over the control plane, and a coordinator that finds
itself behind pulls exactly the divergent objects as a CTFR frame over
the data-plane codec — pull-on-mismatch, not push-to-all, so an idle
coordinator costs one vector fetch per interval.

Convergence invariant: applying a pulled object is idempotent (the
object is keyed and content-hashed, so re-applying after a crash is a
no-op against the committed document) and ordered only by the vector
diff, never by arrival — a coordinator killed mid-apply restarts,
diffs again, and lands on the same document.  Writes never happen
here: every catalog mutation still arbitrates through the authority's
2PC flip (transaction/branches.py), this engine only propagates the
outcome.
"""

from __future__ import annotations

import hashlib
import json
import threading
from typing import Optional

import numpy as np

from citus_tpu_torch.net.data_plane import encode_frame, decode_frame
from citus_tpu_torch.stats import begin_wait, end_wait
from citus_tpu_torch.testing.faults import FAULTS

#: consecutive divergent sync rounds before the flight recorder raises
#: the metadata_sync_lag health event (one round of divergence is the
#: normal DDL-then-converge rhythm, three in a row means this
#: coordinator cannot catch the authority)
SYNC_LAG_ROUNDS = 3

#: dict-valued catalog sections the engine may write object-by-object;
#: anything the authority advertises outside this set is ignored (a
#: newer build's section never half-applies into an older build)
DICT_SECTIONS = frozenset((
    "schemas", "views", "sequences", "roles", "grants", "functions",
    "types", "enum_columns", "policies", "rls", "triggers", "ts_configs",
    "extensions", "domain_columns", "domains", "collations",
    "publications", "statistics", "rollups", "tenant_quotas",
    "priority_classes",
))


def _counters():
    from citus_tpu_torch.executor.executor import GLOBAL_COUNTERS
    return GLOBAL_COUNTERS


def _obj_hash(obj) -> str:
    """Content hash of one catalog object (the vector entry).  The
    canonical JSON form is what ships on the wire, so hash equality is
    exactly wire equality."""
    blob = json.dumps(obj, sort_keys=True, default=str).encode()
    return hashlib.sha1(blob).hexdigest()[:16]


def version_vector(doc: dict) -> dict:
    """Per-object version vector of a catalog document: one entry per
    catalog object, keyed ``section/name``, valued by content hash.
    Two coordinators with equal vectors hold byte-identical catalogs;
    a mismatch names exactly the objects to pull."""
    vec: dict[str, str] = {}
    for sec, data in doc.items():
        if sec == "format_version":
            continue
        if sec == "tables":
            for td in data:
                vec[f"tables/{td['name']}"] = _obj_hash(td)
        elif sec == "nodes":
            for nd in data:
                vec[f"nodes/{nd['node_id']}"] = _obj_hash(nd)
        elif sec in ("next_shard_id", "next_colocation_id"):
            # id allocators are scalars, not named objects; they ratchet
            vec[f"allocators/{sec}"] = _obj_hash(data)
        elif sec in DICT_SECTIONS:
            for name, obj in data.items():
                vec[f"{sec}/{name}"] = _obj_hash(obj)
    return vec


def objects_to_frame(objects: dict) -> bytes:
    """Pack pulled catalog objects into one CTFR frame (a single uint8
    column holding canonical JSON) so metadata rides the same
    data-plane codec as tuples."""
    payload = json.dumps(objects, sort_keys=True, default=str).encode()
    return encode_frame(
        {"metadata_json": np.frombuffer(payload, dtype=np.uint8)})


def frame_to_objects(blob: bytes) -> dict:
    arrs = decode_frame(blob)
    return json.loads(bytes(arrs["metadata_json"]))


# ---- authority side (RPC handlers, via net/control_plane.py) ----------

def authority_versions(cluster) -> dict:
    """metadata_versions RPC: the authority's current version vector.
    Cheap enough to answer every poll — export under the catalog lock,
    no disk merge (commits already merged foreign state)."""
    cat = cluster.catalog
    with cat._lock:
        doc = cat.export_document()
        epoch = cat.ddl_epoch
    return {"vector": version_vector(doc), "ddl_epoch": epoch}


def serve_metadata_pull(cluster, payload: dict):
    """metadata_pull RPC: ship the requested catalog objects as one
    CTFR frame.  Objects that vanished between the vector fetch and the
    pull are simply absent — the puller's next round sees them as gone."""
    keys = [str(k) for k in payload.get("keys", [])]
    cat = cluster.catalog
    with cat._lock:
        doc = cat.export_document()
    tables = {td["name"]: td for td in doc.get("tables", [])}
    nodes = {str(nd["node_id"]): nd for nd in doc.get("nodes", [])}
    objects: dict[str, object] = {}
    for key in keys:
        sec, _, name = key.partition("/")
        if sec == "tables":
            obj = tables.get(name)
        elif sec == "nodes":
            obj = nodes.get(name)
        elif sec == "allocators":
            obj = doc.get(name)
        elif sec in DICT_SECTIONS:
            obj = doc.get(sec, {}).get(name)
        else:
            obj = None
        if obj is not None:
            objects[key] = obj
    blob = objects_to_frame(objects)
    return {"count": len(objects), "bytes": len(blob)}, blob


# ---- coordinator side -------------------------------------------------

class MetadataSync:
    """Per-cluster sync engine: an interval loop (flight-recorder
    lifecycle) plus an inline pull-on-mismatch path the statement-start
    catalog check can invoke.  All state is derived from the committed
    catalog, so the engine itself is restart-free."""

    def __init__(self, cluster):
        self._cluster = cluster
        self._mu = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # consecutive rounds that found divergence (under _mu); crossing
        # SYNC_LAG_ROUNDS raises metadata_sync_lag, convergence resolves
        self._lag_rounds = 0

    # -- lifecycle (mirrors observability/flight_recorder.py) ----------

    def apply(self) -> None:
        """Start or stop the loop to match the GUCs
        (citus.enable_metadata_sync x citus.metadata_sync_interval_ms);
        called at attach and from SET."""
        s = self._cluster.settings.metadata
        attached = (self._cluster._control is not None
                    and self._cluster._control.client is not None)
        if (s.enable_metadata_sync and s.metadata_sync_interval_ms > 0
                and attached):
            self.start()
        else:
            self.stop()

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="metadata-sync", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._thread = None

    def _loop(self) -> None:
        while not self._stop.is_set():
            interval = self._cluster.settings.metadata.metadata_sync_interval_ms
            if interval <= 0:
                return
            if self._stop.wait(interval / 1000.0):
                return
            try:
                self.sync_once()
            except Exception:  # lint: disable=SWL01 -- a failed round (authority restarting, transient socket error) must not kill the loop; the next tick retries and the lag counter surfaces persistent failure
                self._note_diverged(0)

    # -- sync rounds ----------------------------------------------------

    def local_vector(self) -> dict:
        cat = self._cluster.catalog
        with cat._lock:
            doc = cat.export_document()
        return version_vector(doc)

    def sync_once(self) -> int:
        """One pull-on-mismatch round against the authority: fetch its
        vector, pull divergent objects, apply.  Returns the number of
        objects applied or retired (0 = already converged)."""
        control = self._cluster._control
        if control is None or control.client is None:
            return 0
        token = begin_wait("metadata_sync")
        try:
            remote = control.metadata_versions() or {}
        finally:
            end_wait(token)
        _counters().bump("metadata_sync_rounds")
        rvec = remote.get("vector", {})
        lvec = self.local_vector()
        stale = sorted(k for k, h in rvec.items() if lvec.get(k) != h)
        gone = sorted(k for k in lvec
                      if k not in rvec and not k.startswith("allocators/"))
        if not stale and not gone:
            self._note_converged()
            return 0
        objects: dict = {}
        if stale:
            token = begin_wait("metadata_sync")
            try:
                _result, blob = control.metadata_pull(stale)
            finally:
                end_wait(token)
            if blob:
                _counters().bump("metadata_sync_bytes", len(blob))
                objects = frame_to_objects(blob)
        # Kill-matrix fault point: a coordinator dying HERE holds a
        # pulled-but-unapplied batch; on restart the vector diff names
        # the same objects and the apply below is idempotent.
        FAULTS.hit("metadata_sync_apply",
                   context=f"{len(stale)} stale {len(gone)} gone")
        applied = self._apply(objects, gone)
        self._note_diverged(len(stale) + len(gone))
        return applied

    def _apply(self, objects: dict, gone: list) -> int:
        """Install pulled objects and retire vanished ones under the
        catalog lock, then invalidate the derived state (plan cache,
        tenant registry) exactly like a full reload would."""
        from citus_tpu_torch.catalog.catalog import NodeMeta, TableMeta
        cat = self._cluster.catalog
        touched_tenants = False
        with cat._lock:
            for key, obj in objects.items():
                sec, _, name = key.partition("/")
                if sec == "tables":
                    cat.tables[name] = TableMeta.from_json(obj)
                elif sec == "nodes":
                    try:
                        cat.nodes[int(name)] = NodeMeta.from_json(obj)
                    except (TypeError, ValueError):
                        continue
                elif sec == "allocators":
                    # allocators only ratchet forward; never adopt a
                    # smaller id space than we already handed out
                    if name == "next_shard_id":
                        cat._next_shard_id = max(
                            cat._next_shard_id, int(obj))
                    elif name == "next_colocation_id":
                        cat._next_colocation_id = max(
                            cat._next_colocation_id, int(obj))
                elif sec in DICT_SECTIONS:
                    getattr(cat, sec)[name] = obj
                    if sec in ("tenant_quotas", "priority_classes"):
                        touched_tenants = True
            for key in gone:
                sec, _, name = key.partition("/")
                if sec == "tables":
                    cat.tables.pop(name, None)
                elif sec == "nodes":
                    try:
                        cat.nodes.pop(int(name), None)
                    except (TypeError, ValueError):
                        continue
                elif sec in DICT_SECTIONS:
                    getattr(cat, sec).pop(name, None)
                    if sec in ("tenant_quotas", "priority_classes"):
                        touched_tenants = True
            # drop dictionary-encoding caches exactly like a full
            # reload: a pulled table may reference newer dict pages
            cat._dicts = {}
            cat._dict_index = {}
            cat._dict_sig = {}
            cat.ddl_epoch += 1
        self._cluster._plan_cache.clear()
        if touched_tenants:
            from citus_tpu_torch.metadata.quotas import hydrate_tenant_registry
            hydrate_tenant_registry(cat)
        return len(objects) + len(gone)

    def pull_on_mismatch(self) -> bool:
        """Statement-start convergence hook: try one incremental round
        instead of the full document fetch.  False means the caller
        falls back to the full reload."""
        if not self._cluster.settings.metadata.enable_metadata_sync:
            return False
        control = self._cluster._control
        if control is None or control.client is None:
            return False
        try:
            self.sync_once()
            return True
        except Exception:  # lint: disable=SWL01 -- the incremental path is an optimization over the full-document reload; on any failure the caller takes that fallback
            return False

    # -- lag accounting -------------------------------------------------

    def _note_converged(self) -> None:
        with self._mu:
            was = self._lag_rounds
            self._lag_rounds = 0
        if was >= SYNC_LAG_ROUNDS:
            rec = getattr(self._cluster, "flight_recorder", None)
            if rec is not None:
                rec.resolve_event("metadata_sync_lag", "authority")

    def _note_diverged(self, n_objects: int) -> None:
        with self._mu:
            self._lag_rounds += 1
            lag = self._lag_rounds
        if lag >= SYNC_LAG_ROUNDS:
            rec = getattr(self._cluster, "flight_recorder", None)
            if rec is not None:
                rec.emit_event(
                    "metadata_sync_lag", "authority", float(lag),
                    float(SYNC_LAG_ROUNDS),
                    f"{n_objects} catalog objects still divergent after "
                    f"{lag} consecutive sync rounds")
