"""Coordinator control plane over RPC.

Reference mapping (metadata/metadata_sync.c, transaction/
worker_transaction.c): one coordinator process acts as the metadata
authority ("first worker node"); peers register, receive catalog-change
invalidations over a push channel, and exchange in-flight transaction
sets so 2PC recovery never adopts a live peer's transactions — the RPC
generalization of the single-host flock liveness probe.

Transport split (SURVEY §5.8): the catalog *document* travels over RPC
— peers fetch it from the authority on invalidation (fetch_catalog) and
commit by pushing the merged document back (push_catalog) under a
cluster-wide DDL lease the authority grants (the serialization the
reference gets from running metadata changes inside the coordinator's
2PC).  The shared data directory remains the transport for bulk shard
data and dictionary side files, and the degenerate fallback when no
authority is reachable.
"""

from __future__ import annotations

import json
import os
import threading
import time
from citus_tpu_torch.utils.clock import now as wall_now
import uuid
from contextlib import contextmanager
from typing import Optional

from citus_tpu_torch.net.rpc import RpcClient, RpcError, RpcServer

# DDL lease time-to-live: a crashed holder's lease expires after this
# many seconds (renewed implicitly by re-acquiring); generous compared
# to a metadata commit (~ms) but short enough to bound DDL outage
DDL_LEASE_TTL_S = 10.0

#: shared-FS advertisement of the current metadata authority — the
#: promotion arbiter (the role a DCS plays for Patroni; reference:
#: operations/node_promotion.c promotes a secondary into the metadata
#: writer role)
AUTHORITY_FILE = ".authority.json"


class ControlPlane:
    """One coordinator's view of the control plane: optionally a server
    (the metadata authority) and/or a client connection to one."""

    def __init__(self, cluster, serve_port: Optional[int] = None,
                 coordinator: Optional[tuple] = None,
                 secret: Optional[bytes] = None):
        self.cluster = cluster
        self.secret = secret
        self.origin = uuid.uuid4().hex[:12]
        self.server: Optional[RpcServer] = None
        self.client: Optional[RpcClient] = None
        # peers' last reported in-flight xid sets (server side)
        self._peer_inflight: dict[str, list[int]] = {}
        self._lock = threading.Lock()
        # cluster-wide DDL lease (authority side): serializes catalog
        # commits from every coordinator; expires so a crashed holder
        # cannot wedge DDL forever
        self._lease_holder: Optional[str] = None
        self._lease_expires = 0.0
        # serializes failover attempts within this process (maintenance
        # duty vs explicit calls)
        self._failover_mu = threading.Lock()
        self.stats = {"fetch_catalog": 0, "push_catalog": 0,
                      "lease_acquired": 0, "lease_contended": 0,
                      "metadata_versions": 0, "metadata_pull": 0}
        if serve_port is not None:
            self.server = RpcServer(port=serve_port, secret=secret)
            self._register_handlers()
            self.server.start()
            self._write_authority_file()
        # push channel liveness: when it dies (coordinator gone), the
        # cluster falls back to mtime polling for invalidations
        self.push_alive = False
        if coordinator is not None:
            host, port = coordinator
            self.client = RpcClient(host, int(port), secret=secret)
            self.client.call("ping")
            self.push_alive = True
            self.client.subscribe(self._on_event, on_close=self._on_push_closed)

    def _register_handlers(self) -> None:
        self.server.register("ping", lambda p: {"ok": True})
        self.server.register("catalog_changed", self._on_catalog_changed)
        self.server.register("data_changed", self._on_data_changed)
        self.server.register("report_inflight", self._on_report_inflight)
        self.server.register("cluster_inflight", self._on_cluster_inflight)
        self.server.register("tx_event", self._on_tx_event)
        self.server.register("ddl_lease", self._on_ddl_lease)
        self.server.register("fetch_catalog", self._on_fetch_catalog)
        self.server.register("push_catalog", self._on_push_catalog)
        self.server.register("fetch_dict", self._on_fetch_dict)
        self.server.register("grow_dict", self._on_grow_dict)
        self.server.register("record_txn_outcome", self._on_record_txn_outcome)
        self.server.register("txn_outcome", self._on_txn_outcome)
        self.server.register("get_node_stats", self._on_get_node_stats)
        self.server.register("metadata_versions", self._on_metadata_versions)
        self.server.register("metadata_pull", self._on_metadata_pull)

    def _on_get_node_stats(self, payload: dict) -> dict:
        """The authority's own stat snapshot (the same payload the
        data-plane servers expose; observability/cluster_stats.py)."""
        from citus_tpu_torch.observability.cluster_stats import local_node_stats
        return local_node_stats(self.cluster)

    # ---- server handlers ----------------------------------------------
    def _on_catalog_changed(self, payload: dict) -> dict:
        """A peer committed catalog metadata: invalidate locally and
        re-broadcast to every other subscriber."""
        if payload.get("origin") != self.origin:
            self.cluster._catalog_dirty = True
        self.server.broadcast({"event": "catalog_changed",
                               "origin": payload.get("origin")})
        return {"ok": True}

    def _on_data_changed(self, payload: dict) -> dict:
        """A peer committed a DATA write into a table: expire our
        placement-mirror elision tokens for it and re-broadcast so every
        other subscriber expires theirs (the invalidation stream behind
        placement_sync_elided)."""
        if payload.get("origin") != self.origin:
            self._note_data_changed(payload.get("table"))
        self.server.broadcast({"event": "data_changed",
                               "origin": payload.get("origin"),
                               "table": payload.get("table")})
        return {"ok": True}

    def _note_data_changed(self, table) -> None:
        rd = getattr(self.cluster.catalog, "remote_data", None)
        if rd is not None and table:
            rd.note_data_changed(str(table))

    def _on_report_inflight(self, payload: dict) -> dict:
        with self._lock:
            self._peer_inflight[payload.get("origin", "?")] = \
                [int(x) for x in payload.get("xids", [])]
        return {"ok": True}

    def _on_cluster_inflight(self, payload: dict) -> dict:
        """All in-flight xids known cluster-wide: ours + every peer's
        last report (the 2PC-recovery vote: don't touch these)."""
        xids = set(self.cluster.txlog.inflight())
        with self._lock:
            for lst in self._peer_inflight.values():
                xids.update(lst)
        return {"xids": sorted(xids)}

    def _on_tx_event(self, payload: dict) -> dict:
        """2PC state transitions reported by peers (observability +
        faster recovery adoption)."""
        return {"ok": True}

    # ---- catalog authority --------------------------------------------
    def _lease_try(self, origin: str) -> bool:
        with self._lock:
            now = time.monotonic()
            if (self._lease_holder in (None, origin)
                    or now >= self._lease_expires):
                self._lease_holder = origin
                self._lease_expires = now + DDL_LEASE_TTL_S
                self.stats["lease_acquired"] += 1
                return True
            self.stats["lease_contended"] += 1
            return False

    def _lease_release(self, origin: str) -> None:
        with self._lock:
            if self._lease_holder == origin:
                self._lease_holder = None

    def _on_ddl_lease(self, payload: dict) -> dict:
        origin = payload.get("origin", "?")
        if payload.get("action") == "release":
            self._lease_release(origin)
            return {"ok": True}
        return {"ok": self._lease_try(origin)}

    def _on_fetch_catalog(self, payload: dict) -> dict:
        """Serve the canonical catalog document.  Merge any foreign
        shared-FS writer's changes first so the served document is never
        behind the file (non-attached coordinators may still commit via
        the flock path)."""
        from citus_tpu_torch.catalog.catalog import _catalog_flock
        cat = self.cluster.catalog
        with cat._lock, _catalog_flock(cat.data_dir):
            cat._merge_foreign_locked()
            doc = cat.export_document()
        with self._lock:
            self.stats["fetch_catalog"] += 1
        return {"doc": doc}

    def _on_push_catalog(self, payload: dict) -> dict:
        """A lease-holding peer committed: store its merged document as
        canonical, refresh our own plan caches, and broadcast the
        invalidation to every other subscriber."""
        origin = payload.get("origin", "?")
        with self._lock:
            held = (self._lease_holder == origin
                    and time.monotonic() < self._lease_expires)
        if not held:
            raise RpcError(f"push_catalog from {origin} without the DDL lease")
        self.cluster.catalog.store_document(payload["doc"],
                                            payload.get("tombstones"))
        self.cluster._on_foreign_catalog_applied()
        with self._lock:
            self.stats["push_catalog"] += 1
        self.server.broadcast({"event": "catalog_changed", "origin": origin})
        return {"ok": True}

    # ---- metadata sync (pull-on-mismatch; metadata/sync.py) ------------
    # The authority serves its per-object version vector cheaply; a
    # stale peer diffs it against its own and pulls ONLY the mismatched
    # objects, shipped as one CTFR frame in the RPC's binary attachment
    # (the same framed channel the event-loop data plane speaks).

    def _on_metadata_versions(self, payload: dict) -> dict:
        from citus_tpu_torch.metadata.sync import authority_versions
        with self._lock:
            self.stats["metadata_versions"] += 1
        return authority_versions(self.cluster)

    def _on_metadata_pull(self, payload: dict):
        from citus_tpu_torch.metadata.sync import serve_metadata_pull
        with self._lock:
            self.stats["metadata_pull"] += 1
        return serve_metadata_pull(self.cluster, payload)

    def metadata_versions(self) -> Optional[dict]:
        """Client side: the authority's version vector + ddl_epoch, or
        None when not attached."""
        if self.client is None:
            return None
        return self.client.call("metadata_versions")

    def metadata_pull(self, keys: list) -> tuple:
        """Client side: (result, CTFR frame bytes) holding the
        requested objects."""
        if self.client is None:
            raise RpcError("not attached to a metadata authority")
        return self.client.call_binary("metadata_pull", {"keys": keys})

    # ---- dictionary authority ------------------------------------------
    # Text dictionaries are table-global id assignments; coordinators
    # without the shared data dir fetch them here and route growth
    # through the authority so two hosts can never assign one id to
    # different words (the invariant encode_strings' flock provides on
    # one host).
    def _on_fetch_dict(self, payload: dict) -> dict:
        cat = self.cluster.catalog
        table, column = str(payload["table"]), str(payload["column"])
        return {"words": cat.dictionary(table, column)}

    def _on_grow_dict(self, payload: dict) -> dict:
        cat = self.cluster.catalog
        table, column = str(payload["table"]), str(payload["column"])
        fresh = [str(w) for w in payload.get("words", [])]
        # encode through the authority's own (flock-serialized) growth
        # path; the full word list goes back so the caller can mirror it
        cat.encode_strings(table, column, fresh)
        return {"words": cat.dictionary(table, column)}

    def fetch_dict(self, table: str, column: str):
        """Client side: the authority's canonical word list, or None
        when unreachable/not attached."""
        if self.client is None:
            return None
        return self.client.call("fetch_dict", {"table": table,
                                               "column": column})["words"]

    def grow_dict(self, table: str, column: str, words: list) -> list:
        if self.client is None:
            raise RpcError("not attached to a metadata authority")
        return self.client.call("grow_dict", {
            "table": table, "column": column, "words": words})["words"]

    # ---- cross-host transaction outcomes -------------------------------
    # The durable commit point of a cross-host 2PC: the coordinator
    # records the global transaction's outcome HERE before sending any
    # phase-2 decision, so a branch host that crashed (or missed the
    # decide) resolves the gxid from this store at recovery.  Absence
    # of an outcome = presumed abort once the origin is gone — the
    # pg_dist_transaction reconciliation model (transaction_recovery.c:
    # commit if a record exists, abort otherwise).
    def _outcomes_path(self) -> str:
        return os.path.join(self.cluster.catalog.data_dir,
                            "gxid_outcomes.jsonl")

    def _outcome_store(self, gxid: str, outcome: str) -> str:
        """First-writer-wins decision register: the FIRST recorded
        outcome for a gxid is THE outcome; later writers get the winner
        back.  This is what makes participant-side presumed abort and
        the coordinator's commit race-free — whoever reaches the store
        first decides, and everyone else converges on that."""
        with self._lock:
            existing = self._outcome_lookup(gxid)
            if existing is not None:
                return existing
            from citus_tpu_torch.catalog.catalog import _catalog_flock
            with _catalog_flock(self.cluster.catalog.data_dir):
                existing = self._outcome_lookup(gxid)
                if existing is not None:
                    return existing
                with open(self._outcomes_path(), "a") as fh:
                    fh.write(json.dumps({"gxid": gxid,
                                         "outcome": outcome}) + "\n")
                    fh.flush()
                    os.fsync(fh.fileno())
        return outcome

    def _outcome_lookup(self, gxid: str) -> Optional[str]:
        try:
            with open(self._outcomes_path()) as fh:
                for line in fh:
                    line = line.strip()
                    if line:
                        d = json.loads(line)
                        if d.get("gxid") == gxid:
                            return d.get("outcome")
        except OSError:
            pass
        return None

    def _on_record_txn_outcome(self, payload: dict) -> dict:
        winner = self._outcome_store(str(payload["gxid"]),
                                     str(payload["outcome"]))
        return {"ok": True, "outcome": winner}

    def _on_txn_outcome(self, payload: dict) -> dict:
        return {"outcome": self._outcome_lookup(str(payload["gxid"]))}

    def record_txn_outcome(self, gxid: str, outcome: str) -> str:
        """Durably record a cross-host transaction's decision (at the
        authority; locally when we ARE the authority).  Returns the
        WINNING outcome — an earlier writer's decision wins, and the
        caller must follow it."""
        if self.client is not None:
            return str(self.client.call(
                "record_txn_outcome",
                {"gxid": gxid, "outcome": outcome})["outcome"])
        return self._outcome_store(gxid, outcome)

    def txn_outcome(self, gxid: str) -> Optional[str]:
        """'commit' | 'abort' | None (no outcome recorded at a
        REACHABLE authority) | 'unknown' (authority unreachable —
        callers must keep waiting, never presume)."""
        try:
            if self.client is not None:
                return self.client.call("txn_outcome",
                                        {"gxid": gxid}).get("outcome")
            return self._outcome_lookup(gxid)
        except RpcError:
            return "unknown"

    # ---- client-side ---------------------------------------------------
    def _on_event(self, event: dict) -> None:
        if event.get("event") == "catalog_changed" \
                and event.get("origin") != self.origin:
            self.cluster._catalog_dirty = True
        elif event.get("event") == "data_changed" \
                and event.get("origin") != self.origin:
            self._note_data_changed(event.get("table"))

    # ---- outbound ------------------------------------------------------
    def publish_catalog_change(self) -> None:
        payload = {"origin": self.origin}
        if self.client is not None:
            try:
                self.client.call("catalog_changed", payload)
            except RpcError:
                pass  # coordinator down: peers fall back to reload-on-open
        elif self.server is not None:
            self.server.broadcast({"event": "catalog_changed",
                                   "origin": self.origin})

    def publish_data_change(self, table: str) -> None:
        """Tell every coordinator a committed write touched ``table``.
        A lost publication is safe only because receivers gate elision
        on their push stream being alive (``connected``): the same
        outage that loses the event also disables the fast path."""
        payload = {"origin": self.origin, "table": table}
        if self.client is not None:
            try:
                self.client.call("data_changed", payload)
            except RpcError:
                pass  # authority down: peers stop eliding (push dead)
        elif self.server is not None:
            self.server.broadcast({"event": "data_changed",
                                   "origin": self.origin,
                                   "table": table})

    def report_inflight(self) -> None:
        if self.client is not None:
            try:
                self.client.call("report_inflight", {
                    "origin": self.origin,
                    "xids": sorted(self.cluster.txlog.inflight())})
            except RpcError:
                pass

    def peer_inflight_xids(self) -> set[int]:
        """In-flight xids of other coordinators, for recovery to spare.
        Queried through the metadata authority."""
        try:
            if self.client is not None:
                self.report_inflight()
                return set(self.client.call("cluster_inflight")["xids"])
            if self.server is not None:
                return set(self._on_cluster_inflight({})["xids"])
        except RpcError:
            pass
        return set()

    # ---- commit transport (Catalog.commit protocol) --------------------
    @property
    def commit_is_remote(self) -> bool:
        """True when catalog commits should travel to a remote authority
        (we are a client); the authority itself commits locally under
        the same lease."""
        return self.client is not None

    @contextmanager
    def catalog_lease(self, timeout: float = 30.0):
        """Hold the cluster-wide DDL lease (RPC to the authority, or the
        local lease map when we are the authority)."""
        deadline = time.monotonic() + timeout
        while True:
            if self.client is not None:
                ok = self.client.call("ddl_lease", {
                    "origin": self.origin, "action": "acquire"}).get("ok")
            else:
                ok = self._lease_try(self.origin)
            if ok:
                break
            if time.monotonic() >= deadline:
                raise RpcError("timed out waiting for the DDL lease")
            time.sleep(0.02)
        try:
            yield
        finally:
            try:
                if self.client is not None:
                    self.client.call("ddl_lease", {
                        "origin": self.origin, "action": "release"})
                else:
                    self._lease_release(self.origin)
            except RpcError:
                pass  # lease expires by TTL

    def fetch_catalog_doc(self) -> Optional[dict]:
        if self.client is not None:
            return self.client.call("fetch_catalog").get("doc")
        return None

    def push_catalog_doc(self, doc: dict,
                         tombstones: Optional[dict] = None) -> None:
        if self.client is not None:
            self.client.call("push_catalog", {"doc": doc,
                                              "tombstones": tombstones or {},
                                              "origin": self.origin})

    def _on_push_closed(self) -> None:
        # lock-free ON PURPOSE: fires on the subscriber thread, possibly
        # while _try_repoint_locked holds _failover_mu mid-subscribe —
        # taking the lock here would deadlock; a plain bool store is the
        # protocol (set-before-subscribe, cleared by whoever sees death)
        # lint: disable=LOCK01 -- on_close callback may fire while _failover_mu is held; bool store is the documented lock-free protocol
        self.push_alive = False

    # ---- authority failover (reference: node_promotion.c) ---------------
    def _authority_path(self) -> str:
        return os.path.join(self.cluster.catalog.data_dir, AUTHORITY_FILE)

    def _write_authority_file(self) -> None:
        tmp = self._authority_path() + ".tmp"
        with open(tmp, "w") as fh:
            json.dump({"host": "127.0.0.1", "port": self.server.port,
                       "origin": self.origin, "pid": os.getpid(),
                       "promoted_at": wall_now()}, fh)
        os.replace(tmp, self._authority_path())

    def _read_authority_file(self) -> Optional[dict]:
        try:
            with open(self._authority_path()) as fh:
                return json.load(fh)
        except (OSError, ValueError):
            return None

    def ensure_authority(self) -> str:
        """Keep a live metadata authority (maintenance-daemon duty).

        Healthy -> 'ok'.  When our push channel to the authority is
        dead: under the shared-FS promotion lock, first try the
        currently-advertised authority (another peer may have promoted
        already) -> 'repointed'; otherwise promote OURSELVES — start
        serving, advertise, and re-sync — -> 'promoted'.  Writes never
        stop either way: Catalog.commit already falls back to the
        flock path while no authority is reachable."""
        from citus_tpu_torch.utils.filelock import FileLock
        lock = os.path.join(self.cluster.catalog.data_dir, ".authority.lock")
        # one attempt at a time per control plane: the maintenance duty
        # and an explicit call must not promote twice
        with self._failover_mu:
            if self.server is not None:
                # split-brain guard: while we were unreachable, a peer
                # may have promoted (the authority FILE, written under
                # the promotion flock, is the arbiter).  If it advertises
                # a live different authority, step down; if the
                # advertised one is dead, re-assert ourselves.
                info = self._read_authority_file()
                if info is None or info.get("origin") == self.origin:
                    return "ok"
                with FileLock(lock, timeout=10.0):
                    info = self._read_authority_file()
                    if info is None or info.get("origin") == self.origin:
                        return "ok"
                    if self._try_repoint_locked(info):
                        old_server, self.server = self.server, None
                        try:
                            old_server.stop()
                        # lint: disable=SWL01 -- stepping down: closing the dead server socket is best-effort
                        except Exception:
                            pass
                        return "stepped_down"
                    self._write_authority_file()
                    return "ok"
            if self.client is not None and self.push_alive:
                return "ok"
            with FileLock(lock, timeout=10.0):
                # re-check under the flock: another process may have
                # promoted while we waited
                info = self._read_authority_file()
                if info and info.get("origin") != self.origin \
                        and self._try_repoint_locked(info):
                    return "repointed"
                self._promote_locked()
                return "promoted"

    def _try_repoint_locked(self, info: dict) -> bool:
        """Subscribe to the advertised authority if it answers (called
        with _failover_mu held); any
        mid-handshake failure (it died between ping and subscribe) falls
        back to promotion.  Never leaks sockets on failure."""
        c = None
        try:
            c = RpcClient(info["host"], int(info["port"]),
                          secret=self.secret)
            c.call("ping")
        except Exception:
            if c is not None:
                try:
                    c.close()
                # lint: disable=SWL01 -- probe socket to a dead peer; close failure changes nothing
                except Exception:
                    pass
            return False
        old, self.client = self.client, c
        # alive BEFORE subscribe, matching __init__: an on_close firing
        # during subscribe must be able to clear it, never be overwritten
        self.push_alive = True
        try:
            c.subscribe(self._on_event, on_close=self._on_push_closed)
        except Exception:
            self.push_alive = False
            self.client = old
            try:
                c.close()
            # lint: disable=SWL01 -- subscribe failed mid-handshake; closing the half-open socket is best-effort
            except Exception:
                pass
            return False
        if old is not None:
            try:
                old.close()
            # lint: disable=SWL01 -- superseded client connection; close failure changes nothing
            except Exception:
                pass
        # events may have been missed during the outage: force a re-sync
        self.cluster._catalog_dirty = True
        return True

    def _promote_locked(self) -> None:
        """Become the metadata authority: serve, advertise, re-sync.
        Called with _failover_mu held (ensure_authority).
        Reference: citus_promote_clone_and_rebalance / node promotion
        turning a secondary into the metadata writer
        (operations/node_promotion.c)."""
        if self.client is not None:
            try:
                self.client.close()
            # lint: disable=SWL01 -- promoting: the old push channel is already dead
            except Exception:
                pass
            self.client = None
        self.push_alive = False
        self.server = RpcServer(port=0, secret=self.secret)
        self._register_handlers()
        self.server.start()
        self._write_authority_file()
        # adopt the freshest on-disk document before serving fetches
        from citus_tpu_torch.catalog.catalog import _catalog_flock
        cat = self.cluster.catalog
        try:
            with cat._lock, _catalog_flock(cat.data_dir):
                cat._merge_foreign_locked()
        # lint: disable=SWL01 -- pre-serve re-sync is opportunistic; the authority serves its in-memory doc
        except Exception:
            pass
        self.cluster._plan_cache.clear()
        try:
            from citus_tpu_torch.executor.executor import GLOBAL_COUNTERS
            GLOBAL_COUNTERS.bump("authority_promotions")
        except ImportError:
            pass

    @property
    def connected(self) -> bool:
        """Push-based invalidation is trustworthy: we serve it, or our
        subscription to the authority is still alive."""
        if self.server is not None:
            return True
        return self.client is not None and self.push_alive

    def close(self) -> None:
        if self.client is not None:
            self.client.close()
        if self.server is not None:
            self.server.stop()
