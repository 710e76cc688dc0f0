"""The catalog store.

Equivalents, per reference catalog:

- TableMeta      <- pg_dist_partition (+ pg_attribute via Schema)
- ShardMeta      <- pg_dist_shard + pg_dist_placement
- colocation_id  <- pg_dist_colocation
- NodeMeta       <- pg_dist_node (a "node" here is a logical executor slot
                    that maps onto a mesh device/slice at execution time)
- text dictionaries: table-global per-column string dictionaries assigned
  at ingest so every shard shares one id space (this is what makes
  cross-shard GROUP BY combinable with a single psum — the TPU analog of
  the reference's colocated-aggregation guarantees)

Persistence: a single JSON document written atomically (temp + rename);
dictionaries live in side files to keep the main document small.  All
mutations go through commit(), the round-1 stand-in for the metadata
2PC layer (reference: transaction/transaction_management.c) that arrives
with multi-host support.
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass, field
from typing import Optional

from citus_tpu_torch.errors import CatalogError
from citus_tpu_torch.schema import Schema
from citus_tpu_torch.catalog.hashing import shard_hash_ranges


class DistributionMethod:
    HASH = "hash"            # hash-distributed over shards
    REFERENCE = "reference"  # one shard replicated everywhere
    LOCAL = "local"          # coordinator-local single shard
    TENANT = "tenant"        # schema-based sharding: one shard per tenant
                             # schema, all of a schema's tables colocated
                             # (reference: citus.enable_schema_based_sharding,
                             # commands/schema_based_sharding.c)


@dataclass
class ShardMeta:
    shard_id: int
    index: int                     # position within the table's shard list
    hash_min: Optional[int] = None
    hash_max: Optional[int] = None
    placements: list[int] = field(default_factory=list)  # node ids

    def to_json(self):
        return {"shard_id": self.shard_id, "index": self.index,
                "hash_min": self.hash_min, "hash_max": self.hash_max,
                "placements": self.placements}

    @staticmethod
    def from_json(d):
        return ShardMeta(d["shard_id"], d["index"], d["hash_min"], d["hash_max"],
                         list(d["placements"]))


@dataclass
class TableMeta:
    name: str
    schema: Schema
    method: str = DistributionMethod.LOCAL
    dist_column: Optional[str] = None
    colocation_id: int = 0
    shards: list[ShardMeta] = field(default_factory=list)
    # columnar options (per-table override of ColumnarSettings)
    chunk_row_limit: int = 8192
    stripe_row_limit: int = 131072
    compression: str = "zstd"
    compression_level: int = 3
    # bumped on any DDL/ingest; plan caches key on it (the analog of the
    # reference's syscache-invalidation-driven plan invalidation)
    version: int = 0
    # foreign keys declared ON this table (referencing side), each
    # {"name", "columns", "ref_table", "ref_columns", "on_delete"}
    # (reference: pg_constraint rows + foreign_constraint.c validation)
    foreign_keys: list = field(default_factory=list)
    # secondary indexes, each {"name", "column", "unique"} — per-stripe
    # sorted segments beside the stripe files (reference: pg_index rows +
    # columnar_index_build_range_scan, columnar_tableam.c:1444)
    indexes: list = field(default_factory=list)
    # declarative range partitioning (reference: PostgreSQL partitioned
    # tables + multi_partitioning_utils.c helpers).  A parent carries
    # partition_by = {"column", "kind": "range"} and holds no data; a
    # partition carries partition_of = {"parent", "lo", "hi"} with
    # PHYSICAL bounds, lo inclusive / hi exclusive (None = unbounded)
    partition_by: Optional[dict] = None
    partition_of: Optional[dict] = None
    # CHECK constraints, each {"name", "sql"} — enforced on every write
    # path against the encoded batch (reference: pg_constraint CHECK
    # rows; NULL results pass, like SQL)
    check_constraints: list = field(default_factory=list)

    @property
    def shard_count(self) -> int:
        return len(self.shards)

    @property
    def is_distributed(self) -> bool:
        return self.method == DistributionMethod.HASH

    def route_hashes(self, hashes):
        """Shard indexes owning the given signed int32 hash values under
        the table's ACTUAL range layout.  The uniform-arithmetic mapping
        (hashing.shard_index_for_hash) is only valid until the first
        shard split makes the ranges non-uniform; they always tile the
        int32 space contiguously, so a bisect on hash_min is exact."""
        import numpy as np
        mins = np.array([s.hash_min for s in self.shards], np.int64)
        h = np.asarray(hashes).astype(np.int64)
        return (np.searchsorted(mins, h, side="right") - 1).astype(np.int32)

    def route_hash(self, h: int) -> int:
        """Scalar ``route_hashes`` (router fast path, utilities)."""
        return int(self.route_hashes([int(h)])[0])

    @property
    def is_reference(self) -> bool:
        return self.method == DistributionMethod.REFERENCE

    def index_on(self, column: str):
        """The index over ``column``, or None."""
        for ix in self.indexes:
            if ix["column"] == column:
                return ix
        return None

    @property
    def unique_indexes(self) -> list:
        return [ix for ix in self.indexes if ix.get("unique")]

    @property
    def index_columns(self) -> list[str]:
        return [ix["column"] for ix in self.indexes]

    @property
    def is_partitioned(self) -> bool:
        return self.partition_by is not None

    def to_json(self):
        return {
            "name": self.name, "schema": self.schema.to_json(),
            "method": self.method, "dist_column": self.dist_column,
            "colocation_id": self.colocation_id,
            "shards": [s.to_json() for s in self.shards],
            "chunk_row_limit": self.chunk_row_limit,
            "stripe_row_limit": self.stripe_row_limit,
            "compression": self.compression,
            "compression_level": self.compression_level,
            "version": self.version,
            "foreign_keys": self.foreign_keys,
            "indexes": self.indexes,
            "partition_by": self.partition_by,
            "partition_of": self.partition_of,
            "check_constraints": self.check_constraints,
        }

    @staticmethod
    def from_json(d):
        return TableMeta(
            name=d["name"], schema=Schema.from_json(d["schema"]),
            method=d["method"], dist_column=d["dist_column"],
            colocation_id=d["colocation_id"],
            shards=[ShardMeta.from_json(s) for s in d["shards"]],
            chunk_row_limit=d["chunk_row_limit"],
            stripe_row_limit=d["stripe_row_limit"],
            compression=d["compression"],
            compression_level=d["compression_level"],
            version=d.get("version", 0),
            foreign_keys=d.get("foreign_keys", []),
            indexes=d.get("indexes", []),
            partition_by=d.get("partition_by"),
            partition_of=d.get("partition_of"),
            check_constraints=d.get("check_constraints", []),
        )


@dataclass
class NodeMeta:
    node_id: int
    is_active: bool = True
    # data-plane endpoint of the coordinator hosting this node's
    # placements (pg_dist_node nodename/nodeport analog,
    # sql/citus--8.0-1.sql:401).  None = placements live in this
    # process's own data directory (shared-dir / single-host mode).
    host: Optional[str] = None
    port: Optional[int] = None
    # citus_activate_node_metadata marked this node as a full metadata
    # peer (pg_dist_node.hasmetadata analog): it runs the sync engine
    # and may plan/admit locally ("query from any node")
    metadata_synced: bool = False

    @property
    def endpoint(self) -> Optional[tuple]:
        if self.host is None or self.port is None:
            return None
        return (self.host, self.port)

    def to_json(self):
        d = {"node_id": self.node_id, "is_active": self.is_active}
        if self.host is not None:
            d["host"] = self.host
            d["port"] = self.port
        if self.metadata_synced:
            d["metadata_synced"] = True
        return d

    @staticmethod
    def from_json(d):
        return NodeMeta(d["node_id"], d["is_active"],
                        d.get("host"), d.get("port"),
                        bool(d.get("metadata_synced", False)))


def _catalog_flock(data_dir: str):
    """Cross-process serialization of catalog/dictionary writes (two
    coordinators may share one data dir — the MX analog).  Guards every
    read-merge-store of the dictionary side files and the catalog
    document store itself."""
    from citus_tpu_torch.utils.filelock import FileLock
    return FileLock(os.path.join(data_dir, ".catalog.lock"))


def _stat_sig(path: str):
    """(st_mtime_ns, st_size) change signature — mtime alone can miss a
    foreign write landing within one timestamp tick."""
    try:
        st = os.stat(path)
        return (st.st_mtime_ns, st.st_size)
    except OSError:
        return None


class Catalog:
    FILE = "catalog.json"

    def __init__(self, data_dir: str):
        self.data_dir = data_dir
        os.makedirs(data_dir, exist_ok=True)
        self._lock = threading.RLock()
        self.tables: dict[str, TableMeta] = {}
        self.nodes: dict[int, NodeMeta] = {}
        self._next_shard_id = 102008  # match the reference's familiar id space
        self._next_colocation_id = 1
        # cross-host bulk data plane (net/data_plane.py DataPlaneClient);
        # set by the Cluster when remote node endpoints are in play, read
        # by the executor's placement failover and the shard mover
        self.remote_data = None
        # node ids whose placements live in THIS process's data dir;
        # None = all of them (shared-dir / single-host mode)
        self.hosted_nodes: Optional[set] = None
        # bumped on every DDL statement; plan caches key on it so dropped/
        # recreated relations can never serve stale plans
        self.ddl_epoch = 0
        self._dicts: dict[tuple[str, str], list[str]] = {}
        self._dict_index: dict[tuple[str, str], dict[str, int]] = {}
        self._dict_sig: dict[tuple[str, str], Optional[tuple]] = {}
        # tenant schemas: name -> {"colocation_id": int, "home_node": int}
        self.schemas: dict[str, dict] = {}
        # views: name -> SELECT sql text (reparsed at each use)
        self.views: dict[str, str] = {}
        # roles + per-table grants: table -> {role: [privileges]}
        # (reference: commands/role.c, commands/grant.c propagation)
        self.roles: dict[str, dict] = {}
        self.grants: dict[str, dict] = {}
        # SQL expression functions (inlined at planning time;
        # reference: commands/function.c distributed functions)
        self.functions: dict[str, dict] = {}
        # enum types + per-column bindings ("table.column" -> type name);
        # enum columns are dictionary-encoded text with ingest validation
        self.types: dict[str, list] = {}
        self.enum_columns: dict[str, str] = {}
        # row-level security: table -> [policy dicts]; rls flags
        # (reference: commands/policy.c)
        self.policies: dict[str, list] = {}
        self.rls: dict[str, bool] = {}
        # statement-level AFTER triggers: name -> {table, event, function}
        # (reference: commands/trigger.c)
        self.triggers: dict[str, dict] = {}
        # text search configurations (metadata-only propagated objects,
        # reference: commands/text_search.c)
        self.ts_configs: dict[str, dict] = {}
        # object-surface breadth (reference: commands/extension.c,
        # domain.c, collation.c, publication.c, statistics.c):
        # extensions: name -> {"version"}; domains: name -> {"base",
        # "args", "not_null", "check"}; collations: name -> {"locale",
        # "provider"}; publications: name -> {"tables": [..] | "all"};
        # statistics: name -> {"table", "columns", "ndistinct"}
        self.extensions: dict[str, dict] = {}
        # "table.column" -> domain name (domain-typed columns resolve to
        # the base type at DDL time; checks enforce at ingest)
        self.domain_columns: dict[str, str] = {}
        self.domains: dict[str, dict] = {}
        self.collations: dict[str, dict] = {}
        self.publications: dict[str, dict] = {}
        self.statistics: dict[str, dict] = {}
        # continuous-aggregation rollup specs: name -> {"source",
        # "table", "group_cols", "aggs", "backend"} (rollup/manager.py;
        # the refresh watermark lives in the rollup progress TABLE, not
        # here — it must commit atomically with the delta apply)
        self.rollups: dict[str, dict] = {}
        # replicated tenant control plane (metadata/quotas.py is the
        # only write door, cituslint CONF01): tenant -> {"weight",
        # "max_concurrency", "rate_limit_qps", "queue_depth",
        # "priority_class"}; priority class -> {"weight"}.  Persisting
        # quotas here is what makes admission decisions identical on
        # every coordinator (PR 9 kept them process-local).
        self.tenant_quotas: dict[str, dict] = {}
        self.priority_classes: dict[str, dict] = {}
        # sequences: name -> {"value": next unreserved, "increment": n,
        # "start": n}; nextval hands out values from an in-memory block
        # reserved by bumping the persisted high-water mark (gaps on
        # crash, like the reference's cached sequences)
        self.sequences: dict[str, dict] = {}
        self._seq_cache: dict[str, list] = {}   # name -> [next, limit]
        self._seq_currval: dict[str, int] = {}  # session-last nextval
        # per-section dropped names since the last commit (merge guard)
        self._tombstones: dict[str, set] = {}
        self._doc_sig = None
        # transactional-DDL staging guard: while one transaction stages
        # DDL in this (shared) in-memory catalog, other sessions of the
        # same process must not persist the document (their commit would
        # durably leak the uncommitted DDL)
        self._staging_cv = threading.Condition()
        self._staging_txn = None
        self._load()

    # ---- transactional-DDL staging guard ------------------------------
    def _begin_staging(self, txn, timeout: float = 30.0) -> None:
        import time as _time
        with self._staging_cv:
            deadline = _time.monotonic() + timeout
            while self._staging_txn is not None and self._staging_txn is not txn:
                rem = deadline - _time.monotonic()
                if rem <= 0:
                    from citus_tpu_torch.utils.filelock import LockTimeout
                    raise LockTimeout(
                        "another transaction is staging DDL in this process")
                self._staging_cv.wait(rem)
            self._staging_txn = txn

    def _end_staging(self, txn) -> None:
        with self._staging_cv:
            if self._staging_txn is txn:
                self._staging_txn = None
                self._staging_cv.notify_all()

    def _await_no_staging(self, timeout: float = 30.0) -> None:
        """Block a non-transactional catalog persist while another
        session's transaction has DDL staged in memory."""
        import time as _time
        with self._staging_cv:
            deadline = _time.monotonic() + timeout
            while self._staging_txn is not None:
                rem = deadline - _time.monotonic()
                if rem <= 0:
                    from citus_tpu_torch.utils.filelock import LockTimeout
                    raise LockTimeout(
                        "a transaction with staged DDL is open; retry "
                        "after it commits or rolls back")
                self._staging_cv.wait(rem)

    # ---- persistence --------------------------------------------------
    def _path(self) -> str:
        return os.path.join(self.data_dir, self.FILE)

    def _load(self) -> None:
        p = self._path()
        if not os.path.exists(p):
            return
        with open(p) as fh:
            d = json.load(fh)
        with self._lock:
            self.load_document(d)
            self._doc_sig = _stat_sig(p)

    def load_document(self, d: dict) -> None:
        """Replace in-memory state with a catalog document (the unit the
        control plane ships between coordinators).  Documents written by
        older builds are lifted through the versioned migrations first
        (catalog/migrations.py; the ALTER EXTENSION ... UPDATE analog).

        Swaps every section atomically under the catalog lock: an MX
        invalidation reload arrives on the subscriber thread while
        sessions read the catalog, and a reader must never observe new
        tables with old schemas."""
        from citus_tpu_torch.catalog.migrations import migrate_document
        d = migrate_document(d)
        with self._lock:
            self.tables = {t["name"]: TableMeta.from_json(t)
                           for t in d["tables"]}
            self.nodes = {n["node_id"]: NodeMeta.from_json(n)
                          for n in d["nodes"]}
            self._next_shard_id = d["next_shard_id"]
            self._next_colocation_id = d["next_colocation_id"]
            self.schemas = d.get("schemas", {})
            self.views = d.get("views", {})
            self.sequences = d.get("sequences", {})
            self.roles = d.get("roles", {})
            self.grants = d.get("grants", {})
            self.functions = d.get("functions", {})
            self.types = d.get("types", {})
            self.enum_columns = d.get("enum_columns", {})
            self.policies = d.get("policies", {})
            self.rls = d.get("rls", {})
            self.triggers = d.get("triggers", {})
            self.ts_configs = d.get("ts_configs", {})
            self.extensions = d.get("extensions", {})
            self.domain_columns = d.get("domain_columns", {})
            self.domains = d.get("domains", {})
            self.collations = d.get("collations", {})
            self.publications = d.get("publications", {})
            self.statistics = d.get("statistics", {})
            self.rollups = d.get("rollups", {})
            self.tenant_quotas = d.get("tenant_quotas", {})
            self.priority_classes = d.get("priority_classes", {})

    def export_document(self) -> dict:
        from citus_tpu_torch.catalog.migrations import CATALOG_FORMAT_VERSION
        return {
            "format_version": CATALOG_FORMAT_VERSION,
            "tables": [t.to_json() for t in self.tables.values()],
            "nodes": [n.to_json() for n in self.nodes.values()],
            "next_shard_id": self._next_shard_id,
            "next_colocation_id": self._next_colocation_id,
            "schemas": self.schemas,
            "views": self.views,
            "sequences": self.sequences,
            "roles": self.roles,
            "grants": self.grants,
            "functions": self.functions,
            "types": self.types,
            "enum_columns": self.enum_columns,
            "policies": self.policies,
            "rls": self.rls,
            "triggers": self.triggers,
            "ts_configs": self.ts_configs,
            "extensions": self.extensions,
            "domain_columns": self.domain_columns,
            "domains": self.domains,
            "collations": self.collations,
            "publications": self.publications,
            "statistics": self.statistics,
            "rollups": self.rollups,
            "tenant_quotas": self.tenant_quotas,
            "priority_classes": self.priority_classes,
        }

    def tombstone(self, section: str, name: str) -> None:
        """Record a deletion so the commit-time merge never resurrects a
        dropped object from a concurrent coordinator's document."""
        with self._lock:
            self._tombstones.setdefault(section, set()).add(name)

    # ---- replicated tenant control plane ------------------------------
    # The three writers below mutate the catalog-persisted quota
    # sections WITHOUT committing; metadata/quotas.py (the one file
    # cituslint CONF01 admits) wraps them in the 2PC
    # commit_metadata_flip sequence and mirrors the result into the
    # process-local registry.  A write anywhere else would change this
    # coordinator's admission behavior without replicating it.

    def put_tenant_quota(self, tenant: str, quota: dict) -> None:
        with self._lock:
            self.tenant_quotas[tenant] = dict(quota)

    def drop_tenant_quota(self, tenant: str) -> bool:
        with self._lock:
            found = self.tenant_quotas.pop(tenant, None) is not None
            if found:
                self.tombstone("tenant_quotas", tenant)
            return found

    def put_priority_class(self, name: str, weight: float) -> None:
        with self._lock:
            self.priority_classes[name] = {"weight": float(weight)}

    def _merge_foreign_locked(self) -> None:
        """Adopt another coordinator's catalog changes before storing
        (read-merge-store under the catalog flock): entries on disk that
        we neither hold nor dropped are adopted; table conflicts resolve
        by version; sequence high-water marks by increment direction;
        id allocators by max.  This keeps concurrent multi-coordinator
        commits from dropping each other's objects."""
        sig = _stat_sig(self._path())
        if sig is None or sig == getattr(self, "_doc_sig", None):
            return
        try:
            with open(self._path()) as fh:
                d = json.load(fh)
        except (OSError, json.JSONDecodeError):
            return
        self._merge_doc_locked(d)

    def _merge_doc_locked(self, d: dict) -> None:
        """Adopt another coordinator's catalog document into memory
        (tombstones guard drops; table conflicts resolve by version)."""
        from citus_tpu_torch.catalog.migrations import migrate_document
        d = migrate_document(d)
        tomb = self._tombstones
        for td in d.get("tables", []):
            name = td["name"]
            if name in tomb.get("tables", ()):
                continue
            mine = self.tables.get(name)
            if mine is None or td.get("version", 0) > mine.version:
                self.tables[name] = TableMeta.from_json(td)
        for nd in d.get("nodes", []):
            self.nodes.setdefault(nd["node_id"], NodeMeta.from_json(nd))
        # policies are LIST-valued per table: merge per policy (by
        # "table.name" identity) so a concurrent coordinator's added
        # policy on a table we already track is not discarded; drops
        # tombstone the per-policy key
        dead_p = tomb.get("policies", set())
        for tbl, plist in d.get("policies", {}).items():
            if tbl in dead_p or tbl in tomb.get("tables", ()):
                continue
            names = {p["name"] for p in self.policies.get(tbl, [])}
            for p in plist:
                if f"{tbl}.{p['name']}" in dead_p or p["name"] in names:
                    continue
                self.policies.setdefault(tbl, []).append(p)
        for sec in ("views", "sequences", "roles", "functions", "types",
                    "enum_columns", "schemas", "rls",
                    "triggers", "ts_configs", "extensions", "domains",
                    "collations", "publications", "statistics",
                    "rollups", "domain_columns",
                    "tenant_quotas", "priority_classes"):
            disk = d.get(sec, {})
            mem = getattr(self, sec)
            dead = tomb.get(sec, set())
            for k, v in disk.items():
                if k in dead:
                    continue
                if k not in mem:
                    mem[k] = v
                elif sec == "sequences":
                    inc = mem[k].get("increment", 1)
                    ahead = (v.get("value", 0) - mem[k]["value"])
                    if (ahead > 0) == (inc >= 0) and ahead != 0:
                        mem[k]["value"] = v["value"]
        for tbl, by_role in d.get("grants", {}).items():
            if tbl in tomb.get("tables", ()):
                continue
            tgt = self.grants.setdefault(tbl, {})
            for rname, privs in by_role.items():
                if rname not in tomb.get("roles", ()) and rname not in tgt:
                    tgt[rname] = privs
        self._next_shard_id = max(self._next_shard_id,
                                  d.get("next_shard_id", 0))
        self._next_colocation_id = max(self._next_colocation_id,
                                       d.get("next_colocation_id", 1))

    def _store_locked(self) -> None:
        d = self.export_document()
        tmp = self._path() + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(d, fh)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self._path())
        # remember our own write so coordinators in this process don't
        # treat it as a foreign metadata change (see MX reload)
        try:
            self.self_mtime = os.path.getmtime(self._path())
        except OSError:
            pass
        self._doc_sig = _stat_sig(self._path())
        self._tombstones = {}

    def commit(self) -> None:
        """Atomically persist catalog state: the metadata-transaction
        analog.  With a control plane attached, the commit is serialized
        through the metadata authority — acquire the cluster-wide DDL
        lease, merge against the authority's current document (fetched
        over RPC), and push the merged document back; the authority is
        the single writer of the canonical file and broadcasts the
        invalidation (reference: metadata changes travel inside the
        coordinator's 2PC, metadata/metadata_sync.c).  Without one —
        or if the authority is unreachable — fall back to read-merge-
        store under the cross-process flock (the shared-FS degenerate
        transport)."""
        from citus_tpu_torch.testing.faults import FAULTS
        FAULTS.hit("catalog_commit")
        from citus_tpu_torch.storage.overlay import current_overlay
        txn = current_overlay()
        if txn is not None:
            # transactional DDL: the statement mutated the in-memory
            # catalog; persistence + invalidation broadcast happen once
            # at COMMIT (Cluster._commit_txn), discard at ROLLBACK
            # (reference: DDL rides the coordinated transaction,
            # commands/utility_hook.c:148).  Staging claims the process-
            # wide guard so no concurrent session persists the shared
            # in-memory document (which now holds uncommitted DDL).
            self._begin_staging(txn)
            txn.catalog_dirty = True
            txn.ddl_statements += 1
            return
        self._await_no_staging()
        tr = getattr(self, "commit_transport", None)
        if tr is not None and tr.commit_is_remote:
            try:
                with tr.catalog_lease():
                    # network fetch happens OUTSIDE the catalog lock so
                    # readers aren't frozen for a round trip; the lease
                    # already serializes committers
                    remote = tr.fetch_catalog_doc()
                    with self._lock:
                        if remote is not None:
                            self._merge_doc_locked(remote)
                        doc = self.export_document()
                        tombs = {k: sorted(v)
                                 for k, v in self._tombstones.items()}
                    tr.push_catalog_doc(doc, tombs)
                # the authority stored the document and broadcast the
                # invalidation (tagged with our origin); only now are the
                # drop tombstones consumed (a failed push must leave them
                # for the flock fallback's merge)
                # stamp the authority's file write as our own so the
                # mtime poller doesn't treat our commit as foreign and
                # reload underneath concurrent readers
                with self._lock:
                    self._tombstones = {}
                    try:
                        self.self_mtime = os.path.getmtime(self._path())
                        self._doc_sig = _stat_sig(self._path())
                    except OSError:
                        pass
                return
            except Exception:
                # authority unreachable mid-commit: fall through to the
                # shared-FS path, WITHOUT the (dead) remote lease — the
                # flock alone serializes FS peers; a held lease expires
                # by TTL
                self._commit_local()
                cb = getattr(self, "on_commit", None)
                if cb is not None:
                    cb()
                return
        if tr is not None:
            # metadata authority committing its own DDL: serialize with
            # remote pushers through the same lease
            with tr.catalog_lease():
                self._commit_local()
        else:
            self._commit_local()
        # control-plane invalidation hook (set by Cluster when an RPC
        # control plane is attached): peers learn of this commit by push
        cb = getattr(self, "on_commit", None)
        if cb is not None:
            cb()

    def _commit_local(self) -> None:
        with self._lock, _catalog_flock(self.data_dir):
            self._merge_foreign_locked()
            self._store_locked()
            # dictionaries are persisted (fsync'd) by encode_strings at
            # growth time, before any commit record can reference their
            # ids — nothing to write here

    def store_document(self, doc: dict,
                       tombstones: Optional[dict] = None) -> None:
        """Authority-side application of a pushed catalog document.
        Push order is serialized by the DDL lease and every pusher
        merged against the freshest fetched document — but a NON-
        attached coordinator may still flock-commit between the pusher's
        fetch and this store, so merge the disk file once more before
        persisting, guarded by the pusher's tombstones (shipped with the
        document) so its drops don't resurrect."""
        with self._lock, _catalog_flock(self.data_dir):
            self.load_document(doc)
            self._tombstones = {k: set(v)
                                for k, v in (tombstones or {}).items()}
            self._merge_foreign_locked()
            self._dicts.clear()
            self._dict_index.clear()
            self._dict_sig.clear()
            self.ddl_epoch += 1
            self._store_locked()

    # ---- tables -------------------------------------------------------
    def partitions_of(self, parent: str) -> list[TableMeta]:
        """Range partitions of a parent, ordered by lower bound
        (None-lo first)."""
        parts = [t for t in self.tables.values()
                 if t.partition_of is not None
                 and t.partition_of["parent"] == parent]
        return sorted(parts, key=lambda t: (
            t.partition_of["lo"] is not None, t.partition_of["lo"] or 0))

    def table(self, name: str) -> TableMeta:
        t = self.tables.get(name)
        if t is None:
            raise CatalogError(f'relation "{name}" does not exist')
        return t

    def has_table(self, name: str) -> bool:
        return name in self.tables

    def referencing_fks(self, name: str) -> list[tuple[str, dict]]:
        """Foreign keys of OTHER tables that reference ``name`` ->
        [(referencing_table, fk)] (the reverse edge set of the
        reference's foreign-key graph cache,
        utils/foreign_key_relationship.c)."""
        out = []
        for t in self.tables.values():
            for fk in t.foreign_keys:
                if fk["ref_table"] == name:
                    out.append((t.name, fk))
        return out

    def create_table(self, name: str, schema: Schema, **columnar_opts) -> TableMeta:
        with self._lock:
            if name in self.tables:
                raise CatalogError(f'relation "{name}" already exists')
            t = TableMeta(name=name, schema=schema, **columnar_opts)
            if "." in name:
                schema_name = name.split(".", 1)[0]
                tenant = self.schemas.get(schema_name)
                if tenant is None:
                    raise CatalogError(f'schema "{schema_name}" does not exist')
                # tenant table: single shard on the schema's home node,
                # colocated with the rest of the schema
                t.method = DistributionMethod.TENANT
                t.colocation_id = tenant["colocation_id"]
                t.shards = [ShardMeta(self._alloc_shard_id(), 0,
                                      placements=[tenant["home_node"]])]
            else:
                # every table starts LOCAL with a single shard on node 0
                t.shards = [ShardMeta(self._alloc_shard_id(), 0, placements=[0])]
            self.tables[name] = t
            self.ddl_epoch += 1
            return t

    def create_schema(self, name: str) -> None:
        with self._lock:
            if name in self.schemas:
                raise CatalogError(f'schema "{name}" already exists')
            nodes = self.active_node_ids() or [0]
            home = nodes[len(self.schemas) % len(nodes)]
            self.schemas[name] = {
                "colocation_id": self._next_colocation_id,
                "home_node": home,
            }
            self._next_colocation_id += 1
            self.ddl_epoch += 1

    def drop_schema(self, name: str, cascade: bool = False) -> list[str]:
        with self._lock:
            if name not in self.schemas:
                raise CatalogError(f'schema "{name}" does not exist')
            members = [t for t in self.tables if t.startswith(name + ".")]
            if members and not cascade:
                raise CatalogError(
                    f'schema "{name}" is not empty; use DROP SCHEMA ... CASCADE')
            del self.schemas[name]
            self.ddl_epoch += 1
            return members

    def add_column(self, name: str, column) -> None:
        from citus_tpu_torch.schema import Schema
        with self._lock:
            t = self.table(name)
            if t.schema.has(column.name):
                raise CatalogError(f"column {column.name!r} already exists")
            if column.not_null:
                raise CatalogError(
                    "cannot add a NOT NULL column (existing rows would violate it)")
            t.schema = Schema(t.schema.columns + [column])
            t.version += 1
            self.ddl_epoch += 1

    def drop_column(self, name: str, column: str) -> None:
        from citus_tpu_torch.schema import Schema
        with self._lock:
            t = self.table(name)
            c = t.schema.column(column)
            if t.dist_column == column:
                raise CatalogError("cannot drop the distribution column")
            if len(t.schema) == 1:
                raise CatalogError("cannot drop the only column")
            t.schema = Schema([x for x in t.schema.columns if x.name != column])
            t.version += 1
            self.ddl_epoch += 1
            key = (name, column)
            self._dicts.pop(key, None)
            self._dict_index.pop(key, None)
            dp = self._dict_path(name, column)
            if os.path.exists(dp):
                from citus_tpu_torch.storage.overlay import current_overlay
                txn = current_overlay()
                if txn is not None:
                    # irreversible file removal: defer to COMMIT; a
                    # re-added same-name column keeps its dictionary
                    def _remove_dict(name=name, column=column, dp=dp):
                        t2 = self.tables.get(name)
                        if (t2 is None or not t2.schema.has(column)) \
                                and os.path.exists(dp):
                            os.remove(dp)
                    txn.on_commit.append(_remove_dict)
                else:
                    os.remove(dp)

    def rename_column(self, name: str, old: str, new: str) -> None:
        from citus_tpu_torch.schema import Column, Schema
        with self._lock:
            t = self.table(name)
            c = t.schema.column(old)
            if t.schema.has(new):
                raise CatalogError(f"column {new!r} already exists")
            cols = [Column(new, x.type, x.not_null, x.storage_name)
                    if x.name == old else x for x in t.schema.columns]
            t.schema = Schema(cols)
            if t.dist_column == old:
                t.dist_column = new
            t.version += 1
            self.ddl_epoch += 1
            # dictionaries are keyed by logical name: carry them over
            self._ensure_dict(name, old)
            words = self._dicts.pop((name, old))
            index = self._dict_index.pop((name, old))
            self._dicts[(name, new)] = words
            self._dict_index[(name, new)] = index
            oldp = self._dict_path(name, old)
            if os.path.exists(oldp):
                os.replace(oldp, self._dict_path(name, new))

    def rename_table(self, old: str, new: str) -> None:
        """ALTER TABLE ... RENAME TO: catalog key, shard data directory,
        dictionary side files, grants and enum bindings all move.  Views
        whose stored SQL references the old name will error at next use
        (recreate them), unlike the reference's OID-based views."""
        with self._lock:
            t = self.table(old)
            if new in self.tables or new in self.views:
                raise CatalogError(f'relation "{new}" already exists')
            if "." in new or "." in old:
                raise CatalogError("cannot rename tenant-schema tables")
            data_old = os.path.join(self.data_dir, "data", old)
            data_new = os.path.join(self.data_dir, "data", new)
            if os.path.isdir(data_old):
                os.rename(data_old, data_new)
            for col in t.schema.names:
                op = self._dict_path(old, col)
                if os.path.exists(op):
                    os.replace(op, self._dict_path(new, col))
                key = (old, col)
                if key in self._dicts:
                    self._dicts[(new, col)] = self._dicts.pop(key)
                    self._dict_index[(new, col)] = self._dict_index.pop(key)
                    self._dict_sig[(new, col)] = self._dict_sig.pop(key, None)
            del self.tables[old]
            self.tombstone("tables", old)
            t.name = new
            self.tables[new] = t
            if old in self.grants:
                self.grants[new] = self.grants.pop(old)
            for k in [k for k in self.enum_columns if k.startswith(old + ".")]:
                self.enum_columns[new + k[len(old):]] = self.enum_columns.pop(k)
            t.version += 1
            self.ddl_epoch += 1

    def drop_table(self, name: str) -> None:
        from citus_tpu_torch.storage.overlay import current_overlay
        with self._lock:
            t = self.table(name)
            del self.tables[name]
            self.tombstone("tables", name)
            self.ddl_epoch += 1
            for key in [k for k in self._dicts if k[0] == name]:
                del self._dicts[key]
                self._dict_index.pop(key, None)
            txn = current_overlay()
            if txn is not None:
                # transactional DROP: file removal is irreversible, so it
                # runs only if the transaction commits.  Capture THIS
                # incarnation's shard ids: a same-name table recreated
                # later in the transaction gets fresh ids, and its files
                # must survive the deferred removal.
                cols = list(t.schema.names)
                old_sids = [s.shard_id for s in t.shards]
                txn.on_commit.append(
                    lambda: self._remove_table_files(name, cols, old_sids))
            else:
                self._remove_table_files(name, list(t.schema.names))

    def _remove_table_files(self, name: str, col_names: list[str],
                            only_shard_ids: Optional[list[int]] = None) -> None:
        """Remove on-disk shard data and dictionary side files so a
        recreated relation starts clean (reference: DROP TABLE drops
        shards via citus_drop_all_shards, operations/delete_protocol.c).
        ``only_shard_ids`` (deferred transactional drop): if the table
        exists again at commit time, remove only the dropped
        incarnation's shard dirs and keep the shared dictionary files."""
        import shutil
        data_root = os.path.join(self.data_dir, "data", name)
        recreated = only_shard_ids is not None and name in self.tables
        if recreated:
            # shard dirs are data/<table>/shard_<id>/placement_<node>
            keep = {f"shard_{s.shard_id}" for s in self.tables[name].shards}
            for sid in only_shard_ids:
                entry = f"shard_{sid}"
                if entry not in keep:
                    shutil.rmtree(os.path.join(data_root, entry),
                                  ignore_errors=True)
            return
        if os.path.isdir(data_root):
            shutil.rmtree(data_root, ignore_errors=True)
        for col in col_names:
            dp = self._dict_path(name, col)
            if os.path.exists(dp):
                os.remove(dp)

    def resolve_colocation_id(self, name: str, dist_column: str,
                              shard_count: int,
                              colocate_with: Optional[str] = None) -> int:
        """The colocation id ``distribute_table`` would assign, without
        mutating the table.  Lets alter_distributed_table learn the
        table's POST-swap flip identity first, so it can register the
        flip bracket on it before any reader can see the new shard map
        (fresh ids are allocated here, so the answer stays valid)."""
        with self._lock:
            t = self.table(name)
            col = t.schema.column(dist_column)
            if col.type.kind in ("float32", "float64"):
                raise CatalogError("cannot distribute on a floating-point column")
            if colocate_with and colocate_with != "default":
                if colocate_with == "none":
                    colocation_id = self._next_colocation_id
                    self._next_colocation_id += 1
                else:
                    other = self.table(colocate_with)
                    if other.shard_count != shard_count:
                        raise CatalogError("colocation requires equal shard counts")
                    colocation_id = other.colocation_id
            else:
                # implicit default colocation: reuse the group of any table
                # with the same shard count and distribution column type
                # (reference: colocation_utils.c default colocation groups)
                colocation_id = None
                for other in self.tables.values():
                    if (other.name != name and other.is_distributed
                            and other.shard_count == shard_count
                            and other.dist_column is not None
                            and other.schema.column(other.dist_column).type.kind == col.type.kind):
                        colocation_id = other.colocation_id
                        break
                if colocation_id is None:
                    colocation_id = self._next_colocation_id
                    self._next_colocation_id += 1
            return colocation_id

    def distribute_table(self, name: str, dist_column: str, shard_count: int,
                         node_ids: list[int], colocate_with: Optional[str] = None,
                         replication_factor: int = 1,
                         colocation_id: Optional[int] = None) -> TableMeta:
        """create_distributed_table analog (reference:
        src/backend/distributed/commands/create_distributed_table.c).
        Caller is responsible for moving any existing data.  An explicit
        ``colocation_id`` (from resolve_colocation_id) skips selection."""
        if colocation_id is None:
            colocation_id = self.resolve_colocation_id(
                name, dist_column, shard_count, colocate_with)
        with self._lock:
            t = self.table(name)
            self.ddl_epoch += 1
            ranges = shard_hash_ranges(shard_count)
            rf = max(1, min(int(replication_factor), len(node_ids)))
            shards = []
            for i, (lo, hi) in enumerate(ranges):
                placements = [node_ids[(i + r) % len(node_ids)]
                              for r in range(rf)]
                shards.append(ShardMeta(self._alloc_shard_id(), i, lo, hi,
                                        placements))
            t.method = DistributionMethod.HASH
            t.dist_column = dist_column
            t.colocation_id = colocation_id
            t.shards = shards
            t.version += 1
            return t

    def make_reference_table(self, name: str, node_ids: list[int]) -> TableMeta:
        with self._lock:
            t = self.table(name)
            t.method = DistributionMethod.REFERENCE
            t.dist_column = None
            t.colocation_id = 0
            t.shards = [ShardMeta(self._alloc_shard_id(), 0, placements=list(node_ids))]
            t.version += 1
            return t

    # ---- views --------------------------------------------------------
    def create_view(self, name: str, sql: str,
                    or_replace: bool = False) -> None:
        with self._lock:
            if name in self.tables:
                raise CatalogError(f'relation "{name}" already exists')
            if name in self.views and not or_replace:
                raise CatalogError(f'relation "{name}" already exists')
            self.views[name] = sql
            self.ddl_epoch += 1

    def drop_view(self, name: str) -> None:
        with self._lock:
            if name not in self.views:
                raise CatalogError(f'view "{name}" does not exist')
            del self.views[name]
            self.tombstone("views", name)
            self.ddl_epoch += 1

    # ---- roles / grants ----------------------------------------------
    PRIVILEGES = ("select", "insert", "update", "delete", "truncate")

    def create_role(self, name: str) -> None:
        with self._lock:
            if name in self.roles:
                raise CatalogError(f'role "{name}" already exists')
            self.roles[name] = {}

    def drop_role(self, name: str) -> None:
        with self._lock:
            if name not in self.roles:
                raise CatalogError(f'role "{name}" does not exist')
            del self.roles[name]
            self.tombstone("roles", name)
            for tbl in self.grants.values():
                tbl.pop(name, None)

    def grant(self, table: str, role: str, privileges: list[str]) -> None:
        with self._lock:
            if role not in self.roles:
                raise CatalogError(f'role "{role}" does not exist')
            if table not in self.tables and table not in self.views:
                raise CatalogError(f'relation "{table}" does not exist')
            privs = list(self.PRIVILEGES) if "all" in privileges else privileges
            cur = set(self.grants.setdefault(table, {}).get(role, []))
            cur.update(privs)
            self.grants[table][role] = sorted(cur)

    def revoke(self, table: str, role: str, privileges: list[str]) -> None:
        with self._lock:
            privs = list(self.PRIVILEGES) if "all" in privileges else privileges
            cur = set(self.grants.get(table, {}).get(role, []))
            cur -= set(privs)
            if table in self.grants:
                if cur:
                    self.grants[table][role] = sorted(cur)
                else:
                    self.grants[table].pop(role, None)

    def has_privilege(self, role: str, table: str, privilege: str) -> bool:
        return privilege in self.grants.get(table, {}).get(role, ())

    # ---- sequences ----------------------------------------------------
    SEQ_CACHE_BLOCK = 32

    def create_sequence(self, name: str, start: int = 1,
                        increment: int = 1) -> None:
        with self._lock:
            if name in self.sequences:
                raise CatalogError(f'sequence "{name}" already exists')
            if increment == 0:
                raise CatalogError("sequence increment cannot be zero")
            self.sequences[name] = {"value": start, "increment": increment,
                                    "start": start}

    def drop_sequence(self, name: str) -> None:
        with self._lock:
            if name not in self.sequences:
                raise CatalogError(f'sequence "{name}" does not exist')
            del self.sequences[name]
            self.tombstone("sequences", name)
            self._seq_cache.pop(name, None)
            self._seq_currval.pop(name, None)

    def nextval(self, name: str) -> int:
        """Next sequence value; values come from an in-memory block
        reserved — durably and under the cross-process lock with a
        read-merge, so two coordinators can never reserve overlapping
        blocks and no value is handed out before its reservation is on
        disk (crash = gap, never a repeat)."""
        with self._lock:
            if name not in self.sequences:
                raise CatalogError(f'sequence "{name}" does not exist')
            cache = self._seq_cache.get(name)
            if cache is None or cache[0] == cache[1]:
                from citus_tpu_torch.storage.overlay import current_overlay
                txn = current_overlay()
                if txn is not None and txn.catalog_dirty:
                    # block reservation persists the whole document; with
                    # staged DDL in memory that would leak uncommitted
                    # state to disk — fail closed
                    from citus_tpu_torch.errors import UnsupportedFeatureError
                    raise UnsupportedFeatureError(
                        "nextval needs a new block reservation, which "
                        "cannot run after DDL in the same transaction")
                # another session's staged DDL must not be persisted by
                # our block reservation's document store
                self._await_no_staging()
                with _catalog_flock(self.data_dir):
                    # pick up foreign reservations before extending
                    self._merge_foreign_locked()
                    seq = self.sequences.get(name)
                    if seq is None:
                        raise CatalogError(
                            f'sequence "{name}" does not exist')
                    inc = seq["increment"]
                    base = seq["value"]
                    seq["value"] = base + inc * self.SEQ_CACHE_BLOCK
                    self._store_locked()  # durable BEFORE handing out
                self._seq_cache[name] = cache = [base, seq["value"]]
            inc = self.sequences[name]["increment"]
            v = cache[0]
            cache[0] = v + inc
            self._seq_currval[name] = v
            return v

    def currval(self, name: str) -> int:
        if name not in self.sequences:
            raise CatalogError(f'sequence "{name}" does not exist')
        v = self._seq_currval.get(name)
        if v is None:
            raise CatalogError(
                f'currval of sequence "{name}" is not yet defined in this session')
        return v

    def setval(self, name: str, value: int) -> int:
        with self._lock:
            seq = self.sequences.get(name)
            if seq is None:
                raise CatalogError(f'sequence "{name}" does not exist')
            seq["value"] = value + seq["increment"]
            self._seq_cache.pop(name, None)
            self._seq_currval[name] = value
        self.commit()
        return value

    def _alloc_shard_id(self) -> int:
        with self._lock:
            sid = self._next_shard_id
            self._next_shard_id += 1
            return sid

    def flip_placement(self, table, shard, source_node: int,
                       target_node: int) -> None:
        """Retarget one shard placement: the metadata half of a shard
        move.  In-memory only — the caller commits, and the commit IS
        the move's 2PC decision record (transaction/branches.py
        commit_metadata_flip).  Confined to operations/shard_transfer.py
        (cituslint CONF01): a flip anywhere else would skip the final
        catch-up under the colocation group's write lock and lose
        writes raced onto the source."""
        with self._lock:
            shard.placements = [target_node if n == source_node else n
                                for n in shard.placements]
            table.version += 1

    # ---- nodes --------------------------------------------------------
    def ensure_nodes(self, count: int) -> list[int]:
        with self._lock:
            for nid in range(count):
                if nid not in self.nodes:
                    self.nodes[nid] = NodeMeta(nid)
            return sorted(self.nodes)

    def active_node_ids(self) -> list[int]:
        return sorted(n.node_id for n in self.nodes.values() if n.is_active)

    def is_remote_node(self, node: int) -> bool:
        """True when ``node``'s placements live on ANOTHER coordinator
        (it advertises a data-plane endpoint and this process does not
        host it)."""
        if self.hosted_nodes is None or node in self.hosted_nodes:
            return False
        meta = self.nodes.get(node)
        return meta is not None and meta.endpoint is not None

    def node_endpoint(self, node: int) -> Optional[tuple]:
        meta = self.nodes.get(node)
        return meta.endpoint if meta is not None else None

    # ---- shard data directories --------------------------------------
    def shard_dir(self, table: str, shard_id: int, placement_node: int = 0) -> str:
        return os.path.join(self.data_dir, "data", table,
                            f"shard_{shard_id}", f"placement_{placement_node}")

    # ---- text dictionaries --------------------------------------------
    def _dict_path(self, table: str, column: str) -> str:
        return os.path.join(self.data_dir, f"dict__{table}__{column}.json")

    def _ensure_dict(self, table: str, column: str) -> None:
        key = (table, column)
        # reentrant: encode_strings already holds the catalog lock, and
        # lookup paths may race store_document clearing the caches
        with self._lock:
            if key in self._dicts:
                return
            p = self._dict_path(table, column)
            if not os.path.exists(p):
                # attached coordinator without the side file: the
                # authority holds the canonical dictionary — mirror it
                self._fetch_remote_dict(table, column)
            words = []
            if os.path.exists(p):
                with open(p) as fh:
                    words = json.load(fh)
            self._dicts[key] = words
            self._dict_index[key] = {w: i for i, w in enumerate(words)}
            self._dict_sig[key] = _stat_sig(p)

    def _fetch_remote_dict(self, table: str, column: str) -> bool:
        """Mirror the authority's dictionary side file (returns True
        when fetched).  No-op without a remote commit transport."""
        tr = getattr(self, "commit_transport", None)
        if tr is None or not getattr(tr, "commit_is_remote", False):
            return False
        try:
            words = tr.fetch_dict(table, column)
        except Exception:
            return False
        if words is None:
            return False
        p = self._dict_path(table, column)
        tmp = p + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(words, fh)
        os.replace(tmp, p)
        key = (table, column)
        with self._lock:
            self._dicts[key] = list(words)
            self._dict_index[key] = {w: i for i, w in enumerate(words)}
            self._dict_sig[key] = _stat_sig(p)
        return True

    def _merge_disk_dict(self, table: str, column: str) -> None:
        """Adopt words another coordinator appended to the on-disk
        dictionary since we last read/wrote it.  Growth is append-only
        and always happens under the catalog flock, so the disk file is
        a strict extension of what we hold."""
        key = (table, column)
        p = self._dict_path(table, column)
        sig = _stat_sig(p)
        if sig is None or sig == self._dict_sig.get(key):
            return
        with open(p) as fh:
            disk = json.load(fh)
        with self._lock:
            words, index = self._dicts[key], self._dict_index[key]
            for w in disk[len(words):]:
                index.setdefault(w, len(words))
                words.append(w)
            self._dict_sig[key] = sig

    def _store_dict(self, table: str, column: str) -> None:
        key = (table, column)
        dp = self._dict_path(table, column)
        tmp = dp + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(self._dicts[key], fh)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, dp)
        with self._lock:
            self._dict_sig[key] = _stat_sig(dp)

    def _word_type(self, table: str, column: str):
        """ColumnType for a dictionary column when it needs kind-specific
        canonicalization (uuid/bytea/array), else None (plain text)."""
        t = self.tables.get(table)
        if t is None or not t.schema.has(column):
            return None
        ct = t.schema.column(column).type
        return ct if ct.is_text and ct.kind != "text" else None

    def encode_strings(self, table: str, column: str, values):
        """Map strings -> table-global dictionary ids, growing the
        dictionary for unseen strings (ingest path, coordinator-only).
        Vectorized: unique the batch once, dict-lookup only the uniques.

        Growth runs under the cross-process catalog lock with a
        read-merge before assignment and an fsync'd store after, so two
        coordinators ingesting into one table can never assign the same
        id to different words, and every id handed out is durable before
        any transaction commit record can reference it."""
        import numpy as np
        with self._lock:
            key = (table, column)
            self._ensure_dict(table, column)
            words, index = self._dicts[key], self._dict_index[key]
            # element-wise fill: np.asarray would turn equal-length list
            # values (array columns) into a 2-D object array
            vlist = list(values)
            arr = np.empty(len(vlist), dtype=object)
            for i, v in enumerate(vlist):
                arr[i] = v
            nulls = np.array([v is None for v in arr], dtype=bool)
            out = np.zeros(len(arr), dtype=np.int64)
            nn = ~nulls
            if not nn.any():
                return out
            wt = self._word_type(table, column)
            if wt is not None:
                # uuid/bytea/array: canonicalize so equal logical values
                # share one dictionary word (types.normalize_word)
                arr = arr.copy()
                arr[nn] = [wt.normalize_word(v) for v in arr[nn]]
            uniq, inverse = np.unique(arr[nn].astype(str), return_inverse=True)
            uid = np.empty(len(uniq), dtype=np.int64)
            fresh = [w for w in (str(w) for w in uniq) if w not in index]
            if fresh:
                tr = getattr(self, "commit_transport", None)
                if tr is not None and getattr(tr, "commit_is_remote", False):
                    # attached coordinator: id assignment must be global —
                    # route growth through the metadata authority (it
                    # holds the canonical dictionary under its flock) and
                    # adopt the returned full word list
                    new_words = tr.grow_dict(table, column, fresh)
                    for i, w in enumerate(new_words):
                        if i >= len(words):
                            words.append(w)
                        index.setdefault(w, i)
                    self._store_dict(table, column)
                else:
                    with _catalog_flock(self.data_dir):
                        self._merge_disk_dict(table, column)
                        grew = False
                        for w in fresh:
                            if w not in index:
                                index[w] = len(words)
                                words.append(w)
                                grew = True
                        if grew:
                            self._store_dict(table, column)
            for i, w in enumerate(uniq):
                uid[i] = index[str(w)]  # plain str, not np.str_
            out[nn] = uid[inverse]
            return out

    def lookup_string_id(self, table: str, column: str, value: str) -> Optional[int]:
        self._ensure_dict(table, column)
        wt = self._word_type(table, column)
        if wt is not None:
            try:
                value = wt.normalize_word(value)
            except Exception:
                return None  # malformed literal can never match
        return self._dict_index[(table, column)].get(value)

    def decode_strings(self, table: str, column: str, ids) -> list:
        self._ensure_dict(table, column)
        words = self._dicts[(table, column)]
        if any(i >= len(words) for i in ids):
            # an id beyond our mirror: another coordinator grew the
            # dictionary — adopt the shared-FS growth, else refetch from
            # the authority
            self._merge_disk_dict(table, column)
            words = self._dicts[(table, column)]
            if any(i >= len(words) for i in ids):
                self._fetch_remote_dict(table, column)
                words = self._dicts[(table, column)]
        return [words[i] if 0 <= i < len(words) else None for i in ids]

    def dictionary(self, table: str, column: str) -> list[str]:
        self._ensure_dict(table, column)
        return self._dicts[(table, column)]
