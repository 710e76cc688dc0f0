"""Versioned catalog-document migrations.

Reference: the 69 versioned SQL migration scripts
(src/backend/distributed/sql/citus--*.sql) upgraded through ALTER
EXTENSION citus UPDATE; ci/check_migration_files.sh enforces their
hygiene.  Here the catalog is one JSON document, so a migration is a
pure function old-shape -> new-shape, applied in order at load time;
``format_version`` records the shape a document was written with.

Rules (the reference's migration discipline):
- migrations are append-only: never edit a shipped migration, add a new
  version;
- each migration must be idempotent over already-migrated fields (a
  merge may feed a half-new document);
- loading a NEWER version than this build understands is refused —
  silently dropping unknown sections would corrupt a shared cluster
  (PostgreSQL refuses to start on a newer catalog version the same way).
"""

from __future__ import annotations

from citus_tpu_torch.errors import CatalogError

#: the document shape this build writes
CATALOG_FORMAT_VERSION = 3

#: every section the current shape carries with an empty default —
#: migration 0->1 materializes them so later code never .get()-guards
_SECTIONS_V1 = (
    "schemas", "views", "sequences", "roles", "grants", "functions",
    "types", "enum_columns", "policies", "rls", "triggers", "ts_configs",
    "extensions", "domain_columns", "domains", "collations",
    "publications", "statistics",
)


def _migrate_0_to_1(doc: dict) -> None:
    """Round-3 shape -> round-4: breadth sections and per-table
    index/partition fields appear (with empty defaults)."""
    for sec in _SECTIONS_V1:
        doc.setdefault(sec, {})
    for td in doc.get("tables", []):
        td.setdefault("indexes", [])
        td.setdefault("partition_by", None)
        td.setdefault("partition_of", None)
        td.setdefault("foreign_keys", [])
        td.setdefault("version", 0)


def _migrate_1_to_2(doc: dict) -> None:
    """Round-4 shape -> round-5: node rows may carry a data-plane
    endpoint (host/port; pg_dist_node nodename/nodeport analog).
    Absent endpoint = single-host placement, so old rows pass through;
    this migration only guarantees the keys parse uniformly."""
    for nd in doc.get("nodes", []):
        if "host" in nd and "port" not in nd:
            nd.pop("host")  # half-written endpoint: meaningless alone


def _migrate_2_to_3(doc: dict) -> None:
    """Round-5 shape -> round-6: the tenant control plane moves into
    the catalog (tenant quotas + priority classes replicate to every
    coordinator instead of living process-local)."""
    doc.setdefault("tenant_quotas", {})
    doc.setdefault("priority_classes", {})


#: ordered, append-only: MIGRATIONS[v] lifts a version-v document to v+1
MIGRATIONS = {
    0: _migrate_0_to_1,
    1: _migrate_1_to_2,
    2: _migrate_2_to_3,
}


def migrate_document(doc: dict) -> dict:
    """Lift a document to CATALOG_FORMAT_VERSION in place (returns it).
    Refuses documents from a newer build."""
    v = doc.get("format_version", 0)
    if v > CATALOG_FORMAT_VERSION:
        raise CatalogError(
            f"catalog document format {v} is newer than this build "
            f"(understands up to {CATALOG_FORMAT_VERSION}); upgrade "
            "citus_tpu_torch before opening this data directory")
    while v < CATALOG_FORMAT_VERSION:
        fn = MIGRATIONS.get(v)
        if fn is None:
            raise CatalogError(f"no migration from catalog format {v}")
        fn(doc)
        v += 1
    doc["format_version"] = CATALOG_FORMAT_VERSION
    return doc
