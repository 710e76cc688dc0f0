"""Catalog-persisted tenant control plane: the replicated write door.

Reference: Citus keeps tenant-facing control state in pg_dist_* catalogs
precisely so every MX node plans and admits identically; a GUC-only
quota would fork behavior per coordinator.  This module is the ONE
place allowed to write the catalog's tenant_quotas / priority_classes
sections (cituslint CONF01 confines Catalog.put_tenant_quota,
drop_tenant_quota and put_priority_class here): each write registers an
operation, runs through the 2PC commit_metadata_flip sequence — so
concurrent coordinators arbitrate through the metadata authority, and a
crash mid-write resolves by presumed abort — and then re-hydrates the
process-local registry from the committed document.

The registry (workload/registry.py) stays the hot-path read side;
hydration is what makes admission decisions identical on every
coordinator: same catalog document -> same registry rows -> same
weighted-stride tree -> same admit/shed/queue outcome.
"""

from __future__ import annotations

import uuid

from citus_tpu_torch.workload.registry import GLOBAL_TENANTS

#: tenant names / class names this process mirrored from the catalog.
#: Hydration retires only rows it previously installed, so quotas
#: registered directly against the registry (tests, internal tenants
#: like the rollup refresh worker) survive catalog reloads.
_MIRRORED_TENANTS: set = set()
_MIRRORED_CLASSES: set = set()


def _flip(cl, kind: str, mutate) -> None:
    """One replicated catalog mutation: register the operation, bracket
    ``mutate()`` and the commit with the decide/decided phase markers
    (the reference's ``transaction/branches.py commit_metadata_flip``),
    retire the registry row.  cat.commit() publishes the change to
    attached coordinators via the on_commit hook."""
    from citus_tpu_torch.operations.cleaner import (
        complete_operation, mark_operation_phase, register_operation,
    )
    cat = cl.catalog
    op_id = uuid.uuid4().int & ((1 << 62) - 1)
    register_operation(cat, op_id, kind=kind)
    ok = False
    try:
        mark_operation_phase(cat, op_id, "decide")
        mutate()
        cat.commit()
        mark_operation_phase(cat, op_id, "decided")
        ok = True
    finally:
        complete_operation(cat, op_id, success=ok)


def replicated_set_quota(cl, tenant: str, *, weight: float = 0.0,
                         max_concurrency: int = 0,
                         rate_limit_qps: float = 0.0, queue_depth: int = 0,
                         priority_class: str = "") -> None:
    """citus_add_tenant_quota: a replicated catalog write followed by
    the local registry mirror (remote coordinators mirror when the
    sync engine or invalidation reload delivers the document)."""
    quota = {
        "weight": float(weight),
        "max_concurrency": int(max_concurrency),
        "rate_limit_qps": float(rate_limit_qps),
        "queue_depth": int(queue_depth),
        "priority_class": str(priority_class),
    }
    cat = cl.catalog
    _flip(cl, "tenant_quota",
          lambda: cat.put_tenant_quota(str(tenant), quota))
    hydrate_tenant_registry(cat)


def replicated_remove_quota(cl, tenant: str) -> bool:
    """citus_remove_tenant_quota: tombstoned catalog drop (the merge
    never resurrects it from a concurrent coordinator's document)."""
    cat = cl.catalog
    found: dict = {}

    def mutate():
        found["hit"] = cat.drop_tenant_quota(str(tenant))

    _flip(cl, "tenant_quota_drop", mutate)
    GLOBAL_TENANTS.remove(str(tenant))
    _MIRRORED_TENANTS.discard(str(tenant))
    return bool(found.get("hit"))


def replicated_set_class(cl, name: str, weight: float) -> None:
    """citus_add_priority_class: register/update a class node in the
    scheduler's two-level stride tree, replicated like any quota."""
    cat = cl.catalog
    _flip(cl, "priority_class",
          lambda: cat.put_priority_class(str(name), float(weight)))
    hydrate_tenant_registry(cat)


def hydrate_tenant_registry(cat) -> int:
    """Mirror the catalog's replicated tenant sections into the
    process-local registry.  Every coordinator runs this at open, on
    catalog reload, and after each sync apply; it is idempotent and
    last-write-wins per tenant, so coordinators holding the same
    document always end with identical registries."""
    with cat._lock:
        quotas = {str(t): dict(q) for t, q in cat.tenant_quotas.items()}
        classes = {str(c): dict(v)
                   for c, v in cat.priority_classes.items()}
    for t, q in quotas.items():
        GLOBAL_TENANTS.set_quota(
            t,
            weight=float(q.get("weight", 0.0)),
            max_concurrency=int(q.get("max_concurrency", 0)),
            rate_limit_qps=float(q.get("rate_limit_qps", 0.0)),
            queue_depth=int(q.get("queue_depth", 0)),
            priority_class=str(q.get("priority_class", "")))
    for c, v in classes.items():
        GLOBAL_TENANTS.set_class(c, float(v.get("weight", 1.0)))
    # retire only rows we mirrored earlier whose catalog entry is gone
    for t in _MIRRORED_TENANTS - set(quotas):
        GLOBAL_TENANTS.remove(t)
    for c in _MIRRORED_CLASSES - set(classes):
        GLOBAL_TENANTS.remove_class(c)
    _MIRRORED_TENANTS.clear()
    _MIRRORED_TENANTS.update(quotas)
    _MIRRORED_CLASSES.clear()
    _MIRRORED_CLASSES.update(classes)
    return len(quotas)
