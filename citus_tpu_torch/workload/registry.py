"""Tenant quota registry.

Reference: citus_stat_tenants attributes load per distribution-key
value (stats/stat_tenants.c), and the multi-tenant SaaS guidance layers
quotas on top; here the registry is the control half of the workload
scheduler — per-tenant weight, concurrency cap, QPS rate limit, queue
depth, and an optional pinned node (the isolate_tenant_to_node analog).

Tenants are identified the same way TenantStats keys them: the string
form of the router distribution-key value; the reserved name "*" is the
shared bucket for multi-shard/analytic queries that have no router key.
Quotas are process-local control state (like the GUC system), set
through ``GLOBAL_TENANTS.set_quota`` (the SQL writers
``citus_add_tenant_quota``/``citus_add_priority_class`` replicate the
quota as a catalog write); tenants WITHOUT a quota fall
back to the citus.tenant_* GUC defaults, so an empty registry degrades
to one uniform tenant class.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional

#: the shared bucket for queries with no router key (multi-shard scans)
SHARED_TENANT = "*"


def tenant_key(router_key) -> str:
    """Canonical tenant name for a plan's router key (None = shared)."""
    return SHARED_TENANT if router_key is None else str(router_key)


@dataclass
class TenantQuota:
    weight: float = 0.0           # 0 = use citus.tenant_default_weight
    max_concurrency: int = 0      # 0 = unlimited
    rate_limit_qps: float = 0.0   # 0 = use citus.tenant_rate_limit_qps
    queue_depth: int = 0          # 0 = use citus.tenant_queue_depth
    pinned_node: Optional[int] = None
    # "" = citus.tenant_default_priority_class; classes form the upper
    # level of the scheduler's two-level stride tree
    priority_class: str = ""


class TenantRegistry:
    def __init__(self):
        self._mu = threading.Lock()
        self._quotas: dict[str, TenantQuota] = {}
        # priority class -> weight of its node in the stride tree;
        # unregistered classes weigh 1.0 (a lone default class makes
        # the tree degenerate to the flat ring)
        self._classes: dict[str, float] = {}

    def set_quota(self, tenant: str, *, weight: float = 0.0,
                  max_concurrency: int = 0, rate_limit_qps: float = 0.0,
                  queue_depth: int = 0, priority_class: str = "") -> None:
        with self._mu:
            q = self._quotas.setdefault(tenant, TenantQuota())
            q.weight = float(weight)
            q.max_concurrency = int(max_concurrency)
            q.rate_limit_qps = float(rate_limit_qps)
            q.queue_depth = int(queue_depth)
            q.priority_class = str(priority_class)

    def get(self, tenant: str) -> Optional[TenantQuota]:
        with self._mu:
            return self._quotas.get(tenant)

    def remove(self, tenant: str) -> bool:
        with self._mu:
            return self._quotas.pop(tenant, None) is not None

    def pin(self, tenant: str, node: Optional[int]) -> None:
        """Record the dedicated host a tenant's router traffic now
        lands on (the placement move itself is the caller's job)."""
        with self._mu:
            q = self._quotas.setdefault(tenant, TenantQuota())
            q.pinned_node = node

    def set_class(self, name: str, weight: float) -> None:
        with self._mu:
            self._classes[name] = max(float(weight), 1e-6)

    def remove_class(self, name: str) -> bool:
        with self._mu:
            return self._classes.pop(name, None) is not None

    def class_weight(self, name: str) -> float:
        with self._mu:
            return self._classes.get(name, 1.0)

    def classes_view(self) -> list[tuple]:
        with self._mu:
            return sorted(self._classes.items())

    def rows_view(self) -> list[tuple]:
        with self._mu:
            return [(t, q.weight, q.max_concurrency, q.rate_limit_qps,
                     q.queue_depth, q.pinned_node, q.priority_class)
                    for t, q in sorted(self._quotas.items())]

    def clear(self) -> None:
        with self._mu:
            self._quotas.clear()
            self._classes.clear()


#: process-wide quota table (control state, like the GUC tree)
GLOBAL_TENANTS = TenantRegistry()
