"""Workload management: tenant quotas and fair-share admission.

The subsystem the rest of the package admits device work through:

- ``registry``  — per-tenant quotas (weight / concurrency / QPS /
  queue depth) + pinned-node records, GUC-backed defaults
- ``scheduler`` — stride-scheduled fair-share slot dispatch over the
  shared task pool, with load shedding and live per-tenant stats

The JAX package's ``isolation`` module (pin a tenant's router traffic to
a dedicated host) needs shard moves and splits and waits for ROADMAP.md
A14.
"""

from citus_tpu_torch.workload.registry import (  # noqa: F401
    GLOBAL_TENANTS, SHARED_TENANT, TenantQuota, TenantRegistry, tenant_key,
)
from citus_tpu_torch.workload.scheduler import (  # noqa: F401
    GLOBAL_SCHEDULER, TenantScheduler,
)
