"""Multi-coordinator metadata subsystem: catalog sync engine plus the
catalog-persisted tenant control plane (the Citus MX "query from any
node" analog — see sync.py and quotas.py)."""

from citus_tpu_torch.metadata.quotas import (hydrate_tenant_registry,
                                       replicated_remove_quota,
                                       replicated_set_class,
                                       replicated_set_quota)
from citus_tpu_torch.metadata.sync import (MetadataSync, SYNC_LAG_ROUNDS,
                                     authority_versions, serve_metadata_pull,
                                     version_vector)

__all__ = [
    "MetadataSync",
    "SYNC_LAG_ROUNDS",
    "authority_versions",
    "serve_metadata_pull",
    "version_vector",
    "hydrate_tenant_registry",
    "replicated_remove_quota",
    "replicated_set_class",
    "replicated_set_quota",
]
