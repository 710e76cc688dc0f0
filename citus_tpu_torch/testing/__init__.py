"""Test-support machinery shipped with the framework (the reference
compiles test helper UDFs into the extension,
src/backend/distributed/test/, and injects transport faults with a
mitmproxy sidecar, src/test/regress/mitmscripts/)."""

from citus_tpu_torch.testing.faults import FaultInjector, FAULTS, FaultError

__all__ = ["FaultInjector", "FAULTS", "FaultError"]
