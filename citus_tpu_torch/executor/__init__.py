"""Distributed executor.

The TPU-native counterpart of the reference's adaptive executor stack
(src/backend/distributed/executor/): tasks are per-shard kernel
invocations instead of per-shard SQL text over libpq; the combine step is
an ICI collective or a host merge instead of a coordinator combine query.
"""

from citus_tpu_torch.executor.executor import execute_select, Result

__all__ = ["execute_select", "Result"]
