"""citus_tpu_torch — the PyTorch/CUDA port of citus_tpu.

The same distributed analytical SQL engine (hash-sharded columnar
tables, a layered planner that splits aggregates into per-shard partial
and coordinator combine halves) with its device half on one NVIDIA GPU:
plain tensor code around hand-written CUDA kernels for Hopper
(``csrc/``), built at first use.  The JAX package ``citus_tpu`` stays
beside it, unchanged, as the reference the port is held against; this
package imports neither ``jax`` nor anything of ``citus_tpu``.

Exact aggregates (DECIMAL as scaled int64) need 64-bit lanes.  PyTorch
keeps int64 and float64 wherever a tensor carries them, so there is no
switch to flip as ``citus_tpu`` flips ``jax_enable_x64``: every device
dtype comes from ``schema.scan_dtype(..., device=True)`` and every
typed constant from ``planner/bound.py``'s ``const``.

The public API lives on :class:`citus_tpu_torch.cluster.Cluster`.
"""

from citus_tpu_torch.version import __version__
from citus_tpu_torch.config import Settings, current_settings, settings_override
from citus_tpu_torch.cluster import Cluster
from citus_tpu_torch import types

__all__ = [
    "__version__",
    "Settings",
    "current_settings",
    "settings_override",
    "Cluster",
    "types",
]
