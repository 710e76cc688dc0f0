"""The device mesh and the repartition shuffle of the port.

The reference (``citus_tpu/parallel``) runs its data plane as XLA
collectives over a ``jax.sharding.Mesh``.  The port has, for now, a
mesh of one card: ``parallel/mesh.py`` gives its shape, and
``parallel/shuffle.py`` the partition (B7) and sort-join (B8) kernels
that the repartition join runs on it.  The collectives (NCCL) come with
more than one card (ROADMAP.md A9b).
"""

from citus_tpu_torch.parallel.mesh import SHARD_AXIS, DeviceMesh, default_mesh

__all__ = ["SHARD_AXIS", "DeviceMesh", "default_mesh"]
