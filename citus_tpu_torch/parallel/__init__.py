"""The device mesh, its combine and the repartition shuffle of the port.

The reference (``citus_tpu/parallel``) runs its data plane as XLA
collectives over a ``jax.sharding.Mesh``.  The port's mesh is a list of
torch devices, one per member (``parallel/mesh.py``; a card may hold
several members), driven by one process: partial aggregates combine
over it through ``mesh_combine`` (B6), and the repartition join packs
(B7), exchanges (``exchange_blocks``) and joins (B8) over it
(``parallel/shuffle.py``).  Transport between hosts (NCCL) is
ROADMAP.md A9b.
"""

from citus_tpu_torch.parallel.mesh import (
    SHARD_AXIS, DeviceMesh, default_mesh, mesh_combine,
)

__all__ = ["SHARD_AXIS", "DeviceMesh", "default_mesh", "mesh_combine"]
