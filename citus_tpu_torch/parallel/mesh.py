"""The device mesh: the cards a repartition join runs over.

The reference's mesh (``citus_tpu/parallel/mesh.py``) is a
``jax.sharding.Mesh`` with one axis, ``shard``, over every device, and
its collectives (psum, all_gather, all_to_all) run over that axis.  The
port's mesh holds one card: ``shape[SHARD_AXIS] == 1``, and every
exchange over it is the identity.  More than one card, with NCCL, is
ROADMAP.md A9b.
"""

from __future__ import annotations

SHARD_AXIS = "shard"


class DeviceMesh:
    """The torch devices of a mesh, along its one axis."""

    def __init__(self, devices):
        self.devices = tuple(devices)
        if len(self.devices) != 1:
            raise NotImplementedError(
                "a mesh of more than one card is not ported yet "
                "(ROADMAP.md A9b)")
        self.shape = {SHARD_AXIS: len(self.devices)}

    @property
    def device(self):
        return self.devices[0]


def default_mesh(device) -> DeviceMesh:
    """The one-card mesh of ``device`` (a torch device)."""
    return DeviceMesh([device])
