"""The device mesh and the combine of partial aggregates over it (B6).

The reference's mesh (``citus_tpu/parallel/mesh.py``) is a
``jax.sharding.Mesh`` with one axis, ``shard``, over ``jax.devices()``;
``sharded_partial_agg`` runs the worker on each member's batch and
combines the partial states over that axis with ``psum``, or
``all_gather`` and a min/max.  The port's ``DeviceMesh`` is a list of
torch devices, one per member, where a device may repeat: ``n`` members
on one card are the counterpart of XLA's
``--xla_force_host_platform_device_count``, each member's registers and
blocks a separate allocation.  One process drives every member, as the
reference's one JAX process drives its mesh.

- ``mesh_combine`` (B6, ``csrc/mesh_combine.cu``) combines each member's
  partial registers, every position in one launch: ``sum`` in member
  order, ``min`` / ``max`` propagating NaN as ``jnp.min`` / ``jnp.max``
  do, ``none`` stacked per member.  ``mesh_combine_plain`` is its plain
  version; on CUDA tensors the wrapper launches the kernel (counted in
  ``mesh_combine.launches``) or raises, on CPU tensors it runs the plain
  version.
- ``to_member`` is the transport between members: a copy to the member's
  card when the tensor lies on another (``Tensor.to(non_blocking=True)``
  inside one process), nothing on one card.  Between hosts it is not
  ported: NCCL takes its place there (ROADMAP.md A9b).
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Callable, Sequence

import torch

from citus_tpu_torch.ops.cuda_build import count_launch

SHARD_AXIS = "shard"
#: members a mesh may have: the combine and the exchange kernels take
#: every member's pointers in their parameter blocks
MAX_MEMBERS = 16
_MC_MAX_POS = 24
_KINDS = {"sum": 0, "min": 1, "max": 2, "none": 3}
_DTYPES = {torch.int64: 0, torch.float64: 1, torch.int32: 2,
           torch.float32: 3}


class DeviceMesh:
    """The torch devices of a mesh's members, along its one axis; a
    device may hold several members."""

    def __init__(self, devices):
        self.devices = tuple(torch.device(d) for d in devices)
        if not 1 <= len(self.devices) <= MAX_MEMBERS:
            raise ValueError(f"a mesh has 1 to {MAX_MEMBERS} members, got "
                             f"{len(self.devices)}")
        if len({d.type for d in self.devices}) != 1:
            raise NotImplementedError(
                "a mesh's members share one kind of device; a mesh across "
                "kinds or hosts is not ported yet (ROADMAP.md A9b)")
        self.shape = {SHARD_AXIS: len(self.devices)}

    @property
    def device(self):
        """Member 0's device: where combined partials and the stacked
        outputs of an exchange land."""
        return self.devices[0]

    def device_of(self, i: int):
        return self.devices[i]

    def __repr__(self) -> str:
        return f"DeviceMesh({[str(d) for d in self.devices]})"


def default_mesh(device) -> DeviceMesh:
    """The one-member mesh of ``device`` (a torch device)."""
    return DeviceMesh([device])


def shard_axis_size(mesh: DeviceMesh) -> int:
    return mesh.shape[SHARD_AXIS]


def to_member(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` on ``device``: the transport between a mesh's members.  One
    process, one card: nothing moves; another card of the host: an
    asynchronous copy on the current streams."""
    return t if t.device == device else t.to(device, non_blocking=True)


def on_member(device):
    """The context a member's kernels launch in: its card made current
    (the C launches take the current device's stream), nothing on the
    CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


# ----------------------------------------------------------------- B6


def _nan_pick(kind: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """XLA's float min/max of two: NaN wins, then -0.0 < +0.0."""
    take_b = (b < a) if kind == "min" else (b > a)
    tie = (a == b) & (torch.signbit(b) if kind == "min" else torch.signbit(a))
    r = torch.where(take_b | tie, b, a)
    return torch.where(torch.isnan(a) | torch.isnan(b),
                       torch.full_like(a, float("nan")), r)


def mesh_combine_plain(kinds: Sequence[str], members: Sequence[Sequence]):
    """``mesh_combine`` in eager tensor ops: ``members[m][i]`` is member
    m's register of position i; -> position i combined over members by
    ``kinds[i]``, on member 0's device."""
    dev = members[0][0].device
    out = []
    for i, kind in enumerate(kinds):
        regs = [to_member(m[i], dev) for m in members]
        if kind == "none":
            out.append(torch.stack(regs))
            continue
        acc = regs[0].clone()
        for r in regs[1:]:
            if kind == "sum":
                acc = acc + r
            elif acc.dtype.is_floating_point:
                acc = _nan_pick(kind, acc, r)
            else:
                acc = torch.minimum(acc, r) if kind == "min" \
                    else torch.maximum(acc, r)
        out.append(acc)
    return tuple(out)


class _McPos(ctypes.Structure):
    _fields_ = [("kind", ctypes.c_int32), ("dtype", ctypes.c_int32),
                ("numel", ctypes.c_int64), ("out", ctypes.c_void_p),
                ("in_", ctypes.c_void_p * MAX_MEMBERS)]


class _McParams(ctypes.Structure):
    _fields_ = [("n_members", ctypes.c_int64), ("n_pos", ctypes.c_int64),
                ("pos", _McPos * _MC_MAX_POS)]


_lib = None


def _library():
    """``csrc/mesh_combine.cu`` built and loaded, its C interface typed
    and its parameter layout checked against the ctypes mirror."""
    global _lib
    if _lib is not None:
        return _lib
    from citus_tpu_torch.ops import cuda_build
    lib = cuda_build.load("mesh_combine")
    lib.mesh_combine_launch.argtypes = [ctypes.POINTER(_McParams),
                                        ctypes.c_void_p]
    lib.mesh_combine_launch.restype = ctypes.c_int
    for fn, want in ((lib.mesh_combine_params_size,
                      ctypes.sizeof(_McParams)),
                     (lib.mesh_combine_max_members, MAX_MEMBERS),
                     (lib.mesh_combine_max_pos, _MC_MAX_POS)):
        fn.restype, fn.argtypes = ctypes.c_int, []
        if fn() != want:
            raise RuntimeError("mesh_combine: parameter block layout "
                               "differs between Python and CUDA")
    _lib = lib
    return lib


def _combine_launch(kinds, members):
    dev = members[0][0].device
    n = len(members)
    if not 1 <= n <= MAX_MEMBERS:
        raise ValueError(f"mesh_combine: 1 to {MAX_MEMBERS} members")
    regs, outs = [], []
    for i, kind in enumerate(kinds):
        if kind not in _KINDS:
            raise ValueError(f"mesh_combine: unknown kind {kind!r}")
        row = [to_member(m[i], dev) for m in members]
        first = row[0]
        if first.dtype not in _DTYPES:
            raise ValueError(f"mesh_combine: no kernel for {first.dtype} "
                             "registers")
        for r in row:
            if r.dtype != first.dtype or r.shape != first.shape \
                    or not r.is_contiguous():
                raise ValueError(f"mesh_combine: position {i}: members' "
                                 "registers differ in dtype or shape, or "
                                 "are not contiguous")
        regs.append(row)
        outs.append(torch.empty(((n,) if kind == "none" else ())
                                + tuple(first.shape), dtype=first.dtype,
                                device=dev))
    lib = _library()
    with on_member(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for a in range(0, len(kinds), _MC_MAX_POS):
            p = _McParams()
            p.n_members = n
            chunk = range(a, min(a + _MC_MAX_POS, len(kinds)))
            p.n_pos = len(chunk)
            for k, i in enumerate(chunk):
                q = p.pos[k]
                q.kind, q.dtype = _KINDS[kinds[i]], _DTYPES[regs[i][0].dtype]
                q.numel, q.out = regs[i][0].numel(), outs[i].data_ptr()
                for m, r in enumerate(regs[i]):
                    q.in_[m] = r.data_ptr()
            err = lib.mesh_combine_launch(ctypes.byref(p), stream)
            if err != 0:
                raise RuntimeError(f"mesh_combine launch failed: CUDA "
                                   f"error {err}")
            count_launch(mesh_combine)
    return tuple(outs)


def mesh_combine(kinds: Sequence[str], members: Sequence[Sequence]):
    """The partial registers of every member combined: ``members[m]`` is
    member m's tuple of registers (int64, float64 or int32, one shape per
    position across members), ``kinds[i]`` in {sum, min, max, none}.
    -> position i combined, on member 0's device (``none``: stacked,
    ``[n, ...]``).  CUDA tensors launch ``csrc/mesh_combine.cu`` once for
    up to 24 positions (Q1 has 17) (each launch counted in
    ``mesh_combine.launches``), after moving other cards' registers to
    member 0's; CPU tensors run ``mesh_combine_plain``."""
    if len(kinds) == 0:
        return ()
    dev = members[0][0].device
    if dev.type == "cuda":
        return _combine_launch(kinds, members)
    if dev.type != "cpu":
        raise ValueError(f"mesh_combine: no kernel for {dev}")
    return mesh_combine_plain(kinds, members)


#: kernel launches since the counter was last set to 0
mesh_combine.launches = 0


def sharded_partial_agg(worker: Callable, combine_kinds: Sequence[str],
                        mesh: DeviceMesh) -> Callable:
    """The reference's contract over a port mesh: ``run(cols, valids,
    row_mask)`` with each argument stacked over members (``[n, N]``, row
    m on any device) runs ``worker`` on member m's row on member m's
    device and returns ``out[i] = combine over members (worker(...)[i])``
    by ``combine_kinds[i]`` (``mesh_combine``), on member 0's device."""
    n = shard_axis_size(mesh)

    def run(cols, valids, row_mask):
        partials = []
        for m in range(n):
            dev = mesh.device_of(m)
            with on_member(dev):
                partials.append(tuple(worker(
                    tuple(to_member(c[m], dev) for c in cols),
                    tuple(to_member(v[m], dev) for v in valids),
                    to_member(row_mask[m], dev))))
        return mesh_combine(list(combine_kinds), partials)

    return run
