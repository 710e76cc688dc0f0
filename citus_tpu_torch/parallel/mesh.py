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
  version.  The executor keeps each member's registers as one
  allocation (``RegisterLayout``) and combines them with
  ``mesh_combine_arenas`` into one output allocation, copied to the host
  in one copy.
- ``to_member`` is the transport between members: a copy to the member's
  card when the tensor lies on another (``Tensor.to(non_blocking=True)``
  inside one process), nothing on one card.  Between hosts it is not
  ported: NCCL takes its place there (ROADMAP.md A9b).
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Callable, Sequence

import numpy as np
import torch

from citus_tpu_torch.ops.cuda_build import count_launch

SHARD_AXIS = "shard"
#: members a mesh may have: the combine and the exchange kernels take
#: every member's pointers in their parameter blocks
MAX_MEMBERS = 16
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


#: csrc/mesh_combine.cu: the parameter block's header words, the most
#: words after it, the threads a block (each a 16-byte vector of every
#: member), and a segment's flag that every access is 16-byte aligned
_HEADER_WORDS = 19
_MAX_WORDS = 4000
_MC_THREADS = 128
_ALIGNED = 1 << 16


def _align16(nbytes: int) -> int:
    return (nbytes + 15) & ~15


class RegisterLayout:
    """The partial registers of a mesh's members as one allocation a
    member, and their combine's output as one allocation: position i is
    ``kinds[i]``'s ``dtypes[i]`` register of ``shapes[i]`` at a 16-byte
    aligned byte offset, the positions of one dtype together (so one
    ``split`` views them all; a ``none`` position's output is ``[n,
    *shape]``).  ``words`` is the kernel's parameter block with its
    segment table filled (``csrc/mesh_combine.cu``): a launch fills only
    the members' base pointers and the output's.  Cached on the plan by
    the executor (``mesh_layout``), by its register shapes for
    ``mesh_combine``."""

    def __init__(self, kinds, dtypes, shapes, n: int):
        if not 1 <= n <= MAX_MEMBERS:
            raise ValueError(f"mesh_combine: 1 to {MAX_MEMBERS} members")
        p = len(kinds)
        if p == 0 or len(dtypes) != p or len(shapes) != p:
            raise ValueError("mesh_combine: one kind, dtype and shape a "
                             "position")
        for kind, dt in zip(kinds, dtypes):
            if kind not in _KINDS:
                raise ValueError(f"mesh_combine: unknown kind {kind!r}")
            if dt not in _DTYPES:
                raise ValueError(f"mesh_combine: no kernel for {dt} "
                                 "registers")
        if 4 * p + p * n > _MAX_WORDS:
            raise ValueError(f"mesh_combine: {p} positions of {n} members "
                             "pass one launch's parameter block")
        self.kinds, self.n = tuple(kinds), n
        self.dtypes, self.shapes = tuple(dtypes), tuple(map(tuple, shapes))
        self.numels = [int(np.prod(s, dtype=np.int64)) for s in self.shapes]
        self.out_shapes = [((n,) if k == "none" else ()) + s
                           for k, s in zip(kinds, self.shapes)]
        out_numels = [k * (n if kind == "none" else 1)
                      for k, kind in zip(self.numels, kinds)]
        self.in_offsets, self.nbytes, self._in_split = self._place(
            self.numels, self.shapes)
        self.out_offsets, self.out_nbytes, self._out_split = self._place(
            out_numels, self.out_shapes)
        self._out_numels = out_numels
        segs = np.zeros((p, 4), np.uint64)
        blocks = 0
        for i, (kind, dt, k) in enumerate(zip(kinds, dtypes, self.numels)):
            aligned = kind != "none" or k * dt.itemsize % 16 == 0
            segs[i] = (_KINDS[kind] | _DTYPES[dt] << 8
                       | (_ALIGNED if aligned else 0) | blocks << 32,
                       self.in_offsets[i], self.out_offsets[i], k)
            blocks += -(-(-(-k * dt.itemsize // 16)) // _MC_THREADS)
        head = np.zeros(_HEADER_WORDS, np.uint64)
        head[0] = n | p << 32
        head[1] = blocks << 32
        self.words = np.concatenate([head, segs.reshape(-1)])
        head[1] = blocks << 32 | 1
        self.general_words = np.concatenate(
            [head, segs.reshape(-1), np.zeros(p * n, np.uint64)])
        self._seg_words = _HEADER_WORDS + 4 * np.arange(p)

    def _place(self, numels, shapes) -> tuple:
        """Byte offsets of the positions, grouped by dtype, each 16-byte
        aligned: -> (offsets, total bytes, the split of each dtype's run:
        [(dtype, first byte, end byte, element sizes with the gaps,
        [(position, its piece, shape to view it as or None)])])."""
        offsets = [0] * len(numels)
        split = []
        at = 0
        for dt in dict.fromkeys(self.dtypes):
            es = dt.itemsize
            first, sizes, pieces = at, [], []
            for i, k in enumerate(numels):
                if self.dtypes[i] != dt:
                    continue
                offsets[i] = at
                pieces.append((i, len(sizes), None if len(shapes[i]) == 1
                               else shapes[i]))
                sizes.append(k)
                gap = (_align16(k * es) - k * es) // es
                if gap:
                    sizes.append(gap)
                at += _align16(k * es)
            split.append((dt, first, at, sizes, pieces))
        return offsets, at, split

    @staticmethod
    def _view(buf: torch.Tensor, split: list, p: int) -> tuple:
        out = [None] * p
        for dt, first, end, sizes, pieces in split:
            parts = buf[first:end].view(dt).split(sizes)
            for i, j, shape in pieces:
                out[i] = parts[j] if shape is None else parts[j].view(shape)
        return tuple(out)

    def views(self, arena: torch.Tensor) -> tuple:
        """Position i's register, a view of one member's ``arena`` (uint8
        [nbytes])."""
        return self._view(arena, self._in_split, len(self.kinds))

    def out_views(self, out: torch.Tensor) -> tuple:
        """Position i combined, a view of the output ``out`` (uint8
        [out_nbytes])."""
        return self._view(out, self._out_split, len(self.kinds))

    def host_outputs(self, out: np.ndarray) -> tuple:
        """``out_views`` of the output copied to the host (uint8 numpy)."""
        return tuple(out[o:o + k * dt.itemsize].view(_NP_DTYPES[dt])
                     .reshape(shape)
                     for o, k, dt, shape in zip(self.out_offsets,
                                                self._out_numels, self.dtypes,
                                                self.out_shapes))

    def pack(self, registers) -> np.ndarray:
        """One member's registers (numpy, one a position) as its arena's
        bytes."""
        buf = np.zeros(self.nbytes, np.uint8)
        for o, k, dt, r in zip(self.in_offsets, self.numels, self.dtypes,
                               registers):
            buf[o:o + k * dt.itemsize].view(_NP_DTYPES[dt])[:] = \
                np.asarray(r, _NP_DTYPES[dt]).reshape(-1)
        return buf


_NP_DTYPES = {torch.int64: np.int64, torch.float64: np.float64,
              torch.int32: np.int32, torch.float32: np.float32}
#: the layouts of mesh_combine's calls, by kinds, members and register
#: dtypes and shapes (bounded: the oldest goes first)
_LAYOUTS: dict = {}
_MAX_LAYOUTS = 64


def _layout_of(kinds, members) -> RegisterLayout:
    first = members[0]
    key = (tuple(kinds), len(members),
           tuple((t.dtype, t.shape) for t in first))
    layout = _LAYOUTS.get(key)
    if layout is None:
        layout = RegisterLayout(kinds, [t.dtype for t in first],
                                [t.shape for t in first], len(members))
        if len(_LAYOUTS) >= _MAX_LAYOUTS:
            del _LAYOUTS[next(iter(_LAYOUTS))]
        _LAYOUTS[key] = layout
    return layout


_lib = None


def _library():
    """``csrc/mesh_combine.cu`` built and loaded (``bind``)."""
    global _lib
    if _lib is None:
        from citus_tpu_torch.ops import cuda_build
        _lib = bind(cuda_build.load("mesh_combine"))
    return _lib


def bind(lib):
    """``lib``, a build of ``csrc/mesh_combine.cu``, with its C interface
    typed and its parameter layout checked against ``RegisterLayout``'s."""
    lib.mesh_combine_launch.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                        ctypes.c_void_p]
    lib.mesh_combine_launch.restype = ctypes.c_int
    for fn, want in ((lib.mesh_combine_header_words, _HEADER_WORDS),
                     (lib.mesh_combine_max_words, _MAX_WORDS),
                     (lib.mesh_combine_max_members, MAX_MEMBERS),
                     (lib.mesh_combine_threads, _MC_THREADS)):
        fn.restype, fn.argtypes = ctypes.c_int, []
        if fn() != want:
            raise RuntimeError("mesh_combine: parameter block layout "
                               "differs between Python and CUDA")
    return lib


def _launch_words(words: np.ndarray, dev) -> None:
    if torch.cuda.current_device() != dev.index:
        with torch.cuda.device(dev):
            return _launch_words(words, dev)
    err = _library().mesh_combine_launch(
        words.ctypes.data, words.shape[0],
        torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(f"mesh_combine launch failed: CUDA error {err}")
    count_launch(mesh_combine)


def mesh_combine_arenas(layout: RegisterLayout, arenas) -> torch.Tensor:
    """The members' registers combined, each member's one ``arena``
    (uint8 [layout.nbytes], ``layout.views``): -> the output, uint8
    [layout.out_nbytes] on member 0's device (``layout.out_views``,
    ``layout.host_outputs``).  On a card one launch of
    ``csrc/mesh_combine.cu`` (counted in ``mesh_combine.launches``),
    after moving other cards' arenas to member 0's; on the CPU
    ``mesh_combine_plain``."""
    dev = arenas[0].device
    if len(arenas) != layout.n:
        raise ValueError(f"mesh_combine: {layout.n} members' arenas, got "
                         f"{len(arenas)}")
    out = torch.empty(layout.out_nbytes, dtype=torch.uint8, device=dev)
    if dev.type == "cpu":
        got = mesh_combine_plain(layout.kinds, [layout.views(a)
                                                for a in arenas])
        for v, g in zip(layout.out_views(out), got):
            v.copy_(g)
        return out
    if dev.type != "cuda":
        raise ValueError(f"mesh_combine: no kernel for {dev}")
    di = dev.index
    words = layout.words.copy()
    moved = []  # arenas copied from other cards, alive until the launch
    for m, a in enumerate(arenas):
        if a.get_device() != di:
            a = to_member(a, dev)
            moved.append(a)
        if a.dtype != torch.uint8 or a.dim() != 1 \
                or a.shape[0] != layout.nbytes or not a.is_contiguous() \
                or a.data_ptr() & 15:
            raise ValueError(f"mesh_combine: member {m}'s arena must be a "
                             f"16-byte aligned uint8 [{layout.nbytes}]")
        words[3 + m] = a.data_ptr()
    words[2] = out.data_ptr()
    _launch_words(words, dev)
    return out


def _combine_launch(kinds, members):
    """The general path: every member's registers separate tensors, a
    pointer per position and member after the segment table."""
    dev = members[0][0].device
    n = len(members)
    if not 1 <= n <= MAX_MEMBERS:
        raise ValueError(f"mesh_combine: 1 to {MAX_MEMBERS} members")
    if any(len(m) != len(kinds) for m in members):
        raise ValueError("mesh_combine: one register a position")
    layout = _layout_of(kinds, members)
    di = dev.index
    ptrs = []
    moved = []  # registers copied from other cards, alive until the launch
    bits = 0
    for i, (dt, shape) in enumerate(zip(layout.dtypes, layout.shapes)):
        for m in members:
            r = m[i]
            if r.get_device() != di:
                r = to_member(r, dev)
                moved.append(r)
            if r.dtype is not dt or r.shape != shape or not r.is_contiguous():
                raise ValueError(f"mesh_combine: position {i}: members' "
                                 "registers differ in dtype or shape, or "
                                 "are not contiguous")
            ptr = r.data_ptr()
            bits |= ptr
            ptrs.append(ptr)
    words = layout.general_words.copy()
    words[_HEADER_WORDS + 4 * len(kinds):] = ptrs
    if bits & 15:
        # a position whose registers are not all 16-byte aligned goes an
        # element at a time
        for i in range(len(kinds)):
            if any(p & 15 for p in ptrs[i * n:(i + 1) * n]):
                words[layout._seg_words[i]] &= ~np.uint64(_ALIGNED)
    out = torch.empty(layout.out_nbytes, dtype=torch.uint8, device=dev)
    words[2] = out.data_ptr()
    _launch_words(words, dev)
    return layout.out_views(out)


def mesh_combine(kinds: Sequence[str], members: Sequence[Sequence]):
    """The partial registers of every member combined: ``members[m]`` is
    member m's tuple of registers (int64, float64, int32 or float32, one
    shape per position across members), ``kinds[i]`` in {sum, min, max,
    none}.  -> position i combined, on member 0's device (``none``:
    stacked, ``[n, ...]``), every position a view of one output
    allocation.  CUDA tensors launch ``csrc/mesh_combine.cu`` once for
    any number of positions (counted in ``mesh_combine.launches``),
    after moving other cards' registers to member 0's; CPU tensors run
    ``mesh_combine_plain``.  Registers that are one allocation a member
    take ``mesh_combine_arenas``."""
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
