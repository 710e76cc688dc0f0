"""Repartition shuffle: the partition (B7) and sort-join (B8) kernels.

The reference redistributes rows between workers with MapMergeJob (map
tasks hash-partition each shard's rows into bucket files, fetch tasks
pull each bucket to its destination); ``citus_tpu/parallel/shuffle.py``
does the same exchange as one ``jax.lax.all_to_all`` over the mesh.

Static-shape contract, as in the reference: each device holds ``N`` rows
(+validity); rows are bucketed by a target id in ``[0, n_dev)``; every
(src, dst) block is padded to a fixed capacity ``C``.  Rows past ``C``
are counted in ``overflow`` and the caller refuses a nonzero one.

The two kernels, each a wrapper with a launch counter and a plain
PyTorch version:

- ``pack_blocks`` (B7, ``csrc/partition_pack.cu``): one device's rows
  into ``[n_dev, C]`` send blocks by target, stable, with the overflow
  count (the reference's ``_pack_blocks``);
- ``sorted_join`` (B8, ``csrc/sorted_join.cu``): one device's inner
  equi-join on dense group ids, ``(l_idx, r_idx, out_valid, total)`` of
  ``join_cap`` slots exactly as the reference's
  ``_sorted_join_indexes``, and the gather of every column at them (its
  ``out_l`` / ``out_r``).

On CUDA tensors a wrapper launches its kernel (counted in
``<wrapper>.launches``) or raises; on CPU tensors it runs the plain
version.  There is no fallback between the two.

``build_repartition`` and ``build_repartition_join`` compose them over a
mesh as the reference's builders do.  The mesh has one card
(``parallel/mesh.py``): the exchange between packing and joining is the
identity there, and NCCL's all_to_all takes its place with more than
one card (ROADMAP.md A9b).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from citus_tpu_torch.ops.cuda_build import count_launch
from citus_tpu_torch.parallel.mesh import SHARD_AXIS

#: rows per tile of the counting passes (csrc/partition.cuh PT_TILE)
_TILE = 2048
#: destinations of one counting pass, the virtual one included
_MAX_DIGITS = 1024
_PP_MAX_COLS = 64
_SJ_MAX_COLS = 32


def _tiles(n: int) -> int:
    return -(-n // _TILE)


class _PpColumn(ctypes.Structure):
    _fields_ = [("in_", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("elem", ctypes.c_int64)]


class _PpParams(ctypes.Structure):
    _fields_ = [("n", ctypes.c_int64), ("n_dev", ctypes.c_int64),
                ("capacity", ctypes.c_int64), ("target", ctypes.c_void_p),
                ("mask", ctypes.c_void_p), ("n_cols", ctypes.c_int64),
                ("cols", _PpColumn * _PP_MAX_COLS),
                ("out_valid", ctypes.c_void_p), ("overflow", ctypes.c_void_p),
                ("hist", ctypes.c_void_p), ("bsum", ctypes.c_void_p)]


class _SjParams(ctypes.Structure):
    _fields_ = [("L", ctypes.c_int64), ("R", ctypes.c_int64),
                ("U", ctypes.c_int64), ("J", ctypes.c_int64),
                ("lgid", ctypes.c_void_p), ("lvalid", ctypes.c_void_p),
                ("rgid", ctypes.c_void_p), ("rvalid", ctypes.c_void_p),
                ("l_idx", ctypes.c_void_p), ("r_idx", ctypes.c_void_p),
                ("out_valid", ctypes.c_void_p), ("total", ctypes.c_void_p),
                ("key_a", ctypes.c_void_p), ("key_b", ctypes.c_void_p),
                ("idx_a", ctypes.c_void_p), ("idx_b", ctypes.c_void_p),
                ("hist", ctypes.c_void_p), ("bsum", ctypes.c_void_p),
                ("starts", ctypes.c_void_p), ("lo", ctypes.c_void_p),
                ("run", ctypes.c_void_p)]


class _SjGather(ctypes.Structure):
    _fields_ = [("J", ctypes.c_int64), ("idx", ctypes.c_void_p),
                ("n_cols", ctypes.c_int64),
                ("cols", _PpColumn * _SJ_MAX_COLS)]


_libs: dict = {}
_calls_lock = threading.Lock()


def _library(name: str):
    """``csrc/<name>.cu`` built and loaded, its C interface typed and its
    parameter layout checked against the ctypes mirror."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    from citus_tpu_torch.ops import cuda_build
    lib = cuda_build.load(name)
    vp = ctypes.c_void_p
    if name == "partition_pack":
        lib.partition_pack_launch.argtypes = [ctypes.POINTER(_PpParams), vp]
        lib.partition_pack_launch.restype = ctypes.c_int
        sizes = [(lib.partition_pack_params_size, _PpParams)]
        tile = lib.partition_pack_tile
    else:
        lib.sorted_join_launch.argtypes = [ctypes.POINTER(_SjParams), vp]
        lib.sorted_join_gather_launch.argtypes = [ctypes.POINTER(_SjGather),
                                                  vp]
        lib.sorted_join_launch.restype = ctypes.c_int
        lib.sorted_join_gather_launch.restype = ctypes.c_int
        sizes = [(lib.sorted_join_params_size, _SjParams),
                 (lib.sorted_join_gather_size, _SjGather)]
        tile = lib.sorted_join_tile
    for fn, struct in sizes:
        fn.restype, fn.argtypes = ctypes.c_int, []
        if fn() != ctypes.sizeof(struct):
            raise RuntimeError(f"{name}: parameter block layout differs "
                               "between Python and CUDA")
    tile.restype, tile.argtypes = ctypes.c_int, []
    if tile() != _TILE:
        raise RuntimeError(f"{name}: tile size differs between Python and "
                           "CUDA")
    _libs[name] = lib
    return lib


def _stream(device):
    with torch.cuda.device(device):
        return torch.cuda.current_stream(device).cuda_stream


def _check_vector(what: str, t: torch.Tensor, n: int, device, dtype=None):
    if t.device != device or t.dim() != 1 or t.shape[0] != n \
            or not t.is_contiguous() or (dtype is not None and t.dtype != dtype):
        want = f"{dtype} " if dtype is not None else ""
        raise ValueError(f"{what} must be a contiguous [{n}] {want}tensor on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")
    if t.element_size() not in (1, 4, 8):
        raise ValueError(f"{what}: {t.dtype} values are not 1, 4 or 8 "
                         "bytes")


# ------------------------------------------------------------------- B7


def _count_call(fn) -> None:
    """One more call of a plain version (``fn.calls``): the CPU tests'
    evidence that a query went through the wrapper."""
    with _calls_lock:
        fn.calls += 1


def pack_blocks_plain(values: tuple, target: torch.Tensor, mask: torch.Tensor,
                      n_dev: int, capacity: int):
    """``pack_blocks`` in eager tensor ops on any device: a stable argsort
    by target (masked rows in a virtual bucket ``n_dev``), each row's
    rank in its destination, and the rows of rank under ``capacity``
    placed at ``[target, rank]``.  Counts its calls in
    ``pack_blocks_plain.calls``."""
    _count_call(pack_blocks_plain)
    n = target.shape[0]
    dev = target.device
    tgt = torch.where(mask & (target >= 0) & (target < n_dev),
                      target.to(torch.int64), n_dev)
    order = torch.argsort(tgt, stable=True)
    sorted_tgt = tgt[order]
    counts = torch.bincount(tgt, minlength=n_dev + 1)
    start = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n, device=dev) - start[sorted_tgt]
    keep = (sorted_tgt < n_dev) & (rank < capacity)
    slot = sorted_tgt[keep] * capacity + rank[keep]
    total = n_dev * capacity
    packed_valid = torch.zeros(total, dtype=torch.bool, device=dev)
    packed_valid[slot] = True
    packed = []
    for v in values:
        buf = torch.zeros(total, dtype=v.dtype, device=dev)
        buf[slot] = v[order][keep]
        packed.append(buf.reshape(n_dev, capacity))
    overflow = torch.clamp(counts[:n_dev] - capacity, min=0).sum()
    return tuple(packed), packed_valid.reshape(n_dev, capacity), overflow


pack_blocks_plain.calls = 0


def _pack_launch(values, target, mask, n_dev: int, capacity: int):
    dev = target.device
    n = target.shape[0]
    if not 1 <= n_dev < _MAX_DIGITS or capacity < 1:
        raise ValueError(f"pack_blocks: n_dev must lie in [1, "
                         f"{_MAX_DIGITS - 1}] and capacity be positive")
    if len(values) > _PP_MAX_COLS:
        raise ValueError(f"pack_blocks: more than {_PP_MAX_COLS} columns")
    _check_vector("pack_blocks: target", target, n, dev, torch.int32)
    _check_vector("pack_blocks: mask", mask, n, dev, torch.bool)
    for j, v in enumerate(values):
        _check_vector(f"pack_blocks: column {j}", v, n, dev)
    lib = _library("partition_pack")
    nt = _tiles(n)
    hist = torch.empty(max(1, (n_dev + 1) * nt), dtype=torch.int64,
                       device=dev)
    bsum = torch.empty(max(1, _tiles((n_dev + 1) * nt)), dtype=torch.int64,
                       device=dev)
    packed = tuple(torch.empty((n_dev, capacity), dtype=v.dtype, device=dev)
                   for v in values)
    pvalid = torch.empty((n_dev, capacity), dtype=torch.bool, device=dev)
    overflow = torch.empty((), dtype=torch.int64, device=dev)
    p = _PpParams()
    p.n, p.n_dev, p.capacity = n, n_dev, capacity
    p.target, p.mask = target.data_ptr(), mask.data_ptr()
    p.n_cols = len(values)
    for j, (v, out) in enumerate(zip(values, packed)):
        p.cols[j].in_ = v.data_ptr()
        p.cols[j].out = out.data_ptr()
        p.cols[j].elem = v.element_size()
    p.out_valid, p.overflow = pvalid.data_ptr(), overflow.data_ptr()
    p.hist, p.bsum = hist.data_ptr(), bsum.data_ptr()
    err = lib.partition_pack_launch(ctypes.byref(p), _stream(dev))
    if err != 0:
        raise RuntimeError(f"partition_pack launch failed: CUDA error {err}")
    return packed, pvalid, overflow


def pack_blocks(values: tuple, target: torch.Tensor, mask: torch.Tensor,
                n_dev: int, capacity: int):
    """One device's rows arranged into ``[n_dev, capacity]`` send blocks
    by ``target`` (int32 ``[N]`` in ``[0, n_dev)``), in input order within
    each block; rows with ``mask`` false are dropped, and so are rows
    past ``capacity``, counted in ``overflow``.  ``values`` are ``[N]``
    columns of any dtype (validity travels as bool columns).  -> (packed
    columns, packed validity ``[n_dev, capacity]`` bool, overflow 0-d
    int64).  CUDA tensors launch ``csrc/partition_pack.cu`` (one launch
    per call, counted in ``pack_blocks.launches``); CPU tensors run
    ``pack_blocks_plain``."""
    if target.device.type == "cuda":
        out = _pack_launch(values, target, mask, n_dev, capacity)
        count_launch(pack_blocks)
        return out
    if target.device.type != "cpu":
        raise ValueError(f"pack_blocks: no kernel for {target.device}")
    return pack_blocks_plain(values, target, mask, n_dev, capacity)


#: kernel launches since the counter was last set to 0
pack_blocks.launches = 0


# ------------------------------------------------------------------- B8


def sorted_join_indexes_plain(lgid, lvalid, rgid, rvalid, join_cap: int):
    """The reference's ``_sorted_join_indexes`` in eager tensor ops:
    left rows sorted by gid (invalid ones last, stable), each right row
    binary-searching its run, the runs' ends cumulated, and output slot
    ``j`` mapped back to its (right row, offset).  -> (l_idx, r_idx,
    out_valid, total), int64 indexes."""
    L, R = lgid.shape[0], rgid.shape[0]
    dev = lgid.device
    big = torch.iinfo(lgid.dtype).max
    lkey = torch.where(lvalid, lgid, big)
    order = torch.argsort(lkey, stable=True)
    skey = lkey[order]
    lo = torch.searchsorted(skey, rgid, side="left")
    hi = torch.searchsorted(skey, rgid, side="right")
    cnt = torch.where(rvalid, hi - lo, 0)
    ends = torch.cumsum(cnt, 0)
    total = ends[-1]
    start = ends - cnt
    j = torch.arange(join_cap, device=dev)
    r_idx = torch.searchsorted(ends, j, side="right").clip(0, R - 1)
    off = j - start[r_idx]
    l_idx = order[(lo[r_idx] + off).clip(0, L - 1)]
    return l_idx, r_idx, j < total, total


def sorted_join_plain(lgid, lvalid, rgid, rvalid, lcols: tuple, rcols: tuple,
                      n_groups: int, join_cap: int):
    """``sorted_join`` in eager tensor ops.  A valid left gid outside
    ``[0, n_groups)`` joins as an invalid row, as in the kernel.  Counts
    its calls in ``sorted_join_plain.calls``."""
    _count_call(sorted_join_plain)
    lvalid = lvalid & (lgid >= 0) & (lgid < n_groups)
    li, ri, ov, total = sorted_join_indexes_plain(lgid, lvalid, rgid, rvalid,
                                                  join_cap)
    return (li, ri, ov, total, tuple(c[li] for c in lcols),
            tuple(c[ri] for c in rcols))


sorted_join_plain.calls = 0


def _gather_launch(lib, idx, cols, dev, stream):
    outs = tuple(torch.empty(idx.shape[0], dtype=c.dtype, device=dev)
                 for c in cols)
    for a in range(0, len(cols), _SJ_MAX_COLS):
        g = _SjGather()
        g.J, g.idx = idx.shape[0], idx.data_ptr()
        chunk = list(zip(cols, outs))[a:a + _SJ_MAX_COLS]
        g.n_cols = len(chunk)
        for k, (c, o) in enumerate(chunk):
            g.cols[k].in_, g.cols[k].out = c.data_ptr(), o.data_ptr()
            g.cols[k].elem = c.element_size()
        err = lib.sorted_join_gather_launch(ctypes.byref(g), stream)
        if err != 0:
            raise RuntimeError(f"sorted_join gather launch failed: CUDA "
                               f"error {err}")
    return outs


def _sorted_join_launch(lgid, lvalid, rgid, rvalid, lcols, rcols,
                        n_groups: int, join_cap: int):
    dev = lgid.device
    L, R, U, J = lgid.shape[0], rgid.shape[0], int(n_groups), int(join_cap)
    if not 0 <= U < 2**31 - 1 or L >= 2**31 - 1 or J < 0:
        raise ValueError("sorted_join: n_groups and the left side must "
                         "stay under 2^31 - 1, join_cap non-negative")
    _check_vector("sorted_join: lgid", lgid, L, dev, torch.int64)
    _check_vector("sorted_join: lvalid", lvalid, L, dev, torch.bool)
    _check_vector("sorted_join: rgid", rgid, R, dev, torch.int64)
    _check_vector("sorted_join: rvalid", rvalid, R, dev, torch.bool)
    for side, cols, n in (("left", lcols, L), ("right", rcols, R)):
        for j, c in enumerate(cols):
            _check_vector(f"sorted_join: {side} column {j}", c, n, dev)
    lib = _library("sorted_join")
    i32 = lambda k: torch.empty(k, dtype=torch.int32, device=dev)  # noqa: E731
    i64 = lambda k: torch.empty(k, dtype=torch.int64, device=dev)  # noqa: E731
    scratch = {"key_a": i32(L), "key_b": i32(L), "idx_a": i32(L),
               "idx_b": i32(L), "hist": i64(256 * _tiles(L)),
               "bsum": i64(max(1, _tiles(256 * _tiles(L)), _tiles(U),
                               _tiles(R))),
               "starts": i64(U + 1), "lo": i64(R), "run": i64(R)}
    l_idx, r_idx = i64(J), i64(J)
    out_valid = torch.empty(J, dtype=torch.bool, device=dev)
    total = torch.empty((), dtype=torch.int64, device=dev)
    p = _SjParams()
    p.L, p.R, p.U, p.J = L, R, U, J
    p.lgid, p.lvalid = lgid.data_ptr(), lvalid.data_ptr()
    p.rgid, p.rvalid = rgid.data_ptr(), rvalid.data_ptr()
    p.l_idx, p.r_idx = l_idx.data_ptr(), r_idx.data_ptr()
    p.out_valid, p.total = out_valid.data_ptr(), total.data_ptr()
    for k, t in scratch.items():
        setattr(p, k, t.data_ptr())
    stream = _stream(dev)
    err = lib.sorted_join_launch(ctypes.byref(p), stream)
    if err != 0:
        raise RuntimeError(f"sorted_join launch failed: CUDA error {err}")
    out_l = _gather_launch(lib, l_idx, lcols, dev, stream)
    out_r = _gather_launch(lib, r_idx, rcols, dev, stream)
    return l_idx, r_idx, out_valid, total, out_l, out_r


def sorted_join(lgid, lvalid, rgid, rvalid, lcols: tuple, rcols: tuple,
                n_groups: int, join_cap: int):
    """Inner equi-join of one device's two relations on int64 group ids
    (valid ids dense in ``[0, n_groups)``), for ``join_cap`` output
    slots: -> (l_idx, r_idx, out_valid, total, left columns gathered at
    l_idx, right columns gathered at r_idx), equal slot for slot to the
    reference's ``_sorted_join_indexes`` and gathers.  A valid left gid
    outside ``[0, n_groups)`` joins as an invalid row (sorted last, in
    input order, with the invalid ones).  Both sides need at least one
    row (the reference's searches need them too).  CUDA
    tensors launch ``csrc/sorted_join.cu`` (one counted launch per call
    in ``sorted_join.launches``, its index kernels and gathers); CPU
    tensors run ``sorted_join_plain``."""
    if lgid.shape[0] < 1 or rgid.shape[0] < 1:
        raise ValueError("sorted_join: both sides need at least one row")
    if lgid.device.type == "cuda":
        out = _sorted_join_launch(lgid, lvalid, rgid, rvalid, lcols, rcols,
                                  n_groups, join_cap)
        count_launch(sorted_join)
        return out
    if lgid.device.type != "cpu":
        raise ValueError(f"sorted_join: no kernel for {lgid.device}")
    return sorted_join_plain(lgid, lvalid, rgid, rvalid, lcols, rcols,
                             n_groups, join_cap)


#: kernel launches since the counter was last set to 0
sorted_join.launches = 0


# -------------------------------------------------------- over the mesh


def _one_card(mesh) -> None:
    """The builders below run on the one-card mesh, where the exchange
    between packing and joining is the identity: block 0 of the one
    device goes to itself.  (NCCL's all_to_all between cards, and the
    loop over source devices that comes with it, ROADMAP.md A9b.)"""
    if mesh.shape[SHARD_AXIS] != 1:
        raise NotImplementedError("the exchange between cards is not ported "
                                  "yet (ROADMAP.md A9b)")


def build_repartition(mesh, n_cols: int, capacity: int):
    """An exchange over ``mesh``: values tuple of ``[n_dev, N]`` tensors,
    target ``[n_dev, N]`` int32, mask ``[n_dev, N]`` -> values tuple of
    ``[n_dev, n_dev * C]`` (rows now on their target device), validity
    ``[n_dev, n_dev * C]`` and the overflow count (0-d; nonzero means
    rows were dropped)."""
    _one_card(mesh)

    def run(values, target, mask):
        if len(values) != n_cols:
            raise ValueError(f"repartition built for {n_cols} columns")
        packed, pvalid, overflow = pack_blocks(
            tuple(v[0] for v in values), target[0], mask[0], 1, capacity)
        return packed, pvalid, overflow
    return run


def build_repartition_join(mesh, n_lcols: int, n_rcols: int, capacity_l: int,
                           capacity_r: int, join_cap: int, n_groups: int):
    """A shuffle and join over ``mesh``: both relations exchange by join
    group bucket, then each device joins its bucket (``sorted_join``).
    Inputs as the reference's: left values tuple of ``[n_dev, Nl]``
    (validity as bool columns), lgid ``[n_dev, Nl]`` int64 dense group ids
    (``n_groups`` of them), ltgt / lmask likewise, and the same for the
    right side.  -> (left columns ``[n_dev, join_cap]``, right columns,
    out_valid ``[n_dev, join_cap]``, overflow 0-d: nonzero when a block
    or ``join_cap`` was too small)."""
    _one_card(mesh)

    def exchange(values, gid, tgt, mask, capacity):
        packed, pvalid, overflow = pack_blocks((gid[0],) + tuple(
            v[0] for v in values), tgt[0], mask[0], 1, capacity)
        return packed[0][0], tuple(c[0] for c in packed[1:]), pvalid[0], \
            overflow

    def run(lvals, lgid, ltgt, lmask, rvals, rgid, rtgt, rmask):
        if len(lvals) != n_lcols or len(rvals) != n_rcols:
            raise ValueError("repartition join built for another column "
                             "count")
        lg, lc, lv, lov = exchange(lvals, lgid, ltgt, lmask, capacity_l)
        rg, rc, rv, rov = exchange(rvals, rgid, rtgt, rmask, capacity_r)
        _, _, ovalid, total, ol, orr = sorted_join(lg, lv, rg, rv, lc, rc,
                                                   n_groups, join_cap)
        overflow = lov + rov + torch.clamp(total - join_cap, min=0)
        return (tuple(c[None] for c in ol), tuple(c[None] for c in orr),
                ovalid[None], overflow)
    return run


def repartition_host(values: tuple, target: np.ndarray, mask: np.ndarray,
                     n_buckets: int):
    """Host reference implementation (oracle): per-bucket tuples of row
    arrays."""
    out = []
    for b in range(n_buckets):
        sel = mask & (target == b)
        out.append(tuple(v[sel] for v in values))
    return out
