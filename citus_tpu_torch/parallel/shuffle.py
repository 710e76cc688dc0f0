"""Repartition shuffle: the partition (B7), exchange and sort-join (B8)
kernels.

The reference redistributes rows between workers with MapMergeJob (map
tasks hash-partition each shard's rows into bucket files, fetch tasks
pull each bucket to its destination); ``citus_tpu/parallel/shuffle.py``
does the same exchange as one ``jax.lax.all_to_all`` over the mesh.

Static-shape contract, as in the reference: each device holds ``N`` rows
(+validity); rows are bucketed by a target id in ``[0, n_dev)``; every
(src, dst) block is padded to a fixed capacity ``C``.  Rows past ``C``
are counted in ``overflow`` and the caller refuses a nonzero one.

The three kernels, each a wrapper with a launch counter and a plain
PyTorch version:

- ``pack_blocks`` (B7, ``csrc/partition_pack.cu``): one member's rows
  into ``[n_dev, C]`` send blocks by target, stable, with the overflow
  count (the reference's ``_pack_blocks``);
- ``exchange_blocks`` (the exchange of B7/B8, ``csrc/mesh_exchange.cu``):
  block d of every member's packed columns to member d, the reference's
  ``all_to_all(split_axis=0, concat_axis=0)``, one launch per card for
  every destination on it (on one card, straight into the stacked
  ``[n, n * C]`` receive columns);
- ``sorted_join`` (B8, ``csrc/sorted_join.cu``): one member's inner
  equi-join on dense group ids, ``(l_idx, r_idx, out_valid, total)`` of
  ``join_cap`` slots exactly as the reference's
  ``_sorted_join_indexes``, and the gather of every column at them (its
  ``out_l`` / ``out_r``).

On CUDA tensors a wrapper launches its kernel (counted in
``<wrapper>.launches``) or raises; on CPU tensors it runs the plain
version.  There is no fallback between the two.

``build_repartition`` and ``build_repartition_join`` compose them over a
mesh of ``n_dev`` members (``parallel/mesh.py``) as the reference's
builders do: each member packs, the blocks are exchanged, the overflow
sums over members (``mesh_combine``, the reference's ``psum``) and each
member joins what it received.  On a one-member mesh the exchange and
the sum are the identity and launch nothing.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from citus_tpu_torch.ops.cuda_build import count_launch
from citus_tpu_torch.parallel.mesh import (
    MAX_MEMBERS, mesh_combine, on_member, shard_axis_size, to_member,
)

#: rows per tile of the partition (csrc/partition_pack.cu PP_TILE) and
#: of sorted_join's radix passes and scans (csrc/sorted_join.cu SJ_TILE)
_TILE = 2048
#: destinations of one partition (csrc/partition_pack.cu PP_MAX_DEV)
_PP_MAX_DEV = 1023
_PP_MAX_COLS = 64
_SJ_MAX_COLS = 32
_MX_MAX_COLS = 24


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
                ("ticket", ctypes.c_void_p), ("state", ctypes.c_void_p),
                ("ticket_base", ctypes.c_int64), ("epoch", ctypes.c_int64)]


#: sorted_join's parameter block (csrc/sorted_join.cu SjParams) as int64
#: words: these fields, then SJ_MAX_COLS columns of (in, out, elem, right)
_SJ_FIELDS = ("L", "R", "U", "J", "epoch", "passes", "width", "lgid",
              "lvalid", "rgid", "rvalid", "l_idx", "r_idx", "out_valid",
              "total", "zero", "zero_bytes", "starts", "hist", "tickets",
              "u_agg", "u_incl", "u_flag", "r_agg", "r_incl", "r_flag",
              "digit_state", "key_a", "key_b", "idx_a", "idx_b", "base",
              "ends", "n_cols")
_SJ = {f: i for i, f in enumerate(_SJ_FIELDS)}
_SJ_WORDS = len(_SJ_FIELDS) + 4 * _SJ_MAX_COLS
_SJ_MAX_PASSES, _SJ_TICKETS = 4, 6
#: epochs of one workspace's look-back words (csrc/sorted_join.cu,
#: csrc/partition_pack.cu)
_SJ_EPOCHS = 1 << 30


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
    if name == "mesh_exchange":
        lib.mesh_exchange_launch.argtypes = [vp, vp]
        lib.mesh_exchange_launch.restype = ctypes.c_int
        for fn, want in ((lib.mesh_exchange_params_size, _MX_WORDS * 8),
                         (lib.mesh_exchange_max_src, MAX_MEMBERS),
                         (lib.mesh_exchange_max_cols, _MX_MAX_COLS)):
            fn.restype, fn.argtypes = ctypes.c_int, []
            if fn() != want:
                raise RuntimeError("mesh_exchange: parameter block layout "
                                   "differs between Python and CUDA")
        _libs[name] = lib
        return lib
    if name == "partition_pack":
        lib.partition_pack_launch.argtypes = [ctypes.POINTER(_PpParams), vp]
        lib.partition_pack_launch.restype = ctypes.c_int
        sizes = [(lib.partition_pack_params_size, _PpParams)]
        tile = lib.partition_pack_tile
        lib.partition_pack_max_dev.restype = ctypes.c_int
        lib.partition_pack_max_dev.argtypes = []
        if lib.partition_pack_max_dev() != _PP_MAX_DEV:
            raise RuntimeError("partition_pack: destination limit differs "
                               "between Python and CUDA")
    else:
        lib.sorted_join_launch.argtypes = [vp, vp]
        lib.sorted_join_gather_launch.argtypes = [ctypes.c_int64, vp, vp, vp]
        lib.sorted_join_launch.restype = ctypes.c_int
        lib.sorted_join_gather_launch.restype = ctypes.c_int
        for fn, want in ((lib.sorted_join_params_words, _SJ_WORDS),
                         (lib.sorted_join_max_cols, _SJ_MAX_COLS)):
            fn.restype, fn.argtypes = ctypes.c_int, []
            if fn() != want:
                raise RuntimeError("sorted_join: parameter block layout "
                                   "differs between Python and CUDA")
        sizes = []
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
    """PyTorch's current stream of ``device`` (a CUDA device with its
    index), as a C pointer."""
    return torch._C._cuda_getCurrentRawStream(device.index)


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


class _PpWorkspace:
    """One device stream's reused scratch of ``pack_blocks``: the ticket
    counter, then ``[tiles, n_dev]`` look-back words.  Neither is ever
    cleared: each launch takes the tickets past those of the launches
    before it and tags its words with an epoch of its own."""

    def __init__(self):
        self.buf = None
        self.words = 0
        self.epoch = 0
        self.tickets = 0

    def take(self, dev, words: int):
        """-> (ticket address, words address, ticket base, epoch) of a
        launch needing ``words`` look-back words: a fresh zeroed
        workspace when it grows or its epochs run out."""
        if words > self.words or self.epoch + 1 >= _SJ_EPOCHS:
            self.words = max(words, self.words)
            self.buf = None
            self.buf = torch.zeros(8 * (1 + self.words), dtype=torch.uint8,
                                   device=dev)
            self.epoch = self.tickets = 0
        self.epoch += 1
        at = self.buf.data_ptr()
        return at, at + 8, self.tickets, self.epoch


_pp_spaces: dict = {}
_pp_lock = threading.Lock()


def _pack_launch(values, target, mask, n_dev: int, capacity: int):
    dev = target.device
    n = target.shape[0]
    if not 1 <= n_dev <= _PP_MAX_DEV or capacity < 1 or n >= 2**31 - 1:
        raise ValueError(f"pack_blocks: n_dev must lie in [1, "
                         f"{_PP_MAX_DEV}], capacity be positive and the "
                         "rows under 2^31 - 1")
    if len(values) > _PP_MAX_COLS:
        raise ValueError(f"pack_blocks: more than {_PP_MAX_COLS} columns")
    _check_vector("pack_blocks: target", target, n, dev, torch.int32)
    _check_vector("pack_blocks: mask", mask, n, dev, torch.bool)
    for j, v in enumerate(values):
        _check_vector(f"pack_blocks: column {j}", v, n, dev)
    lib = _library("partition_pack")
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
    stream = _stream(dev)
    with _pp_lock:
        ws = _pp_spaces.setdefault((str(dev), stream), _PpWorkspace())
        p.ticket, p.state, p.ticket_base, p.epoch = ws.take(
            dev, _tiles(n) * n_dev)
        err = lib.partition_pack_launch(ctypes.byref(p), stream)
        if err == 0:
            ws.tickets += _tiles(n)
        else:
            ws.words = -1  # tickets unknown: a fresh workspace next time
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
    int64).  CUDA tensors launch ``csrc/partition_pack.cu`` (one counted
    launch per call: a pass over the rows and a fill of the slots no row
    reached); CPU tensors run ``pack_blocks_plain``."""
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


class _SjWorkspace:
    """One device stream's reused scratch of ``sorted_join``: the
    look-back words of its digit passes and of its scans each in a region
    of their own (so a word read there is always one such word, of this
    launch's epoch or an earlier one), then everything else."""

    def __init__(self):
        self.buf = None
        self.caps = (0, 0, 0)
        self.epoch = 0

    def take(self, dev, digit_words: int, flag_words: int, rest: int):
        """-> (base address, epoch) of a workspace of at least these
        sizes: a fresh zeroed one when it grows or its epochs run out."""
        need = (digit_words, flag_words, rest)
        if any(n > c for n, c in zip(need, self.caps)) \
                or self.epoch + 1 >= _SJ_EPOCHS:
            self.caps = tuple(max(n, c) for n, c in zip(need, self.caps))
            self.buf = None
            self.buf = torch.zeros(self._bytes(*self.caps), dtype=torch.uint8,
                                   device=dev)
            self.epoch = 0
        self.epoch += 1
        return self.buf.data_ptr(), self.epoch

    @staticmethod
    def _bytes(digit_words, flag_words, rest) -> int:
        return 8 * digit_words + 8 * -(-flag_words // 2) + rest


_sj_spaces: dict = {}
_sj_lock = threading.Lock()


def _sj_layout(L: int, R: int, U: int, passes: int) -> dict:
    """Byte offsets of ``sorted_join``'s workspace past its look-back
    regions, from 0: the zeroed part (starts, digit histograms,
    tickets), the scans' tile sums, the sort's buffers and the runs."""
    tu, tr = _tiles(U + 1), _tiles(R)
    sizes = [("starts", 8 * (U + 1)), ("hist", 8 * 256 * _SJ_MAX_PASSES),
             ("tickets", 4 * _SJ_TICKETS), ("u_agg", 8 * tu),
             ("u_incl", 8 * tu), ("r_agg", 8 * tr), ("r_incl", 8 * tr),
             ("key_a", 4 * L), ("key_b", 4 * L), ("idx_a", 4 * L),
             ("idx_b", 4 * L), ("base", 8 * R), ("ends", 8 * R)]
    out, at = {}, 0
    for name, n in sizes:
        out[name] = at
        at += -(-n // 8) * 8
    out["zero_bytes"] = out["u_agg"]
    out["bytes"] = at
    return out


def _sj_passes(U: int) -> tuple:
    """(radix passes, digit bits) of keys in [0, U]: ceil(bits / 8)
    passes of ceil(bits / passes) bits, bits the bit length of U."""
    bits = int(U).bit_length()
    passes = -(-bits // 8)
    return passes, (-(-bits // passes) if passes else 0)


def _sj_params(L: int, R: int, U: int, J: int, ptrs: dict, cols) -> np.ndarray:
    """The parameter block of one ``sorted_join`` launch as int64 words:
    sizes and ``ptrs`` by field name, then ``cols`` as (in, out, elem,
    right) tuples."""
    p = np.zeros(_SJ_WORDS, np.int64)
    p[:4] = (L, R, U, J)
    for name, v in ptrs.items():
        p[_SJ[name]] = v
    p[_SJ["n_cols"]] = len(cols)
    if cols:
        head = len(_SJ_FIELDS)
        p[head:head + 4 * len(cols)] = np.asarray(cols, np.int64).reshape(-1)
    return p


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
    i64 = lambda k: torch.empty(k, dtype=torch.int64, device=dev)  # noqa: E731
    l_idx, r_idx = i64(J), i64(J)
    out_valid = torch.empty(J, dtype=torch.bool, device=dev)
    total = torch.empty((), dtype=torch.int64, device=dev)
    cols = [(c, 0) for c in lcols] + [(c, 1) for c in rcols]
    outs = [torch.empty(J, dtype=c.dtype, device=dev) for c, _ in cols]
    fused = [(c.data_ptr(), o.data_ptr(), c.element_size(), right)
             for (c, right), o in zip(cols, outs)][:_SJ_MAX_COLS]
    passes, width = _sj_passes(U)
    lay = _sj_layout(L, R, U, passes)
    digit_words = passes * _tiles(L) * 256
    flag_words = _tiles(U + 1) + _tiles(R)
    stream = _stream(dev)
    with _sj_lock:
        ws = _sj_spaces.setdefault((str(dev), stream), _SjWorkspace())
        base, epoch = ws.take(dev, digit_words, flag_words, lay["bytes"])
        flags = base + 8 * ws.caps[0]
        rest = flags + 8 * -(-ws.caps[1] // 2)
        ptrs = {name: rest + lay[name] for name in (
            "starts", "hist", "tickets", "u_agg", "u_incl", "r_agg",
            "r_incl", "key_a", "key_b", "idx_a", "idx_b", "base", "ends")}
        ptrs.update(
            epoch=epoch, passes=passes, width=width,
            lgid=lgid.data_ptr(), lvalid=lvalid.data_ptr(),
            rgid=rgid.data_ptr(), rvalid=rvalid.data_ptr(),
            l_idx=l_idx.data_ptr(), r_idx=r_idx.data_ptr(),
            out_valid=out_valid.data_ptr(), total=total.data_ptr(),
            zero=rest, zero_bytes=lay["zero_bytes"], digit_state=base,
            u_flag=flags, r_flag=flags + 4 * _tiles(U + 1))
        p = _sj_params(L, R, U, J, ptrs, fused)
        err = lib.sorted_join_launch(p.ctypes.data, stream)
    if err != 0:
        raise RuntimeError(f"sorted_join launch failed: CUDA error {err}")
    for k in range(_SJ_MAX_COLS, len(cols)):
        (c, right), o = cols[k], outs[k]
        col = np.array([c.data_ptr(), o.data_ptr(), c.element_size(), right],
                       np.int64)
        err = lib.sorted_join_gather_launch(
            J, (r_idx if right else l_idx).data_ptr(), col.ctypes.data,
            stream)
        if err != 0:
            raise RuntimeError(f"sorted_join gather launch failed: CUDA "
                               f"error {err}")
    return (l_idx, r_idx, out_valid, total, tuple(outs[:len(lcols)]),
            tuple(outs[len(lcols):]))


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


# --------------------------------------------------- the exchange (B7/B8)


#: the exchange's parameter block (csrc/mesh_exchange.cu MxParams) as
#: int64 words: n_src, capacity, n_cols, n_dst, remote, then the arrays
_MX_DST_IDS = 5
_MX_ELEM = _MX_DST_IDS + MAX_MEMBERS
_MX_DST = _MX_ELEM + _MX_MAX_COLS
_MX_SRC = _MX_DST + _MX_MAX_COLS
_MX_WORDS = _MX_SRC + _MX_MAX_COLS * MAX_MEMBERS


def exchange_params(n_src: int, capacity: int, dst_ids, remote: int,
                    elems, dst_ptrs, src_ptrs) -> np.ndarray:
    """The parameter block of one exchange launch, as int64 words: for
    each destination row k (member ``dst_ids[k]``), each source s and
    each column c, copy ``capacity`` values of ``elems[c]`` bytes from
    ``src_ptrs[c][s] + row * capacity * elems[c]`` (row = k when bit s of
    ``remote`` is set, the source's rows being copies for this launch's
    destinations; else ``dst_ids[k]``) to ``dst_ptrs[c] + (k * n_src + s)
    * capacity * elems[c]``.  Pointers are addresses on the launch's
    card (``data_ptr()``)."""
    n_cols, n_dst = len(elems), len(dst_ids)
    if not 1 <= n_cols <= _MX_MAX_COLS or not 1 <= n_dst <= MAX_MEMBERS \
            or not 1 <= n_src <= MAX_MEMBERS:
        raise ValueError("exchange_params: 1 to 24 columns, 1 to 16 members")
    p = np.zeros(_MX_WORDS, np.int64)
    p[:_MX_DST_IDS] = (n_src, capacity, n_cols, n_dst, remote)
    p[_MX_DST_IDS:_MX_DST_IDS + n_dst] = dst_ids
    p[_MX_ELEM:_MX_ELEM + n_cols] = elems
    p[_MX_DST:_MX_DST + n_cols] = dst_ptrs
    p[_MX_SRC:].reshape(_MX_MAX_COLS, MAX_MEMBERS)[:n_cols, :n_src] = src_ptrs
    return p


def exchange_blocks_plain(blocks: list, mesh) -> list:
    """``exchange_blocks`` in eager tensor ops: destination d's column c
    is the concatenation, in source order, of block d of every source's
    column c, on d's device.  Counts its calls in
    ``exchange_blocks_plain.calls``."""
    _count_call(exchange_blocks_plain)
    n = len(blocks)
    return [tuple(torch.cat([to_member(blocks[s][c][d], mesh.device_of(d))
                             for s in range(n)])
                  for c in range(len(blocks[0])))
            for d in range(n)]


exchange_blocks_plain.calls = 0


def _exchange_check(blocks: list) -> tuple:
    """-> (n, n_cols, C) of valid CUDA send blocks; raises otherwise."""
    n, n_cols = len(blocks), len(blocks[0])
    if n > MAX_MEMBERS:
        raise ValueError(f"exchange_blocks: at most {MAX_MEMBERS} members")
    if any(len(cols) != n_cols for cols in blocks):
        raise ValueError("exchange_blocks: sources differ in columns")
    C = blocks[0][0].shape[1]
    for s, cols in enumerate(blocks):
        for c, b in enumerate(cols):
            want = blocks[0][c].dtype
            if b.shape != (n, C) or b.dtype != want \
                    or not b.is_contiguous() or b.device.type != "cuda" \
                    or b.element_size() not in (1, 4, 8):
                raise ValueError(f"exchange_blocks: source {s} column {c} "
                                 f"must be a contiguous [{n}, {C}] "
                                 f"{want} CUDA tensor of 1, 4 or 8 "
                                 f"byte values, got {b.dtype} "
                                 f"{tuple(b.shape)} on {b.device}")
    return n, n_cols, C


def exchange_cards(member_devices, source_devices) -> list:
    """The launches of one exchange, one per card: -> [(device, the
    destination members on it, remote)], cards in the order of their
    first member; bit s of ``remote`` is set when source s's blocks lie
    on another device (they are copied onto the card first, one row per
    destination)."""
    cards: dict = {}
    for d, dev in enumerate(member_devices):
        cards.setdefault(dev, []).append(d)
    return [(dev, dsts, sum(1 << s for s, sd in enumerate(source_devices)
                            if sd != dev))
            for dev, dsts in cards.items()]


def exchange_prepare(blocks: list, mesh) -> tuple:
    """The receive buffers and parameter blocks of ``exchange_blocks``
    on CUDA, nothing launched: -> (out, launches, stacked).  ``out[d]``
    is destination d's tuple of ``[n * C]`` receive columns: row k of one
    ``[n_dst, n * C]`` tensor per column and card.  ``stacked`` is that
    tuple of tensors when one card holds every destination (each
    ``[n, n * C]``, row d destination d's), else None.  ``launches``
    holds one ``(device, params, sources)`` per card and 24 columns,
    ``params`` the int64 block of ``exchange_params``; the blocks a
    card's destinations need from other cards are copied onto it first
    (``sources`` keeps those copies)."""
    n, n_cols, C = _exchange_check(blocks)
    out, launches, stacked = [None] * n, [], None
    cards = exchange_cards([mesh.device_of(d) for d in range(n)],
                           [cols[0].device for cols in blocks])
    for dev, dsts, remote in cards:
        src = [tuple(to_member(b[dsts], dev) for b in cols)
               if (remote >> s) & 1 else cols
               for s, cols in enumerate(blocks)]
        recv = tuple(torch.empty((len(dsts), n * C), dtype=b.dtype,
                                 device=dev) for b in blocks[0])
        for a in range(0, n_cols, _MX_MAX_COLS):
            cs = range(a, min(a + _MX_MAX_COLS, n_cols))
            launches.append((dev, exchange_params(
                n, C, dsts, remote, [recv[c].element_size() for c in cs],
                [recv[c].data_ptr() for c in cs],
                [[src[s][c].data_ptr() for s in range(n)] for c in cs]),
                src))
        rows = [r.unbind(0) for r in recv]
        for k, d in enumerate(dsts):
            out[d] = tuple(r[k] for r in rows)
        if len(cards) == 1:
            stacked = recv
    return out, launches, stacked


def exchange_run(launches: list) -> None:
    """Launch ``csrc/mesh_exchange.cu`` once per entry of
    ``exchange_prepare``'s ``launches``, each counted in
    ``exchange_blocks.launches``."""
    lib = _library("mesh_exchange")
    for dev, params, _ in launches:
        with on_member(dev):
            err = lib.mesh_exchange_launch(
                params.ctypes.data, torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"mesh_exchange launch failed: CUDA error "
                               f"{err}")
        count_launch(exchange_blocks)


def _exchange(blocks: list, mesh) -> tuple:
    """-> (``exchange_blocks``' result, the stacked receive columns of
    ``exchange_prepare`` or None)."""
    dev = blocks[0][0].device
    if dev.type == "cuda":
        out, launches, stacked = exchange_prepare(blocks, mesh)
        exchange_run(launches)
        return out, stacked
    if dev.type != "cpu":
        raise ValueError(f"exchange_blocks: no kernel for {dev}")
    return exchange_blocks_plain(blocks, mesh), None


def exchange_blocks(blocks: list, mesh) -> list:
    """The all_to_all of a repartition over ``mesh``: ``blocks[s]`` is
    source member s's tuple of packed ``[n, C]`` columns (its validity
    among them), on any device; -> for each destination member d the
    tuple of its ``[n * C]`` receive columns on d's device, block d of
    source s at rows ``[s * C, (s + 1) * C)`` (the reference's
    ``all_to_all(split_axis=0, concat_axis=0)`` flattened).  CUDA tensors
    launch ``csrc/mesh_exchange.cu`` once per card for every destination
    on it (for up to 24 columns; each launch counted in
    ``exchange_blocks.launches``), after moving the blocks a card's
    destinations need from other cards onto it; on one card the receive
    columns are the rows of one stacked ``[n, n * C]`` tensor per column.
    CPU tensors run ``exchange_blocks_plain``."""
    return _exchange(blocks, mesh)[0]


#: kernel launches since the counter was last set to 0
exchange_blocks.launches = 0


# -------------------------------------------------------- over the mesh


def _pack_members(mesh, values, gid, target, mask, capacity: int):
    """Each member packs its row of the stacked inputs on its device
    (B7); -> per member (packed columns + validity, overflow)."""
    n = shard_axis_size(mesh)
    out = []
    for s in range(n):
        dev = mesh.device_of(s)
        row = lambda t: to_member(t[s], dev)  # noqa: E731
        cols = ((row(gid),) if gid is not None else ()) + tuple(
            row(v) for v in values)
        with on_member(dev):
            packed, pvalid, overflow = pack_blocks(cols, row(target),
                                                   row(mask), n, capacity)
        out.append((packed + (pvalid,), overflow))
    return out


def _received(mesh, packed: list) -> list:
    """Each destination member's ``[n * C]`` columns: the exchange, or
    on a one-member mesh the one block as it is."""
    if shard_axis_size(mesh) == 1:
        return [tuple(b[0] for b in packed[0])]
    return exchange_blocks(packed, mesh)


def _received_stacked(mesh, packed: list) -> tuple:
    """Each column's ``[n, n * C]`` receive rows on member 0's device
    (row d destination d's): on a one-member mesh the one block as it
    is, on one card the exchange kernel's own receive tensors, else the
    destinations' columns stacked."""
    if shard_axis_size(mesh) == 1:
        return tuple(packed[0])
    out, stacked = _exchange(packed, mesh)
    if stacked is not None:
        return stacked
    return tuple(_stacked(mesh, [r[c] for r in out])
                 for c in range(len(packed[0])))


def _overflow_sum(mesh, overflows: list) -> torch.Tensor:
    """The overflow summed over members (the reference's ``psum``):
    ``mesh_combine``, or the one member's count as it is."""
    if len(overflows) == 1:
        return overflows[0]
    return mesh_combine(["sum"], [(o,) for o in overflows])[0]


def _stacked(mesh, per_member: list) -> torch.Tensor:
    """Per-member tensors as one ``[n, ...]`` stack on member 0's device
    (a view on a one-member mesh)."""
    if len(per_member) == 1:
        return per_member[0][None]
    return torch.stack([to_member(t, mesh.device) for t in per_member])


def build_repartition(mesh, n_cols: int, capacity: int):
    """An exchange over ``mesh``: values tuple of ``[n_dev, N]`` tensors,
    target ``[n_dev, N]`` int32, mask ``[n_dev, N]`` -> values tuple of
    ``[n_dev, n_dev * C]`` (rows now on their target member), validity
    ``[n_dev, n_dev * C]`` and the overflow count (0-d; nonzero means
    rows were dropped).  Row s of each input is member s's: it packs
    there (``pack_blocks``), the blocks move (``exchange_blocks``) and
    the overflow sums over members (``mesh_combine``)."""

    def run(values, target, mask):
        if len(values) != n_cols:
            raise ValueError(f"repartition built for {n_cols} columns")
        packed = _pack_members(mesh, values, None, target, mask, capacity)
        cols = _received_stacked(mesh, [p for p, _ in packed])
        return cols[:-1], cols[-1], _overflow_sum(
            mesh, [o for _, o in packed])
    return run


def build_repartition_join(mesh, n_lcols: int, n_rcols: int, capacity_l: int,
                           capacity_r: int, join_cap: int, n_groups: int):
    """A shuffle and join over ``mesh``: both relations exchange by join
    group bucket, then each member joins what it received
    (``sorted_join``).  Inputs as the reference's: left values tuple of
    ``[n_dev, Nl]`` (validity as bool columns), lgid ``[n_dev, Nl]``
    int64 dense group ids (``n_groups`` of them), ltgt / lmask likewise,
    and the same for the right side; row s is member s's.  -> (left
    columns ``[n_dev, join_cap]``, right columns, out_valid ``[n_dev,
    join_cap]``, overflow 0-d: nonzero when a block or ``join_cap`` was
    too small, summed over members)."""

    def side(values, gid, tgt, mask, capacity):
        packed = _pack_members(mesh, values, gid, tgt, mask, capacity)
        recv = _received(mesh, [p for p, _ in packed])
        # per member: (gid, columns, validity), and the overflow
        return [(r[0], r[1:-1], r[-1]) for r in recv], [o for _, o in packed]

    def run(lvals, lgid, ltgt, lmask, rvals, rgid, rtgt, rmask):
        if len(lvals) != n_lcols or len(rvals) != n_rcols:
            raise ValueError("repartition join built for another column "
                             "count")
        left, lov = side(lvals, lgid, ltgt, lmask, capacity_l)
        right, rov = side(rvals, rgid, rtgt, rmask, capacity_r)
        outs_l, outs_r, ovalid, overflows = [], [], [], []
        for d, ((lg, lc, lv), (rg, rc, rv)) in enumerate(zip(left, right)):
            with on_member(mesh.device_of(d)):
                _, _, ov, total, ol, orr = sorted_join(
                    lg, lv, rg, rv, lc, rc, n_groups, join_cap)
            outs_l.append(ol)
            outs_r.append(orr)
            ovalid.append(ov)
            overflows.append(lov[d] + rov[d]
                             + torch.clamp(total - join_cap, min=0))
        return (tuple(_stacked(mesh, [o[c] for o in outs_l])
                      for c in range(n_lcols)),
                tuple(_stacked(mesh, [o[c] for o in outs_r])
                      for c in range(n_rcols)),
                _stacked(mesh, ovalid), _overflow_sum(mesh, overflows))
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
