"""The partial-aggregate fold of one scan batch: the hand-written CUDA
kernel ``csrc/scan_agg_fold.cu`` and its plain PyTorch version.

``scan_agg_fold`` folds the rows of one batch that pass ``mask`` into
running per-group registers, in place: ``acc[op][gid]`` for every
partial op and ``rows[gid]`` (direct mode).  It is what remains of the
reference's fused worker (``citus_tpu/ops/scan_agg.py``) once the
filter and argument expressions are evaluated: group id, validity,
the cast to the accumulator type and count/sum/min/max.

On CUDA tensors it launches the kernel (one launch per call, counted
in ``scan_agg_fold.launches``) or raises; on CPU tensors it runs
``scan_agg_fold_plain``.  There is no fallback between the two.

``scan_agg_fold_batched`` folds one batch for Q queries of one literal
family at once (``csrc/scan_agg_fold_batched.cu``): masks [Q, N],
registers [Q, G], the keys and arguments shared.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from citus_tpu_torch.ops.cuda_build import count_launch
_MAX_KEYS, _MAX_ARGS, _MAX_OPS = 8, 32, 32
#: partial sums per group of a float sum in the plain version
_SUM_LANES = 1024

_DTYPE_CODES = {torch.bool: 0, torch.uint8: 0, torch.int32: 1,
                torch.int64: 2, torch.float32: 3, torch.float64: 4}
_KIND_CODES = {"count_star": 0, "count": 1, "sum": 2, "min": 3, "max": 4}
_ACC_DTYPES = {
    "count_star": (torch.int64,),
    "count": (torch.int64,),
    "sum": (torch.int64, torch.float64, torch.int32, torch.float32),
    "min": (torch.int32, torch.int64, torch.float32, torch.float64),
    "max": (torch.int32, torch.int64, torch.float32, torch.float64),
}


@dataclass(frozen=True)
class FoldOp:
    """One partial op: ``kind`` in count_star/count/sum/min/max, ``arg``
    the index of its argument column (-1 for count_star)."""
    kind: str
    arg: int = -1


@dataclass(frozen=True)
class FoldKey:
    """One direct-mode group key: ``code = (value - lo) // step + 1``
    (0 when NULL), weighted by ``stride``."""
    values: torch.Tensor
    valid: Optional[torch.Tensor]
    lo: int
    step: int
    stride: int


def _sentinel(kind: str, dtype: torch.dtype):
    if kind == "min":
        return (float("inf") if dtype.is_floating_point
                else torch.iinfo(dtype).max)
    if kind == "max":
        return (float("-inf") if dtype.is_floating_point
                else torch.iinfo(dtype).min)
    return 0


def _full(t: torch.Tensor, n: int) -> torch.Tensor:
    return t.expand(n) if t.numel() == 1 and n != 1 else t


def scan_agg_fold_plain(acc: Sequence[torch.Tensor],
                        rows: Optional[torch.Tensor], mask: torch.Tensor,
                        keys: Sequence[FoldKey],
                        args: Sequence[tuple], ops: Sequence[FoldOp],
                        n_groups: int) -> None:
    """The same fold in plain tensor ops (``index_add_`` and
    ``scatter_reduce_``), on any device.

    A float sum goes through ``_SUM_LANES`` partial sums per group, added
    up at the end: one running float64 sum over the ~10^5 rows of a
    TPC-H group drifts by about 1e-11 of its value, more than the
    kernel's own error, and the plain version is what the kernel's float
    sums are held against (rel 1e-12)."""
    n = mask.shape[0]
    dev = mask.device
    gid = torch.zeros(n, dtype=torch.int64, device=dev)
    for k in keys:
        kv = _full(k.values, n).to(torch.int64)
        code = (kv - k.lo) // k.step + 1
        if k.valid is not None:
            code = torch.where(_full(k.valid, n), code, 0)
        gid += code.clamp(min=0) * k.stride
    gid = torch.where(mask, gid, 0).clamp(0, n_groups - 1)
    for a, op in zip(acc, ops):
        if op.kind == "count_star":
            a.index_add_(0, gid, mask.to(torch.int64))
            continue
        v, valid = args[op.arg]
        ok = mask if valid is None else mask & _full(valid, n)
        if op.kind == "count":
            a.index_add_(0, gid, ok.to(torch.int64))
        elif op.kind == "sum" and a.dtype.is_floating_point:
            lanes = max(1, min(_SUM_LANES, _SUM_LANES * 1024 // n_groups))
            wide = torch.zeros(n_groups * lanes, dtype=a.dtype, device=dev)
            lane = torch.arange(n, device=dev) % lanes
            wide.index_add_(0, gid * lanes + lane,
                            torch.where(ok, _full(v, n).to(a.dtype), 0))
            a += wide.view(n_groups, lanes).sum(dim=1)
        elif op.kind == "sum":
            a.index_add_(0, gid, torch.where(ok, _full(v, n).to(a.dtype), 0))
        else:
            upd = torch.where(ok, _full(v, n).to(a.dtype),
                              _sentinel(op.kind, a.dtype))
            a.scatter_reduce_(0, gid, upd,
                              "amin" if op.kind == "min" else "amax",
                              include_self=True)
    if rows is not None:
        rows.index_add_(0, gid, mask.to(torch.int64))


# ------------------------------------------------------------- kernel


class _Col(ctypes.Structure):
    _fields_ = [("data", ctypes.c_void_p), ("valid", ctypes.c_void_p),
                ("data_stride", ctypes.c_int64),
                ("valid_stride", ctypes.c_int64),
                ("dtype", ctypes.c_int32), ("pad", ctypes.c_int32)]


class _Params(ctypes.Structure):
    _fields_ = [("n", ctypes.c_int64), ("n_groups", ctypes.c_int64),
                ("mask", ctypes.c_void_p),
                ("n_keys", ctypes.c_int32), ("n_args", ctypes.c_int32),
                ("n_ops", ctypes.c_int32), ("pad", ctypes.c_int32),
                ("keys", _Col * _MAX_KEYS),
                ("key_lo", ctypes.c_int64 * _MAX_KEYS),
                ("key_step", ctypes.c_int64 * _MAX_KEYS),
                ("key_stride", ctypes.c_int64 * _MAX_KEYS),
                ("args", _Col * _MAX_ARGS),
                ("op_kind", ctypes.c_int32 * _MAX_OPS),
                ("op_arg", ctypes.c_int32 * _MAX_OPS),
                ("op_dtype", ctypes.c_int32 * _MAX_OPS),
                ("acc", ctypes.c_void_p * _MAX_OPS),
                ("rows", ctypes.c_void_p)]


_lib = None


def _library():
    global _lib
    if _lib is None:
        from citus_tpu_torch.ops.cuda_build import load
        lib = load("scan_agg_fold")
        lib.scan_agg_fold_launch.restype = ctypes.c_int
        lib.scan_agg_fold_launch.argtypes = [
            ctypes.POINTER(_Params), ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int)]
        lib.scan_agg_fold_params_size.restype = ctypes.c_int
        lib.scan_agg_fold_params_size.argtypes = []
        if lib.scan_agg_fold_params_size() != ctypes.sizeof(_Params):
            raise RuntimeError("scan_agg_fold: parameter block layout "
                               "differs between Python and CUDA")
        _lib = lib
    return _lib


def _check_vector(t: torch.Tensor, what: str, n: int, dev) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"scan_agg_fold: {what} must be a tensor")
    if t.device != dev:
        raise ValueError(f"scan_agg_fold: {what} is on {t.device}, "
                         f"the mask on {dev}")
    if t.dim() != 1 or t.shape[0] not in (n, 1) or not t.is_contiguous():
        raise ValueError(f"scan_agg_fold: {what} must be a contiguous "
                         f"[{n}] or [1] vector, got {tuple(t.shape)}")
    if t.dtype not in _DTYPE_CODES:
        raise TypeError(f"scan_agg_fold: {what} has dtype {t.dtype}")


def _col(t: torch.Tensor, valid: Optional[torch.Tensor], what: str,
         n: int, dev) -> _Col:
    _check_vector(t, what, n, dev)
    c = _Col()
    c.data = t.data_ptr()
    c.data_stride = 1 if t.shape[0] == n else 0
    c.dtype = _DTYPE_CODES[t.dtype]
    if valid is not None:
        _check_vector(valid, f"{what} validity", n, dev)
        if valid.dtype != torch.bool:
            raise TypeError(f"scan_agg_fold: {what} validity must be bool")
        c.valid = valid.data_ptr()
        c.valid_stride = 1 if valid.shape[0] == n else 0
    return c


def _block(acc, rows, mask, keys, args, ops, n_groups, n_q=None) -> _Params:
    """The parameter block of one launch; registers are [G] (one query)
    or [n_q, G] (``n_q`` queries, ``mask`` [n_q, N])."""
    dev = mask.device
    n = mask.shape[-1]
    want_dim = 1 if n_q is None else 2
    if mask.dtype != torch.bool or mask.dim() != want_dim \
            or (n_q is not None and mask.shape[0] != n_q) \
            or not mask.is_contiguous():
        raise ValueError("scan_agg_fold: mask must be a contiguous bool "
                         + ("vector" if n_q is None else f"[{n_q}, N] tensor"))
    if len(keys) > _MAX_KEYS or len(args) > _MAX_ARGS \
            or len(ops) > _MAX_OPS:
        raise ValueError(
            f"scan_agg_fold takes at most {_MAX_KEYS} keys, {_MAX_ARGS} "
            f"arguments and {_MAX_OPS} partial ops")
    if len(acc) != len(ops):
        raise ValueError("scan_agg_fold: one accumulator per partial op")
    reg_shape = (n_groups,) if n_q is None else (n_q, n_groups)
    p = _Params()
    p.n = n
    p.n_groups = n_groups
    p.mask = mask.data_ptr()
    p.n_keys, p.n_args, p.n_ops = len(keys), len(args), len(ops)
    for i, k in enumerate(keys):
        c = _col(k.values, k.valid, f"key {i}", n, dev)
        if c.dtype not in (0, 1, 2):
            raise TypeError(f"scan_agg_fold: key {i} must be integer")
        if k.step <= 0:
            raise ValueError(f"scan_agg_fold: key {i} step must be > 0")
        p.keys[i] = c
        p.key_lo[i], p.key_step[i], p.key_stride[i] = k.lo, k.step, k.stride
    for i, (v, valid) in enumerate(args):
        p.args[i] = _col(v, valid, f"argument {i}", n, dev)
    for i, (a, op) in enumerate(zip(acc, ops)):
        if op.kind not in _KIND_CODES:
            raise ValueError(f"scan_agg_fold: unknown op kind {op.kind!r}")
        if a.device != dev or a.dtype not in _ACC_DTYPES[op.kind] \
                or a.shape != reg_shape or not a.is_contiguous():
            raise ValueError(
                f"scan_agg_fold: accumulator {i} ({op.kind}) must be a "
                f"contiguous {list(reg_shape)} tensor of "
                f"{_ACC_DTYPES[op.kind]} on {dev}, got {a.dtype} "
                f"{tuple(a.shape)} on {a.device}")
        if op.kind != "count_star" and not 0 <= op.arg < len(args):
            raise ValueError(f"scan_agg_fold: op {i} argument out of range")
        p.op_kind[i] = _KIND_CODES[op.kind]
        p.op_arg[i] = max(op.arg, 0)
        p.op_dtype[i] = _DTYPE_CODES[a.dtype]
        p.acc[i] = a.data_ptr()
    if rows is not None:
        if rows.device != dev or rows.dtype != torch.int64 \
                or rows.shape != reg_shape or not rows.is_contiguous():
            raise ValueError("scan_agg_fold: rows must be a contiguous "
                             f"{list(reg_shape)} int64 tensor on {dev}")
        p.rows = rows.data_ptr()
    return p


def _launch(acc, rows, mask, keys, args, ops, n_groups) -> int:
    p = _block(acc, rows, mask, keys, args, ops, n_groups)
    regime = ctypes.c_int(-1)
    dev = mask.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _library().scan_agg_fold_launch(ctypes.byref(p), stream,
                                              ctypes.byref(regime))
    if err != 0:
        raise RuntimeError(f"scan_agg_fold launch failed: CUDA error {err}")
    return regime.value


def scan_agg_fold(acc: Sequence[torch.Tensor], rows: Optional[torch.Tensor],
                  mask: torch.Tensor, keys: Sequence[FoldKey],
                  args: Sequence[tuple], ops: Sequence[FoldOp],
                  n_groups: int) -> None:
    """Fold one batch into ``acc``/``rows`` in place.

    ``acc[i]`` is op ``i``'s [G] register of its accumulator type,
    ``rows`` the [G] int64 group-row counts (None in scalar mode, G=1),
    ``mask`` the bool [N] rows that pass the filter, ``keys`` the
    direct-mode group keys, ``args`` (values, validity or None) pairs of
    [N] or broadcast [1] vectors.  CUDA tensors launch the kernel, CPU
    tensors run the plain version."""
    if mask.device.type == "cuda":
        scan_agg_fold.last_regime = _launch(acc, rows, mask, keys, args,
                                            ops, n_groups)
        count_launch(scan_agg_fold)
        return
    if mask.device.type != "cpu":
        raise ValueError(f"scan_agg_fold: no kernel for {mask.device}")
    scan_agg_fold_plain(acc, rows, mask, keys, args, ops, n_groups)


#: kernel launches since the counter was last set to 0
scan_agg_fold.launches = 0
#: 1 = shared-memory group table, 0 = global atomics (last launch)
scan_agg_fold.last_regime = -1


# --------------------------------------------------- Q queries at once


def scan_agg_fold_batched_plain(acc: Sequence[torch.Tensor],
                                rows: Optional[torch.Tensor],
                                masks: torch.Tensor, keys: Sequence[FoldKey],
                                args: Sequence[tuple], ops: Sequence[FoldOp],
                                n_groups: int) -> None:
    """The same batched fold in plain tensor ops: one
    ``scan_agg_fold_plain`` per query into row q of its registers."""
    for q in range(masks.shape[0]):
        scan_agg_fold_plain([a[q] for a in acc],
                            None if rows is None else rows[q], masks[q],
                            keys, args, ops, n_groups)


_lib_batched = None


def _library_batched():
    global _lib_batched
    if _lib_batched is None:
        from citus_tpu_torch.ops.cuda_build import load
        lib = load("scan_agg_fold_batched")
        lib.scan_agg_fold_batched_launch.restype = ctypes.c_int
        lib.scan_agg_fold_batched_launch.argtypes = [
            ctypes.POINTER(_Params), ctypes.c_int, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int)]
        lib.scan_agg_fold_batched_params_size.restype = ctypes.c_int
        lib.scan_agg_fold_batched_params_size.argtypes = []
        if lib.scan_agg_fold_batched_params_size() != ctypes.sizeof(_Params):
            raise RuntimeError("scan_agg_fold_batched: parameter block "
                               "layout differs between Python and CUDA")
        _lib_batched = lib
    return _lib_batched


def _launch_batched(acc, rows, masks, keys, args, ops, n_groups) -> int:
    n_q = masks.shape[0] if masks.dim() == 2 else 0
    if n_q <= 0:
        raise ValueError("scan_agg_fold_batched: masks must be [Q, N], Q > 0")
    p = _block(acc, rows, masks, keys, args, ops, n_groups, n_q)
    regime = ctypes.c_int(-1)
    dev = masks.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _library_batched().scan_agg_fold_batched_launch(
            ctypes.byref(p), n_q, stream, ctypes.byref(regime))
    if err != 0:
        raise RuntimeError(f"scan_agg_fold_batched launch failed: CUDA "
                           f"error {err}")
    return regime.value


def scan_agg_fold_batched(acc: Sequence[torch.Tensor],
                          rows: Optional[torch.Tensor], masks: torch.Tensor,
                          keys: Sequence[FoldKey], args: Sequence[tuple],
                          ops: Sequence[FoldOp], n_groups: int) -> None:
    """Fold one batch into the registers of Q queries at once, in place:
    row q of every register (``acc[i]`` [Q, G], ``rows`` [Q, G] or None
    in scalar mode, G = 1) takes the rows that pass ``masks[q]`` (bool
    [Q, N]).  ``keys`` and ``args`` are shared by every query: they
    reference no parameter.  It is the reference's ``batched:jit_fused``
    (a ``jax.vmap`` of the fused worker over the query axis).  CUDA
    tensors launch ``csrc/scan_agg_fold_batched.cu`` (one launch per
    call, counted in ``scan_agg_fold_batched.launches``), CPU tensors
    run the plain version."""
    if masks.device.type == "cuda":
        scan_agg_fold_batched.last_regime = _launch_batched(
            acc, rows, masks, keys, args, ops, n_groups)
        count_launch(scan_agg_fold_batched)
        return
    if masks.device.type != "cpu":
        raise ValueError(f"scan_agg_fold_batched: no kernel for "
                         f"{masks.device}")
    scan_agg_fold_batched_plain(acc, rows, masks, keys, args, ops, n_groups)


#: kernel launches since the counter was last set to 0
scan_agg_fold_batched.launches = 0
#: 1 = shared-memory group table, 0 = global atomics (last launch)
scan_agg_fold_batched.last_regime = -1
