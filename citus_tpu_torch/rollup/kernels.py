"""Delta-batch partial states for the rollup refresh loop.

A CDC delta batch is (values, group index) pairs; the refresh needs the
same per-group partial states the scan aggregates compute — count/sum
vectors, HLL register maxes, DDSketch/top-k bucket histograms — just
over a small batch instead of a shard.  ``rollup_delta`` computes one
kind's tables for one padded batch: on CUDA tensors the hand-written
kernel ``csrc/rollup_delta.cu`` (one launch per call, counted in
``rollup_delta.launches``), on CPU tensors ``rollup_delta_plain``
(``index_add_`` and ``scatter_reduce_``).  There is no fallback between
the two.  Both bucket through the same functions as the scan fold
(``csrc/sketch.cuh``, ``ops/sketch_buckets.py``), so rollup and
raw-scan estimates agree.

``delta_partials`` pads the batch to a power-of-two row count and the
tables to a power-of-two group count, from 8 (``_pad_to``), as the
reference does: the padding bounds the table shapes a steady refresh
loop allocates.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from citus_tpu_torch.ops.cuda_build import count_launch
from citus_tpu_torch.planner.aggregates import DDSK_M, HLL_M, TOPK_M

#: kernel kind codes (csrc/rollup_delta.cu RD_*)
KINDS = {"count": 0, "sum_int": 1, "sum_float": 2, "hll": 3, "ddsk": 4,
         "topk": 5}
_INT64_MIN = torch.iinfo(torch.int64).min


def value_bits(arr: np.ndarray) -> np.ndarray:
    """Values -> the int64 bit pattern the hash sketches consume (must
    match ops/scan_agg.py: floats hash their float64 bits, everything
    else its int64 value, so rollup and raw-scan estimates agree)."""
    a = np.asarray(arr)
    if np.issubdtype(a.dtype, np.floating):
        return a.astype(np.float64).view(np.int64)
    return a.astype(np.int64)


def _pad_to(n: int) -> int:
    p = 8
    while p < n:
        p *= 2
    return p


def _values_dtype(kind: str):
    return torch.float64 if kind in ("sum_float", "ddsk") else torch.int64


def _tables(kind: str, gp: int, device) -> tuple:
    """Fresh tables of one kind for ``gp`` groups: (table, top-k value
    table or None)."""
    if kind == "count" or kind == "sum_int":
        return torch.zeros(gp, dtype=torch.int64, device=device), None
    if kind == "sum_float":
        return torch.zeros(gp, dtype=torch.float64, device=device), None
    if kind == "hll":
        return torch.zeros((gp, HLL_M), dtype=torch.int32,
                           device=device), None
    if kind == "ddsk":
        return torch.zeros((gp, DDSK_M), dtype=torch.int64,
                           device=device), None
    if kind == "topk":
        return (torch.zeros((gp, TOPK_M), dtype=torch.int64, device=device),
                torch.full((gp, TOPK_M), _INT64_MIN, dtype=torch.int64,
                           device=device))
    raise ValueError(f"unknown rollup partial kind {kind!r}")


def rollup_delta_plain(kind: str, vals: Optional[torch.Tensor],
                       gidx: torch.Tensor, ok: torch.Tensor, out: torch.Tensor,
                       out2: Optional[torch.Tensor]) -> None:
    """The kernel's fold in plain tensor ops, into ``out`` (and ``out2``
    for topk) in place."""
    from citus_tpu_torch.ops import sketch_buckets as sb
    g = gidx.to(torch.int64)
    if kind == "count":
        out.index_add_(0, g, ok.to(torch.int64))
    elif kind in ("sum_int", "sum_float"):
        out.index_add_(0, g, torch.where(ok, vals, torch.zeros((), dtype=vals.dtype)))
    elif kind == "hll":
        bucket, rho = sb.hll_rho_buckets(vals, ok)
        out.view(-1).scatter_reduce_(0, g * HLL_M + bucket, rho, "amax",
                                     include_self=True)
    elif kind == "ddsk":
        out.view(-1).index_add_(0, g * DDSK_M + sb.ddsk_bucket_indexes(vals),
                                ok.to(torch.int64))
    else:
        flat = g * TOPK_M + sb.topk_buckets(vals)
        out.view(-1).index_add_(0, flat, ok.to(torch.int64))
        out2.view(-1).scatter_reduce_(0, flat,
                                      torch.where(ok, vals, _INT64_MIN),
                                      "amax", include_self=True)


_lib = None


def _library():
    global _lib
    if _lib is None:
        from citus_tpu_torch.ops.cuda_build import load
        lib = load("rollup_delta")
        lib.rollup_delta_launch.restype = ctypes.c_int
        lib.rollup_delta_launch.argtypes = [
            ctypes.c_int, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p]
        _lib = lib
    return _lib


def _check(kind, vals, gidx, ok) -> int:
    if kind not in KINDS:
        raise ValueError(f"unknown rollup partial kind {kind!r}")
    n = gidx.shape[0] if gidx.dim() == 1 else -1
    if n < 0 or gidx.dtype != torch.int32 or not gidx.is_contiguous():
        raise ValueError("rollup_delta: gidx must be a contiguous int32 [N]")
    if ok.shape != (n,) or ok.dtype != torch.bool or not ok.is_contiguous() \
            or ok.device != gidx.device:
        raise ValueError("rollup_delta: ok must be a contiguous bool [N] "
                         "beside gidx")
    if kind == "count":
        return n
    if vals is None or vals.shape != (n,) or not vals.is_contiguous() \
            or vals.dtype != _values_dtype(kind) \
            or vals.device != gidx.device:
        raise ValueError(f"rollup_delta: {kind} needs contiguous "
                         f"{_values_dtype(kind)} values [N] beside gidx")
    return n


def rollup_delta(kind: str, vals: Optional[torch.Tensor], gidx: torch.Tensor,
                 ok: torch.Tensor, n_groups: int):
    """One delta batch's tables of one kind, for ``n_groups`` groups:
    [G] for count/sum_int/sum_float, [G, M] for hll/ddsk, a ([G, M],
    [G, M]) counts/values pair for topk.  ``vals`` is int64 (the value
    bits for hll and topk) or float64 (sum_float, ddsk), None for count;
    ``gidx`` int32 group indexes below ``n_groups``; ``ok`` the rows
    that count (real rows with a non-NULL value).  CUDA tensors launch
    the kernel, CPU tensors run the plain version."""
    n = _check(kind, vals, gidx, ok)
    dev = gidx.device
    out, out2 = _tables(kind, n_groups, dev)
    if dev.type == "cuda":
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = _library().rollup_delta_launch(
                KINDS[kind], n, None if vals is None else vals.data_ptr(),
                gidx.data_ptr(), ok.data_ptr(), out.data_ptr(),
                None if out2 is None else out2.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"rollup_delta launch failed: CUDA error {err}")
        count_launch(rollup_delta)
    elif dev.type == "cpu":
        rollup_delta_plain(kind, vals, gidx, ok, out, out2)
    else:
        raise ValueError(f"rollup_delta: no kernel for {dev}")
    return out if out2 is None else (out, out2)


#: kernel launches since the counter was last set to 0
rollup_delta.launches = 0


def delta_partials(kind: str, gidx: np.ndarray, ok: np.ndarray,
                   n_groups: int, values=None, *, device=None):
    """Per-group partials for one delta batch.

    ``kind``   — count | sum_int | sum_float | hll | ddsk | topk
    ``gidx``   — [N] group index per row
    ``ok``     — [N] bool (real row AND value non-null)
    ``values`` — [N] values (sum/ddsk) or int64 hash bits (hll/topk)
    ``device`` — where the tables are built: the Cluster's device
    (None = CUDA, as ``Cluster`` defaults)

    Returns numpy: [G] for count/sum, [G, M] for hll/ddsk, a
    ([G, M], [G, M]) counts/values pair for topk.
    """
    from citus_tpu_torch.cluster import resolve_device
    dev = resolve_device(device)
    n = int(np.asarray(gidx).shape[0])
    np_pad, gp = _pad_to(max(n, 1)), _pad_to(max(n_groups, 1))
    g = np.zeros(np_pad, np.int32)
    g[:n] = np.asarray(gidx, np.int32)
    m = np.zeros(np_pad, bool)
    m[:n] = np.asarray(ok, bool)
    vals = None
    if values is not None:
        dt = np.float64 if kind in ("sum_float", "ddsk") else np.int64
        v = np.zeros(np_pad, dt)
        v[:n] = np.asarray(values, dt)
        vals = torch.from_numpy(v).to(dev)
    out = rollup_delta(kind, vals, torch.from_numpy(g).to(dev),
                       torch.from_numpy(m).to(dev), gp)
    if isinstance(out, tuple):
        return tuple(o.cpu().numpy()[:n_groups] for o in out)
    return out.cpu().numpy()[:n_groups]
