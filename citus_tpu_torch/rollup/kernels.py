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

On the card the kernel runs in one of two regimes (``regime``): direct
(global atomics) for a refresh batch and the sketch kinds, privatized
(each block folds its rows into a table in its shared memory, then adds
its nonzero slots into the output by global atomics) for count and sums
when rows far outnumber groups, as in a backfill.
Top-k's table is one int64 record a cell, ``[G, M, 2]`` (count, then
the maximum value), returned as two strided views.

``delta_partials`` pads the batch to a power-of-two row count and the
tables to a power-of-two group count, from 8 (``_pad_to``), as the
reference does: the padding bounds the table shapes a steady refresh
loop allocates.  On the card its inputs go over in one copy of a pinned
staging buffer, and each table comes back in one copy.
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
#: regime codes (csrc/rollup_delta.cu RD_DIRECT, RD_PRIVATE)
REGIMES = {"direct": 0, "private": 1}
#: the kinds the privatized regime takes, the most groups whose [G] table
#: a block keeps in shared memory (128 KB), and the rows a group it
#: needs: below that, zeroing and writing a table a block costs more
#: than the atomics it saves
PRIVATE_KINDS = ("count", "sum_int", "sum_float")
PRIVATE_MAX_GROUPS = 16_384
PRIVATE_MIN_ROWS_PER_GROUP = 32
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


def regime(kind: str, n: int, n_groups: int) -> str:
    """The kernel's regime for ``n`` rows of ``kind`` into ``n_groups``
    groups: ``"private"`` for count and sums when the table fits a
    block's shared memory and the rows outnumber the groups
    ``PRIVATE_MIN_ROWS_PER_GROUP`` to 1 (a backfill), else direct."""
    if kind in PRIVATE_KINDS and n_groups <= PRIVATE_MAX_GROUPS \
            and n >= PRIVATE_MIN_ROWS_PER_GROUP * n_groups:
        return "private"
    return "direct"


def _table(kind: str, gp: int, device) -> torch.Tensor:
    """An uninitialised table of one kind for ``gp`` groups (top-k: the
    ``[G, M, 2]`` records)."""
    if kind in ("count", "sum_int"):
        return torch.empty(gp, dtype=torch.int64, device=device)
    if kind == "sum_float":
        return torch.empty(gp, dtype=torch.float64, device=device)
    if kind == "hll":
        return torch.empty((gp, HLL_M), dtype=torch.int32, device=device)
    if kind == "ddsk":
        return torch.empty((gp, DDSK_M), dtype=torch.int64, device=device)
    if kind == "topk":
        return torch.empty((gp, TOPK_M, 2), dtype=torch.int64, device=device)
    raise ValueError(f"unknown rollup partial kind {kind!r}")


def _split(kind: str, table):
    """A table as ``rollup_delta`` returns it: top-k's records as its
    (counts, values) views, any other table as it is."""
    return (table[..., 0], table[..., 1]) if kind == "topk" else table


def _empty_table(kind: str, gp: int, device) -> torch.Tensor:
    """``_table`` set empty: zeros, top-k's records (0, INT64_MIN)."""
    t = _table(kind, gp, device)
    if kind != "topk":
        return t.zero_()
    t[..., 0] = 0
    t[..., 1] = _INT64_MIN
    return t


def _tables(kind: str, gp: int, device) -> tuple:
    """Fresh empty tables of one kind for ``gp`` groups: (table, top-k
    value table or None); top-k's two are the strided views of one
    record a cell."""
    t = _split(kind, _empty_table(kind, gp, device))
    return t if kind == "topk" else (t, None)


def rollup_delta_plain(kind: str, vals: Optional[torch.Tensor],
                       gidx: torch.Tensor, ok: torch.Tensor, out: torch.Tensor,
                       out2: Optional[torch.Tensor]) -> None:
    """The kernel's fold in plain tensor ops, into ``out`` (and ``out2``
    for topk) in place; a [G, M] table may be a strided view (top-k's
    records), flattened with ``reshape``, which views it."""
    from citus_tpu_torch.ops import sketch_buckets as sb
    g = gidx.to(torch.int64)
    if kind == "count":
        out.index_add_(0, g, ok.to(torch.int64))
    elif kind in ("sum_int", "sum_float"):
        out.index_add_(0, g, torch.where(ok, vals, torch.zeros((), dtype=vals.dtype)))
    elif kind == "hll":
        bucket, rho = sb.hll_rho_buckets(vals, ok)
        out.reshape(-1).scatter_reduce_(0, g * HLL_M + bucket, rho, "amax",
                                        include_self=True)
    elif kind == "ddsk":
        out.reshape(-1).index_add_(0, g * DDSK_M + sb.ddsk_bucket_indexes(vals),
                                   ok.to(torch.int64))
    else:
        flat = g * TOPK_M + sb.topk_buckets(vals)
        out.reshape(-1).index_add_(0, flat, ok.to(torch.int64))
        out2.reshape(-1).scatter_reduce_(0, flat,
                                         torch.where(ok, vals, _INT64_MIN),
                                         "amax", include_self=True)


_lib = None


def bind(lib):
    """``lib``, a build of ``csrc/rollup_delta.cu``, with its C interface
    typed."""
    lib.rollup_delta_launch.restype = ctypes.c_int
    lib.rollup_delta_launch.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    return lib


def _library():
    global _lib
    if _lib is None:
        from citus_tpu_torch.ops.cuda_build import load
        _lib = bind(load("rollup_delta"))
    return _lib


def _check(kind, vals, gidx, ok) -> int:
    if kind not in KINDS:
        raise ValueError(f"unknown rollup partial kind {kind!r}")
    if gidx.dtype != torch.int32 or gidx.dim() != 1 \
            or not gidx.is_contiguous():
        raise ValueError("rollup_delta: gidx must be a contiguous int32 [N]")
    n = gidx.shape[0]
    di = gidx.get_device()
    if ok.dtype != torch.bool or ok.dim() != 1 or ok.shape[0] != n \
            or not ok.is_contiguous() or ok.get_device() != di:
        raise ValueError("rollup_delta: ok must be a contiguous bool [N] "
                         "beside gidx")
    if kind == "count":
        return n
    want = _values_dtype(kind)
    if vals is None or vals.dtype != want or vals.dim() != 1 \
            or vals.shape[0] != n or not vals.is_contiguous() \
            or vals.get_device() != di:
        raise ValueError(f"rollup_delta: {kind} needs contiguous {want} "
                         "values [N] beside gidx")
    return n


def launch_fold(kind: str, vals, gidx, ok, table, regime_: str,
                fill: bool = True) -> None:
    """One launch of the kernel on the current stream of ``gidx``'s card
    into ``table`` (``_table``'s shape), in ``regime_``; with ``fill``
    the launch first sets the table empty.  Not counted as a launch of
    ``rollup_delta`` (the caller counts its own)."""
    dev = gidx.device
    if torch.cuda.current_device() != dev.index:
        with torch.cuda.device(dev):
            return launch_fold(kind, vals, gidx, ok, table, regime_, fill)
    err = _library().rollup_delta_launch(
        KINDS[kind], REGIMES[regime_], gidx.shape[0], table.shape[0],
        None if vals is None else vals.data_ptr(), gidx.data_ptr(),
        ok.data_ptr(), table.data_ptr(), int(fill),
        torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(f"rollup_delta launch failed: CUDA error {err}")


def _fold_table(kind: str, vals, gidx, ok, n_groups: int) -> torch.Tensor:
    """``rollup_delta``'s table as one tensor (top-k: its records)."""
    n = _check(kind, vals, gidx, ok)
    dev = gidx.device
    if dev.type == "cuda":
        table = _table(kind, n_groups, dev)
        r = regime(kind, n, n_groups)
        launch_fold(kind, vals, gidx, ok, table, r)
        count_launch(rollup_delta)
        rollup_delta.last_regime = r
        return table
    if dev.type != "cpu":
        raise ValueError(f"rollup_delta: no kernel for {dev}")
    table = _empty_table(kind, n_groups, dev)
    t = _split(kind, table)
    rollup_delta_plain(kind, vals, gidx, ok,
                       *(t if kind == "topk" else (t, None)))
    return table


def rollup_delta(kind: str, vals: Optional[torch.Tensor], gidx: torch.Tensor,
                 ok: torch.Tensor, n_groups: int):
    """One delta batch's tables of one kind, for ``n_groups`` groups:
    [G] for count/sum_int/sum_float, [G, M] for hll/ddsk, a ([G, M],
    [G, M]) counts/values pair for topk (strided views of one [G, M, 2]
    record table).  ``vals`` is int64 (the value bits for hll and topk)
    or float64 (sum_float, ddsk), None for count; ``gidx`` int32 group
    indexes below ``n_groups``; ``ok`` the rows that count (real rows
    with a non-NULL value).  CUDA tensors launch the kernel (in the
    regime ``regime`` picks, recorded in ``rollup_delta.last_regime``),
    CPU tensors run the plain version."""
    return _split(kind, _fold_table(kind, vals, gidx, ok, n_groups))


#: kernel launches since the counter was last set to 0
rollup_delta.launches = 0
#: the last launch's regime (``regime``)
rollup_delta.last_regime = None


def _staged(kind: str, gidx, ok, values, n: int, np_pad: int, dev) -> tuple:
    """The padded batch on ``dev``: (values or None, gidx, ok).  On a
    card one pinned buffer of [values | gidx | ok] goes over in one
    copy, and the three are views of it."""
    has_vals = values is not None
    vbytes = 8 * np_pad if has_vals else 0
    cuda = dev.type == "cuda"
    buf = torch.empty(vbytes + 5 * np_pad, dtype=torch.uint8,
                      pin_memory=cuda)
    host = buf.numpy()
    vdt = _values_dtype(kind)
    if has_vals:
        dt = np.float64 if vdt == torch.float64 else np.int64
        v = host[:vbytes].view(dt)
        v[:n] = np.asarray(values, dt)
        v[n:] = 0
    g = host[vbytes:vbytes + 4 * np_pad].view(np.int32)
    g[:n] = np.asarray(gidx, np.int32)
    g[n:] = 0
    m = host[vbytes + 4 * np_pad:].view(np.bool_)
    m[:n] = np.asarray(ok, bool)
    m[n:] = False
    if cuda:
        buf = buf.to(dev, non_blocking=True)
    vals = buf[:vbytes].view(vdt) if has_vals else None
    return (vals, buf[vbytes:vbytes + 4 * np_pad].view(torch.int32),
            buf[vbytes + 4 * np_pad:].view(torch.bool))


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
    ([G, M], [G, M]) counts/values pair for topk (views of the one
    record table copied back).
    """
    from citus_tpu_torch.cluster import resolve_device
    dev = resolve_device(device)
    n = int(np.asarray(gidx).shape[0])
    np_pad, gp = _pad_to(max(n, 1)), _pad_to(max(n_groups, 1))
    vals, g, m = _staged(kind, gidx, ok, values, n, np_pad, dev)
    host = _fold_table(kind, vals, g, m, gp).cpu().numpy()[:n_groups]
    return (host[..., 0], host[..., 1]) if kind == "topk" else host
