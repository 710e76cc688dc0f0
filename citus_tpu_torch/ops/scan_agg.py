"""Scan → filter → partial-aggregate worker kernels.

One worker function is built per physical plan and cached per plan
family (executor/kernel_cache.py).  Two namespaces build it: numpy, the
host oracle (the reference's own body, unchanged), and the torch
namespace of ``ops/xp_torch.py``, where the filter and argument
expressions run as tensor code on the Cluster's device and the
group-id/count/sum/min/max reduction (and scalar mode's sketch
registers) with the running merge runs in
ONE ``scan_agg_fold`` call per batch: the hand-written CUDA kernel on
a card, its plain PyTorch version on the CPU.  Its structure mirrors the per-shard half of the
reference's split aggregation (multi_logical_optimizer.c
WorkerExtendedOpNode): evaluate quals, compute group ids, accumulate
combinable partial states.  All partial states are chosen so that the
cross-shard combine is a pure elementwise sum/min/max — i.e. a single
``psum``/``pmin``/``pmax`` over the mesh axis (the reference needs a
coordinator-side combine query; we need one collective).

Input convention (fixed by the executor):
    cols:     tuple of value arrays [N] in plan.scan_columns order
    valids:   tuple of bool arrays [N] (validity)
    row_mask: bool array [N] marking real (non-padding) rows

Output convention:
    scalar mode:    tuple of 0-d accumulators per partial op
    direct mode:    tuple of [G] accumulators per partial op, plus [G]
                    int64 group-row counts
    hash_host mode: (filter_mask [N], key value/valid arrays, agg-input
                    value/valid arrays) — grouping happens on the host
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from citus_tpu_torch.planner.bound import (
    _as_mask, compile_expr, param_env_names, predicate_mask,
)
from citus_tpu_torch.planner.physical import PhysicalPlan

#: partial-op kinds the device fold computes: count/sum/min/max and, in
#: scalar mode, the sketch registers of approx_count_distinct (hll),
#: approx_percentile (ddsk) and approx_top_k (topk, topkv).  A GROUP BY
#: with a sketch plans to hash_host and groups on the host, as in the
#: reference (executor._hash_has_exact).
DEVICE_KINDS = ("count", "sum", "min", "max", "hll", "ddsk", "topk", "topkv")


def _sentinel(kind: str, dtype: np.dtype):
    if kind == "min":
        return np.inf if np.issubdtype(dtype, np.floating) else np.iinfo(dtype).max
    if kind == "max":
        return -np.inf if np.issubdtype(dtype, np.floating) else np.iinfo(dtype).min
    return 0


def build_worker_fn(plan: PhysicalPlan, xp) -> Callable:
    """Build the per-shard worker function: ``worker(cols, valids,
    row_mask)`` -> the batch's partial states (pure under numpy; on a
    torch namespace, fresh device registers folded once)."""
    if xp is not np:
        fold = _build_device_fold(plan, xp)

        def worker_device(cols, valids, row_mask):
            return fold(empty_device_partials(plan, xp.device), cols,
                        valids, row_mask)
        return worker_device
    filter_fn = compile_expr(plan.bound.filter, xp) if plan.bound.filter is not None else None
    key_fns = [compile_expr(k, xp) for k in plan.bound.group_keys]
    arg_fns = [compile_expr(a, xp) for a in plan.agg_args]
    arg_types = [a.type for a in plan.agg_args]
    mode = plan.group_mode
    # $N parameters ride as trailing 0-d "columns": the jitted kernel
    # treats them as traced inputs, so one compile serves every value
    names = plan.scan_columns + param_env_names(plan.bound.param_specs)
    partial_ops = plan.partial_ops

    def eval_mask(env, row_mask):
        if filter_fn is None:
            return row_mask
        return row_mask & predicate_mask(xp, filter_fn, env, row_mask)

    def make_env(cols, valids):
        return {n: (c, v) for n, c, v in zip(names, cols, valids)}

    if mode.kind == "scalar":
        def worker_scalar(cols, valids, row_mask):
            env = make_env(cols, valids)
            mask = eval_mask(env, row_mask)
            outs = []
            for op in partial_ops:
                if op.arg_index < 0:
                    outs.append(xp.sum(mask, dtype=np.int64))
                    continue
                v, valid = arg_fns[op.arg_index](env)
                ok = mask & _as_mask(xp, valid, mask)
                dt = np.dtype(op.dtype)
                if op.kind == "count":
                    outs.append(xp.sum(ok, dtype=np.int64))
                elif op.kind == "sum":
                    outs.append(xp.sum(xp.where(ok, v, 0).astype(dt)))
                elif op.kind == "min":
                    outs.append(xp.min(xp.where(ok, v, dt.type(_sentinel("min", dt))).astype(dt)))
                elif op.kind == "max":
                    outs.append(xp.max(xp.where(ok, v, dt.type(_sentinel("max", dt))).astype(dt)))
                elif op.kind == "ddsk":
                    # DDSketch log-bucket histogram: per-row bucket id,
                    # one-hot segment sum into [M] — combinable across
                    # shards with the same psum as plain sum partials.
                    # numpy would materialize the [M, N] one-hot (M=2048
                    # — 16x HLL's), so the host backend bincounts instead
                    from citus_tpu_torch.planner.aggregates import (
                        DDSK_M, ddsk_bucket_indexes,
                    )
                    bucket = ddsk_bucket_indexes(xp, xp.asarray(v))
                    outs.append(np.bincount(
                        bucket[np.asarray(ok)],
                        minlength=DDSK_M).astype(np.int64))
                elif op.kind == "topk":
                    # heavy-hitter count sketch: hashed bucket per row,
                    # one-hot segment sum into [M] — psum-combinable
                    # like ddsk (numpy bincounts for the same reason)
                    from citus_tpu_torch.planner.aggregates import (
                        TOPK_M, topk_buckets,
                    )
                    bucket = topk_buckets(xp, xp.asarray(v).astype(np.int64))
                    outs.append(np.bincount(
                        bucket[np.asarray(ok)],
                        minlength=TOPK_M).astype(np.int64))
                elif op.kind == "topkv":
                    # companion value register: max value per hash
                    # bucket (INT64_MIN = empty) — max-combinable
                    from citus_tpu_torch.planner.aggregates import (
                        TOPK_M, TOPK_SENTINEL, topk_buckets,
                    )
                    v64 = xp.asarray(v).astype(np.int64)
                    bucket = topk_buckets(xp, v64)
                    upd = xp.where(ok, v64, TOPK_SENTINEL)
                    acc = np.full((TOPK_M,), TOPK_SENTINEL, np.int64)
                    outs.append(_np_scatter_max(acc, bucket, upd))
                elif op.kind == "hll":
                    # HyperLogLog registers: per-row (bucket, rho), then a
                    # one-hot segment max into [m] — combinable across
                    # shards with the same elementwise-max collective as
                    # plain max partials
                    from citus_tpu_torch.planner.aggregates import (
                        HLL_M, hll_rho_buckets,
                    )
                    v = xp.asarray(v)
                    bits = v.astype(np.float64).view(np.int64) \
                        if np.issubdtype(v.dtype, np.floating) \
                        else v.astype(np.int64)
                    bucket, rho = hll_rho_buckets(xp, bits, ok)
                    onehot = bucket[None, :] == xp.arange(
                        HLL_M, dtype=np.int32)[:, None]
                    outs.append(xp.max(
                        xp.where(onehot, rho[None, :], np.int32(0)), axis=1))
            return tuple(outs)
        return worker_scalar

    if mode.kind == "direct":
        los = [d.lo for d in mode.domains]
        steps = [d.step for d in mode.domains]
        strides = mode.strides
        G = mode.n_groups

        def seg_sum(gid, upd, dt):
            return _np_scatter_add(xp.zeros((G,), dt), gid, upd)

        def seg_minmax(gid, upd, dt, kind):
            acc = xp.full((G,), dt.type(_sentinel(kind, dt)), dt)
            return (_np_scatter_min if kind == "min" else _np_scatter_max)(acc, gid, upd)

        def worker_direct(cols, valids, row_mask):
            env = make_env(cols, valids)
            mask = eval_mask(env, row_mask)
            gid = None
            for kf, lo, step, stride in zip(key_fns, los, steps, strides):
                kv, kvalid = kf(env)
                kvm = _as_mask(xp, kvalid, kv)
                code = xp.where(kvm, (kv.astype(np.int64) - lo) // step + 1, 0)
                # clamp padding rows into range; they are masked out anyway
                code = xp.clip(code, 0, None)
                part = code * stride
                gid = part if gid is None else gid + part
            # masked/padding rows may compute wild codes from zeroed values;
            # clamp into table range (their updates are neutral anyway, and
            # unclamped indexes would be silently dropped by XLA scatter but
            # error under numpy)
            gid = xp.clip(xp.where(mask, gid, 0), 0, G - 1).astype(np.int32)
            outs = []
            for op in partial_ops:
                dt = np.dtype(op.dtype)
                if op.arg_index < 0:
                    outs.append(seg_sum(gid, xp.where(mask, 1, 0).astype(np.int64), np.dtype(np.int64)))
                    continue
                v, valid = arg_fns[op.arg_index](env)
                ok = mask & _as_mask(xp, valid, mask)
                if op.kind == "count":
                    outs.append(seg_sum(gid, xp.where(ok, 1, 0).astype(np.int64), np.dtype(np.int64)))
                elif op.kind == "sum":
                    outs.append(seg_sum(gid, xp.where(ok, v, 0).astype(dt), dt))
                else:
                    sent = dt.type(_sentinel(op.kind, dt))
                    upd = xp.where(ok, v, sent).astype(dt)
                    outs.append(seg_minmax(gid, upd, dt, op.kind))
            rows = seg_sum(gid, xp.where(mask, 1, 0).astype(np.int64), np.dtype(np.int64))
            return tuple(outs) + (rows,)
        return worker_direct

    # hash_host: device evaluates filter, keys and agg inputs; host groups
    def worker_hash(cols, valids, row_mask):
        env = make_env(cols, valids)
        mask = eval_mask(env, row_mask)
        keys = []
        for kf in key_fns:
            kv, kvalid = kf(env)
            keys.append((kv, _as_mask(xp, kvalid, kv)))
        args = []
        for af in arg_fns:
            av, avalid = af(env)
            av = xp.asarray(av)
            if av.ndim == 0:  # constant argument, e.g. count(1)
                av = xp.broadcast_to(av, mask.shape)
            args.append((av, _as_mask(xp, avalid, mask)))
        return mask, tuple(keys), tuple(args)
    return worker_hash


def _np_scatter_add(acc, idx, upd):
    np.add.at(acc, idx, upd)
    return acc


def _np_scatter_min(acc, idx, upd):
    np.minimum.at(acc, idx, upd)
    return acc


def _np_scatter_max(acc, idx, upd):
    np.maximum.at(acc, idx, upd)
    return acc


def build_fused_worker_fn(plan: PhysicalPlan, xp) -> Callable:
    """Fused hot loop: filter→partial-agg AND the running cross-batch
    merge in one fold.

    ``fused(acc, cols, valids, row_mask) -> acc`` folds one batch into
    the running partial-agg registers.  On a torch namespace the
    registers are updated IN PLACE (the port's counterpart of the
    reference's ``donate_argnums=0``): they stay device-resident across
    the whole scan, one ``scan_agg_fold`` launch per batch, no separate
    merge, no host round-trip until the final copy back.  Each
    accumulator has the shape/dtype of the matching ``_empty_partials``
    seed.  The numpy oracle has no fused loop: it combines per-batch
    partials with ``combine_partials_host``."""
    if plan.group_mode.kind == "hash_host":
        raise ValueError("fused accumulation needs device-combinable "
                         "partials (scalar/direct group modes)")
    if xp is np:
        raise ValueError("the fused fold runs on a torch namespace")
    return _build_device_fold(plan, xp)


def empty_device_partials(plan: PhysicalPlan, device) -> tuple:
    """``executor._empty_partials`` seeds as fresh tensors on ``device``
    (0-d registers in scalar mode)."""
    import torch
    from citus_tpu_torch.executor.executor import _empty_partials
    return tuple(torch.from_numpy(np.array(p)).to(device)
                 for p in _empty_partials(plan, np))


def _build_device_fold(plan: PhysicalPlan, xp) -> Callable:
    """``fold(acc, cols, valids, row_mask) -> acc`` on a torch namespace:
    the filter, group keys and arguments evaluate as tensor code, then
    one ``scan_agg_fold`` folds the batch into ``acc`` in place."""
    from citus_tpu_torch.ops.scan_agg_fold import scan_agg_fold
    inputs = build_fold_inputs(plan, xp)

    def fold(acc, cols, valids, row_mask):
        scan_agg_fold(*inputs(acc, cols, valids, row_mask))
        return acc

    return fold


def _vec(xp, v):
    """A kernel input vector: contiguous [N], or [1] for a constant."""
    v = xp.asarray(v)
    return (v.reshape(1) if v.dim() == 0 else v).contiguous()


def _validity(xp, valid):
    """A kernel validity input: None when every row is valid."""
    if valid is True:
        return None
    if valid is False:
        return xp.const(False, np.bool_)
    return _vec(xp, valid)


def build_fold_inputs(plan: PhysicalPlan, xp) -> Callable:
    """``inputs(acc, cols, valids, row_mask)`` -> the argument tuple of
    ``scan_agg_fold`` for one batch: (registers, group-row counts or
    None, mask, keys, arguments, ops, G).  The device fold calls the
    kernel with it; a caller that holds the kernel against its plain
    version gets the main path's exact kernel inputs from it."""
    filter_fn = compile_expr(plan.bound.filter, xp) \
        if plan.bound.filter is not None else None
    shared, ops, G = build_shared_fold_inputs(plan, xp)
    names = plan.scan_columns + param_env_names(plan.bound.param_specs)
    n_ops = len(ops)
    direct = plan.group_mode.kind == "direct"

    def inputs(acc, cols, valids, row_mask):
        env = {n: (c, v) for n, c, v in zip(names, cols, valids)}
        mask = row_mask
        if filter_fn is not None:
            mask = row_mask & predicate_mask(xp, filter_fn, env, row_mask)
        keys, args = shared(cols, valids)
        # scalar mode keeps 0-d registers (a sketch's are [M]); the
        # kernel sees [1] views
        regs = list(acc[:n_ops]) if direct \
            else [a.view(1) if a.dim() == 0 else a for a in acc[:n_ops]]
        return (regs, acc[n_ops] if direct else None, _vec(xp, mask), keys,
                args, ops, G)

    return inputs


def build_shared_fold_inputs(plan: PhysicalPlan, xp):
    """The part of a fold's inputs that no parameter changes: ->
    (``shared(cols, valids)`` -> (keys, arguments) of one batch, ops,
    G).  The megabatch path computes it once per batch for every query
    of a family; each query contributes only its mask."""
    from citus_tpu_torch.ops.scan_agg_fold import FoldKey, FoldOp
    mode = plan.group_mode
    if mode.kind not in ("scalar", "direct"):
        raise ValueError("the device fold needs device-combinable "
                         "partials (scalar/direct group modes)")
    other = sorted({op.kind for op in plan.partial_ops
                    if op.kind not in DEVICE_KINDS})
    if other:
        raise ValueError(f"the device fold has no partial op kind "
                         f"{', '.join(other)}")
    key_fns = [compile_expr(k, xp) for k in plan.bound.group_keys]
    used = sorted({op.arg_index for op in plan.partial_ops
                   if op.arg_index >= 0})
    arg_fns = [compile_expr(plan.agg_args[i], xp) for i in used]
    slot = {ai: j for j, ai in enumerate(used)}
    ops = [FoldOp("count_star") if op.arg_index < 0
           else FoldOp(op.kind, slot[op.arg_index])
           for op in plan.partial_ops]
    names = plan.scan_columns + param_env_names(plan.bound.param_specs)
    direct = mode.kind == "direct"
    G = mode.n_groups if direct else 1
    domains = list(zip(mode.domains, mode.strides)) if direct else []

    def shared(cols, valids):
        env = {n: (c, v) for n, c, v in zip(names, cols, valids)}
        keys = []
        for kf, (d, stride) in zip(key_fns, domains):
            kv, kvalid = kf(env)
            keys.append(FoldKey(_vec(xp, kv), _validity(xp, kvalid), d.lo,
                                d.step, stride))
        args = []
        for af in arg_fns:
            v, valid = af(env)
            args.append((_vec(xp, v), _validity(xp, valid)))
        return keys, args

    return shared, ops, G


def combine_partials_host(plan: PhysicalPlan, shard_partials: list[tuple]) -> tuple:
    """Combine per-shard partial tuples on the host (numpy).  Used by the
    local executor and as the coordinator-side merge when shards were
    executed in independent rounds; the in-mesh combine uses
    psum/pmin/pmax instead (citus_tpu_torch.parallel.collectives)."""
    ops = list(plan.partial_ops)
    n = len(ops)
    has_rows = plan.group_mode.kind == "direct"
    out = []
    for i, op in enumerate(ops):
        stack = np.stack([np.asarray(sp[i]) for sp in shard_partials])
        if op.kind in ("sum", "count", "ddsk", "topk"):
            out.append(stack.sum(axis=0))
        elif op.kind == "min":
            out.append(stack.min(axis=0))
        elif op.kind in ("max", "hll", "topkv"):
            out.append(stack.max(axis=0))
        else:
            raise AssertionError(f"uncombinable partial kind {op.kind!r}")
    if has_rows:
        rows = np.stack([np.asarray(sp[n]) for sp in shard_partials]).sum(axis=0)
        return tuple(out) + (rows,)
    return tuple(out)
