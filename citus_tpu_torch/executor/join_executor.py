"""Join execution.

Physical execution of BoundJoinSelect plans:

- *colocated* strategy: one task per shard index of the colocation
  group; each task joins the colocated shard of every distributed
  relation plus the (replicated) reference/local relations — the direct
  analog of the reference's per-shard-group pushdown joins.
- *pull* strategy: relations are scanned (with filter/chunk pruning
  pushed down) and joined on the coordinator — the reference's
  pull-to-coordinator degradation path.
- *repartition* strategy: both sides are partitioned by join-key hash
  and joined per bucket.  On the ``gpu`` backend each inner equi step
  runs on the Cluster's device mesh (``_device_join_step``): each member
  packs its rows with the partition kernel (B7, ``parallel/shuffle.py
  pack_blocks``), the exchange kernel (``exchange_blocks``) hands block d
  of every member to member d, and each member joins what it received
  with the sort-join kernel (B8, ``sorted_join``), gathering the joined
  columns.  On a one-member mesh the exchange is the identity.  Steps
  the device join refuses (outer joins, and outputs over
  ``MAX_DEVICE_JOIN_CAP``) take the bucket path, whose packing and
  exchange run B7 and the exchange kernel too.  The ``cpu`` backend
  buckets on the host, as the reference's cpu oracle does.

The join algorithm is an exact hash join over int64-encoded key bit
patterns (nulls never match, matching SQL semantics); inner/left/right/
full/cross kinds are supported.  Aggregation over joined rows reuses
HostGroupAccumulator + the standard finalize pipeline.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from citus_tpu_torch.catalog import Catalog
from citus_tpu_torch.config import Settings
from citus_tpu_torch.errors import ExecutionError
from citus_tpu_torch.executor.executor import Result
from citus_tpu_torch.executor.finalize import finalize_groups, order_and_limit, project_rows
from citus_tpu_torch.executor.host_agg import HostGroupAccumulator
from citus_tpu_torch.observability import trace as _trace
from citus_tpu_torch.observability.trace import clock
from citus_tpu_torch.planner.bound import BColumn, BKeyRef, compile_expr, predicate_mask
from citus_tpu_torch.planner.join_planner import BoundJoinSelect, RelPlan
from citus_tpu_torch.storage import ShardReader
from citus_tpu_torch.storage.overlay import visible_meta

# frame: dict[qualified_col -> (values ndarray, valid ndarray)] + row count


def _load_rel_frame(cat: Catalog, rp: RelPlan, qualified: bool,
                    shard_indexes: Optional[list[int]] = None):
    """Scan one relation (given shards or all) -> (frame, n_rows)."""
    t = rp.table
    idxs = shard_indexes if shard_indexes is not None else list(range(t.shard_count))
    vals = {c: [] for c in rp.columns}
    valids = {c: [] for c in rp.columns}
    total = 0
    for si in idxs:
        shard = t.shards[si]
        d = cat.shard_dir(t.name, shard.shard_id, shard.placements[0])
        if not os.path.isdir(d) or visible_meta(d)["row_count"] == 0:
            continue
        reader = ShardReader(d, t.schema)
        for batch in reader.scan(rp.columns, rp.intervals):
            for c in rp.columns:
                v = batch.values[c].astype(t.schema.column(c).type.device_dtype, copy=False)
                m = batch.validity[c]
                vals[c].append(v)
                valids[c].append(np.ones(batch.row_count, bool) if m is None else m)
            total += batch.row_count
    frame = {}
    for c in rp.columns:
        q = f"{rp.alias}.{c}" if qualified else c
        if vals[c]:
            frame[q] = (np.concatenate(vals[c]), np.concatenate(valids[c]))
        else:
            dt = t.schema.column(c).type.device_dtype
            frame[q] = (np.zeros(0, dt), np.zeros(0, bool))
    if rp.filter is not None and total > 0:
        fn = compile_expr(rp.filter, np)
        mask = np.asarray(predicate_mask(np, fn, frame, np.ones(total, bool)))
        if mask.shape == ():
            mask = np.full(total, bool(mask))
        keep = np.nonzero(mask)[0]
        frame = {k: (v[keep], m[keep] if not isinstance(m, bool) else m)
                 for k, (v, m) in frame.items()}
        total = keep.size
    return frame, total


def _frame_len(frame) -> int:
    for v, _ in frame.values():
        return len(v)
    return 0


def _gather(frame, idx, found=None):
    """Gather rows of a frame by index; rows where found==False become
    all-NULL (outer join padding)."""
    out = {}
    safe = np.clip(idx, 0, None)
    for k, (v, m) in frame.items():
        vv = v[safe] if len(v) else np.zeros(len(idx), v.dtype)
        mm = (m[safe] if not isinstance(m, bool) else np.full(len(idx), m)) if len(v) \
            else np.zeros(len(idx), bool)
        if found is not None:
            mm = mm & found
            vv = np.where(found, vv, 0) if vv.dtype != object else vv
        out[k] = (vv, np.asarray(mm))
    return out


def _key_matrix(frame, key_exprs, n):
    """Evaluate join key expressions -> (int64 matrix [n, k], all_valid [n])."""
    cols = []
    valid = np.ones(n, bool)
    for e in key_exprs:
        v, m = compile_expr(e, np)(frame)
        v = np.asarray(v)
        if v.ndim == 0:
            v = np.broadcast_to(v, (n,))
        if m is True:
            m = np.ones(n, bool)
        elif m is False:
            m = np.zeros(n, bool)
        else:
            m = np.asarray(m)
        bits = v.astype(np.float64).view(np.int64) if np.issubdtype(v.dtype, np.floating) \
            else v.astype(np.int64)
        cols.append(bits)
        valid &= m
    mat = np.stack(cols, axis=1) if cols else np.zeros((n, 0), np.int64)
    return mat, valid


def _hash_join_indexes(lmat, lvalid, rmat, rvalid, kind):
    """Exact multi-key equi-join -> (left_idx, right_idx, left_found,
    right_found).  NULL keys never match.  Fully vectorized: both sides
    map into one key-group id space (np.unique over the stacked key
    matrices), left rows bucket by group, and each right row expands to
    its bucket with a repeat/offset construction."""
    ln, rn = len(lmat), len(rmat)
    lsel = np.nonzero(lvalid)[0]
    rsel = np.nonzero(rvalid)[0]
    l_matched = np.zeros(ln, bool)
    r_matched = np.zeros(rn, bool)
    if lsel.size and rsel.size:
        both = np.concatenate([lmat[lsel], rmat[rsel]], axis=0)
        _, inv = np.unique(both, axis=0, return_inverse=True)
        lgid = inv[: lsel.size]
        rgid = inv[lsel.size:]
        G = int(inv.max()) + 1
        lcount = np.bincount(lgid, minlength=G)
        lorder = np.argsort(lgid, kind="stable")
        lstart = np.concatenate([[0], np.cumsum(lcount)])
        rcnt = lcount[rgid]
        total = int(rcnt.sum())
        ri = np.repeat(rsel, rcnt)
        run_starts = np.concatenate([[0], np.cumsum(rcnt)[:-1]]).astype(np.int64)
        offs = (np.arange(total, dtype=np.int64)
                - np.repeat(run_starts, rcnt)
                + np.repeat(lstart[rgid], rcnt))
        li = lsel[lorder[offs]]
        l_matched[li] = True
        r_matched[rsel[rcnt > 0]] = True
    else:
        li = np.zeros(0, np.int64)
        ri = np.zeros(0, np.int64)
    lfound = np.ones(len(li), bool)
    rfound = np.ones(len(ri), bool)
    if kind in ("left", "full"):
        extra = np.nonzero(~l_matched)[0]
        li = np.concatenate([li, extra])
        ri = np.concatenate([ri, np.zeros(len(extra), np.int64)])
        lfound = np.concatenate([lfound, np.ones(len(extra), bool)])
        rfound = np.concatenate([rfound, np.zeros(len(extra), bool)])
    if kind in ("right", "full"):
        extra = np.nonzero(~r_matched)[0]
        li = np.concatenate([li, np.zeros(len(extra), np.int64)])
        ri = np.concatenate([ri, extra])
        lfound = np.concatenate([lfound, np.zeros(len(extra), bool)])
        rfound = np.concatenate([rfound, np.ones(len(extra), bool)])
    return li, ri, lfound, rfound


MAX_CROSS_ROWS = 50_000_000

# --------------------------------------------------- repartition shuffle

_MIX = np.int64(-7046029254386353131)  # odd 64-bit multiplier (splitmix)


def _bucket_targets(frame, key_exprs, n, n_buckets) -> np.ndarray:
    """Destination bucket per row: mixed hash of the join-key bit
    patterns.  NULL-key rows never match anything; they route to bucket
    0 so outer joins still preserve them exactly once."""
    mat, valid = _key_matrix(frame, key_exprs, n)
    with np.errstate(over="ignore"):
        h = np.zeros(n, np.int64)
        for j in range(mat.shape[1]):
            h = (h ^ mat[:, j]) * _MIX
            h ^= (h >> np.int64(29)) & np.int64(0x7FFFFFFFFFFFFFFF)
    tgt = (h % n_buckets + n_buckets) % n_buckets
    return np.where(valid, tgt, 0).astype(np.int32)


def _host_shuffle(frame, target: np.ndarray, n_buckets: int) -> list:
    """Host bucketing (single-device / cpu-oracle fallback) — the moral
    equivalent of the reference's bucket files on one worker."""
    out = []
    for b in range(n_buckets):
        sel = target == b
        sub = {k: (v[sel], m[sel] if not isinstance(m, bool) else m)
               for k, (v, m) in frame.items()}
        out.append((sub, int(sel.sum())))
    return out


# Per-device join output capacity above which the device join falls back
# to the host bucket path (a many-to-many explosion would not fit HBM).
MAX_DEVICE_JOIN_CAP = 1 << 22


def _get_mesh(settings: Settings, device, mesh=None):
    """The device mesh, or None for the cpu oracle.  The ``gpu`` backend
    joins on the Cluster's mesh, or without one on the one-member mesh of
    its device (the reference needs more than one device for its mesh;
    at one member the exchange is the identity, and the port's partition
    and join kernels do the real work there)."""
    backend = settings.executor.task_executor_backend
    if backend == "cpu":
        return None
    if backend != "gpu":
        raise ExecutionError(
            f"unknown task_executor_backend {backend!r} (cpu | gpu)")
    if mesh is not None:
        return mesh
    if device is None:
        raise ExecutionError("the gpu backend needs the Cluster's device")
    import torch
    from citus_tpu_torch.parallel.mesh import default_mesh
    return default_mesh(torch.device(device))


def _to_device(arrays, device) -> tuple:
    """numpy arrays -> tensors on ``device`` (stacked shapes kept)."""
    import torch
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in arrays)


def _to_host(tensors) -> list:
    return [t.cpu().numpy() for t in tensors]


def _sync(mesh) -> None:
    """Wait for every member's card."""
    import torch
    for device in dict.fromkeys(mesh.devices):
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def _stack_side(frame, gid, tgt, mask, n_dev):
    """Split one relation's rows across source devices: frame columns
    (values + validity as bool columns), gids, targets, masks all become
    [n_dev, per] stacks; returns the per-(src,dst) max count for the
    exchange capacity."""
    names = list(frame.keys())
    n = len(gid)
    per = -(-max(n, 1) // n_dev)
    pad = per * n_dev - n

    def stack(a, fill):
        a = np.concatenate([a, np.full(pad, fill, a.dtype)]) if pad else a
        return a.reshape(n_dev, per)

    values = []
    for k in names:
        v, m = frame[k]
        values.append(stack(np.asarray(v), 0))
        values.append(stack(np.asarray(m) if not isinstance(m, bool)
                            else np.full(n, m), False))
    gid2 = stack(gid.astype(np.int64), 0)
    tgt2 = stack(tgt, 0)
    mask2 = stack(mask, False)
    cap = 1
    for s in range(n_dev):
        row = tgt2[s][mask2[s]]
        if row.size:
            cap = max(cap, int(np.bincount(row, minlength=n_dev).max()))
    return names, tuple(values), gid2, tgt2, mask2, cap


def _empty_joined_frame(lframe, rframe):
    out = {}
    for src in (lframe, rframe):
        for k, (v, m) in src.items():
            out[k] = (np.asarray(v)[:0],
                      np.zeros(0, bool))
    return out, 0


def _device_join_step(cur, n, right, rn, step, mesh, stats=None):
    """Inner equi-join of two frames entirely on the mesh: host assigns
    dense join-group ids (exact np.unique over both sides' key tuples —
    no hash-collision concerns), routes gid % n_dev, and the partition
    kernel packs both sides, the exchange moves them, and the sort-join
    kernel joins and gathers per device (parallel/shuffle.py
    build_repartition_join).  The host sees one fetch of the joined
    columns.  Output capacity is computed exactly from per-gid count
    products, so the kernel never retries.

    Returns (frame, n) or None when unsupported (non-inner, no keys, or
    a many-to-many output too large for a static device buffer).
    ``stats`` (a list) gets one dict of the step's times: the host's
    group-id assignment, the copies to and from the device, and the
    device's time from the first launch to the overflow read."""
    if step.kind != "inner" or not step.left_keys:
        return None
    t0 = clock()
    lmat, lvalid = _key_matrix(cur, step.left_keys, n)
    rmat, rvalid = _key_matrix(right, step.right_keys, rn)
    nl_v, nr_v = int(lvalid.sum()), int(rvalid.sum())
    if nl_v == 0 or nr_v == 0:
        return _apply_residual(step, *_empty_joined_frame(cur, right))
    both = np.concatenate([lmat[lvalid], rmat[rvalid]], axis=0)
    _, inv = np.unique(both, axis=0, return_inverse=True)
    U = int(inv.max()) + 1
    n_dev = mesh.shape["shard"]
    lc = np.bincount(inv[:nl_v], minlength=U)
    rc = np.bincount(inv[nl_v:], minlength=U)
    bucket_pairs = np.zeros(n_dev, np.int64)
    np.add.at(bucket_pairs, np.arange(U, dtype=np.int64) % n_dev, lc * rc)
    max_pairs = int(bucket_pairs.max())
    if max_pairs == 0:
        return _apply_residual(step, *_empty_joined_frame(cur, right))
    J = max_pairs
    if J > MAX_DEVICE_JOIN_CAP:
        return None
    lgid = np.zeros(n, np.int64)
    lgid[lvalid] = inv[:nl_v]
    rgid = np.zeros(rn, np.int64)
    rgid[rvalid] = inv[nl_v:]
    lnames, lv, lgid2, ltgt2, lmask2, cap_l = _stack_side(
        cur, lgid, (lgid % n_dev).astype(np.int32), np.asarray(lvalid), n_dev)
    rnames, rv, rgid2, rtgt2, rmask2, cap_r = _stack_side(
        right, rgid, (rgid % n_dev).astype(np.int32), np.asarray(rvalid), n_dev)
    from citus_tpu_torch.parallel.shuffle import build_repartition_join
    fn = build_repartition_join(mesh, n_lcols=len(lv), n_rcols=len(rv),
                                capacity_l=cap_l, capacity_r=cap_r,
                                join_cap=J, n_groups=U)
    # the stacks land on member 0's device; each member's row moves on
    # to its own device inside the builder (nothing moves on one card)
    dev = mesh.device
    t1 = clock()
    lv, rv = _to_device(lv, dev), _to_device(rv, dev)
    lgid2, ltgt2, lmask2, rgid2, rtgt2, rmask2 = _to_device(
        (lgid2, ltgt2, lmask2, rgid2, rtgt2, rmask2), dev)
    _sync(mesh)
    t2 = clock()
    out_l, out_r, out_valid, overflow = fn(lv, lgid2, ltgt2, lmask2,
                                           rv, rgid2, rtgt2, rmask2)
    overflow = int(overflow)
    t3 = clock()
    if overflow != 0:
        # capacities are computed exactly host-side; a nonzero overflow
        # means lost rows — refuse to return a wrong answer
        raise ExecutionError("device join capacity undersized "
                             f"(overflow={overflow})")
    out_valid = out_valid.cpu().numpy()
    out_l, out_r = _to_host(out_l), _to_host(out_r)
    t4 = clock()
    if stats is not None:
        stats.append({"rows_left": n, "rows_right": rn, "groups": U,
                      "capacity_left": cap_l, "capacity_right": cap_r,
                      "join_cap": J, "gid_host_ms": (t1 - t0) * 1e3,
                      "h2d_ms": (t2 - t1) * 1e3,
                      "device_ms": (t3 - t2) * 1e3,
                      "d2h_ms": (t4 - t3) * 1e3})
    frame = {}
    sels = [out_valid[d] for d in range(n_dev)]
    total = int(out_valid.sum())
    for names, outs in ((lnames, out_l), (rnames, out_r)):
        for i, k in enumerate(names):
            vals = outs[2 * i]
            ms = outs[2 * i + 1]
            frame[k] = (np.concatenate([vals[d][sels[d]] for d in range(n_dev)]),
                        np.concatenate([ms[d][sels[d]] for d in range(n_dev)]))
    return _apply_residual(step, frame, total)


def _apply_residual(step, cur, n):
    """Post-join residual filter (host) — shared by the device-join and
    host-join paths."""
    if step.residual is None or n == 0:
        return cur, n
    fn = compile_expr(step.residual, np)
    mask = np.asarray(predicate_mask(np, fn, cur, np.ones(n, bool)))
    if mask.shape == ():
        mask = np.full(n, bool(mask))
    keep = np.nonzero(mask)[0]
    cur = {k: (v[keep], m[keep] if not isinstance(m, bool) else m)
           for k, (v, m) in cur.items()}
    return cur, keep.size


def _device_shuffle(frame, target: np.ndarray, mesh) -> list:
    """Exchange rows to their bucket member over the mesh: each member's
    partition kernel packs them, the exchange kernel moves them (the
    map-merge of MapMergeJob; parallel/shuffle.py).  Returns per-bucket
    host frames."""
    from citus_tpu_torch.parallel.shuffle import build_repartition

    n_dev = mesh.shape["shard"]
    names = list(frame.keys())
    n = len(target)
    per = -(-max(n, 1) // n_dev)  # rows per source device (ceil)
    pad = per * n_dev - n

    def stack(a, fill):
        a = np.concatenate([a, np.full(pad, fill, a.dtype)]) if pad else a
        return a.reshape(n_dev, per)

    values = []
    for k in names:
        v, m = frame[k]
        values.append(stack(np.asarray(v), 0))
        values.append(stack(np.asarray(m) if not isinstance(m, bool)
                            else np.full(n, m), False))
    tgt2 = stack(target, 0)
    mask2 = stack(np.ones(n, bool), False)
    # exact per-(src,dst) counts are known host-side
    counts = np.zeros((n_dev, n_dev), np.int64)
    for s in range(n_dev):
        row = tgt2[s][mask2[s]]
        if row.size:
            counts[s] = np.bincount(row, minlength=n_dev)
    cap = max(1, int(counts.max()))
    fn = build_repartition(mesh, n_cols=len(values), capacity=cap)
    dev = mesh.device
    out_vals, out_valid, overflow = fn(
        _to_device(values, dev), *_to_device((tgt2, mask2), dev))
    if int(overflow) != 0:
        raise ExecutionError("repartition capacity undersized "
                             f"(overflow={int(overflow)})")
    out_vals = _to_host(out_vals)
    out_valid = out_valid.cpu().numpy()
    buckets = []
    for d in range(n_dev):
        sel = out_valid[d]
        sub = {}
        for i, k in enumerate(names):
            sub[k] = (out_vals[2 * i][d][sel], out_vals[2 * i + 1][d][sel])
        buckets.append((sub, int(sel.sum())))
    return buckets


def _repartition_tasks(cat: Catalog, bj: BoundJoinSelect, settings: Settings,
                       device=None, mesh=None):
    """Partition both distributed sides by join-key hash -> per-bucket
    frame overrides.  Uses the device shuffle when a mesh is available,
    host bucketing otherwise."""
    la, ra, lks, rks = bj.repartition_spec
    qualified = bj.binder.qualified
    lframe, ln = _load_rel_frame(cat, bj.rel_plans[la], qualified)
    rframe, rn = _load_rel_frame(cat, bj.rel_plans[ra], qualified)
    mesh = _get_mesh(settings, device, mesh)
    B = (mesh.shape["shard"] if mesh is not None
         else settings.planner.repartition_bucket_count_per_device * 8)
    ltgt = _bucket_targets(lframe, lks, ln, B)
    rtgt = _bucket_targets(rframe, rks, rn, B)
    if mesh is not None:
        lbuckets = _device_shuffle(lframe, ltgt, mesh)
        rbuckets = _device_shuffle(rframe, rtgt, mesh)
        mode = "all_to_all"
    else:
        lbuckets = _host_shuffle(lframe, ltgt, B)
        rbuckets = _host_shuffle(rframe, rtgt, B)
        mode = "host"
    overrides = [{la: lbuckets[b], ra: rbuckets[b]} for b in range(B)]
    return overrides, mode


def _execute_join_tree(cat: Catalog, bj: BoundJoinSelect,
                       shard_index: Optional[int],
                       frame_override: Optional[dict] = None):
    """Join all relations for one task -> (frame, n_rows).

    ``frame_override`` supplies pre-partitioned frames for relations the
    repartition shuffle already bucketed (the merge half of MapMergeJob)."""
    if frame_override is not None and "__result__" in frame_override:
        return frame_override["__result__"]  # stepwise DAG already joined
    qualified = bj.binder.qualified
    frames = {}
    for alias, t in bj.rels:
        if frame_override is not None and alias in frame_override:
            frames[alias] = frame_override[alias]
            continue
        rp = bj.rel_plans[alias]
        if t.is_distributed and shard_index is not None:
            frames[alias] = _load_rel_frame(cat, rp, qualified, [shard_index])
        else:
            frames[alias] = _load_rel_frame(cat, rp, qualified)

    cur, n = frames[bj.rels[0][0]]
    for step in bj.steps:
        right, rn = frames[step.right_alias]
        cur, n = _apply_step(cur, n, right, rn, step)
    return cur, n


def _apply_step(cur, n, right, rn, step):
    """Join one step's right frame onto the accumulated frame."""
    if step.kind == "cross" or not step.left_keys:
        if n * rn > MAX_CROSS_ROWS:
            raise ExecutionError("cross join result too large")
        li = np.repeat(np.arange(n, dtype=np.int64), rn)
        ri = np.tile(np.arange(rn, dtype=np.int64), n)
        lfound = np.ones(len(li), bool)
        rfound = np.ones(len(ri), bool)
    else:
        lmat, lvalid = _key_matrix(cur, step.left_keys, n)
        rmat, rvalid = _key_matrix(right, step.right_keys, rn)
        li, ri, lfound, rfound = _hash_join_indexes(lmat, lvalid, rmat, rvalid, step.kind)
    new = _gather(cur, li, lfound if step.kind in ("right", "full") else None)
    new.update(_gather(right, ri, rfound if step.kind in ("left", "full", "inner", "cross") else None))
    return _apply_residual(step, new, len(li))


def _concat_frames(pieces):
    """[(frame, n)] -> (frame, n) — column-wise concatenation.  Keeps a
    zero-row frame's schema so later steps can still evaluate keys."""
    nonzero = [(f, n) for f, n in pieces if n > 0]
    if not nonzero:
        return (pieces[0][0], 0) if pieces else ({}, 0)
    pieces = nonzero
    if len(pieces) == 1:
        return pieces[0]
    keys = list(pieces[0][0].keys())
    out = {}
    for k in keys:
        vals = np.concatenate([np.asarray(f[k][0]) for f, _ in pieces])
        ms = np.concatenate([
            (np.asarray(f[k][1]) if not isinstance(f[k][1], bool)
             else np.full(n, f[k][1])) for f, n in pieces])
        out[k] = (vals, ms)
    return out, sum(n for _, n in pieces)


def _stepwise_shuffle_join(cat: Catalog, bj: BoundJoinSelect,
                           settings: Settings, device=None, stats=None,
                           mesh=None):
    """Multi-step shuffle DAG: each equi-join step hash-partitions both
    the accumulated frame and the incoming relation on the step's keys
    and joins bucket-by-bucket — the general MapMergeJob composition for
    arbitrary join trees (reference: dependent MapMerge jobs executed in
    dependency order, directed_acyclic_graph_execution.c:57).  Buckets
    then concatenate so the next step can re-partition on ITS keys."""
    qualified = bj.binder.qualified
    frames = {alias: _load_rel_frame(cat, bj.rel_plans[alias], qualified)
              for alias, _t in bj.rels}
    mesh = _get_mesh(settings, device, mesh)
    B = (mesh.shape["shard"] if mesh is not None
         else settings.planner.repartition_bucket_count_per_device * 8)
    mode = "all_to_all" if mesh is not None else "host"
    cur, n = frames[bj.rels[0][0]]
    shuffles = 0
    device_joins = 0
    for step in bj.steps:
        right, rn = frames[step.right_alias]
        if step.left_keys and (n + rn) > 0:
            if mesh is not None:
                dj = _device_join_step(cur, n, right, rn, step, mesh, stats)
                if dj is not None:
                    cur, n = dj
                    shuffles += 1
                    device_joins += 1
                    continue
            ltgt = _bucket_targets(cur, step.left_keys, n, B)
            rtgt = _bucket_targets(right, step.right_keys, rn, B)
            if mesh is not None and cur and right:
                lb = _device_shuffle(cur, ltgt, mesh)
                rb = _device_shuffle(right, rtgt, mesh)
            else:
                lb = _host_shuffle(cur, ltgt, B)
                rb = _host_shuffle(right, rtgt, B)
            shuffles += 1
            pieces = []
            for b in range(B):
                (f_l, n_l), (f_r, n_r) = lb[b], rb[b]
                pieces.append(_apply_step(f_l, n_l, f_r, n_r, step))
            cur, n = _concat_frames(pieces)
        else:
            cur, n = _apply_step(cur, n, right, rn, step)
    if device_joins:
        mode = f"all_to_all+{device_joins}-devjoin"
    return cur, n, mode, shuffles


class _JoinPlanView:
    """Adapter so finalize/order helpers can consume a join plan."""

    def __init__(self, bj: BoundJoinSelect):
        self.bound = bj
        self.agg_extract = bj.agg_extract
        self.runtime_cache: dict = {}


def _join_text_src(bj: BoundJoinSelect):
    from citus_tpu_torch.planner.bound import BDictRemap

    def resolve(e):
        from citus_tpu_torch.planner.bound import walk
        if isinstance(e, BKeyRef):
            e = bj.group_keys[e.index]
        while isinstance(e, BDictRemap):
            e = e.operand
        if not e.type.is_text:
            return None
        if isinstance(e, BColumn):
            return bj.binder.text_source(e)
        for n in walk(e):
            if isinstance(n, BColumn) and n.type.is_text:
                return bj.binder.text_source(n)
        return None
    return resolve


def _guard_remote_hosted(cat: Catalog, bj: BoundJoinSelect) -> None:
    """Refuse a join over shards another coordinator hosts: the frame
    loads read local placement directories, and pushing or pulling a
    join's relations is not ported (ROADMAP.md A13)."""
    for alias, t in bj.rels:
        if any(cat.is_remote_node(s.placements[0]) for s in t.shards):
            from citus_tpu_torch.errors import UnsupportedFeatureError
            raise UnsupportedFeatureError(
                f"a join over {t.name!r}, whose shards another coordinator "
                "hosts, is not ported yet (ROADMAP.md A13)")


def execute_join_select(cat: Catalog, bj: BoundJoinSelect, settings: Settings,
                        device=None, mesh=None) -> Result:
    """Run a join plan; ``device`` is the Cluster's torch device and
    ``mesh`` its ``DeviceMesh``, over which the ``gpu`` backend's device
    join runs (None: the one-member mesh of ``device``)."""
    from citus_tpu_torch.executor.executor import _guard_remote_written
    from citus_tpu_torch.transaction.snapshot import snapshot_read_multi

    _guard_remote_written(cat, [t_.name for _, t_ in bj.rels])
    _guard_remote_hosted(cat, bj)
    # snapshot read across every base relation: the multi-shard frame
    # loads below must observe a consistent flip generation per
    # colocation group — validated, non-blocking (transaction/snapshot.py)
    return snapshot_read_multi(
        cat.data_dir, [t_ for _, t_ in bj.rels],
        lambda: _execute_join_select(cat, bj, settings, device, mesh),
        timeout=settings.executor.lock_timeout_s)


def _execute_join_select(cat: Catalog, bj: BoundJoinSelect, settings: Settings,
                         device=None, mesh=None) -> Result:
    from citus_tpu_torch.executor.executor import GLOBAL_COUNTERS
    GLOBAL_COUNTERS.bump("join_queries")
    t0 = clock()
    strategy = bj.strategy
    if strategy == "repartition" and not settings.planner.enable_repartition_joins:
        strategy = "pull"
    shuffle_mode = None
    join_steps: list = []
    # tasks: (shard_index, frame_override) pairs
    if strategy == "colocated":
        dist = [t for _, t in bj.rels if t.is_distributed]
        tasks = ([(si, None) for si in range(dist[0].shard_count)]
                 if dist else [(None, None)])
    elif (strategy == "repartition" and bj.repartition_spec is not None
          and _get_mesh(settings, device, mesh) is None):
        # single-repartition with host buckets (the cpu oracle)
        with _trace.span("shuffle", mode="host"):
            overrides, shuffle_mode = _repartition_tasks(cat, bj, settings,
                                                         device, mesh)
        tasks = [(None, fo) for fo in overrides]
    elif strategy == "repartition":
        # on a mesh the step-wise path joins each equi step on device
        # (exchange + per-device sort join, one host fetch)
        with _trace.span("shuffle", mode="mesh"):
            frame_n = _stepwise_shuffle_join(cat, bj, settings, device,
                                             join_steps, mesh)
        shuffle_mode = f"{frame_n[2]}:{frame_n[3]}-step"
        tasks = [(None, {"__result__": (frame_n[0], frame_n[1])})]
    else:
        tasks = [(None, None)]

    view = _JoinPlanView(bj)
    text_src = _join_text_src(bj)
    rows: list[tuple] = []
    if bj.has_aggs:
        acc = HostGroupAccumulator(len(bj.group_keys), bj.partial_ops)
        key_fns = [compile_expr(k, np) for k in bj.group_keys]
        arg_fns = [compile_expr(a, np) for a in bj.agg_args]
        for si, fo in tasks:
            frame, n = _execute_join_tree(cat, bj, si, fo)
            if n == 0:
                continue
            mask = np.ones(n, bool)
            if bj.post_filter is not None:
                mask = np.asarray(predicate_mask(
                    np, compile_expr(bj.post_filter, np), frame, mask))
                if mask.shape == ():
                    mask = np.full(n, bool(mask))
            keys = [f(frame) for f in key_fns]
            args = [f(frame) for f in arg_fns]
            acc.add_batch(mask, keys, args)
        key_arrays, partials = acc.finalize([k.type for k in bj.group_keys],
                                            scalar=not bj.group_keys)
        if partials is not None:
            rows = finalize_groups(view, cat, key_arrays, partials, text_src=text_src)
    else:
        env_batches = []
        for si, fo in tasks:
            frame, n = _execute_join_tree(cat, bj, si, fo)
            if n == 0:
                continue
            mask = np.ones(n, bool)
            if bj.post_filter is not None:
                mask = np.asarray(predicate_mask(
                    np, compile_expr(bj.post_filter, np), frame, mask))
                if mask.shape == ():
                    mask = np.full(n, bool(mask))
            env_batches.append((frame, mask))
        rows = project_rows(view, cat, env_batches, text_src=text_src)

    rows = order_and_limit(view, rows)
    visible = list(bj.output_names)
    if bj.hidden_outputs:
        keep = len(visible) - bj.hidden_outputs
        visible = visible[:keep]
        rows = [r[:keep] for r in rows]
    explain = {
        "strategy": f"join:{strategy}",
        "tasks": len(tasks),
        "elapsed_s": clock() - t0,
    }
    if shuffle_mode is not None:
        explain["shuffle"] = shuffle_mode
    if join_steps:
        explain["device_join_steps"] = join_steps
    return Result(
        columns=visible,
        rows=rows,
        types=[e.type for e in bj.final_exprs][:len(visible)],
        explain=explain,
    )
