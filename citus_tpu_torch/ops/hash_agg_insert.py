"""One batch of a hash GROUP BY into the running device hash table: the
hand-written CUDA kernel ``csrc/hash_agg_insert.cu`` and its plain
PyTorch version.

``hash_agg_insert(table, mask, keys, args, ops)`` places every row with
``mask`` set into its group's slot of ``table`` (an
``ops/hash_agg.HashTable``), folds count/sum/min/max of its arguments
into that slot's partial registers and ``rows``, all in place, and
returns the spill mask: the rows that lost both probes, which the
caller merges exactly on the host.  It is the reference's
``citus_tpu/ops/hash_agg.py`` ``build_fused_hash_worker`` once the
filter, keys and arguments are evaluated.

The kernel and the plain version may lay the groups out in different
slots and spill different rows: the reference's claim (the minimum
fingerprint wins a slot, the stored keys verify it) and the kernel's
(the first atomic claim of an empty slot publishes its keys) are both
exact, so the groups after the host merge of table and spill are the
same.  ``keys`` are (values of the table's key dtype, bool validity)
pairs of [N] vectors; ``args`` and ``ops`` are as in ``scan_agg_fold``.

On CUDA tensors it launches the kernel (one launch per call, counted in
``hash_agg_insert.launches``) or raises; on CPU tensors it runs
``hash_agg_insert_plain``.  There is no fallback between the two.

``hash_agg_insert_batched`` inserts one batch into the Q tables of a
stacked ``HashTable`` ([Q, S] tensors) for Q queries of one literal
family at once (``csrc/hash_agg_insert_batched.cu``): masks and spill
masks [Q, N], the keys fingerprinted once per row and shared.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from citus_tpu_torch.ops.cuda_build import count_launch
from citus_tpu_torch.ops.hash_agg import (
    _GOLD, _INT64_MIN, _canon_keys, _fingerprint, _mix, _umod,
)
from citus_tpu_torch.ops.scan_agg_fold import (
    _ACC_DTYPES, _DTYPE_CODES, _KIND_CODES, _Col, _col, _full, _sentinel,
    FoldOp,
)

_MAX_KEYS, _MAX_ARGS, _MAX_OPS = 8, 32, 32
#: fingerprint sentinel of the plain claim: uint64 max, as signed order
_CLAIM_NONE = (1 << 63) - 1


def _stored_eq(kvt, kft, slot, kv, kvm):
    """Slot ``slot`` stores exactly this key value+validity; NaN-aware
    for float keys (the canonical NaN equals itself)."""
    sv = kvt[slot]
    eq = sv == kv
    if kvt.is_floating_point():
        eq = eq | (torch.isnan(sv) & torch.isnan(kv))
    return eq & (kft[slot] == kvm.to(torch.int8) + 1)


def _scatter_max_(table: torch.Tensor, idx, upd) -> None:
    if table.dtype == torch.bool:
        table.view(torch.uint8).scatter_reduce_(
            0, idx, upd.to(torch.uint8), "amax", include_self=True)
    else:
        table.scatter_reduce_(0, idx, upd, "amax", include_self=True)


def _insert_keys(keys, mask, h, key_values, key_flags, occ):
    """Two-probe match-or-claim into the running table, step by step as
    the reference's ``_insert_keys``: each probe round first matches
    rows against the stored entry at their candidate slot, then lets
    unmatched rows claim an unoccupied slot (minimum fingerprint wins;
    the stored key values verify the claim).  Updates the key tables in
    place; -> (slot, placed, occ)."""
    S = occ.shape[0]
    placed = torch.zeros_like(mask)
    fslot = None
    for hp in (h, _mix(h, _GOLD)):
        cand = _umod(hp, S)
        want = mask & ~placed
        cand = torch.where(want, cand, 0)
        match = want & occ[cand]
        for (kv, kvm), kvt, kft in zip(keys, key_values, key_flags):
            match = match & _stored_eq(kvt, kft, cand, kv, kvm)
        wants_claim = want & ~match & ~occ[cand]
        # unsigned order of the fingerprints = signed order of h ^ MIN
        order = hp ^ _INT64_MIN
        claimed = torch.full((S,), _CLAIM_NONE, dtype=torch.int64,
                             device=h.device)
        claimed.scatter_reduce_(
            0, cand, torch.where(wants_claim, order, _CLAIM_NONE), "amin",
            include_self=True)
        claim_ok = wants_claim & (claimed[cand] == order)
        for (kv, kvm), kvt, kft in zip(keys, key_values, key_flags):
            ksent = torch.full((), _key_min(kvt.dtype), dtype=kvt.dtype,
                               device=kvt.device)
            _scatter_max_(kvt, cand, torch.where(claim_ok, kv, ksent))
            _scatter_max_(kft, cand, torch.where(
                claim_ok, kvm.to(torch.int8) + 1,
                torch.zeros((), dtype=torch.int8, device=kft.device)))
        verified = claim_ok
        for (kv, kvm), kvt, kft in zip(keys, key_values, key_flags):
            verified = verified & _stored_eq(kvt, kft, cand, kv, kvm)
        hits = torch.zeros(S, dtype=torch.int32, device=h.device)
        hits.index_add_(0, cand, verified.to(torch.int32))
        occ = occ | (hits > 0)
        took = match | verified
        fslot = cand if fslot is None else torch.where(took, cand, fslot)
        placed = placed | took
    return fslot, placed, occ


def _key_min(dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("-inf")
    if dtype == torch.bool:
        return False
    return torch.iinfo(dtype).min


def hash_agg_insert_plain(table, mask: torch.Tensor, keys: Sequence[tuple],
                          args: Sequence[tuple], ops: Sequence[FoldOp]
                          ) -> torch.Tensor:
    """The same insert in plain tensor ops, on any device: the
    reference's claim-then-verify passes (``_insert_keys``) and
    ``index_add_``/``scatter_reduce_`` folds.  -> spill mask."""
    n = mask.shape[0]
    dev = mask.device
    full_keys = []
    for kv, kvm in keys:
        kvm = torch.ones(n, dtype=torch.bool, device=dev) if kvm is None \
            else _full(kvm, n)
        full_keys.append((_full(kv, n), kvm))
    canon = _canon_keys(full_keys)
    h = _fingerprint(canon, (n,), dev)
    slot, placed, _ = _insert_keys(canon, mask, h, table.key_values,
                                   table.key_flags, table.rows > 0)
    for prior, op in zip(table.partials, ops):
        if op.kind == "count_star":
            prior.index_add_(0, slot, placed.to(torch.int64))
            continue
        v, valid = args[op.arg]
        ok = placed if valid is None else placed & _full(valid, n)
        if op.kind == "count":
            prior.index_add_(0, slot, ok.to(torch.int64))
        elif op.kind == "sum":
            prior.index_add_(0, slot,
                             torch.where(ok, _full(v, n).to(prior.dtype), 0))
        else:
            upd = torch.where(ok, _full(v, n).to(prior.dtype),
                              _sentinel(op.kind, prior.dtype))
            prior.scatter_reduce_(0, slot, upd,
                                  "amin" if op.kind == "min" else "amax",
                                  include_self=True)
    table.rows.index_add_(0, slot, placed.to(torch.int64))
    table.state.copy_(torch.where(table.rows > 0, 2, 0).to(torch.int32))
    return mask & ~placed


# ------------------------------------------------------------- kernel


class _Params(ctypes.Structure):
    _fields_ = [("n", ctypes.c_int64), ("slots", ctypes.c_int64),
                ("mask", ctypes.c_void_p), ("spill", ctypes.c_void_p),
                ("n_keys", ctypes.c_int32), ("n_args", ctypes.c_int32),
                ("n_ops", ctypes.c_int32), ("pad", ctypes.c_int32),
                ("keys", _Col * _MAX_KEYS),
                ("key_values", ctypes.c_void_p * _MAX_KEYS),
                ("key_flags", ctypes.c_void_p * _MAX_KEYS),
                ("args", _Col * _MAX_ARGS),
                ("op_kind", ctypes.c_int32 * _MAX_OPS),
                ("op_arg", ctypes.c_int32 * _MAX_OPS),
                ("op_dtype", ctypes.c_int32 * _MAX_OPS),
                ("acc", ctypes.c_void_p * _MAX_OPS),
                ("rows", ctypes.c_void_p), ("state", ctypes.c_void_p)]


_lib = None


def _library():
    global _lib
    if _lib is None:
        from citus_tpu_torch.ops.cuda_build import load
        lib = load("hash_agg_insert")
        lib.hash_agg_insert_launch.restype = ctypes.c_int
        lib.hash_agg_insert_launch.argtypes = [ctypes.POINTER(_Params),
                                               ctypes.c_void_p]
        lib.hash_agg_insert_params_size.restype = ctypes.c_int
        lib.hash_agg_insert_params_size.argtypes = []
        if lib.hash_agg_insert_params_size() != ctypes.sizeof(_Params):
            raise RuntimeError("hash_agg_insert: parameter block layout "
                               "differs between Python and CUDA")
        _lib = lib
    return _lib


def _check_table_vector(t, what: str, shape: tuple, dtypes, dev) -> None:
    if t.device != dev or t.dtype not in dtypes or t.shape != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"hash_agg_insert: {what} must be a contiguous {list(shape)} "
            f"tensor of {dtypes} on {dev}, got {t.dtype} {tuple(t.shape)} "
            f"on {t.device}")


def _block(table, mask, spill, keys, args, ops, n_q=None) -> _Params:
    """The parameter block of one launch: one [S] table and [N] masks,
    or ``n_q`` stacked [n_q, S] tables and [n_q, N] masks."""
    dev = mask.device
    n = mask.shape[-1]
    S = table.slots
    want_dim = 1 if n_q is None else 2
    if mask.dtype != torch.bool or mask.dim() != want_dim \
            or (n_q is not None and mask.shape[0] != n_q) \
            or not mask.is_contiguous():
        raise ValueError("hash_agg_insert: mask must be a contiguous bool "
                         + ("vector" if n_q is None else f"[{n_q}, N] tensor"))
    if not 0 < len(keys) <= _MAX_KEYS or len(args) > _MAX_ARGS \
            or len(ops) > _MAX_OPS:
        raise ValueError(
            f"hash_agg_insert takes 1 to {_MAX_KEYS} keys, at most "
            f"{_MAX_ARGS} arguments and {_MAX_OPS} partial ops")
    if len(keys) != len(table.key_values) \
            or len(ops) != len(table.partials):
        raise ValueError("hash_agg_insert: one key table per key and one "
                         "partial table per op")
    if S <= 0 or S >= 1 << 62 or (n_q or 1) * S >= 1 << 62:
        raise ValueError(f"hash_agg_insert: bad slot count {S}")
    shape = (S,) if n_q is None else (n_q, S)
    p = _Params()
    p.n, p.slots = n, S
    p.mask, p.spill = mask.data_ptr(), spill.data_ptr()
    p.n_keys, p.n_args, p.n_ops = len(keys), len(args), len(ops)
    for i, ((kv, kvm), kvt, kft) in enumerate(zip(keys, table.key_values,
                                                  table.key_flags)):
        c = _col(kv, kvm, f"key {i}", n, dev)
        _check_table_vector(kvt, f"key table {i}", shape, (kv.dtype,), dev)
        _check_table_vector(kft, f"key flag table {i}", shape,
                            (torch.int8,), dev)
        p.keys[i] = c
        p.key_values[i] = kvt.data_ptr()
        p.key_flags[i] = kft.data_ptr()
    for i, (v, valid) in enumerate(args):
        p.args[i] = _col(v, valid, f"argument {i}", n, dev)
    for i, (a, op) in enumerate(zip(table.partials, ops)):
        if op.kind not in _KIND_CODES:
            raise ValueError(f"hash_agg_insert: unknown op kind {op.kind!r}")
        _check_table_vector(a, f"partial table {i} ({op.kind})", shape,
                            _ACC_DTYPES[op.kind], dev)
        if op.kind != "count_star" and not 0 <= op.arg < len(args):
            raise ValueError(f"hash_agg_insert: op {i} argument out of "
                             "range")
        p.op_kind[i] = _KIND_CODES[op.kind]
        p.op_arg[i] = max(op.arg, 0)
        p.op_dtype[i] = _DTYPE_CODES[a.dtype]
        p.acc[i] = a.data_ptr()
    _check_table_vector(table.rows, "rows", shape, (torch.int64,), dev)
    _check_table_vector(table.state, "state", shape, (torch.int32,), dev)
    p.rows, p.state = table.rows.data_ptr(), table.state.data_ptr()
    return p


def _launch(table, mask, keys, args, ops) -> torch.Tensor:
    dev = mask.device
    spill = torch.empty(mask.shape[-1], dtype=torch.bool, device=dev)
    p = _block(table, mask, spill, keys, args, ops)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _library().hash_agg_insert_launch(ctypes.byref(p), stream)
    if err != 0:
        raise RuntimeError(f"hash_agg_insert launch failed: CUDA error {err}")
    return spill


def hash_agg_insert(table, mask: torch.Tensor, keys: Sequence[tuple],
                    args: Sequence[tuple], ops: Sequence[FoldOp]
                    ) -> torch.Tensor:
    """Insert one batch into ``table`` in place; -> spill mask [N] bool.

    CUDA tensors launch the kernel, CPU tensors run the plain version."""
    if mask.device.type == "cuda":
        spill = _launch(table, mask, keys, args, ops)
        count_launch(hash_agg_insert)
        return spill
    if mask.device.type != "cpu":
        raise ValueError(f"hash_agg_insert: no kernel for {mask.device}")
    return hash_agg_insert_plain(table, mask, keys, args, ops)


#: kernel launches since the counter was last set to 0
hash_agg_insert.launches = 0


# --------------------------------------------------- Q queries at once


def hash_agg_insert_batched_plain(table, masks: torch.Tensor,
                                  keys: Sequence[tuple],
                                  args: Sequence[tuple],
                                  ops: Sequence[FoldOp]) -> torch.Tensor:
    """The same batched insert in plain tensor ops: one
    ``hash_agg_insert_plain`` per query into its own table.  -> spill
    masks [Q, N]."""
    return torch.stack([
        hash_agg_insert_plain(table.query(q), masks[q], keys, args, ops)
        for q in range(masks.shape[0])])


_lib_batched = None


def _library_batched():
    global _lib_batched
    if _lib_batched is None:
        from citus_tpu_torch.ops.cuda_build import load
        lib = load("hash_agg_insert_batched")
        lib.hash_agg_insert_batched_launch.restype = ctypes.c_int
        lib.hash_agg_insert_batched_launch.argtypes = [
            ctypes.POINTER(_Params), ctypes.c_int, ctypes.c_void_p]
        lib.hash_agg_insert_batched_params_size.restype = ctypes.c_int
        lib.hash_agg_insert_batched_params_size.argtypes = []
        if lib.hash_agg_insert_batched_params_size() \
                != ctypes.sizeof(_Params):
            raise RuntimeError("hash_agg_insert_batched: parameter block "
                               "layout differs between Python and CUDA")
        _lib_batched = lib
    return _lib_batched


def _launch_batched(table, masks, keys, args, ops) -> torch.Tensor:
    n_q = masks.shape[0] if masks.dim() == 2 else 0
    if n_q <= 0:
        raise ValueError("hash_agg_insert_batched: masks must be [Q, N], "
                         "Q > 0")
    dev = masks.device
    spill = torch.empty(masks.shape, dtype=torch.bool, device=dev)
    p = _block(table, masks, spill, keys, args, ops, n_q)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _library_batched().hash_agg_insert_batched_launch(
            ctypes.byref(p), n_q, stream)
    if err != 0:
        raise RuntimeError(f"hash_agg_insert_batched launch failed: CUDA "
                           f"error {err}")
    return spill


def hash_agg_insert_batched(table, masks: torch.Tensor, keys: Sequence[tuple],
                            args: Sequence[tuple], ops: Sequence[FoldOp]
                            ) -> torch.Tensor:
    """Insert one batch into the Q tables of ``table`` (a ``HashTable``
    whose tensors are [Q, S]) at once, in place: table q takes the rows
    that pass ``masks[q]`` (bool [Q, N]).  The keys are canonicalized
    and fingerprinted once per row; ``keys`` and ``args`` are shared by
    every query.  It is the reference's ``batched:jit_hash_fused`` (a
    ``jax.vmap`` of the fused hash worker over the query axis).
    -> spill masks [Q, N].  CUDA tensors launch
    ``csrc/hash_agg_insert_batched.cu`` (one launch per call, counted in
    ``hash_agg_insert_batched.launches``), CPU tensors run the plain
    version."""
    if masks.device.type == "cuda":
        spill = _launch_batched(table, masks, keys, args, ops)
        count_launch(hash_agg_insert_batched)
        return spill
    if masks.device.type != "cpu":
        raise ValueError(f"hash_agg_insert_batched: no kernel for "
                         f"{masks.device}")
    return hash_agg_insert_batched_plain(table, masks, keys, args, ops)


#: kernel launches since the counter was last set to 0
hash_agg_insert_batched.launches = 0
