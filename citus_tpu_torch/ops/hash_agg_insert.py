"""One batch of a hash GROUP BY into the running device hash table: the
CUDA kernel generated for each plan (``ops/expr_codegen.py
generate_fold_row``, instantiating ``csrc/hash_agg_insert.cu``) and its
plain PyTorch version.

``hash_agg_insert(prog, table, cols, params, row_mask)`` evaluates a
plan's WHERE, group keys (cast to the table's key dtypes) and aggregate
arguments (a hash ``FoldProgram``) over one batch's scan columns,
places every row that passes into its group's slot of ``table`` (an
``ops/hash_agg.HashTable``), folds count/sum/min/max of its arguments
into that slot's partial registers and ``rows``, all in place, and
returns the spill mask: the rows that lost both probes, which the
caller merges exactly on the host.  It is the reference's
``citus_tpu/ops/hash_agg.py`` ``build_fused_hash_worker``.

The kernel and the plain version may lay the groups out in different
slots and spill different rows: the reference's claim (the minimum
fingerprint wins a slot, the stored keys verify it) and the kernel's
(the first atomic claim of an empty slot publishes its keys) are both
exact, so the groups after the host merge of table and spill are the
same.

On CUDA tensors it launches the program's generated kernel (one launch
per call, counted in ``hash_agg_insert.launches``) or raises; on CPU
tensors it runs ``insert_plain``: the expressions as eager tensor code,
then ``hash_agg_insert_plain`` over (values of the table's key dtype,
bool validity) key pairs and ``scan_agg_fold``'s (values, validity)
arguments.  There is no fallback between the two.

``hash_agg_insert_batched`` inserts one batch into the Q tables of a
stacked ``HashTable`` ([Q, S] tensors) for Q queries of one literal
family at once (``csrc/hash_agg_insert_batched.cu``): masks and spill
masks [Q, N], the keys and arguments evaluated and fingerprinted once
per row and shared.
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
    _ACC_DTYPES, _DTYPE_CODES, _KIND_CODES, _full, _sentinel, _validity,
    _vec, FoldOp, FoldProgram, row_block,
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


def plain_insert_inputs(prog: FoldProgram, cols: dict, params: dict,
                        row_mask: torch.Tensor, with_filter: bool = True):
    """-> (mask, keys, args) of ``hash_agg_insert_plain`` for one batch:
    the program's expressions in eager tensor ops, each key cast to its
    table's key dtype as the reference's ``_eval_keys`` casts it (not yet
    canonical: the insert canonicalizes)."""
    from citus_tpu_torch.ops.xp_torch import torch_dtype
    mask, keys, args = prog.plain_eval(cols, params, row_mask, with_filter)
    n = row_mask.shape[-1]
    dev = row_mask.device
    tkeys = []
    for (kv, kvalid), kdt in zip(keys, prog.key_dtypes):
        kv = torch.as_tensor(kv).to(torch_dtype(kdt)).reshape(-1)
        kvm = torch.as_tensor(kvalid, device=dev).reshape(-1)
        tkeys.append((kv.expand(n).contiguous(), kvm.expand(n).contiguous()))
    return mask, tkeys, [(_vec(v), _validity(k, dev)) for v, k in args]


def insert_plain(prog: FoldProgram, table, cols: dict, params: dict,
                 row_mask: torch.Tensor) -> torch.Tensor:
    """The plain version of the generated insert, on any device: the
    expressions as eager tensor code, then ``hash_agg_insert_plain``.
    -> spill mask."""
    mask, keys, args = plain_insert_inputs(prog, cols, params, row_mask)
    return hash_agg_insert_plain(table, mask.contiguous(), keys, args,
                                 prog.ops)


# ------------------------------------------------------------- kernel


class _Params(ctypes.Structure):
    _fields_ = [("n", ctypes.c_int64), ("slots", ctypes.c_int64),
                ("slots_magic", ctypes.c_uint64),
                ("mask", ctypes.c_void_p), ("spill", ctypes.c_void_p),
                ("records", ctypes.c_void_p),
                ("slot_stride", ctypes.c_int64),
                ("query_stride", ctypes.c_int64),
                ("n_keys", ctypes.c_int32), ("n_ops", ctypes.c_int32),
                ("key_dtype", ctypes.c_int32 * _MAX_KEYS),
                ("key_off", ctypes.c_int32 * _MAX_KEYS),
                ("flag_off", ctypes.c_int32 * _MAX_KEYS),
                ("op_kind", ctypes.c_int32 * _MAX_OPS),
                ("op_arg", ctypes.c_int32 * _MAX_OPS),
                ("op_dtype", ctypes.c_int32 * _MAX_OPS),
                ("acc_off", ctypes.c_int32 * _MAX_OPS),
                ("rows_off", ctypes.c_int32), ("state_off", ctypes.c_int32)]


def slot_magic(S: int) -> int:
    """The reciprocal of ``csrc/hash_slot.cuh hs_slot``: floor((2^64 - 1)
    / S), with which a high multiply and one correction give h % S."""
    return ((1 << 64) - 1) // S


def _bind_library(lib):
    """Declare a generated insert library's entry points and check its
    parameter blocks' layouts."""
    from citus_tpu_torch.ops.filter_mask import _FmParams
    P, R = ctypes.POINTER(_Params), ctypes.POINTER(_FmParams)
    lib.hash_agg_insert_launch.restype = ctypes.c_int
    lib.hash_agg_insert_launch.argtypes = [P, R, ctypes.c_void_p]
    lib.hash_agg_insert_batched_launch.restype = ctypes.c_int
    lib.hash_agg_insert_batched_launch.argtypes = [P, R, ctypes.c_int,
                                                   ctypes.c_void_p]
    for fn in (lib.hash_agg_insert_params_size, lib.fold_row_params_size):
        fn.restype = ctypes.c_int
        fn.argtypes = []
    if lib.hash_agg_insert_params_size() != ctypes.sizeof(_Params) \
            or lib.fold_row_params_size() != ctypes.sizeof(_FmParams):
        raise RuntimeError("hash_agg_insert: parameter block layout "
                           "differs between Python and CUDA")
    return lib


#: the build name of a generated insert's source (not a ``csrc`` name:
#: the source includes ``csrc/hash_agg_insert.cu``)
INSERT_BUILD = "generated_insert"


def insert_library(prog: FoldProgram):
    """The generated insert library of ``prog``, built at first use."""
    return prog.library(INSERT_BUILD, _bind_library)


def _record_field(t, what: str, shape: tuple, dtypes, dev, base: int,
                  strides: tuple) -> int:
    """-> the byte offset of a table tensor's field in its slot record:
    ``t`` is a ``shape`` view of ``dtypes`` on ``dev`` with the table's
    record ``strides`` (bytes) whose field lies inside the record at
    ``base``."""
    es = t.element_size() if t.dtype in dtypes else 0
    off = t.data_ptr() - base
    if t.device != dev or es == 0 or tuple(t.shape) != shape \
            or tuple(x * es for x in t.stride()) != strides \
            or not 0 <= off <= min(strides) - es or off % es:
        raise ValueError(
            f"hash_agg_insert: {what} must be a {list(shape)} view of "
            f"{dtypes} on {dev} into the table's slot records (strides "
            f"{strides} bytes; see ops/hash_agg.py empty_hash_state), got "
            f"{t.dtype} {tuple(t.shape)} strides {t.stride()} on {t.device}")
    return off


def table_block(table, kinds, shape: tuple, dev, n: int, n_q=None):
    """The table side of a hash kernel's parameter block (``HaiParams``):
    slots and their reciprocal, the records' base and strides, each
    field's offset in a record, op kinds and accumulator dtypes; ``n``
    rows, ``n_q`` stacked tables or None.  The table must be laid out in
    slot records (``ops/hash_agg.py empty_hash_state``): every tensor a
    strided view of one record per slot.  The checked block is kept on
    the table and reused while its tensors are the same objects."""
    S = table.slots
    if not 0 < len(table.key_values) <= _MAX_KEYS \
            or len(table.partials) > _MAX_OPS:
        raise ValueError(f"hash_agg_insert takes 1 to {_MAX_KEYS} keys and "
                         f"at most {_MAX_OPS} partial ops")
    if len(kinds) != len(table.partials):
        raise ValueError("hash_agg_insert: one partial table per op")
    if S <= 0 or S >= 1 << 62 or (n_q or 1) * S >= 1 << 62:
        raise ValueError(f"hash_agg_insert: bad slot count {S}")
    fields = (table.key_values + table.key_flags + table.partials
              + [table.rows, table.state])
    key = (tuple(kinds), shape, str(dev), table.state.data_ptr())
    cached = getattr(table, "_block", None)
    if cached is not None and cached[0] == key \
            and all(a is b for a, b in zip(cached[1], fields)):
        p = _Params.from_buffer_copy(cached[2])
        p.n = n
        return p
    st = table.state
    strides = tuple(x * 4 for x in st.stride())
    if min(strides) % 8 or min(strides) <= 0:
        raise ValueError("hash_agg_insert: the table is not laid out in "
                         "slot records (ops/hash_agg.py empty_hash_state)")
    base = min(t.data_ptr() for t in fields)
    p = _Params()
    p.n, p.slots, p.slots_magic = n, S, slot_magic(S)
    p.records, p.slot_stride = base, strides[-1]
    p.query_stride = strides[0] if n_q is not None else 0
    p.n_keys, p.n_ops = len(table.key_values), len(kinds)
    taken = []

    def field(t, what, dtypes):
        off = _record_field(t, what, shape, dtypes, dev, base, strides)
        taken.append((off, off + t.element_size()))
        return off
    for i, (kvt, kft) in enumerate(zip(table.key_values, table.key_flags)):
        if kvt.dtype not in _DTYPE_CODES:
            raise TypeError(f"hash_agg_insert: key table {i} has dtype "
                            f"{kvt.dtype}")
        p.key_dtype[i] = _DTYPE_CODES[kvt.dtype]
        p.key_off[i] = field(kvt, f"key table {i}", (kvt.dtype,))
        p.flag_off[i] = field(kft, f"key flag table {i}", (torch.int8,))
    for i, (a, kind) in enumerate(zip(table.partials, kinds)):
        if kind not in _KIND_CODES:
            raise ValueError(f"hash_agg_insert: unknown op kind {kind!r}")
        p.op_kind[i] = _KIND_CODES[kind]
        p.acc_off[i] = field(a, f"partial table {i} ({kind})",
                             _ACC_DTYPES[kind])
        p.op_dtype[i] = _DTYPE_CODES[a.dtype]
    p.rows_off = field(table.rows, "rows", (torch.int64,))
    p.state_off = field(st, "state", (torch.int32,))
    taken.sort()
    if any(a[1] > b[0] for a, b in zip(taken, taken[1:])):
        raise ValueError("hash_agg_insert: two fields of the table's slot "
                         "records overlap")
    table._block = (key, fields, bytes(p))
    return p


def _block(prog: FoldProgram, table, mask, spill, n_q=None) -> _Params:
    """The parameter block of one launch: one [S] table and [N] masks,
    or ``n_q`` stacked [n_q, S] tables and [n_q, N] masks."""
    from citus_tpu_torch.ops.xp_torch import torch_dtype
    dev = mask.device
    n = mask.shape[-1]
    ops = prog.ops
    want_dim = 1 if n_q is None else 2
    if mask.dtype != torch.bool or mask.dim() != want_dim \
            or (n_q is not None and mask.shape[0] != n_q) \
            or not mask.is_contiguous():
        raise ValueError("hash_agg_insert: mask must be a contiguous bool "
                         + ("vector" if n_q is None else f"[{n_q}, N] tensor"))
    n_args = len(prog.exprs.args)
    if len(prog.exprs.keys) != len(table.key_values) or n_args > _MAX_ARGS:
        raise ValueError(f"hash_agg_insert: one key table per key, at most "
                         f"{_MAX_ARGS} arguments")
    for i, (kvt, kdt) in enumerate(zip(table.key_values, prog.key_dtypes)):
        if kvt.dtype != torch_dtype(kdt):
            raise ValueError(f"hash_agg_insert: key table {i} is "
                             f"{kvt.dtype}, the program's key {kdt}")
    shape = (table.slots,) if n_q is None else (n_q, table.slots)
    p = table_block(table, [op.kind for op in ops], shape, dev, n, n_q)
    p.mask, p.spill = mask.data_ptr(), spill.data_ptr()
    for i, op in enumerate(ops):
        if op.kind != "count_star" and not 0 <= op.arg < n_args:
            raise ValueError(f"hash_agg_insert: op {i} argument out of "
                             "range")
        p.op_arg[i] = max(op.arg, 0)
    return p


def _launch(prog, table, cols, params, row_mask) -> torch.Tensor:
    lib = insert_library(prog)
    dev = row_mask.device
    spill = torch.empty(row_mask.shape[-1], dtype=torch.bool, device=dev)
    p = _block(prog, table, row_mask, spill)
    r = row_block(prog, cols, params, row_mask.shape[0], dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.hash_agg_insert_launch(ctypes.byref(p), ctypes.byref(r),
                                         stream)
    if err != 0:
        raise RuntimeError(f"hash_agg_insert launch failed: CUDA error {err}")
    return spill


def hash_agg_insert(prog: FoldProgram, table, cols: dict, params: dict,
                    row_mask: torch.Tensor) -> torch.Tensor:
    """Insert one batch into ``table`` in place; -> spill mask [N] bool.

    ``prog`` is the plan's hash ``FoldProgram``, ``cols`` maps the scan
    columns to (values, validity or None) [N] tensors, ``params`` the
    parameter env names to host (value, valid) scalars, ``row_mask`` the
    bool [N] real rows.  CUDA tensors launch the generated kernel, CPU
    tensors run ``insert_plain``."""
    if row_mask.device.type == "cuda":
        spill = _launch(prog, table, cols, params, row_mask)
        count_launch(hash_agg_insert)
        return spill
    if row_mask.device.type != "cpu":
        raise ValueError(f"hash_agg_insert: no kernel for {row_mask.device}")
    return insert_plain(prog, table, cols, params, row_mask)


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


def insert_batched_plain(prog: FoldProgram, table, cols: dict,
                         masks: torch.Tensor) -> torch.Tensor:
    """The plain version of the generated batched insert: the keys and
    arguments once, then ``hash_agg_insert_batched_plain``."""
    _, keys, args = plain_insert_inputs(prog, cols, {}, masks[0],
                                        with_filter=False)
    return hash_agg_insert_batched_plain(table, masks, keys, args, prog.ops)


def _launch_batched(prog, table, cols, masks) -> torch.Tensor:
    n_q = masks.shape[0] if masks.dim() == 2 else 0
    if n_q <= 0:
        raise ValueError("hash_agg_insert_batched: masks must be [Q, N], "
                         "Q > 0")
    lib = insert_library(prog)
    dev = masks.device
    spill = torch.empty(masks.shape, dtype=torch.bool, device=dev)
    p = _block(prog, table, masks, spill, n_q)
    r = row_block(prog, cols, None, masks.shape[1], dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.hash_agg_insert_batched_launch(
            ctypes.byref(p), ctypes.byref(r), n_q, stream)
    if err != 0:
        raise RuntimeError(f"hash_agg_insert_batched launch failed: CUDA "
                           f"error {err}")
    return spill


def hash_agg_insert_batched(prog: FoldProgram, table, cols: dict,
                            masks: torch.Tensor) -> torch.Tensor:
    """Insert one batch into the Q tables of ``table`` (a ``HashTable``
    whose tensors are [Q, S]) at once, in place: table q takes the rows
    that pass ``masks[q]`` (bool [Q, N]: each query's WHERE, with the
    padding).  The program's keys and arguments reference no parameter:
    they are evaluated, canonicalized and fingerprinted once per row and
    shared by every query.  It is the reference's
    ``batched:jit_hash_fused`` (a ``jax.vmap`` of the fused hash worker
    over the query axis).  -> spill masks [Q, N].  CUDA tensors launch
    the generated batched kernel (one launch per call, counted in
    ``hash_agg_insert_batched.launches``), CPU tensors run
    ``insert_batched_plain``."""
    if masks.device.type == "cuda":
        spill = _launch_batched(prog, table, cols, masks)
        count_launch(hash_agg_insert_batched)
        return spill
    if masks.device.type != "cpu":
        raise ValueError(f"hash_agg_insert_batched: no kernel for "
                         f"{masks.device}")
    return insert_batched_plain(prog, table, cols, masks)


#: kernel launches since the counter was last set to 0
hash_agg_insert_batched.launches = 0
