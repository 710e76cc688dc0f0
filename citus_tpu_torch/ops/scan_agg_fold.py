"""The partial-aggregate fold of one scan batch: the CUDA kernel
generated for each plan (``ops/expr_codegen.py generate_fold_row``,
instantiating ``csrc/scan_agg_fold.cu``) and its plain PyTorch version.

``scan_agg_fold(prog, acc, rows, cols, params, row_mask)`` evaluates a
plan's WHERE, group keys and aggregate arguments (a ``FoldProgram``)
over one batch's scan columns and folds the rows that pass into running
per-group registers, in place: ``acc[op][gid]`` for every partial op
and ``rows[gid]`` (direct mode).  It is the reference's fused worker
(``citus_tpu/ops/scan_agg.py``): the expressions, the group id,
validity, the cast to the accumulator type and count/sum/min/max, and
in scalar mode the sketch registers of approx_count_distinct (hll),
approx_percentile (ddsk) and approx_top_k (topk, topkv).

On CUDA tensors it launches the program's generated kernel (one launch
per call, counted in ``scan_agg_fold.launches``; parameters ride the
launch's parameter block) or raises; on CPU tensors it runs
``fold_plain``: the expressions as eager tensor code
(``compile_expr`` on the torch namespace) and ``scan_agg_fold_plain``.
There is no fallback between the two.

``scan_agg_fold_batched`` folds one batch for Q queries of one literal
family at once (``csrc/scan_agg_fold_batched.cu``): masks [Q, N] (each
query's WHERE, from ``filter_mask_batched``), registers [Q, G], the keys
and arguments evaluated once per row and shared.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from citus_tpu_torch.ops.cuda_build import count_launch
from citus_tpu_torch.ops.expr_codegen import (
    FoldExprs, FoldRow, fold_exprs, generate_fold_row,
)
from citus_tpu_torch.planner.bound import BColumn, walk

_MAX_KEYS, _MAX_ARGS, _MAX_OPS = 8, 32, 32
#: partial sums per group of a float sum in the plain version
_SUM_LANES = 1024

_DTYPE_CODES = {torch.bool: 0, torch.uint8: 0, torch.int32: 1,
                torch.int64: 2, torch.float32: 3, torch.float64: 4}
_KIND_CODES = {"count_star": 0, "count": 1, "sum": 2, "min": 3, "max": 4,
               "hll": 5, "ddsk": 6, "topk": 7, "topkv": 8}
#: registers per group of a sketch op (planner/aggregates.py HLL_M,
#: DDSK_M, TOPK_M); every other op has one
SKETCH_M = {"hll": 128, "ddsk": 2048, "topk": 1024, "topkv": 1024}
_ACC_DTYPES = {
    "count_star": (torch.int64,),
    "count": (torch.int64,),
    "sum": (torch.int64, torch.float64, torch.int32, torch.float32),
    "min": (torch.int32, torch.int64, torch.float32, torch.float64),
    "max": (torch.int32, torch.int64, torch.float32, torch.float64),
    "hll": (torch.int32,),
    "ddsk": (torch.int64,),
    "topk": (torch.int64,),
    "topkv": (torch.int64,),
}


@dataclass(frozen=True)
class FoldOp:
    """One partial op: ``kind`` in count_star/count/sum/min/max or a
    sketch kind (hll/ddsk/topk/topkv), ``arg`` the index of its argument
    column (-1 for count_star)."""
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
        if op.kind in SKETCH_M:
            _fold_sketch_plain(a.view(-1), gid * SKETCH_M[op.kind], ok,
                               _full(v, n), op.kind)
        elif op.kind == "count":
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


def _fold_sketch_plain(flat: torch.Tensor, base: torch.Tensor,
                       ok: torch.Tensor, v: torch.Tensor, kind: str) -> None:
    """Fold the ``ok`` rows of one sketch op into ``flat`` (its [G * M]
    registers); ``base`` is each row's group offset g * M."""
    from citus_tpu_torch.ops import sketch_buckets as sb
    if kind == "hll":
        bucket, rho = sb.hll_rho_buckets(sb.value_bits(v), ok)
        flat.scatter_reduce_(0, base + bucket, rho, "amax", include_self=True)
    elif kind == "ddsk":
        flat.index_add_(0, base + sb.ddsk_bucket_indexes(v),
                        ok.to(torch.int64))
    elif kind == "topk":
        flat.index_add_(0, base + sb.topk_buckets(v.to(torch.int64)),
                        ok.to(torch.int64))
    else:  # topkv: the largest value seen per bucket
        v64 = v.to(torch.int64)
        flat.scatter_reduce_(0, base + sb.topk_buckets(v64),
                             torch.where(ok, v64, torch.iinfo(torch.int64).min),
                             "amax", include_self=True)


# ------------------------------------------------------------- program


#: partial-op kinds the device fold computes: count/sum/min/max and, in
#: scalar mode, the sketch registers of approx_count_distinct (hll),
#: approx_percentile (ddsk) and approx_top_k (topk, topkv).  A GROUP BY
#: with a sketch plans to hash_host and groups on the host, as in the
#: reference (executor._hash_has_exact).
DEVICE_KINDS = ("count", "sum", "min", "max", "hll", "ddsk", "topk", "topkv")


class FoldProgram:
    """A plan's per-row work in one fold or hash insert: its WHERE, group
    keys and used aggregate arguments (``exprs``), over columns and
    parameters of known device dtypes, with its partial ops (argument
    slots), direct-mode key domains (lo, step, stride) and group count,
    or the table's ``key_dtypes`` for a hash insert.  Its generated
    source and library are made at the first CUDA launch (one build per
    source: a literal family shares it), its plain version per device."""

    def __init__(self, exprs: FoldExprs, ops, col_dtypes: dict,
                 param_dtypes: dict, *, domains=(), n_groups: int = 1,
                 key_dtypes=None):
        self.exprs = exprs
        self.ops = list(ops)
        self.domains = list(domains)
        self.n_groups = int(n_groups)
        self.key_dtypes = None if key_dtypes is None \
            else tuple(np.dtype(d) for d in key_dtypes)
        used = {n.name for e in (exprs.filter, *exprs.keys, *exprs.args)
                if e is not None for n in walk(e) if isinstance(n, BColumn)}
        self.columns = sorted(used)
        self.col_dtypes = {c: np.dtype(col_dtypes[c]) for c in self.columns}
        self.param_dtypes = {k: np.dtype(v) for k, v in param_dtypes.items()}
        if self.key_dtypes is None and len(self.domains) != len(exprs.keys):
            raise ValueError("a fold needs one (lo, step, stride) domain per "
                             "group key")
        self._row = None
        self._lib = None
        self._plain: dict = {}
        self._tables: dict = {}

    @classmethod
    def of_plan(cls, plan, param_dtypes: dict, key_dtypes=None
                ) -> "FoldProgram":
        """The program of a physical plan: its fold (scalar and direct
        modes) or, with ``key_dtypes``, its hash insert."""
        exprs, slots = fold_exprs(plan)
        ops = [FoldOp("count_star") if j < 0 else FoldOp(op.kind, j)
               for op, j in zip(plan.partial_ops, slots)]
        schema = plan.bound.table.schema
        col_dtypes = {c: schema.scan_dtype(c, device=True)
                      for c in plan.scan_columns}
        if key_dtypes is not None:
            return cls(exprs, ops, col_dtypes, param_dtypes,
                       key_dtypes=key_dtypes)
        mode = plan.group_mode
        if mode.kind not in ("scalar", "direct"):
            raise ValueError("the device fold needs device-combinable "
                             "partials (scalar/direct group modes)")
        other = sorted({op.kind for op in plan.partial_ops
                        if op.kind not in DEVICE_KINDS})
        if other:
            raise ValueError(f"the device fold has no partial op kind "
                             f"{', '.join(other)}")
        if mode.kind == "scalar":
            return cls(exprs, ops, col_dtypes, param_dtypes)
        return cls(exprs, ops, col_dtypes, param_dtypes,
                   domains=[(d.lo, d.step, s) for d, s in
                            zip(mode.domains, mode.strides)],
                   n_groups=mode.n_groups)

    @property
    def hashed(self) -> bool:
        return self.key_dtypes is not None

    @property
    def row(self) -> FoldRow:
        """The generated source (raises for an unsupported node)."""
        if self._row is None:
            self._row = generate_fold_row(self.exprs, self.col_dtypes,
                                          self.param_dtypes, self.key_dtypes)
        return self._row

    def library(self, name: str, bind):
        """The loaded library of the generated source, built at first use
        as ``name`` (``cuda_build.load_generated``) and declared by
        ``bind``: the fold's and the insert's wrappers pass their own
        (``fold_library``, ``hash_agg_insert.insert_library``)."""
        if self._lib is None:
            from citus_tpu_torch.ops.cuda_build import load_generated
            self._lib = bind(load_generated(name, self.row.source))
        return self._lib

    def tables(self, device) -> list:
        key = str(device)
        t = self._tables.get(key)
        if t is None:
            t = [torch.from_numpy(m).to(device) for m in self.row.tables]
            self._tables[key] = t
        return t

    def plain_fns(self, device):
        """-> (torch namespace, filter, key and argument functions) of
        the plain version on ``device``."""
        key = str(device)
        fns = self._plain.get(key)
        if fns is None:
            from citus_tpu_torch.ops.xp_torch import TorchNamespace
            from citus_tpu_torch.planner.bound import compile_expr
            xp = TorchNamespace(device)
            e = self.exprs
            fns = (xp, None if e.filter is None else compile_expr(e.filter, xp),
                   [compile_expr(k, xp) for k in e.keys],
                   [compile_expr(a, xp) for a in e.args])
            self._plain[key] = fns
        return fns

    def plain_eval(self, cols: dict, params: dict, row_mask: torch.Tensor,
                   with_filter: bool = True):
        """The plain version's expressions over one batch, in eager tensor
        ops: -> (row_mask & WHERE, [(key values, validity)], [(argument
        values, validity)]) as ``compile_expr`` gives them."""
        from citus_tpu_torch.planner.bound import predicate_mask
        xp, ffn, kfns, afns = self.plain_fns(row_mask.device)
        n = row_mask.shape[-1]
        env = {}
        for name in self.columns:
            v, valid = cols[name]
            env[name] = (v, torch.ones(n, dtype=torch.bool, device=v.device)
                         if valid is None else valid)
        for name, (v, valid) in (params or {}).items():
            env[name] = (xp.asarray(np.asarray(v, self.param_dtypes[name])),
                         xp.asarray(np.asarray(bool(valid))))
        mask = row_mask
        if with_filter and ffn is not None:
            mask = row_mask & predicate_mask(xp, ffn, env, row_mask)
        return mask, [f(env) for f in kfns], [f(env) for f in afns]


def _vec(v) -> torch.Tensor:
    """A plain-version input vector: contiguous [N], or [1] for a
    constant."""
    v = torch.as_tensor(v)
    return (v.reshape(1) if v.dim() == 0 else v).contiguous()


def _validity(valid, device) -> Optional[torch.Tensor]:
    """A plain-version validity input: None when every row is valid."""
    if valid is True:
        return None
    if valid is False:
        return torch.zeros(1, dtype=torch.bool, device=device)
    return _vec(valid)


def plain_fold_inputs(prog: FoldProgram, cols: dict, params: dict,
                      row_mask: torch.Tensor, with_filter: bool = True):
    """-> (mask, keys, args) of ``scan_agg_fold_plain`` for one batch:
    the program's expressions in eager tensor ops."""
    mask, keys, args = prog.plain_eval(cols, params, row_mask, with_filter)
    dev = row_mask.device
    fkeys = [FoldKey(_vec(kv), _validity(kvalid, dev), lo, step, stride)
             for (kv, kvalid), (lo, step, stride) in zip(keys, prog.domains)]
    return mask, fkeys, [(_vec(v), _validity(k, dev)) for v, k in args]


def fold_plain(prog: FoldProgram, acc: Sequence[torch.Tensor],
               rows: Optional[torch.Tensor], cols: dict, params: dict,
               row_mask: torch.Tensor) -> None:
    """The plain version of the generated fold, on any device: the
    expressions as eager tensor code, then ``scan_agg_fold_plain``."""
    mask, keys, args = plain_fold_inputs(prog, cols, params, row_mask)
    scan_agg_fold_plain(acc, rows, mask.contiguous(), keys, args, prog.ops,
                        prog.n_groups)


def fold_batched_plain(prog: FoldProgram, acc: Sequence[torch.Tensor],
                       rows: Optional[torch.Tensor], cols: dict,
                       masks: torch.Tensor) -> None:
    """The plain version of the generated batched fold: the keys and
    arguments once, then ``scan_agg_fold_batched_plain``."""
    _, keys, args = plain_fold_inputs(prog, cols, {}, masks[0],
                                      with_filter=False)
    scan_agg_fold_batched_plain(acc, rows, masks, keys, args, prog.ops,
                                prog.n_groups)


# ------------------------------------------------------------- kernel


class _Params(ctypes.Structure):
    _fields_ = [("n", ctypes.c_int64), ("n_groups", ctypes.c_int64),
                ("mask", ctypes.c_void_p),
                ("n_keys", ctypes.c_int32), ("n_args", ctypes.c_int32),
                ("n_ops", ctypes.c_int32), ("pad", ctypes.c_int32),
                ("key_lo", ctypes.c_int64 * _MAX_KEYS),
                ("key_step", ctypes.c_int64 * _MAX_KEYS),
                ("key_stride", ctypes.c_int64 * _MAX_KEYS),
                ("op_kind", ctypes.c_int32 * _MAX_OPS),
                ("op_arg", ctypes.c_int32 * _MAX_OPS),
                ("op_dtype", ctypes.c_int32 * _MAX_OPS),
                ("op_m", ctypes.c_int32 * _MAX_OPS),
                ("op_soff", ctypes.c_int64 * (_MAX_OPS + 1)),
                ("acc", ctypes.c_void_p * _MAX_OPS),
                ("rows", ctypes.c_void_p)]


def _bind_fold_library(lib):
    """Declare a generated fold library's entry points and check its
    parameter blocks' layouts."""
    from citus_tpu_torch.ops.filter_mask import _FmParams
    P, R = ctypes.POINTER(_Params), ctypes.POINTER(_FmParams)
    lib.scan_agg_fold_launch.restype = ctypes.c_int
    lib.scan_agg_fold_launch.argtypes = [P, R, ctypes.c_void_p,
                                         ctypes.POINTER(ctypes.c_int)]
    lib.scan_agg_fold_batched_launch.restype = ctypes.c_int
    lib.scan_agg_fold_batched_launch.argtypes = [
        P, R, ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    for fn in (lib.scan_agg_fold_params_size, lib.fold_row_params_size):
        fn.restype = ctypes.c_int
        fn.argtypes = []
    if lib.scan_agg_fold_params_size() != ctypes.sizeof(_Params) \
            or lib.fold_row_params_size() != ctypes.sizeof(_FmParams):
        raise RuntimeError("scan_agg_fold: parameter block layout "
                           "differs between Python and CUDA")
    return lib


#: the build name of a generated fold's source (not a ``csrc`` name: the
#: source includes ``csrc/scan_agg_fold.cu``)
FOLD_BUILD = "generated_fold"


def fold_library(prog: FoldProgram):
    """The generated fold library of ``prog``, built at first use."""
    return prog.library(FOLD_BUILD, _bind_fold_library)


def row_block(prog: FoldProgram, cols: dict, params: Optional[dict], n: int,
              dev):
    """The generated row's parameter block (``FmParams``) over one
    batch's columns, the program's dictionary tables and, unless None,
    one query's host parameters."""
    from citus_tpu_torch.ops.filter_mask import _FmParams, _param_bits
    from citus_tpu_torch.ops.xp_torch import torch_dtype
    row = prog.row
    r = _FmParams()
    r.n = n
    for j, name in enumerate(row.columns):
        v, valid = cols[name]
        want = torch_dtype(prog.col_dtypes[name])
        if v.device != dev or v.dtype != want or v.shape != (n,) \
                or not v.is_contiguous():
            raise ValueError(
                f"fold: column {name!r} must be a contiguous [{n}] {want} "
                f"tensor on {dev}, got {v.dtype} {tuple(v.shape)} on "
                f"{v.device}")
        r.cols[j] = v.data_ptr()
        if valid is not None:
            if valid.device != dev or valid.dtype != torch.bool \
                    or valid.shape != (n,) or not valid.is_contiguous():
                raise ValueError(f"fold: validity of {name!r} must be a "
                                 f"contiguous [{n}] bool tensor on {dev}")
            r.valids[j] = valid.data_ptr()
    for j, t in enumerate(prog.tables(dev)):
        r.tables[j] = t.data_ptr()
        r.table_len[j] = t.numel()
    if params is not None:
        for j, name in enumerate(row.params):
            v, valid = params[name]
            r.params[j] = _param_bits(v, prog.param_dtypes[name])
            r.param_valid[j] = 1 if bool(valid) else 0
    return r


def _reg_shape(kind: str, n_groups: int, n_q) -> tuple:
    """An op's register shape: [G] (one query) or [n_q, G] (``n_q``
    queries); a sketch op's are [M], [G, M], [n_q, M] or [n_q, G, M]."""
    shape = () if n_q is None else (n_q,)
    if kind not in SKETCH_M:
        return shape + (n_groups,)
    return shape + (() if n_groups == 1 else (n_groups,)) + (SKETCH_M[kind],)


def _block(prog: FoldProgram, acc, rows, mask, n_q=None) -> _Params:
    """The fold's parameter block of one launch; registers as
    ``_reg_shape``, ``mask`` [N] (one query) or [n_q, N] (``n_q``
    queries)."""
    dev = mask.device
    n = mask.shape[-1]
    ops, n_groups = prog.ops, prog.n_groups
    n_keys, n_args = len(prog.exprs.keys), len(prog.exprs.args)
    want_dim = 1 if n_q is None else 2
    if mask.dtype != torch.bool or mask.dim() != want_dim \
            or (n_q is not None and mask.shape[0] != n_q) \
            or not mask.is_contiguous():
        raise ValueError("scan_agg_fold: mask must be a contiguous bool "
                         + ("vector" if n_q is None else f"[{n_q}, N] tensor"))
    if n_keys > _MAX_KEYS or n_args > _MAX_ARGS or len(ops) > _MAX_OPS:
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
    p.n_keys, p.n_args, p.n_ops = n_keys, n_args, len(ops)
    for i, (lo, step, stride) in enumerate(prog.domains):
        if step <= 0:
            raise ValueError(f"scan_agg_fold: key {i} step must be > 0")
        p.key_lo[i], p.key_step[i], p.key_stride[i] = lo, step, stride
    for i, (a, op) in enumerate(zip(acc, ops)):
        if op.kind not in _KIND_CODES:
            raise ValueError(f"scan_agg_fold: unknown op kind {op.kind!r}")
        want = _reg_shape(op.kind, n_groups, n_q)
        if a.device != dev or a.dtype not in _ACC_DTYPES[op.kind] \
                or a.shape != want or not a.is_contiguous():
            raise ValueError(
                f"scan_agg_fold: accumulator {i} ({op.kind}) must be a "
                f"contiguous {list(want)} tensor of "
                f"{_ACC_DTYPES[op.kind]} on {dev}, got {a.dtype} "
                f"{tuple(a.shape)} on {a.device}")
        if op.kind != "count_star" and not 0 <= op.arg < n_args:
            raise ValueError(f"scan_agg_fold: op {i} argument out of range")
        p.op_kind[i] = _KIND_CODES[op.kind]
        p.op_arg[i] = max(op.arg, 0)
        p.op_dtype[i] = _DTYPE_CODES[a.dtype]
        p.op_m[i] = SKETCH_M.get(op.kind, 1)
        p.acc[i] = a.data_ptr()
    if rows is not None:
        if rows.device != dev or rows.dtype != torch.int64 \
                or rows.shape != reg_shape or not rows.is_contiguous():
            raise ValueError("scan_agg_fold: rows must be a contiguous "
                             f"{list(reg_shape)} int64 tensor on {dev}")
        p.rows = rows.data_ptr()
    return p


def _launch(prog, acc, rows, cols, params, row_mask) -> int:
    lib = fold_library(prog)
    dev = row_mask.device
    p = _block(prog, acc, rows, row_mask)
    r = row_block(prog, cols, params, row_mask.shape[0], dev)
    regime = ctypes.c_int(-1)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.scan_agg_fold_launch(ctypes.byref(p), ctypes.byref(r),
                                       stream, ctypes.byref(regime))
    if err != 0:
        raise RuntimeError(f"scan_agg_fold launch failed: CUDA error {err}")
    return regime.value


def scan_agg_fold(prog: FoldProgram, acc: Sequence[torch.Tensor],
                  rows: Optional[torch.Tensor], cols: dict, params: dict,
                  row_mask: torch.Tensor) -> None:
    """Fold one batch into ``acc``/``rows`` in place.

    ``prog`` is the plan's ``FoldProgram``; ``acc[i]`` is op ``i``'s [G]
    register of its accumulator type, ``rows`` the [G] int64 group-row
    counts (None in scalar mode, G=1), a sketch op's registers [M]
    (scalar mode; [G, M] for G > 1); ``cols`` maps the scan columns to
    (values, validity or None) [N] tensors, ``params`` the parameter env
    names to host (value, valid) scalars; ``row_mask`` the bool [N] real
    (non-padding) rows.  CUDA tensors launch the generated kernel, CPU
    tensors run ``fold_plain``."""
    if row_mask.device.type == "cuda":
        scan_agg_fold.last_regime = _launch(prog, acc, rows, cols, params,
                                            row_mask)
        count_launch(scan_agg_fold)
        return
    if row_mask.device.type != "cpu":
        raise ValueError(f"scan_agg_fold: no kernel for {row_mask.device}")
    fold_plain(prog, acc, rows, cols, params, row_mask)


#: kernel launches since the counter was last set to 0
scan_agg_fold.launches = 0
#: the last launch's regime: n >= 1 = the shared-memory group table in n
#: query chunks (1: one table for every query), 0 = global atomics
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


def _launch_batched(prog, acc, rows, cols, masks) -> int:
    n_q = masks.shape[0] if masks.dim() == 2 else 0
    if n_q <= 0:
        raise ValueError("scan_agg_fold_batched: masks must be [Q, N], Q > 0")
    lib = fold_library(prog)
    dev = masks.device
    p = _block(prog, acc, rows, masks, n_q)
    r = row_block(prog, cols, None, masks.shape[1], dev)
    regime = ctypes.c_int(-1)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.scan_agg_fold_batched_launch(
            ctypes.byref(p), ctypes.byref(r), n_q, stream,
            ctypes.byref(regime))
    if err != 0:
        raise RuntimeError(f"scan_agg_fold_batched launch failed: CUDA "
                           f"error {err}")
    return regime.value


def scan_agg_fold_batched(prog: FoldProgram, acc: Sequence[torch.Tensor],
                          rows: Optional[torch.Tensor], cols: dict,
                          masks: torch.Tensor) -> None:
    """Fold one batch into the registers of Q queries at once, in place:
    row q of every register (``acc[i]`` [Q, G], a sketch op's [Q, M] in
    scalar mode, ``rows`` [Q, G] or None in scalar mode, G = 1) takes the
    rows that pass ``masks[q]`` (bool [Q, N]: each query's WHERE, with
    the padding).  The program's keys and arguments reference no
    parameter: they are evaluated once per row for every query.  It is
    the reference's ``batched:jit_fused`` (a ``jax.vmap`` of the fused
    worker over the query axis).  CUDA tensors launch the generated
    batched kernel (one launch per call, counted in
    ``scan_agg_fold_batched.launches``), CPU tensors run
    ``fold_batched_plain``."""
    if masks.device.type == "cuda":
        scan_agg_fold_batched.last_regime = _launch_batched(
            prog, acc, rows, cols, masks)
        count_launch(scan_agg_fold_batched)
        return
    if masks.device.type != "cpu":
        raise ValueError(f"scan_agg_fold_batched: no kernel for "
                         f"{masks.device}")
    fold_batched_plain(prog, acc, rows, cols, masks)


#: kernel launches since the counter was last set to 0
scan_agg_fold_batched.launches = 0
#: the last launch's regime: n >= 1 = the shared-memory group table in n
#: query chunks (1: one table for every query), 0 = global atomics
scan_agg_fold_batched.last_regime = -1
