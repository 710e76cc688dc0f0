"""The row mask of a filtered scan: a CUDA predicate kernel generated from
the bound tree (``ops/expr_codegen.py``) and its plain PyTorch version.

``filter_mask(prog, cols, params, row_mask)`` computes
``row_mask & predicate(env)`` for one batch, as the reference's
``jit_filter`` slot does for projection scans
(``citus_tpu/executor/executor.py:971-979 _build_filter``).  ``prog``
is the ``FilterProgram`` of one plan's predicate, ``cols`` maps the
predicate's column names to (values, validity or None) tensors,
``params`` the parameter env names to host (value, valid) scalars;
``row_mask`` None keeps every row (the batch's length then comes from
the columns, or ``n``).

On CUDA tensors it generates the predicate's source (once per program),
builds it with ``nvcc`` (once per source, ``cuda_build.load_generated``)
and launches it (one launch per call, counted in
``filter_mask.launches``), or raises; a predicate node the generator
does not know raises ``UnsupportedFeatureError``.  On CPU tensors it
runs ``filter_mask_plain``: ``compile_expr`` on the torch namespace and
``predicate_mask``.  There is no fallback between the two.

``filter_mask_batched(prog, cols, params, row_mask)`` is the same mask
for Q queries of one literal family at once, bool [Q, N] (the
reference's ``batched:jit_filter``, ``citus_tpu/executor/megabatch.py``
:518-527): ``params`` are the queries' parameters stacked on the device
(``stack_params``), and the generated source's batched kernel loads each
row's columns once and evaluates the predicate once per query.  Its
plain version runs ``filter_mask_plain`` once per query.
"""

from __future__ import annotations

import ctypes
import struct
from typing import Optional

import numpy as np
import torch

from citus_tpu_torch.ops.cuda_build import count_launch
from citus_tpu_torch.ops.expr_codegen import Predicate, generate_predicate
from citus_tpu_torch.planner.bound import (
    BColumn, compile_expr, predicate_mask, walk,
)

_MAX_COLS, _MAX_PARAMS, _MAX_TABLES = 64, 64, 16
#: a float64's bits as an int64 (a parameter's encoding)
_F64_BITS_IN, _F64_BITS = struct.Struct("<d"), struct.Struct("<q")


class FilterProgram:
    """One predicate over columns and parameters of known device dtypes:
    its generated kernel (built at the first CUDA launch) and its
    compiled plain version per device."""

    def __init__(self, expr, col_dtypes: dict, param_dtypes: dict):
        self.expr = expr
        self.columns = sorted({n.name for n in walk(expr)
                               if isinstance(n, BColumn)})
        self.col_dtypes = {c: np.dtype(col_dtypes[c]) for c in self.columns}
        self.param_dtypes = {k: np.dtype(v) for k, v in param_dtypes.items()}
        self._predicate: Optional[Predicate] = None
        self._lib = None
        self._plain: dict = {}
        self._tables: dict = {}
        self._blocks: dict = {}

    @property
    def predicate(self) -> Predicate:
        """The generated source (raises for an unsupported node)."""
        if self._predicate is None:
            self._predicate = generate_predicate(self.expr, self.col_dtypes,
                                                 self.param_dtypes)
        return self._predicate

    def library(self):
        if self._lib is None:
            from citus_tpu_torch.ops.cuda_build import load_generated
            lib = load_generated("filter_mask", self.predicate.source)
            lib.filter_mask_launch.restype = ctypes.c_int
            lib.filter_mask_launch.argtypes = [ctypes.POINTER(_FmParams),
                                               ctypes.c_void_p]
            lib.filter_mask_params_size.restype = ctypes.c_int
            lib.filter_mask_params_size.argtypes = []
            lib.filter_mask_batched_launch.restype = ctypes.c_int
            lib.filter_mask_batched_launch.argtypes = [
                ctypes.POINTER(_FmParams), ctypes.POINTER(_FmBatch),
                ctypes.c_void_p]
            lib.filter_mask_batch_size.restype = ctypes.c_int
            lib.filter_mask_batch_size.argtypes = []
            if lib.filter_mask_params_size() != ctypes.sizeof(_FmParams) \
                    or lib.filter_mask_batch_size() != ctypes.sizeof(_FmBatch):
                raise RuntimeError("filter_mask: parameter block layout "
                                   "differs between Python and CUDA")
            self._lib = lib
        return self._lib

    def tables(self, device) -> list:
        key = str(device)
        t = self._tables.get(key)
        if t is None:
            t = [torch.from_numpy(m).to(device)
                 for m in self.predicate.tables]
            self._tables[key] = t
        return t

    def block(self, device) -> tuple:
        """-> (the parameter block's bytes with this device's dictionary
        tables in it, the columns' names and torch dtypes and the
        parameters' names and dtypes, in slot order), built once per
        device: a launch copies the bytes and sets only what changes."""
        b = self._blocks.get(device)
        if b is None:
            from citus_tpu_torch.ops.xp_torch import torch_dtype
            p = _FmParams()
            for j, t in enumerate(self.tables(device)):
                p.tables[j] = t.data_ptr()
                p.table_len[j] = t.numel()
            b = (bytes(p), tuple((name, torch_dtype(self.col_dtypes[name]))
                                 for name in self.predicate.columns),
                 tuple((name, self.param_dtypes[name])
                       for name in self.predicate.params))
            self._blocks[device] = b
        return b

    def plain_fn(self, device):
        key = str(device)
        fn = self._plain.get(key)
        if fn is None:
            from citus_tpu_torch.ops.xp_torch import TorchNamespace
            xp = TorchNamespace(device)
            fn = (xp, compile_expr(self.expr, xp))
            self._plain[key] = fn
        return fn


def _batch_rows(cols: dict, row_mask, n) -> tuple:
    """-> (rows, device) of one batch: the row mask's, else ``n`` and the
    columns' device."""
    if row_mask is not None:
        return row_mask.shape[0], row_mask.device
    if not cols:
        raise ValueError("filter_mask: without a row mask the batch needs "
                         "a column")
    v = next(iter(cols.values()))[0]
    return (v.shape[0] if n is None else n), v.device


def filter_mask_plain(prog: FilterProgram, cols: dict, params: dict,
                      row_mask: Optional[torch.Tensor], n: int = None
                      ) -> torch.Tensor:
    """``row_mask & predicate`` in eager tensor ops on any device (row
    mask None: every row)."""
    n, dev = _batch_rows(cols, row_mask, n)
    if row_mask is None:
        row_mask = torch.ones(n, dtype=torch.bool, device=dev)
    xp, fn = prog.plain_fn(row_mask.device)
    env = {}
    for name, (v, valid) in cols.items():
        env[name] = (v, torch.ones(n, dtype=torch.bool, device=v.device)
                     if valid is None else valid)
    for name, (v, valid) in params.items():
        env[name] = (xp.asarray(np.asarray(v, prog.param_dtypes[name])),
                     xp.asarray(np.asarray(bool(valid))))
    return row_mask & predicate_mask(xp, fn, env, row_mask)


class _FmParams(ctypes.Structure):
    _fields_ = [("n", ctypes.c_int64), ("row_mask", ctypes.c_void_p),
                ("out", ctypes.c_void_p),
                ("cols", ctypes.c_void_p * _MAX_COLS),
                ("valids", ctypes.c_void_p * _MAX_COLS),
                ("tables", ctypes.c_void_p * _MAX_TABLES),
                ("table_len", ctypes.c_int64 * _MAX_TABLES),
                ("params", ctypes.c_int64 * _MAX_PARAMS),
                ("param_valid", ctypes.c_uint8 * _MAX_PARAMS)]


class _FmBatch(ctypes.Structure):
    _fields_ = [("n_q", ctypes.c_int64), ("n_params", ctypes.c_int64),
                ("params", ctypes.c_void_p), ("param_valid", ctypes.c_void_p),
                ("out", ctypes.c_void_p)]


def _param_bits(v, dt: np.dtype) -> int:
    if dt.kind == "f":
        return _F64_BITS.unpack(_F64_BITS_IN.pack(float(v)))[0]
    return int(v)


def _param_value(bits: int, dt: np.dtype):
    """The inverse of ``_param_bits``: a value of ``dt``."""
    b = np.asarray(bits, np.int64)
    if dt.kind == "f":
        return b.view(np.float64).astype(dt)
    return b.astype(dt)


def _block(prog: FilterProgram, cols: dict, row_mask, n: int, dev,
           out: torch.Tensor) -> "_FmParams":
    """The parameter block of one launch over ``cols`` (parameters
    left at 0): the program's block for ``dev`` with this batch's
    pointers, each column checked."""
    raw, slots, _ = prog.block(dev)
    p = _FmParams.from_buffer_copy(raw)
    p.n = n
    if row_mask is not None:
        if row_mask.dtype != torch.bool or row_mask.dim() != 1 \
                or not row_mask.is_contiguous():
            raise ValueError("filter_mask: row_mask must be a contiguous "
                             "bool vector")
        p.row_mask = row_mask.data_ptr()
    p.out = out.data_ptr()
    pc, pv = p.cols, p.valids
    di = out.get_device()
    for j, (name, want) in enumerate(slots):
        v, valid = cols[name]
        if v.dtype != want or v.get_device() != di or v.dim() != 1 \
                or v.shape[0] != n or not v.is_contiguous():
            raise ValueError(
                f"filter_mask: column {name!r} must be a contiguous [{n}] "
                f"{want} tensor on {dev}, got {v.dtype} {tuple(v.shape)} "
                f"on {v.device}")
        pc[j] = v.data_ptr()
        if valid is not None:
            if valid.dtype != torch.bool or valid.get_device() != di \
                    or valid.dim() != 1 or valid.shape[0] != n \
                    or not valid.is_contiguous():
                raise ValueError(f"filter_mask: validity of {name!r} must "
                                 f"be a contiguous [{n}] bool tensor on "
                                 f"{dev}")
            pv[j] = valid.data_ptr()
    return p


def _launch_on(dev, launch) -> int:
    """``launch(stream)`` with ``dev`` the current card (the C launch
    takes the current device's context) on PyTorch's current stream of
    ``dev``: -> its CUDA error."""
    if torch.cuda.current_device() != dev.index:
        with torch.cuda.device(dev):
            return _launch_on(dev, launch)
    return launch(torch._C._cuda_getCurrentRawStream(dev.index))


def _launch(prog: FilterProgram, cols: dict, params: dict, row_mask, n: int,
            dev) -> torch.Tensor:
    lib = prog.library()
    out = torch.empty(n, dtype=torch.bool, device=dev)
    p = _block(prog, cols, row_mask, n, dev, out)
    pp, pvl = p.params, p.param_valid
    for j, (name, dt) in enumerate(prog.block(dev)[2]):
        v, valid = params[name]
        pp[j] = _param_bits(v, dt)
        pvl[j] = 1 if valid else 0
    err = _launch_on(dev, lambda s: lib.filter_mask_launch(ctypes.byref(p),
                                                           s))
    if err != 0:
        raise RuntimeError(f"filter_mask launch failed: CUDA error {err}")
    return out


def filter_mask(prog: FilterProgram, cols: dict, params: dict,
                row_mask: Optional[torch.Tensor], n: int = None
                ) -> torch.Tensor:
    """-> bool [N] ``row_mask & predicate`` of one batch (row mask None:
    every one of the columns' N rows, or of ``n``).  CUDA tensors launch
    the generated kernel, CPU tensors run the plain version."""
    n, dev = _batch_rows(cols, row_mask, n)
    if dev.type == "cuda":
        out = _launch(prog, cols, params, row_mask, n, dev)
        count_launch(filter_mask)
        return out
    if dev.type != "cpu":
        raise ValueError(f"filter_mask: no kernel for {dev}")
    return filter_mask_plain(prog, cols, params, row_mask, n)


#: kernel launches since the counter was last set to 0
filter_mask.launches = 0


# --------------------------------------------------- Q queries at once


class StackedParams:
    """The parameters of Q queries of one predicate family, as the
    batched kernel reads them: ``bits`` int64 [Q, P] (integers
    sign-extended, floats as the bits of their float64 value) and
    ``valid`` uint8 [Q, P], column j holding parameter ``names[j]``, in
    the predicate's slot order."""

    def __init__(self, names: tuple, bits: torch.Tensor,
                 valid: torch.Tensor):
        self.names, self.bits, self.valid = names, bits, valid

    @property
    def n_queries(self) -> int:
        return int(self.bits.shape[0])


def stack_params(prog: FilterProgram, params: list, device) -> StackedParams:
    """``params``: one host parameter env (name -> (value, valid)) per
    query -> their ``StackedParams`` on ``device`` (one copy for the
    whole family, reused by every batch of its scan)."""
    names = prog.predicate.params
    q, n_p = len(params), max(1, len(names))
    bits = np.zeros((q, n_p), np.int64)
    valid = np.zeros((q, n_p), np.uint8)
    for qi, env in enumerate(params):
        for j, name in enumerate(names):
            v, ok = env[name]
            bits[qi, j] = _param_bits(v, prog.param_dtypes[name])
            valid[qi, j] = 1 if bool(ok) else 0
    return StackedParams(names, torch.from_numpy(bits).to(device),
                         torch.from_numpy(valid).to(device))


def filter_mask_batched_plain(prog: FilterProgram, cols: dict,
                              params: StackedParams,
                              row_mask: Optional[torch.Tensor]
                              ) -> torch.Tensor:
    """The same masks in eager tensor ops on any device: one
    ``filter_mask_plain`` per query, with its parameters decoded from
    the stacked bits.  -> bool [Q, N]."""
    bits = params.bits.cpu().numpy()
    valid = params.valid.cpu().numpy()
    outs = []
    for qi in range(params.n_queries):
        env = {name: (_param_value(bits[qi, j], prog.param_dtypes[name]),
                      bool(valid[qi, j]))
               for j, name in enumerate(params.names)}
        outs.append(filter_mask_plain(prog, cols, env, row_mask))
    return torch.stack(outs)


def _launch_batched(prog: FilterProgram, cols: dict, params: StackedParams,
                    row_mask, n: int, dev) -> torch.Tensor:
    q = params.n_queries
    if params.names != prog.predicate.params:
        raise ValueError("filter_mask_batched: parameters stacked for "
                         "another predicate")
    for t, dt in ((params.bits, torch.int64), (params.valid, torch.uint8)):
        if t.device != dev or t.dtype != dt or t.dim() != 2 \
                or t.shape[0] != q or not t.is_contiguous():
            raise ValueError(f"filter_mask_batched: stacked parameters must "
                             f"be contiguous [Q, P] {dt} tensors on {dev}")
    lib = prog.library()
    out = torch.empty((q, n), dtype=torch.bool, device=dev)
    p = _block(prog, cols, row_mask, n, dev, out)
    b = _FmBatch()
    b.n_q, b.n_params = q, params.bits.shape[1]
    b.params, b.param_valid = params.bits.data_ptr(), params.valid.data_ptr()
    b.out = out.data_ptr()
    err = _launch_on(dev, lambda s: lib.filter_mask_batched_launch(
        ctypes.byref(p), ctypes.byref(b), s))
    if err != 0:
        raise RuntimeError(f"filter_mask_batched launch failed: CUDA error "
                           f"{err}")
    return out


def filter_mask_batched(prog: FilterProgram, cols: dict,
                        params: StackedParams,
                        row_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """-> bool [Q, N]: row q is ``row_mask & predicate`` under query q's
    parameters, for Q queries of one family over one batch (the
    reference's ``batched:jit_filter``, a ``jax.vmap`` of the
    predicate over the stacked parameters).  CUDA tensors launch the
    generated batched kernel, which loads each row's columns once and
    evaluates the predicate once per query (one launch per call,
    counted in ``filter_mask_batched.launches``); CPU tensors run
    ``filter_mask_batched_plain``.  There is no fallback between the
    two.  A row mask of None keeps every row."""
    n, dev = _batch_rows(cols, row_mask, None)
    if dev.type == "cuda":
        out = _launch_batched(prog, cols, params, row_mask, n, dev)
        count_launch(filter_mask_batched)
        return out
    if dev.type != "cpu":
        raise ValueError(f"filter_mask_batched: no kernel for {dev}")
    return filter_mask_batched_plain(prog, cols, params, row_mask)


#: kernel launches since the counter was last set to 0
filter_mask_batched.launches = 0
