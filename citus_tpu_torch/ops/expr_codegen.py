"""CUDA C++ source from a bound expression tree (ROADMAP.md B10).

``generate_predicate(expr, col_dtypes, param_dtypes)`` turns a bound
predicate (``planner/bound.py``) into the source of a predicate kernel:
a ``__host__ __device__`` function ``fm_eval(p, r, prm, pvl)`` that
evaluates every node of the tree as a (value, valid) pair over the
loaded columns ``r`` of one row and one query's parameters, with the
semantics of the reference's ``compile_expr``/``predicate_mask`` under
JAX; ``fm_predicate(p, i)`` for one query and ``fm_batched_row`` for Q
queries of one family (the columns loaded once); and, under
``__CUDACC__``, the kernels that write ``out[i] = row_mask[i] &&
fm_predicate(p, i)`` and ``out[q, i]`` for every query q, with their C
launchers.
``csrc/expr.cuh`` holds the helpers and the parameter block.

Semantics kept from the reference:
- SQL three-valued logic: ``and``/``or`` exactly as ``run_logic``, NULL
  is false at the filter boundary (``predicate_mask``);
- arithmetic and comparisons in the promoted type of the two operands
  (JAX's rules with 64-bit types: bool < int < float, the wider of two
  ints or two floats, an int with a float takes the float), then the
  cast to the node's device dtype; integer ``+ - *`` wrap;
- ``/`` and ``%`` give NULL for a zero divisor; integer ``/`` truncates
  toward zero (``_trunc_div``);
- float-to-integer casts saturate, NaN -> 0, as XLA's do.

Parameters (``$N`` and the literals ``planner/auto_param.py`` hoists)
are kernel arguments, not constants of the source, so one build serves a
whole literal family; column and parameter dtypes are part of the
source, and so of its build key.  A node the generator does not know
raises ``UnsupportedFeatureError`` naming ROADMAP.md B10: the predicate
never falls back to eager tensor code on the card.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from citus_tpu_torch.errors import UnsupportedFeatureError
from citus_tpu_torch.planner.bound import (
    BBinOp, BCast, BColumn, BDictMask, BIsNull, BLiteral, BParam, BScale,
    BUnOp,
)

_BOOL, _I32, _I64 = np.dtype(bool), np.dtype(np.int32), np.dtype(np.int64)
_F32, _F64 = np.dtype(np.float32), np.dtype(np.float64)
_C_TYPES = {_BOOL: "bool", _I32: "int32_t", _I64: "int64_t",
            _F32: "float", _F64: "double"}
_CMP = {"=": "==", "<>": "!=", "<": "<", "<=": "<=", ">": ">", ">=": ">="}
_ARITH = {"+": "add", "-": "sub", "*": "mul"}


@dataclass(frozen=True)
class Predicate:
    """Generated source of one predicate and the inputs it reads, in the
    order of the parameter block's slots."""
    source: str
    columns: tuple       # column names -> FmParams.cols / valids
    params: tuple        # parameter env names -> FmParams.params
    tables: tuple        # dictionary-mask tables (bool tuples)


def _unsupported(what: str):
    raise UnsupportedFeatureError(
        f"{what} in a predicate has no CUDA code generator yet "
        "(ROADMAP.md B10)")


def _dtype(dt) -> np.dtype:
    dt = np.dtype(dt)
    if dt not in _C_TYPES:
        _unsupported(f"values of dtype {dt}")
    return dt


def promote(a: np.dtype, b: np.dtype) -> np.dtype:
    """JAX's (and PyTorch's) result type of two operands."""
    if a == b:
        return a
    if a == _BOOL:
        return b
    if b == _BOOL:
        return a
    fa, fb = a.kind == "f", b.kind == "f"
    if fa and fb:
        return _F64
    if fa:
        return a
    if fb:
        return b
    return _I64


def _bits_literal(value, dt: np.dtype) -> str:
    """An exact C literal of ``dt.type(value)``."""
    v = np.asarray(value, dtype=dt)
    if dt == _BOOL:
        return "true" if bool(v) else "false"
    if dt == _F64:
        return f"fm_f64(0x{int(v.view(np.uint64)):016x}ull)"
    if dt == _F32:
        return f"fm_f32(0x{int(v.view(np.uint32)):08x}u)"
    return f"(({_C_TYPES[dt]})0x{int(v.astype(np.int64).view(np.uint64)):016x}ull)"


def cast(expr: str, src: np.dtype, dst: np.dtype) -> str:
    """C expression of ``expr`` (of dtype ``src``) cast as numpy's
    ``.astype(dst)`` is on the card."""
    if src == dst:
        return expr
    if dst == _BOOL:
        return f"(({expr}) != 0)"
    if src.kind == "f" and dst.kind == "i":
        return f"fm_f2i{dst.itemsize * 8}((double)({expr}))"
    return f"(({_C_TYPES[dst]})({expr}))"


class _Gen:
    def __init__(self, col_dtypes: dict, param_dtypes: dict):
        self.col_dtypes = col_dtypes
        self.param_dtypes = param_dtypes
        self.lines: list[str] = []
        self.columns: list[str] = []
        self.column_types: list[np.dtype] = []
        self.params: list[str] = []
        self.tables: list[tuple] = []
        self.n = 0

    def tmp(self, ctype: str, expr: str) -> str:
        name = f"t{self.n}"
        self.n += 1
        self.lines.append(f"    const {ctype} {name} = {expr};")
        return name

    def value(self, dt: np.dtype, expr: str) -> str:
        return self.tmp(_C_TYPES[dt], expr)

    def valid(self, expr: str) -> str:
        if expr in ("true", "false"):
            return expr
        return self.tmp("bool", expr)

    # -- validity algebra on C expressions ("true"/"false" constants fold)
    @staticmethod
    def both(a: str, b: str) -> str:
        if a == "false" or b == "false":
            return "false"
        if a == "true":
            return b
        if b == "true":
            return a
        return f"({a} && {b})"

    def arith(self, op: str, a: str, b: str, ct: np.dtype) -> str:
        """Wrapping ``a op b`` in ``ct`` (both already of type ``ct``)."""
        if ct.kind == "f":
            return f"({a} {op} {b})"
        if ct == _BOOL:
            _unsupported(f"arithmetic '{op}' on booleans")
        return f"fm_{_ARITH[op]}{ct.itemsize * 8}({a}, {b})"

    def trunc_div(self, a, adt, b, bdt, ct) -> str:
        """The reference's ``_trunc_div``: sign(a) * sign(b) *
        (|a| // |where(b == 0, 1, b)|), each step in its numpy type."""
        for dt in (adt, bdt):
            if dt.kind != "i":
                _unsupported(f"truncating division of {dt} values")
        w = {_I32: 32, _I64: 64}
        sign = self.arith("*", cast(f"fm_sign{w[adt]}({a})", adt, ct),
                          cast(f"fm_sign{w[bdt]}({b})", bdt, ct), ct)
        b1 = f"({b} == 0 ? ({_C_TYPES[bdt]})1 : {b})"
        q = (f"fm_floordiv{w[ct]}({cast(f'fm_abs{w[adt]}({a})', adt, ct)}, "
             f"{cast(f'fm_abs{w[bdt]}({b1})', bdt, ct)})")
        return self.arith("*", sign, q, ct)

    # -- nodes -> (value name or constant, valid name or constant, dtype)
    def gen(self, e):
        if isinstance(e, BColumn):
            dt = _dtype(self.col_dtypes[e.name])
            if e.name not in self.columns:
                self.columns.append(e.name)
                self.column_types.append(dt)
            j = self.columns.index(e.name)
            return f"r.c{j}", f"r.v{j}", dt
        if isinstance(e, BParam):
            name = e.env_name
            dt = _dtype(self.param_dtypes[name])
            if name not in self.params:
                self.params.append(name)
            j = self.params.index(name)
            raw = (f"fm_f64((uint64_t)prm[{j}])" if dt.kind == "f"
                   else f"prm[{j}]")
            src = _F64 if dt.kind == "f" else _I64
            v = self.value(dt, cast(raw, src, dt))
            return v, self.valid(f"(pvl[{j}] != 0)"), dt
        if isinstance(e, BLiteral):
            dt = _dtype(e.type.device_dtype)
            if e.value is None:
                return _bits_literal(0, dt), "false", dt
            return _bits_literal(e.value, dt), "true", dt
        if isinstance(e, BBinOp):
            return self.binop(e)
        if isinstance(e, BUnOp):
            v, k, dt = self.gen(e.operand)
            if e.op == "-":
                if dt.kind == "f":
                    return self.value(dt, f"(-{v})"), k, dt
                if dt == _BOOL:
                    _unsupported("negation of a boolean")
                return self.value(dt, f"fm_neg{dt.itemsize * 8}({v})"), k, dt
            if e.op == "not":
                expr = f"(!{v})" if dt == _BOOL else f"({v} == 0)"
                return self.value(_BOOL, expr), k, _BOOL
            _unsupported(f"unary operator {e.op!r}")
        if isinstance(e, BScale):
            v, k, dt = self.gen(e.operand)
            fdt = _dtype(e.type.device_dtype)
            ct = promote(dt, fdt)
            factor = cast(_bits_literal(10 ** e.power, fdt), fdt, ct)
            return self.value(ct, self.arith("*", cast(v, dt, ct), factor,
                                             ct)), k, ct
        if isinstance(e, BCast):
            return self.cast_node(e)
        if isinstance(e, BIsNull):
            _, k, _ = self.gen(e.operand)
            if k in ("true", "false"):
                out = (k == "true") == e.negated
                return ("true" if out else "false"), "true", _BOOL
            return self.value(_BOOL, k if e.negated else f"(!{k})"), \
                "true", _BOOL
        if isinstance(e, BDictMask):
            v, k, dt = self.gen(e.operand)
            if dt.kind != "i":
                _unsupported(f"dictionary ids of dtype {dt}")
            n = len(e.mask)
            if n == 0:
                return "false", k, _BOOL
            j = len(self.tables)
            self.tables.append(tuple(bool(b) for b in e.mask))
            safe = f"({v} < 0 ? 0 : ({v} > {n - 1} ? {n - 1} : {v}))"
            return self.value(_BOOL, f"(p.tables[{j}][{safe}] != 0)"), k, _BOOL
        _unsupported(type(e).__name__)

    def binop(self, e: BBinOp):
        lv, lk, ldt = self.gen(e.left)
        rv, rk, rdt = self.gen(e.right)
        op = e.op
        if op in ("and", "or"):
            lb = lv if ldt == _BOOL else f"({lv} != 0)"
            rb = rv if rdt == _BOOL else f"({rv} != 0)"
            if op == "and":
                value = f"({lb} && {rb})"
                valid = (f"(({lk} && {rk}) || ({lk} && !{lb}) "
                         f"|| ({rk} && !{rb}))")
            else:
                value = f"({lb} || {rb})"
                valid = (f"(({lk} && {rk}) || ({lk} && {lb}) "
                         f"|| ({rk} && {rb}))")
            return self.value(_BOOL, value), self.valid(valid), _BOOL
        ct = promote(ldt, rdt)
        a, b = cast(lv, ldt, ct), cast(rv, rdt, ct)
        valid = self.both(lk, rk)
        if op in _CMP:
            return self.value(_BOOL, f"({a} {_CMP[op]} {b})"), \
                self.valid(valid), _BOOL
        dt = _dtype(e.type.device_dtype)
        if op in _ARITH:
            return self.value(dt, cast(self.arith(op, a, b, ct), ct, dt)), \
                self.valid(valid), dt
        if op not in ("/", "%"):
            _unsupported(f"operator {op!r}")
        valid = self.valid(self.both(valid, f"!({rv} == 0)"))
        if op == "/" and e.type.is_float:
            # truediv(a, where(b == 0, 1, b)): integers divide in float64
            b1 = f"({rv} == 0 ? {cast('1', _I64, rdt)} : {rv})"
            qt = ct if ct.kind == "f" else _F64
            q = f"({cast(lv, ldt, qt)} / {cast(b1, rdt, qt)})"
            return self.value(dt, cast(q, qt, dt)), valid, dt
        q = self.trunc_div(lv, ldt, rv, rdt, ct)
        if op == "%":
            q = self.arith("-", a, self.arith("*", q, b, ct), ct)
        return self.value(dt, cast(q, ct, dt)), valid, dt

    def cast_node(self, e: BCast):
        v, k, sdt = self.gen(e.operand)
        src, dst = e.operand.type, e.type
        dt = _dtype(dst.device_dtype)
        if src.is_decimal and dst.is_decimal:
            diff = dst.scale - src.scale
            if diff >= 0:
                out = self.arith("*", cast(v, sdt, dt),
                                 _bits_literal(10 ** diff, dt), dt)
                return self.value(dt, out), k, dt
            f = _bits_literal(10 ** (-diff), dt)
            ct = promote(sdt, dt)
            return self.value(dt, cast(self.trunc_div(v, sdt, f, dt, ct), ct,
                                       dt)), k, dt
        if src.is_decimal and dst.is_float:
            # truediv by a Python float: an integer operand divides in
            # float64, a float one in its own type
            qt = sdt if sdt.kind == "f" else _F64
            scale = _bits_literal(10.0 ** src.scale, qt)
            return self.value(dt, cast(f"({cast(v, sdt, qt)} / {scale})",
                                       qt, dt)), k, dt
        if dst.is_decimal and not src.is_decimal:
            factor = 10 ** dst.scale
            if src.is_float:
                fn = "rint" if sdt == _F64 else "rintf"
                r = f"{fn}({v} * {_bits_literal(factor, sdt)})"
                return self.value(dt, cast(r, sdt, dt)), k, dt
            return self.value(dt, self.arith(
                "*", cast(v, sdt, dt), _bits_literal(factor, dt), dt)), k, dt
        if src.is_decimal and dst.is_integer:
            f = _bits_literal(10 ** src.scale, _I64)
            ct = promote(sdt, _I64)
            return self.value(dt, cast(self.trunc_div(v, sdt, f, _I64, ct),
                                       ct, dt)), k, dt
        return self.value(dt, cast(v, sdt, dt)), k, dt


_KERNEL = """
// one query, row i, with the parameters of the parameter block
__host__ __device__ inline bool fm_predicate(const FmParams& p, int64_t i) {
    return fm_eval(p, fm_load(p, i), p.params, p.param_valid);
}

// Q queries, row i: the row's columns are loaded once, then the
// predicate runs once per query with that query's parameters
__host__ __device__ inline void fm_batched_row(const FmParams& p, const FmBatch& b,
                                               int64_t i) {
    const bool keep = p.row_mask == nullptr || p.row_mask[i] != 0;
    if (!keep) {
        for (int64_t q = 0; q < b.n_q; ++q) b.out[q * p.n + i] = 0;
        return;
    }
    const FmRow r = fm_load(p, i);
    for (int64_t q = 0; q < b.n_q; ++q) {
        const int64_t* prm = b.params + q * b.n_params;
        const uint8_t* pvl = b.param_valid + q * b.n_params;
        b.out[q * p.n + i] = fm_eval(p, r, prm, pvl) ? 1 : 0;
    }
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

__global__ void fm_kernel(const FmParams p) {
    int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= p.n) return;
    bool keep = p.row_mask == nullptr || p.row_mask[i] != 0;
    p.out[i] = (keep && fm_predicate(p, i)) ? 1 : 0;
}

__global__ void fm_batched_kernel(const FmParams p, const FmBatch b) {
    int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < p.n) fm_batched_row(p, b, i);
}

extern "C" int filter_mask_launch(const FmParams* p, void* stream) {
    if (p->n <= 0) return 0;
    const int threads = 256;
    long long blocks = (p->n + threads - 1) / threads;
    fm_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(*p);
    return (int)cudaGetLastError();
}

extern "C" int filter_mask_batched_launch(const FmParams* p, const FmBatch* b,
                                          void* stream) {
    if (p->n <= 0 || b->n_q <= 0) return 0;
    const int threads = 256;
    long long blocks = (p->n + threads - 1) / threads;
    fm_batched_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(*p, *b);
    return (int)cudaGetLastError();
}

extern "C" int filter_mask_params_size(void) { return (int)sizeof(FmParams); }
extern "C" int filter_mask_batch_size(void) { return (int)sizeof(FmBatch); }
#endif
"""


def generate_predicate(expr, col_dtypes: dict, param_dtypes: dict
                       ) -> Predicate:
    """-> the CUDA C++ source of ``expr`` as a row predicate.
    ``col_dtypes`` maps column names, ``param_dtypes`` parameter env
    names (``BParam.env_name``) to their device dtypes.

    The source defines ``FmRow`` (the row's loaded columns),
    ``fm_load(p, i)`` (loads them), ``fm_eval(p, r, prm, pvl)`` (the
    predicate over a loaded row and one query's parameter values and
    validity), ``fm_predicate(p, i)`` (one query, the parameter block's
    parameters) and ``fm_batched_row(p, b, i)`` (Q queries, the columns
    loaded once), and, under ``__CUDACC__``, the one-query and the
    batched kernel with their C launchers."""
    g = _Gen(col_dtypes, param_dtypes)
    v, k, dt = g.gen(expr)
    b = v if dt == _BOOL else f"({v} != 0)"
    body = "\n".join(g.lines)
    fields = "".join(f"    {_C_TYPES[t]} c{j};\n    bool v{j};\n"
                     for j, t in enumerate(g.column_types)) \
        or "    bool unused;\n"
    loads = "".join(
        f"    r.c{j} = ((const {_C_TYPES[t]}*)p.cols[{j}])[i];\n"
        f"    r.v{j} = fm_valid(p.valids[{j}], i);\n"
        for j, t in enumerate(g.column_types))
    source = (
        "// generated by citus_tpu_torch/ops/expr_codegen.py from:\n"
        f"// {_one_line(expr)}\n"
        "#include \"expr.cuh\"\n\n"
        f"struct FmRow {{\n{fields}}};\n\n"
        "__host__ __device__ inline FmRow fm_load(const FmParams& p, "
        "int64_t i) {\n"
        "    FmRow r{};\n"
        f"{loads}"
        "    return r;\n"
        "}\n\n"
        "__host__ __device__ inline bool fm_eval(const FmParams& p, "
        "const FmRow& r, const int64_t* prm, const uint8_t* pvl) {\n"
        f"{body}\n"
        f"    return {g.both(b, k)};\n"
        "}\n" + _KERNEL)
    for used, limit in ((g.columns, 64), (g.params, 64), (g.tables, 16)):
        if len(used) > limit:
            _unsupported(f"more than {limit} columns, parameters or "
                         "dictionary masks")
    return Predicate(source, tuple(g.columns), tuple(g.params),
                     tuple(g.tables))


def _one_line(expr) -> str:
    """The tree as a one-line C++ comment (no line splice, bounded)."""
    s = repr(expr).replace("\n", " ").replace("\\", "/")
    return s if len(s) <= 2000 else s[:2000] + " ..."
