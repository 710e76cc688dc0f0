"""CUDA C++ source from bound expression trees (ROADMAP.md B10).

``generate_predicate(expr, col_dtypes, param_dtypes)`` turns a bound
predicate (``planner/bound.py``) into the source of a predicate kernel:
a ``__host__ __device__`` function ``fm_eval(p, r, prm, pvl)`` that
evaluates every node of the tree as a (value, valid) pair over the
loaded columns ``r`` of one row and one query's parameters, with the
semantics of the reference's ``compile_expr``/``predicate_mask`` under
JAX; ``fm_rows(p, g)`` for one query and ``fm_batched_rows`` for Q
queries of one family (the columns loaded once), each over a thread's
few consecutive rows; and, under ``__CUDACC__``, the kernels that write
``out[i] = row_mask[i] && predicate(i)`` and ``out[q, i]`` for every
query q, with their C launchers.
``csrc/expr.cuh`` holds the helpers and the parameter block.

``generate_fold_row(plan, col_dtypes, param_dtypes, key_dtypes)`` turns
the WHERE, the group keys and the used aggregate arguments of a plan
into the row source of the fold (``csrc/fold.cuh``) or hash-insert
(``csrc/hash_probe.cuh``) kernels: for row ``i``, the filter's pass bit
and each key's and argument's (value, valid), evaluated in registers
with the same semantics, then the fold or insert instantiated over it.
A direct-mode key is its value as int64 (``astype(np.int64)`` of the
reference's group id); a hash key is cast to its key dtype, as the
reference's ``_eval_keys`` casts it, and the insert's ``key_bits``
(``csrc/hash_probe.cuh``) makes it canonical (-0.0 -> 0.0, one quiet
NaN, NULL -> 0) as ``_canon_keys`` does.  Outside ``__CUDACC__`` the
source instead has a host C entry, ``fold_row_host``, that writes those
outputs for ``n`` rows: the tests compile it with g++ and hold it
against the reference.

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

import re
from dataclasses import dataclass

import numpy as np

from citus_tpu_torch import types as T
from citus_tpu_torch.errors import UnsupportedFeatureError
from citus_tpu_torch.planner.bound import (
    BAddMonths, BBinOp, BCase, BCast, BColumn, BDateTrunc, BDateTruncCivil,
    BDictLookup, BDictMask, BDictRemap, BExtract, BIsNull, BLiteral,
    BMathFunc, BParam, BScale, BUnOp,
)

_BOOL, _I32, _I64 = np.dtype(bool), np.dtype(np.int32), np.dtype(np.int64)
_F32, _F64 = np.dtype(np.float32), np.dtype(np.float64)
_C_TYPES = {_BOOL: "bool", _I32: "int32_t", _I64: "int64_t",
            _F32: "float", _F64: "double"}
_CMP = {"=": "==", "<>": "!=", "<": "<", "<=": "<=", ">": ">", ">=": ">="}
_ARITH = {"+": "add", "-": "sub", "*": "mul"}
_TS_KINDS = (T.TIMESTAMP, T.TIMESTAMPTZ)
_US = {"minute": 60_000_000, "hour": 3_600_000_000,
       "day": 86_400_000_000, "week": 7 * 86_400_000_000}
_CIVIL_FIELDS = {"year": 0, "month": 1, "quarter": 2, "day": 3, "doy": 4}
_TRUNC_UNITS = {"month": 0, "quarter": 1, "year": 2}
#: float functions of one float64 argument and the domain outside which
#: the reference's _compile_math gives NULL
_UNARY_MATH = {"sqrt": ("sqrt", ">= 0"), "exp": ("exp", None),
               "ln": ("log", "> 0"), "log10": ("log10", "> 0"),
               "log2": ("log2", "> 0")}
_ROUNDING = {"floor": "floor", "ceil": "ceil", "round": "rint",
             "trunc": "trunc"}


@dataclass(frozen=True)
class Predicate:
    """Generated source of one predicate and the inputs it reads, in the
    order of the parameter block's slots."""
    source: str
    columns: tuple       # column names -> FmParams.cols / valids
    params: tuple        # parameter env names -> FmParams.params
    tables: tuple        # dictionary tables (numpy arrays: bool masks as
    #                      uint8, remaps int32, lookups int64)


def _unsupported(what: str):
    raise UnsupportedFeatureError(
        f"{what} in an expression has no CUDA code generator yet "
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
        self.used: set = set()   # column slots the current part reads
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

    def lookup(self, operand, values: np.ndarray):
        """``values[clip(ids, 0, n - 1)]`` of a dictionary table (never
        empty), added to the parameter block (the reference's dictionary
        gathers); -> (C expression, validity)."""
        v, k, dt = self.gen(operand)
        if dt.kind != "i":
            _unsupported(f"dictionary ids of dtype {dt}")
        j = len(self.tables)
        self.tables.append(np.ascontiguousarray(values))
        ctype = "uint8_t" if values.dtype == np.uint8 else _C_TYPES[values.dtype]
        # the table's length is a launch argument, so a dictionary that
        # grows keeps its predicate's source (and build)
        last = f"(p.table_len[{j}] - 1)"
        safe = f"({v} < 0 ? 0 : ({v} > {last} ? {last} : {v}))"
        return f"((const {ctype}*)p.tables[{j}])[{safe}]", k

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

    @staticmethod
    def pick(c: str, a: str, b: str) -> str:
        """``c ? a : b`` over validity expressions."""
        if c == "true" or a == b:
            return a
        if c == "false":
            return b
        return f"({c} ? {a} : {b})"

    @staticmethod
    def as_bool(v: str, dt: np.dtype) -> str:
        return v if dt == _BOOL else f"({v} != 0)"

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
            self.used.add(j)
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
            if not e.mask:
                _, k, dt = self.gen(e.operand)
                if dt.kind != "i":
                    _unsupported(f"dictionary ids of dtype {dt}")
                return "false", k, _BOOL
            g, k = self.lookup(e.operand, np.array(e.mask, np.uint8))
            return self.value(_BOOL, f"({g} != 0)"), k, _BOOL
        if isinstance(e, BDictRemap):
            g, k = self.lookup(e.operand, np.array(e.mapping or (-1,),
                                                   np.int32))
            return self.value(_I32, g), k, _I32
        if isinstance(e, BDictLookup):
            g, k = self.lookup(e.operand, np.array(e.table or (0,),
                                                   np.int64))
            return self.value(_I64, g), k, _I64
        if isinstance(e, BCase):
            return self.case(e)
        if isinstance(e, BMathFunc):
            return self.math(e)
        if isinstance(e, (BExtract, BDateTrunc, BDateTruncCivil,
                          BAddMonths)):
            return self.datetime(e)
        _unsupported(type(e).__name__)

    def case(self, e: BCase):
        """The reference's run_case: every branch is evaluated, a NULL
        condition is a branch not taken, the first true WHEN wins."""
        dt = _dtype(e.type.device_dtype)
        result = valid = taken = None
        for c, v in e.whens:
            cv, ck, cdt = self.gen(c)
            cond = self.valid(self.both(self.as_bool(cv, cdt), ck))
            vv, vk, vdt = self.gen(v)
            vv = cast(vv, vdt, dt)
            if result is None:
                result = self.value(dt, f"({cond} ? {vv} : "
                                        f"{_bits_literal(0, dt)})")
                valid = self.valid(self.both(cond, vk))
                taken = cond
            else:
                take = self.valid(self.both(cond, f"!{taken}"))
                result = self.value(dt, f"({take} ? {vv} : {result})")
                valid = self.valid(self.pick(take, vk, valid))
                taken = self.valid(f"({taken} || {cond})")
        if e.else_ is not None:
            ev, ek, edt = self.gen(e.else_)
            result = self.value(dt, f"({taken} ? {result} : "
                                    f"{cast(ev, edt, dt)})")
            valid = self.valid(self.pick(taken, valid, ek))
        else:
            valid = self.valid(self.both(valid, taken))
        return result, valid, dt

    def math(self, e: BMathFunc):
        """The reference's _compile_math; domain violations are NULL."""
        name = e.name
        if name in _UNARY_MATH:
            fn, dom = _UNARY_MATH[name]
            v, k, dt = self.gen(e.operands[0])
            x = self.value(_F64, cast(v, dt, _F64))
            if dom is None:
                return self.value(_F64, f"{fn}({x})"), k, _F64
            ok = self.valid(f"({x} {dom})")
            out = self.value(_F64, f"{fn}({ok} ? {x} : 1.0)")
            return out, self.valid(self.both(k, ok)), _F64
        if name == "power":
            (av, ak, adt), (bv, bk, bdt) = (self.gen(o) for o in e.operands)
            a = self.value(_F64, cast(av, adt, _F64))
            b = self.value(_F64, cast(bv, bdt, _F64))
            ok = self.valid(f"(!({a} == 0.0 && {b} < 0.0) && "
                            f"!({a} < 0.0 && {b} != floor({b})))")
            out = self.value(_F64, f"pow({ok} ? {a} : 1.0, "
                                   f"{ok} ? {b} : 1.0)")
            return out, self.valid(self.both(self.both(ak, bk), ok)), _F64
        if name in _ROUNDING:
            return self.rounding(e)
        if name == "sign":
            v, k, dt = self.gen(e.operands[0])
            out_dt = _dtype(e.type.device_dtype)
            if dt.kind == "f":
                one = _bits_literal(1, dt)
                s_ = (f"({v} > 0 ? {one} : ({v} < 0 ? "
                      f"{_bits_literal(-1, dt)} : {v}))")
            elif dt in (_I32, _I64):
                s_ = f"fm_sign{dt.itemsize * 8}({v})"
            else:
                _unsupported(f"sign() of dtype {dt}")
            return self.value(out_dt, cast(s_, dt, out_dt)), k, out_dt
        if name in ("greatest", "least"):
            dt = _dtype(e.type.device_dtype)
            op = ">" if name == "greatest" else "<"
            acc, acc_k = None, None
            for o in e.operands:
                v, k, vdt = self.gen(o)
                v = self.value(dt, cast(v, vdt, dt))
                if acc is None:
                    acc, acc_k = v, k
                    continue
                # NULLs are ignored: take the other side when one is null
                pick = self.valid(self.both(k, f"(!{acc_k} || "
                                               f"{v} {op} {acc})"))
                acc = self.value(dt, f"({pick} ? {v} : {acc})")
                acc_k = self.valid(f"({acc_k} || {k})")
            return acc, acc_k, dt
        _unsupported(f"math function {name}()")

    def rounding(self, e: BMathFunc):
        name = e.name
        v, k, dt = self.gen(e.operands[0])
        src_scale, digits = e.param
        if e.operands[0].type.is_float:
            fn = _ROUNDING[name]
            if digits:
                factor = _bits_literal(10.0 ** digits, _F64)
                x = cast(v, dt, _F64)
                return self.value(_F64, f"({fn}({x} * {factor}) / "
                                        f"{factor})"), k, _F64
            if dt.kind != "f":
                _unsupported(f"{name}() of dtype {dt}")
            return self.value(dt, f"{fn}{'f' if dt == _F32 else ''}({v})"), \
                k, dt
        # decimal (scaled int64): exact integer arithmetic
        drop = src_scale - max(digits, 0)
        if drop <= 0 or dt.kind != "i":
            _unsupported(f"{name}() of a decimal without digits to drop")
        ct = promote(dt, _I64)
        x = self.value(ct, cast(v, dt, ct))
        p = _bits_literal(10 ** drop, ct)
        q = self.value(ct, f"fm_floordiv64({x}, {p})")
        r = self.value(ct, f"fm_sub64({x}, fm_mul64({q}, {p}))")
        up = f"fm_add64({q}, ({r} > 0 ? 1 : 0))"
        if name == "floor":
            out = q
        elif name == "ceil":
            out = self.value(ct, up)
        else:
            qt = self.value(ct, f"({x} >= 0 ? {q} : {up})")
            if name == "trunc":
                out = qt
            else:  # round half away from zero
                rt = self.value(ct, f"fm_sub64({x}, fm_mul64({qt}, {p}))")
                out = self.value(ct, f"fm_add64({qt}, fm_sign64({rt}) * "
                                     f"(2 * fm_abs64({rt}) >= {p} ? 1 : 0))")
        out_dt = _dtype(e.type.device_dtype)
        return self.value(out_dt, cast(out, ct, out_dt)), k, out_dt

    def datetime(self, e):
        """EXTRACT, date_trunc and + N months on the day (int32) and
        microsecond (int64) encodings, as the reference's run_extract,
        run_trunc_civil, run_add_months and BDateTrunc do."""
        v, k, dt = self.gen(e.operand)
        if dt.kind != "i":
            _unsupported(f"{type(e).__name__} of dtype {dt}")
        is_ts = e.operand.type.kind in _TS_KINDS
        if isinstance(e, BDateTrunc):
            if e.operand.type.kind == T.DATE:
                units = {"day": 1, "week": 7}
                ct = promote(dt, _I32)
                off_v = 3 if e.unit == "week" else 0
            else:
                units = _US
                ct = promote(dt, _I64)
                off_v = 3 * _US["day"] if e.unit == "week" else 0
            if e.unit not in units:
                _unsupported(f"date_trunc({e.unit!r})")
            w = ct.itemsize * 8
            step = _bits_literal(units[e.unit], ct)
            off = _bits_literal(off_v, ct)
            x = cast(v, dt, ct)
            out = (f"fm_sub{w}(fm_mul{w}(fm_floordiv{w}(fm_add{w}({x}, "
                   f"{off}), {step}), {step}), {off})")
            return self.value(ct, out), k, ct
        x = self.value(_I64, cast(v, dt, _I64))
        days = self.value(_I64, f"fm_floordiv64({x}, FM_US_DAY)") if is_ts \
            else x
        if isinstance(e, BExtract):
            f = e.field
            if f == "epoch":
                out = (f"fm_floordiv64({x}, 1000000LL)" if is_ts
                       else f"fm_mul64({days}, 86400LL)")
            elif f in ("hour", "minute", "second"):
                if not is_ts:
                    out = "((int64_t)0)"
                else:
                    rem = self.value(_I64, f"fm_sub64({x}, fm_mul64({days}, "
                                           "FM_US_DAY))")
                    out = {"hour": f"fm_floordiv64({rem}, 3600000000LL)",
                           "minute": f"fm_floormod64(fm_floordiv64({rem}, "
                                     "60000000LL), 60)",
                           "second": f"fm_floormod64(fm_floordiv64({rem}, "
                                     "1000000LL), 60)"}[f]
            elif f == "dow":  # 0 = Sunday, as PostgreSQL
                out = f"fm_floormod64(fm_add64({days}, 4), 7)"
            elif f in _CIVIL_FIELDS:
                out = f"fm_extract_civil({days}, {_CIVIL_FIELDS[f]})"
            else:
                _unsupported(f"EXTRACT field {f!r}")
            return self.value(_I64, out), k, _I64
        if isinstance(e, BDateTruncCivil):
            if e.unit not in _TRUNC_UNITS:
                _unsupported(f"date_trunc({e.unit!r})")
            out = f"fm_trunc_civil({days}, {_TRUNC_UNITS[e.unit]})"
        else:  # BAddMonths
            out = f"fm_add_months({days}, {int(e.months)}LL)"
        out = self.value(_I64, out)
        if is_ts:
            rem = f"fm_sub64({x}, fm_mul64({days}, FM_US_DAY))"
            tail = (f"fm_add64(fm_mul64({out}, FM_US_DAY), {rem})"
                    if isinstance(e, BAddMonths)
                    else f"fm_mul64({out}, FM_US_DAY)")
            return self.value(_I64, tail), k, _I64
        return self.value(_I32, f"((int32_t){out})"), k, _I32

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
// one query's parameters into registers
__host__ __device__ inline void fm_params(const int64_t* prm, const uint8_t* pvl,
                                          int64_t (&lp)[FM_PARAMS], uint8_t (&lv)[FM_PARAMS]) {
#pragma unroll
    for (int j = 0; j < FM_PARAMS; ++j) {
        lp[j] = prm[j];
        lv[j] = pvl[j];
    }
}

// byte k: 1 where row r0 + k passes under one query's parameters and
// is kept (keep: 1 in the kept rows' bytes).  Every row is evaluated
// without a branch (a row that is not kept may hold any bits; no node
// traps on them), so the rows' evaluations interleave.
__host__ __device__ inline uint64_t fm_eval_rows(const FmParams& p, const FmRows& rs,
                                                 uint64_t keep,
                                                 const int64_t (&lp)[FM_PARAMS],
                                                 const uint8_t (&lv)[FM_PARAMS]) {
    uint64_t w = 0;
#pragma unroll
    for (int k = 0; k < FM_ROWS; ++k)
        w |= (uint64_t)(fm_eval(p, fm_row(rs, k), lp, lv) ? 1u : 0u) << (8 * k);
    return w & keep;
}

// thread g's rows of one query, with the parameters of the parameter block
__host__ __device__ inline void fm_rows(const FmParams& p, int64_t g) {
    const int64_t r0 = g * FM_ROWS;
    if (r0 >= p.n) return;
    const uint64_t keep = fm_keep_bytes<FM_ROWS>(p.row_mask, r0, p.n);
    FmRows rs;
    fm_load_rows(p, r0, rs);
    int64_t lp[FM_PARAMS];
    uint8_t lv[FM_PARAMS];
    fm_params(p.params, p.param_valid, lp, lv);
    fm_store_rows<FM_ROWS>(p.out, r0, p.n, fm_eval_rows(p, rs, keep, lp, lv));
}

// thread g's rows of Q queries: the columns loaded once, then query by
// query its parameters (read once for the thread's rows) and its bytes
// of out[q]
__host__ __device__ inline void fm_batched_rows(const FmParams& p, const FmBatch& b,
                                                int64_t g) {
    const int64_t r0 = g * FM_ROWS;
    if (r0 >= p.n) return;
    const uint64_t keep = fm_keep_bytes<FM_ROWS>(p.row_mask, r0, p.n);
    FmRows rs;
    fm_load_rows(p, r0, rs);
    for (int64_t q = 0; q < b.n_q; ++q) {
        int64_t lp[FM_PARAMS];
        uint8_t lv[FM_PARAMS];
        fm_params(b.params + q * b.n_params, b.param_valid + q * b.n_params, lp, lv);
        fm_store_rows<FM_ROWS>(b.out + q * p.n, r0, p.n, fm_eval_rows(p, rs, keep, lp, lv));
    }
}

// the threads that cover n rows, FM_ROWS rows a thread
__host__ __device__ inline int64_t fm_threads(int64_t n) {
    return (n + FM_ROWS - 1) / FM_ROWS;
}

#ifdef __CUDACC__
#include <cuda_runtime.h>

#define FM_THREADS 256

__global__ void __launch_bounds__(FM_THREADS) fm_kernel(const FmParams p) {
    fm_rows(p, (int64_t)blockIdx.x * FM_THREADS + threadIdx.x);
}

__global__ void __launch_bounds__(FM_THREADS) fm_batched_kernel(const FmParams p,
                                                                const FmBatch b) {
    fm_batched_rows(p, b, (int64_t)blockIdx.x * FM_THREADS + threadIdx.x);
}

// a thread for each FM_ROWS rows
static unsigned fm_blocks(int64_t n) {
    return (unsigned)((fm_threads(n) + FM_THREADS - 1) / FM_THREADS);
}

extern "C" int filter_mask_launch(const FmParams* p, void* stream) {
    if (p->n <= 0) return 0;
    fm_kernel<<<fm_blocks(p->n), FM_THREADS, 0, (cudaStream_t)stream>>>(*p);
    return (int)cudaGetLastError();
}

extern "C" int filter_mask_batched_launch(const FmParams* p, const FmBatch* b,
                                          void* stream) {
    if (p->n <= 0 || b->n_q <= 0) return 0;
    fm_batched_kernel<<<fm_blocks(p->n), FM_THREADS, 0, (cudaStream_t)stream>>>(*p, *b);
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

    The source defines ``FmRow`` (one row's loaded columns), ``FmRows``
    and ``fm_load_rows(p, r0, rs)`` (the columns of a thread's
    ``FM_ROWS`` consecutive rows from r0), ``fm_row(rs, k)``,
    ``fm_eval(p, r, prm, pvl)`` (the predicate over a loaded row and one
    query's parameter values and validity), ``fm_rows(p, g)`` (thread
    g's rows of one query, the parameter block's parameters) and
    ``fm_batched_rows(p, b, g)`` (thread g's rows of Q queries, the
    columns loaded once), and, under ``__CUDACC__``, the one-query and
    the batched kernel with their C launchers.  ``FM_ROWS`` (a thread's
    rows, kept in registers) is 8 for a row of at most 8 bytes of
    columns, 4 up to 24, else 2, and 1 for a long predicate (whose
    evaluation takes the time and the registers); chosen by timing the
    Q1, P, Q6 and C1 families at 1, 2, 4 and 8 on the card (PERF.md
    §5)."""
    g = _Gen(col_dtypes, param_dtypes)
    v, k, dt = g.gen(expr)
    b = v if dt == _BOOL else f"({v} != 0)"
    body = "\n".join(g.lines)
    row_bytes = sum(t.itemsize for t in g.column_types)
    rows = 8 if row_bytes <= 8 else 4 if row_bytes <= 24 else 2
    if len(g.lines) > _LONG_PREDICATE:
        rows = 1
    source = (
        "// generated by citus_tpu_torch/ops/expr_codegen.py from:\n"
        f"// {_one_line(expr)}\n"
        "#include \"expr.cuh\"\n\n"
        f"#define FM_ROWS {rows}\n"
        f"#define FM_PARAMS {max(1, len(g.params))}\n\n"
        f"{_row_struct(g)}"
        f"{_rows_struct(g)}"
        "__host__ __device__ inline void fm_load_rows(const FmParams& p, "
        "int64_t r0, FmRows& rs) {\n"
        f"{_row_loads(g)}"
        "}\n\n"
        "__host__ __device__ inline FmRow fm_row(const FmRows& rs, int k) "
        "{\n"
        "    FmRow r{};\n"
        + "".join(f"    r.c{j} = rs.c{j}[k];\n"
                  f"    r.v{j} = ((rs.v{j} >> k) & 1u) != 0;\n"
                  for j in range(len(g.columns)))
        + "    return r;\n"
        "}\n\n"
        "__host__ __device__ inline bool fm_eval(const FmParams& p, "
        "const FmRow& r, const int64_t* prm, const uint8_t* pvl) {\n"
        f"{body}\n"
        f"    return {g.both(b, k)};\n"
        "}\n" + _KERNEL)
    _check_limits(g)
    return Predicate(source, tuple(g.columns), tuple(g.params),
                     tuple(g.tables))


#: generated lines past which a predicate takes 1 row a thread (its
#: evaluation is long, its temporaries many): on the card the C1 family's
#: 67 lines ran fastest at 2 rows a thread, the C1all family's 201 at 1
_LONG_PREDICATE = 70


def _rows_struct(g: _Gen) -> str:
    """``FmRows``: the loaded columns of a thread's rows, validity as
    bits."""
    fields = "".join(f"    {_C_TYPES[t]} c{j}[FM_ROWS];\n    uint32_t v{j};\n"
                     for j, t in enumerate(g.column_types)) \
        or "    bool unused;\n"
    return f"struct FmRows {{\n{fields}}};\n\n"


def _row_loads(g: _Gen) -> str:
    """C statements loading every column of a thread's rows from
    ``r0``."""
    return "".join(
        f"    fm_ld_rows<{_C_TYPES[t]}, FM_ROWS>(p.cols[{j}], p.valids[{j}], "
        f"r0, p.n, rs.c{j}, &rs.v{j});\n"
        for j, t in enumerate(g.column_types))


def _row_struct(g: _Gen) -> str:
    """``FmRow``: the loaded columns of one row."""
    fields = "".join(f"    {_C_TYPES[t]} c{j};\n    bool v{j};\n"
                     for j, t in enumerate(g.column_types)) \
        or "    bool unused;\n"
    return f"struct FmRow {{\n{fields}}};\n\n"


def _loads(g: _Gen, slots) -> str:
    """C statements loading column slots ``slots`` of row ``i`` into ``r``."""
    return "".join(
        f"    r.c{j} = ((const {_C_TYPES[g.column_types[j]]}*)p.cols[{j}])[i];\n"
        f"    r.v{j} = fm_valid(p.valids[{j}], i);\n" for j in sorted(slots))


def _check_limits(g: _Gen) -> None:
    for used, limit in ((g.columns, 64), (g.params, 64), (g.tables, 16)):
        if len(used) > limit:
            _unsupported(f"more than {limit} columns, parameters or "
                         "dictionary masks")


# ------------------------------------------------ fold and insert rows


@dataclass(frozen=True)
class FoldExprs:
    """What a fold or hash insert evaluates for each row: the WHERE (or
    None), the group keys, and the aggregate arguments that partial ops
    read, in the order of their argument slots."""
    filter: object
    keys: tuple
    args: tuple


def fold_exprs(plan) -> tuple:
    """-> (a physical plan's ``FoldExprs``, each partial op's argument
    slot, -1 for one that reads none): argument slot j is the j-th
    smallest ``agg_args`` index a partial op reads."""
    used = sorted({op.arg_index for op in plan.partial_ops
                   if op.arg_index >= 0})
    slot = {ai: j for j, ai in enumerate(used)}
    return (FoldExprs(plan.bound.filter, tuple(plan.bound.group_keys),
                      tuple(plan.agg_args[i] for i in used)),
            [slot.get(op.arg_index, -1) for op in plan.partial_ops])


@dataclass(frozen=True)
class FoldRow:
    """Generated row source of one plan's fold or hash insert and the
    inputs it reads, in the order of the parameter block's slots; the
    dtypes of its key and argument outputs."""
    source: str
    columns: tuple
    params: tuple
    tables: tuple
    key_dtypes: tuple
    arg_dtypes: tuple
    hashed: bool


_FOLD_INCLUDES = ('#include "fold.cuh"\n', '#include "scan_agg_fold.cu"\n'
                  '#include "scan_agg_fold_batched.cu"\n')
_HASH_INCLUDES = ('#include "hash_probe.cuh"\n',
                  '#include "hash_agg_insert.cu"\n'
                  '#include "hash_agg_insert_batched.cu"\n')


def generate_fold_row(plan, col_dtypes: dict, param_dtypes: dict,
                      key_dtypes=None) -> FoldRow:
    """-> the CUDA C++ source of the fold (``key_dtypes`` None: scalar
    and direct modes) or the hash insert (``key_dtypes``: the table's key
    dtypes) of ``plan``, a ``PhysicalPlan`` or its ``FoldExprs``.

    The source defines ``FmRow`` as a predicate's does,
    ``fr_filter`` (the WHERE's pass bit, NULL is false; ``true`` without
    a WHERE), ``FrVals`` and ``fr_values`` (keys ``k<j>``/``kv<j>`` and
    arguments ``a<j>``/``av<j>``).  Under ``__CUDACC__`` it wraps them as
    the row source ``FoldRow`` and includes the kernels; otherwise it
    defines ``fold_row_host``.  Literal keys, arguments and validities
    are constants of the source."""
    e = plan if isinstance(plan, FoldExprs) else fold_exprs(plan)[0]
    hashed = key_dtypes is not None
    if hashed and len(key_dtypes) != len(e.keys):
        raise ValueError("one key dtype per group key")
    g = _Gen(col_dtypes, param_dtypes)
    filt = "true"
    if e.filter is not None:
        v, k, dt = g.gen(e.filter)
        filt = g.both(g.as_bool(v, dt), k)
    filter_body, g.lines = g.lines, []
    filter_cols, g.used = g.used, set()
    fields, outs, key_dts, arg_dts = [], [], [], []
    for j, ke in enumerate(e.keys):
        v, k, dt = g.gen(ke)
        kdt = _dtype(key_dtypes[j]) if hashed else _I64
        val = cast(v, dt, kdt)
        fields.append(f"    {_C_TYPES[kdt]} k{j};\n    bool kv{j};\n")
        outs.append(f"    o.k{j} = {val};\n    o.kv{j} = {k};\n")
        key_dts.append(kdt)
    for j, ae in enumerate(e.args):
        v, k, dt = g.gen(ae)
        fields.append(f"    {_C_TYPES[dt]} a{j};\n    bool av{j};\n")
        outs.append(f"    o.a{j} = {v};\n    o.av{j} = {k};\n")
        arg_dts.append(dt)
    _check_limits(g)
    source = (
        "// generated by citus_tpu_torch/ops/expr_codegen.py "
        "(generate_fold_row) from:\n"
        f"// filter: {_one_line(e.filter)}\n"
        + "".join(f"// key {j}: {_one_line(x)}\n"
                  for j, x in enumerate(e.keys))
        + "".join(f"// argument {j}: {_one_line(x)}\n"
                  for j, x in enumerate(e.args))
        + "#include \"expr.cuh\"\n\n"
        + _row_struct(g)
        + "// the columns the WHERE reads, and those the keys and arguments "
          "read\n"
        "__host__ __device__ inline void fr_load_filter(const FmParams& p, "
        "int64_t i, FmRow& r) {\n" + _loads(g, filter_cols) + "}\n\n"
        "__host__ __device__ inline void fr_load_values(const FmParams& p, "
        "int64_t i, FmRow& r) {\n" + _loads(g, g.used) + "}\n\n"
        "__host__ __device__ inline bool fr_filter(const FmParams& p, "
        "const FmRow& r, const int64_t* prm, const uint8_t* pvl) {\n"
        + "".join(line + "\n" for line in filter_body)
        + f"    return {filt};\n}}\n\n"
        + "struct FrVals {\n" + ("".join(fields) or "    bool unused;\n")
        + "};\n\n"
        "__host__ __device__ inline void fr_values(const FmParams& p, "
        "const FmRow& r, const int64_t* prm, const uint8_t* pvl, "
        "FrVals& o) {\n"
        + "".join(line + "\n" for line in g.lines) + "".join(outs)
        + "}\n\n"
        + _fold_row_tail(len(e.keys), len(e.args), key_dts, arg_dts, hashed))
    return FoldRow(source, tuple(g.columns), tuple(g.params),
                   tuple(g.tables), tuple(key_dts), tuple(arg_dts), hashed)


def _switch(n: int, case, default: str) -> str:
    return ("        switch (k) {\n"
            + "".join(f"            case {j}: {case(j)}\n" for j in range(n))
            + f"        }}\n        {default}\n")


def _fold_row_tail(n_keys, n_args, key_dts, arg_dts, hashed) -> str:
    """The ``FoldRow`` row source and the kernels under ``__CUDACC__``;
    ``fold_row_host`` otherwise."""
    head, kernels = _HASH_INCLUDES if hashed else _FOLD_INCLUDES
    if hashed:
        key = ("    static __device__ __forceinline__ KeyBits key_bits("
               "const Vals& v, int k) {\n"
               + _switch(n_keys, lambda j: f"return ::key_bits(v.k{j}, v.kv{j});",
                         "return KeyBits{0, 0, false};") + "    }\n")
    else:
        key = ("    static __device__ __forceinline__ bool key("
               "const Vals& v, int k, long long* out) {\n"
               + _switch(n_keys, lambda j: f"*out = (long long)v.k{j}; "
                         f"return v.kv{j};", "return false;") + "    }\n")
    arg = ("    static __device__ __forceinline__ bool arg(const Vals& v, "
           "int k, SafVal* out) {\n"
           + _switch(n_args, lambda j: f"*out = saf_val(v.a{j}); "
                     f"return v.av{j};", "return false;") + "    }\n")
    host_outs = "".join(
        f"        ((({_C_TYPES[t]}*)keys[{j}]))[i] = o.k{j};\n"
        f"        key_valid[{j}][i] = o.kv{j} ? 1 : 0;\n"
        for j, t in enumerate(key_dts)) + "".join(
        f"        ((({_C_TYPES[t]}*)args[{j}]))[i] = o.a{j};\n"
        f"        arg_valid[{j}][i] = o.av{j} ? 1 : 0;\n"
        for j, t in enumerate(arg_dts))
    return (
        "#ifdef __CUDACC__\n" + head +
        "\n// the row source of the kernels included below\n"
        "struct FoldRow {\n"
        f"    static constexpr int kKeys = {n_keys};\n"
        "    typedef FrVals Vals;\n"
        "    static __device__ __forceinline__ bool pass(const FmParams& p, "
        "int64_t i) {\n"
        "        FmRow r{};\n"
        "        fr_load_filter(p, i, r);\n"
        "        return fr_filter(p, r, p.params, p.param_valid);\n    }\n"
        "    static __device__ __forceinline__ void values(const FmParams& p, "
        "int64_t i, Vals& v) {\n"
        "        FmRow r{};\n"
        "        fr_load_values(p, i, r);\n"
        "        fr_values(p, r, p.params, p.param_valid, v);\n    }\n"
        + key + arg + "};\n\n" + kernels +
        "#else\n"
        "// rows [0, p->n): pass[i] = row_mask[i] && the WHERE, and each key's\n"
        "// and argument's value and validity\n"
        "extern \"C\" void fold_row_host(const FmParams* p, uint8_t* pass, "
        "void* const* keys, uint8_t* const* key_valid, void* const* args, "
        "uint8_t* const* arg_valid) {\n"
        "    for (int64_t i = 0; i < p->n; ++i) {\n"
        "        FmRow r{};\n"
        "        fr_load_filter(*p, i, r);\n"
        "        fr_load_values(*p, i, r);\n"
        "        pass[i] = ((p->row_mask == nullptr || p->row_mask[i] != 0) "
        "&& fr_filter(*p, r, p->params, p->param_valid)) ? 1 : 0;\n"
        "        FrVals o;\n"
        "        fr_values(*p, r, p->params, p->param_valid, o);\n"
        f"{host_outs}"
        "    }\n}\n#endif\n")


#: a dictionary node's table as its repr shows it (a flat tuple)
_DICT_TABLE = re.compile(r"\b(mapping|table|mask)=\([^()]*\)")


def _one_line(expr) -> str:
    """The tree as a one-line C++ comment (no line splice, bounded).  A
    dictionary node's table is left out: it is a launch argument, so a
    dictionary that grows (an INSERT of new words, an enum column's new
    labels) keeps the source, and its build."""
    s = _DICT_TABLE.sub(r"\1=(...)", repr(expr))
    s = s.replace("\n", " ").replace("\\", "/")
    return s if len(s) <= 2000 else s[:2000] + " ..."
