"""Bound (typed) expressions and their compilation to array evaluators.

The binder turns parser AST into this typed tree; the executor compiles it
once per plan into a function over column arrays.  The same compiled form
runs on both backends — ``numpy`` (host oracle / small local paths, the
analog of the reference's row-at-a-time qual evaluation) and the torch
namespace of ``ops/xp_torch.py`` on the Cluster's device.  The bodies
stay namespace-generic: numpy's scalar methods (``.astype``,
``dtype.type(x)``, ``/``) go through the module-level helpers
``astype``, ``const``, ``truediv``, which defer to the namespace when it
is not numpy.  SQL three-valued logic is carried
explicitly: every evaluation returns ``(values, valid)`` where ``valid``
is the not-null mask; predicates treat NULL as false at the filter
boundary, matching PostgreSQL semantics.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

from citus_tpu_torch import types as T
from citus_tpu_torch.errors import AnalysisError

# ------------------------------------------------ namespace helpers


def _is_numpy(xp) -> bool:
    return xp is np


def astype(xp, v, dt):
    """``v.astype(dt)`` for numpy values and namespace tensors alike."""
    if _is_numpy(xp):
        return v.astype(dt) if hasattr(v, "astype") else np.asarray(v).astype(dt)
    return xp.astype(v, dt)


def const(xp, dt, value):
    """A typed constant: ``dtype.type(value)`` under numpy."""
    if _is_numpy(xp):
        return np.dtype(dt).type(value)
    return xp.const(value, dt)


def truediv(xp, a, b):
    """``a / b`` with numpy's float64 result for integer operands."""
    if _is_numpy(xp):
        return a / b
    return xp.truediv(a, b)


def _is_bool(v) -> bool:
    return str(getattr(v, "dtype", "")) in ("bool", "torch.bool")


# ---------------------------------------------------------------- nodes


class BExpr:
    type: T.ColumnType


@dataclass(frozen=True)
class BColumn(BExpr):
    name: str
    type: T.ColumnType


@dataclass(frozen=True)
class BLiteral(BExpr):
    """Physical-encoded constant (None = SQL NULL)."""
    value: Any
    type: T.ColumnType


@dataclass(frozen=True)
class BParam(BExpr):
    """Deferred $N parameter (reference: Job->deferredPruning /
    fast-path prepared statements).  Compiles to an env lookup of a 0-d
    runtime array — kernels jitted once serve every parameter value."""
    index: int  # 0-based
    type: T.ColumnType
    # "" = the whole value (uuid: its high lane); types.UUID_LANE_SUFFIX
    # = the low int64 lane of a uuid parameter
    lane: str = ""

    @property
    def env_name(self) -> str:
        return f"__param_{self.index}{self.lane}"


@dataclass(frozen=True)
class BBinOp(BExpr):
    op: str  # + - * / % = <> < <= > >= and or
    left: BExpr
    right: BExpr
    type: T.ColumnType


@dataclass(frozen=True)
class BUnOp(BExpr):
    op: str  # not | -
    operand: BExpr
    type: T.ColumnType


@dataclass(frozen=True)
class BScale(BExpr):
    """Multiply by 10**power — decimal scale alignment."""
    operand: BExpr
    power: int
    type: T.ColumnType


@dataclass(frozen=True)
class BCast(BExpr):
    operand: BExpr
    type: T.ColumnType


@dataclass(frozen=True)
class BIsNull(BExpr):
    operand: BExpr
    negated: bool
    type: T.ColumnType = T.BOOL_T


@dataclass(frozen=True)
class BCase(BExpr):
    whens: tuple[tuple[BExpr, BExpr], ...]
    else_: Optional[BExpr]
    type: T.ColumnType


@dataclass(frozen=True)
class BDictRemap(BExpr):
    """Re-encode a dictionary-id column into another relation's dictionary
    id space (cross-relation text equality/joins stay integer-valued).
    ``mapping[id]`` is the target id, or -1 when the string is absent."""
    operand: BExpr
    mapping: tuple[int, ...]
    type: T.ColumnType = T.TEXT_T


@dataclass(frozen=True)
class BDictLookup(BExpr):
    """Per-dictionary-id lookup table -> numeric value (e.g. length(s):
    the table holds each word's length, the device just gathers)."""
    operand: BExpr
    table: tuple
    type: T.ColumnType = T.INT64_T


@dataclass(frozen=True)
class BDictMask(BExpr):
    """Membership of a dictionary-encoded column in a precomputed id set
    (LIKE / IN over text evaluate the pattern against the table-global
    dictionary at bind time; the device just gathers a bool table)."""
    operand: BExpr            # int32 dictionary ids
    mask: tuple[bool, ...]    # mask[id] -> matches
    type: T.ColumnType = T.BOOL_T


@dataclass(frozen=True)
class BMathFunc(BExpr):
    """Scalar math function lowered to elementwise xp ops (reference:
    float8/numeric math in PostgreSQL's float.c / numeric.c; domain
    violations — sqrt of a negative, log of a non-positive — yield SQL
    NULL rather than a device-side error, since a traced kernel cannot
    raise data-dependent errors).

    ``param`` carries bind-time constants (digit count for round/trunc
    over decimals, the operand's decimal scale) so compilation stays
    shape-static."""
    name: str
    operands: tuple[BExpr, ...]
    type: T.ColumnType
    param: object = None


@dataclass(frozen=True)
class BAggRef(BExpr):
    """Reference to aggregate slot ``index`` in the combine/final phase."""
    index: int
    type: T.ColumnType


@dataclass(frozen=True)
class BKeyRef(BExpr):
    """Reference to GROUP BY key ``index`` in the combine/final phase."""
    index: int
    type: T.ColumnType


@dataclass(frozen=True)
class BDateTrunc(BExpr):
    """date_trunc to a fixed-width unit (device-computable on the physical
    day/microsecond encodings)."""
    unit: str  # hour | minute | day | week
    operand: BExpr
    type: T.ColumnType


@dataclass(frozen=True)
class BExtract(BExpr):
    """EXTRACT(field FROM date/timestamp) — vectorized proleptic-Gregorian
    calendar math on the integer day/microsecond encodings (no table
    lookups, fully jittable)."""
    field: str  # year | month | day | dow | doy | hour | minute | second | epoch
    operand: BExpr
    type: T.ColumnType = T.INT64_T


@dataclass(frozen=True)
class BAddMonths(BExpr):
    """date/timestamp + N months: civil month addition with day-of-month
    clamping (PostgreSQL timestamp_pl_interval semantics), vectorized on
    the integer day/microsecond encodings."""
    operand: BExpr
    months: int
    type: T.ColumnType


def py_add_interval(value, months: int, days: int, micros: int):
    """Python-side interval addition for constant folding (value is a
    datetime.date or datetime.datetime)."""
    import datetime as _dt
    d = value
    if months:
        is_date = not isinstance(d, _dt.datetime)
        y, m = d.year, d.month - 1 + months
        y += m // 12
        m = m % 12 + 1
        if m == 12:
            last = 31
        else:
            last = ((_dt.date(y, m + 1, 1) if m < 12
                     else _dt.date(y + 1, 1, 1))
                    - _dt.date(y, m, 1)).days
        day = min(d.day, last)
        d = d.replace(year=y, month=m, day=day) if not is_date \
            else _dt.date(y, m, day)
    if days:
        d = d + _dt.timedelta(days=days)
    if micros:
        if not isinstance(d, _dt.datetime):
            d = _dt.datetime(d.year, d.month, d.day)
        d = d + _dt.timedelta(microseconds=micros)
    return d


@dataclass(frozen=True)
class BDateTruncCivil(BExpr):
    """date_trunc to a calendar unit (month/quarter/year) — needs civil
    date math rather than fixed-width division."""
    unit: str  # month | quarter | year
    operand: BExpr
    type: T.ColumnType


def civil_from_days(xp, z):
    """days-since-1970 -> (year, month, day); Hinnant's algorithm with
    floor divisions kept positive via the era offset."""
    z = astype(xp, z, np.int64) + 719468
    era = z // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = mp + xp.where(mp < 10, 3, -9)
    y = y + (m <= 2)
    return y, m, d


def days_from_civil(xp, y, m, d):
    # torch refuses int - bool; the cast keeps numpy's int64 result
    y = y - astype(xp, m <= 2, np.int64)
    era = y // 400
    yoe = y - era * 400
    doy = (153 * (m + xp.where(m > 2, -3, 9)) + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def walk(e: BExpr):
    yield e
    if isinstance(e, BBinOp):
        yield from walk(e.left)
        yield from walk(e.right)
    elif isinstance(e, (BUnOp, BScale, BCast, BIsNull, BDictMask, BDictRemap,
                        BDictLookup, BExtract, BDateTrunc, BDateTruncCivil,
                        BAddMonths)):
        yield from walk(e.operand)
    elif isinstance(e, BMathFunc):
        for o in e.operands:
            yield from walk(o)
    elif isinstance(e, BCase):
        for c, v in e.whens:
            yield from walk(c)
            yield from walk(v)
        if e.else_ is not None:
            yield from walk(e.else_)


def referenced_columns(e: BExpr) -> list[str]:
    return sorted({n.name for n in walk(e) if isinstance(n, BColumn)})


def param_env_names(param_specs) -> list[str]:
    """Worker env names for plan parameters, in positional order; a uuid
    parameter contributes its low int64 lane right after its high lane
    (matching BParam.env_name for both lanes)."""
    out: list[str] = []
    for i, spec in enumerate(param_specs):
        out.append(f"__param_{i}")
        if spec[0].kind == T.UUID:
            out.append(f"__param_{i}{T.UUID_LANE_SUFFIX}")
    return out


# ---------------------------------------------------------- compilation


def _trunc_div(xp, a, b):
    """SQL integer division truncates toward zero (numpy/jnp floor_divide
    rounds toward -inf, so do it on magnitudes)."""
    sign = xp.sign(a) * xp.sign(b)
    q = xp.abs(a) // xp.abs(xp.where(b == 0, 1, b))
    return sign * q


def compile_expr(e: BExpr, xp):
    """BExpr -> fn(env) -> (values, valid). ``env`` maps column name ->
    (values, valid) arrays; '__aggs__' -> list of (values, valid) for
    BAggRef. ``xp`` is numpy or a ``TorchNamespace`` (ops/xp_torch.py)."""
    if isinstance(e, BColumn):
        name = e.name
        return lambda env: env[name]
    if isinstance(e, BLiteral):
        if e.value is None:
            zero = const(xp, e.type.device_dtype, 0)
            return lambda env: (zero, False)
        val = const(xp, e.type.device_dtype, e.value)
        return lambda env: (val, True)
    if isinstance(e, BParam):
        name = e.env_name
        return lambda env: env[name]
    if isinstance(e, BAggRef):
        idx = e.index
        return lambda env: env["__aggs__"][idx]
    if isinstance(e, BKeyRef):
        idx = e.index
        return lambda env: env["__keys__"][idx]
    if isinstance(e, BExtract):
        f = compile_expr(e.operand, xp)
        field = e.field
        is_ts = e.operand.type.kind in (T.TIMESTAMP, T.TIMESTAMPTZ)
        US_DAY = const(xp, np.int64, 86_400_000_000)

        def run_extract(env):
            v, valid = f(env)
            v = xp.asarray(v)
            if is_ts:
                days = v // US_DAY
                rem = v - days * US_DAY
            else:
                days = astype(xp, v, np.int64)
                rem = None
            if field == "epoch":
                out = astype(xp, v, np.int64) // 1_000_000 if is_ts \
                    else days * 86_400
                return (out, valid)
            if field in ("hour", "minute", "second"):
                if rem is None:
                    return (xp.zeros_like(days), valid)
                if field == "hour":
                    return (rem // 3_600_000_000, valid)
                if field == "minute":
                    return (rem // 60_000_000 % 60, valid)
                return (rem // 1_000_000 % 60, valid)
            if field == "dow":  # 0=Sunday like PostgreSQL
                return ((days + 4) % 7, valid)
            y, m, d = civil_from_days(xp, days)
            if field == "year":
                return (y, valid)
            if field == "month":
                return (m, valid)
            if field == "quarter":
                return ((m - 1) // 3 + 1, valid)
            if field == "day":
                return (d, valid)
            if field == "doy":
                jan1 = days_from_civil(xp, y, xp.ones_like(m), xp.ones_like(d))
                return (days - jan1 + 1, valid)
            raise AnalysisError(f"EXTRACT field {field!r} not supported")
        return run_extract
    if isinstance(e, BAddMonths):
        f = compile_expr(e.operand, xp)
        months = int(e.months)
        is_ts = e.operand.type.kind in (T.TIMESTAMP, T.TIMESTAMPTZ)
        US_DAY = const(xp, np.int64, 86_400_000_000)

        def run_add_months(env):
            v, valid = f(env)
            v = xp.asarray(v)
            if is_ts:
                days = v // US_DAY
                rem = v - days * US_DAY
            else:
                days = astype(xp, v, np.int64)
                rem = None
            y, m, d = civil_from_days(xp, days)
            mt = (m - 1) + months
            y = y + mt // 12
            m = mt % 12 + 1
            # clamp to the target month's length (PostgreSQL semantics:
            # Jan 31 + 1 month = Feb 28/29)
            nm_y = y + (m == 12)
            nm_m = xp.where(m == 12, 1, m + 1)
            month_len = days_from_civil(xp, nm_y, nm_m, xp.ones_like(d)) \
                - days_from_civil(xp, y, m, xp.ones_like(d))
            d = xp.minimum(d, month_len)
            out_days = days_from_civil(xp, y, m, d)
            if is_ts:
                return (out_days * US_DAY + rem, valid)
            return (astype(xp, out_days, np.int32), valid)
        return run_add_months
    if isinstance(e, BDateTruncCivil):
        f = compile_expr(e.operand, xp)
        unit = e.unit
        is_ts = e.operand.type.kind in (T.TIMESTAMP, T.TIMESTAMPTZ)
        US_DAY = const(xp, np.int64, 86_400_000_000)

        def run_trunc_civil(env):
            v, valid = f(env)
            v = xp.asarray(v)
            days = (v // US_DAY) if is_ts else astype(xp, v, np.int64)
            y, m, d = civil_from_days(xp, days)
            if unit == "year":
                m = xp.ones_like(m)
            elif unit == "quarter":
                m = ((m - 1) // 3) * 3 + 1
            else:  # month
                pass
            out_days = days_from_civil(xp, y, m, xp.ones_like(d))
            if is_ts:
                return (out_days * US_DAY, valid)
            return (astype(xp, out_days, np.int32), valid)
        return run_trunc_civil
    if isinstance(e, BDateTrunc):
        f = compile_expr(e.operand, xp)
        if e.operand.type.kind == T.DATE:
            units = {"day": 1, "week": 7}
            if e.unit not in units:
                raise AnalysisError(f"date_trunc({e.unit!r}) on date not supported")
            step = const(xp, np.int32, units[e.unit])
            # epoch day 0 = Thursday; ISO weeks start Monday (epoch day -3)
            off = const(xp, np.int32, 3 if e.unit == "week" else 0)
            return lambda env: ((lambda v: (((v[0] + off) // step) * step - off, v[1]))(f(env)))
        units = {"minute": 60_000_000, "hour": 3_600_000_000,
                 "day": 86_400_000_000, "week": 7 * 86_400_000_000}
        if e.unit not in units:
            raise AnalysisError(f"date_trunc({e.unit!r}) not supported")
        step = const(xp, np.int64, units[e.unit])
        off = const(xp, np.int64, 3 * 86_400_000_000 if e.unit == "week" else 0)
        return lambda env: ((lambda v: (((v[0] + off) // step) * step - off, v[1]))(f(env)))
    if isinstance(e, BScale):
        f = compile_expr(e.operand, xp)
        factor = const(xp, e.type.device_dtype, 10 ** e.power)
        return lambda env: ((lambda v: (v[0] * factor, v[1]))(f(env)))
    if isinstance(e, BCast):
        f = compile_expr(e.operand, xp)
        src, dst = e.operand.type, e.type
        dt = dst.device_dtype
        if src.is_decimal and dst.is_decimal:
            diff = dst.scale - src.scale
            if diff >= 0:
                factor = const(xp, dt, 10 ** diff)
                return lambda env: ((lambda v: (astype(xp, v[0], dt) * factor, v[1]))(f(env)))
            factor = const(xp, dt, 10 ** (-diff))
            return lambda env: ((lambda v: (astype(xp, _trunc_div(xp, v[0], factor), dt), v[1]))(f(env)))
        if src.is_decimal and dst.is_float:
            scale = 10.0 ** src.scale
            return lambda env: ((lambda v: (astype(xp, truediv(xp, v[0], scale), dt), v[1]))(f(env)))
        if dst.is_decimal and not src.is_decimal:
            factor = 10 ** dst.scale
            if src.is_float:
                return lambda env: ((lambda v: (astype(xp, xp.round(v[0] * factor), dt), v[1]))(f(env)))
            dfactor = const(xp, dt, factor)
            return lambda env: ((lambda v: (astype(xp, v[0], dt) * dfactor, v[1]))(f(env)))
        if src.is_decimal and dst.is_integer:
            factor = const(xp, np.int64, 10 ** src.scale)
            return lambda env: ((lambda v: (astype(xp, _trunc_div(xp, v[0], factor), dt), v[1]))(f(env)))
        return lambda env: ((lambda v: (astype(xp, v[0], dt), v[1]))(f(env)))
    if isinstance(e, BIsNull):
        f = compile_expr(e.operand, xp)
        neg = e.negated

        def run_isnull(env):
            _, valid = f(env)
            if valid is True or valid is False:
                out = valid if neg else not valid
                return (const(xp, np.bool_, out), True)
            v = valid if neg else ~valid
            return (v, True)
        return run_isnull
    if isinstance(e, BDictRemap):
        f = compile_expr(e.operand, xp)
        mapping = xp.asarray(np.array(e.mapping, dtype=np.int32)) if e.mapping \
            else xp.asarray(np.zeros(1, np.int32) - 1)

        def run_remap(env):
            ids, valid = f(env)
            n = mapping.shape[0]
            safe = xp.clip(ids, 0, max(n - 1, 0))
            return (mapping[safe], valid)
        return run_remap
    if isinstance(e, BDictLookup):
        f = compile_expr(e.operand, xp)
        table = xp.asarray(np.array(e.table, dtype=np.int64)) if e.table \
            else xp.zeros(1, np.int64)

        def run_dictlookup(env):
            ids, valid = f(env)
            n = table.shape[0]
            safe = xp.clip(ids, 0, max(n - 1, 0))
            return (table[safe], valid)
        return run_dictlookup
    if isinstance(e, BDictMask):
        f = compile_expr(e.operand, xp)
        table = xp.asarray(np.array(e.mask, dtype=bool))

        def run_dictmask(env):
            ids, valid = f(env)
            n = table.shape[0]
            safe = xp.clip(ids, 0, max(n - 1, 0))
            return (table[safe] if n else xp.zeros_like(ids, dtype=bool), valid)
        return run_dictmask
    if isinstance(e, BMathFunc):
        return _compile_math(e, xp)
    if isinstance(e, BUnOp):
        f = compile_expr(e.operand, xp)
        if e.op == "-":
            return lambda env: ((lambda v: (-v[0], v[1]))(f(env)))
        if e.op == "not":
            # three-valued NOT: NULL stays NULL (valid mask unchanged)
            return lambda env: ((lambda v: (~v[0] if _is_bool(v[0]) else v[0] == 0, v[1]))(f(env)))
        raise AnalysisError(f"unknown unary op {e.op}")
    if isinstance(e, BCase):
        conds = [(compile_expr(c, xp), compile_expr(v, xp)) for c, v in e.whens]
        felse = compile_expr(e.else_, xp) if e.else_ is not None else None
        dt = e.type.device_dtype

        def run_case(env):
            result = None
            valid = None
            taken = None
            for fc, fv in conds:
                cv, cvalid = fc(env)
                vv, vvalid = fv(env)
                # NULL condition = branch not taken (SQL CASE semantics)
                cond = _as_bool(xp, cv) & _as_mask(xp, cvalid, cv)
                vv = astype(xp, xp.asarray(vv), dt)
                if result is None:
                    result = xp.where(cond, vv, const(xp, dt, 0))
                    valid = xp.where(cond, _as_mask(xp, vvalid, vv), False)
                    taken = cond
                else:
                    take = cond & ~taken
                    result = xp.where(take, vv, result)
                    valid = xp.where(take, _as_mask(xp, vvalid, vv), valid)
                    taken = taken | cond
            if felse is not None:
                ev, evalid = felse(env)
                ev = astype(xp, xp.asarray(ev), dt)
                result = xp.where(taken, result, ev)
                valid = xp.where(taken, valid, _as_mask(xp, evalid, ev))
            else:
                valid = valid & taken
            return (result, valid)
        return run_case
    if isinstance(e, BBinOp):
        fl = compile_expr(e.left, xp)
        fr = compile_expr(e.right, xp)
        op = e.op
        if op in ("and", "or"):
            def run_logic(env):
                lv, lvalid = fl(env)
                rv, rvalid = fr(env)
                lv = _as_bool(xp, lv)
                rv = _as_bool(xp, rv)
                lval = _as_mask(xp, lvalid, lv)
                rval = _as_mask(xp, rvalid, rv)
                if op == "and":
                    # three-valued: NULL AND false = false, NULL AND true = NULL
                    value = lv & rv
                    valid = (lval & rval) | (lval & ~lv) | (rval & ~rv)
                else:
                    # NULL OR true = true, NULL OR false = NULL
                    value = lv | rv
                    valid = (lval & rval) | (lval & lv) | (rval & rv)
                return (value, valid)
            return run_logic
        if op in ("=", "<>", "<", "<=", ">", ">="):
            fn = {"=": lambda a, b: a == b, "<>": lambda a, b: a != b,
                  "<": lambda a, b: a < b, "<=": lambda a, b: a <= b,
                  ">": lambda a, b: a > b, ">=": lambda a, b: a >= b}[op]
            return lambda env: _binary(xp, fl, fr, env, fn)
        dt = e.type.device_dtype
        if op == "+":
            return lambda env: _binary(xp, fl, fr, env, lambda a, b: astype(xp, a + b, dt))
        if op == "-":
            return lambda env: _binary(xp, fl, fr, env, lambda a, b: astype(xp, a - b, dt))
        if op == "*":
            return lambda env: _binary(xp, fl, fr, env, lambda a, b: astype(xp, a * b, dt))
        if op == "/":
            if e.type.is_float:
                return lambda env: _binary(xp, fl, fr, env,
                                           lambda a, b: astype(xp, truediv(xp, a, xp.where(b == 0, 1, b)), dt),
                                           null_if=lambda a, b: b == 0)
            return lambda env: _binary(xp, fl, fr, env,
                                       lambda a, b: astype(xp, _trunc_div(xp, a, b), dt),
                                       null_if=lambda a, b: b == 0)
        if op == "%":
            return lambda env: _binary(xp, fl, fr, env,
                                       lambda a, b: astype(xp, a - _trunc_div(xp, a, b) * b, dt),
                                       null_if=lambda a, b: b == 0)
        raise AnalysisError(f"unknown operator {op}")
    raise AnalysisError(f"cannot compile {type(e).__name__}")


def _compile_math(e, xp):
    name = e.name
    fs = [compile_expr(o, xp) for o in e.operands]
    dt = e.type.device_dtype

    if name in ("sqrt", "exp", "ln", "log10", "log2"):
        f = fs[0]
        fn = {"sqrt": lambda x: xp.sqrt(x), "exp": lambda x: xp.exp(x),
              "ln": lambda x: xp.log(x), "log10": lambda x: xp.log10(x),
              "log2": lambda x: xp.log2(x)}[name]
        # domain violations -> NULL (PostgreSQL raises; a traced kernel
        # can't, and NULL matches the sqlite oracle)
        if name == "exp":
            dom = None
        elif name == "sqrt":
            dom = lambda x: x >= 0  # noqa: E731
        else:
            dom = lambda x: x > 0  # noqa: E731

        def run_unary(env):
            v, valid = f(env)
            v = astype(xp, xp.asarray(v), np.float64)
            if dom is None:
                return (fn(v), valid)
            ok = dom(v)
            out = fn(xp.where(ok, v, 1.0))
            return (out, _as_mask(xp, valid, out) & ok)
        return run_unary
    if name == "power":
        fa, fb = fs

        def run_power(env):
            a, avalid = fa(env)
            b, bvalid = fb(env)
            a = astype(xp, xp.asarray(a), np.float64)
            b = astype(xp, xp.asarray(b), np.float64)
            # 0^negative and negative^non-integer are domain errors
            ok = ~((a == 0) & (b < 0)) & ~((a < 0) & (b != xp.floor(b)))
            out = xp.power(xp.where(ok, a, 1.0), xp.where(ok, b, 1.0))
            valid = _as_mask(xp, avalid, out) & _as_mask(xp, bvalid, out) & ok
            return (out, valid)
        return run_power
    if name in ("floor", "ceil", "round", "trunc"):
        f = fs[0]
        src_scale, digits = e.param  # operand decimal scale, round digits
        if e.operands[0].type.is_float:
            # round(double precision) breaks ties to even in PostgreSQL
            # (xp.round is half-to-even); half-away-from-zero applies
            # only to the numeric/decimal path below.
            fn = {"floor": xp.floor, "ceil": xp.ceil,
                  "round": xp.round,
                  "trunc": xp.trunc}[name]
            if digits:
                factor = const(xp, np.float64, 10.0 ** digits)
                return lambda env: ((lambda v: (fn(v[0] * factor) / factor,
                                                v[1]))(f(env)))
            return lambda env: ((lambda v: (fn(v[0]), v[1]))(f(env)))
        # decimal (scaled int64) path: exact integer arithmetic.  The
        # binder only emits this node when digits < operand scale
        # (digits >= scale is an exact rescale handled at bind time).
        drop = src_scale - max(digits, 0)
        assert drop > 0, "binder emits BMathFunc only for digits < scale"
        p = const(xp, np.int64, 10 ** drop)

        def run_dec(env):
            v, valid = f(env)
            v = xp.asarray(v)
            q = v // p                       # toward -inf
            r = v - q * p
            if name == "floor":
                out = q
            elif name == "ceil":
                out = q + (r > 0)
            elif name == "trunc":
                out = xp.where(v >= 0, q, q + (r > 0))
            else:  # round half away from zero
                qt = xp.where(v >= 0, q, q + (r > 0))   # toward zero
                rt = v - qt * p                          # remainder, sign of v
                out = qt + xp.sign(rt) * (2 * xp.abs(rt) >= p)
            return (astype(xp, out, dt), valid)
        return run_dec
    if name == "sign":
        f = fs[0]
        return lambda env: ((lambda v: (astype(xp, xp.sign(v[0]), dt), v[1]))(f(env)))
    if name in ("greatest", "least"):
        take_right = (lambda a, b: b > a) if name == "greatest" \
            else (lambda a, b: b < a)

        def run_fold(env):
            acc, acc_valid = fs[0](env)
            acc = astype(xp, xp.asarray(acc), dt)
            acc_valid = _as_mask(xp, acc_valid, acc)
            for f in fs[1:]:
                v, valid = f(env)
                v = astype(xp, xp.asarray(v), dt)
                valid = _as_mask(xp, valid, v)
                # NULLs are ignored: take the other side when one is null
                pick = valid & (~acc_valid | take_right(acc, v))
                acc = xp.where(pick, v, acc)
                acc_valid = acc_valid | valid
            return (acc, acc_valid)
        return run_fold
    raise AnalysisError(f"cannot compile math function {name}")


def _as_bool(xp, v):
    if hasattr(v, "dtype") and not _is_bool(v):
        return v != 0
    if isinstance(v, (bool, np.bool_)):
        return np.bool_(v)
    return v


def _as_mask(xp, valid, like):
    """Normalize python bool validity to an array mask matching ``like``."""
    if valid is True:
        return xp.ones_like(_as_bool(xp, like), dtype=bool) if hasattr(like, "shape") and like.shape else np.True_
    if valid is False:
        return xp.zeros_like(_as_bool(xp, like), dtype=bool) if hasattr(like, "shape") and like.shape else np.False_
    return valid


def _binary(xp, fl, fr, env, fn, null_if=None):
    lv, lvalid = fl(env)
    rv, rvalid = fr(env)
    value = fn(lv, rv)
    if lvalid is True and rvalid is True:
        valid = True
    elif lvalid is False or rvalid is False:
        valid = False
    else:
        valid = _as_mask(xp, lvalid, value) & _as_mask(xp, rvalid, value)
    if null_if is not None:
        bad = null_if(lv, rv)
        if hasattr(bad, "shape") or bad:
            valid = _as_mask(xp, valid, value) & ~bad if hasattr(bad, "shape") else (False if bad else valid)
    return (value, valid)


def predicate_mask(xp, fn, env, n_rows_like):
    """Evaluate a predicate; NULL -> false (WHERE semantics)."""
    v, valid = fn(env)
    v = _as_bool(xp, v)
    if valid is True:
        out = v
    elif valid is False:
        out = xp.zeros_like(v, dtype=bool) if hasattr(v, "shape") and v.shape else np.False_
    else:
        out = v & valid
    if not (hasattr(out, "shape") and out.shape):
        # 0-d predicate (param-only / hoisted-literal comparison): keep
        # it symbolic — bool() would fail on a traced scalar under jit
        out = xp.full(n_rows_like.shape, out) if hasattr(n_rows_like, "shape") else out
    return out
