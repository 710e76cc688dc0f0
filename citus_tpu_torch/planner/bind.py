"""Binder / semantic analysis: parser AST -> typed BoundSelect.

This is the stand-in for PostgreSQL's analyzer plus the front half of the
reference's logical planner: it resolves columns against the catalog,
types every expression, desugars (BETWEEN, IN, LIKE-over-dictionary,
text equality -> dictionary ids, decimal scale alignment), classifies
aggregates, and validates GROUP BY semantics.  The result is ready for
the worker/combine split (reference: multi_logical_optimizer.c's
WorkerExtendedOpNode/MasterExtendedOpNode construction).
"""

from __future__ import annotations

import decimal
import re
from dataclasses import dataclass, field
from typing import Optional

from citus_tpu_torch import types as T
from citus_tpu_torch.catalog import Catalog, TableMeta
from citus_tpu_torch.errors import AnalysisError, UnsupportedFeatureError
from citus_tpu_torch.planner import ast_nodes as A
from citus_tpu_torch.planner.bound import (
    BAggRef, BBinOp, BCase, BCast, BColumn, BDateTrunc, BDateTruncCivil,
    BDictMask, BExpr, BExtract, BIsNull, BKeyRef, BLiteral, BScale, BUnOp,
    referenced_columns,
)

AGG_FUNCS = {"sum", "count", "avg", "min", "max"}


@dataclass(frozen=True)
class AggSpec:
    kind: str              # sum | count | count_star | avg | min | max | registry name
    arg: Optional[BExpr]   # None for count_star
    out_type: T.ColumnType
    distinct: bool = False
    # extra aggregate parameter (percentile fraction, string_agg
    # delimiter + dictionary source, ...) — hashable for dedup
    param: object = None


@dataclass
class BoundSelect:
    table: TableMeta
    filter: Optional[BExpr]
    group_keys: list[BExpr]
    aggs: list[AggSpec]
    # grouped/agg query: final_exprs over BKeyRef/BAggRef (host combine phase)
    # plain query: final_exprs over columns (device projection)
    final_exprs: list[BExpr]
    output_names: list[str]
    having: Optional[BExpr]
    order_by: list[tuple[int, bool, Optional[bool]]]  # (output index, asc, nulls_first)
    limit: Optional[int]
    offset: Optional[int]
    distinct: bool
    # trailing final_exprs appended only for ORDER BY on non-output
    # expressions; trimmed from the result after sorting
    hidden_outputs: int = 0
    # parameterized plan: per-$N (ColumnType, text_source|None); values
    # arrive at execute time as 0-d env arrays (deferred pruning)
    param_specs: list = field(default_factory=list)

    @property
    def has_aggs(self) -> bool:
        return bool(self.aggs) or bool(self.group_keys)

    @property
    def scan_columns(self) -> list[str]:
        cols: set[str] = set()
        for e in [self.filter, *self.group_keys, *(a.arg for a in self.aggs if a.arg is not None)]:
            if e is not None:
                cols.update(referenced_columns(e))
        for a in self.aggs:
            # ordered aggregates carry sort-key expressions in param
            if isinstance(a.param, tuple) and len(a.param) >= 4 \
                    and isinstance(a.param[2], tuple):
                for e in a.param[2]:
                    if isinstance(e, BExpr):
                        cols.update(referenced_columns(e))
        if not self.has_aggs:
            for e in self.final_exprs:
                cols.update(referenced_columns(e))
        # a uuid column always scans with its low int64 lane (projection
        # and grouping recombine the pair); lane refs from rewritten
        # filters pass through unchanged
        return sorted(self.table.schema.physical_names(sorted(cols)))


def _like_to_regex(pattern: str) -> "re.Pattern":
    out = []
    for ch in pattern:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return re.compile("^" + "".join(out) + "$", re.DOTALL)


def rewrite_agg_filter(e: A.FuncCall) -> A.FuncCall:
    """agg(x) FILTER (WHERE f) -> agg(CASE WHEN f THEN x END): every
    supported aggregate ignores NULL inputs, so masking the value
    argument is exactly the reference's filter semantics (PostgreSQL
    evaluates FILTER before the transition function)."""
    import dataclasses
    f = e.filter
    if e.name == "count" and (not e.args or isinstance(e.args[0], A.Star)):
        new_args = (A.CaseExpr(((f, A.Literal(1, "int")),), None),)
        return dataclasses.replace(e, args=new_args, filter=None)
    if not e.args:
        raise AnalysisError(f"{e.name}() requires an argument")
    # ordered-set aggregates carry the value expression last
    vi = len(e.args) - 1 if e.name in (
        "percentile_cont", "percentile_disc", "approx_percentile") else 0
    args = list(e.args)
    args[vi] = A.CaseExpr(((f, args[vi]),), None)
    return dataclasses.replace(e, args=tuple(args), filter=None)


class Binder:
    """Resolves expressions against a range table of (alias, TableMeta).

    Single-relation queries use bare column names as environment keys;
    multi-relation (join) queries use qualified ``alias.column`` keys so
    two relations' same-named columns never collide.
    """

    def __init__(self, catalog: Catalog, table: TableMeta,
                 rels: Optional[list[tuple[str, TableMeta]]] = None):
        self.catalog = catalog
        self.table = table
        self.rels = rels or [(table.name, table)]
        self.qualified = len(self.rels) > 1
        # $N parameter slots: 0-based index -> (ColumnType, text_source)
        # populated by infer_param_types before a parameterized bind
        self.param_types: dict[int, tuple] = {}
        # (key_map, aggs) while binding scalar-function arguments in a
        # grouped query's select list: lets round(avg(x), 2) resolve the
        # nested aggregate to a BAggRef and group-key references to
        # BKeyRef (PostgreSQL allows arbitrary expressions over
        # aggregates/keys above the Agg node)
        self._agg_ctx = None

    def resolve_column(self, name: str, rel_alias: Optional[str] = None):
        """-> (env_key, Column, alias, TableMeta)."""
        if rel_alias is not None:
            for alias, t in self.rels:
                if alias == rel_alias:
                    col = t.schema.column(name)
                    key = f"{alias}.{name}" if self.qualified else name
                    return key, col, alias, t
            raise AnalysisError(f"unknown relation alias {rel_alias!r}")
        hits = [(alias, t) for alias, t in self.rels if t.schema.has(name)]
        if not hits:
            raise AnalysisError(f"column {name!r} does not exist")
        if len(hits) > 1:
            raise AnalysisError(f"column reference {name!r} is ambiguous")
        alias, t = hits[0]
        key = f"{alias}.{name}" if self.qualified else name
        return key, t.schema.column(name), alias, t

    def _text_words(self, target):
        """Resolve a text expression that is a BColumn or a chain of
        BDictRemap transforms over one: -> (base column, table, column,
        effective word per base dictionary id) or None.  This is what
        lets string functions compose (upper(trim(s))): each wrapper's
        mapping applies to the bind-time word table, and the final remap
        is expressed over the base column's ids."""
        from citus_tpu_torch.planner.bound import BDictRemap
        chain = []
        base = target
        while isinstance(base, BDictRemap):
            chain.append(base.mapping)
            base = base.operand
        if not (isinstance(base, BColumn) and base.type.is_text):
            return None
        tname, cname = self.text_source(base)
        words = self.catalog.dictionary(tname, cname)
        eff = list(range(len(words)))
        for mapping in reversed(chain):  # innermost transform first
            eff = [mapping[i] if i < len(mapping) else i for i in eff]
        return base, tname, cname, [words[i] for i in eff]

    def enum_info(self, target):
        """BARE enum-typed column -> (base column, type name, labels,
        dictionary words) or None.  A string-function remap over an enum
        column (upper(s), ...) produces plain text, not enum values —
        it must NOT get declaration-rank semantics."""
        if not (isinstance(target, BColumn) and target.type.is_text):
            return None
        tname, cname = self.text_source(target)
        type_name = self.catalog.enum_columns.get(f"{tname}.{cname}")
        if type_name is None:
            return None
        labels = list(self.catalog.types.get(type_name, ()))
        words = self.catalog.dictionary(tname, cname)
        return target, type_name, labels, words

    @staticmethod
    def enum_rank_lut(info) -> tuple:
        """(enum_info) -> per-dictionary-id declaration rank table."""
        _base, _type_name, labels, words = info
        rank_of = {w: i for i, w in enumerate(labels)}
        return tuple(rank_of.get(w, -1) for w in words)

    def enum_rank(self, target) -> Optional[BExpr]:
        """Enum column -> its declaration-order rank (int64), via a
        per-dictionary-id lookup table (reference: enum comparisons use
        enumsortorder, not label text)."""
        from citus_tpu_torch.planner.bound import BDictLookup
        info = self.enum_info(target)
        if info is None:
            return None
        return BDictLookup(info[0], self.enum_rank_lut(info))

    def _try_enum_ordered(self, op: str, left: BExpr,
                          right: BExpr) -> Optional[BExpr]:
        """Ordered comparison where a side is an enum column: compare
        declaration-order ranks.  Literal labels validate against the
        type; mismatched enum types reject."""
        linfo = self.enum_info(left) if left.type.is_text else None
        rinfo = self.enum_info(right) if right.type.is_text else None
        if linfo is None and rinfo is None:
            return None

        def side(e, info, other_info):
            if info is not None:
                return self.enum_rank(e), info[1]
            if isinstance(e, BLiteral) and isinstance(e.value, str):
                _b, type_name, labels, _w = other_info
                if e.value not in labels:
                    raise AnalysisError(
                        f"invalid input value for enum {type_name}: "
                        f"{e.value!r}")
                return BLiteral(labels.index(e.value), T.INT64_T), type_name
            return None, None

        lr, lt_name = side(left, linfo, rinfo)
        rr, rt_name = side(right, rinfo, linfo)
        if lr is None or rr is None:
            return None
        if lt_name != rt_name:
            raise AnalysisError(
                f"cannot compare enum types {lt_name} and {rt_name}")
        return BBinOp(op, lr, rr, T.BOOL_T)

    def _remap_text(self, fname: str, target, op):
        """Bind a string function as a dictionary remap on the base
        column (composable with other remap-family functions).  String
        literals constant-fold."""
        from citus_tpu_torch.planner.bound import BDictRemap
        if isinstance(target, BLiteral) and isinstance(target.value, str):
            return BLiteral(op(target.value), target.type)
        resolved = self._text_words(target)
        if resolved is None:
            raise UnsupportedFeatureError(
                f"{fname}() requires a text column (or a string function "
                "over one)")
        base, tname, cname, eff_words = resolved
        out_words = [op(w) for w in eff_words]
        mapping = tuple(int(x) for x in self.catalog.encode_strings(
            tname, cname, out_words))
        return BDictRemap(base, mapping)

    def text_source(self, bcol: BColumn) -> tuple[str, str]:
        """Env key of a text column -> (table_name, column_name)."""
        if "." in bcol.name:
            alias, col = bcol.name.split(".", 1)
            for a, t in self.rels:
                if a == alias:
                    return t.name, col
            raise AnalysisError(f"unknown alias {alias!r}")
        return self.table.name, bcol.name

    # ---------------------------------------------------------------- expr
    def bind_scalar(self, e: A.Expr, allow_agg: bool = False) -> BExpr:
        if isinstance(e, A.ColumnRef):
            key, col, _, _ = self.resolve_column(e.name, e.table)
            b = BColumn(key, col.type)
            if self._agg_ctx is not None:
                idx = self._agg_ctx[0].get(b)
                if idx is not None:
                    return BKeyRef(idx, b.type)
            return b
        if isinstance(e, A.Param):
            from citus_tpu_torch.planner.bound import BParam
            spec = self.param_types.get(e.index - 1)
            if spec is None:
                raise UnsupportedFeatureError(
                    f"cannot infer a type for parameter ${e.index}; "
                    "bind it by comparing against a typed column")
            return BParam(e.index - 1, spec[0])
        if isinstance(e, A.Literal):
            return self._bind_literal(e)
        if isinstance(e, A.UnOp):
            inner = self.bind_scalar(e.operand, allow_agg)
            if e.op == "-":
                if not inner.type.is_numeric:
                    raise AnalysisError(f"cannot negate {inner.type}")
                return BUnOp("-", inner, inner.type)
            if e.op == "not":
                return BUnOp("not", self._to_bool(inner), T.BOOL_T)
        if isinstance(e, A.BinOp):
            return self._bind_binop(e, allow_agg)
        if isinstance(e, A.Between):
            lo = A.BinOp(">=", e.expr, e.lo)
            hi = A.BinOp("<=", e.expr, e.hi)
            both = A.BinOp("and", lo, hi)
            return self.bind_scalar(A.UnOp("not", both) if e.negated else both, allow_agg)
        if isinstance(e, A.InList):
            return self._bind_in(e, allow_agg)
        if isinstance(e, A.IsNull):
            return BIsNull(self.bind_scalar(e.expr, allow_agg), e.negated)
        if isinstance(e, A.Cast):
            inner = self.bind_scalar(e.expr, allow_agg)
            target = T.type_from_sql(e.type_name, list(e.type_args) or None)
            if target.kind == T.UUID:
                if isinstance(inner, BLiteral) \
                        and isinstance(inner.value, str):
                    # typed literal: uuid '...' folds to its 128-bit int
                    return BLiteral(target.to_physical(inner.value), target)
                if inner.type.kind == T.UUID:
                    return inner
                raise UnsupportedFeatureError(
                    "cast to uuid requires a uuid value or string literal")
            if target.is_text:
                if isinstance(inner, BLiteral) \
                        and isinstance(inner.value, str):
                    # typed literal of a dictionary kind (uuid '...'):
                    # stays a string until _align coerces it into the
                    # column's dictionary-id space (normalized there)
                    return BLiteral(inner.value, target)
                raise UnsupportedFeatureError("cast to text not supported")
            if target.kind in (T.DATE, T.TIMESTAMP, T.TIMESTAMPTZ,
                               T.TIME, T.INTERVAL) \
                    and isinstance(inner, BLiteral) \
                    and isinstance(inner.value, str):
                # typed literal: date '1998-12-01' folds at bind time
                try:
                    return BLiteral(target.to_physical(inner.value), target)
                except (ValueError, TypeError):
                    raise AnalysisError(
                        f"invalid input syntax for type {e.type_name}: "
                        f"{inner.value!r}")
            return BCast(inner, target)
        if isinstance(e, A.CaseExpr):
            return self._bind_case(e, allow_agg)
        if isinstance(e, A.FuncCall):
            return self._bind_func(e, allow_agg)
        raise AnalysisError(f"cannot bind expression {e}")

    def _bind_literal(self, e: A.Literal) -> BLiteral:
        v = e.value
        if v is None:
            return BLiteral(None, T.INT64_T)
        if e.type_name == "int":
            return BLiteral(int(v), T.INT64_T)
        if e.type_name == "decimal":
            d = v if isinstance(v, decimal.Decimal) else decimal.Decimal(str(v))
            scale = max(0, -d.as_tuple().exponent)
            t = T.decimal_t(38, scale)
            return BLiteral(t.to_physical(d), t)
        if e.type_name == "float":
            return BLiteral(float(v), T.FLOAT64_T)
        if e.type_name == "bool":
            return BLiteral(1 if v else 0, T.BOOL_T)
        if e.type_name == "string":
            # untyped until coerced against the other side of a comparison
            return BLiteral(v, T.TEXT_T)
        if e.type_name == "array":
            # stays a Python list until _align coerces it into an array
            # column's dictionary-id space (canonical JSON word)
            return BLiteral(list(v), T.array_t())
        raise AnalysisError(f"bad literal {e}")

    def _coerce_string_literal(self, lit: BLiteral, target: T.ColumnType,
                               column: Optional[BColumn]) -> BLiteral:
        """'1994-01-01' vs date column, 'AIR' vs text column, etc."""
        if target.kind in (T.DATE, T.TIMESTAMP, T.TIMESTAMPTZ, T.TIME,
                           T.INTERVAL):
            return BLiteral(target.to_physical(lit.value), target)
        if target.kind == T.UUID:
            # dictionary bypass: the literal folds to its 128-bit integer;
            # _bind_uuid_compare splits it into int64 lane literals
            return BLiteral(target.to_physical(lit.value), target)
        if target.is_text:
            if column is None:
                raise AnalysisError("cannot compare two string literals from different tables")
            tname, cname = self.text_source(column)
            did = self.catalog.lookup_string_id(tname, cname, lit.value)
            # unseen string: id -1 never matches any row
            return BLiteral(-1 if did is None else did, T.TEXT_T)
        if target.is_numeric:
            d = decimal.Decimal(lit.value)
            scale = max(0, -d.as_tuple().exponent)
            t = T.decimal_t(38, scale) if scale else T.INT64_T
            return BLiteral(t.to_physical(d), t)
        raise AnalysisError(f"cannot coerce string literal to {target}")

    def _align(self, left: BExpr, right: BExpr) -> tuple[BExpr, BExpr]:
        """Insert scale/cast adjustments so both sides share physical space."""
        lt, rt = left.type, right.type
        # string literal coercion
        if isinstance(right, BLiteral) and rt.is_text and not lt.is_text \
                and isinstance(right.value, str):
            right = self._coerce_string_literal(right, lt, None)
            rt = right.type
        if isinstance(left, BLiteral) and lt.is_text and not rt.is_text \
                and isinstance(left.value, str):
            left = self._coerce_string_literal(left, rt, None)
            lt = left.type
        if lt.is_text and rt.is_text:
            def text_base(e):
                from citus_tpu_torch.planner.bound import BDictRemap
                while isinstance(e, BDictRemap):
                    e = e.operand  # remapped ids live in the base dictionary
                return e if isinstance(e, BColumn) else None
            col = text_base(left) or text_base(right)
            if isinstance(right, BLiteral) \
                    and isinstance(right.value, (str, list, bytes)):
                right = self._coerce_string_literal(right, lt, col)
            elif isinstance(left, BLiteral) \
                    and isinstance(left.value, (str, list, bytes)):
                left = self._coerce_string_literal(left, rt, col)
            elif isinstance(left, BColumn) and isinstance(right, BColumn):
                lsrc = self.text_source(left)
                rsrc = self.text_source(right)
                if lsrc != rsrc:
                    # different dictionaries: re-encode the right side into
                    # the left dictionary's id space
                    from citus_tpu_torch.planner.bound import BDictRemap
                    lwords = self.catalog.dictionary(*lsrc)
                    lindex = {w: i for i, w in enumerate(lwords)}
                    rwords = self.catalog.dictionary(*rsrc)
                    mapping = tuple(lindex.get(w, -1) for w in rwords)
                    right = BDictRemap(right, mapping)
            return left, right
        # mixed decimal/float: the decimal side must leave scaled-int space
        if lt.is_float and rt.is_decimal:
            right = BCast(right, T.FLOAT64_T)
            rt = right.type
        elif rt.is_float and lt.is_decimal:
            left = BCast(left, T.FLOAT64_T)
            lt = left.type
        # decimal scale alignment (comparisons, +, -)
        ls = lt.scale if lt.is_decimal else 0
        rs = rt.scale if rt.is_decimal else 0
        if (lt.is_decimal or rt.is_decimal) and not (lt.is_float or rt.is_float):
            if ls < rs:
                left = self._rescale(left, rs)
            elif rs < ls:
                right = self._rescale(right, ls)
        return left, right

    def _rescale(self, e: BExpr, scale: int) -> BExpr:
        cur = e.type.scale if e.type.is_decimal else 0
        t = T.decimal_t(38, scale)
        if isinstance(e, BLiteral):
            if e.value is None:
                return BLiteral(None, t)
            return BLiteral(int(e.value) * 10 ** (scale - cur), t)
        return BScale(e, scale - cur, t)

    def _to_bool(self, e: BExpr) -> BExpr:
        if e.type.kind != T.BOOL:
            raise AnalysisError(f"expected boolean expression, got {e.type}")
        return e

    def _bind_interval_arith(self, e: A.BinOp, allow_agg: bool) -> BExpr:
        """date/timestamp ± INTERVAL.  Literal dates fold; expressions
        lower to civil month addition (BAddMonths) plus fixed-width
        day/microsecond offsets.  A DATE result stays DATE when the
        interval has no sub-day component (the reference promotes to
        timestamp; for comparisons at midnight the value is identical)."""
        from citus_tpu_torch.planner.bound import BAddMonths, py_add_interval
        if e.op not in ("+", "-"):
            raise UnsupportedFeatureError(
                f"operator {e.op} is not defined for intervals")
        if isinstance(e.left, A.IntervalLiteral):
            if isinstance(e.right, A.IntervalLiteral) or e.op != "+":
                raise UnsupportedFeatureError(
                    "interval arithmetic supports date/timestamp ± interval")
            ivl, other_ast = e.left, e.right
        else:
            ivl, other_ast = e.right, e.left
        sign = 1 if e.op == "+" else -1
        other = self.bind_scalar(other_ast, allow_agg)
        if other.type.kind not in (T.DATE, T.TIMESTAMP, T.TIMESTAMPTZ):
            raise AnalysisError(
                f"cannot add interval to {other.type}")
        months = sign * ivl.months
        days = sign * ivl.days
        micros = sign * ivl.micros
        if other.type.kind == T.DATE and micros:
            raise UnsupportedFeatureError(
                "sub-day intervals on date values are not supported")
        if isinstance(other, BLiteral):
            if other.value is None:
                return other
            v = other.type.from_physical(other.value)
            out = py_add_interval(v, months, days, micros)
            return BLiteral(other.type.to_physical(out), other.type)
        result: BExpr = other
        if months:
            result = BAddMonths(result, months, other.type)
        if other.type.kind == T.DATE:
            if days:
                result = BBinOp("+", result, BLiteral(days, T.INT64_T),
                                other.type)
        else:
            total = days * 86_400_000_000 + micros
            if total:
                result = BBinOp("+", result, BLiteral(total, T.INT64_T),
                                other.type)
        return result

    def _bind_binop(self, e: A.BinOp, allow_agg: bool) -> BExpr:
        op = e.op
        if isinstance(e.left, A.IntervalLiteral) \
                or isinstance(e.right, A.IntervalLiteral):
            # against an INTERVAL-typed expression the literal is just a
            # microsecond scalar (comparisons, +, -); month components
            # have no fixed us length and stay in the civil-arithmetic
            # path below
            lit = e.left if isinstance(e.left, A.IntervalLiteral) else e.right
            other_ast = e.right if lit is e.left else e.left
            if not isinstance(other_ast, A.IntervalLiteral):
                try:
                    other = self.bind_scalar(other_ast, allow_agg)
                except AnalysisError:
                    other = None
                if other is not None and other.type.kind == T.INTERVAL \
                        and lit.months == 0:
                    us = lit.days * 86_400_000_000 + lit.micros
                    blit = BLiteral(us, T.INTERVAL_T)
                    left, right = (blit, other) if lit is e.left \
                        else (other, blit)
                    if op in ("=", "<>", "<", "<=", ">", ">="):
                        return BBinOp(op, left, right, T.BOOL_T)
                    rt = T.arith_result_type(op, left.type, right.type)
                    return BBinOp(op, left, right, rt)
            return self._bind_interval_arith(e, allow_agg)
        left = self.bind_scalar(e.left, allow_agg)
        right = self.bind_scalar(e.right, allow_agg)
        if op in ("and", "or"):
            return BBinOp(op, self._to_bool(left), self._to_bool(right), T.BOOL_T)
        if op in ("<", "<=", ">", ">=") \
                and (left.type.is_text or right.type.is_text):
            # enum columns order by declaration rank (before _align
            # coerces the literal side into dictionary-id space)
            enum_cmp = self._try_enum_ordered(op, left, right)
            if enum_cmp is not None:
                return enum_cmp
        left, right = self._align(left, right)
        if op in ("=", "<>", "<", "<=", ">", ">=") \
                and (left.type.kind == T.UUID or right.type.kind == T.UUID):
            return self._bind_uuid_compare(op, left, right)
        if op in ("=", "<>", "<", "<=", ">", ">="):
            if left.type.is_text and op not in ("=", "<>"):
                raise UnsupportedFeatureError("ordered comparison on text columns")
            if not left.type.is_text and not right.type.is_numeric and left.type.kind != right.type.kind:
                raise AnalysisError(f"cannot compare {left.type} and {right.type}")
            return BBinOp(op, left, right, T.BOOL_T)
        out = T.arith_result_type(op, left.type, right.type)
        if op in ("+", "-") and out.is_decimal:
            # operands already aligned to out.scale
            out = T.decimal_t(38, max(left.type.scale if left.type.is_decimal else 0,
                                      right.type.scale if right.type.is_decimal else 0))
        return BBinOp(op, left, right, out)

    def _uuid_lane_exprs(self, e: BExpr) -> tuple[BExpr, BExpr]:
        """uuid-typed operand -> (hi, lo) int64 lane expressions.  The
        base column stream carries the high 64 bits; the companion
        "<name>::lo" stream carries the low 64."""
        from citus_tpu_torch.planner.bound import BParam
        if isinstance(e, BColumn):
            return (BColumn(e.name, T.INT64_T),
                    BColumn(T.uuid_lane_name(e.name), T.INT64_T))
        if isinstance(e, BLiteral):
            if e.value is None:
                return BLiteral(None, T.INT64_T), BLiteral(None, T.INT64_T)
            hi, lo = T.uuid_int_to_lanes(int(e.value))
            return BLiteral(hi, T.INT64_T), BLiteral(lo, T.INT64_T)
        if isinstance(e, BParam):
            return (BParam(e.index, T.INT64_T),
                    BParam(e.index, T.INT64_T, lane=T.UUID_LANE_SUFFIX))
        raise UnsupportedFeatureError(
            f"uuid comparison over {type(e).__name__} not supported")

    def _bind_uuid_compare(self, op: str, left: BExpr,
                           right: BExpr) -> BExpr:
        """uuid comparisons lower onto the two int64 lane streams (the
        dictionary-bypass path): equality is lane-wise AND; ordering is
        lexicographic on (hi, lo) — the offset-binary lane encoding
        makes signed int64 order match unsigned 128-bit order."""
        if left.type.kind != T.UUID or right.type.kind != T.UUID:
            raise AnalysisError(
                f"cannot compare {left.type} and {right.type}")
        lh, ll = self._uuid_lane_exprs(left)
        rh, rl = self._uuid_lane_exprs(right)

        def eq(a, b):
            return BBinOp("=", a, b, T.BOOL_T)

        if op == "=":
            return BBinOp("and", eq(lh, rh), eq(ll, rl), T.BOOL_T)
        if op == "<>":
            return BBinOp("or", BBinOp("<>", lh, rh, T.BOOL_T),
                          BBinOp("<>", ll, rl, T.BOOL_T), T.BOOL_T)
        strict = "<" if op in ("<", "<=") else ">"
        return BBinOp(
            "or", BBinOp(strict, lh, rh, T.BOOL_T),
            BBinOp("and", eq(lh, rh), BBinOp(op, ll, rl, T.BOOL_T),
                   T.BOOL_T),
            T.BOOL_T)

    def _bind_in(self, e: A.InList, allow_agg: bool) -> BExpr:
        target = self.bind_scalar(e.expr, allow_agg)
        if target.type.is_text and isinstance(target, BColumn):
            words = self.catalog.dictionary(*self.text_source(target))
            values = {it.value for it in e.items if isinstance(it, A.Literal)}
            if len(values) != len(e.items):
                raise UnsupportedFeatureError("non-literal IN items on text")
            mask = [w in values for w in words]
            out: BExpr = BDictMask(target, tuple(mask))
            return BUnOp("not", out, T.BOOL_T) if e.negated else out
        parts = None
        for item in e.items:
            eq = self._bind_binop(A.BinOp("=", e.expr, item), allow_agg)
            parts = eq if parts is None else BBinOp("or", parts, eq, T.BOOL_T)
        if parts is None:
            parts = BLiteral(0, T.BOOL_T)
        return BUnOp("not", parts, T.BOOL_T) if e.negated else parts

    def _bind_case_from_bound(self, whens, else_, out: T.ColumnType) -> BExpr:
        """CASE over already-bound branches with scale alignment."""
        if out.is_decimal:
            whens = tuple(
                (c, self._rescale(v, out.scale)
                 if (v.type.is_decimal or v.type.is_integer) else v)
                for c, v in whens)
            if else_ is not None and (else_.type.is_decimal or else_.type.is_integer):
                else_ = self._rescale(else_, out.scale)
        return BCase(tuple(whens), else_, out)

    def _bind_case(self, e: A.CaseExpr, allow_agg: bool) -> BExpr:
        whens = [(self._to_bool(self.bind_scalar(c, allow_agg)), self.bind_scalar(v, allow_agg))
                 for c, v in e.whens]
        else_ = self.bind_scalar(e.else_, allow_agg) if e.else_ is not None else None
        result_types = [v.type for _, v in whens] + ([else_.type] if else_ is not None else [])
        out = result_types[0]
        for t in result_types[1:]:
            out = T.common_super_type(out, t)
        # align decimal scales of branches
        if out.is_decimal:
            whens = [(c, self._rescale(v, out.scale) if v.type.is_decimal or v.type.is_integer else v)
                     for c, v in whens]
            if else_ is not None and (else_.type.is_decimal or else_.type.is_integer):
                else_ = self._rescale(else_, out.scale)
        return BCase(tuple(whens), else_, out)

    def _bind_func(self, e: A.FuncCall, allow_agg: bool) -> BExpr:
        name = e.name
        if self._agg_ctx is not None:
            from citus_tpu_torch.planner.aggregates import AGG_REGISTRY
            if name in AGG_FUNCS or name in AGG_REGISTRY:
                return self._bind_agg_call(e, self._agg_ctx[1])
        if name in AGG_FUNCS:
            raise AnalysisError(f"aggregate {name}() not allowed here")
        if e.filter is not None:
            raise AnalysisError(
                f"FILTER specified, but {name}() is not an aggregate "
                "function")
        if name in ("like", "ilike"):
            target = self.bind_scalar(e.args[0], allow_agg)
            pat = e.args[1]
            resolved = self._text_words(target) \
                if target.type.is_text else None
            if not (resolved is not None and isinstance(pat, A.Literal)
                    and isinstance(pat.value, str)):
                raise UnsupportedFeatureError(
                    "LIKE requires a text column (or string function over "
                    "one) and a literal pattern")
            base, _t, _c, eff_words = resolved
            rx = _like_to_regex(pat.value.lower() if name == "ilike"
                                else pat.value)
            # pattern evaluates against the TRANSFORMED word per base id
            if name == "ilike":
                return BDictMask(base, tuple(bool(rx.match(w.lower()))
                                             for w in eff_words))
            return BDictMask(base, tuple(bool(rx.match(w)) for w in eff_words))
        if name in ("current_date", "current_timestamp", "now"):
            import datetime as _dt
            if name == "current_date":
                return BLiteral(T.DATE_T.to_physical(_dt.date.today()),
                                T.DATE_T)
            return BLiteral(T.TIMESTAMP_T.to_physical(_dt.datetime.now()),
                            T.TIMESTAMP_T)
        if name == "date_trunc":
            if len(e.args) != 2 or not isinstance(e.args[0], A.Literal):
                raise AnalysisError("date_trunc(unit, expr) expects a literal unit")
            unit = str(e.args[0].value)
            inner = self.bind_scalar(e.args[1], allow_agg)
            if inner.type.kind not in (T.DATE, T.TIMESTAMP, T.TIMESTAMPTZ):
                raise AnalysisError("date_trunc expects date/timestamp")
            if unit in ("month", "quarter", "year"):
                return BDateTruncCivil(unit, inner, inner.type)
            return BDateTrunc(unit, inner, inner.type)
        if name == "extract":
            field = str(e.args[0].value).lower()
            inner = self.bind_scalar(e.args[1], allow_agg)
            if inner.type.kind not in (T.DATE, T.TIMESTAMP, T.TIMESTAMPTZ):
                raise AnalysisError("EXTRACT expects date/timestamp")
            return BExtract(field, inner)
        if name in ("upper", "lower"):
            target = self.bind_scalar(e.args[0], allow_agg)
            fn = str.upper if name == "upper" else str.lower
            return self._remap_text(name, target, fn)
        if name == "substring":
            target = self.bind_scalar(e.args[0], allow_agg)
            if not all(isinstance(a, A.Literal) for a in e.args[1:]):
                raise UnsupportedFeatureError("substring() bounds must be literals")
            start = int(e.args[1].value) if len(e.args) > 1 else 1
            ln = int(e.args[2].value) if len(e.args) > 2 else None
            i0 = max(start - 1, 0)
            return self._remap_text(
                name, target,
                lambda w: (w[i0:i0 + ln] if ln is not None else w[i0:]))
        if name == "concat":
            bound = [self.bind_scalar(a, allow_agg) for a in e.args]
            texts = [x for x in bound
                     if x.type.is_text and not isinstance(x, BLiteral)]
            if len(texts) != 1 or not all(
                    (isinstance(x, BLiteral) and isinstance(x.value, str)) or x is texts[0]
                    for x in bound):
                raise UnsupportedFeatureError(
                    "concat() supports one text expression plus string literals")
            def cat_op(w, _parts=bound, _t=texts[0]):
                return "".join(x.value if isinstance(x, BLiteral) else w
                               for x in _parts)
            return self._remap_text(name, texts[0], cat_op)
        if name in ("length", "char_length"):
            target = self.bind_scalar(e.args[0], allow_agg)
            from citus_tpu_torch.planner.bound import BDictLookup
            resolved = self._text_words(target)
            if resolved is None:
                raise UnsupportedFeatureError("length() requires a text column")
            base, _, _, eff_words = resolved
            lut = tuple(len(w) for w in eff_words)
            # lookup table indexes by the BASE column's ids
            return BDictLookup(base, lut)
        if name in ("trim", "btrim", "ltrim", "rtrim", "replace", "left",
                    "right", "initcap", "reverse"):
            # dictionary-remap family: apply the python string op to every
            # dictionary word once at bind time; rows keep their ids
            target = self.bind_scalar(e.args[0], allow_agg)
            extras = []
            for a in e.args[1:]:
                lit = self.bind_scalar(a, allow_agg)
                if isinstance(lit, BUnOp) and lit.op == "-" \
                        and isinstance(lit.operand, BLiteral):
                    lit = BLiteral(-lit.operand.value, lit.type)
                if not isinstance(lit, BLiteral):
                    raise UnsupportedFeatureError(
                        f"{name}() extra arguments must be literals")
                extras.append(lit.value)
            if name in ("trim", "btrim"):
                chars = str(extras[0]) if extras else None
                op = lambda w: w.strip(chars)  # noqa: E731
            elif name == "ltrim":
                chars = str(extras[0]) if extras else None
                op = lambda w: w.lstrip(chars)  # noqa: E731
            elif name == "rtrim":
                chars = str(extras[0]) if extras else None
                op = lambda w: w.rstrip(chars)  # noqa: E731
            elif name == "replace":
                if len(extras) != 2:
                    raise AnalysisError("replace() requires (text, from, to)")
                frm, to = str(extras[0]), str(extras[1])
                op = lambda w: w.replace(frm, to)  # noqa: E731
            elif name == "left":
                n_ = int(extras[0])
                op = lambda w: w[:n_]  # noqa: E731  (negative: drop from end)
            elif name == "right":
                n_ = int(extras[0])
                # right(w, n): last n chars; negative drops from the front
                op = (lambda w: w[max(0, len(w) - n_):]) if n_ >= 0 \
                    else (lambda w: w[-n_:])  # noqa: E731
            elif name == "initcap":
                op = lambda w: w.title()  # noqa: E731
            else:  # reverse
                op = lambda w: w[::-1]  # noqa: E731
            return self._remap_text(name, target, op)
        if name == "coalesce":
            if not e.args:
                raise AnalysisError("coalesce() requires arguments")
            bound = [self.bind_scalar(a, allow_agg) for a in e.args]
            # text branches: encode raw string literals into the dictionary
            # of the first text column argument
            text_col = next((x for x in bound
                             if isinstance(x, BColumn) and x.type.is_text), None)
            if text_col is not None:
                tname, cname = self.text_source(text_col)
                bound = [BLiteral(int(self.catalog.encode_strings(
                             tname, cname, [x.value])[0]), T.TEXT_T)
                         if isinstance(x, BLiteral) and isinstance(x.value, str)
                         else x for x in bound]
            out = bound[0].type
            for x in bound[1:]:
                out = T.common_super_type(out, x.type)
            whens = tuple((BIsNull(x, negated=True), x) for x in bound[:-1])
            return self._bind_case_from_bound(whens, bound[-1], out)
        if name == "nullif":
            if len(e.args) != 2:
                raise AnalysisError("nullif() requires two arguments")
            a = self.bind_scalar(e.args[0], allow_agg)
            bdy = self.bind_scalar(e.args[1], allow_agg)
            a2, b2 = self._align(a, bdy)
            cond = BBinOp("=", a2, b2, T.BOOL_T)
            return BCase(((cond, BLiteral(None, a.type)),), a, a.type)
        if name == "abs":
            inner = self.bind_scalar(e.args[0], allow_agg)
            return BCase(((BBinOp("<", inner, BLiteral(0, T.INT64_T) if not inner.type.is_float
                                  else BLiteral(0.0, T.FLOAT64_T), T.BOOL_T),
                           BUnOp("-", inner, inner.type)),), inner, inner.type)
        bound_math = self._bind_math_func(name, e, allow_agg)
        if bound_math is not None:
            return bound_math
        raise UnsupportedFeatureError(f"function {name}() not supported")

    def _bind_math_func(self, name: str, e: A.FuncCall,
                        allow_agg: bool) -> Optional[BExpr]:
        """PostgreSQL's scalar math surface (float.c / numeric.c):
        floor/ceil/round/trunc are exact on the decimal scaled-int
        representation; transcendentals go through float64."""
        from citus_tpu_torch.planner.bound import BMathFunc

        def to_f(x: BExpr) -> BExpr:
            return x if x.type.is_float else BCast(x, T.FLOAT64_T)

        def literal_int(a: A.Expr, what: str) -> int:
            lit = self.bind_scalar(a, allow_agg)
            if isinstance(lit, BUnOp) and lit.op == "-" \
                    and isinstance(lit.operand, BLiteral):
                lit = BLiteral(-lit.operand.value, lit.type)
            if not isinstance(lit, BLiteral) or lit.value is None:
                raise UnsupportedFeatureError(f"{what} must be a literal")
            return int(lit.value)

        if name in ("floor", "ceil", "ceiling", "round", "trunc"):
            fname = "ceil" if name == "ceiling" else name
            if not e.args:
                raise AnalysisError(f"{fname}() requires an argument")
            inner = self.bind_scalar(e.args[0], allow_agg)
            digits = 0
            if len(e.args) > 1:
                if fname in ("floor", "ceil"):
                    raise AnalysisError(f"{fname}() takes one argument")
                digits = literal_int(e.args[1], f"{fname}() digit count")
                if digits < 0:
                    raise UnsupportedFeatureError(
                        f"{fname}() negative digit counts not supported")
            t = inner.type
            if t.is_float:
                return BMathFunc(fname, (inner,), T.FLOAT64_T,
                                 param=(0, digits))
            if t.is_integer:
                return inner
            if t.is_decimal:
                if digits >= t.scale:
                    return self._rescale(inner, digits) \
                        if digits != t.scale else inner
                return BMathFunc(fname, (inner,), T.decimal_t(38, digits),
                                 param=(t.scale, digits))
            raise AnalysisError(f"{fname}() expects a numeric argument")
        if name in ("sqrt", "exp", "ln", "log", "log10", "log2",
                    "power", "pow"):
            args = [self.bind_scalar(a, allow_agg) for a in e.args]
            if any(not a.type.is_numeric for a in args):
                raise AnalysisError(f"{name}() expects numeric arguments")
            if name in ("power", "pow"):
                if len(args) != 2:
                    raise AnalysisError("power() requires two arguments")
                return BMathFunc("power", (to_f(args[0]), to_f(args[1])),
                                 T.FLOAT64_T)
            if name == "log" and len(args) == 2:
                # log(base, x) = ln(x) / ln(base)
                lx = BMathFunc("ln", (to_f(args[1]),), T.FLOAT64_T)
                lb = BMathFunc("ln", (to_f(args[0]),), T.FLOAT64_T)
                return BBinOp("/", lx, lb, T.FLOAT64_T)
            if len(args) != 1:
                raise AnalysisError(f"{name}() requires one argument")
            fname = "log10" if name == "log" else name
            return BMathFunc(fname, (to_f(args[0]),), T.FLOAT64_T)
        if name == "mod":
            if len(e.args) != 2:
                raise AnalysisError("mod() requires two arguments")
            return self._bind_binop(A.BinOp("%", e.args[0], e.args[1]),
                                    allow_agg)
        if name == "sign":
            if len(e.args) != 1:
                raise AnalysisError("sign() requires one argument")
            inner = self.bind_scalar(e.args[0], allow_agg)
            if not inner.type.is_numeric:
                raise AnalysisError("sign() expects a numeric argument")
            out = T.FLOAT64_T if inner.type.is_float else T.INT64_T
            return BMathFunc("sign", (inner,), out)
        if name == "pi":
            import math
            if e.args:
                raise AnalysisError("pi() takes no arguments")
            return BLiteral(math.pi, T.FLOAT64_T)
        if name in ("degrees", "radians"):
            import math
            if len(e.args) != 1:
                raise AnalysisError(f"{name}() requires one argument")
            factor = 180.0 / math.pi if name == "degrees" else math.pi / 180.0
            inner = self.bind_scalar(e.args[0], allow_agg)
            if not inner.type.is_numeric:
                raise AnalysisError(f"{name}() expects a numeric argument")
            return BBinOp("*", to_f(inner), BLiteral(factor, T.FLOAT64_T),
                          T.FLOAT64_T)
        if name in ("greatest", "least"):
            if not e.args:
                raise AnalysisError(f"{name}() requires arguments")
            bound = [self.bind_scalar(a, allow_agg) for a in e.args]
            # string literals coerce against the first typed argument
            anchor = next((x.type for x in bound
                           if not (isinstance(x, BLiteral) and x.type.is_text)),
                          None)
            if anchor is not None and not anchor.is_text:
                bound = [self._coerce_string_literal(x, anchor, None)
                         if isinstance(x, BLiteral) and x.type.is_text
                         and isinstance(x.value, str) else x for x in bound]
            out = bound[0].type
            for x in bound[1:]:
                out = T.common_super_type(out, x.type)
            if out.is_text:
                raise UnsupportedFeatureError(
                    f"{name}() over text not supported")
            if out.is_decimal:
                bound = [self._rescale(x, out.scale)
                         if (x.type.is_decimal or x.type.is_integer) else x
                         for x in bound]
            elif out.is_float:
                bound = [to_f(x) for x in bound]
            return BMathFunc(name, tuple(bound), out)
        if name in ("strpos", "position"):
            if len(e.args) != 2:
                raise AnalysisError(f"{name}() requires two arguments")
            target = self.bind_scalar(e.args[0], allow_agg)
            sub = e.args[1]
            if not (isinstance(sub, A.Literal) and isinstance(sub.value, str)):
                raise UnsupportedFeatureError(
                    f"{name}() substring must be a string literal")
            resolved = self._text_words(target)
            if resolved is None:
                if isinstance(target, BLiteral) and isinstance(target.value, str):
                    return BLiteral(target.value.find(sub.value) + 1, T.INT64_T)
                raise UnsupportedFeatureError(
                    f"{name}() requires a text column")
            from citus_tpu_torch.planner.bound import BDictLookup
            base, _t, _c, eff_words = resolved
            lut = tuple(w.find(sub.value) + 1 for w in eff_words)
            return BDictLookup(base, lut)
        return None

    # ---------------------------------------------------------------- aggs
    def _agg_output_type(self, kind: str, arg: Optional[BExpr]) -> T.ColumnType:
        if kind in ("count", "count_star"):
            return T.INT64_T
        t = arg.type
        if kind == "sum":
            if t.is_decimal:
                return T.decimal_t(38, t.scale)
            if t.is_integer:
                return T.INT64_T
            if t.is_float:
                return T.FLOAT64_T
            raise AnalysisError(f"sum() over {t} not supported")
        if kind == "avg":
            if t.is_float:
                return T.FLOAT64_T
            if t.is_decimal or t.is_integer:
                scale = (t.scale if t.is_decimal else 0) + 6
                return T.decimal_t(38, scale)
            raise AnalysisError(f"avg() over {t} not supported")
        if kind in ("min", "max"):
            if t.is_text:
                raise UnsupportedFeatureError("min/max over text not supported yet")
            if t.kind == T.UUID:
                raise UnsupportedFeatureError(
                    "min/max over uuid not supported yet")
            return t
        raise AnalysisError(f"unknown aggregate {kind}")

    def _bind_agg_call(self, e: A.FuncCall, aggs: list[AggSpec]) -> BExpr:
        """Aggregate call -> AggSpec (deduplicated) -> BAggRef slot."""
        from citus_tpu_torch.planner.aggregates import AGG_REGISTRY
        if e.filter is not None:
            e = rewrite_agg_filter(e)
        # the aggregate's own argument binds in row space, not key space
        saved_ctx, self._agg_ctx = self._agg_ctx, None
        try:
            if e.name in AGG_REGISTRY:
                spec = AGG_REGISTRY[e.name].bind(self, e)
            elif e.distinct and e.name in ("sum", "avg"):
                arg = self.bind_scalar(e.args[0])
                spec = AggSpec(f"{e.name}_distinct", arg,
                               self._agg_output_type(e.name, arg),
                               distinct=True)
            elif e.distinct and e.name in ("min", "max"):
                # DISTINCT is a no-op for extrema
                arg = self.bind_scalar(e.args[0])
                if arg.type.is_text:
                    from citus_tpu_torch.planner.aggregates import bind_text_minmax
                    spec = bind_text_minmax(self, e.name, arg)
                else:
                    spec = AggSpec(e.name, arg,
                                   self._agg_output_type(e.name, arg))
            elif e.distinct and e.name not in ("count",):
                raise UnsupportedFeatureError(
                    f"DISTINCT is not supported for {e.name}()")
            elif e.name == "count" and (not e.args or isinstance(e.args[0], A.Star)):
                spec = AggSpec("count_star", None, T.INT64_T)
            else:
                if len(e.args) != 1:
                    raise AnalysisError(f"{e.name}() expects one argument")
                arg = self.bind_scalar(e.args[0])
                if e.name in ("min", "max") and arg.type.is_text:
                    from citus_tpu_torch.planner.aggregates import bind_text_minmax
                    spec = bind_text_minmax(self, e.name, arg)
                else:
                    spec = AggSpec(e.name, arg, self._agg_output_type(e.name, arg),
                                   distinct=e.distinct)
            for i, existing in enumerate(aggs):
                if existing == spec:
                    return BAggRef(i, spec.out_type)
            aggs.append(spec)
            return BAggRef(len(aggs) - 1, spec.out_type)
        finally:
            self._agg_ctx = saved_ctx

    def bind_select_expr(self, e: A.Expr, key_map: dict[BExpr, int],
                         aggs: list[AggSpec]) -> BExpr:
        """Bind an output/having expression of a grouped query: aggregates
        become BAggRef slots, grouping-key subexpressions become BKeyRef."""
        from citus_tpu_torch.planner.aggregates import AGG_REGISTRY
        if isinstance(e, A.FuncCall) and (e.name in AGG_FUNCS
                                          or e.name in AGG_REGISTRY):
            return self._bind_agg_call(e, aggs)
        # non-aggregate: try matching a group key by source expression
        # first (stable under dictionary growth), then structurally
        am = getattr(self, "_ast_key_map", None)
        if am is not None:
            try:
                idx = am.get(e)
            except TypeError:
                idx = None
            if idx is not None:
                return BKeyRef(idx, self._ast_key_types[idx])
        bound = self._try_bind_as_key(e, key_map)
        if bound is not None:
            return bound
        if isinstance(e, A.BinOp):
            left = self.bind_select_expr(e.left, key_map, aggs)
            right = self.bind_select_expr(e.right, key_map, aggs)
            return self._rebind_binop_from_bound(e.op, left, right)
        if isinstance(e, A.UnOp):
            inner = self.bind_select_expr(e.operand, key_map, aggs)
            if e.op == "-":
                return BUnOp("-", inner, inner.type)
            return BUnOp("not", self._to_bool(inner), T.BOOL_T)
        if isinstance(e, A.Cast):
            inner = self.bind_select_expr(e.expr, key_map, aggs)
            return BCast(inner, T.type_from_sql(e.type_name, list(e.type_args) or None))
        if isinstance(e, A.Literal):
            return self._bind_literal(e)
        if isinstance(e, (A.FuncCall, A.CaseExpr, A.Between, A.InList,
                          A.IsNull)):
            # scalar expression over aggregates / group keys —
            # round(avg(x), 2), coalesce(sum(x), 0), CASE WHEN count(*)...
            # Nested aggregates resolve to BAggRef and key references to
            # BKeyRef via the binding context; any raw column that
            # survives is a semantic error.
            saved_ctx, self._agg_ctx = self._agg_ctx, (key_map, aggs)
            try:
                bound = self.bind_scalar(e, allow_agg=True)
            finally:
                self._agg_ctx = saved_ctx
            stray = [n for n in referenced_columns(bound)]
            if stray:
                raise AnalysisError(
                    f"column {stray[0]!r} must appear in GROUP BY or be "
                    "used in an aggregate")
            return bound
        raise AnalysisError(
            f"expression {e} must appear in GROUP BY or be used in an aggregate")

    def _rebind_binop_from_bound(self, op: str, left: BExpr, right: BExpr) -> BExpr:
        if op in ("and", "or"):
            return BBinOp(op, self._to_bool(left), self._to_bool(right), T.BOOL_T)
        left, right = self._align(left, right)
        if op in ("=", "<>", "<", "<=", ">", ">="):
            return BBinOp(op, left, right, T.BOOL_T)
        out = T.arith_result_type(op, left.type, right.type)
        return BBinOp(op, left, right, out)

    def _try_bind_as_key(self, e: A.Expr, key_map: dict[BExpr, int]) -> Optional[BExpr]:
        try:
            bound = self.bind_scalar(e)
        except (AnalysisError, UnsupportedFeatureError):
            return None
        idx = key_map.get(bound)
        if idx is not None:
            return BKeyRef(idx, bound.type)
        if isinstance(bound, BLiteral):
            return bound
        return None


# ------------------------------------------------------------------ select


def infer_param_types(binder: Binder, stmt: A.Select, n_params: int) -> dict:
    """Infer $N parameter types from their comparison/arithmetic context
    (the reference gets them from the protocol's Bind message; we derive
    them from the query shape).  -> {0-based index: (type, text_src)}."""
    types: dict[int, tuple] = {}

    def try_bind(e):
        try:
            return binder.bind_scalar(e)
        except Exception:
            return None

    def note(pi: int, other: A.Expr):
        if pi in types:
            return
        bexp = try_bind(other)
        if bexp is None:
            return
        src = None
        if bexp.type.is_text:
            from citus_tpu_torch.planner.bound import BColumn
            from citus_tpu_torch.planner.bound import walk as bwalk
            for nd in bwalk(bexp):
                if isinstance(nd, BColumn) and nd.type.is_text:
                    src = binder.text_source(nd)
                    break
            if src is None:
                return
        types[pi] = (bexp.type, src)

    def visit(e):
        if not isinstance(e, A.Expr):
            return
        if isinstance(e, A.BinOp):
            if isinstance(e.left, A.Param) and not isinstance(e.right, A.Param):
                note(e.left.index - 1, e.right)
            if isinstance(e.right, A.Param) and not isinstance(e.left, A.Param):
                note(e.right.index - 1, e.left)
            visit(e.left)
            visit(e.right)
        elif isinstance(e, A.Between):
            for x in (e.lo, e.hi):
                if isinstance(x, A.Param):
                    note(x.index - 1, e.expr)
            if isinstance(e.expr, A.Param):
                for x in (e.lo, e.hi):
                    if not isinstance(x, A.Param):
                        note(e.expr.index - 1, x)
            visit(e.expr), visit(e.lo), visit(e.hi)
        elif isinstance(e, A.InList):
            for it in e.items:
                if isinstance(it, A.Param):
                    note(it.index - 1, e.expr)
            visit(e.expr)
            for it in e.items:
                visit(it)
        elif isinstance(e, A.Cast):
            if isinstance(e.expr, A.Param):
                types.setdefault(
                    e.expr.index - 1,
                    (T.type_from_sql(e.type_name, list(e.type_args) or None), None))
            visit(e.expr)
        elif isinstance(e, A.UnOp):
            visit(e.operand)
        elif isinstance(e, A.IsNull):
            visit(e.expr)
        elif isinstance(e, A.CaseExpr):
            for c, v in e.whens:
                visit(c), visit(v)
            if e.else_ is not None:
                visit(e.else_)
        elif isinstance(e, A.FuncCall):
            for a in e.args:
                visit(a)

    for item in stmt.items:
        visit(item.expr)
    visit(stmt.where)
    visit(stmt.having)
    for g in stmt.group_by:
        visit(g)
    for o in stmt.order_by:
        visit(o.expr)
    return types


def bind_select(catalog: Catalog, stmt: A.Select,
                param_count: int = 0) -> BoundSelect:
    if stmt.from_ is None:
        raise UnsupportedFeatureError("SELECT without FROM not supported")
    if isinstance(stmt.from_, A.Join):
        raise UnsupportedFeatureError("joins are handled by the join planner")
    assert isinstance(stmt.from_, A.TableRef)
    table = catalog.table(stmt.from_.name)
    # single relation: env keys stay unqualified, but qualified references
    # through the FROM alias (or table name) must still resolve
    alias = stmt.from_.alias or stmt.from_.name
    b = Binder(catalog, table, rels=[(alias, table)])
    if param_count:
        b.param_types = infer_param_types(b, stmt, param_count)
        if len(b.param_types) < param_count:
            missing = [i + 1 for i in range(param_count)
                       if i not in b.param_types]
            raise UnsupportedFeatureError(
                f"cannot infer types for parameters {missing}")

    # expand * early
    items: list[A.SelectItem] = []
    for item in stmt.items:
        if isinstance(item.expr, A.Star):
            for col in table.schema:
                items.append(A.SelectItem(A.ColumnRef(col.name), col.name))
        else:
            items.append(item)

    where = b.bind_scalar(stmt.where) if stmt.where is not None else None
    if where is not None and where.type.kind != T.BOOL:
        raise AnalysisError("WHERE must be boolean")

    # GROUP BY ordinals (GROUP BY 1, 2) refer to select-list positions
    group_exprs = []
    for g in stmt.group_by:
        if isinstance(g, A.Literal) and g.type_name == "int":
            idx = int(g.value) - 1
            if not (0 <= idx < len(items)):
                raise AnalysisError(f"GROUP BY position {g.value} out of range")
            group_exprs.append(items[idx].expr)
        else:
            group_exprs.append(g)
    group_keys = [b.bind_scalar(g) for g in group_exprs]
    key_map = {k: i for i, k in enumerate(group_keys)}
    # AST-level key matching: dictionary-remap expressions (lower(s), ...)
    # are not structurally stable across binds when the dictionary grew,
    # but the source expression text is
    b._ast_key_map = {}
    b._ast_key_types = [k.type for k in group_keys]
    for i, g in enumerate(group_exprs):
        try:
            b._ast_key_map.setdefault(g, i)
        except TypeError:
            pass
    # a uuid group key carries its low int64 lane as a hidden trailing
    # key, so grouping is exact over all 128 bits; finalize recombines
    # the pair by lane name.  Appending after key_map keeps BKeyRef
    # indices of the visible keys stable.
    for k in list(group_keys):
        if isinstance(k, BColumn) and k.type.kind == T.UUID:
            group_keys.append(BColumn(T.uuid_lane_name(k.name), T.INT64_T))

    has_agg_funcs = any(_contains_agg(i.expr) for i in items) or \
        (stmt.having is not None) or bool(group_keys)

    aggs: list[AggSpec] = []
    output_names: list[str] = []
    final_exprs: list[BExpr] = []
    if has_agg_funcs:
        for i, item in enumerate(items):
            final_exprs.append(b.bind_select_expr(item.expr, key_map, aggs))
            output_names.append(item.alias or _default_name(item.expr, i))
        having = None
        if stmt.having is not None:
            having = b.bind_select_expr(stmt.having, key_map, aggs)
            if having.type.kind != T.BOOL:
                raise AnalysisError("HAVING must be boolean")
    else:
        for i, item in enumerate(items):
            final_exprs.append(b.bind_scalar(item.expr))
            output_names.append(item.alias or _default_name(item.expr, i))
        having = None

    order_by: list[tuple[int, bool, Optional[bool]]] = []
    hidden = 0
    for oi in stmt.order_by:
        try:
            idx = _resolve_order_ref(oi.expr, items, output_names)
        except AnalysisError:
            # ORDER BY a non-output expression: append as a hidden column
            # (PostgreSQL semantics; forbidden with DISTINCT, like PG)
            if stmt.distinct:
                raise AnalysisError(
                    "for SELECT DISTINCT, ORDER BY expressions must appear "
                    "in the select list")
            if has_agg_funcs:
                bound_e = b.bind_select_expr(oi.expr, key_map, aggs)
            else:
                bound_e = b.bind_scalar(oi.expr)
            final_exprs.append(bound_e)
            output_names.append(f"__order_{hidden}")
            idx = len(final_exprs) - 1
            hidden += 1
        order_by.append((idx, oi.ascending, oi.nulls_first))

    # enum ORDER BY keys sort by declaration rank, not label text
    # (reference: enum ordering via enumsortorder): redirect to a hidden
    # rank column — functionally dependent on the enum value, so
    # DISTINCT results are unchanged
    from citus_tpu_torch.planner.bound import BDictLookup
    for oi_pos, (idx, asc, nf) in enumerate(order_by):
        e_b = final_exprs[idx]
        under = e_b
        if isinstance(e_b, BKeyRef) and group_keys:
            under = group_keys[e_b.index]
        if not (isinstance(under, BColumn) and under.type.is_text):
            continue
        info = b.enum_info(under)
        if info is None:
            continue
        final_exprs.append(BDictLookup(e_b, Binder.enum_rank_lut(info)))
        output_names.append(f"__order_{hidden}")
        order_by[oi_pos] = (len(final_exprs) - 1, asc, nf)
        hidden += 1

    return BoundSelect(
        table=table, filter=where, group_keys=group_keys, aggs=aggs,
        final_exprs=final_exprs, output_names=output_names, having=having,
        order_by=order_by, limit=stmt.limit, offset=stmt.offset,
        distinct=stmt.distinct, hidden_outputs=hidden,
        param_specs=[b.param_types[i] for i in range(param_count)],
    )


def _contains_agg(e: A.Expr) -> bool:
    if isinstance(e, A.FuncCall):
        from citus_tpu_torch.planner.aggregates import AGG_REGISTRY
        if e.name in AGG_FUNCS or e.name in AGG_REGISTRY:
            return True
        return any(_contains_agg(a) for a in e.args)
    if isinstance(e, A.BinOp):
        return _contains_agg(e.left) or _contains_agg(e.right)
    if isinstance(e, A.UnOp):
        return _contains_agg(e.operand)
    if isinstance(e, A.Cast):
        return _contains_agg(e.expr)
    if isinstance(e, A.Between):
        return _contains_agg(e.expr) or _contains_agg(e.lo) or _contains_agg(e.hi)
    if isinstance(e, A.CaseExpr):
        return any(_contains_agg(c) or _contains_agg(v) for c, v in e.whens) or \
            (e.else_ is not None and _contains_agg(e.else_))
    return False


def _default_name(e: A.Expr, i: int) -> str:
    if isinstance(e, A.ColumnRef):
        return e.name
    if isinstance(e, A.FuncCall):
        return e.name
    return f"column{i + 1}"


def _resolve_order_ref(e: A.Expr, items: list[A.SelectItem], names: list[str]) -> int:
    if isinstance(e, A.Literal) and isinstance(e.value, int) and e.value is not True:
        idx = e.value - 1
        if not (0 <= idx < len(items)):
            raise AnalysisError(f"ORDER BY position {e.value} out of range")
        return idx
    if isinstance(e, A.ColumnRef) and e.table is None and e.name in names:
        return names.index(e.name)
    # structural match against select items
    for i, item in enumerate(items):
        if item.expr == e:
            return i
    raise AnalysisError("ORDER BY expression must be an output column, alias, or position")
