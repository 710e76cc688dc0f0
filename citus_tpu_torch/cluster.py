"""Cluster: the public entry point.

One Cluster = one coordinator over a data directory + a logical node set,
executing on one torch device, and over the members of its device mesh
(``mesh_devices``) for multi-batch aggregates and repartition joins.
SQL goes through ``execute``; the control-plane operations the
reference exposes as UDFs (create_distributed_table, ...) are available
both as Python methods and through their SQL spellings
(``SELECT create_distributed_table('t','col')``).

This port carries these slices of the JAX package's surface: CREATE
TABLE (with PRIMARY KEY / UNIQUE, CHECK, FOREIGN KEY, DEFAULT, serial
columns, PARTITION BY RANGE / PARTITION OF) and CREATE TABLE AS, DROP
TABLE, CREATE / DROP INDEX and SEQUENCE, create_distributed_table and
create_reference_table, the time-partition helpers, COPY
(``copy_from``: defaults, partition routing, FK, unique, CHECK and
partition-bound checks; COPY to and from CSV and binary files, COPY
(SELECT ...) TO), INSERT ... VALUES and INSERT ... SELECT (the
colocated / repartition / pull ladder) with ON CONFLICT, UPDATE and
DELETE (with subqueries, RETURNING and the FK actions of a parent),
MERGE, ALTER TABLE, alter_distributed_table and undistribute_table,
CREATE / DROP STATISTICS, ANALYZE, REINDEX, TRUNCATE, VACUUM,
BEGIN/COMMIT/ROLLBACK and savepoints (``session()``, DDL staged inside
them), SELECT
with aggregates in every group mode (scalar, direct and hash, sketch
aggregates included) and without them (filtered projections,
DISTINCT), joins, WITH and WITH RECURSIVE, UNION / INTERSECT / EXCEPT,
derived tables, scalar / IN / EXISTS subqueries (correlated ones
decorrelated), DISTINCT ON, window functions, GROUPING SETS / ROLLUP /
CUBE, SELECT without FROM, ``unnest``, a partitioned parent expanded
to its surviving partitions, ``execute(sql, params)`` and PREPARE /
EXECUTE / DEALLOCATE, EXPLAIN, change data capture and
CDC-fed rollups (``rollup/``), and several coordinators over RPC
(``serve_port``/``coordinator``/``data_port``/``hosted_nodes``: a
query pushes its worker half to the coordinator owning each remote
shard, COPY routes rows to their owners, DDL goes through the metadata
authority).  Everything else raises UnsupportedFeatureError naming its
ROADMAP.md item.  A data
directory written by ``citus_tpu`` opens here unchanged: the catalog
document, the columnar stripe files and the shard hash are the same.
"""

from __future__ import annotations

from typing import Any, Iterable, Optional, Sequence

from citus_tpu_torch.catalog import Catalog
from citus_tpu_torch.config import Settings, current_settings
from citus_tpu_torch.errors import (
    AnalysisError, CatalogError, ExecutionError, TransactionError,
    UnsupportedFeatureError,
)
from citus_tpu_torch.executor import Result, execute_select
from citus_tpu_torch.ingest import TableIngestor, encode_columns, rows_to_columns
from citus_tpu_torch.observability import trace as _trace
from citus_tpu_torch.planner import ast as A
from citus_tpu_torch.planner import parse_sql
from citus_tpu_torch.planner.bind import bind_select
from citus_tpu_torch.schema import Schema
from citus_tpu_torch.types import type_from_sql


def resolve_device(device=None):
    """``None`` means the first CUDA device; without CUDA that raises —
    the port never falls back to the CPU on its own.  ``"cpu"`` is the
    caller's explicit choice (the tests use it)."""
    import torch
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "citus_tpu_torch needs a CUDA device (pass device='cpu' to "
                "run on the CPU)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev



def _option_bool(v) -> bool:
    return str(v).lower() in ("true", "1", "on")

def _has_derived(item) -> bool:
    if isinstance(item, (A.SubqueryRef, A.FunctionRef)):
        return True
    if isinstance(item, A.Join):
        return _has_derived(item.left) or _has_derived(item.right)
    return False


def _srf_result(name: str, args, alias) -> "Result":
    """Evaluate a set-returning FROM function to rows (reference:
    PostgreSQL SRFs; only constant arguments are supported since the
    call is unlateral)."""
    vals = [_eval_const(a) for a in args]
    if name == "generate_series":
        if len(vals) not in (2, 3):
            raise AnalysisError(
                "generate_series(start, stop [, step]) expects 2 or 3 "
                "arguments")
        if any(v is None for v in vals):
            # PostgreSQL: a NULL bound yields zero rows
            return Result(columns=[alias or "generate_series"], rows=[])
        import decimal as _dec
        import math as _math
        numeric = False
        for v in vals:
            if isinstance(v, bool) \
                    or not isinstance(v, (int, float, _dec.Decimal)):
                raise AnalysisError(
                    "generate_series requires numeric bounds "
                    f"(got {v!r}); timestamp series are not supported")
            if (isinstance(v, float) and not _math.isfinite(v)) \
                    or (isinstance(v, _dec.Decimal) and not v.is_finite()):
                raise AnalysisError(
                    "generate_series bound cannot be infinity or NaN")
            if not isinstance(v, int):
                # PostgreSQL: any numeric argument makes the whole
                # series numeric (2.0..4.0 -> 2.0, 3.0, 4.0)
                numeric = True
        if numeric:
            # PostgreSQL numeric generate_series(1.1, 4.0, 1.3) ->
            # 1.1, 2.4, 3.7 — exact decimal stepping
            start = _dec.Decimal(str(vals[0]))
            stop = _dec.Decimal(str(vals[1]))
            step = _dec.Decimal(str(vals[2])) if len(vals) > 2 \
                else _dec.Decimal(1)
            if step == 0:
                raise ExecutionError("step size cannot equal zero")
            rows = []
            v = start
            while (v <= stop) if step > 0 else (v >= stop):
                rows.append((v,))
                v += step
            return Result(columns=[alias or "generate_series"], rows=rows)
        start, stop = int(vals[0]), int(vals[1])
        step = int(vals[2]) if len(vals) > 2 else 1
        if step == 0:
            raise ExecutionError("step size cannot equal zero")
        end = stop + (1 if step > 0 else -1)
        rows = [(v,) for v in range(start, end, step)]
        return Result(columns=[alias or "generate_series"], rows=rows)
    if name == "unnest":
        # reference: unnest(anyarray) SRF — one row per element
        if len(vals) != 1:
            raise AnalysisError("unnest(array) expects one argument")
        arr = vals[0]
        if arr is None:
            return Result(columns=[alias or "unnest"], rows=[])
        if not isinstance(arr, (list, tuple)):
            raise AnalysisError(f"unnest requires an array (got {arr!r})")
        return Result(columns=[alias or "unnest"],
                      rows=[(v,) for v in arr])
    raise UnsupportedFeatureError(
        f"set-returning function {name}() is not supported in FROM")


def _max_param_index(stmt) -> int:
    """Highest $N referenced anywhere in a SELECT (0 when none)."""
    mx = 0

    def visit(e):
        nonlocal mx
        if isinstance(e, A.Param):
            mx = max(mx, e.index)
        elif isinstance(e, A.BinOp):
            visit(e.left), visit(e.right)
        elif isinstance(e, A.UnOp):
            visit(e.operand)
        elif isinstance(e, A.Between):
            visit(e.expr), visit(e.lo), visit(e.hi)
        elif isinstance(e, A.InList):
            visit(e.expr)
            for it in e.items:
                visit(it)
        elif isinstance(e, (A.IsNull, A.Cast)):
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
    return mx


def _eval_const(e):
    """Evaluate a literal-only expression tree to a Python value (SELECT
    without FROM); NULL-propagating arithmetic/comparisons."""
    import decimal as _dec
    if isinstance(e, A.Literal):
        return e.value
    if isinstance(e, A.UnOp):
        v = _eval_const(e.operand)
        if e.op == "-":
            return None if v is None else -v
        return None if v is None else (not v)
    if isinstance(e, A.BinOp):
        if isinstance(e.left, A.IntervalLiteral) \
                or isinstance(e.right, A.IntervalLiteral):
            import datetime as _dt

            from citus_tpu_torch.planner.bound import py_add_interval
            if e.op not in ("+", "-"):
                raise UnsupportedFeatureError(
                    f"operator {e.op} is not defined for intervals")
            ivl = e.right if isinstance(e.right, A.IntervalLiteral) \
                else e.left
            other = e.left if ivl is e.right else e.right
            if ivl is e.left and e.op != "+":
                raise UnsupportedFeatureError(
                    "interval arithmetic supports date/timestamp ± interval")
            v = _eval_const(other)
            if v is None:
                return None
            if not isinstance(v, (_dt.date, _dt.datetime)):
                raise AnalysisError(
                    "cannot add an interval to a non-date value "
                    "(use a typed literal: date '...')")
            sign = 1 if e.op == "+" else -1
            return py_add_interval(v, sign * ivl.months, sign * ivl.days,
                                   sign * ivl.micros)
        l, r = _eval_const(e.left), _eval_const(e.right)
        if e.op == "and":
            if l is False or r is False:
                return False
            return None if (l is None or r is None) else True
        if e.op == "or":
            if l is True or r is True:
                return True
            return None if (l is None or r is None) else False
        if l is None or r is None:
            return None
        if isinstance(l, (int, float)) and isinstance(r, _dec.Decimal):
            l = _dec.Decimal(str(l))
        if isinstance(r, (int, float)) and isinstance(l, _dec.Decimal):
            r = _dec.Decimal(str(r))
        ops = {"+": lambda: l + r, "-": lambda: l - r, "*": lambda: l * r,
               "/": lambda: l / r if r else None,
               "%": lambda: l % r if r else None,
               "=": lambda: l == r, "<>": lambda: l != r,
               "<": lambda: l < r, "<=": lambda: l <= r,
               ">": lambda: l > r, ">=": lambda: l >= r}
        if e.op not in ops:
            raise UnsupportedFeatureError(f"operator {e.op} without FROM")
        return ops[e.op]()
    if isinstance(e, A.IsNull):
        v = _eval_const(e.expr)
        return (v is not None) if e.negated else (v is None)
    if isinstance(e, A.Cast):
        v = _eval_const(e.expr)
        if v is None:
            return None
        t = type_from_sql(e.type_name, list(e.type_args) or None)
        try:
            return t.from_physical(t.to_physical(v))
        except (ValueError, TypeError):
            raise AnalysisError(
                f"invalid input syntax for type {e.type_name}: {v!r}")
    if isinstance(e, A.CaseExpr):
        for c, v in e.whens:
            if _eval_const(c) is True:
                return _eval_const(v)
        return _eval_const(e.else_) if e.else_ is not None else None
    if isinstance(e, A.FuncCall) and e.name == "coalesce":
        for a in e.args:
            v = _eval_const(a)
            if v is not None:
                return v
        return None
    if isinstance(e, A.FuncCall):
        v = _eval_const_func(e)
        if v is not NotImplemented:
            return v
    raise UnsupportedFeatureError(
        f"cannot evaluate {type(e).__name__} without a FROM clause")


def _eval_const_func(e):
    """Constant evaluation of the scalar math/string surface (SELECT
    without FROM); NotImplemented when the function is unknown."""
    import decimal as _dec
    import math as _math
    args = [_eval_const(a) for a in e.args]
    name = e.name
    if name == "pi":
        return _math.pi
    if name in ("current_date", "current_timestamp", "now"):
        import datetime as _dt
        return _dt.date.today() if name == "current_date" \
            else _dt.datetime.now()
    if name == "nullif":
        # NULLIF is not strict: it returns the first argument unless the
        # comparison is true, so nullif(5, NULL) = 5 (PostgreSQL).
        return None if args[0] == args[1] else args[0]
    if any(a is None for a in args):
        # all these functions are strict (NULL in -> NULL out)
        known = {"abs", "floor", "ceil", "ceiling", "round", "trunc",
                 "sign", "sqrt", "exp", "ln", "log", "log10", "log2",
                 "power", "pow", "mod", "degrees", "radians", "greatest",
                 "least", "upper", "lower", "length", "char_length",
                 "strpos", "reverse", "initcap", "trim",
                 "btrim", "ltrim", "rtrim", "replace", "left", "right"}
        if name in ("greatest", "least"):
            vals = [a for a in args if a is not None]
            if not vals:
                return None
            return max(vals) if name == "greatest" else min(vals)
        return None if name in known else NotImplemented
    try:
        if name == "abs":
            return abs(args[0])
        if name in ("floor", "ceil", "ceiling"):
            f = _math.floor if name == "floor" else _math.ceil
            v = f(args[0])
            return _dec.Decimal(v) if isinstance(args[0], _dec.Decimal) \
                else (float(v) if isinstance(args[0], float) else v)
        if name == "round":
            nd = int(args[1]) if len(args) > 1 else 0
            if isinstance(args[0], float):
                # round(double precision) ties to even in PostgreSQL
                return float(round(args[0], nd))
            d = args[0] if isinstance(args[0], _dec.Decimal) \
                else _dec.Decimal(str(args[0]))
            return d.quantize(_dec.Decimal(1).scaleb(-nd),
                              rounding=_dec.ROUND_HALF_UP)
        if name == "trunc":
            nd = int(args[1]) if len(args) > 1 else 0
            d = args[0] if isinstance(args[0], _dec.Decimal) \
                else _dec.Decimal(str(args[0]))
            q = d.quantize(_dec.Decimal(1).scaleb(-nd),
                           rounding=_dec.ROUND_DOWN)
            return float(q) if isinstance(args[0], float) else q
        if name == "sign":
            v = args[0]
            return (v > 0) - (v < 0)
        if name == "sqrt":
            return _math.sqrt(args[0]) if args[0] >= 0 else None
        if name == "exp":
            return _math.exp(args[0])
        if name in ("ln", "log", "log10", "log2"):
            if name == "log" and len(args) == 2:
                return (_math.log(args[1]) / _math.log(args[0])
                        if args[1] > 0 and args[0] > 0 else None)
            if args[0] <= 0:
                return None
            return _math.log(args[0]) if name == "ln" else (
                _math.log2(args[0]) if name == "log2"
                else _math.log10(args[0]))
        if name in ("power", "pow"):
            return float(args[0]) ** float(args[1])
        if name == "mod":
            a, b = args
            if not b:
                return None
            # SQL mod truncates toward zero; exact integer arithmetic
            # (float division would lose precision past 2^53)
            q = abs(a) // abs(b)
            if (a < 0) != (b < 0):
                q = -q
            return a - q * b
        if name == "degrees":
            return _math.degrees(args[0])
        if name == "radians":
            return _math.radians(args[0])
        if name in ("greatest", "least"):
            return max(args) if name == "greatest" else min(args)
        if args and isinstance(args[0], str):
            s = args[0]
            if name == "upper":
                return s.upper()
            if name == "lower":
                return s.lower()
            if name in ("length", "char_length"):
                return len(s)
            if name == "strpos":
                return s.find(str(args[1])) + 1
            if name == "reverse":
                return s[::-1]
            if name == "initcap":
                return s.title()
            if name in ("trim", "btrim"):
                return s.strip(str(args[1]) if len(args) > 1 else None)
            if name == "ltrim":
                return s.lstrip(str(args[1]) if len(args) > 1 else None)
            if name == "rtrim":
                return s.rstrip(str(args[1]) if len(args) > 1 else None)
            if name == "replace":
                return s.replace(str(args[1]), str(args[2]))
            if name == "left":
                return s[:int(args[1])]
            if name == "right":
                n = int(args[1])
                return s[max(0, len(s) - n):] if n >= 0 else s[-n:]
    except (ValueError, OverflowError, ArithmeticError):
        return None
    return NotImplemented


def _pylit(v) -> A.Literal:
    """Python value -> literal AST node (for synthesized statements)."""
    import decimal as _dec
    if v is None:
        return A.Literal(None, "null")
    if isinstance(v, bool):
        return A.Literal(v, "bool")
    if isinstance(v, int):
        return A.Literal(v, "int")
    if isinstance(v, float):
        return A.Literal(v, "float")
    if isinstance(v, _dec.Decimal):
        return A.Literal(v, "decimal")
    return A.Literal(str(v), "string")


def _subst_excluded(e, excl: dict):
    """Replace ``excluded.col`` references with the proposed row's
    literal values (ON CONFLICT DO UPDATE, PostgreSQL semantics)."""
    if isinstance(e, A.ColumnRef) and e.table == "excluded":
        return excl.get(e.name, A.Literal(None, "null"))
    if isinstance(e, A.BinOp):
        return A.BinOp(e.op, _subst_excluded(e.left, excl),
                       _subst_excluded(e.right, excl))
    if isinstance(e, A.UnOp):
        return A.UnOp(e.op, _subst_excluded(e.operand, excl))
    if isinstance(e, A.Between):
        return A.Between(_subst_excluded(e.expr, excl),
                         _subst_excluded(e.lo, excl),
                         _subst_excluded(e.hi, excl), e.negated)
    if isinstance(e, A.InList):
        return A.InList(_subst_excluded(e.expr, excl),
                        tuple(_subst_excluded(i, excl) for i in e.items),
                        e.negated)
    if isinstance(e, A.IsNull):
        return A.IsNull(_subst_excluded(e.expr, excl), e.negated)
    if isinstance(e, A.Cast):
        return A.Cast(_subst_excluded(e.expr, excl), e.type_name, e.type_args)
    if isinstance(e, A.CaseExpr):
        return A.CaseExpr(
            tuple((_subst_excluded(c, excl), _subst_excluded(v, excl))
                  for c, v in e.whens),
            _subst_excluded(e.else_, excl) if e.else_ is not None else None)
    if isinstance(e, A.FuncCall):
        import dataclasses
        return dataclasses.replace(
            e, args=tuple(_subst_excluded(a, excl) for a in e.args),
            agg_order=tuple((_subst_excluded(oe, excl), asc)
                            for oe, asc in e.agg_order),
            filter=_subst_excluded(e.filter, excl)
            if e.filter is not None else None)
    return e


def _expand_returning_items(t, items, subst=None):
    """Expand a RETURNING list to [(expr, output name)]: * becomes the
    table's columns; substitutions (UPDATE assignments, INSERT row
    values) apply after expansion."""
    expanded = []
    for it in items:
        if isinstance(it.expr, A.Star):
            for n in t.schema.names:
                e = A.ColumnRef(n)
                if subst:
                    e = _replace_exprs(e, subst)
                expanded.append((e, n))
        else:
            e = _replace_exprs(it.expr, subst) if subst else it.expr
            expanded.append((e, it.alias or str(it.expr)))
    return expanded


def _replace_exprs(e, mapping: dict):
    """Structural replacement of whole sub-expressions (used to NULL out
    rolled-up grouping columns inside HAVING)."""
    if e in mapping:
        return mapping[e]
    if isinstance(e, A.BinOp):
        return A.BinOp(e.op, _replace_exprs(e.left, mapping),
                       _replace_exprs(e.right, mapping))
    if isinstance(e, A.UnOp):
        return A.UnOp(e.op, _replace_exprs(e.operand, mapping))
    if isinstance(e, A.Between):
        return A.Between(_replace_exprs(e.expr, mapping),
                         _replace_exprs(e.lo, mapping),
                         _replace_exprs(e.hi, mapping), e.negated)
    if isinstance(e, A.InList):
        return A.InList(_replace_exprs(e.expr, mapping),
                        tuple(_replace_exprs(i, mapping) for i in e.items),
                        e.negated)
    if isinstance(e, A.IsNull):
        return A.IsNull(_replace_exprs(e.expr, mapping), e.negated)
    if isinstance(e, A.Cast):
        return A.Cast(_replace_exprs(e.expr, mapping), e.type_name, e.type_args)
    if isinstance(e, A.CaseExpr):
        return A.CaseExpr(tuple((_replace_exprs(c, mapping),
                                 _replace_exprs(v, mapping))
                                for c, v in e.whens),
                          _replace_exprs(e.else_, mapping)
                          if e.else_ is not None else None)
    if isinstance(e, A.FuncCall):
        import dataclasses
        return dataclasses.replace(
            e, args=tuple(_replace_exprs(a, mapping) for a in e.args),
            agg_order=tuple((_replace_exprs(oe, mapping), asc)
                            for oe, asc in e.agg_order),
            filter=_replace_exprs(e.filter, mapping)
            if e.filter is not None else None)
    return e


def _subst_args(e, sub: dict):
    """Replace bare ColumnRefs naming function parameters with the call
    arguments (used by SQL function inlining)."""
    if isinstance(e, A.ColumnRef) and e.table is None and e.name in sub:
        return sub[e.name]
    if isinstance(e, A.BinOp):
        return A.BinOp(e.op, _subst_args(e.left, sub),
                       _subst_args(e.right, sub))
    if isinstance(e, A.UnOp):
        return A.UnOp(e.op, _subst_args(e.operand, sub))
    if isinstance(e, A.Between):
        return A.Between(_subst_args(e.expr, sub), _subst_args(e.lo, sub),
                         _subst_args(e.hi, sub), e.negated)
    if isinstance(e, A.InList):
        return A.InList(_subst_args(e.expr, sub),
                        tuple(_subst_args(i, sub) for i in e.items),
                        e.negated)
    if isinstance(e, A.IsNull):
        return A.IsNull(_subst_args(e.expr, sub), e.negated)
    if isinstance(e, A.Cast):
        return A.Cast(_subst_args(e.expr, sub), e.type_name, e.type_args)
    if isinstance(e, A.CaseExpr):
        return A.CaseExpr(tuple((_subst_args(c, sub), _subst_args(v, sub))
                                for c, v in e.whens),
                          _subst_args(e.else_, sub)
                          if e.else_ is not None else None)
    if isinstance(e, A.FuncCall):
        import dataclasses
        return dataclasses.replace(
            e, args=tuple(_subst_args(a, sub) for a in e.args),
            agg_order=tuple((_subst_args(oe, sub), asc)
                            for oe, asc in e.agg_order),
            filter=_subst_args(e.filter, sub)
            if e.filter is not None else None)
    return e


def _limit0(stmt):
    """A zero-row variant of a SELECT-shaped statement (column/type
    probing without scanning)."""
    import dataclasses as _dc
    if isinstance(stmt, (A.Select, A.SetOp)):
        return _dc.replace(stmt, limit=0)
    if isinstance(stmt, A.WithSelect):
        return _dc.replace(stmt, body=_dc.replace(stmt.body, limit=0))
    return stmt


def _sort_rows(rows, names, order_by):
    """ORDER BY over materialized rows: items resolve by output position
    or output column name (PostgreSQL's rule for set operations)."""
    for oi in reversed(order_by):
        idx = None
        if isinstance(oi.expr, A.Literal) and isinstance(oi.expr.value, int):
            idx = oi.expr.value - 1
        elif isinstance(oi.expr, A.ColumnRef) and oi.expr.table is None \
                and oi.expr.name in names:
            idx = names.index(oi.expr.name)
        if idx is None or not (0 <= idx < len(names)):
            raise AnalysisError(
                "ORDER BY on a set operation must reference an output "
                "column name or position")
        nf = oi.nulls_first if oi.nulls_first is not None else (not oi.ascending)
        nulls = [x for x in rows if x[idx] is None]
        vals = [x for x in rows if x[idx] is not None]
        vals.sort(key=lambda x, j=idx: x[j], reverse=not oi.ascending)
        rows = (nulls + vals) if nf else (vals + nulls)
    return rows


def _from_relations_scope(node) -> set:
    """Relations referenced inside one WITH scope (CTE bodies + body)."""
    inner: set = set()
    for _n, sub in node.ctes:
        inner |= _from_relations(sub)
    inner |= _from_relations(node.body)
    return inner


def _from_relations(s) -> set:
    """Relation names referenced in FROM clauses (incl. joins, derived
    tables, set-op arms): a recursive CTE's self-reference, and the
    tables a statement reads for the guards of ``_execute_stmt_inner``.
    Subqueries in expressions are not walked (ROADMAP.md C10)."""
    out: set = set()

    def from_item(item):
        if isinstance(item, A.TableRef):
            out.add(item.name)
        elif isinstance(item, A.Join):
            from_item(item.left)
            from_item(item.right)
        elif isinstance(item, A.SubqueryRef):
            walk(item.select)

    def walk(node):
        if isinstance(node, A.SetOp):
            walk(node.left)
            walk(node.right)
        elif isinstance(node, A.WithSelect):
            cte_names = {n for n, _ in node.ctes}
            inner = _from_relations_scope(node)
            out.update(inner - cte_names)
        elif isinstance(node, A.Select) and node.from_ is not None:
            from_item(node.from_)

    walk(s)
    return out


def _infer_column_type(vals):
    """Fallback type inference for intermediate results whose planner
    types are unknown (e.g. window outputs): first non-NULL value wins;
    decimals take the column's max scale."""
    import datetime as _dt
    import decimal as _dec
    from citus_tpu_torch import types as T
    kind = None
    max_scale = 0
    for v in vals:
        if v is None:
            continue
        if isinstance(v, bool):
            return T.BOOL_T
        if isinstance(v, _dec.Decimal):
            kind = "decimal"
            max_scale = max(max_scale, -v.as_tuple().exponent)
        elif isinstance(v, float):
            return T.FLOAT64_T
        elif isinstance(v, int):
            kind = kind or "int"
        elif isinstance(v, str):
            return T.TEXT_T
        elif isinstance(v, _dt.datetime):
            return T.TIMESTAMP_T
        elif isinstance(v, _dt.date):
            return T.DATE_T
        else:
            raise AnalysisError(f"cannot infer a column type from {v!r}")
    if kind == "decimal":
        return T.decimal_t(max(18, max_scale), max(max_scale, 0))
    return T.INT64_T


def resolve_mesh(device, mesh_devices=None):
    """The Cluster's ``DeviceMesh``: ``mesh_devices`` (a list of devices,
    one per member; a device may repeat), or by default one member per
    CUDA device, ``device`` first, as the reference's mesh spans
    ``jax.devices()``; on the CPU one member.  Members share ``device``'s
    kind."""
    import torch
    from citus_tpu_torch.parallel.mesh import DeviceMesh
    if mesh_devices is None:
        mesh_devices = [device]
        if device.type == "cuda":
            mesh_devices += [torch.device("cuda", i)
                             for i in range(torch.cuda.device_count())
                             if i != device.index]
    members = [resolve_device(d) for d in mesh_devices]
    if any(d.type != device.type for d in members):
        raise ValueError(f"mesh members {[str(d) for d in members]} are not "
                         f"all on {device.type}, the Cluster's device")
    return DeviceMesh(members)


def _unported(what: str, item: str):
    raise UnsupportedFeatureError(
        f"{what} is not ported to citus_tpu_torch yet (ROADMAP.md {item})")


class Cluster:
    def __init__(self, data_dir: str, *, n_nodes: Optional[int] = None,
                 settings: Optional[Settings] = None, device=None,
                 mesh_devices=None,
                 serve_port: Optional[int] = None,
                 coordinator: Optional[tuple] = None,
                 data_port: Optional[int] = None,
                 hosted_nodes: Optional[set] = None,
                 secret: Optional[bytes] = None,
                 data_bind_host: str = "127.0.0.1"):
        """``device``: the torch device the ``gpu`` backend runs on;
        None = CUDA (raises when there is none).  ``mesh_devices``: the
        members of the mesh that multi-batch aggregates and repartition
        joins run over, one device each (a device may repeat: ``["cpu"]
        * 8`` is an 8-member mesh on the CPU, ``["cuda:0"] * 4`` four
        members on one card); None = one member per CUDA device, or one
        on the CPU (``resolve_mesh``).  ``n_nodes`` defaults to
        the number of CUDA devices (1 on the CPU), as the reference
        defaults to its JAX device count, and to 0 when
        ``hosted_nodes`` is given.

        Several coordinators make one cluster, as in the reference:
        ``serve_port`` makes this one the metadata authority (the
        control plane, net/control_plane.py), ``coordinator=(host,
        port)`` attaches it to one; ``data_port`` serves this process's
        shard placements and pushed worker tasks to its peers
        (net/data_plane.py); ``hosted_nodes`` names the node ids whose
        placements live in THIS data dir (None = all: single-host
        mode); ``secret`` is the shared HMAC secret of every RPC
        (reference: pg_dist_authinfo)."""
        import torch
        if isinstance(secret, str):
            secret = secret.encode()
        self._secret = secret
        self.device = resolve_device(device)
        self.mesh = resolve_mesh(self.device, mesh_devices)
        self.settings = settings or current_settings()
        self.catalog = Catalog(data_dir)
        if hosted_nodes is not None:
            self.catalog.hosted_nodes = set(hosted_nodes)
        if n_nodes is None:
            if hosted_nodes is not None:
                n_nodes = 0
            else:
                n_nodes = max(torch.cuda.device_count(), 1) \
                    if self.device.type == "cuda" else 1
        if n_nodes:
            self.catalog.ensure_nodes(n_nodes)
        self.catalog.commit()
        self._data_server = None
        if data_port is not None:
            from citus_tpu_torch.net.data_plane import DataPlaneServer
            self._data_server = DataPlaneServer(self, port=data_port,
                                                secret=secret,
                                                bind_host=data_bind_host)
        if hosted_nodes is not None:
            from citus_tpu_torch.net.data_plane import DataPlaneClient
            self.catalog.remote_data = DataPlaneClient(self.catalog,
                                                       secret=secret)
        # transaction log + recovery on open (reference: 2PC recovery at
        # maintenance-daemon startup, transaction_recovery.c)
        from citus_tpu_torch.transaction import LockManager, TransactionLog
        from citus_tpu_torch.transaction.recovery import recover_transactions
        self.txlog = TransactionLog(data_dir)
        recover_transactions(self.catalog, self.txlog)
        # plan cache keyed by SQL text, validated per lookup against the
        # table's identity/version (planner/plan_cache.py)
        from citus_tpu_torch.executor.executor import GLOBAL_COUNTERS
        from citus_tpu_torch.executor.kernel_cache import GLOBAL_KERNELS
        from citus_tpu_torch.planner.plan_cache import PlanCache
        self._plan_cache = PlanCache()
        GLOBAL_KERNELS.set_capacity(self.settings.executor.kernel_cache_size)
        self.counters = GLOBAL_COUNTERS
        self.locks = LockManager()
        # per-statement attribution behind citus_stat_statements() and
        # citus_stat_tenants()
        from citus_tpu_torch.stats import QueryStats, TenantStats
        self.query_stats = QueryStats()
        self.tenant_stats = TenantStats()
        # per-placement load attribution re-zeros with the counters so
        # the ledger-balance invariant survives stat resets; the hook is
        # removed in close(): GLOBAL_COUNTERS outlives this handle
        from citus_tpu_torch.observability.load_attribution import (
            GLOBAL_ATTRIBUTION,
        )
        self.counters.add_reset_hook(GLOBAL_ATTRIBUTION.reset)
        # change data capture: one stream per table, written at commit
        from citus_tpu_torch.cdc import ChangeDataCapture
        from citus_tpu_torch.utils.clock import CausalClock
        self.clock = CausalClock(data_dir)
        self.cdc = ChangeDataCapture(
            data_dir, self.settings.enable_change_data_capture)
        # per-thread implicit sessions: {thread ident: (Thread, Session)}
        self._default_sessions: dict = {}
        # continuous aggregation (rollup/manager.py): the CDC-fed
        # incremental refresh loop only runs while
        # citus.rollup_refresh_interval_ms > 0
        from citus_tpu_torch.rollup import RollupManager
        self.rollup_manager = RollupManager(self)
        self.rollup_manager.apply()
        # control plane (reference: metadata sync + 2PC votes over libpq;
        # net/control_plane.py).  serve_port=N makes this coordinator the
        # metadata authority; coordinator=(host, port) joins one.
        # Without either, multi-coordinator invalidation falls back to
        # catalog-file mtime polling.
        self._catalog_dirty = False
        self._control = None
        if serve_port is not None or coordinator is not None:
            from citus_tpu_torch.net.control_plane import ControlPlane
            self._control = ControlPlane(self, serve_port=serve_port,
                                         coordinator=coordinator,
                                         secret=secret)
            # catalog commits serialize through the authority's DDL
            # lease and ship the document over RPC (push_catalog)
            self.catalog.commit_transport = self._control
            # placement-mirror sync elision trusts the data_changed
            # invalidation stream only while it is attached
            if self.catalog.remote_data is not None:
                self.catalog.remote_data.invalidation_fresh = (
                    lambda: self._control is not None
                    and self._control.connected)
        self.catalog.on_commit = self._on_catalog_commit
        # metadata sync engine (metadata/sync.py): per-object
        # pull-on-mismatch convergence against the authority; the
        # interval loop only runs while attached and
        # citus.metadata_sync_interval_ms > 0
        from citus_tpu_torch.metadata import (
            MetadataSync, hydrate_tenant_registry,
        )
        self.metadata_sync = MetadataSync(self)
        self.metadata_sync.apply()
        # mirror the catalog-persisted tenant quotas into the
        # process-local registry, so this coordinator admits identically
        # to every other holder of the same document
        hydrate_tenant_registry(self.catalog)
        # mtime-poll baseline: our own open-time commit; a newer catalog
        # file is another process's change
        self._catalog_mtime = getattr(self.catalog, "self_mtime", None)

    def _peer_inflight(self) -> set:
        """In-flight xids of the other coordinators (2PC recovery spares
        them)."""
        if self._control is not None:
            return self._control.peer_inflight_xids()
        return set()

    def _gxid_outcome(self, gxid: str):
        """Resolve a cross-host branch against the authority's outcome
        store ('commit'/'abort'/None while undecided or unreachable)."""
        if self._control is not None:
            return self._control.txn_outcome(gxid)
        return None

    def _on_catalog_commit(self) -> None:
        if self._control is not None:
            self._control.publish_catalog_change()

    def _on_foreign_catalog_applied(self) -> None:
        """A pushed catalog document was just stored into our live
        catalog (authority side): drop cached plans keyed on the old
        metadata and re-mirror the replicated tenant sections."""
        self._plan_cache.clear()
        from citus_tpu_torch.metadata import hydrate_tenant_registry
        hydrate_tenant_registry(self.catalog)

    @property
    def control_port(self) -> Optional[int]:
        """Port of this coordinator's control-plane server (the metadata
        authority's), or None."""
        if self._control is not None and self._control.server is not None:
            return self._control.server.port
        return None

    @property
    def data_port(self) -> Optional[int]:
        """Port of this coordinator's bulk data-plane server, or None."""
        return self._data_server.port if self._data_server else None

    def close(self) -> None:
        # open transactions on the per-thread default sessions roll back
        # (connection-close semantics)
        for _owner, ds in list(self._default_sessions.values()):
            if ds.txn is not None:
                self._rollback_txn(ds)
        self.rollup_manager.stop()
        self.metadata_sync.stop()
        from citus_tpu_torch.observability.load_attribution import (
            GLOBAL_ATTRIBUTION,
        )
        self.counters.remove_reset_hook(GLOBAL_ATTRIBUTION.reset)
        if self._control is not None:
            self._control.close()
        if self._data_server is not None:
            self._data_server.stop()
        if self.catalog.remote_data is not None:
            self.catalog.remote_data.close()
        # release the transaction-log owner marker: our undecided
        # transactions become recoverable by other coordinators
        self.txlog.close()

    # ------------------------------------------------ cross-host topology
    def register_node(self, host: str = "127.0.0.1") -> int:
        """Join the cluster as a shard-hosting worker: add a node whose
        placements live in THIS coordinator's data dir, advertising our
        data-plane endpoint so peers can read/write them over the wire
        (reference: citus_add_node(nodename, nodeport) +
        metadata/node_metadata.c ActivateNode)."""
        if self._data_server is None:
            raise AnalysisError(
                "register_node requires data_port= (no data-plane server)")
        from citus_tpu_torch.catalog.catalog import NodeMeta
        # adopt the authority's current node map BEFORE allocating an id
        # (an attached coordinator's local file lags the authority)
        self._reload_catalog()
        nid = max(self.catalog.nodes, default=-1) + 1
        self.catalog.nodes[nid] = NodeMeta(nid, True, host,
                                           self._data_server.port)
        if self.catalog.hosted_nodes is None:
            self.catalog.hosted_nodes = set()
        self.catalog.hosted_nodes.add(nid)
        self.catalog.ddl_epoch += 1
        self.catalog.commit()
        return nid

    def _ingest_local_batch(self, table_name: str, values: dict,
                            validity: dict) -> int:
        """Data-plane server entry: write a physical-encoded batch whose
        rows hash to shards hosted HERE (the receiving half of a
        cross-host COPY; reference: the worker side of per-shard COPY
        streams).  Runs this coordinator's own 2PC."""
        self._maybe_reload_catalog()
        if not self.catalog.has_table(table_name):
            # the batch and the DDL's invalidation travel on two sockets:
            # a COPY right after CREATE can arrive first
            self._reload_catalog()
        t = self.catalog.table(table_name)
        from citus_tpu_torch.transaction.locks import SHARED
        with self._write_lock(t, SHARED):
            t = self.catalog.table(table_name)
            ing = TableIngestor(self.catalog, t, txlog=self.txlog)
            try:
                ing.append(values, validity)
            except BaseException:
                ing.abort()
                raise
            ing.finish()
        n = len(next(iter(values.values()))) if values else 0
        self.counters.bump("rows_ingested_remote", n)
        return n

    def _write_lock(self, table_meta, mode: str):
        """Serialize writers on a table's colocation group (the analog of
        LockShardResource, utils/resource_lock.c): EXCLUSIVE for
        UPDATE/DELETE/TRUNCATE and upserts, SHARED for append-only
        ingest.  Inside BEGIN..COMMIT the lock is taken into the
        transaction and held to its end (two-phase locking); otherwise
        it is statement-scoped, and after acquisition the catalog is
        re-read if another process changed it."""
        import contextlib

        @contextlib.contextmanager
        def _ctx():
            from citus_tpu_torch.storage.overlay import current_overlay
            txn = current_overlay()
            if txn is not None:
                txn.hold_group_lock(self, table_meta, mode)
                yield
                return
            from citus_tpu_torch.transaction.write_locks import (
                group_write_lock,
            )
            try:
                with group_write_lock(
                        self.catalog, table_meta, mode,
                        lock_manager=self.locks,
                        timeout=self.settings.executor.lock_timeout_s):
                    # force_sync: an RPC invalidation push may not have
                    # arrived yet; a writer must check staleness
                    # synchronously before touching placements
                    self._maybe_reload_catalog(force_sync=True)
                    yield
            finally:
                # every auto-commit write funnels through here: expire
                # placement-mirror elision tokens cluster-wide (spurious
                # on a failed write — costs one RTT, never staleness)
                self._publish_data_changed(table_meta.name)
        return _ctx()

    def _publish_data_changed(self, table_name: str) -> None:
        """A committed write touched ``table_name``: expire our own
        placement-mirror elision tokens (our mirrors of its remote
        placements may now trail their sources) and broadcast the
        data_changed event so every peer coordinator expires theirs."""
        rd = self.catalog.remote_data
        if rd is not None:
            rd.note_data_changed(table_name)
        if self._control is not None:
            self._control.publish_data_change(table_name)

    def _maybe_reload_catalog(self, force_sync: bool = False) -> None:
        """Pick up metadata other coordinators committed (the
        query-from-any-node analog; reference: metadata/metadata_sync.c).
        With a control plane attached, invalidation arrives as an RPC
        push; otherwise fall back to catalog-file mtime polling.  Writes
        made by THIS process never trigger a reload: concurrent sessions
        hold references into the live catalog."""
        import os
        if self._control is not None and self._control.connected:
            if self._catalog_dirty:
                self._catalog_dirty = False
                # this statement would have planned against stale
                # metadata had the invalidation not been honored
                self.counters.bump("metadata_stale_reads")
                # incremental first: pull exactly the divergent objects
                # (metadata/sync.py); fall back to the full document
                if not self.metadata_sync.pull_on_mismatch():
                    self._reload_catalog()
                try:
                    self._catalog_mtime = os.path.getmtime(
                        self.catalog._path())
                except OSError:
                    pass
                return
            if not force_sync:
                return
            # fall through to the synchronous mtime check: write paths
            # cannot rely on the asynchronous push having arrived
        try:
            mtime = os.path.getmtime(self.catalog._path())
        except OSError:
            return
        if mtime == getattr(self.catalog, "self_mtime", None):
            self._catalog_mtime = mtime
            return
        if self._catalog_mtime is None:
            self._catalog_mtime = mtime
            return
        if mtime != self._catalog_mtime:
            self._catalog_mtime = mtime
            self._reload_catalog()

    def _reload_catalog(self) -> None:
        import os
        # with an authority attached, the catalog document itself comes
        # over RPC (fetch_catalog) — the file is only the fallback
        doc = None
        if self._control is not None and self._control.connected:
            try:
                doc = self._control.fetch_catalog_doc()
            except Exception:  # noqa: BLE001 -- authority unreachable: the file is the fallback
                doc = None
        with self.catalog._lock:
            # swap, never clear-then-refill: concurrent readers see the
            # old or the new document
            self.catalog._dicts = {}
            self.catalog._dict_index = {}
            self.catalog._dict_sig = {}
            if doc is not None:
                self.catalog.load_document(doc)
            elif os.path.exists(self.catalog._path()):
                self.catalog._load()
            else:
                self.catalog.tables = {}
                self.catalog.nodes = {}
            self.catalog.ddl_epoch += 1  # invalidate cached plans
        self._plan_cache.clear()
        # replicated tenant sections may have changed with the document
        from citus_tpu_torch.metadata import hydrate_tenant_registry
        hydrate_tenant_registry(self.catalog)

    # ------------------------------------------------------------- DDL
    def create_table(self, name: str, schema: Schema, *,
                     if_not_exists: bool = False, **columnar_opts) -> None:
        if if_not_exists and self.catalog.has_table(name):
            return
        col = self.settings.columnar
        opts = {
            "chunk_row_limit": int(columnar_opts.get("chunk_group_row_limit", col.chunk_group_row_limit)),
            "stripe_row_limit": int(columnar_opts.get("stripe_row_limit", col.stripe_row_limit)),
            "compression": columnar_opts.get("compression", col.compression),
            "compression_level": int(columnar_opts.get("compression_level", col.compression_level)),
        }
        self.catalog.create_table(name, schema, **opts)
        self.catalog.commit()

    def create_distributed_table(self, name: str, dist_column: str,
                                 shard_count: Optional[int] = None,
                                 colocate_with: Optional[str] = None) -> None:
        """reference: create_distributed_table UDF
        (src/backend/distributed/commands/create_distributed_table.c).
        A partitioned parent distributes every partition, the siblings
        colocated, and records the distribution on itself."""
        from citus_tpu_torch.catalog.catalog import DistributionMethod
        t = self.catalog.table(name)
        if t.is_partitioned:
            shard_count = shard_count or self.settings.sharding.shard_count
            t.schema.column(dist_column)
            first = None
            for p in self.catalog.partitions_of(name):
                self.create_distributed_table(
                    p.name, dist_column, shard_count,
                    colocate_with=first or colocate_with)
                first = first or p.name
            t.method = DistributionMethod.HASH
            t.dist_column = dist_column
            t.partition_by["shard_count"] = shard_count
            if first is not None:
                t.colocation_id = self.catalog.table(first).colocation_id
            t.version += 1
            self.catalog.commit()
            return
        from citus_tpu_torch.catalog.stats import table_row_count
        if table_row_count(self.catalog, t) > 0:
            raise UnsupportedFeatureError(
                "distributing a non-empty table is not supported yet; "
                "create, distribute, then load")
        shard_count = shard_count or self.settings.sharding.shard_count
        self.catalog.distribute_table(
            name, dist_column, shard_count, self.catalog.active_node_ids(),
            colocate_with=colocate_with,
            replication_factor=self.settings.sharding.shard_replication_factor)
        try:
            from citus_tpu_torch.integrity import validate_fk_distribution
            validate_fk_distribution(self.catalog, name)
        except Exception:
            self.catalog._load()  # roll back the uncommitted distribution
            raise
        self.catalog.commit()

    def create_reference_table(self, name: str) -> None:
        """reference: create_reference_table UDF (one shard, replicated
        to every active node); its foreign keys are re-validated."""
        t = self.catalog.table(name)
        from citus_tpu_torch.catalog.stats import table_row_count
        if table_row_count(self.catalog, t) > 0:
            raise UnsupportedFeatureError(
                "converting a non-empty table is not supported yet")
        self.catalog.make_reference_table(name,
                                          self.catalog.active_node_ids())
        try:
            from citus_tpu_torch.integrity import validate_fk_distribution
            validate_fk_distribution(self.catalog, name)
        except Exception:
            self.catalog._load()
            raise
        self.catalog.commit()

    def drop_table(self, name: str, *, if_exists: bool = False) -> None:
        """DROP TABLE (reference: citus_drop_all_shards): the catalog
        entry and, at once or at COMMIT inside a transaction, its files.
        A partitioned parent drops its partitions; a table other tables
        reference by foreign key is refused."""
        if if_exists and not self.catalog.has_table(name):
            return
        from citus_tpu_torch.integrity import forbid_drop_referenced
        forbid_drop_referenced(self.catalog, name)
        t = self.catalog.table(name)
        if t.is_partitioned:
            # PostgreSQL: dropping the parent drops its partitions
            for p in list(self.catalog.partitions_of(name)):
                self.drop_table(p.name)
        import re as _re
        for col in t.schema:
            # owned serial sequences die with the table
            m = _re.fullmatch(r"nextval\('([A-Za-z_0-9.]+)'\)",
                              col.default_sql or "")
            if m and m.group(1) == f"{name}_{col.name}_seq" \
                    and m.group(1) in self.catalog.sequences:
                self.catalog.drop_sequence(m.group(1))
        self.catalog.drop_table(name)
        for key in [k for k in self.catalog.enum_columns
                    if k.startswith(name + ".")]:
            del self.catalog.enum_columns[key]
        for key in [k for k in self.catalog.domain_columns
                    if k.startswith(name + ".")]:
            del self.catalog.domain_columns[key]
            self.catalog.tombstone("domain_columns", key)
        for pub in self.catalog.publications.values():
            tl = pub.get("tables")
            if isinstance(tl, list) and name in tl:
                tl.remove(name)  # PostgreSQL drops the table from pubs
        self.catalog.commit()
        self._plan_cache.invalidate_table(name)
        from citus_tpu_torch.executor.device_cache import GLOBAL_CACHE
        GLOBAL_CACHE.drop_table(self.catalog.data_dir, name)

    def _truncate_one(self, name: str) -> None:
        """Truncate one (possibly partitioned) relation; FK validation
        happens at the statement level, list-aware."""
        from citus_tpu_torch.executor.dml import execute_truncate
        from citus_tpu_torch.transaction.locks import EXCLUSIVE
        t = self.catalog.table(name)
        if t.is_partitioned:
            for p in self.catalog.partitions_of(name):
                self._truncate_one(p.name)
            return
        with self._write_lock(t, EXCLUSIVE):
            execute_truncate(self.catalog, self.catalog.table(name))
        self._plan_cache.invalidate_table(name)
        if self._cdc_captures(t.name):
            self.cdc.emit(t.name, "truncate",
                          self.clock.transaction_clock(), force=True)

    # ------------------------------------------------------- partitioning
    def _internal_txn(self):
        """All-or-nothing wrapper for engine-generated multi-statement
        work (multi-partition writes, CREATE TABLE AS): inside a user
        transaction it is transparent (that transaction provides
        atomicity); otherwise it opens, stages, and 2PC-commits an
        internal one, rolling back on any failure."""
        import contextlib

        @contextlib.contextmanager
        def _ctx():
            from citus_tpu_torch.storage.overlay import (
                current_overlay, transaction_overlay,
            )
            if current_overlay() is not None:
                yield
                return
            from citus_tpu_torch.transaction.session import OpenTransaction
            s = self.session()
            s.txn = OpenTransaction(self.txlog.begin(), s.lock_sid)
            s.txn.tombstones_snapshot = {
                k: set(v) for k, v in self.catalog._tombstones.items()}
            try:
                with transaction_overlay(s.txn):
                    yield
            except BaseException:
                self._rollback_txn(s)
                raise
            self._commit_txn(s)
        return _ctx()

    def _create_partition(self, name: str, parent: str, lo_raw, hi_raw,
                          *, if_not_exists: bool = False) -> None:
        """CREATE TABLE name PARTITION OF parent FOR VALUES FROM..TO:
        clone the parent's schema, record physical bounds, inherit the
        parent's distribution (siblings colocate), constraints and
        indexes.  Reference: PostgreSQL partition DDL distributed per
        partition (multi_partitioning_utils.c)."""
        import json as _json

        from citus_tpu_torch.catalog.catalog import DistributionMethod
        from citus_tpu_torch.partitioning import (
            bound_to_physical, check_new_partition,
        )
        if if_not_exists and self.catalog.has_table(name):
            return
        pt = self.catalog.table(parent)
        if not pt.is_partitioned:
            raise CatalogError(f'"{parent}" is not partitioned')
        col = pt.schema.column(pt.partition_by["column"])
        lo = bound_to_physical(col.type, lo_raw)
        hi = bound_to_physical(col.type, hi_raw)
        check_new_partition(self.catalog, pt, lo, hi)
        self.catalog.create_table(
            name, pt.schema,
            chunk_row_limit=pt.chunk_row_limit,
            stripe_row_limit=pt.stripe_row_limit,
            compression=pt.compression,
            compression_level=pt.compression_level)
        t = self.catalog.table(name)
        t.partition_of = {"parent": parent, "lo": lo, "hi": hi}
        # constraints declared on the parent apply to every partition
        # (unique keys were validated at the parent's creation to
        # include the partition column)
        t.foreign_keys = _json.loads(_json.dumps(pt.foreign_keys))
        t.check_constraints = _json.loads(_json.dumps(pt.check_constraints))
        if pt.method == DistributionMethod.HASH:
            siblings = [p for p in self.catalog.partitions_of(parent)
                        if p.name != name and p.is_distributed]
            self.catalog.distribute_table(
                name, pt.dist_column,
                pt.partition_by.get("shard_count")
                or self.settings.sharding.shard_count,
                self.catalog.active_node_ids(),
                colocate_with=siblings[0].name if siblings else None,
                replication_factor=self.settings.sharding.shard_replication_factor)
        self.catalog.commit()
        for ix in pt.indexes:
            self.create_index(f"{name}_{ix['column']}_key", name,
                              ix["column"], unique=ix.get("unique", False))
        self._plan_cache.clear()

    def _fanout_partitions(self, stmt, *, aggregate_explain: bool = False
                           ) -> Result:
        """Run a single-table utility statement (VACUUM) on every
        partition of the named parent, optionally summing the integer
        explain stats."""
        import dataclasses as _dc
        agg: dict = {}
        for p in self.catalog.partitions_of(stmt.table):
            sub = self._execute_stmt(_dc.replace(stmt, table=p.name))
            if aggregate_explain:
                for k, v in sub.explain.items():
                    agg[k] = agg.get(k, 0) + v
        return Result(columns=[], rows=[], explain=agg)

    def _partition_dml(self, stmt, t) -> Result:
        """UPDATE/DELETE against a partitioned parent: run per surviving
        partition (pruned on the WHERE) and sum the counts."""
        import dataclasses

        from citus_tpu_torch.partitioning import prune_partitions
        if getattr(stmt, "returning", None):
            raise UnsupportedFeatureError(
                "RETURNING on a partitioned parent is not supported")
        if isinstance(stmt, A.Update):
            pcol = t.partition_by["column"]
            if any(c == pcol for c, _ in stmt.assignments):
                raise UnsupportedFeatureError(
                    "updating the partition column (row movement) is "
                    "not supported; DELETE the rows and re-INSERT them "
                    "through the parent so they route to the right "
                    "partition")
        total_key = "updated" if isinstance(stmt, A.Update) else "deleted"
        total = 0
        # atomic across partitions: a later partition's failure must not
        # leave earlier partitions' writes committed
        with self._internal_txn():
            for p in prune_partitions(self.catalog, t, stmt.where):
                sub = dataclasses.replace(stmt, table=p.name)
                total += self._execute_stmt(sub).explain.get(total_key, 0)
        return Result(columns=[], rows=[], explain={total_key: total})

    def _copy_into_partitions(self, t, columns) -> int:
        """Route an ingest batch against a partitioned parent to its
        partitions by range (the multi-level ShardIdForTuple)."""
        import numpy as np

        from citus_tpu_torch.partitioning import partition_for_rows
        pcol = t.partition_by["column"]
        if pcol not in columns:
            raise AnalysisError(f"missing column {pcol!r} in ingest batch")
        col = t.schema.column(pcol)
        raw = columns[pcol]
        if isinstance(raw, np.ndarray) and raw.dtype != object \
                and raw.dtype.kind in "iuf":
            # mirror encode_columns' numeric fast path exactly (decimal
            # floats scale by 10^scale with ROUND_HALF_UP; integer input
            # is already physical), so routing and storage agree
            if col.type.kind == "decimal" \
                    and np.issubdtype(raw.dtype, np.floating):
                x = raw * float(10 ** col.type.scale)
                phys = np.where(x >= 0, np.floor(x + 0.5),
                                np.ceil(x - 0.5)).astype(np.int64)
            else:
                phys = raw.astype(col.type.storage_dtype)
        else:
            vals = list(raw)
            if any(v is None for v in vals):
                raise AnalysisError(
                    f'no partition of relation "{t.name}" found for row '
                    f"({pcol} is null)")
            phys = np.asarray([col.type.to_physical(v) for v in vals])
        routed = partition_for_rows(self.catalog, t, phys)
        # one stable sort by partition, then a slice a partition: each
        # partition's rows in their batch order, as a mask of each
        # partition would select them
        part = np.empty(len(phys), np.int64)
        for i, (_pname, mask) in enumerate(routed):
            part[mask] = i
        order = np.argsort(part, kind="stable")
        bounds = np.searchsorted(part[order], np.arange(len(routed) + 1))
        cols_np = {c: (v if isinstance(v, np.ndarray)
                       else np.asarray(v, dtype=object))[order]
                   for c, v in columns.items()}
        n = 0
        # atomic across partitions (a unique violation in the second
        # partition must not leave the first partition's rows behind)
        with self._internal_txn():
            for i, (pname, _mask) in enumerate(routed):
                lo, hi = int(bounds[i]), int(bounds[i + 1])
                sub = {c: v[lo:hi] for c, v in cols_np.items()}
                n += self.copy_from(pname, columns=sub)
        return n

    def _drop_catalog_object(self, section: str, stmt) -> Result:
        """DROP for the simple metadata-object sections (extension,
        domain, collation, publication, statistics)."""
        store = getattr(self.catalog, section)
        if stmt.name not in store:
            if stmt.if_exists:
                return Result(columns=[], rows=[])
            raise CatalogError(
                f'{section[:-1]} "{stmt.name}" does not exist')
        del store[stmt.name]
        self.catalog.tombstone(section, stmt.name)
        self.catalog.ddl_epoch += 1
        self.catalog.commit()
        return Result(columns=[], rows=[])

    # ----------------------------------------------------------- indexes
    def _find_index(self, name: str):
        """-> (table_meta, index dict) or (None, None)."""
        for t in self.catalog.tables.values():
            for ix in t.indexes:
                if ix["name"] == name:
                    return t, ix
        return None, None

    def _drop_index_segments(self, t, column: str) -> None:
        import os as _os

        from citus_tpu_torch.storage.index import drop_segments
        for shard in t.shards:
            for node in shard.placements:
                d = self.catalog.shard_dir(t.name, shard.shard_id, node)
                if _os.path.isdir(d):
                    drop_segments(d, column)

    def _drop_index_segments_if_unindexed(self, table_name: str,
                                          column: str) -> None:
        """Deferred (COMMIT-time) segment removal: a same-name index
        recreated later in the transaction must keep its fresh segments;
        a dropped table's removal owns its whole directory."""
        if not self.catalog.has_table(table_name):
            return
        t2 = self.catalog.table(table_name)
        if t2.index_on(column) is None:
            self._drop_index_segments(t2, column)

    def create_index(self, name: str, table: str, column: str, *,
                     unique: bool = False,
                     if_not_exists: bool = False) -> None:
        """CREATE [UNIQUE] INDEX: register the index, validate existing
        data for UNIQUE, and backfill per-stripe segments on every
        placement (reference: commands/index.c DDL propagation +
        columnar_index_build_range_scan, columnar_tableam.c:1444)."""
        from citus_tpu_torch.storage.index import backfill_index
        from citus_tpu_torch.storage.overlay import current_overlay
        from citus_tpu_torch.transaction.locks import EXCLUSIVE
        _existing_t, existing = self._find_index(name)
        if existing is not None:
            if if_not_exists:
                return
            raise CatalogError(f'index "{name}" already exists')
        t = self.catalog.table(table)
        if t.is_partitioned:
            raise UnsupportedFeatureError(
                "CREATE INDEX on a partitioned parent is not supported; "
                "create the index on each partition")
        t.schema.column(column)  # must exist
        if t.schema.column(column).type.is_float and unique:
            raise UnsupportedFeatureError(
                "UNIQUE indexes over floating-point columns are not "
                "supported (no exact equality)")
        if t.index_on(column) is not None:
            raise CatalogError(
                f'column "{column}" of "{table}" is already indexed')
        ix = {"name": name, "column": column, "unique": bool(unique)}
        # EXCLUSIVE write lock: no ingest may slip between the uniqueness
        # validation / backfill and the catalog flip
        with self._write_lock(t, EXCLUSIVE):
            if unique:
                from citus_tpu_torch.integrity import validate_unique_backfill
                validate_unique_backfill(self.catalog, t, ix)
            # segments first, catalog second: a backfill failure must
            # leave no in-memory claim of an index that was never built
            backfill_index(self.catalog, t, [column])
            txn = current_overlay()
            if txn is not None:
                # ROLLBACK must remove the backfilled segments (additive
                # files: invisible to peers until the catalog commits)
                txn.on_rollback.append(
                    lambda: self._drop_index_segments(t, column))
            t.indexes.append(ix)
            t.version += 1
            self.catalog.ddl_epoch += 1
            self.catalog.commit()
        self._plan_cache.invalidate_table(t.name)

    def _execute_create_index(self, stmt: A.CreateIndex) -> Result:
        self.create_index(stmt.name, stmt.table, stmt.column,
                          unique=stmt.unique,
                          if_not_exists=stmt.if_not_exists)
        return Result(columns=[], rows=[])

    def _execute_drop_index(self, stmt: A.DropIndex) -> Result:
        from citus_tpu_torch.storage.overlay import current_overlay
        from citus_tpu_torch.transaction.locks import EXCLUSIVE
        t, ix = self._find_index(stmt.name)
        if ix is None:
            if stmt.if_exists:
                return Result(columns=[], rows=[])
            raise CatalogError(f'index "{stmt.name}" does not exist')
        with self._write_lock(t, EXCLUSIVE):
            t.indexes.remove(ix)
            # another index may not share the column (enforced at CREATE)
            txn = current_overlay()
            if txn is not None:
                # segment removal is irreversible: defer to COMMIT
                col = ix["column"]
                tname = t.name
                txn.on_commit.append(
                    lambda: self._drop_index_segments_if_unindexed(tname, col))
            else:
                self._drop_index_segments(t, ix["column"])
            t.version += 1
            self.catalog.ddl_epoch += 1
            self.catalog.commit()
        self._plan_cache.invalidate_table(t.name)
        return Result(columns=[], rows=[])

    # ----------------------------------------------------------- ingest
    def copy_from(self, table_name: str,
                  columns: Optional[dict[str, Sequence[Any]]] = None,
                  rows: Optional[Iterable[Sequence[Any]]] = None,
                  column_names: Optional[list[str]] = None,
                  session=None) -> int:
        """Bulk load (the COPY analog).  Either ``columns`` (dict of
        arrays/lists, fastest) or ``rows`` (iterable of tuples).  The
        load commits as one two-phase transaction across placements;
        inside an open transaction (``session`` with BEGIN, or called
        from a statement of one) it stages under the transaction's xid
        and commits with it.  A captured table's rows go to its CDC
        stream at commit.  Omitted columns take their DEFAULTs; a
        partitioned parent routes each row to its partition; foreign
        keys, unique indexes, CHECK constraints and a partition's bounds
        are checked before anything is written."""
        from citus_tpu_torch.storage.overlay import (
            current_overlay, transaction_overlay,
        )
        if session is None:
            # a BEGIN issued through execute() opens a transaction on
            # this thread's default session: a COPY must join it
            session = self._default_session()
        if session.txn is not None and current_overlay() is None:
            if session.txn.failed:
                from citus_tpu_torch.transaction.session import (
                    InFailedTransaction,
                )
                raise InFailedTransaction(
                    "current transaction is aborted, commands ignored "
                    "until end of transaction block")
            with transaction_overlay(session.txn):
                try:
                    return self.copy_from(table_name, columns=columns,
                                          rows=rows,
                                          column_names=column_names)
                except Exception:
                    session.txn.failed = True
                    raise
        t = self.catalog.table(table_name)
        if (columns is None) == (rows is None):
            raise AnalysisError("provide exactly one of columns= or rows=")
        if rows is not None:
            columns = rows_to_columns(t.schema.names, rows, column_names)
            if column_names is not None:
                # rows_to_columns pads OMITTED columns with None; drop
                # them again so their DEFAULTs apply (a column the user
                # listed keeps its explicit NULLs)
                listed = set(column_names)
                columns = {c: v for c, v in columns.items()
                           if c in listed
                           or not t.schema.column(c).default_sql}
        if t.is_partitioned:
            # two-level routing: range partition first, then hash shard
            # within it (each recursive call re-enters with the same
            # session/transaction context)
            return self._copy_into_partitions(t, columns)
        columns = self._fill_defaults(t, columns)
        self._check_domains(t, columns)
        values, validity = encode_columns(self.catalog, t, columns)
        if t.partition_of is not None:
            from citus_tpu_torch.partitioning import check_partition_bounds
            check_partition_bounds(self.catalog, t, values, validity)
        if t.check_constraints:
            from citus_tpu_torch.integrity import enforce_check_constraints
            enforce_check_constraints(self.catalog, t, values, validity)
        remote_n = 0
        if self.catalog.remote_data is not None \
                and not getattr(self._remote_exec_guard, "v", False):
            values, validity, remote_n = self._route_remote_batch(
                t, values, validity)
            if not values or len(next(iter(values.values()))) == 0:
                # every row went to remote hosts
                self.counters.bump("rows_ingested", remote_n)
                return remote_n
        from citus_tpu_torch.transaction.locks import EXCLUSIVE, SHARED
        txn = current_overlay()
        # unique enforcement needs probe+write atomicity: two SHARED
        # ingests could both miss the probe and insert the same key.
        # The mode is re-derived from the fresh TableMeta inside the
        # lock — a CREATE UNIQUE INDEX committed after our stale fetch
        # must escalate us before the probe runs.
        lock_mode = EXCLUSIVE if t.unique_indexes else SHARED
        while True:
            with self._write_lock(t, lock_mode):
                t = self.catalog.table(table_name)  # re-fetch: fresh placements
                if t.unique_indexes and lock_mode == SHARED:
                    lock_mode = EXCLUSIVE
                    continue  # retry under the stronger lock
                self._copy_from_locked(t, txn, columns, values, validity)
                break
        n = len(next(iter(values.values()))) if values else 0
        self.counters.bump("rows_ingested", n + remote_n)
        if self._cdc_captures(t.name) and n:
            self._emit_cdc(t.name, "insert",
                           rows=self._decode_rows(t, values, validity),
                           columns=t.schema.names)
        return n + remote_n

    def copy_from_csv(self, table_name: str, path: str, *,
                      delimiter: str = ",", header: bool = False,
                      null_string: str = "", batch_rows: int = 200_000) -> int:
        """Bulk load from a CSV file, streamed in batches (the reference's
        COPY FROM with per-shard stream switchover,
        commands/multi_copy.c)."""
        import csv
        t = self.catalog.table(table_name)
        names = t.schema.names
        total = 0

        def load(batch: list) -> int:
            # copy_from(rows=batch), its rows turned into columns by one
            # transposition (rows_to_columns' check and message)
            for row in batch:
                if len(row) != len(names):
                    raise AnalysisError(f"row has {len(row)} values, "
                                        f"expected {len(names)}")
            return self.copy_from(table_name, columns={
                c: [None if v == null_string else v for v in col]
                for c, col in zip(names, zip(*batch))})
        with open(path, newline="") as fh:
            reader = csv.reader(fh, delimiter=delimiter)
            if header:
                next(reader, None)
            batch: list = []
            for row in reader:
                batch.append(row)
                if len(batch) >= batch_rows:
                    total += load(batch)
                    batch = []
            if batch:
                total += load(batch)
        return total

    @staticmethod
    def _open_csv_writer(fh, columns, *, delimiter: str, header: bool):
        """One CSV emission convention for both COPY TO forms."""
        import csv
        w = csv.writer(fh, delimiter=delimiter)
        if header:
            w.writerow(columns)
        return w

    def copy_to_csv(self, table_name: str, path: str, *,
                    delimiter: str = ",", header: bool = False,
                    null_string: str = "") -> int:
        """Streaming CSV export: shards are read batch by batch, decoded,
        and written incrementally (symmetric with copy_from_csv)."""
        import os as _os
        from citus_tpu_torch.storage import ShardReader
        from citus_tpu_torch.transaction.snapshot import read_generation
        t = self.catalog.table(table_name)
        names = t.schema.names
        total = 0
        # NOTE: the export streams to the caller's file, so a mid-export
        # flip cannot be retried transparently; capture the generation
        # and fail loudly on a torn export instead of silently writing
        # a mixture (readers of query results get the retrying
        # snapshot_read path; COPY TO keeps PostgreSQL's "repeatable
        # read within the statement" spirit by detecting the overlap)
        gen0, busy0 = read_generation(self.catalog.data_dir, t)
        with open(path, "w", newline="") as fh:
            w = self._open_csv_writer(fh, names, delimiter=delimiter,
                                      header=header)
            for shard in t.shards:
                d = self.catalog.shard_dir(table_name, shard.shard_id,
                                           shard.placements[0])
                if not _os.path.isdir(d):
                    continue
                reader = ShardReader(d, t.schema)
                from citus_tpu_torch import types as T
                for batch in reader.scan(t.schema.physical_names(names)):
                    # a batch is decoded column by column and written
                    # row by row; a NULL is written as null_string
                    decoded = []
                    for c in names:
                        col = t.schema.column(c)
                        vals = batch.values[c]
                        if col.type.is_text:
                            out = self.catalog.decode_strings(
                                table_name, c, vals.tolist())
                        elif col.type.kind == "uuid":
                            lane = batch.values[T.uuid_lane_name(c)]
                            out = [T.uuid_from_lane_pair(int(h), int(l))
                                   for h, l in zip(vals, lane)]
                        else:
                            conv = col.type.from_physical
                            out = [conv(v) for v in vals.tolist()]
                        m = batch.validity[c]
                        if m is not None:
                            out = [v if ok else null_string
                                   for v, ok in zip(out, m.tolist())]
                        decoded.append(out)
                    w.writerows(zip(*decoded))
                    total += batch.row_count
        gen1, busy1 = read_generation(self.catalog.data_dir, t)
        if busy0 or busy1 or gen1 != gen0:
            raise ExecutionError(
                "concurrent metadata flip during COPY TO; re-run the "
                "export")
        return total

    def _fill_defaults(self, t, columns: dict) -> dict:
        """Fill columns absent from an ingest batch from their DEFAULT
        expressions (reference: pg_attrdef defaults applied by the
        rewriter).  nextval defaults draw one value PER ROW; other
        defaults are constants folded once."""
        missing = [c for c in t.schema
                   if c.name not in columns and c.default_sql]
        if not missing:
            return columns
        n = len(next(iter(columns.values()))) if columns else 1
        out = dict(columns)
        from citus_tpu_torch.planner.parser import Parser
        cache = self._default_expr_cache
        for col in missing:
            e = cache.get(col.default_sql)
            if e is None:
                e = Parser(col.default_sql).parse_expr()
                if len(cache) > 512:
                    cache.clear()
                cache[col.default_sql] = e
            if isinstance(e, A.FuncCall) and e.name == "nextval" \
                    and e.args and isinstance(e.args[0], A.Literal):
                seq = str(e.args[0].value)
                out[col.name] = [self.catalog.nextval(seq)
                                 for _ in range(n)]
            else:
                out[col.name] = [_eval_const(e)] * n
        return out

    def _copy_from_locked(self, t, txn, columns, values, validity) -> None:
        """copy_from's body under the table write lock: FK and unique
        probes, then the staged or 2PC ingest."""
        import contextlib

        from citus_tpu_torch.transaction.locks import SHARED
        with contextlib.ExitStack() as stack:
            if t.foreign_keys:
                # hold the parents' group locks (SHARED) across probe +
                # write, so a concurrent parent DELETE (EXCLUSIVE on the
                # parent group) cannot interleave between the FK check
                # and the ingest commit
                from citus_tpu_torch.integrity import check_ingest
                from citus_tpu_torch.transaction.write_locks import (
                    group_resource, group_write_lock,
                )
                parents = {}
                for fk in t.foreign_keys:
                    p = self.catalog.table(fk["ref_table"])
                    parents[group_resource(p)] = p
                for res in sorted(parents):
                    if txn is not None:
                        txn.hold_group_lock(self, parents[res], SHARED)
                    else:
                        stack.enter_context(group_write_lock(
                            self.catalog, parents[res], SHARED,
                            lock_manager=self.locks,
                            timeout=self.settings.executor.lock_timeout_s))
                check_ingest(self, t, columns, values, validity)
            if t.unique_indexes:
                from citus_tpu_torch.integrity import check_unique_ingest
                check_unique_ingest(self, t, values, validity)
            if txn is not None:
                # stage under the open transaction; COMMIT flips it.  On
                # failure, register (don't abort) what was staged, so
                # ROLLBACK [TO SAVEPOINT] cleans exactly this statement
                ing = TableIngestor(self.catalog, t, txlog=None)
                ing.xid = txn.xid
                try:
                    ing.append(values, validity)
                    for w in ing._writers.values():
                        w.flush()
                finally:
                    txn.record_ingest(
                        t.name, [w.directory for w in ing._writers.values()])
            else:
                ing = TableIngestor(self.catalog, t, txlog=self.txlog)
                try:
                    ing.append(values, validity)
                except BaseException:
                    ing.abort()
                    raise
                ing.finish()

    def _route_remote_batch(self, t, values, validity):
        """Split a physical ingest batch by shard ownership: rows whose
        shard another coordinator hosts ship over the data plane
        (reference: distributed COPY forwarding per-shard streams to the
        owning worker, commands/multi_copy.c); the local remainder
        continues through the normal path.  Returns (local_values,
        local_validity, rows_shipped)."""
        import numpy as np

        from citus_tpu_torch.catalog.hashing import hash_int64
        from citus_tpu_torch.storage.overlay import current_overlay
        cat = self.catalog
        wire = self.settings.executor.wire_format
        if not t.is_distributed:
            # reference/local tables: every remote host with a placement
            # receives the FULL batch; rows counted once, from the local
            # copy when one exists
            eps = {cat.node_endpoint(nd) for s in t.shards
                   for nd in s.placements if cat.is_remote_node(nd)}
            if not eps:
                return values, validity, 0
            if current_overlay() is not None:
                _unported("writes to remote-hosted placements inside an "
                          "explicit transaction", "A13")
            shipped = 0
            for ep in eps:
                shipped = cat.remote_data.ship_batch(ep, t.name, values,
                                                     validity, wire=wire)
            if any(not cat.is_remote_node(nd)
                   for s in t.shards for nd in s.placements):
                return values, validity, 0  # local ingest counts them
            return {}, {}, shipped
        # replicated shards spanning hosts: routing writes the primary
        # placement only, so a replica on another host would diverge —
        # fail closed, as the reference does
        if any(len(s.placements) > 1
               and any(cat.is_remote_node(nd) for nd in s.placements)
               for s in t.shards):
            raise UnsupportedFeatureError(
                "writing to a distributed table whose replicated shard "
                "placements span hosts is not supported yet (only one "
                "placement would receive the rows, diverging replicas)")
        owners = [t.shards[si].placements[0] for si in range(t.shard_count)]
        if not any(cat.is_remote_node(o) for o in owners):
            return values, validity, 0
        if current_overlay() is not None:
            _unported("writes to remote-hosted shards inside an explicit "
                      "transaction (cross-host 2PC)", "A13")
        if t.unique_indexes or t.foreign_keys:
            raise UnsupportedFeatureError(
                "unique/FK-constrained tables cannot span remote-hosted "
                "shards yet (constraint probes are host-local)")
        dist = values[t.dist_column].astype(np.int64)
        idx = t.route_hashes(hash_int64(dist))
        # one batch per owning host
        by_endpoint: dict = {}
        remote_rows = np.zeros(len(dist), bool)
        for si, owner in enumerate(owners):
            if not cat.is_remote_node(owner):
                continue
            sel = idx == si
            if not sel.any():
                continue
            m = by_endpoint.setdefault(cat.node_endpoint(owner),
                                       np.zeros(len(dist), bool))
            m |= sel
            remote_rows |= sel
        shipped = 0
        for ep, m in by_endpoint.items():
            shipped += cat.remote_data.ship_batch(
                ep, t.name, {c: v[m] for c, v in values.items()},
                {c: x[m] for c, x in validity.items()}, wire=wire)
        if not remote_rows.any():
            return values, validity, 0
        keep = ~remote_rows
        return ({c: v[keep] for c, v in values.items()},
                {c: x[keep] for c, x in validity.items()}, shipped)

    # ------------------------------------------------------------ domains
    def _domain_columns_of(self, t) -> list[tuple[str, str, dict]]:
        """[(column, domain name, domain def)] for ``t``."""
        out = []
        for cname in t.schema.names:
            dn = self.catalog.domain_columns.get(f"{t.name}.{cname}")
            if dn is None:
                continue
            dom = self.catalog.domains.get(dn)
            if dom is not None:
                out.append((cname, dn, dom))
        return out

    def _check_domain_values(self, dn: str, dom: dict, values) -> None:
        """Evaluate one domain's CHECK over an iterable of logical
        values, on the host, once per distinct value (the memo keeps a
        categorical bulk load cheap); NULL passes CHECK (NOT NULL is the
        column's)."""
        import numpy as _np

        from citus_tpu_torch.planner.parser import Parser as _P
        if not dom.get("check"):
            return
        expr = _P(dom["check"]).parse_expr()
        verdicts: dict = {}
        for v in values:
            if v is None:
                continue
            if isinstance(v, _np.generic):
                v = v.item()
            ok = verdicts.get(v)
            if ok is None:
                sub = {A.ColumnRef("value"): _pylit(v)}
                try:
                    ok = _eval_const(_replace_exprs(expr, sub)) is True
                except Exception:
                    raise UnsupportedFeatureError(
                        f'cannot evaluate CHECK of domain "{dn}" '
                        f"({dom['check']!r})")
                verdicts[v] = ok
            if not ok:
                raise ExecutionError(
                    f'value {v!r} for domain "{dn}" violates check '
                    f"constraint ({dom['check']})")

    def _check_domains(self, t, columns) -> None:
        """Domain CHECK enforcement at ingest (every insert; VALUE names
        the checked value)."""
        for cname, dn, dom in self._domain_columns_of(t):
            if cname in columns:
                self._check_domain_values(dn, dom, columns[cname])

    def _check_domains_physical(self, t, values, validity) -> None:
        """Same enforcement over PHYSICAL column arrays (the UPDATE
        re-insert path): decode back to logical values first."""
        import numpy as _np

        from citus_tpu_torch import types as T
        for cname, dn, dom in self._domain_columns_of(t):
            if cname not in values or not dom.get("check"):
                continue
            col = t.schema.column(cname)
            vals = []
            for phys, ok in zip(values[cname], validity[cname]):
                if not ok:
                    continue
                if col.type.is_text:
                    vals.append(self.catalog.decode_strings(
                        t.name, cname, [int(phys)])[0])
                elif col.type.kind == "uuid":
                    continue  # recombined below from the lane pair
                else:
                    vals.append(col.type.from_physical(
                        _np.asarray(phys).item()))
            if col.type.kind == "uuid":
                lane = values[T.uuid_lane_name(cname)]
                vals = [T.uuid_from_lane_pair(int(h), int(lo))
                        for h, lo, ok in zip(values[cname], lane,
                                             validity[cname]) if ok]
            self._check_domain_values(dn, dom, vals)

    # ------------------------------------------------ change data capture
    def _cdc_captures(self, table: str) -> bool:
        """The table's changes are captured when CDC is globally on OR
        any publication covers it (reference: commands/publication.c —
        publications gate logical decoding per table)."""
        if self.cdc.enabled:
            return True
        if not self.catalog.publications:
            return False
        # a publication on a partitioned parent covers its partitions
        # (writes route to leaves before this gate runs)
        names = {table}
        t = self.catalog.tables.get(table)
        if t is not None and t.partition_of is not None:
            names.add(t.partition_of["parent"])
        for pub in self.catalog.publications.values():
            tl = pub.get("tables")
            if tl == "all" or (isinstance(tl, list) and names & set(tl)):
                return True
        return False

    def _emit_cdc(self, table: str, op: str, **kw) -> None:
        """Emit a change event — or, inside an open transaction, defer
        it to COMMIT (PostgreSQL logical decoding emits on commit)."""
        from citus_tpu_torch.storage.overlay import current_overlay
        txn = current_overlay()
        if txn is not None:
            txn.cdc_events.append((table, op, kw))
        else:
            self.cdc.emit(table, op, self.clock.transaction_clock(),
                          force=True, **kw)

    def _decode_rows(self, t, values, validity) -> list:
        """A physical batch -> Python rows, as a SELECT reads them back
        (the CDC stream's row format)."""
        from citus_tpu_torch import types as T
        out = []
        names = t.schema.names
        n = len(next(iter(values.values())))
        text_cache = {}
        for c in names:
            if t.schema.column(c).type.is_text:
                text_cache[c] = self.catalog.decode_strings(
                    t.name, c, values[c].tolist())
        for i in range(n):
            row = []
            for c in names:
                col = t.schema.column(c)
                if not validity[c][i]:
                    row.append(None)
                elif col.type.is_text:
                    row.append(text_cache[c][i])
                elif col.type.kind == "uuid":
                    row.append(T.uuid_from_lane_pair(
                        int(values[c][i]),
                        int(values[T.uuid_lane_name(c)][i])))
                else:
                    row.append(col.type.from_physical(values[c][i].item()))
            out.append(row)
        return out

    # ---------------------------------------------------------- sessions
    def session(self):
        """Open an interactive session (the psql-connection analog):
        BEGIN/COMMIT/ROLLBACK and savepoints.  Statements run through
        ``Cluster.execute`` directly use this thread's default session,
        so ``cl.execute("BEGIN")`` works too."""
        from citus_tpu_torch.transaction.session import Session
        return Session(self)

    def _default_session(self):
        """One implicit session PER THREAD: a BEGIN issued on one thread
        must not pull other threads' autocommit statements into its
        block.  CPython reuses thread idents, so each entry remembers its
        owning Thread — a recycled ident rolls back the dead owner's
        abandoned transaction instead of inheriting it."""
        import threading as _th
        me = _th.current_thread()
        entry = self._default_sessions.get(me.ident)
        if entry is not None:
            owner, s = entry
            if owner is me:
                return s
            if s.txn is not None:
                self._rollback_txn(s)
        s = self.session()
        self._default_sessions[me.ident] = (me, s)
        return s

    #: statement types allowed inside BEGIN..COMMIT: catalog mutations
    #: stage in memory (Catalog.commit defers), physical file actions
    #: defer to COMMIT or register rollback cleanups (reference: DDL in
    #: transaction blocks via citus_ProcessUtility, utility_hook.c:148).
    #: The object statements of ROADMAP.md A14b pass this guard and are
    #: refused when they dispatch.
    _TXN_ALLOWED = (A.Select, A.WithSelect, A.SetOp, A.Explain, A.Insert,
                    A.Update, A.Delete,
                    A.CreateTable, A.DropTable, A.CreateIndex, A.DropIndex,
                    A.CreateSchema, A.CreateView, A.DropView,
                    A.CreateSequence, A.DropSequence, A.CreateFunction,
                    A.DropFunction, A.CreateType, A.DropType, A.CreateRole,
                    A.DropRole, A.Grant, A.CreatePolicy, A.DropPolicy,
                    A.CreateTrigger, A.DropTrigger, A.AlterTableRls,
                    A.AlterTable, A.CreateExtension, A.DropExtension,
                    A.CreateDomain, A.DropDomain, A.CreateCollation,
                    A.DropCollation, A.CreatePublication,
                    A.DropPublication, A.CreateStatistics,
                    A.DropStatistics, A.Analyze, A.CreateTableAs,
                    A.SetConfig, A.ShowConfig, A.UtilityCall)

    def _guard_in_txn(self, stmt) -> None:
        if not isinstance(stmt, self._TXN_ALLOWED):
            raise UnsupportedFeatureError(
                f"{type(stmt).__name__} cannot run inside a transaction "
                "block")
        if isinstance(stmt, A.AlterTable) and stmt.action in (
                "rename_table", "rename_column"):
            # renames shard-data directories / dictionary and segment
            # files in place — not stageable
            raise UnsupportedFeatureError(
                "ALTER TABLE RENAME cannot run inside a transaction block")
        if isinstance(stmt, A.UtilityCall) and stmt.name not in (
                "create_distributed_table", "create_reference_table"):
            raise UnsupportedFeatureError(
                f"{stmt.name}() cannot run inside a transaction block")

    def _execute_transaction_stmt(self, session, stmt) -> Result:
        """BEGIN/COMMIT/ROLLBACK/SAVEPOINT state machine (reference:
        CoordinatedTransactionCallback, transaction_management.c:319;
        subtransaction callback :176)."""
        from citus_tpu_torch.transaction.session import (
            InFailedTransaction, OpenTransaction,
        )
        kind = stmt.kind
        txn = session.txn
        if kind == "begin":
            if txn is not None:
                return Result(columns=[], rows=[],
                              explain={"warning": "there is already a "
                                       "transaction in progress"})
            session.txn = OpenTransaction(self.txlog.begin(),
                                          session.lock_sid)
            # DDL rollback restores drop-tombstones with the document
            session.txn.tombstones_snapshot = {
                k: set(v) for k, v in self.catalog._tombstones.items()}
            return Result(columns=[], rows=[],
                          explain={"transaction": "begin"})
        if kind in ("commit", "rollback"):
            if txn is None:
                return Result(columns=[], rows=[],
                              explain={"warning": "there is no "
                                       "transaction in progress"})
            if kind == "commit" and not txn.failed:
                self._commit_txn(session)
                return Result(columns=[], rows=[],
                              explain={"transaction": "commit"})
            # COMMIT of an aborted transaction rolls back
            self._rollback_txn(session)
            return Result(columns=[], rows=[],
                          explain={"transaction": "rollback"})
        if txn is None:
            raise TransactionError(
                f"{kind.upper()} can only be used in transaction blocks")
        if kind in ("savepoint", "release") and txn.failed:
            raise InFailedTransaction(
                "current transaction is aborted, commands ignored until "
                "end of transaction block")
        if kind == "savepoint":
            txn.savepoints.append((stmt.name, txn.snapshot(self.catalog)))
            return Result(columns=[], rows=[])
        for i in range(len(txn.savepoints) - 1, -1, -1):
            if txn.savepoints[i][0] != stmt.name:
                continue
            if kind == "rollback_to":
                txn.restore(txn.savepoints[i][1], self)
                # the savepoint itself survives; later ones die
                del txn.savepoints[i + 1:]
                self._plan_cache.clear()
            else:  # release
                del txn.savepoints[i:]
            return Result(columns=[], rows=[])
        txn.failed = True  # an error in a txn block aborts it (25P02)
        raise TransactionError(f'savepoint "{stmt.name}" does not exist')

    def _commit_txn(self, session) -> None:
        """PREPARED -> COMMITTED -> flip staged state -> DONE across every
        placement the transaction touched (reference: pre-commit PREPARE
        on all write connections, transaction_management.c:319).  Every
        touched table's version bumps, so the device cache and the plan
        cache never serve a pre-commit scan."""
        import contextlib

        from citus_tpu_torch.storage.deletes import commit_staged_deletes
        from citus_tpu_torch.storage.writer import commit_staged
        from citus_tpu_torch.transaction.manager import TxState
        from citus_tpu_torch.transaction.snapshot import flip_generation
        from citus_tpu_torch.transaction.write_locks import group_resource

        txn = session.txn
        try:
            if not (txn.has_writes or txn.catalog_dirty or txn.on_commit):
                self.txlog.release(txn.xid)
                return
            try:
                # catalog (version bumps + staged DDL) persisted before
                # the COMMITTED record: roll-forward must find everything
                # it references on disk
                for name in sorted(txn.tables):
                    if self.catalog.has_table(name):
                        self.catalog.table(name).version += 1
                self.catalog._end_staging(txn)
                self.catalog.commit()
                if txn.has_writes:
                    payload = {"kind": "txn",
                               "placements": sorted(txn.delete_dirs),
                               "ingest_placements": sorted(txn.ingest_dirs),
                               "tables": sorted(txn.tables)}
                    self.txlog.log(txn.xid, TxState.PREPARED, payload)
                    self.txlog.log(txn.xid, TxState.COMMITTED, payload)
                    # one flip bracket per touched colocation group: a
                    # snapshot read sees all of the transaction or none
                    groups = {}
                    for name in sorted(txn.tables):
                        if self.catalog.has_table(name):
                            t0 = self.catalog.table(name)
                            groups.setdefault(group_resource(t0), t0)
                    with contextlib.ExitStack() as flips:
                        for res in sorted(groups):
                            flips.enter_context(flip_generation(
                                self.catalog.data_dir, groups[res]))
                        for d in sorted(txn.delete_dirs):
                            commit_staged_deletes(d, txn.xid)
                        for d in sorted(txn.ingest_dirs):
                            commit_staged(d, txn.xid)
                    self.txlog.log(txn.xid, TxState.DONE)
                else:
                    self.txlog.release(txn.xid)
                # deferred physical DDL effects (table file removal), only
                # after the catalog flip is durable
                for act in txn.on_commit:
                    act()
            except BaseException:
                # stop driving; recovery decides the outcome from the log
                self.txlog.release(txn.xid)
                raise
            self._plan_cache.clear()
            if txn.cdc_events:
                clock = self.clock.transaction_clock()
                for table, op, kw in txn.cdc_events:
                    self.cdc.emit(table, op, clock, force=True, **kw)
        finally:
            self.catalog._end_staging(txn)
            txn.release_locks(self)
            session.txn = None

    def _rollback_txn(self, session) -> None:
        from citus_tpu_torch.storage.deletes import abort_staged_deletes
        from citus_tpu_torch.storage.writer import abort_staged

        txn = session.txn
        try:
            for d in sorted(txn.ingest_dirs):
                abort_staged(d, txn.xid)
            for d in sorted(txn.delete_dirs):
                abort_staged_deletes(d, txn.xid)
            # physical artifacts staged by DDL, newest first
            for act in reversed(txn.on_rollback):
                try:
                    act()
                except Exception:  # noqa: BLE001 -- best effort: orphan files never affect reads
                    pass
            if txn.catalog_dirty:
                # discard staged DDL: the on-disk document was never
                # touched, so reloading it restores the pre-BEGIN state
                self._reload_catalog()
                self.catalog._tombstones = {
                    k: set(v) for k, v in txn.tombstones_snapshot.items()}
            self.txlog.release(txn.xid)
            self._plan_cache.clear()
        finally:
            self.catalog._end_staging(txn)
            txn.release_locks(self)
            session.txn = None

    # -------------------------------------------------------------- SQL
    def execute(self, sql: str, params: Optional[Sequence[Any]] = None,
                role: Optional[str] = None, session=None) -> Result:
        """Run one SQL string on ``session`` (default: this thread's),
        ``$N`` placeholders taking ``params``.
        Safe to call from several threads at once: the plan cache, the
        counters, the device cache, the kernel builds and the launch
        counters are locked, and each statement keeps its own scan
        state.  Concurrent literal variants of one query coalesce into
        one scan when ``citus.megabatch_window_ms`` is set
        (executor/megabatch.py).  Inside BEGIN..COMMIT a statement's
        writes stage under the transaction and its reads see them; an
        error aborts the block until ROLLBACK."""
        if role is not None:
            _unported("roles and row-level security (role=)", "A14b")
        if session is None:
            session = self._default_session()
        result = Result(columns=[], rows=[])
        with _trace.span("parse"):
            stmts = parse_sql(sql)
        t0 = _trace.clock()
        for stmt in stmts:
            if isinstance(stmt, A.TransactionStmt):
                result = self._execute_transaction_stmt(session, stmt)
                continue
            txn = session.txn
            if txn is not None and txn.failed:
                from citus_tpu_torch.transaction.session import (
                    InFailedTransaction,
                )
                raise InFailedTransaction(
                    "current transaction is aborted, commands ignored "
                    "until end of transaction block")
            if isinstance(stmt, (A.Prepare, A.ExecutePrepared,
                                 A.Deallocate)):
                try:
                    result = self._execute_prepared_stmt(session, stmt)
                except Exception:
                    # PostgreSQL: any error aborts the block
                    if txn is not None:
                        txn.failed = True
                    raise
                continue
            if txn is None:
                result = self._execute_in_session(stmt, sql, stmts, params)
                continue
            from citus_tpu_torch.storage.overlay import transaction_overlay
            try:
                self._guard_in_txn(stmt)
                with transaction_overlay(txn):
                    result = self._execute_in_session(stmt, sql, stmts,
                                                      params)
            except Exception:
                # PostgreSQL: any error aborts the transaction block
                # until ROLLBACK [TO SAVEPOINT]
                txn.failed = True
                raise
        # the nested execute() of an EXECUTE already recorded the
        # underlying statement: the wrapper is not counted twice
        if not (len(stmts) == 1 and isinstance(stmts[0], A.ExecutePrepared)):
            self._record_statement(sql, result, _trace.clock() - t0)
        return result

    def _execute_in_session(self, stmt, sql: str, stmts: list,
                            params) -> Result:
        """One statement through parameter substitution and plan-cache
        keying.  A parameterized single SELECT takes the generic plan
        (``_execute_param_select``); any other statement has its $N
        replaced by literals (``rewrite_params``) and is not cached."""
        if params is not None:
            if len(stmts) == 1 and isinstance(stmt, A.Select):
                r = self._execute_param_select(sql, stmt, list(params))
                if r is not None:
                    return r
            from citus_tpu_torch.planner.recursive import rewrite_params
            stmt = rewrite_params(stmt, list(params))
        key = sql if (len(stmts) == 1 and params is None) else None
        return self._execute_stmt(stmt, key)

    def _execute_prepared_stmt(self, session, stmt) -> Result:
        """PREPARE / EXECUTE / DEALLOCATE.  The stored unit is SQL text,
        so EXECUTE rides the text-keyed generic-plan cache: one plan and
        one kernel build serve every invocation."""
        if isinstance(stmt, A.Prepare):
            if stmt.name in session.prepared:
                raise CatalogError(
                    f'prepared statement "{stmt.name}" already exists')
            session.prepared[stmt.name] = stmt.sql
            return Result(columns=[], rows=[])
        if isinstance(stmt, A.Deallocate):
            if stmt.name is None:
                session.prepared.clear()
                return Result(columns=[], rows=[])
            if session.prepared.pop(stmt.name, None) is None:
                raise CatalogError(
                    f'prepared statement "{stmt.name}" does not exist')
            return Result(columns=[], rows=[])
        sql = session.prepared.get(stmt.name)
        if sql is None:
            raise CatalogError(
                f'prepared statement "{stmt.name}" does not exist')
        args = [_eval_const(a) for a in stmt.args]
        return self.execute(sql, params=args or None, session=session)

    def _execute_param_select(self, sql: str, stmt: A.Select,
                              params: list) -> Optional[Result]:
        """A parameterized SELECT through the generic-plan cache: bound
        once with $N slots under ``("$param", sql)``, shards pruned at
        execution for each value set, the values in the kernels'
        parameter block (so every value set shares one build).  None
        when the query's shape needs the literal-substitution
        fallback."""
        from citus_tpu_torch.planner.recursive import has_subquery
        if not isinstance(stmt.from_, A.TableRef):
            return None
        if self.catalog.has_table(stmt.from_.name) \
                and self.catalog.table(stmt.from_.name).is_partitioned:
            return None  # the fallback refuses it in _execute_stmt
        if stmt.distinct_on:
            return None  # DISTINCT ON dedups through _execute_distinct_on
        if any(isinstance(i.expr, A.WindowCall) for i in stmt.items):
            return None
        exprs = ([i.expr for i in stmt.items] + [stmt.where, stmt.having]
                 + list(stmt.group_by) + [o.expr for o in stmt.order_by])
        if any(e is not None and has_subquery(e) for e in exprs):
            return None
        n_params = _max_param_index(stmt)
        if n_params > len(params):
            raise AnalysisError(
                f"query references ${n_params} but only "
                f"{len(params)} parameters were supplied")
        key = ("$param", sql)
        backend = self.settings.executor.task_executor_backend
        cache_on = self.settings.planner.plan_cache_mode != "force_custom"
        _trace.set_phase("plan")
        if cache_on:
            entry = self._plan_cache.lookup(key, self.catalog, backend)
            if entry is not None:
                self.counters.bump("plan_cache_hits")
                with _trace.span("plan", cache_hit=True):
                    pass
                return execute_select(self.catalog, entry.bound,
                                      self.settings, plan=entry.plan,
                                      param_values=params,
                                      device=self.device, mesh=self.mesh)
        with _trace.span("plan", cache_hit=False):
            try:
                with _trace.span("bind"):
                    bound = bind_select(self.catalog, stmt,
                                        param_count=n_params)
            except UnsupportedFeatureError:
                return None  # fall back to literal substitution
            from citus_tpu_torch.planner.physical import plan_select
            plan = plan_select(
                self.catalog, bound,
                direct_limit=self.settings.planner.direct_gid_limit)
            if cache_on:
                self._plan_cache.put(key, bound, plan, self.catalog, backend)
                self.counters.bump("plan_cache_misses")
        return execute_select(self.catalog, bound, self.settings, plan=plan,
                              param_values=params, device=self.device,
                              mesh=self.mesh)

    def _record_statement(self, sql: str, result: Result,
                          elapsed: float) -> None:
        """Per-statement attribution: citus_stat_statements, the tenant
        window, the scheduler's latency histogram (router queries under
        their key, analytics under "*") and, for a query that rode a
        megabatch, its occupancy."""
        explain = result.explain or {}
        rkey = explain.get("router_key")
        self.query_stats.record(sql, elapsed, result.rowcount,
                                str(explain.get("strategy", "utility")),
                                partition_key="" if rkey is None
                                else str(rkey))
        if rkey is not None:
            self.tenant_stats.record(str(rkey), elapsed)
        if "strategy" in explain:
            from citus_tpu_torch.workload import GLOBAL_SCHEDULER, tenant_key
            GLOBAL_SCHEDULER.record_latency(tenant_key(rkey),
                                            elapsed * 1000.0)
        mb = explain.get("megabatch")
        if mb:
            from citus_tpu_torch.executor.megabatch import GLOBAL_MEGABATCH
            GLOBAL_MEGABATCH.note_query_occupancy(int(mb.get("occupancy", 1)))

    def _cached_select_plan(self, stmt: A.Select, key):
        """Bind + plan a single-table SELECT through the plan cache,
        auto-parameterizing filter literals so literal variants of one
        query family share a structural fingerprint (and thus built
        workers, executor/kernel_cache.py).  ``key`` None skips caching.
        Returns (bound, plan, values).  Its ``plan`` span records the
        cache's hit or miss and the plan's fingerprint (what EXPLAIN
        ANALYZE's ``Plan Cache`` line reads)."""
        from citus_tpu_torch.executor.kernel_cache import plan_fingerprint
        backend = self.settings.executor.task_executor_backend
        cache_on = key is not None \
            and self.settings.planner.plan_cache_mode != "force_custom"
        _trace.set_phase("plan")
        if cache_on:
            entry = self._plan_cache.lookup(key, self.catalog, backend)
            if entry is not None:
                self.counters.bump("plan_cache_hits")
                with _trace.span("plan", cache_hit=True) as psp:
                    if psp.recording:
                        psp.set(fingerprint=plan_fingerprint(
                            entry.plan)[:12])
                return entry.bound, entry.plan, entry.values
        with _trace.span("plan", cache_hit=False) as psp:
            with _trace.span("bind"):
                bound = bind_select(self.catalog, stmt)
            values = None
            if cache_on:
                from citus_tpu_torch.planner.auto_param import (
                    auto_parameterize,
                )
                ap = auto_parameterize(bound)
                if ap is not None:
                    bound, values = ap
            from citus_tpu_torch.planner.physical import plan_select
            plan = plan_select(
                self.catalog, bound,
                direct_limit=self.settings.planner.direct_gid_limit)
            if cache_on:
                self._plan_cache.put(key, bound, plan, self.catalog, backend,
                                     values=values)
                self.counters.bump("plan_cache_misses")
            if psp.recording:
                psp.set(fingerprint=plan_fingerprint(plan)[:12])
        return bound, plan, values

    # parsed DEFAULT expressions keyed by their SQL text (immutable)
    _default_expr_cache: dict = {}

    def _compute_ndistinct(self, table, columns):
        from citus_tpu_torch.commands.config_cmds import _compute_ndistinct
        return _compute_ndistinct(self, table, columns)

    def _execute_analyze(self, table):
        from citus_tpu_torch.commands.config_cmds import _execute_analyze
        return _execute_analyze(self, table)

    def _execute_reindex(self, stmt):
        from citus_tpu_torch.commands.config_cmds import _execute_reindex
        return _execute_reindex(self, stmt)

    def _returning_result(self, table_name, where, items, subst=None):
        from citus_tpu_torch.commands.config_cmds import _returning_result
        return _returning_result(self, table_name, where, items, subst)

    def _run_command_on_shards(self, table_name, command,
                               per_placement: bool = False):
        from citus_tpu_torch.commands.shard_cmds import _run_command_on_shards
        return _run_command_on_shards(self, table_name, command,
                                      per_placement=per_placement)

    def _table_ddl(self, name):
        from citus_tpu_torch.commands.shard_cmds import _table_ddl
        return _table_ddl(self, name)

    def _table_size(self, name: str) -> int:
        """Bytes of every placement's files of ``name`` on disk."""
        import os
        t = self.catalog.table(name)
        total = 0
        for shard in t.shards:
            for node in shard.placements:
                d = self.catalog.shard_dir(name, shard.shard_id, node)
                if os.path.isdir(d):
                    total += sum(os.path.getsize(os.path.join(d, f))
                                 for f in os.listdir(d))
        return total

    # set while executing a task a PEER pushed to us: such a task
    # operates on OUR placements only and must never push again
    _remote_exec_guard = __import__("threading").local()

    #: statement-recursion ceiling: subquery materialization, CTE
    #: bodies and view expansion re-enter _execute_stmt; a circular view
    #: reference (through another view or a subquery) fails with an
    #: AnalysisError instead of a raw RecursionError
    _MAX_STMT_DEPTH = 64
    _stmt_depth = __import__("threading").local()

    def _execute_stmt(self, stmt: A.Statement,
                      sql_text: Optional[str] = None) -> Result:
        depth = getattr(self._stmt_depth, "v", 0)
        if depth >= self._MAX_STMT_DEPTH:
            raise AnalysisError(
                "query nesting too deep (possible circular view "
                "reference)")
        self._stmt_depth.v = depth + 1
        try:
            return self._execute_stmt_inner(stmt, sql_text)
        finally:
            self._stmt_depth.v = depth

    def _execute_stmt_inner(self, stmt: A.Statement,
                            sql_text: Optional[str] = None) -> Result:
        """One statement, in the reference's order: WITH, SQL functions
        inlined, set operations, DISTINCT ON, SELECT without FROM,
        decorrelation, views expanded, partitioned parents expanded,
        derived tables, GROUPING SETS, windows, unnest, subqueries
        materialized, DELETE/UPDATE subqueries, joins, single-table
        SELECT; everything else through the handler registry."""
        # SELECT machinery above the planner (imported here: it imports
        # this module's helpers)
        from citus_tpu_torch.commands import select_exec
        if isinstance(stmt, (A.Select, A.SetOp, A.WithSelect)):
            from citus_tpu_torch.storage.overlay import current_overlay
            txn0 = current_overlay()
            if txn0 is not None and txn0.remote_written_tables:
                hit = _from_relations(stmt) & txn0.remote_written_tables
                if hit:
                    raise UnsupportedFeatureError(
                        f"cannot read {sorted(hit)[0]!r} in this "
                        "transaction after writing its remote-hosted "
                        "shards (remote staged state is not visible "
                        "here); COMMIT first")
        if isinstance(stmt, A.WithSelect):
            return select_exec._execute_with(self, stmt)
        if isinstance(stmt, (A.Select, A.SetOp)) and self.catalog.functions:
            stmt = select_exec._expand_functions_stmt(self, stmt)
        if isinstance(stmt, A.SetOp):
            return select_exec._execute_setop(self, stmt)
        if isinstance(stmt, A.Select) and stmt.distinct_on:
            return select_exec._execute_distinct_on(self, stmt)
        if isinstance(stmt, A.Select) and stmt.from_ is None:
            return select_exec._execute_constant_select(self, stmt)
        if isinstance(stmt, A.Select):
            from citus_tpu_torch.planner.recursive import (
                decorrelate_scalars, decorrelate_where,
            )
            stmt = decorrelate_scalars(stmt)
            stmt = decorrelate_where(stmt)
            if self.catalog.views:
                new_from = select_exec._expand_views(self, stmt.from_)
                if new_from is not stmt.from_:
                    stmt = A.Select(stmt.items, new_from, stmt.where,
                                    stmt.group_by, stmt.having,
                                    stmt.order_by, stmt.limit, stmt.offset,
                                    stmt.distinct, stmt.windows)
            if any(t.is_partitioned for t in self.catalog.tables.values()):
                # partitioned parents rewrite to their surviving
                # partitions (partition pruning stacks on shard and
                # chunk pruning)
                from citus_tpu_torch.partitioning import (
                    expand_from, referenced_columns,
                )
                new_from = expand_from(self, stmt.from_, stmt.where,
                                       referenced_columns(stmt))
                if new_from is not stmt.from_:
                    import dataclasses as _dc
                    stmt = _dc.replace(stmt, from_=new_from)
            if _has_derived(stmt.from_):
                return select_exec._execute_derived(self, stmt)
            if len(stmt.group_by) == 1 \
                    and isinstance(stmt.group_by[0], A.GroupingSetsSpec):
                return select_exec._execute_grouping_sets(
                    self, stmt, stmt.group_by[0].sets)
            if any(isinstance(i.expr, A.WindowCall) for i in stmt.items):
                return select_exec._execute_window(self, stmt)
            if any(isinstance(i.expr, A.FuncCall) and i.expr.name == "unnest"
                   for i in stmt.items):
                return select_exec._execute_unnest(self, stmt)
            # recursive planning: materialize subqueries first
            from citus_tpu_torch.planner.recursive import rewrite_subqueries
            new_stmt = rewrite_subqueries(
                stmt, lambda sub: self._execute_stmt(sub))
            if new_stmt is not stmt:
                return self._execute_stmt(new_stmt)  # plans are not cached
            return self._execute_select(stmt, sql_text)
        if isinstance(stmt, (A.Delete, A.Update)):
            stmt = self._materialize_dml_subqueries(stmt)
        if isinstance(stmt, A.UtilityCall):
            from citus_tpu_torch.commands.utility import execute_utility
            return execute_utility(self, stmt)
        from citus_tpu_torch.commands import loader as _loader
        _loader.ensure_loaded()
        from citus_tpu_torch.commands.registry import lookup as _lookup
        handler = _lookup(stmt)
        if handler is not None:
            return handler(self, stmt)
        # every statement kind without a handler is an object DDL of
        # ROADMAP.md A14b (roles, grants, policies, row-level security,
        # triggers, text-search configurations)
        _unported(type(stmt).__name__, "A14b")

    def _materialize_dml_subqueries(self, stmt):
        """DELETE's WHERE and UPDATE's assignments and WHERE with their
        subqueries run first and replaced by their values, through a
        FROM-less SELECT wrapper (the reference's recursive planning of
        modifications)."""
        import dataclasses

        from citus_tpu_torch.planner.recursive import (
            has_subquery, rewrite_subqueries,
        )
        assignments = getattr(stmt, "assignments", [])
        exprs = [e for _, e in assignments] + \
            ([stmt.where] if stmt.where is not None else [])
        if not any(has_subquery(e) for e in exprs):
            return stmt
        items = [A.SelectItem(e) for _, e in assignments]
        wrapped = A.Select(items or [A.SelectItem(A.Literal(1, "int"))],
                           from_=None, where=stmt.where)
        rew = rewrite_subqueries(wrapped, lambda sub: self._execute_stmt(sub))
        if isinstance(stmt, A.Delete):
            return dataclasses.replace(stmt, where=rew.where)
        return dataclasses.replace(
            stmt, where=rew.where,
            assignments=[(c, it.expr) for (c, _), it
                         in zip(assignments, rew.items)])

    def _execute_select(self, stmt: A.Select, sql_text) -> Result:
        """A SELECT with no subquery, derived table, window or grouping
        set left: a join, or one table through the plan cache."""
        if isinstance(stmt.from_, A.Join):
            from citus_tpu_torch.executor.join_executor import (
                execute_join_select,
            )
            from citus_tpu_torch.planner.join_planner import bind_join_select
            bj = bind_join_select(self.catalog, stmt)
            return execute_join_select(self.catalog, bj, self.settings,
                                       device=self.device, mesh=self.mesh)
        if self.catalog.rollups:
            # continuous aggregation: a dashboard query whose shape a
            # rollup materializes is answered from stored sketch state
            # (stale by the refresh lag) instead of scanning
            from citus_tpu_torch.rollup.routing import maybe_execute_rollup
            rres = maybe_execute_rollup(self, stmt)
            if rres is not None:
                return rres
        bound, plan, values = self._cached_select_plan(stmt, sql_text or None)
        return execute_select(self.catalog, bound, self.settings,
                              plan=plan, param_values=values,
                              device=self.device, mesh=self.mesh)
