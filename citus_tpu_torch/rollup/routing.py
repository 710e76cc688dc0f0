"""Planner-side rollup routing: answer matching queries from stored
sketches instead of a raw scan.

A dashboard query qualifies when its whole shape is computable from a
rollup's materialized state: it scans the rollup's SOURCE table, groups
by a subset of the rollup's group columns, filters only on group
columns with host-evaluable predicates, and every select item is either
a grouped column or an aggregate the spec materializes.  The rewrite
then reads the (tiny) rollup table, re-merges stored states across any
residual group columns — the same merge laws the refresh uses, which is
exactly why subset grouping is sound — and finalizes sketch words into
user-facing values.

Routing serves the state as of the rollup's durable watermark: results
trail raw scans by the refresh lag surfaced in ``citus_rollups()``.
That staleness-for-speed trade is the contract of continuous
aggregation; ``SET citus.enable_rollup_routing = off`` opts a session
out (and gives benchmarks their raw-scan A arm).
"""

from __future__ import annotations

from citus_tpu_torch.planner import ast as A
from citus_tpu_torch.rollup import sketches


def _counters():
    from citus_tpu_torch.executor.executor import GLOBAL_COUNTERS
    return GLOBAL_COUNTERS


class _NoMatch(Exception):
    """Internal: query shape not answerable from the rollup."""


def _colname(e, tables) -> str:
    if not isinstance(e, A.ColumnRef) or e.table not in tables:
        raise _NoMatch
    return e.name


def _const(e):
    from citus_tpu_torch.cluster import _eval_const
    try:
        return _eval_const(e)
    except Exception:  # lint: disable=SWL01 -- any non-constant expr simply disqualifies the rewrite; the raw scan path answers instead
        raise _NoMatch


def _const_number(e) -> float:
    # The parser yields Decimal for numeric literals like 0.5; anything
    # float()-coercible counts as a constant number here.
    v = _const(e)
    if isinstance(v, bool) or v is None:
        raise _NoMatch
    try:
        return float(v)
    except (TypeError, ValueError):
        raise _NoMatch


def _match_agg(e, spec) -> tuple:
    """Aggregate FuncCall -> ("count"|"sum"|..., out_col, param) when
    the spec materializes it; raises _NoMatch otherwise."""
    if not isinstance(e, A.FuncCall) or e.distinct or e.filter is not None \
            or e.agg_order:
        raise _NoMatch
    by_kind = {(k, c): out for k, c, out in spec["aggs"]}
    if e.name == "count" and len(e.args) == 1 \
            and isinstance(e.args[0], A.Star) and ("count", "*") in by_kind:
        return "count", by_kind[("count", "*")], None
    if e.name == "sum" and len(e.args) == 1 \
            and isinstance(e.args[0], A.ColumnRef):
        col = e.args[0].name
        if ("sum", col) in by_kind:
            return "sum", by_kind[("sum", col)], None
    if e.name == "approx_count_distinct" and len(e.args) == 1 \
            and isinstance(e.args[0], A.ColumnRef):
        col = e.args[0].name
        if ("hll", col) in by_kind:
            return "hll", by_kind[("hll", col)], None
    if e.name == "approx_percentile" and len(e.args) == 2 \
            and isinstance(e.args[1], A.ColumnRef):
        col = e.args[1].name
        frac = _const_number(e.args[0])
        if ("pct", col) in by_kind and 0.0 <= frac <= 1.0:
            return "pct", by_kind[("pct", col)], frac
    if e.name == "approx_top_k" and len(e.args) == 2 \
            and isinstance(e.args[0], A.ColumnRef):
        col = e.args[0].name
        k = _const_number(e.args[1])
        if ("topk", col) in by_kind and k == int(k) and 1 <= k <= 64:
            return "topk", by_kind[("topk", col)], int(k)
    raise _NoMatch


def _check_where(e, group_cols, tables) -> None:
    """WHERE must be a host-evaluable predicate over group columns only
    (it then filters stored group rows instead of source rows)."""
    if e is None:
        return
    if isinstance(e, A.BinOp):
        if e.op in ("and", "or"):
            _check_where(e.left, group_cols, tables)
            _check_where(e.right, group_cols, tables)
            return
        if e.op in ("=", "<>", "!=", "<", "<=", ">", ">="):
            _check_operand(e.left, group_cols, tables)
            _check_operand(e.right, group_cols, tables)
            return
        raise _NoMatch
    if isinstance(e, A.UnOp) and e.op == "not":
        _check_where(e.operand, group_cols, tables)
        return
    if isinstance(e, A.InList):
        _check_operand(e.expr, group_cols, tables)
        for it in e.items:
            _const(it)
        return
    if isinstance(e, A.Between):
        _check_operand(e.expr, group_cols, tables)
        _const(e.lo)
        _const(e.hi)
        return
    if isinstance(e, A.IsNull):
        _check_operand(e.expr, group_cols, tables)
        return
    raise _NoMatch


def _check_operand(e, group_cols, tables) -> None:
    if isinstance(e, A.ColumnRef):
        if e.table not in tables or e.name not in group_cols:
            raise _NoMatch
        return
    _const(e)


def _eval_where(e, env: dict) -> bool:
    if e is None:
        return True
    if isinstance(e, A.BinOp):
        if e.op == "and":
            return _eval_where(e.left, env) and _eval_where(e.right, env)
        if e.op == "or":
            return _eval_where(e.left, env) or _eval_where(e.right, env)
        lv, rv = _eval_operand(e.left, env), _eval_operand(e.right, env)
        if lv is None or rv is None:
            return False  # SQL three-valued logic: NULL never matches
        return {"=": lv == rv, "<>": lv != rv, "!=": lv != rv,
                "<": lv < rv, "<=": lv <= rv, ">": lv > rv,
                ">=": lv >= rv}[e.op]
    if isinstance(e, A.UnOp) and e.op == "not":
        return not _eval_where(e.operand, env)
    if isinstance(e, A.InList):
        v = _eval_operand(e.expr, env)
        hit = v is not None and any(v == _const(i) for i in e.items)
        return (not hit) if e.negated else hit
    if isinstance(e, A.Between):
        v = _eval_operand(e.expr, env)
        hit = v is not None and _const(e.lo) <= v <= _const(e.hi)
        return (not hit) if e.negated else hit
    if isinstance(e, A.IsNull):
        v = _eval_operand(e.expr, env)
        return (v is not None) if e.negated else (v is None)
    raise _NoMatch


def _eval_operand(e, env: dict):
    if isinstance(e, A.ColumnRef):
        return env[e.name]
    return _const(e)


def match_rollup(cl, sel):
    """Select AST -> (rollup_name, spec, plan dict) or None.  The plan
    carries the per-item actions so execution never re-inspects the
    AST."""
    if not isinstance(sel, A.Select) \
            or not isinstance(sel.from_, A.TableRef) \
            or not getattr(cl.settings.rollup, "enable_rollup_routing",
                           True):
        return None
    if sel.distinct or sel.distinct_on or sel.windows \
            or sel.having is not None:
        return None
    src = sel.from_.name
    tables = {None, src, sel.from_.alias}
    for name in sorted(cl.catalog.rollups):
        spec = cl.catalog.rollups[name]
        if spec["source"] != src:
            continue
        try:
            return name, spec, _plan_one(sel, spec, tables)
        except _NoMatch:
            continue
    return None


def _plan_one(sel, spec, tables) -> dict:
    gset = set(spec["group_cols"])
    req_groups = []
    for g in sel.group_by:
        c = _colname(g, tables)
        if c not in gset or c in req_groups:
            raise _NoMatch
        req_groups.append(c)
    items = []   # ("group", col) | (agg_kind, out_col, param)
    for it in sel.items:
        if isinstance(it.expr, A.ColumnRef):
            c = _colname(it.expr, tables)
            if c not in req_groups:
                raise _NoMatch
            items.append(("group", c, None))
        else:
            items.append(_match_agg(it.expr, spec))
    if not any(k != "group" for k, _o, _p in items):
        raise _NoMatch
    _check_where(sel.where, gset, tables)
    order = []
    for oi in sel.order_by:
        c = _colname(oi.expr, tables)
        sis = [i for i, (k, o, _p) in enumerate(items)
               if k == "group" and o == c]
        if not sis:
            raise _NoMatch
        order.append((sis[0], oi.ascending))
    return {"groups": req_groups, "items": items, "where": sel.where,
            "order": order, "limit": sel.limit, "offset": sel.offset}


def maybe_execute_rollup(cl, stmt):
    """Dispatch hook: answer ``stmt`` from a rollup table, or None to
    fall through to the raw scan path."""
    m = match_rollup(cl, stmt)
    if m is None:
        return None
    from citus_tpu_torch.executor import Result
    name, spec, plan = m
    merged = _merge_groups(cl, spec, plan)
    rows = _finalize_rows(spec, plan, merged)
    cols = [it.alias or _default_name(it.expr) for it in stmt.items]
    _counters().bump("rollup_queries_served", 1)
    return Result(columns=cols, rows=rows,
                  explain={"strategy": "rollup", "rollup": name})


def _default_name(e) -> str:
    if isinstance(e, A.ColumnRef):
        return e.name
    if isinstance(e, A.FuncCall):
        return e.name
    return str(e)


def _merge_groups(cl, spec, plan) -> dict:
    """Read the rollup table and fold stored rows down to the requested
    grouping: {requested-key-tuple: {out_col: merged cell}}."""
    gcols = spec["group_cols"]
    need_out = sorted({o for k, o, _p in plan["items"] if k != "group"})
    agg_kind = {out: kind for kind, _c, out in spec["aggs"]}
    sel = A.Select(
        [A.SelectItem(A.ColumnRef(c)) for c in gcols + need_out],
        A.TableRef(spec["table"]))
    res = cl._execute_stmt(sel)
    merged: dict = {}
    for row in res.rows:
        env = dict(zip(gcols, row[:len(gcols)]))
        if not _eval_where(plan["where"], env):
            continue
        key = tuple(env[c] for c in plan["groups"])
        cells = merged.get(key)
        if cells is None:
            merged[key] = dict(zip(need_out, row[len(gcols):]))
            continue
        for out, v in zip(need_out, row[len(gcols):]):
            cur = cells[out]
            if v is None:
                continue
            if cur is None:
                cells[out] = v
            elif agg_kind[out] in ("count", "sum"):
                cells[out] = cur + v
            else:
                cells[out] = sketches.merge_sketch_words(str(cur), str(v))
    return merged


def _finalize_rows(spec, plan, merged: dict) -> list:
    out_rows = []
    items = plan["items"]
    if not merged and not plan["groups"]:
        # scalar query over an empty state: count 0, everything else NULL
        merged = {(): {o: None for _k, o, _p in items if _k != "group"}}
    for key, cells in merged.items():
        env = dict(zip(plan["groups"], key))
        row = []
        for kind, out, param in items:
            if kind == "group":
                row.append(env[out])
            else:
                row.append(_finalize_cell(kind, cells.get(out), param))
        out_rows.append(tuple(row))
    for si, asc in reversed(plan["order"]):
        out_rows.sort(key=lambda r, i=si: (r[i] is None, r[i]),
                      reverse=not asc)
    lo = plan["offset"] or 0
    hi = None if plan["limit"] is None else lo + plan["limit"]
    return out_rows[lo:hi] if (lo or hi is not None) else out_rows


def _finalize_cell(kind, word, param):
    if kind == "count":
        return int(word) if word is not None else 0
    if kind == "sum":
        return word
    if word is None:
        return 0 if kind == "hll" else None
    skind, state = sketches.decode_sketch(str(word))
    v, valid = sketches.finalize_sketch(skind, state, param)
    return v if valid else None
