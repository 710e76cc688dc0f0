"""Coordinator-side finalization: combine results -> Python rows.

The analog of the reference's coordinator combine query + final
projection (MasterExtendedOpNode output): aggregate extraction from
partial states (avg = exact sum/count division), HAVING, output
decoding (scaled-int decimals -> Decimal, dictionary ids -> strings,
day/microsecond encodings -> date/datetime), ORDER BY with PostgreSQL
null ordering, DISTINCT, OFFSET/LIMIT.
"""

from __future__ import annotations

import decimal
from typing import Optional

import numpy as np

from citus_tpu_torch import types as T
from citus_tpu_torch.catalog import Catalog
from citus_tpu_torch.errors import UnsupportedFeatureError
from citus_tpu_torch.planner.bound import (
    BColumn, BDictRemap, BKeyRef, BLiteral, compile_expr, predicate_mask,
    walk,
)
from citus_tpu_torch.planner.physical import AggExtract, PhysicalPlan


def extract_aggs(plan: PhysicalPlan, partials: tuple,
                 cat: Optional[Catalog] = None) -> list[tuple[np.ndarray, np.ndarray]]:
    """Partial-op arrays -> per-SQL-aggregate (values, valid) arrays."""
    out = []
    for ex in plan.agg_extract:
        if ex.kind == "count_distinct":
            v = np.asarray(partials[ex.slots[0]], dtype=np.int64)
            out.append((v, np.ones(v.shape, bool)))
        elif ex.kind in ("count", "count_star"):
            v = np.asarray(partials[ex.slots[0]], dtype=np.int64)
            out.append((v, np.ones(v.shape, bool)))
        elif ex.kind == "sum":
            s = np.asarray(partials[ex.slots[0]])
            c = np.asarray(partials[ex.slots[1]])
            _check_sum_overflow(ex, partials, c)
            out.append((s, c > 0))
        elif ex.kind == "avg":
            s = np.asarray(partials[ex.slots[0]])
            c = np.asarray(partials[ex.slots[1]])
            _check_sum_overflow(ex, partials, c)
            valid = c > 0
            if ex.out_type.is_float:
                v = np.divide(s, np.where(valid, c, 1))
                out.append((v.astype(np.float64), valid))
            else:
                # exact decimal average: sum is scaled by arg scale; output
                # scale is arg scale + 6 -> multiply by 10^6 then divide
                vals = np.zeros(s.shape, np.int64)
                flat_s, flat_c = s.reshape(-1), c.reshape(-1)
                flat_o = vals.reshape(-1)
                for i in range(flat_s.shape[0]):
                    if flat_c[i] > 0:
                        q = (decimal.Decimal(int(flat_s[i])) * 1_000_000 /
                             decimal.Decimal(int(flat_c[i])))
                        flat_o[i] = int(q.to_integral_value(rounding=decimal.ROUND_HALF_UP))
                out.append((vals, valid))
        elif ex.kind in ("min", "max"):
            v = np.asarray(partials[ex.slots[0]])
            c = np.asarray(partials[ex.slots[1]])
            out.append((v, c > 0))
        else:
            from citus_tpu_torch.planner.aggregates import finalize_kind
            fin = finalize_kind(ex.kind)
            if fin is None:
                raise AssertionError(ex.kind)
            out.append(fin(ex, partials, cat))
    return out


#: |shadow float sum| at or beyond this proves the exact int64 sum
#: cannot fit (2^62: a 2x margin over int64 range absorbs float error)
_SUM_OVERFLOW_LIMIT = float(1 << 62)


def _check_sum_overflow(ex: AggExtract, partials: tuple, counts) -> None:
    """sum/avg over int64-accumulated numerics carry a float64 shadow
    sum in slot 2 (planner/physical.py lower_aggregates); reject results
    whose true sum provably left int64 range rather than returning the
    silently wrapped value.  The reference's NUMERIC is arbitrary-
    precision and never overflows — erroring is the honest analog."""
    if len(ex.slots) < 3:
        return
    shadow = np.asarray(partials[ex.slots[2]], np.float64)
    # the float cast of a decimal yields the LOGICAL value; the exact
    # accumulator holds integers at the ARGUMENT's scale — compare in
    # that space.  For sum, out scale == arg scale; avg's output gains
    # +6 digits (the exact-division scale, extract_aggs avg path) that
    # the accumulator never holds, so strip them or the check is 10^6
    # too strict.
    scale = ex.out_type.scale if ex.out_type.is_decimal else 0
    if ex.kind == "avg":
        scale = max(0, scale - 6)
    limit = _SUM_OVERFLOW_LIMIT / (10.0 ** scale)
    bad = (np.abs(shadow) >= limit) & (np.asarray(counts) > 0)
    if bad.any():
        from citus_tpu_torch.errors import ExecutionError
        raise ExecutionError(
            "numeric value out of range: sum() exceeds the exact 64-bit "
            "accumulator (reduce the aggregate's scale or range)")


def decode_qualified(cat: Catalog, expr_type: T.ColumnType,
                     source: "Optional[tuple[str, str]]", raw, valid) -> object:
    """Physical value -> Python value; ``source`` is (table, column) for
    text dictionary decoding.  Registry aggregates (string_agg,
    array_agg) finalize straight to Python objects, which pass through."""
    if not valid:
        return None
    if isinstance(raw, (str, list)):
        return raw
    if expr_type.is_text:
        if source is None:
            return int(raw)
        word = cat.decode_strings(source[0], source[1], [int(raw)])[0]
        if word is not None and expr_type.kind != "text":
            return expr_type.render_word(word)  # uuid/bytea/array
        return word
    return expr_type.from_physical(raw.item() if hasattr(raw, "item") else raw)


def default_text_src(plan):
    """Returns a resolver: output expr -> (table_name, column) whose
    dictionary decodes it, or None for non-text outputs."""
    bound = plan.bound

    def resolve(e):
        if isinstance(e, BKeyRef):
            e = bound.group_keys[e.index]
        while isinstance(e, BDictRemap):
            e = e.operand  # remapped ids live in the operand's dictionary
        if not e.type.is_text:
            return None
        if isinstance(e, BColumn):
            return (bound.table.name, e.name)
        # composite text expr (CASE/coalesce): ids come from the first
        # text column referenced inside it
        for n in walk(e):
            if isinstance(n, BColumn) and n.type.is_text:
                return (bound.table.name, n.name)
        return None
    return resolve


def _uuid_lane_strings(hi_v, hi_m, lo_v, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Recombine hi/lo int64 lane arrays into canonical uuid strings.

    uuid columns are stored as two order-preserving int64 lanes
    (dictionary bypass, types.py) — outputs rebuild the 128-bit value
    here, on the already-filtered result set, never on the device."""
    hi_v = np.asarray(hi_v).reshape(-1)
    lo_v = np.asarray(lo_v).reshape(-1)
    if isinstance(hi_m, (bool, np.bool_)):
        hi_m = np.full(n, bool(hi_m))
    else:
        hi_m = np.asarray(hi_m).reshape(-1)
    out = np.empty(n, object)
    for i in range(n):
        if hi_m[i]:
            out[i] = T.uuid_from_lane_pair(int(hi_v[i]), int(lo_v[i]))
    return out, hi_m


def _uuid_output(e, env_get, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Evaluate a uuid-typed output expr without compile_expr (whose
    literal cast would overflow int64).  ``env_get(name)`` returns the
    (values, valid) pair for a column/lane env name."""
    if isinstance(e, BColumn):
        hv, hm = env_get(e.name)
        lv, _lm = env_get(T.uuid_lane_name(e.name))
        return _uuid_lane_strings(hv, hm, lv, n)
    if isinstance(e, BLiteral):
        out = np.empty(n, object)
        if e.value is not None:
            out[:] = e.type.from_physical(int(e.value))
        return out, np.full(n, e.value is not None)
    raise UnsupportedFeatureError(
        f"uuid output expression {type(e).__name__} not supported yet")


def finalize_groups(
    plan: PhysicalPlan, cat: Catalog,
    key_arrays: list[tuple[np.ndarray, np.ndarray]],
    partials: tuple,
    text_src=None,
    params_env: Optional[dict] = None,
) -> list[tuple]:
    """Grouped/aggregate query: evaluate final exprs per group -> rows."""
    bound = plan.bound
    aggs = extract_aggs(plan, partials, cat)
    env = {"__keys__": key_arrays, "__aggs__": aggs}
    if params_env:
        env.update(params_env)
    n_groups = key_arrays[0][0].shape[0] if key_arrays else (
        aggs[0][0].shape[0] if aggs else 1)

    keep = np.ones(n_groups, bool)
    if bound.having is not None:
        fn = compile_expr(bound.having, np)
        ref = np.zeros(n_groups)
        keep = np.asarray(predicate_mask(np, fn, env, ref))
        if keep.shape == ():
            keep = np.full(n_groups, bool(keep))

    resolve = text_src or default_text_src(plan)
    text_cols = [resolve(e) for e in bound.final_exprs]

    # a uuid group key spans two key slots: the visible hi-lane key and
    # its hidden trailing lo-lane key (bind_select appends it) — locate
    # the lane slot by name so BKeyRef outputs can recombine
    lane_slot = {}
    for i, k in enumerate(bound.group_keys):
        if isinstance(k, BColumn) and k.type.kind == T.UUID:
            lane_slot[i] = next(
                j for j, g in enumerate(bound.group_keys)
                if isinstance(g, BColumn)
                and g.name == T.uuid_lane_name(k.name))

    out_cols = []
    for e in bound.final_exprs:
        if e.type.kind == T.UUID:
            if isinstance(e, BKeyRef) and e.index in lane_slot:
                hv, hm = key_arrays[e.index]
                lv, _lm = key_arrays[lane_slot[e.index]]
                v, valid = _uuid_lane_strings(hv, hm, lv, n_groups)
            else:
                v, valid = _uuid_output(
                    e, lambda name: env[name], n_groups)
            out_cols.append((v, valid, e.type))
            continue
        fn = compile_expr(e, np)
        v, valid = fn(env)
        v = np.broadcast_to(np.asarray(v), (n_groups,) + np.shape(v)[1:]) \
            if np.shape(v)[:1] != (n_groups,) else np.asarray(v)
        if valid is True:
            valid = np.ones(n_groups, bool)
        elif valid is False:
            valid = np.zeros(n_groups, bool)
        else:
            valid = np.broadcast_to(np.asarray(valid), (n_groups,))
        out_cols.append((v, valid, e.type))

    rows = []
    for gi in range(n_groups):
        if not keep[gi]:
            continue
        row = []
        for (v, valid, t), src in zip(out_cols, text_cols):
            row.append(decode_qualified(cat, t, src, v[gi], bool(valid[gi])))
        rows.append(tuple(row))
    return rows


def project_rows(plan: PhysicalPlan, cat: Catalog, env_batches: list[dict],
                 text_src=None) -> list[tuple]:
    """Non-aggregate query: evaluate projections per batch on the host
    (the device already computed the filter mask and raw columns)."""
    bound = plan.bound
    rows: list[tuple] = []
    resolve = text_src or default_text_src(plan)
    text_cols = [resolve(e) for e in bound.final_exprs]
    fns = plan.runtime_cache.get("np_final_fns")
    if fns is None:
        # uuid exprs are recombined from lanes below, not compiled —
        # compile_expr's literal cast cannot hold a 128-bit value
        fns = [None if e.type.kind == T.UUID else compile_expr(e, np)
               for e in bound.final_exprs]
        plan.runtime_cache["np_final_fns"] = fns
    for env, mask in env_batches:
        idx = np.nonzero(mask)[0]
        if idx.size == 0:
            continue
        sel_env = {name: ((v, m) if name.startswith("__param_")
                          else (np.asarray(v)[idx],
                                np.asarray(m)[idx] if not isinstance(m, bool) else m))
                   for name, (v, m) in env.items()}
        cols = []
        for e, fn in zip(bound.final_exprs, fns):
            if fn is None:
                v, valid = _uuid_output(
                    e, lambda name: sel_env[name], idx.size)
                cols.append((v, np.broadcast_to(np.asarray(valid),
                                                (idx.size,)), e.type))
                continue
            v, valid = fn(sel_env)
            v = np.broadcast_to(np.asarray(v), (idx.size,) + np.shape(v)[1:]) \
                if np.shape(v)[:1] != (idx.size,) else np.asarray(v)
            if valid is True:
                valid = np.ones(idx.size, bool)
            elif valid is False:
                valid = np.zeros(idx.size, bool)
            cols.append((v, np.broadcast_to(np.asarray(valid), (idx.size,)), e.type))
        rows.extend(zip(*(decode_column(cat, t, src, v, valid)
                          for (v, valid, t), src in zip(cols, text_cols))))
    return rows


def decode_column(cat: Catalog, expr_type: T.ColumnType,
                  source: "Optional[tuple[str, str]]", raw, valid) -> list:
    """``decode_qualified`` over a whole column at once: one dictionary
    lookup for text and one ``tolist`` for bool/integer/float values,
    whose Python values are those ``from_physical`` gives."""
    raw = np.asarray(raw)
    valid = np.asarray(valid, bool)
    if raw.dtype == object or raw.ndim != 1:
        return [decode_qualified(cat, expr_type, source, x, bool(ok))
                for x, ok in zip(raw, valid)]
    k = expr_type.kind
    if expr_type.is_text:
        if source is None:
            vals = raw.astype(np.int64).tolist()
        else:
            vals = cat.decode_strings(source[0], source[1],
                                      raw.astype(np.int64).tolist())
            if k != "text":
                vals = [None if w is None else expr_type.render_word(w)
                        for w in vals]
    elif k == T.BOOL:
        vals = raw.astype(bool).tolist()
    elif k in (T.INT16, T.INT32, T.INT64):
        vals = raw.astype(np.int64).tolist()
    elif k in (T.FLOAT32, T.FLOAT64):
        vals = raw.astype(np.float64).tolist()
    else:
        vals = [expr_type.from_physical(x) for x in raw.tolist()]
    if valid.all():
        return vals
    return [x if ok else None for x, ok in zip(vals, valid.tolist())]


def order_and_limit(plan: PhysicalPlan, rows: list[tuple]) -> list[tuple]:
    bound = plan.bound
    if bound.distinct:
        seen = set()
        uniq = []
        for r in rows:
            if r not in seen:
                seen.add(r)
                uniq.append(r)
        rows = uniq
    # stable multi-key sort: apply keys right-to-left; PostgreSQL default
    # null ordering is NULLS LAST for ASC, NULLS FIRST for DESC
    for idx, asc, nulls_first in reversed(bound.order_by):
        nf = nulls_first if nulls_first is not None else (not asc)
        nulls = [r for r in rows if r[idx] is None]
        vals = [r for r in rows if r[idx] is not None]
        vals.sort(key=lambda r, i=idx: r[i], reverse=not asc)
        rows = (nulls + vals) if nf else (vals + nulls)
    if bound.offset:
        rows = rows[bound.offset:]
    if bound.limit is not None:
        rows = rows[:bound.limit]
    return rows
