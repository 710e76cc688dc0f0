"""Extended-aggregate registry: the declared partial/combine interface.

Reference: arbitrary aggregates run worker-side sfuncs and a
coordinator combinefunc (utils/aggregate_utils.c:502,847
worker_partial_agg_sfunc / coord_combine_agg_sfunc).  Here every
aggregate declares three pieces and the planner/executor stay generic:

- ``bind``   — argument typing and the AggSpec (binder phase)
- ``lower``  — which combinable partial slots the worker computes
  (physical phase).  Variance-family aggregates lower to *sum/sumsq/
  count* partials, so on device they combine with the same single psum
  as plain sums — no new collectives, no executor changes.
- ``finalize`` — partial slots -> per-group (values, valid) arrays
  (coordinator combine phase)

Aggregates that need exact value multisets (percentiles, string_agg,
array_agg) declare ``needs_exact``: their partial is an order-preserving
*collect*, which forces the host grouping path — the analog of the
reference pulling rows when an aggregate has no combinefunc.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from citus_tpu_torch import types as T
from citus_tpu_torch.errors import AnalysisError, UnsupportedFeatureError
from citus_tpu_torch.planner.bound import BBinOp, BCast, BExpr


@dataclass
class AggDef:
    name: str
    bind: Callable          # (binder, A.FuncCall) -> AggSpec
    lower: Callable         # (spec, arg_slot, partial_slot) -> AggExtract
    finalize: Callable      # (extract, partials, cat) -> (values, valid)
    needs_exact: bool = False  # collect-based: host grouping only
    # device partial exists only for the scalar (ungrouped) shape;
    # grouped queries route through host grouping
    host_grouped: bool = False


def _as_float(e: BExpr) -> BExpr:
    if e.type.is_float:
        return e
    return BCast(e, T.FLOAT64_T)


# ------------------------------------------------------- variance family

_VAR_CANON = {
    "variance": "var_samp", "var_samp": "var_samp", "var_pop": "var_pop",
    "stddev": "stddev_samp", "stddev_samp": "stddev_samp",
    "stddev_pop": "stddev_pop",
}


def _bind_variance(binder, e):
    from citus_tpu_torch.planner.bind import AggSpec
    if len(e.args) != 1:
        raise AnalysisError(f"{e.name}() expects one argument")
    arg = binder.bind_scalar(e.args[0])
    if not (arg.type.is_integer or arg.type.is_float or arg.type.is_decimal):
        raise AnalysisError(f"{e.name}() over {arg.type} not supported")
    if e.distinct:
        raise UnsupportedFeatureError(f"{e.name}(DISTINCT ...) not supported")
    return AggSpec(_VAR_CANON[e.name], _as_float(arg), T.FLOAT64_T)


def _lower_variance(spec, arg_slot, partial_slot):
    from citus_tpu_torch.planner.physical import AggExtract
    ai = arg_slot(spec.arg)
    sq = arg_slot(BBinOp("*", spec.arg, spec.arg, T.FLOAT64_T))
    s = partial_slot("sum", ai, "float64")
    ss = partial_slot("sum", sq, "float64")
    c = partial_slot("count", ai, "int64")
    return AggExtract(spec.kind, [s, ss, c], spec.out_type, param=spec.param)


def _finalize_variance(ex, partials, cat):
    s = np.asarray(partials[ex.slots[0]], np.float64)
    ss = np.asarray(partials[ex.slots[1]], np.float64)
    n = np.asarray(partials[ex.slots[2]], np.float64)
    pop = ex.kind.endswith("_pop")
    min_n = 1 if pop else 2
    valid = n >= min_n
    safe_n = np.where(n > 0, n, 1)
    # numerically: E[x^2] - E[x]^2, clamped (catastrophic cancellation
    # can dip epsilon-negative); matches PostgreSQL's float8 accumulator
    mean = s / safe_n
    m2 = ss - safe_n * mean * mean
    denom = safe_n if pop else np.where(n > 1, n - 1, 1)
    var = np.maximum(m2 / denom, 0.0)
    if ex.kind.startswith("stddev"):
        var = np.sqrt(var)
    return var, valid


# ------------------------------------------------------------- booleans


def _bind_bool(binder, e):
    from citus_tpu_torch.planner.bind import AggSpec
    if len(e.args) != 1:
        raise AnalysisError(f"{e.name}() expects one argument")
    arg = binder.bind_scalar(e.args[0])
    if arg.type.kind != T.BOOL:
        raise AnalysisError(f"{e.name}() requires a boolean argument")
    return AggSpec(e.name, BCast(arg, T.INT64_T), T.BOOL_T)


def _lower_bool(spec, arg_slot, partial_slot):
    from citus_tpu_torch.planner.physical import AggExtract
    ai = arg_slot(spec.arg)
    kind = "min" if spec.kind == "bool_and" else "max"
    v = partial_slot(kind, ai, "int64")
    c = partial_slot("count", ai, "int64")
    return AggExtract(spec.kind, [v, c], spec.out_type)


def _finalize_bool(ex, partials, cat):
    v = np.asarray(partials[ex.slots[0]])
    c = np.asarray(partials[ex.slots[1]])
    return v.astype(bool), c > 0


# ------------------------------------------------- collect-based family


def _bind_sort_keys(binder, e):
    """ORDER BY inside an aggregate call -> (sortable BExprs, asc flags).
    Text sort keys become lexicographic-rank lookups so plain numeric
    ordering of collected tuples matches string ordering."""
    from citus_tpu_torch.planner.bound import BDictLookup
    exprs, ascs = [], []
    for oe, asc in getattr(e, "agg_order", ()):
        b = binder.bind_scalar(oe)
        if b.type.is_text:
            # enum columns order by declaration rank (enumsortorder)
            enum_rank = binder.enum_rank(b)
            if enum_rank is not None:
                exprs.append(enum_rank)
                ascs.append(bool(asc))
                continue
            resolved = binder._text_words(b)
            if resolved is None:
                raise UnsupportedFeatureError(
                    "aggregate ORDER BY over computed text is not supported")
            base, _t, _c, eff_words = resolved
            order = sorted(range(len(eff_words)), key=eff_words.__getitem__)
            rank = [0] * len(eff_words)
            for pos, i in enumerate(order):
                rank[i] = pos
            b = BDictLookup(base, tuple(rank), T.INT64_T)
        elif not (b.type.is_numeric or b.type.kind in (T.DATE, T.TIMESTAMP,
                                                       T.BOOL)):
            raise UnsupportedFeatureError(
                f"cannot ORDER BY {b.type} inside an aggregate")
        exprs.append(b)
        ascs.append(bool(asc))
    return tuple(exprs), tuple(ascs)


def _bind_string_agg(binder, e):
    from citus_tpu_torch.planner import ast_nodes as A
    from citus_tpu_torch.planner.bind import AggSpec
    from citus_tpu_torch.planner.bound import BColumn
    if len(e.args) != 2:
        raise AnalysisError("string_agg() expects (expression, delimiter)")
    arg = binder.bind_scalar(e.args[0])
    if not arg.type.is_text:
        raise AnalysisError("string_agg() requires a text argument")
    d = e.args[1]
    if not (isinstance(d, A.Literal) and isinstance(d.value, str)):
        raise AnalysisError("string_agg() delimiter must be a string literal")
    src = None
    if isinstance(arg, BColumn):
        src = binder.text_source(arg)
    else:
        from citus_tpu_torch.planner.bound import walk
        for nd in walk(arg):
            if isinstance(nd, BColumn) and nd.type.is_text:
                src = binder.text_source(nd)
                break
    if src is None:
        raise UnsupportedFeatureError("string_agg() over computed text")
    sort_exprs, ascs = _bind_sort_keys(binder, e)
    return AggSpec("string_agg", arg, T.TEXT_T,
                   param=(d.value, src, sort_exprs, ascs))


def _lower_collect(spec, arg_slot, partial_slot):
    from citus_tpu_torch.planner.physical import AggExtract
    ai = arg_slot(spec.arg)
    sort_exprs = spec.param[2] if isinstance(spec.param, tuple) \
        and len(spec.param) >= 4 else ()
    extra = tuple(arg_slot(e) for e in sort_exprs)
    s = partial_slot("collect", ai, "object", extra)
    return AggExtract(spec.kind, [s], spec.out_type, param=spec.param)


def _sorted_items(vals, ascs):
    """Collected (value, key...) tuples -> values in ORDER BY order
    (PG null placement: last for ASC, first for DESC)."""
    if not vals or not isinstance(vals[0], tuple):
        return list(vals)

    def sort_key(item):
        parts = []
        for k, asc in zip(item[1:], ascs):
            null = k is None
            v = 0 if null else (k if asc else -k)
            parts.append((null if asc else not null, v))
        return tuple(parts)
    return [it[0] for it in sorted(vals, key=sort_key)]


def _finalize_string_agg(ex, partials, cat):
    delim, src = ex.param[0], ex.param[1]
    ascs = ex.param[3] if len(ex.param) >= 4 else ()
    lists = np.asarray(partials[ex.slots[0]], object)
    out = np.empty(lists.shape[0], object)
    valid = np.zeros(lists.shape[0], bool)
    for i, vals in enumerate(lists):
        if vals:
            ordered = _sorted_items(vals, ascs)
            words = cat.decode_strings(src[0], src[1],
                                       [int(v) for v in ordered])
            out[i] = delim.join(w for w in words if w is not None)
            valid[i] = True
    return out, valid


def _bind_array_agg(binder, e):
    from citus_tpu_torch.planner.bind import AggSpec
    from citus_tpu_torch.planner.bound import BColumn
    if len(e.args) != 1:
        raise AnalysisError("array_agg() expects one argument")
    arg = binder.bind_scalar(e.args[0])
    src = None
    if arg.type.is_text and isinstance(arg, BColumn):
        src = binder.text_source(arg)
    sort_exprs, ascs = _bind_sort_keys(binder, e)
    return AggSpec("array_agg", arg, arg.type,
                   param=("array", src, sort_exprs, ascs))


def _finalize_array_agg(ex, partials, cat):
    src = ex.param[1]
    ascs = ex.param[3] if len(ex.param) >= 4 else ()
    lists = np.asarray(partials[ex.slots[0]], object)
    out = np.empty(lists.shape[0], object)
    valid = np.zeros(lists.shape[0], bool)
    for i, vals in enumerate(lists):
        if vals:
            ordered = _sorted_items(vals, ascs)
            if src is not None:
                out[i] = cat.decode_strings(src[0], src[1],
                                            [int(v) for v in ordered])
            else:
                out[i] = [ex.out_type.from_physical(v) for v in ordered]
            valid[i] = True
    return out, valid


def _percentile_fraction(e) -> float:
    """Validate fn(frac) WITHIN GROUP desugar: two args, numeric literal
    fraction in [0, 1]."""
    import decimal
    from citus_tpu_torch.planner import ast_nodes as A
    if len(e.args) != 2:
        raise AnalysisError(f"{e.name}() requires WITHIN GROUP (ORDER BY ...)")
    f = e.args[0]
    if not (isinstance(f, A.Literal)
            and isinstance(f.value, (int, float, decimal.Decimal))):
        raise AnalysisError(f"{e.name}() fraction must be a numeric literal")
    frac = float(f.value)
    if not (0.0 <= frac <= 1.0):
        raise AnalysisError("percentile fraction must be in [0, 1]")
    return frac


def _bind_percentile(binder, e):
    """percentile_cont(frac) WITHIN GROUP (ORDER BY x) arrives desugared
    as FuncCall(name, (frac_literal, x))."""
    from citus_tpu_torch.planner.bind import AggSpec
    frac = _percentile_fraction(e)
    arg = binder.bind_scalar(e.args[1])
    if arg.type.is_text:
        raise UnsupportedFeatureError(f"{e.name}() over text not supported")
    out = T.FLOAT64_T if e.name == "percentile_cont" else arg.type
    return AggSpec(e.name, arg, out, param=frac)


def _finalize_percentile(ex, partials, cat):
    frac = ex.param
    lists = np.asarray(partials[ex.slots[0]], object)
    out = np.empty(lists.shape[0], object)
    valid = np.zeros(lists.shape[0], bool)
    cont = ex.kind == "percentile_cont"
    for i, vals in enumerate(lists):
        if not vals:
            continue
        v = np.sort(np.asarray(vals, np.float64 if cont else None))
        if cont:
            pos = frac * (len(v) - 1)
            lo = int(math.floor(pos))
            hi = min(lo + 1, len(v) - 1)
            out[i] = float(v[lo] + (pos - lo) * (v[hi] - v[lo]))
        else:
            # discrete: first value whose cumulative fraction >= frac
            idx = int(math.ceil(frac * len(v))) - 1 if frac > 0 else 0
            out[i] = v[max(0, min(idx, len(v) - 1))]
        valid[i] = True
    return out, valid


# -------------------------------------------------- min/max over text


def bind_text_minmax(binder, kind: str, arg):
    """min()/max() over a text expression: aggregate the lexicographic
    RANK of each word (combinable int64 min/max — still one collective),
    map the winning rank back to its word at finalize.  Built here
    because the builtin min/max branch rejects text."""
    from citus_tpu_torch.planner.bind import AggSpec
    from citus_tpu_torch.planner.bound import BDictLookup
    resolved = binder._text_words(arg)
    if resolved is None:
        raise UnsupportedFeatureError(
            f"{kind}() over computed text is not supported")
    base, _tname, _cname, eff_words = resolved
    order = sorted(range(len(eff_words)), key=eff_words.__getitem__)
    rank = [0] * len(eff_words)
    for pos, i in enumerate(order):
        rank[i] = pos
    sorted_words = tuple(eff_words[i] for i in order)
    ranked = BDictLookup(base, tuple(rank), T.INT64_T)
    return AggSpec(f"{kind}_text", ranked, T.TEXT_T, param=sorted_words)


def _lower_text_minmax(spec, arg_slot, partial_slot):
    from citus_tpu_torch.planner.physical import AggExtract
    ai = arg_slot(spec.arg)
    kind = "min" if spec.kind == "min_text" else "max"
    s = partial_slot(kind, ai, "int64")
    c = partial_slot("count", ai, "int64")
    return AggExtract(spec.kind, [s, c], spec.out_type, param=spec.param)


def _finalize_text_minmax(ex, partials, cat):
    ranks = np.asarray(partials[ex.slots[0]])
    c = np.asarray(partials[ex.slots[1]])
    words = ex.param
    out = np.empty(ranks.shape[0], object)
    valid = c > 0
    for i, r in enumerate(ranks):
        if valid[i] and 0 <= int(r) < len(words):
            out[i] = words[int(r)]
    return out, valid


# ---------------------------------------- approximate distinct (HLL)

HLL_M = 128                      # registers; error ~ 1.04/sqrt(m) ≈ 9%
HLL_ALPHA = 0.7213 / (1 + 1.079 / HLL_M)


def hll_rho_buckets(xp, bits, ok):
    """int64 value bits -> (bucket [N] int32, rho [N] int32); invalid
    rows get rho 0 (neutral under max)."""
    h = bits.astype(np.uint64)
    # splitmix64 finalizer
    h = (h ^ (h >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    h = (h ^ (h >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    h = h ^ (h >> np.uint64(31))
    bucket = (h & np.uint64(HLL_M - 1)).astype(np.int32)
    w = h >> np.uint64(7)  # remaining 57 bits
    # rho = leading-zero count within the 57-bit window + 1
    lz = xp.zeros(w.shape, np.int32)
    x = w
    for shift in (32, 16, 8, 4, 2, 1):
        big = (x >> np.uint64(shift)) != 0
        lz = lz + xp.where(big, 0, shift).astype(np.int32)
        x = xp.where(big, x >> np.uint64(shift), x)
    lz = lz - np.int32(7)  # the window is 57 bits wide, not 64
    rho = xp.where(w == 0, np.int32(57), lz + np.int32(1))
    rho = xp.where(ok, rho, np.int32(0))
    return bucket, rho


def hll_estimate(registers: np.ndarray) -> int:
    m = float(HLL_M)
    M = np.asarray(registers, np.float64)
    E = HLL_ALPHA * m * m / float(np.sum(np.power(2.0, -M)))
    if E <= 2.5 * m:
        V = int(np.sum(M == 0))
        if V > 0:
            E = m * np.log(m / V)
    return int(round(E))


def _bind_approx_distinct(binder, e):
    from citus_tpu_torch.planner.bind import AggSpec
    if len(e.args) != 1:
        raise AnalysisError("approx_count_distinct() expects one argument")
    arg = binder.bind_scalar(e.args[0])
    return AggSpec("approx_count_distinct", arg, T.INT64_T)


def _lower_approx_distinct(spec, arg_slot, partial_slot):
    from citus_tpu_torch.planner.physical import AggExtract
    ai = arg_slot(spec.arg)
    s = partial_slot("hll", ai, "int32")
    return AggExtract("approx_count_distinct", [s], spec.out_type)


def _finalize_approx_distinct(ex, partials, cat):
    regs = np.asarray(partials[ex.slots[0]])
    if regs.ndim == 1:          # scalar query: one register vector
        regs = regs[None, :]
    out = np.array([hll_estimate(r) for r in regs], np.int64)
    return out, np.ones(out.shape, bool)


# ---------------------------------- approximate percentiles (DDSketch)
#
# The reference pushes percentile computation down via the t-digest
# extension (planner/tdigest_extension.c:250): workers build sketches,
# the coordinator combines them.  A t-digest's variable-size centroid
# list is a poor fit for fixed-shape device code; the TPU-native
# equivalent is a DDSketch-style log-bucketed histogram: a FIXED vector
# of bucket counts per group, built with the same one-hot segment-sum
# the other aggregates use, and combined across shards with one psum —
# identical machinery to a plain sum partial, just vector-valued.
# Relative value error is bounded by the bucket width (~2.7% here).

DDSK_HALF = 1024                      # buckets per sign
DDSK_M = 2 * DDSK_HALF                # neg 0..1022 | zero 1023 | pos 1024..
DDSK_LOG_MIN = float(np.log(1e-12))   # smallest resolved magnitude
DDSK_LNG = float(np.log(1e24)) / DDSK_HALF  # ln(gamma): 1e-12..1e12 span


def ddsk_bucket_indexes(xp, v):
    """float values -> bucket index [N] int32 (callers mask invalid
    rows themselves)."""
    val = v.astype(np.float64)
    mag = xp.abs(val)
    li = xp.clip(
        xp.floor((xp.log(xp.maximum(mag, 1e-300)) - DDSK_LOG_MIN) / DDSK_LNG),
        0, DDSK_HALF - 1).astype(np.int32)
    neg_idx = np.int32(DDSK_HALF - 2) - xp.minimum(li, np.int32(DDSK_HALF - 2))
    pos_idx = np.int32(DDSK_HALF) + li
    return xp.where(val > 0, pos_idx,
                    xp.where(val < 0, neg_idx, np.int32(DDSK_HALF - 1)))


def ddsk_bucket_values() -> np.ndarray:
    """Representative value per bucket (geometric midpoint)."""
    j = np.arange(DDSK_M, dtype=np.float64)
    pos = np.exp(DDSK_LOG_MIN + (j - DDSK_HALF + 0.5) * DDSK_LNG)
    neg = -np.exp(DDSK_LOG_MIN + ((DDSK_HALF - 2 - j) + 0.5) * DDSK_LNG)
    vals = np.where(j >= DDSK_HALF, pos, neg)
    vals[DDSK_HALF - 1] = 0.0
    return vals


def _bind_approx_percentile(binder, e):
    """approx_percentile(frac) WITHIN GROUP (ORDER BY x): sketch-based,
    device-combinable percentile (cont-style rank selection, value
    resolved to the containing log bucket)."""
    from citus_tpu_torch.planner.bind import AggSpec
    frac = _percentile_fraction(e)
    arg = binder.bind_scalar(e.args[1])
    if not (arg.type.is_integer or arg.type.is_float or arg.type.is_decimal):
        raise AnalysisError(f"approx_percentile() over {arg.type} "
                            "not supported")
    return AggSpec("approx_percentile", _as_float(arg), T.FLOAT64_T,
                   param=frac)


def _lower_approx_percentile(spec, arg_slot, partial_slot):
    from citus_tpu_torch.planner.physical import AggExtract
    ai = arg_slot(spec.arg)
    s = partial_slot("ddsk", ai, "int64")
    return AggExtract("approx_percentile", [s], spec.out_type,
                      param=spec.param)


def _finalize_approx_percentile(ex, partials, cat):
    counts = np.asarray(partials[ex.slots[0]], np.int64)
    if counts.ndim == 1:
        counts = counts[None, :]
    vals = ddsk_bucket_values()
    out = np.zeros(counts.shape[0], np.float64)
    valid = np.zeros(counts.shape[0], bool)
    for g in range(counts.shape[0]):
        total = int(counts[g].sum())
        if total == 0:
            continue
        valid[g] = True
        rank = int(math.floor(ex.param * (total - 1)))
        cum = np.cumsum(counts[g])
        out[g] = vals[int(np.searchsorted(cum, rank + 1, side="left"))]
    return out, valid


# ------------------------------------------- heavy hitters (approx_top_k)
#
# Same fixed-shape recipe as HLL/DDSketch above: a hashed count-array
# sketch (a one-row count-min row) instead of a variable-size
# space-saving list.  Each value hashes (splitmix64, like the HLL
# bucketing) into one of TOPK_M count buckets; a parallel value
# register keeps the max value seen per bucket so the finalizer can
# name the heavy hitter the count belongs to.  Counts combine with the
# same psum as plain sums, registers with the same elementwise max as
# plain max partials — no new collectives.  A hash collision inflates a
# bucket's count by the colliding light value's rows; with TOPK_M
# buckets the probability a given heavy hitter shares a bucket is
# ~n_distinct/TOPK_M, the usual count-min bound.

TOPK_M = 1024                        # count buckets (power of two)
TOPK_SENTINEL = np.int64(np.iinfo(np.int64).min)  # empty value register


def topk_buckets(xp, bits):
    """int64 value bits -> bucket [N] int32 (callers mask invalid rows
    themselves)."""
    h = bits.astype(np.uint64)
    # splitmix64 finalizer (same mix as hll_rho_buckets)
    h = (h ^ (h >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    h = (h ^ (h >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    h = h ^ (h >> np.uint64(31))
    return (h & np.uint64(TOPK_M - 1)).astype(np.int32)


def _bind_approx_top_k(binder, e):
    from citus_tpu_torch.planner import ast_nodes as A
    from citus_tpu_torch.planner.bind import AggSpec
    if len(e.args) != 2:
        raise AnalysisError("approx_top_k() expects (column, k)")
    kl = e.args[1]
    if not (isinstance(kl, A.Literal) and isinstance(kl.value, int)
            and not isinstance(kl.value, bool)):
        raise AnalysisError("approx_top_k() k must be an integer literal")
    k = int(kl.value)
    if not 1 <= k <= 64:
        raise AnalysisError("approx_top_k() k must be in [1, 64]")
    arg = binder.bind_scalar(e.args[0])
    if not arg.type.is_integer:
        raise AnalysisError(f"approx_top_k() over {arg.type} not supported")
    if e.distinct:
        raise UnsupportedFeatureError("approx_top_k(DISTINCT ...) not supported")
    return AggSpec("approx_top_k", arg, T.TEXT_T, param=k)


def _lower_approx_top_k(spec, arg_slot, partial_slot):
    from citus_tpu_torch.planner.physical import AggExtract
    ai = arg_slot(spec.arg)
    counts = partial_slot("topk", ai, "int64")
    values = partial_slot("topkv", ai, "int64")
    return AggExtract("approx_top_k", [counts, values], spec.out_type,
                      param=spec.param)


def _finalize_approx_top_k(ex, partials, cat):
    import json as _json
    counts = np.asarray(partials[ex.slots[0]], np.int64)
    values = np.asarray(partials[ex.slots[1]], np.int64)
    if counts.ndim == 1:        # scalar query: one sketch
        counts = counts[None, :]
        values = values[None, :]
    out = np.empty(counts.shape[0], object)
    valid = np.zeros(counts.shape[0], bool)
    for g in range(counts.shape[0]):
        hot = np.nonzero(counts[g] > 0)[0]
        if hot.size == 0:
            continue
        valid[g] = True
        # top-k buckets by count (value as the deterministic tiebreak)
        order = sorted(hot, key=lambda b: (-int(counts[g][b]),
                                           int(values[g][b])))
        out[g] = _json.dumps(
            [{"value": int(values[g][b]), "count": int(counts[g][b])}
             for b in order[:ex.param]])
    return out, valid


# ----------------------------------------------- DISTINCT sum/avg


def _lower_set(spec, arg_slot, partial_slot):
    from citus_tpu_torch.planner.physical import AggExtract
    ai = arg_slot(spec.arg)
    s = partial_slot("collect_set", ai, "object")
    return AggExtract(spec.kind, [s], spec.out_type, param=spec.param)


def _finalize_set_sum_avg(ex, partials, cat):
    """sum(DISTINCT)/avg(DISTINCT) over exact value sets; physical-space
    arithmetic so decimal exactness matches the non-distinct paths
    (avg scales by 10^6 like the builtin decimal average)."""
    import decimal as _dec
    sets = np.asarray(partials[ex.slots[0]], object)
    out = np.empty(sets.shape[0], object)
    valid = np.zeros(sets.shape[0], bool)
    is_avg = ex.kind == "avg_distinct"
    is_float = ex.out_type.is_float
    for i, vals in enumerate(sets):
        if not vals:
            continue
        valid[i] = True
        if is_float:
            s = float(sum(vals))
            out[i] = s / len(vals) if is_avg else s
        else:
            s = int(sum(int(v) for v in vals))
            if is_avg:
                q = _dec.Decimal(s) * 1_000_000 / _dec.Decimal(len(vals))
                out[i] = int(q.to_integral_value(rounding=_dec.ROUND_HALF_UP))
            else:
                out[i] = s
    return out, valid


AGG_REGISTRY: dict[str, AggDef] = {}


def register(defn: AggDef) -> None:
    AGG_REGISTRY[defn.name] = defn


for _n in ("variance", "var_samp", "var_pop", "stddev", "stddev_samp",
           "stddev_pop"):
    register(AggDef(_n, _bind_variance, _lower_variance, _finalize_variance))
for _n in ("bool_and", "bool_or"):
    register(AggDef(_n, _bind_bool, _lower_bool, _finalize_bool))
register(AggDef("string_agg", _bind_string_agg, _lower_collect,
                _finalize_string_agg, needs_exact=True))
register(AggDef("array_agg", _bind_array_agg, _lower_collect,
                _finalize_array_agg, needs_exact=True))
for _n in ("percentile_cont", "percentile_disc"):
    register(AggDef(_n, _bind_percentile, _lower_collect,
                    _finalize_percentile, needs_exact=True))
for _n in ("min_text", "max_text"):
    register(AggDef(_n, None, _lower_text_minmax, _finalize_text_minmax))
for _n in ("sum_distinct", "avg_distinct"):
    register(AggDef(_n, None, _lower_set, _finalize_set_sum_avg,
                    needs_exact=True))
register(AggDef("approx_count_distinct", _bind_approx_distinct,
                _lower_approx_distinct, _finalize_approx_distinct,
                host_grouped=True))
register(AggDef("approx_percentile", _bind_approx_percentile,
                _lower_approx_percentile, _finalize_approx_percentile,
                host_grouped=True))
register(AggDef("approx_top_k", _bind_approx_top_k, _lower_approx_top_k,
                _finalize_approx_top_k, host_grouped=True))


def finalize_kind(kind: str):
    """Finalizer lookup by canonical extract kind (canonical variance
    names differ from their aliases)."""
    d = AGG_REGISTRY.get(kind)
    return d.finalize if d is not None else None
