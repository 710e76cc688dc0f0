"""Window function execution.

The reference delegates window functions to PostgreSQL's executor after
its planner proves safety (pushdown when partitioned by the distribution
column, else pull).  Here the base projection (including partition/order
keys and window arguments) executes through the normal distributed scan
— or the grouped pipeline when the query also aggregates — and the
window pass runs on the coordinator.

Supported: row_number, rank, dense_rank, ntile, lag, lead, first_value,
last_value, nth_value, count, sum, avg, min, max OVER (PARTITION BY ...
ORDER BY ... [ROWS|RANGE BETWEEN ...]), plus named windows (WINDOW w AS
(...) with OVER w / OVER (w ...)).  Default frame matches PostgreSQL
(RANGE UNBOUNDED PRECEDING .. CURRENT ROW: running aggregates include
peer rows; no ORDER BY -> whole partition).  ROWS frames bound by row
offsets; RANGE offset frames bound by ORDER-BY value distance (single
sort key required, as in PostgreSQL), with RANGE CURRENT ROW meaning
the peer group on both ends.
"""

from __future__ import annotations

import decimal
from typing import Any, Optional

from citus_tpu_torch.errors import AnalysisError, UnsupportedFeatureError

RANKING = {"row_number", "rank", "dense_rank", "ntile"}
NAVIGATION = {"lag", "lead", "first_value", "last_value", "nth_value"}
AGGS = {"count", "sum", "avg", "min", "max"}


def _order_indexes(idxs: list[int], order) -> list[int]:
    """Stable multi-key ordering honoring ASC/DESC with PG null placement
    (nulls last for ASC, first for DESC)."""
    out = list(idxs)
    for vals, asc in reversed(order):
        nulls_first = not asc
        nulls = [i for i in out if vals[i] is None]
        nonnull = [i for i in out if vals[i] is not None]
        nonnull.sort(key=lambda i: vals[i], reverse=not asc)
        out = (nulls + nonnull) if nulls_first else (nonnull + nulls)
    return out


def _rows_slice(start, end, j: int, n: int) -> tuple[int, int]:
    """ROWS frame bounds -> [lo, hi) positions for row at position j."""
    sdir, sn = start
    edir, en = end
    if sdir == "preceding":
        lo = 0 if sn is None else j - sn
    elif sdir == "current":
        lo = j
    else:  # following
        lo = j + (sn or 0)
    if edir == "following":
        hi = n if en is None else j + en + 1
    elif edir == "current":
        hi = j + 1
    else:  # preceding
        hi = j - (en or 0) + 1
    return max(0, lo), min(n, hi)


def _peer_bounds(okeys, j: int, n: int) -> tuple[int, int]:
    """[first, last+1) of the peer group (equal full sort key) of row j."""
    lo = j
    while lo > 0 and okeys[lo - 1] == okeys[j]:
        lo -= 1
    hi = j + 1
    while hi < n and okeys[hi] == okeys[j]:
        hi += 1
    return lo, hi


def _range_slice(start, end, okeys, ovals, asc: bool, j: int,
                 n: int) -> tuple[int, int]:
    """RANGE frame bounds for row at sorted position j.

    ``okeys`` are the full sort-key tuples (peer detection); ``ovals``
    the single ORDER BY column values (None unless an offset bound is
    present).  CURRENT ROW means the peer group edge; offset bounds
    select rows whose value lies within the offset of the current value
    in ordering direction.  A NULL current value frames its peer group
    (NULLs are peers of each other, per PostgreSQL)."""
    plo, phi = _peer_bounds(okeys, j, n)

    def value_bound(direction: str, off, is_start: bool) -> int:
        cur = ovals[j]
        if cur is None:
            return plo if is_start else phi
        sign = 1 if asc else -1
        # target value at the frame edge, in ordering direction
        delta = -off if direction == "preceding" else off
        target = cur + sign * delta
        if is_start:
            k = 0
            while k < n and (ovals[k] is None
                             or (ovals[k] < target if asc else ovals[k] > target)):
                k += 1
            return k
        k = n
        while k > 0 and (ovals[k - 1] is None
                         or (ovals[k - 1] > target if asc else ovals[k - 1] < target)):
            k -= 1
        return k

    sdir, sn = start
    edir, en = end
    if sdir == "preceding" and sn is None:
        lo = 0
    elif sdir == "current":
        lo = plo
    else:
        lo = value_bound(sdir, sn, True)
    if edir == "following" and en is None:
        hi = n
    elif edir == "current":
        hi = phi
    else:
        hi = value_bound(edir, en, False)
    return max(0, lo), min(n, hi)


def compute_window(rows_n: int, fn_name: str, args: list[list],
                   partition: list[list], order: list[tuple[list, bool]],
                   frame: Optional[tuple] = None,
                   params: tuple = ()) -> list:
    """Compute one window function over decoded per-row value lists.

    args/partition: per-row value columns; order: (values, asc); frame:
    ROWS bounds; params: literal extras (lag offset/default, ntile n,
    nth_value n).  Returns per-row results in the original row order.
    """
    if fn_name not in RANKING | NAVIGATION | AGGS:
        raise UnsupportedFeatureError(f"window function {fn_name}() not supported")
    if frame is not None and frame[0] == "range":
        has_offset = any(d in ("preceding", "following") and v is not None
                         for d, v in (frame[1], frame[2]))
        if has_offset:
            if len(order) != 1:
                raise AnalysisError("RANGE offset frames require exactly one "
                                    "ORDER BY column")
            if any(v is not None and not isinstance(
                    v, (int, float, decimal.Decimal))
                   or isinstance(v, bool) for v in order[0][0]):
                raise AnalysisError("RANGE with offset requires a numeric "
                                    "ORDER BY column")
    groups: dict[tuple, list[int]] = {}
    for i in range(rows_n):
        key = tuple(p[i] for p in partition)
        groups.setdefault(key, []).append(i)
    out: list[Any] = [None] * rows_n
    for idxs in groups.values():
        if order:
            idxs = _order_indexes(idxs, order)
        okeys = [tuple(vals[i] for vals, _ in order) for i in idxs] if order else None
        n = len(idxs)
        col = args[0] if args else None
        # loop-invariant range-frame context (built once per partition)
        range_keys = okeys if okeys is not None else [()] * n
        range_vals = ([order[0][0][i] for i in idxs]
                      if len(order) == 1 else [None] * n)
        range_asc = order[0][1] if order else True

        def frame_slice(frame3, pos):
            mode, start, end = frame3
            if mode == "rows":
                return _rows_slice(start, end, pos, n)
            return _range_slice(start, end, range_keys, range_vals,
                                range_asc, pos, n)
        if fn_name == "row_number":
            for pos, i in enumerate(idxs):
                out[i] = pos + 1
            continue
        if fn_name in ("rank", "dense_rank"):
            rank = dense = 0
            prev = object()
            for pos, i in enumerate(idxs):
                cur = okeys[pos] if okeys is not None else ()
                if cur != prev:
                    rank = pos + 1
                    dense += 1
                    prev = cur
                out[i] = rank if fn_name == "rank" else dense
            continue
        if fn_name == "ntile":
            buckets = int(params[0]) if params else 1
            if buckets <= 0:
                raise AnalysisError("ntile() buckets must be positive")
            base, rem = divmod(n, buckets)
            pos = 0
            for b in range(buckets):
                size = base + (1 if b < rem else 0)
                for _ in range(size):
                    if pos < n:
                        out[idxs[pos]] = b + 1
                        pos += 1
            continue
        if fn_name in ("lag", "lead"):
            off = int(params[0]) if params else 1
            default = params[1] if len(params) > 1 else None
            for pos, i in enumerate(idxs):
                src = pos - off if fn_name == "lag" else pos + off
                out[i] = col[idxs[src]] if 0 <= src < n else default
            continue
        if fn_name in ("first_value", "last_value", "nth_value"):
            eff = frame or (("range", ("preceding", None), ("current", 0))
                            if order else ("rows", ("preceding", None),
                                           ("following", None)))
            for pos, i in enumerate(idxs):
                lo, hi = frame_slice(eff, pos)
                if lo >= hi:
                    out[i] = None
                elif fn_name == "first_value":
                    out[i] = col[idxs[lo]]
                elif fn_name == "last_value":
                    out[i] = col[idxs[hi - 1]]
                else:
                    k = int(params[0]) if params else 1
                    out[i] = col[idxs[lo + k - 1]] if lo + k - 1 < hi else None
            continue
        # aggregates
        if frame is not None:
            for pos, i in enumerate(idxs):
                lo, hi = frame_slice(frame, pos)
                window = [col[idxs[j]] for j in range(lo, hi)
                          if col is not None and col[idxs[j]] is not None] \
                    if col is not None else None
                out[i] = _agg_value(fn_name, window if window is not None else [],
                                    count_star=col is None, n=max(0, hi - lo))
            continue
        if not order:
            vals = [col[i] for i in idxs if col is not None and col[i] is not None] \
                if col is not None else idxs
            agg = _agg_value(fn_name, vals, count_star=col is None, n=n)
            for i in idxs:
                out[i] = agg
            continue
        # default frame: running aggregate including peer rows
        pos = 0
        acc: list = []
        while pos < n:
            end = pos
            while end < n and okeys[end] == okeys[pos]:
                end += 1
            for j in range(pos, end):
                i = idxs[j]
                if col is not None and col[i] is not None:
                    acc.append(col[i])
            agg = _agg_value(fn_name, acc, count_star=col is None, n=end)
            for j in range(pos, end):
                out[idxs[j]] = agg
            pos = end
    return out


def _agg_value(fn: str, vals: list, count_star: bool, n: int):
    if fn == "count":
        return n if count_star else len(vals)
    if not vals:
        return None
    if fn == "sum":
        return sum(vals)
    if fn == "min":
        return min(vals)
    if fn == "max":
        return max(vals)
    if fn == "avg":
        s = sum(vals)
        if isinstance(s, (int, decimal.Decimal)):
            return decimal.Decimal(s) / len(vals)
        return s / len(vals)
    raise AnalysisError(fn)
