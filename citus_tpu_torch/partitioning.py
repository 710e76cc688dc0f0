"""Declarative range partitioning over (distributed) tables.

Reference: PostgreSQL's PARTITION BY RANGE tables, which the reference
distributes per-partition (each partition is itself a distributed
table), plus the time-partition helpers create_time_partitions /
drop_old_time_partitions
(src/backend/distributed/utils/multi_partitioning_utils.c).

The parent is metadata-only (no shards receive rows); each partition
is an ordinary (optionally distributed, colocated with its siblings)
table whose TableMeta carries physical [lo, hi) bounds.  Scans against
the parent rewrite to the surviving partitions after pruning the WHERE
against the bounds: pruning stacks with shard pruning and chunk
skip-lists inside each partition, and each surviving partition's scan
runs the port's kernels.  The port of ``citus_tpu/partitioning.py``;
its one difference, in ``expand_from``, changes no rows.
"""

from __future__ import annotations

import datetime
from typing import Optional

import numpy as np

from citus_tpu_torch.errors import AnalysisError, CatalogError
from citus_tpu_torch.planner import ast as A


def bound_to_physical(col_type, raw):
    """Raw partition-bound literal -> physical value (None passes)."""
    if raw is None:
        return None
    return col_type.to_physical(raw)


def check_new_partition(cat, parent_meta, lo, hi) -> None:
    if lo is not None and hi is not None and not lo < hi:
        raise AnalysisError(
            "empty range: lower bound must be below upper bound")
    for p in cat.partitions_of(parent_meta.name):
        plo, phi = p.partition_of["lo"], p.partition_of["hi"]
        # overlap of [lo, hi) and [plo, phi) with None = unbounded
        lo_ok = hi is not None and plo is not None and hi <= plo
        hi_ok = lo is not None and phi is not None and lo >= phi
        if not (lo_ok or hi_ok):
            raise CatalogError(
                f'partition would overlap partition "{p.name}"')


def partition_for_rows(cat, parent_meta, phys_values: np.ndarray):
    """-> (list of (partition name, row mask)); raises when a row falls
    outside every partition (PostgreSQL: 'no partition of relation ...
    found for row')."""
    parts = cat.partitions_of(parent_meta.name)
    assigned = np.zeros(len(phys_values), bool)
    out = []
    for p in parts:
        lo, hi = p.partition_of["lo"], p.partition_of["hi"]
        m = ~assigned
        if lo is not None:
            m &= phys_values >= lo
        if hi is not None:
            m &= phys_values < hi
        if m.any():
            out.append((p.name, m))
            assigned |= m
    if not assigned.all():
        col = parent_meta.partition_by["column"]
        bad = phys_values[~assigned][0]
        raise AnalysisError(
            f'no partition of relation "{parent_meta.name}" found for '
            f'row ({col} physical value {bad})')
    return out


def check_partition_bounds(cat, leaf_meta, values, validity) -> None:
    """Enforce a leaf partition's [lo, hi) bounds on a physical ingest
    batch written directly to the leaf (the implicit partition CHECK
    constraint PostgreSQL attaches to every partition).  Without this a
    direct COPY/INSERT/UPDATE on the leaf could store rows the parent's
    partition pruning would silently exclude."""
    info = leaf_meta.partition_of
    if info is None:
        return
    parent = cat.table(info["parent"])
    pcol = parent.partition_by["column"]
    vals = values.get(pcol)
    if vals is None:
        return
    valid = validity.get(pcol)
    lo, hi = info["lo"], info["hi"]
    bad = np.zeros(len(vals), bool)
    if valid is not None:
        # NULL never satisfies a range partition constraint
        bad |= ~np.asarray(valid, bool)
    if lo is not None:
        bad |= vals < lo
    if hi is not None:
        bad |= vals >= hi
    if bad.any():
        i = int(np.nonzero(bad)[0][0])
        detail = "null" if (valid is not None and not valid[i]) \
            else f"physical value {vals[i]}"
        raise AnalysisError(
            f'new row for relation "{leaf_meta.name}" violates partition '
            f"constraint ({pcol} {detail} outside [{lo}, {hi})); "
            f'write through the parent "{parent.name}" to route rows')


def prune_partitions(cat, parent_meta, where: Optional[A.Expr]):
    """Partitions that can hold rows satisfying the WHERE clause —
    bound-level pruning from `col op literal` AND-conjuncts, the analog
    of shard pruning one level up (shard_pruning.c:314)."""
    parts = cat.partitions_of(parent_meta.name)
    if where is None:
        return parts
    try:
        from citus_tpu_torch.planner.bind import Binder
        from citus_tpu_torch.planner.physical import extract_intervals
        bound = Binder(cat, parent_meta).bind_scalar(where)
        intervals = [c for c in extract_intervals(bound)
                     if c.column == parent_meta.partition_by["column"]]
    except Exception:
        return parts  # unbindable / parameterized: no pruning
    if not intervals:
        return parts
    is_float = parent_meta.schema.column(
        parent_meta.partition_by["column"]).type.is_float
    out = []
    for p in parts:
        lo, hi = p.partition_of["lo"], p.partition_of["hi"]
        # Interval.admits takes a closed [cmin, cmax]; [lo, hi) over an
        # integer physical space is [lo, hi-1].  Float spaces keep hi
        # (conservative: the open bound may retain one extra partition,
        # never prunes a holding one).
        cmin = lo
        cmax = None if hi is None else (hi if is_float else hi - 1)
        if all(c.admits(cmin, cmax) for c in intervals):
            out.append(p)
    return out


def referenced_columns(stmt: A.Select) -> Optional[set]:
    """The column names a single-table SELECT reads anywhere (items,
    WHERE, GROUP BY, HAVING, ORDER BY, subqueries included: a superset),
    or None when it reads every column (``*``) or its FROM is not one
    table."""
    import dataclasses
    if not isinstance(stmt.from_, A.TableRef) \
            or any(isinstance(i.expr, A.Star) for i in stmt.items):
        return None
    out: set = set()

    def walk(node):
        if isinstance(node, A.ColumnRef):
            out.add(node.name)
        elif isinstance(node, (list, tuple)):
            for x in node:
                walk(x)
        elif isinstance(node, dict):
            for x in node.values():
                walk(x)
        elif dataclasses.is_dataclass(node) and not isinstance(node, type):
            for f in dataclasses.fields(node):
                walk(getattr(node, f.name))
    walk(stmt)
    return out


def expand_from(cluster, item, where: Optional[A.Expr],
                columns: Optional[set] = None):
    """Rewrite a FROM item that references a partitioned parent into its
    surviving partitions: one partition swaps the TableRef; several
    become a UNION ALL derived table; zero becomes an always-empty
    derived table.  ``columns`` (``referenced_columns`` of the statement)
    narrows the arms to the columns the statement reads, the first
    column when it reads none (the port's; the reference's arms read
    every column: the same rows, fewer of them materialized on the
    host)."""
    if isinstance(item, A.Join):
        left = expand_from(cluster, item.left, where)
        right = expand_from(cluster, item.right, where)
        if left is item.left and right is item.right:
            return item
        import dataclasses
        return dataclasses.replace(item, left=left, right=right)
    if not isinstance(item, A.TableRef):
        return item
    cat = cluster.catalog
    if not cat.has_table(item.name):
        return item
    t = cat.table(item.name)
    if not t.is_partitioned:
        return item
    alias = item.alias or item.name
    survivors = prune_partitions(cat, t, where)
    if len(survivors) == 1:
        return A.TableRef(survivors[0].name, alias)
    names = [c for c in t.schema.names if columns is None or c in columns]
    cols = [A.SelectItem(A.ColumnRef(c))
            for c in names or t.schema.names[:1]]
    if not survivors:
        # no partition can match: SELECT ... WHERE false over the parent
        # schema via an empty UNION arm is clumsy — synthesize a 0-row
        # derived table from the first partition (or error if none)
        parts = cat.partitions_of(t.name)
        if not parts:
            raise AnalysisError(
                f'partitioned table "{t.name}" has no partitions')
        empty = A.Select(cols, A.TableRef(parts[0].name),
                         A.Literal(False, "bool"))
        return A.SubqueryRef(empty, alias)
    # push the WHERE into each arm (qualifiers stripped) so shard/chunk
    # pruning still fires inside every partition — but ONLY when every
    # referenced column resolves against the parent itself (a predicate
    # naming a join partner would fail inside the single-table arm).
    # The outer query keeps its own copy; filtering twice is idempotent.
    arm_where = None
    if where is not None:
        from citus_tpu_torch.planner.recursive import _walk_columns, has_subquery
        if not has_subquery(where):
            names = {alias, item.name}
            refs = list(_walk_columns(where))
            pushable = all(
                (c.table is None or c.table in names)
                and t.schema.has(c.name) for c in refs)
            if pushable:
                from citus_tpu_torch.cluster import _replace_exprs
                mapping = {c: A.ColumnRef(c.name) for c in refs
                           if c.table in names}
                arm_where = _replace_exprs(where, mapping) \
                    if mapping else where
    node = A.Select(cols, A.TableRef(survivors[0].name), where=arm_where)
    for p in survivors[1:]:
        node = A.SetOp("union", True, node,
                       A.Select(cols, A.TableRef(p.name), where=arm_where))
    return A.SubqueryRef(node, alias)


# ---- time-partition helpers ---------------------------------------------

_INTERVALS = {
    "1 hour": datetime.timedelta(hours=1), "hour": datetime.timedelta(hours=1),
    "1 day": datetime.timedelta(days=1), "day": datetime.timedelta(days=1),
    "1 week": datetime.timedelta(weeks=1), "week": datetime.timedelta(weeks=1),
    "1 month": "month", "month": "month",
}


def _parse_ts(v) -> datetime.datetime:
    if isinstance(v, datetime.datetime):
        return v
    if isinstance(v, datetime.date):
        return datetime.datetime(v.year, v.month, v.day)
    from citus_tpu_torch.types import parse_datetime
    return parse_datetime(str(v))


def _advance(t: datetime.datetime, interval):
    if interval == "month":
        y, m = divmod(t.month, 12)
        return t.replace(year=t.year + y, month=m + 1)
    return t + interval


def _floor_to(t: datetime.datetime, interval) -> datetime.datetime:
    if interval == "month":
        return t.replace(day=1, hour=0, minute=0, second=0, microsecond=0)
    if interval >= datetime.timedelta(weeks=1):
        d = t.date() - datetime.timedelta(days=t.weekday())
        return datetime.datetime(d.year, d.month, d.day)
    if interval >= datetime.timedelta(days=1):
        return t.replace(hour=0, minute=0, second=0, microsecond=0)
    return t.replace(minute=0, second=0, microsecond=0)


def create_time_partitions(cluster, table: str, interval_str: str,
                           end_at, start_from=None) -> int:
    """SQL: SELECT create_time_partitions('t', '1 day', '2020-02-01'
    [, '2020-01-01']) — create missing range partitions at the cadence
    until end_at.  Returns partitions created (reference:
    multi_partitioning_utils.c create_time_partitions)."""
    cat = cluster.catalog
    t = cat.table(table)
    if not t.is_partitioned:
        raise AnalysisError(f'"{table}" is not partitioned')
    interval = _INTERVALS.get(str(interval_str).strip().lower())
    if interval is None:
        raise AnalysisError(
            f"unsupported partition interval {interval_str!r} "
            f"(supported: {', '.join(sorted(_INTERVALS))})")
    col = t.schema.column(t.partition_by["column"])
    end = _parse_ts(end_at)
    existing = cat.partitions_of(table)
    if start_from is not None:
        cur = _floor_to(_parse_ts(start_from), interval)
    elif existing and existing[-1].partition_of["hi"] is not None:
        cur = _from_physical_ts(col.type, existing[-1].partition_of["hi"])
    else:
        raise AnalysisError(
            "start_from is required when the table has no partitions")
    created = 0
    while cur < end:
        nxt = _advance(cur, interval)
        if interval == "month":
            name = f"{table}_p{cur.strftime('%Y%m')}"
        elif interval >= datetime.timedelta(days=1):
            name = f"{table}_p{cur.strftime('%Y%m%d')}"
        else:
            name = f"{table}_p{cur.strftime('%Y%m%d%H')}"
        lo = _fmt_bound(col.type, cur)
        hi = _fmt_bound(col.type, nxt)
        if not cat.has_table(name):
            cluster._create_partition(name, table, lo, hi,
                                      if_not_exists=True)
            created += 1
        cur = nxt
    return created


def drop_old_time_partitions(cluster, table: str, older_than) -> int:
    """Drop partitions whose whole range lies before ``older_than``
    (retention; reference: drop_old_time_partitions)."""
    cat = cluster.catalog
    t = cat.table(table)
    if not t.is_partitioned:
        raise AnalysisError(f'"{table}" is not partitioned')
    col = t.schema.column(t.partition_by["column"])
    cutoff = bound_to_physical(col.type, _coerce_bound(col.type, older_than))
    dropped = 0
    for p in list(cat.partitions_of(table)):
        hi = p.partition_of["hi"]
        if hi is not None and hi <= cutoff:
            cluster.drop_table(p.name)
            dropped += 1
    return dropped


def _coerce_bound(col_type, v):
    from citus_tpu_torch import types as T
    if col_type.kind == T.DATE and isinstance(v, str):
        return v[:10]
    return v


def _fmt_bound(col_type, ts: datetime.datetime):
    from citus_tpu_torch import types as T
    if col_type.kind == T.DATE:
        return ts.date().isoformat()
    if col_type.kind == T.TIMESTAMP:
        return ts.isoformat(sep=" ")
    raise AnalysisError(
        "create_time_partitions requires a date or timestamp "
        "partition column")


def _from_physical_ts(col_type, phys) -> datetime.datetime:
    v = col_type.from_physical(phys)
    return _parse_ts(v)
