"""Rollup lifecycle + the CDC-fed incremental refresh loop.

A rollup is a materialized GROUP BY over one distributed source table
whose aggregate columns are *re-mergeable*: plain adds (count/sum) and
serialized sketch states (SKETCH columns, rollup/sketches.py).  Because
every aggregate's merge law is commutative and associative, folding a
CDC delta batch into the stored state gives the same answer as
re-scanning source ∪ delta — the property that makes the refresh
incremental instead of a re-materialization.

Three moving parts live here:

* ``create_rollup`` — validates the spec, creates the rollup table
  colocated with its source (refresh upserts are then shard-local),
  snapshots existing rows as the backfill, and records the spec in
  ``catalog.rollups``.
* ``refresh_once`` — drains one batch of CDC insert events past the
  rollup's watermark, computes per-group partials on the Cluster's
  device through the rollup kernel (rollup/kernels.py, bucketing with
  the same functions as the scan fold), and
  applies them via ``INSERT ... ON CONFLICT ... DO UPDATE`` with
  ``sketch_merge`` assignments.  The delta upserts and the watermark
  advance commit in ONE transaction, so a crash at any point (fault
  point ``rollup_refresh`` sits between them) replays the whole batch
  exactly once — the WAL either rolls the batch forward with its
  watermark or rolls both back.
* the background loop — FlightRecorder-style lifecycle (``apply`` /
  ``start`` / ``stop`` on the ``citus.rollup_refresh_interval_ms``
  GUC, ``run_once`` as the synchronous test hook).  Device work is
  admitted under the low-weight ``rollup_refresh`` tenant so a
  refresh burst cannot starve foreground queries.

The watermark is a ROW in the ``citus_rollup_progress`` table, not a
catalog field: catalog commits are not transactional with table writes,
table-to-table writes are.

Append-only caveat: update/delete CDC events cannot be folded into a
merge-only state (a sketch cannot "unsee" a value); they are counted
(``rollup_skipped_changes``), surfaced in ``citus_rollups()``, and the
watermark advances past them.  Rows whose group key contains a NULL are
skipped the same way (rollup group keys are the conflict target).
"""

from __future__ import annotations

import re
import threading

import numpy as np

from citus_tpu_torch import types as T
from citus_tpu_torch.cluster import _pylit
from citus_tpu_torch.errors import AnalysisError
from citus_tpu_torch.planner import ast as A
from citus_tpu_torch.rollup import kernels, sketches
from citus_tpu_torch.stats import begin_wait, end_wait
from citus_tpu_torch.testing.faults import FAULTS

PROGRESS_TABLE = "citus_rollup_progress"

#: admission tenant for refresh device work (weight ~ a tenth of a
#: default foreground tenant's share)
REFRESH_TENANT = "rollup_refresh"
REFRESH_TENANT_WEIGHT = 0.1

_IDENT = re.compile(r"[A-Za-z_]\w*$")
_AGG = re.compile(r"(\w+)\s*\(\s*(\*|[A-Za-z_]\w*)\s*\)$")

#: agg spec kind -> (rollup column prefix, sketch kind or None)
_AGG_KINDS = {
    "count": ("n_rows", None),
    "sum": ("sum_", None),
    "hll": ("acd_", "hll"),
    "pct": ("apct_", None),     # sketch kind chosen by backend
    "topk": ("atopk_", "topk"),
}

_SQL_TYPE_NAMES = {
    T.BOOL: "bool", T.INT16: "smallint", T.INT32: "int",
    T.INT64: "bigint", T.FLOAT32: "real", T.FLOAT64: "double",
    T.DATE: "date", T.TIMESTAMP: "timestamp",
    T.TIMESTAMPTZ: "timestamptz", T.TIME: "time",
    T.INTERVAL: "interval", T.TEXT: "text", T.UUID: "uuid",
}

_INT_KINDS = (T.BOOL, T.INT16, T.INT32, T.INT64)
_FLOAT_KINDS = (T.FLOAT32, T.FLOAT64)


def _counters():
    from citus_tpu_torch.executor.executor import GLOBAL_COUNTERS
    return GLOBAL_COUNTERS


def _sql_lit(v) -> str:
    """Python value -> SQL literal text for the refresh statements."""
    if v is None:
        return "NULL"
    if isinstance(v, bool):
        return "TRUE" if v else "FALSE"
    if isinstance(v, (int, float)):
        return repr(v)
    s = str(v)
    return "'" + s.replace("'", "''") + "'"


def parse_aggs(aggs_text: str) -> list[tuple[str, str]]:
    """``"count(*), sum(x), approx_percentile(y)"`` ->
    ``[("count", "*"), ("sum", "x"), ("pct", "y")]``."""
    out = []
    for part in aggs_text.split(","):
        part = part.strip()
        if not part:
            continue
        m = _AGG.match(part)
        if not m:
            raise AnalysisError(f"cannot parse rollup aggregate {part!r}")
        fn, col = m.group(1).lower(), m.group(2)
        if fn == "count" and col == "*":
            out.append(("count", "*"))
        elif fn == "sum" and col != "*":
            out.append(("sum", col))
        elif fn == "approx_count_distinct" and col != "*":
            out.append(("hll", col))
        elif fn == "approx_percentile" and col != "*":
            out.append(("pct", col))
        elif fn == "approx_top_k" and col != "*":
            out.append(("topk", col))
        else:
            raise AnalysisError(
                f"unsupported rollup aggregate {part!r} (supported: "
                f"count(*), sum(col), approx_count_distinct(col), "
                f"approx_percentile(col), approx_top_k(col))")
    if not out:
        raise AnalysisError("rollup needs at least one aggregate")
    return out


def agg_column(kind: str, col: str) -> str:
    """The rollup-table column name an agg spec materializes into."""
    prefix, _ = _AGG_KINDS[kind]
    return "n_rows" if kind == "count" else prefix + col


def _group_index(rows, gi: list) -> tuple[list, np.ndarray]:
    """Rows -> (group keys in order of first appearance, int64 group
    index per row): the numbering of the reference's dict loop, with the
    columns uniqued by numpy.  A float NaN key (every NaN object its own
    dict key there) or values numpy cannot order take that loop."""
    codes = None
    try:
        for j in gi:
            col = np.array([r[j] for r in rows])
            if col.ndim != 1 or (col.dtype.kind == "f"
                                 and np.isnan(col).any()):
                raise TypeError("not uniqued by numpy")
            _, inv = np.unique(col, return_inverse=True)
            inv = inv.astype(np.int64).reshape(-1)
            codes = inv if codes is None \
                else codes * (int(inv.max()) + 1) + inv
    except TypeError:
        uniq, gidx = {}, np.empty(len(rows), np.int64)
        for i, r in enumerate(rows):
            gidx[i] = uniq.setdefault(tuple(r[j] for j in gi), len(uniq))
        return list(uniq), gidx
    _, first, inv = np.unique(codes, return_index=True, return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty(order.size, np.int64)
    rank[order] = np.arange(order.size)
    return ([tuple(rows[first[g]][j] for j in gi) for g in order],
            rank[inv.reshape(-1)])


class RollupManager:
    """Per-cluster rollup registry and refresh thread."""

    def __init__(self, cluster) -> None:
        self._cluster = cluster
        self._stop = threading.Event()
        self._thread = None
        # refresh/drop serialize PER ROLLUP NAME through this busy set
        # instead of one lock held across execute(): execute can park
        # in admission_wait, and blocking there while holding a plain
        # mutex is exactly the wait-under-lock stall citussan flags
        self._busy_cv = threading.Condition()
        self._busy: set = set()

    # ------------------------------------------------------- lifecycle

    def apply(self) -> None:
        """Start or stop the refresh loop to match the current GUC
        value (the SET citus.rollup_refresh_interval_ms hook)."""
        if self._interval_ms() > 0:
            self.start()
        else:
            self.stop()

    def _interval_ms(self) -> float:
        return float(
            self._cluster.settings.rollup.rollup_refresh_interval_ms)

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="citus-rollup-refresh")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._thread = None

    def _loop(self) -> None:
        while not self._stop.is_set():
            interval = self._interval_ms()
            if interval <= 0:
                break
            try:
                self.run_once()
            except Exception:  # lint: disable=SWL01 -- a failed refresh tick must not kill the loop; the error counter is the signal and the next tick retries from the durable watermark
                _counters().bump("rollup_refresh_errors", 1)
            token = begin_wait("rollup_refresh")
            try:
                self._stop.wait(timeout=interval / 1000.0)
            finally:
                end_wait(token)

    def run_once(self) -> int:
        """One refresh tick: drain every registered rollup to its CDC
        head.  Synchronous test hook, like FlightRecorder.run_once."""
        total = 0
        for name in sorted(self._cluster.catalog.rollups):
            while True:
                folded = self.refresh_once(name)
                if folded is None:
                    break
                total += folded
        _counters().bump("rollup_refresh_ticks", 1)
        return total

    # ------------------------------------------------------------- DDL

    def create_rollup(self, name: str, source: str, group_cols_text: str,
                      aggs_text: str) -> dict:
        cl = self._cluster
        if not _IDENT.match(name or ""):
            raise AnalysisError(f"invalid rollup name {name!r}")
        if name in cl.catalog.rollups or cl.catalog.has_table(name):
            raise AnalysisError(f"relation {name!r} already exists")
        src = cl.catalog.table(source)
        if not src.is_distributed:
            raise AnalysisError(
                f"rollup source {source!r} must be a distributed table")
        if not cl._cdc_captures(source):
            raise AnalysisError(
                f"rollup source {source!r} has no CDC stream; enable "
                f"change data capture or add it to a publication")
        group_cols = [c.strip() for c in group_cols_text.split(",")
                      if c.strip()]
        if not group_cols:
            raise AnalysisError("rollup needs at least one group column")
        for c in group_cols:
            if not src.schema.has(c):
                raise AnalysisError(
                    f"group column {c!r} does not exist in {source!r}")
            if src.schema.column(c).type.kind not in _SQL_TYPE_NAMES:
                raise AnalysisError(
                    f"column {c!r} cannot be a rollup group column")
        if src.dist_column not in group_cols:
            raise AnalysisError(
                f"rollup group columns must include the source "
                f"distribution column {src.dist_column!r} (refresh "
                f"upserts route by it)")
        aggs = parse_aggs(aggs_text)
        backend = "tdg" if cl.settings.rollup.percentile_backend \
            == "tdigest" else "ddsk"
        ddl_cols = []
        for c in group_cols:
            kind = src.schema.column(c).type.kind
            t = src.schema.column(c).type
            sql_t = _SQL_TYPE_NAMES[kind]
            if kind == T.DECIMAL:
                sql_t = f"decimal({t.precision},{t.scale})"
            ddl_cols.append(f"{c} {sql_t}")
        spec_aggs = []
        for kind, col in aggs:
            out = agg_column(kind, col)
            if any(a[2] == out for a in spec_aggs):
                raise AnalysisError(
                    f"duplicate rollup aggregate column {out!r}")
            if kind == "count":
                ddl_cols.append("n_rows bigint")
            elif kind == "sum":
                ck = src.schema.column(col).type.kind
                if ck in _INT_KINDS:
                    ddl_cols.append(f"{out} bigint")
                elif ck in _FLOAT_KINDS:
                    ddl_cols.append(f"{out} double")
                else:
                    raise AnalysisError(
                        f"sum({col}) is not supported in rollups for "
                        f"type {ck}")
            else:
                if not src.schema.has(col):
                    raise AnalysisError(
                        f"aggregate column {col!r} does not exist in "
                        f"{source!r}")
                if kind == "pct" and src.schema.column(col).type.kind \
                        not in _INT_KINDS + _FLOAT_KINDS + (T.DECIMAL,):
                    raise AnalysisError(
                        f"approx_percentile({col}) needs a numeric "
                        f"column")
                if kind == "topk" and src.schema.column(col).type.kind \
                        not in (T.INT16, T.INT32, T.INT64):
                    raise AnalysisError(
                        f"approx_top_k({col}) needs an integer column "
                        f"(matching the scan aggregate)")
                ddl_cols.append(f"{out} sketch")
            spec_aggs.append([kind, col, out])
        cl.execute(f"CREATE TABLE {name} ({', '.join(ddl_cols)})")
        cl.create_distributed_table(
            name, src.dist_column, shard_count=len(src.shards),
            colocate_with=source)
        self._ensure_progress_table()
        spec = {"source": source, "table": name,
                "group_cols": group_cols, "aggs": spec_aggs,
                "backend": backend}
        cl.catalog.rollups[name] = spec
        cl.catalog.commit()
        # Backfill: snapshot the watermark FIRST, then scan.  Rows
        # ingested between the two are folded twice only if they both
        # appear in the scan and carry lsn > watermark — the bench and
        # docs therefore create rollups before opening ingest; a
        # concurrent-create skew is bounded by one in-flight batch.
        wm0 = cl.cdc.last_lsn(source)
        need = sorted({c for c in group_cols}
                      | {a[1] for a in spec_aggs if a[1] != "*"})
        res = cl.execute(
            f"SELECT {', '.join(need)} FROM {source}")
        self._apply_batch(name, spec, res.rows, list(res.columns),
                          watermark=wm0, progress_insert=True)
        return spec

    def _claim(self, name: str) -> None:
        """Take the per-name refresh/drop slot (blocks while another
        thread folds or drops the same rollup; holds NO lock after)."""
        with self._busy_cv:
            while name in self._busy:
                self._busy_cv.wait()
            self._busy.add(name)

    def _unclaim(self, name: str) -> None:
        with self._busy_cv:
            self._busy.discard(name)
            self._busy_cv.notify_all()

    def drop_rollup(self, name: str) -> None:
        cl = self._cluster
        if name not in cl.catalog.rollups:
            raise AnalysisError(f"rollup {name!r} does not exist")
        self._claim(name)
        try:
            if name not in cl.catalog.rollups:  # raced a concurrent drop
                raise AnalysisError(f"rollup {name!r} does not exist")
            del cl.catalog.rollups[name]
            cl.catalog.commit()
            cl.execute(f"DROP TABLE {name}")
            cl.execute(f"DELETE FROM {PROGRESS_TABLE} "
                       f"WHERE rollup = {_sql_lit(name)}")
        finally:
            self._unclaim(name)

    def _ensure_progress_table(self) -> None:
        cl = self._cluster
        if not cl.catalog.has_table(PROGRESS_TABLE):
            cl.execute(f"CREATE TABLE {PROGRESS_TABLE} "
                       f"(rollup text, watermark bigint)")

    # --------------------------------------------------------- refresh

    def watermark(self, name: str):
        cl = self._cluster
        if not cl.catalog.has_table(PROGRESS_TABLE):
            return None
        res = cl.execute(
            f"SELECT watermark FROM {PROGRESS_TABLE} "
            f"WHERE rollup = {_sql_lit(name)}")
        return int(res.rows[0][0]) if res.rows else None

    def refresh_once(self, name: str):
        """Fold ONE batch (<= citus.rollup_max_batch_rows source rows)
        of CDC changes past the watermark.  Returns the number of rows
        folded, or None when the rollup is already at the CDC head."""
        cl = self._cluster
        spec = cl.catalog.rollups.get(name)
        if spec is None:
            raise AnalysisError(f"rollup {name!r} does not exist")
        self._claim(name)
        try:
            spec = cl.catalog.rollups.get(name)
            if spec is None:  # dropped while we waited for the slot
                return None
            wm = self.watermark(name)
            if wm is None:
                return None
            source = spec["source"]
            limit = max(1, int(cl.settings.rollup.rollup_max_batch_rows))
            batch, skipped, upto, n = [], 0, wm, 0
            for ev in cl.cdc.events(source, from_lsn=wm):
                if ev["op"] == "insert":
                    rows = ev.get("rows") or []
                    cols = list(ev.get("columns") or [])
                    batch.append((cols, rows))
                    n += len(rows)
                else:
                    # merge-only states cannot retract; count and skip
                    # (documented append-only assumption)
                    skipped += 1
                upto = int(ev["lsn"])
                if n >= limit:
                    break
            if upto <= wm:
                return None
            if skipped:
                _counters().bump("rollup_skipped_changes", skipped)
            need = sorted({c for c in spec["group_cols"]}
                          | {a[1] for a in spec["aggs"] if a[1] != "*"})
            flat_rows = []
            for cols, rows in batch:
                idx = {c: cols.index(c) for c in need if c in cols}
                for r in rows:
                    flat_rows.append(tuple(
                        r[idx[c]] if c in idx else None for c in need))
            self._apply_batch(name, spec, flat_rows, need, watermark=upto,
                              progress_insert=False)
            return len(flat_rows)
        finally:
            self._unclaim(name)

    # --------------------------------------------------- batch folding

    def _apply_batch(self, name: str, spec: dict, rows, cols: list,
                     watermark: int, progress_insert: bool) -> None:
        """Group one delta batch, compute partials, and commit the
        upserts + watermark advance as one transaction."""
        cl = self._cluster
        group_cols = spec["group_cols"]
        gi = [cols.index(c) for c in group_cols]
        keyed = [r for r in rows
                 if not any(r[i] is None for i in gi)]
        dropped = len(rows) - len(keyed)
        if dropped:
            _counters().bump("rollup_skipped_changes", dropped)
        out_rows = self._fold_groups(spec, keyed, cols) if keyed else []
        upsert = None
        if out_rows:
            # the statement the reference writes as SQL text, built as
            # its syntax tree: the same literals, without printing and
            # parsing ~10,000 rows of sketch words per fold
            sets = []
            for kind, _col, out in spec["aggs"]:
                cur, new = A.ColumnRef(out), A.ColumnRef(out, "excluded")
                sets.append((out, A.BinOp("+", cur, new)
                             if kind in ("count", "sum")
                             else A.FuncCall("sketch_merge", (cur, new))))
            upsert = A.Insert(
                spec["table"],
                list(group_cols) + [a[2] for a in spec["aggs"]],
                [[_pylit(v) for v in r] for r in out_rows],
                on_conflict=A.OnConflict(tuple(group_cols), "update",
                                         tuple(sets)))
        ex = cl.execute
        ex("BEGIN")
        try:
            if upsert is not None:
                from citus_tpu_torch.storage.overlay import (
                    transaction_overlay,
                )
                with transaction_overlay(cl._default_session().txn):
                    cl._execute_stmt(upsert)
            # the exactly-once regression kills the process here: the
            # deltas are applied but the watermark is not yet advanced;
            # recovery must roll BOTH back
            FAULTS.hit("rollup_refresh")
            if progress_insert:
                ex(f"INSERT INTO {PROGRESS_TABLE} (rollup, watermark) "
                   f"VALUES ({_sql_lit(name)}, {int(watermark)})")
            else:
                ex(f"UPDATE {PROGRESS_TABLE} "
                   f"SET watermark = {int(watermark)} "
                   f"WHERE rollup = {_sql_lit(name)}")
            ex("COMMIT")
        except BaseException:
            try:
                ex("ROLLBACK")
            except Exception:  # lint: disable=SWL01 -- rollback of an already-dead txn; the original error is the signal
                pass
            raise
        _counters().bump("rollup_rows_folded", len(keyed))

    def _fold_groups(self, spec: dict, rows, cols: list) -> list:
        """Delta rows -> one output row per group: group key values +
        merged-agg cell values (ints for count/sum, sketch words)."""
        from citus_tpu_torch.workload.registry import GLOBAL_TENANTS
        from citus_tpu_torch.workload.scheduler import GLOBAL_SCHEDULER
        cl = self._cluster
        src = cl.catalog.table(spec["source"])
        gi = [cols.index(c) for c in spec["group_cols"]]
        keys, gidx = _group_index(rows, gi)
        n_groups = len(keys)
        ok_row = np.ones(len(rows), bool)
        GLOBAL_TENANTS.set_quota(REFRESH_TENANT,
                                 weight=REFRESH_TENANT_WEIGHT)
        cells = []  # one [G] list per agg, aligned with spec["aggs"]
        with GLOBAL_SCHEDULER.slot(
                cl.settings, REFRESH_TENANT,
                timeout=cl.settings.executor.lock_timeout_s):
            for kind, col, _out in spec["aggs"]:
                cells.append(self._fold_one(
                    spec, src, kind, col, rows, cols, gidx, ok_row,
                    n_groups))
        return [list(key) + [c[g] for c in cells]
                for g, key in enumerate(keys)]

    def _fold_one(self, spec, src, kind, col, rows, cols, gidx, ok_row,
                  n_groups):
        if kind == "count":
            part = kernels.delta_partials("count", gidx, ok_row, n_groups,
                                          device=self._cluster.device)
            return [int(v) for v in part]
        ci = cols.index(col)
        raw = [r[ci] for r in rows]
        ok = ok_row & np.array([v is not None for v in raw], bool)
        if kind == "sum":
            ck = src.schema.column(col).type.kind
            sk = "sum_int" if ck in _INT_KINDS else "sum_float"
            vals = np.array([0 if v is None else v for v in raw],
                            np.int64 if sk == "sum_int" else np.float64)
            part = kernels.delta_partials(sk, gidx, ok, n_groups, vals,
                                          device=self._cluster.device)
            return [int(v) if sk == "sum_int" else float(v)
                    for v in part]
        if kind == "pct" and spec["backend"] == "tdg":
            vals = np.array([0.0 if v is None else float(v)
                             for v in raw], np.float64)
            words = []
            for g in range(n_groups):
                sel = (np.asarray(gidx) == g) & ok
                words.append(sketches.encode_sketch(
                    "tdg", sketches.tdg_from_values(vals[sel])))
            return words
        if kind == "pct":
            vals = np.array([0.0 if v is None else float(v)
                             for v in raw], np.float64)
            part = kernels.delta_partials("ddsk", gidx, ok, n_groups,
                                          vals, device=self._cluster.device)
            return [sketches.encode_sketch("ddsk", part[g])
                    for g in range(n_groups)]
        # hll / topk hash the value's bit pattern; text values hash
        # their table-global dictionary id, so the refresh must encode
        # through the SAME dictionary the scan aggregates read
        ck = src.schema.column(col).type.kind
        if ck in (T.TEXT, T.UUID, T.BYTEA, T.ARRAY):
            ctype = src.schema.column(col).type
            words_in = [ctype.normalize_word(v)
                        if v is not None else "" for v in raw]
            ids = self._cluster.catalog.encode_strings(
                spec["source"], col, words_in)
            bits = np.asarray(ids, np.int64)
        else:
            bits = kernels.value_bits(
                np.array([0 if v is None else v for v in raw]))
        if kind == "hll":
            part = kernels.delta_partials("hll", gidx, ok, n_groups,
                                          bits, device=self._cluster.device)
            return [sketches.encode_sketch("hll", part[g])
                    for g in range(n_groups)]
        counts, vals = kernels.delta_partials("topk", gidx, ok, n_groups,
                                              bits,
                                              device=self._cluster.device)
        out = []
        for g in range(n_groups):
            state = sketches.empty_state("topk")
            state[:sketches.TOPK_M] = counts[g]
            state[sketches.TOPK_M:] = vals[g]
            out.append(sketches.encode_sketch("topk", state))
        return out

    # ----------------------------------------------------------- views

    def rollup_rows(self) -> list:
        """[name, source, table, backend, watermark, head_lsn,
        pending_changes] per registered rollup — the citus_rollups()
        surface (pending_changes is the refresh lag in change records)."""
        cl = self._cluster
        rows = []
        for name in sorted(cl.catalog.rollups):
            spec = cl.catalog.rollups[name]
            wm = self.watermark(name)
            head = cl.cdc.last_lsn(spec["source"])
            pending = 0 if wm is None \
                else cl.cdc.pending_count(spec["source"], wm)
            rows.append([name, spec["source"], spec["table"],
                         spec["backend"], wm, head, pending])
        return rows
