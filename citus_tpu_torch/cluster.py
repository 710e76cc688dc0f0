"""Cluster: the public entry point.

One Cluster = one coordinator over a data directory + a logical node set,
executing on one torch device.  SQL goes through ``execute``; the
control-plane operations the reference exposes as UDFs
(create_distributed_table, ...) are available both as Python methods and
through their SQL spellings (``SELECT create_distributed_table('t','col')``).

This port carries the first slices of the JAX package's surface: CREATE
TABLE, create_distributed_table, COPY (``copy_from``), INSERT ... VALUES,
single-table SELECT with aggregates in every group mode (scalar, direct
and hash) and without them (filtered projections, DISTINCT), with ORDER
BY / LIMIT on the result, and EXPLAIN.  Everything
else raises UnsupportedFeatureError naming its ROADMAP.md item.  A data
directory written by ``citus_tpu`` opens here unchanged: the catalog
document, the columnar stripe files and the shard hash are the same.
"""

from __future__ import annotations

from typing import Any, Iterable, Optional, Sequence

from citus_tpu_torch.catalog import Catalog
from citus_tpu_torch.config import Settings, current_settings
from citus_tpu_torch.errors import AnalysisError, UnsupportedFeatureError
from citus_tpu_torch.executor import Result, execute_select
from citus_tpu_torch.ingest import TableIngestor, encode_columns, rows_to_columns
from citus_tpu_torch.observability import trace as _trace
from citus_tpu_torch.planner import ast as A
from citus_tpu_torch.planner import parse_sql
from citus_tpu_torch.planner.bind import bind_select
from citus_tpu_torch.schema import Schema


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


def _unported(what: str, item: str):
    raise UnsupportedFeatureError(
        f"{what} is not ported to citus_tpu_torch yet (ROADMAP.md {item})")


class Cluster:
    def __init__(self, data_dir: str, *, n_nodes: Optional[int] = None,
                 settings: Optional[Settings] = None, device=None):
        """``device``: the torch device the ``gpu`` backend runs on;
        None = CUDA (raises when there is none).  ``n_nodes`` defaults to
        the number of CUDA devices (1 on the CPU), as the reference
        defaults to its JAX device count."""
        import torch
        self.device = resolve_device(device)
        self.settings = settings or current_settings()
        self.catalog = Catalog(data_dir)
        if n_nodes is None:
            n_nodes = max(torch.cuda.device_count(), 1) \
                if self.device.type == "cuda" else 1
        if n_nodes:
            self.catalog.ensure_nodes(n_nodes)
        self.catalog.commit()
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

    def close(self) -> None:
        # release the transaction-log owner marker: our undecided
        # transactions become recoverable by other coordinators
        self.txlog.close()

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
        (src/backend/distributed/commands/create_distributed_table.c)."""
        t = self.catalog.table(name)
        if t.is_partitioned:
            _unported("partitioned tables", "queue A")
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
        self.catalog.commit()

    # ----------------------------------------------------------- ingest
    def copy_from(self, table_name: str,
                  columns: Optional[dict[str, Sequence[Any]]] = None,
                  rows: Optional[Iterable[Sequence[Any]]] = None,
                  column_names: Optional[list[str]] = None) -> int:
        """Bulk load (the COPY analog).  Either ``columns`` (dict of
        arrays/lists, fastest) or ``rows`` (iterable of tuples).  The
        load commits as one two-phase transaction across placements."""
        t = self.catalog.table(table_name)
        if (columns is None) == (rows is None):
            raise AnalysisError("provide exactly one of columns= or rows=")
        if t.is_partitioned:
            _unported("partitioned tables", "queue A")
        if t.foreign_keys or t.unique_indexes or t.check_constraints:
            _unported("constraint checks on ingest", "queue A")
        if rows is not None:
            columns = rows_to_columns(t.schema.names, rows, column_names)
        values, validity = encode_columns(self.catalog, t, columns)
        from citus_tpu_torch.transaction.locks import SHARED
        from citus_tpu_torch.transaction.write_locks import group_write_lock
        with group_write_lock(self.catalog, t, SHARED,
                              lock_manager=self.locks,
                              timeout=self.settings.executor.lock_timeout_s):
            t = self.catalog.table(table_name)  # re-fetch: fresh placements
            ing = TableIngestor(self.catalog, t, txlog=self.txlog)
            try:
                ing.append(values, validity)
            except BaseException:
                ing.abort()
                raise
            ing.finish()
        n = len(next(iter(values.values()))) if values else 0
        self.counters.bump("rows_ingested", n)
        return n

    # -------------------------------------------------------------- SQL
    def execute(self, sql: str, params: Optional[Sequence[Any]] = None) -> Result:
        """Run one SQL string.  Safe to call from several threads at
        once: the plan cache, the counters, the device cache, the kernel
        builds and the launch counters are locked, and each statement
        keeps its own scan state.  Concurrent literal variants of one
        query coalesce into one scan when ``citus.megabatch_window_ms``
        is set (executor/megabatch.py)."""
        if params:
            _unported("parameterized execute()", "queue A")
        result = Result(columns=[], rows=[])
        with _trace.span("parse"):
            stmts = parse_sql(sql)
        t0 = _trace.clock()
        for stmt in stmts:
            result = self._execute_stmt(stmt, sql if len(stmts) == 1 else None)
        self._record_statement(sql, result, _trace.clock() - t0)
        return result

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
        Returns (bound, plan, values)."""
        backend = self.settings.executor.task_executor_backend
        cache_on = key is not None \
            and self.settings.planner.plan_cache_mode != "force_custom"
        _trace.set_phase("plan")
        if cache_on:
            entry = self._plan_cache.lookup(key, self.catalog, backend)
            if entry is not None:
                self.counters.bump("plan_cache_hits")
                return entry.bound, entry.plan, entry.values
        with _trace.span("bind"):
            bound = bind_select(self.catalog, stmt)
        values = None
        if cache_on:
            from citus_tpu_torch.planner.auto_param import auto_parameterize
            ap = auto_parameterize(bound)
            if ap is not None:
                bound, values = ap
        from citus_tpu_torch.planner.physical import plan_select
        plan = plan_select(self.catalog, bound,
                           direct_limit=self.settings.planner.direct_gid_limit)
        if cache_on:
            self._plan_cache.put(key, bound, plan, self.catalog, backend,
                                 values=values)
            self.counters.bump("plan_cache_misses")
        return bound, plan, values

    def _execute_stmt(self, stmt: A.Statement,
                      sql_text: Optional[str] = None) -> Result:
        if isinstance(stmt, A.Select):
            return self._execute_select(stmt, sql_text)
        if isinstance(stmt, A.UtilityCall):
            from citus_tpu_torch.commands.utility import execute_utility
            return execute_utility(self, stmt)
        from citus_tpu_torch.commands import loader as _loader
        _loader.ensure_loaded()
        from citus_tpu_torch.commands.registry import lookup as _lookup
        handler = _lookup(stmt)
        if handler is not None:
            return handler(self, stmt)
        if isinstance(stmt, A.TransactionStmt):
            _unported("transaction blocks (BEGIN/COMMIT)", "queue A")
        _unported(type(stmt).__name__, "queue A")

    def _execute_select(self, stmt: A.Select, sql_text) -> Result:
        if stmt.from_ is None:
            _unported("SELECT without FROM", "queue A")
        if isinstance(stmt.from_, A.Join):
            _unported("joins", "queue A and B7/B8")
        if not isinstance(stmt.from_, A.TableRef):
            _unported("subqueries in FROM", "queue A")
        if stmt.distinct_on or stmt.windows or any(
                isinstance(i.expr, A.WindowCall) for i in stmt.items):
            _unported("DISTINCT ON and window functions", "queue A")
        if len(stmt.group_by) == 1 \
                and isinstance(stmt.group_by[0], A.GroupingSetsSpec):
            _unported("GROUPING SETS", "queue A")
        from citus_tpu_torch.planner.recursive import has_subquery
        exprs = ([i.expr for i in stmt.items] + [stmt.where, stmt.having]
                 + list(stmt.group_by) + [o.expr for o in stmt.order_by])
        if any(e is not None and has_subquery(e) for e in exprs):
            _unported("subqueries", "queue A")
        bound, plan, values = self._cached_select_plan(stmt, sql_text or None)
        return execute_select(self.catalog, bound, self.settings,
                              plan=plan, param_values=values,
                              device=self.device)
