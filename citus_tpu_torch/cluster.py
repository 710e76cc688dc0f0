"""Cluster: the public entry point.

One Cluster = one coordinator over a data directory + a logical node set,
executing on one torch device.  SQL goes through ``execute``; the
control-plane operations the reference exposes as UDFs
(create_distributed_table, ...) are available both as Python methods and
through their SQL spellings (``SELECT create_distributed_table('t','col')``).

This port carries the first slices of the JAX package's surface: CREATE
TABLE / DROP TABLE, create_distributed_table, COPY (``copy_from``),
INSERT ... VALUES with ON CONFLICT, UPDATE, DELETE, TRUNCATE,
BEGIN/COMMIT/ROLLBACK and savepoints (``session()``), single-table
SELECT with aggregates in every group mode (scalar, direct and hash,
sketch aggregates included) and without them (filtered projections,
DISTINCT), with ORDER BY / LIMIT on the result, EXPLAIN, change data
capture and CDC-fed rollups (``rollup/``).  Everything else raises
UnsupportedFeatureError naming its ROADMAP.md item.  A data
directory written by ``citus_tpu`` opens here unchanged: the catalog
document, the columnar stripe files and the shard hash are the same.
"""

from __future__ import annotations

from typing import Any, Iterable, Optional, Sequence

from citus_tpu_torch.catalog import Catalog
from citus_tpu_torch.config import Settings, current_settings
from citus_tpu_torch.errors import (
    AnalysisError, TransactionError, UnsupportedFeatureError,
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
        # change data capture: one stream per table, written at commit
        from citus_tpu_torch.cdc import ChangeDataCapture
        from citus_tpu_torch.utils.clock import CausalClock
        self.clock = CausalClock(data_dir)
        self.cdc = ChangeDataCapture(
            data_dir, self.settings.enable_change_data_capture)
        # per-thread implicit sessions: {thread ident: (Thread, Session)}
        self._default_sessions: dict = {}
        # mtime-poll baseline: our own open-time commit; a newer catalog
        # file is another process's change
        self._catalog_mtime = getattr(self.catalog, "self_mtime", None)
        # continuous aggregation (rollup/manager.py): the CDC-fed
        # incremental refresh loop only runs while
        # citus.rollup_refresh_interval_ms > 0
        from citus_tpu_torch.rollup import RollupManager
        self.rollup_manager = RollupManager(self)
        self.rollup_manager.apply()

    def close(self) -> None:
        # open transactions on the per-thread default sessions roll back
        # (connection-close semantics)
        for _owner, ds in list(self._default_sessions.values()):
            if ds.txn is not None:
                self._rollback_txn(ds)
        self.rollup_manager.stop()
        # release the transaction-log owner marker: our undecided
        # transactions become recoverable by other coordinators
        self.txlog.close()

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
            with group_write_lock(self.catalog, table_meta, mode,
                                  lock_manager=self.locks,
                                  timeout=self.settings.executor.lock_timeout_s):
                self._maybe_reload_catalog(force_sync=True)
                yield
        return _ctx()

    def _maybe_reload_catalog(self, force_sync: bool = False) -> None:
        """Pick up metadata another process sharing this data directory
        committed (catalog-file mtime polling; the reference also takes
        invalidations from its control plane, ROADMAP.md A13).  Our own
        commits never trigger a reload."""
        import os
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
        with self.catalog._lock:
            # swap, never clear-then-refill: concurrent readers see the
            # old or the new document
            self.catalog._dicts = {}
            self.catalog._dict_index = {}
            self.catalog._dict_sig = {}
            if os.path.exists(self.catalog._path()):
                self.catalog._load()
            else:
                self.catalog.tables = {}
                self.catalog.nodes = {}
            self.catalog.ddl_epoch += 1  # invalidate cached plans
        self._plan_cache.clear()

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

    def drop_table(self, name: str, *, if_exists: bool = False) -> None:
        """DROP TABLE (reference: citus_drop_all_shards): the catalog
        entry and, at once or at COMMIT inside a transaction, its files.
        Partitioned tables and tables other tables reference by foreign
        key are not ported (ROADMAP.md A11)."""
        if if_exists and not self.catalog.has_table(name):
            return
        t = self.catalog.table(name)
        if t.is_partitioned or t.partition_of is not None:
            _unported("partitioned tables", "A11")
        if self.catalog.referencing_fks(name):
            _unported("foreign keys", "A11")
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

    def _truncate_one(self, name: str) -> None:
        from citus_tpu_torch.executor.dml import execute_truncate
        from citus_tpu_torch.transaction.locks import EXCLUSIVE
        t = self.catalog.table(name)
        if t.is_partitioned:
            _unported("partitioned tables", "A11")
        with self._write_lock(t, EXCLUSIVE):
            execute_truncate(self.catalog, self.catalog.table(name))
        self._plan_cache.invalidate_table(name)
        if self._cdc_captures(t.name):
            self.cdc.emit(t.name, "truncate",
                          self.clock.transaction_clock(), force=True)

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
        stream at commit."""
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
        if t.is_partitioned:
            _unported("partitioned tables", "queue A")
        if t.foreign_keys or t.unique_indexes or t.check_constraints:
            _unported("constraint checks on ingest", "queue A")
        values, validity = encode_columns(self.catalog, t, columns)
        from citus_tpu_torch.transaction.locks import SHARED
        txn = current_overlay()
        with self._write_lock(t, SHARED):
            t = self.catalog.table(table_name)  # re-fetch: fresh placements
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
        n = len(next(iter(values.values()))) if values else 0
        self.counters.bump("rows_ingested", n)
        if self._cdc_captures(t.name) and n:
            self._emit_cdc(t.name, "insert",
                           rows=self._decode_rows(t, values, validity),
                           columns=t.schema.names)
        return n

    # ------------------------------------------------ change data capture
    def _cdc_captures(self, table: str) -> bool:
        """The table's changes are captured when CDC is globally on OR
        any publication covers it (reference: commands/publication.c)."""
        if self.cdc.enabled:
            return True
        for pub in self.catalog.publications.values():
            tl = pub.get("tables")
            if tl == "all" or (isinstance(tl, list) and table in tl):
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

    #: statement types allowed inside BEGIN..COMMIT (DDL stages in the
    #: in-memory catalog until COMMIT)
    _TXN_ALLOWED = (A.Select, A.Explain, A.Insert, A.Update, A.Delete,
                    A.CreateTable, A.DropTable, A.SetConfig, A.ShowConfig,
                    A.UtilityCall)

    def _guard_in_txn(self, stmt) -> None:
        if not isinstance(stmt, self._TXN_ALLOWED):
            raise UnsupportedFeatureError(
                f"{type(stmt).__name__} cannot run inside a transaction "
                "block")
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
                session=None) -> Result:
        """Run one SQL string on ``session`` (default: this thread's).
        Safe to call from several threads at once: the plan cache, the
        counters, the device cache, the kernel builds and the launch
        counters are locked, and each statement keeps its own scan
        state.  Concurrent literal variants of one query coalesce into
        one scan when ``citus.megabatch_window_ms`` is set
        (executor/megabatch.py).  Inside BEGIN..COMMIT a statement's
        writes stage under the transaction and its reads see them; an
        error aborts the block until ROLLBACK."""
        if params:
            _unported("parameterized execute()", "queue A")
        if session is None:
            session = self._default_session()
        result = Result(columns=[], rows=[])
        with _trace.span("parse"):
            stmts = parse_sql(sql)
        t0 = _trace.clock()
        key = sql if len(stmts) == 1 else None
        for stmt in stmts:
            if isinstance(stmt, A.TransactionStmt):
                result = self._execute_transaction_stmt(session, stmt)
                continue
            txn = session.txn
            if txn is None:
                result = self._execute_stmt(stmt, key)
                continue
            if txn.failed:
                from citus_tpu_torch.transaction.session import (
                    InFailedTransaction,
                )
                raise InFailedTransaction(
                    "current transaction is aborted, commands ignored "
                    "until end of transaction block")
            from citus_tpu_torch.storage.overlay import transaction_overlay
            try:
                self._guard_in_txn(stmt)
                with transaction_overlay(txn):
                    result = self._execute_stmt(stmt, key)
            except Exception:
                # PostgreSQL: any error aborts the transaction block
                # until ROLLBACK [TO SAVEPOINT]
                txn.failed = True
                raise
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
                              device=self.device)
