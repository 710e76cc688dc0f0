"""Surgical plan-cache invalidation (reference: plancache.c +
CitusTableCacheEntry invalidation via relcache callbacks).

The previous cache was a plain ``{sql_text: (bound, plan, version,
epoch, backend)}`` dict whose entries all died on ANY catalog change
(~10 wholesale ``.clear()`` sites): DDL on table A evicted table B's
plans and every kernel warm-up with them.  This module scopes
invalidation to what actually changed:

- **table identity + version**: an entry pins the exact ``TableMeta``
  object it bound against; ingest/DDL that flips the table (version
  bump or object replacement) kills only that table's entries — the
  ingest-flip window is covered because validation happens on every
  lookup, not at mutation time.
- **DDL epoch + object-state token**: ``ddl_epoch`` is bumped by ~30
  catalog mutations, most of them irrelevant to a given SELECT.  On an
  epoch mismatch the entry is re-validated against a digest of every
  catalog namespace a plan could depend on beyond its table — views,
  roles AND grants (REVOKE must force a re-bind so privilege checks
  re-run), functions, enum types, row policies/RLS, triggers,
  text-search configs.  Token equal -> the epoch churn was elsewhere
  (another table's DDL, a sequence bump) and the entry is re-armed.
- **LRU bound** so ad-hoc text keys can't grow without limit.

``invalidate_table(name)`` is the targeted kill used by DML/DDL
handlers that know their table; ``clear()`` stays available as
``invalidate_all`` for multi-table transaction ends and foreign catalog
pushes.  Counters: plan_cache_invalidations / plan_cache_evictions
(hits/misses are bumped by the callers that know whether a statement
was cacheable at all).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional

#: ad-hoc SQL texts are unbounded; cap the entry count (each entry is a
#: bound tree + physical plan, small next to the kernels they point at)
DEFAULT_CAPACITY = 1024

#: catalog namespaces beyond the entry's own table that can change plan
#: output or its authorization; sequences are deliberately absent
#: (nextval bumps them constantly and no SELECT plan reads them)
_TOKEN_SECTIONS = ("schemas", "views", "roles", "grants", "functions",
                   "types", "enum_columns", "policies", "rls", "triggers",
                   "ts_configs")


def _counters():
    from citus_tpu_torch.executor.executor import GLOBAL_COUNTERS
    return GLOBAL_COUNTERS


def object_state_token(catalog) -> int:
    """Order-insensitive digest of the non-table catalog namespaces; two
    equal tokens mean no mutation in any section between them.  Table
    *topology* (which tables exist, partition parentage) rides along —
    attaching a partition must kill cached parent-query plans whose
    partition fan-out was baked in at bind time — but per-table state
    (version, indexes) does not: that is covered entry-locally, so
    ingest into table B cannot disturb table A's entries."""
    topology = sorted(
        (name, t.partition_of["parent"] if t.partition_of else None)
        for name, t in catalog.tables.items())
    return hash((repr(topology),)
                + tuple(repr(sorted(getattr(catalog, s, {}).items(),
                                    key=lambda kv: repr(kv[0])))
                        for s in _TOKEN_SECTIONS))


@dataclass
class PlanEntry:
    bound: object
    plan: object
    version: int
    epoch: int
    backend: str
    table_name: str
    obj_token: int
    #: auto-parameterized literal values (planner/auto_param.py); None
    #: for explicitly-parameterized or literal-free plans
    values: Optional[list] = None

    def __getitem__(self, i):
        # legacy tuple shape (bound, plan, version, epoch, backend) —
        # tests and tooling index entries positionally
        return (self.bound, self.plan, self.version, self.epoch,
                self.backend)[i]


class PlanCache:
    """LRU of PlanEntry with per-lookup validation.  Dict-compatible on
    the read side (get/[]/in/len) so existing introspection keeps
    working; mutation goes through put/invalidate_*."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._mu = threading.RLock()
        self._e: OrderedDict = OrderedDict()
        self.capacity = capacity

    def lookup(self, key, catalog, backend: str) -> Optional[PlanEntry]:
        with self._mu:
            e = self._e.get(key)
            if e is None:
                return None
            if e.backend != backend:
                return None  # stale backend: overwritten by the next put
            if (catalog.tables.get(e.table_name) is not e.bound.table
                    or e.bound.table.version != e.version):
                del self._e[key]
                _counters().bump("plan_cache_invalidations")
                return None
            if e.epoch != catalog.ddl_epoch:
                tok = object_state_token(catalog)
                if tok != e.obj_token:
                    del self._e[key]
                    _counters().bump("plan_cache_invalidations")
                    return None
                e.epoch = catalog.ddl_epoch  # churn was elsewhere: re-arm
            self._e.move_to_end(key)
            return e

    def put(self, key, bound, plan, catalog, backend: str,
            values: Optional[list] = None) -> PlanEntry:
        e = PlanEntry(bound, plan, bound.table.version, catalog.ddl_epoch,
                      backend, bound.table.name,
                      object_state_token(catalog), values)
        with self._mu:
            self._e[key] = e
            self._e.move_to_end(key)
            while len(self._e) > max(1, self.capacity):
                self._e.popitem(last=False)
                _counters().bump("plan_cache_evictions")
        return e

    def invalidate_table(self, name: str) -> None:
        with self._mu:
            dead = [k for k, e in self._e.items() if e.table_name == name]
            for k in dead:
                del self._e[k]
        if dead:
            _counters().bump("plan_cache_invalidations", len(dead))

    def invalidate_all(self) -> None:
        with self._mu:
            n = len(self._e)
            self._e.clear()
        if n:
            _counters().bump("plan_cache_invalidations", n)

    def clear(self) -> None:
        # legacy spelling at multi-table sites (transaction rollback,
        # foreign catalog push): everything really is suspect there
        self.invalidate_all()

    # ---- dict-compatible read side ----

    def get(self, key, default=None):
        with self._mu:
            return self._e.get(key, default)

    def __getitem__(self, key):
        with self._mu:
            return self._e[key]

    def __contains__(self, key) -> bool:
        with self._mu:
            return key in self._e

    def __len__(self) -> int:
        with self._mu:
            return len(self._e)
