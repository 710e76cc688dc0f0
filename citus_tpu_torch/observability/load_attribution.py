"""Per-placement load attribution ledger.

Every observability surface so far answers "how much work" (counters)
or "which query" (stat statements, tenants) — nothing answers WHERE the
load lands.  The reference drives its rebalancer off observed placement
state (SURVEY §2.10's pluggable cost strategies); this ledger is that
missing dimension: device milliseconds, bytes scanned, rows returned
and query counts booked against ``(table, shard, placement node,
tenant)`` at the existing instrumentation seams —

  * executor device rounds (executor/executor.py ``task_times`` /
    per-batch transfer bytes),
  * pushed remote-task execution (executor/worker_tasks.py
    ``run_worker_task``, booked on the WORKER so the placement's own
    host carries its load),
  * remote-task waits (executor/pipeline.py collect, booked on the
    coordinator as ``remote_wait_ms``).

Ledger-balance invariant (counter-asserted in tests): summed over all
entries, ``bytes_scanned`` equals the StatCounters ``bytes_scanned``
delta and ``rows_returned``/``queries`` equal the ``rows_returned`` /
``queries_executed`` deltas — attribution never invents or loses work.

The flight recorder samples ``ring_metrics()`` into its ring/on-disk
log (``citus_stat_history('shard_load:...')``), ``citus_shard_load()``
fans the per-node ledgers in cluster-wide, and ``tick()`` maintains the
EWMA device-ms/s rates the ``by_observed_load`` rebalance strategy and
the autopilot consume.  ``tick()`` is explicitly driven (recorder
sample / autopilot duty) — reading rates never advances them, so a
rebalance plan is deterministic for a fixed attribution snapshot.
"""

from __future__ import annotations

import threading

from citus_tpu_torch.utils.clock import now as wall_now

#: placement-metric cardinality cap in the flight-recorder ring: only
#: the top-K placements by booked device ms are sampled as
#: ``shard_load:`` series (the ledger itself is unbounded by key space
#: but bounded by the catalog's placement count)
RING_TOP_K = 32

#: EWMA smoothing for the per-placement device-ms/s rate
EWMA_ALPHA = 0.3


def _key_str(table: str, shard_id: int, node: int) -> str:
    return f"{table}.{shard_id}@{node}"


class LoadAttribution:
    """Thread-safe in-memory ledger: cumulative load per
    (table, shard_id, node, tenant) plus EWMA'd per-placement rates."""

    FIELDS = ("queries", "device_ms", "bytes_scanned", "rows_returned",
              "remote_wait_ms")

    def __init__(self) -> None:
        self._mu = threading.Lock()
        # (table, shard_id, node, tenant) -> [queries, device_ms,
        #                                     bytes, rows, remote_wait_ms]
        self._e: dict[tuple, list] = {}
        # EWMA state per (table, shard_id, node):
        #   [ewma_ms_per_s, prev_total_device_ms]
        self._rate: dict[tuple, list] = {}
        self._last_tick = 0.0

    # ------------------------------------------------------------ booking

    def book(self, table: str, shard_id: int, node: int, tenant: str, *,
             queries: int = 0, device_ms: float = 0.0,
             bytes_scanned: int = 0, rows_returned: int = 0,
             remote_wait_ms: float = 0.0) -> None:
        key = (str(table), int(shard_id), int(node), str(tenant))
        with self._mu:
            e = self._e.get(key)
            if e is None:
                e = self._e[key] = [0, 0.0, 0, 0, 0.0]
            e[0] += int(queries)
            e[1] += float(device_ms)
            e[2] += int(bytes_scanned)
            e[3] += int(rows_returned)
            e[4] += float(remote_wait_ms)

    def book_query(self, table, tenant: str, task_times, task_bytes,
                   rows_returned: int, remote_tasks=(),
                   head_si: int | None = None) -> None:
        """Book one finished SELECT from its explain-payload pieces.

        ``table`` is the TableMeta scanned; ``task_times`` is the
        executor's [(shard_index, n_rows, seconds)] list and
        ``task_bytes`` the parallel [(shard_index, bytes)] transfer log;
        ``remote_tasks`` is the pipeline's [(shard_index, node,
        blob_bytes, rpc_s, decode_s)] push log.  The query count and
        result rows are booked once, against the first scanned
        placement (for a router query that IS the routed shard), so the
        ledger-wide sums stay equal to the whole-query counters."""
        shards = table.shards
        n_sh = len(shards)

        def _placement(si: int):
            if 0 <= si < n_sh:
                s = shards[si]
                return s.shard_id, s.placements[0]
            return -1, -1

        booked_head = False
        for si, _n_rows, secs in task_times:
            shard_id, node = _placement(int(si))
            self.book(table.name, shard_id, node, tenant,
                      queries=0 if booked_head else 1,
                      device_ms=secs * 1000.0,
                      rows_returned=0 if booked_head else rows_returned)
            booked_head = True
        for si, nbytes in task_bytes:
            shard_id, node = _placement(int(si))
            self.book(table.name, shard_id, node, tenant,
                      bytes_scanned=int(nbytes))
        for rt in remote_tasks:
            si, node, _blob, rpc_s = rt[0], rt[1], rt[2], rt[3]
            shard_id, _local = _placement(int(si))
            self.book(table.name, shard_id, int(node), tenant,
                      queries=0 if booked_head else 1,
                      remote_wait_ms=float(rpc_s) * 1000.0,
                      rows_returned=0 if booked_head else rows_returned)
            booked_head = True
        if not booked_head and n_sh:
            # zero-device-task result (projection path, device cache hit,
            # megabatch rider, fully-pruned scan): the query and its
            # result rows still book — against the routed shard when
            # known, else the table's first placement — so ledger-wide
            # query/row sums stay equal to the whole-query counters
            si = head_si if head_si is not None else 0
            shard_id, node = _placement(int(si))
            self.book(table.name, shard_id, node, tenant, queries=1,
                      rows_returned=rows_returned)

    # -------------------------------------------------------------- rates

    def tick(self, now: float | None = None) -> None:
        """Advance the EWMA device-ms/s rate per placement.  Driven
        explicitly (flight-recorder sample, autopilot duty) — never
        from a read path, so plans are stable between ticks."""
        if now is None:
            now = wall_now()
        with self._mu:
            dt = now - self._last_tick
            if dt <= 0:
                return
            first = self._last_tick == 0.0
            self._last_tick = now
            totals: dict[tuple, float] = {}
            for (table, shard_id, node, _tenant), e in self._e.items():
                k = (table, shard_id, node)
                totals[k] = totals.get(k, 0.0) + e[1]
            for k, total in totals.items():
                st = self._rate.get(k)
                if st is None:
                    st = self._rate[k] = [0.0, total]
                    continue
                if first:
                    st[1] = total  # unknown dt baseline: skip the burst
                    continue
                inst = max(0.0, total - st[1]) / dt
                st[0] = st[0] + EWMA_ALPHA * (inst - st[0])
                st[1] = total

    def load_scores(self) -> dict[tuple, float]:
        """(table, shard_id, node) -> observed-load score: the EWMA
        rate once ticks have run, else the cumulative device ms (the
        cold-start fallback so a plan is available before the sampler's
        second tick)."""
        with self._mu:
            out: dict[tuple, float] = {}
            for (table, shard_id, node, _tenant), e in self._e.items():
                k = (table, shard_id, node)
                out[k] = out.get(k, 0.0) + e[1]
            rated = {k: st[0] for k, st in self._rate.items() if st[0] > 0}
        if rated:
            return {k: rated.get(k, 0.0) for k in out}
        return out

    # -------------------------------------------------------------- views

    def rows_view(self) -> list[list]:
        """[table, shard_id, node, tenant, queries, device_ms, bytes,
        rows, remote_wait_ms, ewma_ms_per_s] rows, deterministic order
        (device_ms desc, then key)."""
        with self._mu:
            rates = {k: st[0] for k, st in self._rate.items()}
            rows = [[t, sid, n, ten, e[0], round(e[1], 3), e[2], e[3],
                     round(e[4], 3), round(rates.get((t, sid, n), 0.0), 3)]
                    for (t, sid, n, ten), e in self._e.items()]
        rows.sort(key=lambda r: (-r[5], r[0], r[1], r[2], str(r[3])))
        return rows

    def totals(self) -> dict:
        """Ledger-wide sums per field — the balance-invariant surface
        the attribution tests assert against the whole-query
        counters."""
        with self._mu:
            out = dict.fromkeys(self.FIELDS, 0)
            for e in self._e.values():
                for i, f in enumerate(self.FIELDS):
                    out[f] = out[f] + e[i]
            return out

    def ring_metrics(self) -> dict:
        """Flat {``shard_load:<table>.<shard>@<node>``: cumulative
        device ms} for the flight recorder's sample dict — top
        RING_TOP_K placements by booked device ms, so history rates
        (``citus_stat_history('shard_load:...')``) stay bounded."""
        with self._mu:
            per: dict[tuple, float] = {}
            for (table, shard_id, node, _tenant), e in self._e.items():
                k = (table, shard_id, node)
                per[k] = per.get(k, 0.0) + e[1]
        top = sorted(per.items(), key=lambda kv: (-kv[1], kv[0]))[:RING_TOP_K]
        return {f"shard_load:{_key_str(*k)}": round(v, 3) for k, v in top}

    def reset(self) -> None:
        """Counters-reset hook (StatCounters.add_reset_hook): the
        ledger re-zeros with the whole-query counters so the balance
        invariant survives citus_stat_counters_reset()."""
        with self._mu:
            self._e.clear()
            self._rate.clear()
            self._last_tick = 0.0


GLOBAL_ATTRIBUTION = LoadAttribution()
