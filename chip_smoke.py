"""Chip smoke test of citus_tpu_torch on one NVIDIA card.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py [--rows N]

Phases, each on its own lines; any failure exits non-zero and prints no
result line:

1. the card (``nvidia-smi`` name and power limit) and the torch, CUDA
   and nvcc versions;
2. build of every CUDA kernel of the port from ``citus_tpu_torch/csrc``
   (``rollup_delta``, ``hash_agg_merge``, ``partition_pack``,
   ``sorted_join``, ``mesh_combine`` and ``mesh_exchange``), of the
   predicate kernels generated for Q6, P1, the
   predicate over every C1 node, C1's five WHEREs and the phase-5 and
   phase-8 families, and of the fold and insert kernels generated for
   each plan phases 3-7 run (``ops/expr_codegen.py generate_fold_row``:
   the plan's WHERE, keys and arguments instantiating the serial and
   batched fold of ``csrc/fold.cuh`` with its sketch registers, or the
   serial and batched insert of ``csrc/hash_probe.cuh``); one nvcc per
   source, all started together; then one more generated predicate
   alone and Q1's generated fold alone, for their cold build times;
3. each kernel against its plain PyTorch version on the card, at the
   main path's shapes (a generated kernel's plain version evaluates the
   plan's expressions as eager tensor code):
   - ``scan_agg_fold`` for TPC-H Q6 (scalar mode) and Q1 (direct mode,
     G = 12, the shared-memory regime) on 2^21 generated lineitem rows
     (the padded batch of one SF1 shard of four, parameters in the
     launch's block), a direct G = 65,536 fold (the global-atomics
     regime) with nulls, NaN, +-inf, +-0.0, an all-false mask and N not
     a multiple of the block, and signed float64 sums near cancellation
     (G = 4,097), each held to 1e-12 times its group's sum of
     magnitudes, which the plain version sums in the same pass;
   - ``hash_agg_insert`` for bench.py's ``GROUP BY l_orderkey`` (count
     and an int64 sum) on the first padded shard batch of the loaded
     lineitem into 2^20 slots (what citus.hash_agg_slots = auto gives at
     SF1), the same rows with l_orderkey in runs of 1-7 rows as dbgen
     writes lineitem (the warp-aggregated path), and an adversarial
     insert: three keys (int64; float64 with
     -0.0, NaN payloads and nulls; int32) on 1,000 slots, so most rows
     spill, a float64 sum/min/max, an all-false mask, N not a multiple
     of the block.  The merged groups (table and spilled rows through
     HostGroupAccumulator) must agree, and each key must sit in at most
     one slot with placed + spilled rows = masked rows;
   - ``filter_mask``, the predicate kernels generated from Q6's and P1's
     WHERE, from a synthetic predicate with nulls, NaN, zero divisors
     and three-valued AND/OR, and from one predicate over every node
     kind of ROADMAP.md C1's repair (EXTRACT, CASE and abs, upper,
     length, date_trunc by week and by month, + interval '1 month', and
     sqrt, ln, power, round, floor, greatest, sign, exp) on 2^21
     generated events rows with nulls, then each over views that start
     3 elements into their buffers (no base 16-byte aligned), with no
     row mask: identical masks;
   - the batched kernels of the megabatch path at Q = 8 on one padded
     2^21-row batch: ``filter_mask_batched`` for the predicate of each
     phase-5 family, of phase 8's C1 family and of a family over the
     predicate over every C1 node under its 8 parameter sets, Q6's at
     Q = 32, and Q6's over views 3 elements into their buffers with no
     row mask (identical [Q, N] masks),
     ``scan_agg_fold_batched`` for the Q6 (scalar) and Q1 (direct)
     families (and Q1 at Q = 32, whose shared-memory table passes the
     48 KB default, and a G = 65,536 fold of 3 queries in the
     global-atomics regime), ``hash_agg_insert_batched`` for the H
     family on the first
     SF1 shard batch into 8 tables of 2^20 slots and of 1,000 slots
     (most rows spill): per query the merged groups agree, each key sits
     in at most one slot, placed + spilled = masked rows.
   - the sketch registers (approx_count_distinct, approx_percentile,
     approx_top_k) of ``scan_agg_fold`` for S1's ops on one padded
     2^21-row batch of the generated sketch table, and an adversarial
     case (NaN, +-inf, +-0.0, 1e-300, a subnormal, every DDSketch bucket
     edge and its neighbours, INT64_MIN/MAX, nulls, an all-false mask,
     N not a multiple of the block); of ``scan_agg_fold_batched`` for
     the S family at Q = 8 (the shared-memory table in two query chunks
     of 4: ~264 KB of registers pass the opt-in limit) and Q = 6 (one
     table), against eight serial S1 folds;
   - ``rollup_delta`` for all six kinds at n = 65,536 (one refresh
     batch, the direct regime) and n = 2^23 (SF1's backfill, padded;
     count and the sums in the privatized regime, checked, and also
     held and timed in the other regimes) into 10,000 groups, timed as
     the wrapper's call (its table allocated and filled; event time and
     device time from torch.profiler) and as its kernel alone into a
     table allocated beforehand;
   - ``partition_pack`` (B7) on both sides of QJOIN's device join at
     SF1 (gid, l_orderkey, l_quantity with their validity; the flagged
     orders_b rows), n_dev = 1, on the lineitem side to 8 destinations
     with a capacity that overflows, on one member's rows of phase 9's
     mesh to 4 destinations, and on the lineitem side to 1,023 (the
     most one launch takes): blocks, validity and overflow identical;
   - ``sorted_join`` (B8) on QJOIN's join at SF1 (join_cap = its
     pairs, as the device join sizes it), a
     many-to-many join, an all-invalid side, invalid rows on both
     sides and one gid holding 60 % of the left rows: l_idx, r_idx,
     out_valid, total and every gathered column identical;
   - ``mesh_combine`` (B6) over 4 members on the card, each member's
     registers folded by the generated fold from its share of the rows:
     Q1's (12 groups x 17 positions), S1's (sketch registers) and a
     G = 65,536 direct fold's with NaN, +-inf and +-0.0, one member
     folding no row, from one allocation a member (the executor's call)
     and from separate tensors: every output identical bit for bit
     (sums in member order in both), event and device times;
   - ``exchange_blocks`` over 4 members: QJOIN's lineitem side at SF1
     split and packed as the device join does it: identical receive
     buffers, one launch, and its kernel timed alone from a prebuilt
     parameter block beside the wrapper call.
   int64 registers, keys, counts, min/max and NaN positions must be
   identical, float64 sums within rel 1e-12 (atomics add in another
   order; the sums near cancellation as above).  Each kernel is timed
   (CUDA events, median) beside its bound (the bytes it must move on
   this run's data: the mask; of each column the WHERE reads, and its
   validity, the 32-byte sectors holding a row whose WHERE it
   evaluates; of each other column the sectors holding a row whose keys
   and arguments it evaluates (one that passes, or that some query's
   mask passes); the registers or the table's filled slots), its plain
   version and a one-op library yardstick (B6: one torch.stack and
   sum / amin / amax a position; the exchange: torch.stack, transpose
   and contiguous a column);
4. the main path through the port's entry points: ``Cluster(tmpdir)``
   on CUDA, bench.py's lineitem (schema, generator, seed 7) at TPC-H SF1
   (6,001,215 rows) in 4 shards, each query cold and then a second
   time: bench.py's Q6 (the second run served from the device cache);
   with ``SET citus.hash_agg_slots = auto`` as bench.py sets it, H1
   (TPC-H Q18's inner aggregate: ~1.47 M groups, more than the 2^20
   slots, so rows spill and merge on the host) and H2 (Q3's per-order
   revenue over one ship year, without its joins); and P1, a drill-down
   projection.  At SF1, bench.py's Q1 trips the engine's int64 overflow
   guard on sum_charge (a decimal(38,8) sum whose float64 shadow passes
   2^62; citus_tpu refuses it the same way): the script checks that the
   guard fires exactly where the oracle says it must, then runs Q1 cold
   and warm on 5,000,000 rows, the largest round scale the guard admits.
   Rows must equal those computed straight from the generated numpy
   arrays (exact int64 cents grouped with np.unique), each query's
   kernel must launch once per batch and no other kernel may launch;
   a warm Q1, Q6, S1, H1 and H2 runs once more under torch.profiler
   (CUDA activity, the session idling 20 ms at each end; a run whose
   record lost kernels the wrappers launched is run again, up to 10
   times, idling 2 s at each end), which must see one kernel of the
   port per batch and no other kernel (no PyTorch elementwise kernel);
   each run prints the nvcc builds it waited for;
5. literal families through ``Cluster.execute``: 8 variants of one
   query, first one after another (``citus.megabatch_window_ms = 0``,
   cold then warm), then from 8 threads at once with
   ``citus.megabatch_window_ms = 1000`` and ``megabatch_max_size = 8``
   (cold then warm): Q6 with 8 of TPC-H's substitution parameter sets,
   H2's shape over one 1995 ship month each and P1 over one ship day
   each at SF1, Q1 with DELTA 60-120 at 5,000,000 rows.  Every query's
   rows must equal the numpy oracle, the coalesced queries must ride
   batches of occupancy above 1, each of the family's batched kernels
   must launch once per shard batch per group and no other kernel.
   Wall time and queries per second of the serial and coalesced runs.
   Then, on a second SF1 table of TPC-H's sketch columns (l_orderkey,
   l_partkey, l_suppkey, l_quantity, l_extendedprice, l_shipdate; 10,000
   suppliers; distributed by l_suppkey, as a rollup by supplier needs):
   phase 4's S1 (count, approx_count_distinct, approx_percentile and
   approx_top_k over one ship year) cold and warm, one sketch fold per
   shard batch and no other kernel, rows equal to a numpy oracle built
   with the port's numpy bucket functions; phase 5's S family (S1 over
   each ship year 1992-1998 and 1995-H2), serial and coalesced;
6. rollups with change data capture on: ``citus_create_rollup`` by
   l_suppkey of count(*), sum(l_quantity), approx_count_distinct
   (l_partkey), approx_percentile(l_extendedprice) and approx_top_k
   (l_partkey) (its backfill timed), 131,072 more generated rows by COPY
   in 2 batches, ``citus_refresh_rollups()`` to the CDC head: the stored
   counts, sums and sketch registers must equal numpy's over every
   generated row, the routed dashboard query must return the oracle's
   rows, and ``rollup_delta`` must launch once per aggregate per fold;
7. two coordinators on the card, in one process: A is the metadata
   authority and serves its placements, B attaches to A and serves its
   own; each hosts one node.  The sketch table of phase 4 is loaded
   through A (4 shards by l_suppkey over the two nodes: the rows of B's
   shards ship to B as CTFR batches).  R1 (TPC-H Q17's per-part
   quantity aggregate, GROUP BY l_partkey, 200,000 groups), S1 and R3 (a
   filtered projection) run cold and warm, first pushed
   (``citus.remote_task_execution = auto``: B runs the worker half of
   each query on its shards through the port's kernels and ships back
   partial states, its hash table, or rows) and then pulled (A mirrors
   B's placement files and scans them itself).  Rows must equal the
   numpy oracle; pushed, each query sends one task per remote shard
   with no fallback, and R1 merges each returned table through one
   ``hash_agg_merge`` launch.  Then 262,144 more rows by COPY through A,
   and R1 and R3 warm again, pushed and pulled, against the new oracle.
   Wall time of each run, bytes shipped and the data plane's totals;
8. joins and C1 on the SF1 lineitem of phase 4 (run right after phase
   5's SF1 families): bench.py's orders_b (schema, generator, seed 11,
   SF1 // 4 rows, 4 shards by o_custkey); bench.py's QJOIN cold and warm
   through the device join (EXPLAIN join:repartition with devjoin,
   ``partition_pack`` twice and ``sorted_join`` once per run), its LEFT
   JOIN through the bucket path (``partition_pack`` twice), rows equal to
   an oracle from the generated arrays, with the wall time, rows/s
   ((lineitem + orders_b rows) / s) and the device join step's host
   group-id time, copies and time on the card; then an events table of
   SF1's row count (tests/test_torch_slice.py's schema and
   distributions, vectorized, plus a timestamp) and C1's five WHEREs as
   projections (one ``filter_mask`` launch per batch, rows equal to
   numpy's), a literal family over C1's nodes coalesced (one
   ``filter_mask_batched`` launch per shard batch), and the five pushed
   between two coordinators over 262,144 events rows;
9. the mesh: a second ``Cluster`` over the same tables whose mesh has 4
   members on the card (``mesh_devices=[card] * 4``, the device cache
   emptied first), run right after phases 8, 5 (Q1) and 4 (S1) on their
   tables: Q6 at SF1, Q1 at 5,000,000 rows and S1 on the sketch table,
   each cold and warm (the warm run replays the mesh's cache entry),
   rows equal to the numpy oracle, one fold per member per round and
   one ``mesh_combine`` per query and no other kernel, one
   device-to-host copy per warm query (torch.profiler), its warm time
   beside phase 4's on the single stream; one warm QJOIN at
   SF1 through the device join over the 4 members (``partition_pack``
   8 times, ``exchange_blocks`` twice (one launch an exchange on the
   one card),
   ``sorted_join`` 4, ``mesh_combine`` once for the overflow);
10. the rest of SELECT on phase 4's SF1 lineitem (run right after phase
   8; its ``l_suppkey``, 10,000 suppliers, from a random stream of its
   own): TPC-H Q15 in its two-CTE form (no supplier table, so no
   supplier join), an IN-subquery drill-down (its key count printed), a
   window over an aggregate, Q1's ROLLUP, INTERSECT and EXCEPT of two
   months' suppliers, DISTINCT ON, a derived table and a recursive CTE
   of 100 steps, each cold and 3 times warm, its rows equal to the
   port's numpy ``cpu`` backend's on the same tables (Q15's also to
   numpy's), no nvcc build in the warm runs, no kernel but the port's
   in one more warm run (torch.profiler); the allocated device memory
   before and after 20 more warm runs of Q15 must not grow; then Q6
   with ``$1..$5`` under phase 5's 8 value sets through ``execute(sql,
   params)`` and through PREPARE / EXECUTE / DEALLOCATE: rows equal to
   the literal Q6's and the oracle's, 1 plan-cache miss and 15 hits, no
   nvcc build after the first execution;
11. A11's local write surface on phase 4's SF1 lineitem (run right
   after phase 10): (a) ``lineitem_m``, partitioned by month of
   l_shipdate over 1992-1998 by ``create_time_partitions`` (84
   partitions, each distributed by l_orderkey, siblings colocated), one
   ``copy_from`` of every row routed to them, each partition's row count
   against numpy's; (b) Q6 of June 1994 (one survivor), Q6 as written
   (12 survivors, a UNION ALL of pruned arms), P1 over the parent, and
   the EXPLAIN of Q6 (``partitions: 12/84``); (c) INSERT ... SELECT of
   June 1994 from the lineitem into a colocated copy (``colocated``) and
   into a table distributed by l_suppkey (``repartition``), the daily
   rollup (``pull``) and its ``ON CONFLICT DO UPDATE SET n = n +
   excluded.n`` (``upsert_pull``, every n twice numpy's count), CREATE
   TABLE AS of H1 over the month, UPDATE and DELETE ... RETURNING of
   one day; (d) a PRIMARY KEY reference table of the distinct order keys
   and a COPY of June 1994 into a fresh table whose l_orderkey
   references it (ROADMAP.md C12), a batch with one missing key refused
   and the table unchanged, a DELETE of a referenced row refused; (e)
   ``drop_old_time_partitions`` before 1993, the parent's count, DROP
   of the parent.  Each statement cold and 3 times warm, its rows equal
   to numpy's and the ``cpu`` backend's, no nvcc build in a warm run
   (the FK-checked COPYs included), no kernel but the port's in one more
   warm run (torch.profiler); the B1, B2 and B4 launches of the phase.
   Its generated kernels build during its own load, from a CPU
   rehearsal that runs, with phase 10's, in a process of its own from
   the start of phase 2;
12. the rest of A11 on phase 8's orders_b arrays (1,500,303 rows; run
   right after phase 11): (a) ``orders_m`` (o_orderkey PRIMARY KEY,
   4 shards) loaded by ``COPY orders_m FROM '<file>' WITH (delimiter
   '|')`` from a file numpy writes in dbgen's layout, ``COPY orders_m
   TO`` CSV (its lines as a multiset equal to numpy's), a binary
   export loaded into ``orders_m2``, ``COPY (SELECT o_flag, count(*)
   ...) TO``; (d) CREATE STATISTICS on (o_custkey, o_flag), its
   ndistinct numpy's; (b) a colocated staging table of TPC-H RF1's
   1,500 new orders and 15,000 updated ones, MERGE ... WHEN MATCHED
   UPDATE ... WHEN NOT MATCHED INSERT cold and warm (the same rows
   after each; ``updated`` 15,000 and ``inserted`` 1,500, then 16,500
   and 0; no kernel launched), RF2's MERGE ... DELETE of 1,500
   orders, a source with a duplicate key refused and the table
   unchanged; ANALYZE (``statistics_refreshed`` 1, numpy's
   ndistinct); (c) ADD COLUMN, ADD CONSTRAINT CHECK (o_custkey >= 0)
   validated by a count through B1, CHECK (o_custkey > 0) refused with
   numpy's count of violating rows, RENAME COLUMN, DROP COLUMN, RENAME
   TO, ``alter_distributed_table('orders_m', 8)``,
   ``undistribute_table('orders_m2')``; (d) CREATE INDEX on o_custkey,
   an index lookup, REINDEX TABLE after its segment files are deleted
   (``segments_rebuilt`` the ``cpu`` backend's).  After each write the
   Q checks (the count, sum(o_custkey) and sum(o_orderkey), the o_flag
   counts) run on the card against numpy and the ``cpu`` backend; each read cold and
   3 times warm (the exports, ANALYZE and REINDEX cold only, CREATE
   STATISTICS and the MERGE once warm: the time limit), no
   nvcc build in a warm run, no kernel but the port's in one more warm
   run of the reads (torch.profiler); the B1, B2 and B4 launches of the
   phase.  Its generated kernels build during its COPY FROM, from a CPU
   rehearsal in the process of phases 10 and 11;
13. A14a's catalog objects (run right after phase 12, on phase 4's SF1
   lineitem and phase 8's orders_b arrays, both checked to be there):
   (b) ``CREATE TYPE prio AS ENUM ('L', 'M', 'H')``, ``CREATE DOMAIN
   custkey_t AS bigint CHECK (VALUE >= 0)`` and ``orders_e`` (4 shards)
   loaded by ``copy_from`` from the arrays (1,500,303 orders, both
   checks; rows/s, and the domain CHECK alone, on the host once per
   distinct custkey); (a) TPC-H Q15 as written: ``CREATE FUNCTION
   disc_price`` inlined into ``CREATE VIEW revenue0``'s aggregate, the
   view read by the outer FROM and by the scalar subquery (each
   materialized), its rows equal to phase 10's CTE Q15 on the card,
   numpy's and the ``cpu`` backend's, the inlined fold's generated
   source compared with the written-out expression's; then ``CREATE OR
   REPLACE FUNCTION`` with another body (a new source; rows equal
   numpy's for it), and golden ``objects``'s ``amount * 1.5`` over
   l_extendedprice (decimals equal numpy's, printed as the ``cpu``
   backend's); (b) the enum GROUP BY (rows in declaration order L,
   M, H) and ``o_flag >= 'M'`` cold and warm against numpy and the
   ``cpu`` backend, an INSERT of label 'X' and one of custkey -1
   refused with the table unchanged, an UPDATE of o_custkey kept and
   one violating the domain refused, an INSERT then the warm query with
   no nvcc build, and an INSERT that grows an enum column's dictionary
   (its rank table is a launch argument) with no nvcc build; (c)
   EXPLAIN of an UPDATE, of QJOIN (no kernel launched) and of the enum
   GROUP BY, EXPLAIN ANALYZE of Q6 and of the enum GROUP BY twice (Rows
   the query's, Elapsed within the statement's wall time, the second
   run a plan-cache hit with no nvcc build), and EXPLAIN ANALYZE's
   device figures of Q6 beside torch.profiler's device time of the
   same run, and any other kernel it saw (recorded, not gated); the B1,
   B2 and B4 launches of the phase and its time against its 40 s.  Its
   generated kernels build while phase 12 runs, from a CPU rehearsal in
   the process of phases 10-12 (``phase13_sources``).

Then a JSON line of the kernels, the card line, and as the last line
``{"ok": true, "device": {...}}``.  The script imports nothing of JAX
and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import datetime
import decimal
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

SF1_ROWS = 6_001_215
#: Q1's rows at SF1 trip the engine's int64 overflow guard (see
#: q1_guard_fires); below it Q1 answers, so its rows run at this scale
Q1_ROWS = 5_000_000
SHARDS = 4
FOLD_N = 1 << 21

# bench.py's Q1 and Q6, verbatim (tests/test_torch_slice.py holds them
# equal to bench.py's)
Q1 = """SELECT l_returnflag, l_linestatus,
  sum(l_quantity) AS sum_qty,
  sum(l_extendedprice) AS sum_base_price,
  sum(l_extendedprice * (1 - l_discount)) AS sum_disc_price,
  sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) AS sum_charge,
  avg(l_quantity) AS avg_qty, avg(l_extendedprice) AS avg_price,
  avg(l_discount) AS avg_disc, count(*) AS count_order
FROM lineitem WHERE l_shipdate <= date '1998-12-01' - interval '90' day
GROUP BY l_returnflag, l_linestatus
ORDER BY l_returnflag, l_linestatus"""

Q6 = """SELECT sum(l_extendedprice * l_discount) AS revenue
FROM lineitem
WHERE l_shipdate >= date '1994-01-01'
  AND l_shipdate < date '1995-01-01'
  AND l_discount BETWEEN 0.05 AND 0.07 AND l_quantity < 24"""

# TPC-H Q18's inner aggregate (H1), Q3's per-order revenue over one ship
# year without its joins (H2), and a drill-down projection (P1)
H1 = """SELECT l_orderkey, sum(l_quantity) FROM lineitem
GROUP BY l_orderkey HAVING sum(l_quantity) > 300 ORDER BY l_orderkey"""

H2 = """SELECT l_orderkey, sum(l_extendedprice * (1 - l_discount)) AS revenue
FROM lineitem
WHERE l_shipdate >= date '1994-01-01' AND l_shipdate < date '1995-01-01'
GROUP BY l_orderkey ORDER BY revenue DESC, l_orderkey LIMIT 10"""

P1 = """SELECT l_orderkey, l_quantity, l_extendedprice FROM lineitem
WHERE l_shipdate = date '1994-06-01' AND l_discount >= 0.09
ORDER BY l_orderkey, l_quantity, l_extendedprice"""

# phase 5: Q_BATCH literal variants of one query, the way dashboard and
# multi-tenant sessions send them: TPC-H Q6's substitution parameters
# (DATE = Jan 1 of 1993-1997, DISCOUNT 0.02-0.09, QUANTITY 24-25), Q1's
# DELTA, H2's shape over one ship month of 1995 each, P1 over one ship
# day each
Q_BATCH = 8
Q1_DELTAS = (60, 69, 78, 87, 96, 105, 114, 120)


def q6_variant(year: int, disc: int, qty: int) -> str:
    """Q6 with DATE = Jan 1 of ``year``, DISCOUNT ``disc`` cents."""
    return ("SELECT sum(l_extendedprice * l_discount) AS revenue\n"
            "FROM lineitem\n"
            f"WHERE l_shipdate >= date '{year}-01-01'\n"
            f"  AND l_shipdate < date '{year + 1}-01-01'\n"
            f"  AND l_discount BETWEEN 0.{disc - 1:02d} AND 0.{disc + 1:02d}"
            f" AND l_quantity < {qty}")


def q1_variant(delta: int) -> str:
    return Q1.replace("interval '90' day", f"interval '{delta}' day")


def h_variant(month: int) -> str:
    return ("SELECT l_orderkey, sum(l_extendedprice * (1 - l_discount)) "
            "AS revenue\nFROM lineitem\n"
            f"WHERE l_shipdate >= date '1995-{month:02d}-01' AND l_shipdate "
            f"< date '1995-{month:02d}-01' + interval '1' month\n"
            "GROUP BY l_orderkey ORDER BY revenue DESC, l_orderkey LIMIT 10")


def p_variant(day: int) -> str:
    return P1.replace("1994-06-01", f"1994-06-{day:02d}")


def families() -> dict:
    """name -> (kind, [(sql, oracle(cols) -> rows)]) of phase 5."""
    def q6(i):
        year, disc, qty = 1993 + i % 5, 2 + i, 24 + i % 2
        return (q6_variant(year, disc, qty),
                lambda c: oracle_q6(c, year, disc, qty))

    def q1(i):
        delta = Q1_DELTAS[i]
        return q1_variant(delta), lambda c: oracle_q1(c, delta)

    def h(i):
        m = i + 1
        lo = _day(1995, m, 1)
        hi = _day(1995 + m // 12, m % 12 + 1, 1)
        return h_variant(m), lambda c: oracle_h2(c, lo, hi)

    def p(i):
        return p_variant(i + 1), lambda c: oracle_p1(c, i + 1)
    return {name: (kind, [make(i) for i in range(Q_BATCH)])
            for name, kind, make in (("Q6", "scalar", q6),
                                     ("H", "hash_host", h),
                                     ("P", "projection", p),
                                     ("Q1", "direct", q1))}


# phase 10: the rest of SELECT over phase 4's lineitem.  TPC-H Q15 in
# its two-CTE form (the supplier join dropped: there is no supplier
# table), an IN-subquery drill-down, a window over an aggregate, Q1's
# ROLLUP, INTERSECT and EXCEPT, DISTINCT ON, a derived table, a
# recursive CTE of 100 steps, and Q6 with $1..$5
Q15 = """WITH revenue AS (
  SELECT l_suppkey AS supplier_no,
    sum(l_extendedprice * (1 - l_discount)) AS total_revenue
  FROM lineitem
  WHERE l_shipdate >= date '1996-01-01' AND l_shipdate < date '1996-04-01'
  GROUP BY l_suppkey),
mx AS (SELECT max(total_revenue) AS max_revenue FROM revenue)
SELECT supplier_no, total_revenue FROM revenue JOIN mx
  ON total_revenue = max_revenue ORDER BY supplier_no"""


def _between_days(lo, hi) -> str:
    return (f"l_shipdate >= date '{'%d-%02d-%02d' % lo}' "
            f"AND l_shipdate < date '{'%d-%02d-%02d' % hi}'")


#: the month and the threshold of phase 10's IN-subquery: at SF1 the
#: subquery keeps the suppliers with more than this quantity shipped
#: in June 1995, a few hundred at most (ROADMAP.md C11: a few hundred
#: more and the IN list's OR chain overflows the binder's recursion)
IN_MONTH = ((1995, 6, 1), (1995, 7, 1))
IN_THRESHOLD = 400


def in_subquery(threshold: int = IN_THRESHOLD) -> str:
    """The IN-subquery of ``in_drilldown`` alone (its keys are counted)."""
    return (f"SELECT l_suppkey FROM lineitem WHERE {_between_days(*IN_MONTH)}"
            f" GROUP BY l_suppkey HAVING sum(l_quantity) > {threshold}")


def in_drilldown(threshold: int = IN_THRESHOLD) -> str:
    return ("SELECT l_returnflag, count(*), sum(l_extendedprice) "
            f"FROM lineitem\nWHERE l_suppkey IN ({in_subquery(threshold)})\n"
            "GROUP BY l_returnflag ORDER BY l_returnflag")


WINDOW_RANK = """SELECT l_suppkey, sum(l_extendedprice) AS revenue,
  rank() OVER (ORDER BY sum(l_extendedprice) DESC) AS rnk
FROM lineitem GROUP BY l_suppkey ORDER BY rnk, l_suppkey LIMIT 10"""

Q1_ROLLUP = """SELECT l_returnflag, l_linestatus,
  sum(l_quantity) AS sum_qty, sum(l_extendedprice) AS sum_base_price,
  count(*) AS count_order
FROM lineitem WHERE l_shipdate <= date '1998-12-01' - interval '90' day
GROUP BY ROLLUP (l_returnflag, l_linestatus)
ORDER BY l_returnflag NULLS LAST, l_linestatus NULLS LAST"""

FIRST_MONTH = ((1992, 1, 1), (1992, 2, 1))
LAST_MONTH = ((1998, 11, 1), (1998, 12, 1))


def month_setop(op: str) -> str:
    return (f"SELECT l_suppkey FROM lineitem WHERE "
            f"{_between_days(*FIRST_MONTH)}\n{op}\n"
            f"SELECT l_suppkey FROM lineitem WHERE "
            f"{_between_days(*LAST_MONTH)}\nORDER BY l_suppkey")


DISTINCT_ON = ("SELECT DISTINCT ON (l_returnflag) l_returnflag, "
               "l_extendedprice, l_orderkey FROM lineitem\nWHERE "
               f"{_between_days(*LAST_MONTH)}\n"
               "ORDER BY l_returnflag, l_extendedprice DESC, l_orderkey")

DERIVED = """SELECT count(*), max(total) FROM (
  SELECT l_suppkey, sum(l_quantity) AS total FROM lineitem
  GROUP BY l_suppkey) t"""

RECURSIVE_STEPS = 100
RECURSIVE = (f"WITH RECURSIVE s(n) AS (SELECT 1 UNION ALL SELECT n + 1 "
             f"FROM s WHERE n < {RECURSIVE_STEPS}) "
             "SELECT count(*), sum(n), max(n) FROM s")

Q6_PARAM = """SELECT sum(l_extendedprice * l_discount) AS revenue
FROM lineitem
WHERE l_shipdate >= $1 AND l_shipdate < $2
  AND l_discount BETWEEN $3 AND $4 AND l_quantity < $5"""


def q6_params(i: int) -> list:
    """Phase 5's i-th Q6 variant (``families``) as Q6_PARAM's values."""
    year, disc, qty = 1993 + i % 5, 2 + i, 24 + i % 2
    return [datetime.date(year, 1, 1), datetime.date(year + 1, 1, 1),
            decimal.Decimal(f"0.{disc - 1:02d}"),
            decimal.Decimal(f"0.{disc + 1:02d}"), qty]


def phase10_queries(threshold: int = IN_THRESHOLD) -> list:
    """(label, SQL) of phase 10's queries (a)-(h)."""
    return [("a Q15", Q15), ("b IN-subquery", in_drilldown(threshold)),
            ("c window", WINDOW_RANK), ("d ROLLUP", Q1_ROLLUP),
            ("e INTERSECT", month_setop("INTERSECT")),
            ("e EXCEPT", month_setop("EXCEPT")),
            ("f DISTINCT ON", DISTINCT_ON), ("g derived", DERIVED),
            ("h recursive", RECURSIVE)]


LINEITEM_DDL = """CREATE TABLE lineitem (
        l_orderkey bigint NOT NULL, l_quantity decimal(12,2),
        l_extendedprice decimal(12,2), l_discount decimal(12,2),
        l_tax decimal(12,2), l_returnflag text, l_linestatus text,
        l_shipdate date, l_suppkey bigint)"""

# phase 11: A11's local write surface on phase 4's lineitem.  The
# time-series layout (monthly partitions of the ship date, 1992-1998,
# each distributed by l_orderkey), INSERT ... SELECT of one month
# through each rung of the strategy ladder, RETURNING, CREATE TABLE AS,
# a foreign key to a reference table of the order keys, retention
LINEITEM_M_DDL = (LINEITEM_DDL.replace("CREATE TABLE lineitem (",
                                       "CREATE TABLE lineitem_m (")
                  + " PARTITION BY RANGE (l_shipdate)")
PH11_PARTITIONS = 84
PH11_DDL = [
    LINEITEM_M_DDL,
    "SELECT create_time_partitions('lineitem_m', '1 month', '1999-01-01', "
    "'1992-01-01')",
    f"SELECT create_distributed_table('lineitem_m', 'l_orderkey', {SHARDS})",
]
#: the month of phase 11's INSERT ... SELECT, COPY and Q6 of one month
JUNE_1994 = ("l_shipdate >= date '1994-06-01' "
             "AND l_shipdate < date '1994-07-01'")
Q6_JUNE_M = (Q6.replace("FROM lineitem", "FROM lineitem_m")
             .replace("l_shipdate >= date '1994-01-01'\n  "
                      "AND l_shipdate < date '1995-01-01'", JUNE_1994))
PH11_QUERIES = {
    "b1 Q6 of June 1994": Q6_JUNE_M,
    "b2 Q6": Q6.replace("FROM lineitem", "FROM lineitem_m"),
    "b3 P1": P1.replace("FROM lineitem", "FROM lineitem_m"),
}
PH11_EXPLAIN = "EXPLAIN " + PH11_QUERIES["b2 Q6"]
PH11_RETENTION = ("SELECT drop_old_time_partitions('lineitem_m', "
                  "'1993-01-01')")


def lineitem_named(name: str, references: str = "") -> str:
    """LINEITEM_DDL for a table ``name``, its l_orderkey referencing
    ``references`` when given."""
    ddl = LINEITEM_DDL.replace("CREATE TABLE lineitem (",
                               f"CREATE TABLE {name} (")
    if references:
        ddl = ddl.replace("l_orderkey bigint NOT NULL,",
                          "l_orderkey bigint NOT NULL REFERENCES "
                          f"{references},")
    return ddl


PH11_INSERTS = {
    # source and target colocated, the target's key fed by the source's
    "c1 colocated": ("li_copy", "l_orderkey",
                     f"INSERT INTO li_copy SELECT * FROM lineitem "
                     f"WHERE {JUNE_1994}"),
    # the target distributed by another column: re-hashed
    "c2 repartition": ("li_supp", "l_suppkey",
                       f"INSERT INTO li_supp SELECT * FROM lineitem "
                       f"WHERE {JUNE_1994}"),
}
#: verification of an INSERT ... SELECT target
PH11_TARGET_CHECK = ("SELECT count(*), sum(l_quantity), sum(l_extendedprice), "
                     "min(l_orderkey), max(l_orderkey), sum(l_suppkey) "
                     "FROM {t}")
DAILY_DDL = ("CREATE TABLE daily (l_shipdate date NOT NULL, n bigint, "
             "revenue decimal(18,4))")
INSERT_DAILY = ("INSERT INTO daily SELECT l_shipdate, count(*), "
                "sum(l_extendedprice * (1 - l_discount)) FROM lineitem "
                "GROUP BY l_shipdate")
UPSERT_DAILY = (INSERT_DAILY
                + " ON CONFLICT (l_shipdate) DO UPDATE SET n = n + excluded.n")
DAILY_CHECK = "SELECT l_shipdate, n, revenue FROM daily ORDER BY l_shipdate"
#: TPC-H Q18's inner aggregate (H1) over the month's copy
H1_MONTH = ("SELECT l_orderkey, sum(l_quantity) AS qty FROM li_copy "
            "GROUP BY l_orderkey HAVING sum(l_quantity) > 30")
CTAS_H1 = "CREATE TABLE h1_month AS " + H1_MONTH
H1_MONTH_CHECK = "SELECT l_orderkey, qty FROM h1_month ORDER BY l_orderkey"
UPDATE_RETURNING = ("UPDATE li_copy SET l_tax = 0.01 WHERE l_shipdate = "
                    "date '1994-06-15' RETURNING l_orderkey, l_tax")
DELETE_RETURNING = ("DELETE FROM li_copy WHERE l_shipdate = date '1994-06-16' "
                    "RETURNING l_orderkey, l_quantity")
REINSERT_JUNE_16 = ("INSERT INTO li_copy SELECT * FROM lineitem WHERE "
                    "l_shipdate = date '1994-06-16'")
ORDERS_REF_DDL = "CREATE TABLE orders_ref (o_orderkey bigint PRIMARY KEY)"
#: phase 11 runs each statement cold and this many times warm
P11_WARM = 3

# phase 12: the rest of A11 on phase 8's orders_b arrays.  TPC-H's own
# load path (a `|`-delimited dbgen file through COPY FROM), exports to
# CSV and binary files, MERGE of a staging table (TPC-H's refresh
# functions RF1 and RF2 at SF1, plus an update stream), ALTER TABLE,
# the redistribution UDFs, extended statistics with ANALYZE, REINDEX
ORDERS_M_DDL = ("CREATE TABLE {t} (o_orderkey bigint PRIMARY KEY, "
                "o_custkey bigint NOT NULL, o_flag text)")
#: TPC-H RF1 inserts SF x 1,500 new orders and RF2 deletes as many
PH12_RF1 = 1_500
PH12_RF2 = 1_500
#: existing orders the staging table updates (a new custkey and flag)
PH12_UPDATES = 15_000
#: phase 12 runs each read statement cold and this many times warm,
#: but, to keep the script inside its time limit (PERF.md section 4),
#: its whole-table statements (the exports, ANALYZE, REINDEX: 0.5-4 s
#: a run on the card's host) cold only, CREATE STATISTICS (whose counts
#: ANALYZE repeats) once warm and the MERGE P12_MERGE_WARM times warm
P12_WARM = 3
P12_WARM_HEAVY = 0
P12_MERGE_WARM = 1
PH12_CHECKS = {
    "count and sums": ("SELECT count(*), sum(o_custkey), sum(o_orderkey) "
                       "FROM {t}"),
    "o_flag counts": ("SELECT {f}, count(*) FROM {t} GROUP BY {f} "
                      "ORDER BY {f}"),
}
PH12_MERGE = (
    "MERGE INTO orders_m t USING orders_delta d "
    "ON t.o_orderkey = d.o_orderkey "
    "WHEN MATCHED THEN UPDATE SET o_custkey = d.o_custkey, "
    "o_flag = d.o_flag "
    "WHEN NOT MATCHED THEN INSERT (o_orderkey, o_custkey, o_flag) "
    "VALUES (d.o_orderkey, d.o_custkey, d.o_flag)")
PH12_MERGE_RF2 = ("MERGE INTO orders_m t USING orders_rf2 r "
                  "ON t.o_orderkey = r.o_orderkey WHEN MATCHED THEN DELETE")
PH12_MERGE_DUP = ("MERGE INTO orders_m t USING orders_dup d "
                  "ON t.o_orderkey = d.o_orderkey "
                  "WHEN MATCHED THEN UPDATE SET o_custkey = d.o_custkey")
PH12_FLAGS_QUERY = ("COPY (SELECT o_flag, count(*) FROM orders_m GROUP BY "
                    "o_flag) TO '{path}'")
PH12_CHECK_OK = ("ALTER TABLE orders_m ADD CONSTRAINT cust_nonneg "
                 "CHECK (o_custkey >= 0)")
#: orders_b's custkeys start at 0: this CHECK is violated
PH12_CHECK_BAD = ("ALTER TABLE orders_m ADD CONSTRAINT cust_pos "
                  "CHECK (o_custkey > 0)")
PH12_LOOKUP = ("SELECT count(*), sum(o_orderkey) FROM orders_m "
               "WHERE o_custkey = {k}")


RF = np.array(["A", "N", "R"])
LS = np.array(["F", "O"])

#: H100 SXM device-memory rate (NVIDIA data sheet), for the bound
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM float32 rate outside the tensor cores, for the operations
#: bound of integer and float64 folds (a lower bound on their time)
SIMT_OPS_PER_S = 67e12


def say(*parts) -> None:
    print(*parts, flush=True)


def lineitem_chunks(n_rows: int):
    """bench.py's ensure_data generator (seed 7, 1M-row chunks), as the
    integer arrays it draws: cents, flag indexes, day numbers."""
    rng = np.random.default_rng(7)
    # l_suppkey (phase 10) from a stream of its own: bench.py's columns
    # keep their values
    srng = np.random.default_rng(8)
    chunk = 1_000_000
    for start in range(0, n_rows, chunk):
        n = min(chunk, n_rows - start)
        yield {
            "orderkey": rng.integers(0, n_rows // 4, n),
            "qty": rng.integers(100, 5100, n),
            "price": rng.integers(90_000, 10_500_000, n),
            "disc": rng.integers(0, 11, n),
            "tax": rng.integers(0, 9, n),
            "rf": rng.integers(0, 3, n),
            "ls": rng.integers(0, 2, n),
            "ship": (rng.integers(0, 2526, n) + 8036).astype(np.int32),
            "suppkey": srng.integers(1, SUPPLIERS + 1, n),
        }


def copy_columns(c: dict) -> dict:
    """The generator's values as bench.py hands them to copy_from."""
    return {
        "l_orderkey": c["orderkey"],
        "l_quantity": c["qty"] / 100.0,
        "l_extendedprice": c["price"] / 100.0,
        "l_discount": c["disc"] / 100.0,
        "l_tax": c["tax"] / 100.0,
        "l_returnflag": RF[c["rf"]].tolist(),
        "l_linestatus": LS[c["ls"]].tolist(),
        "l_shipdate": c["ship"],
        "l_suppkey": c["suppkey"],
    }


def _day(y, m, d) -> int:
    return (datetime.date(y, m, d) - datetime.date(1970, 1, 1)).days


def _dec(v: int, scale: int) -> decimal.Decimal:
    return decimal.Decimal(int(v)).scaleb(-scale)


def _avg(total: int, count: int, scale: int) -> decimal.Decimal:
    """The engine's exact decimal average: scale + 6, half up."""
    q = decimal.Decimal(int(total)) * 1_000_000 / decimal.Decimal(int(count))
    return _dec(int(q.to_integral_value(rounding=decimal.ROUND_HALF_UP)),
                scale + 6)


def oracle_q1(cols: dict, delta: int = 90) -> list[tuple]:
    """Q1 with ``date '1998-12-01' - interval 'delta' day``."""
    keep = cols["ship"] <= _day(1998, 12, 1) - delta
    gid = (cols["rf"] * 2 + cols["ls"])[keep]
    groups, inv = np.unique(gid, return_inverse=True)
    qty, price = cols["qty"][keep], cols["price"][keep]
    disc, tax = cols["disc"][keep], cols["tax"][keep]
    disc_price = price * (100 - disc)
    charge = disc_price * (100 + tax)

    def total(v):
        out = np.zeros(len(groups), np.int64)
        np.add.at(out, inv, v.astype(np.int64))
        return out
    cnt = np.bincount(inv, minlength=len(groups))
    s_qty, s_price, s_disc = total(qty), total(price), total(disc)
    s_dp, s_ch = total(disc_price), total(charge)
    rows = []
    for i, g in enumerate(groups):
        rows.append((str(RF[g // 2]), str(LS[g % 2]),
                     _dec(s_qty[i], 2), _dec(s_price[i], 2),
                     _dec(s_dp[i], 4), _dec(s_ch[i], 6),
                     _avg(s_qty[i], cnt[i], 2), _avg(s_price[i], cnt[i], 2),
                     _avg(s_disc[i], cnt[i], 2), int(cnt[i])))
    return sorted(rows, key=lambda r: (r[0], r[1]))


def oracle_q6(cols: dict, year: int = 1994, disc: int = 6,
              qty: int = 24) -> list[tuple]:
    """Q6 with its substitution parameters: ship year, discount in
    cents, quantity."""
    keep = ((cols["ship"] >= _day(year, 1, 1))
            & (cols["ship"] < _day(year + 1, 1, 1))
            & (cols["disc"] >= disc - 1) & (cols["disc"] <= disc + 1)
            & (cols["qty"] < qty * 100))
    rev = int((cols["price"][keep].astype(np.int64)
               * cols["disc"][keep]).sum())
    return [(_dec(rev, 4),)]


def oracle_h1(cols: dict, threshold: int = 300) -> list[tuple]:
    """H1: per-order quantity sums above ``threshold``, by order key."""
    keys, inv = np.unique(cols["orderkey"], return_inverse=True)
    qty = np.zeros(len(keys), np.int64)
    np.add.at(qty, inv, cols["qty"].astype(np.int64))
    keep = qty > threshold * 100
    return [(int(k), _dec(q, 2)) for k, q in zip(keys[keep], qty[keep])]


def oracle_h2(cols: dict, lo: int = None, hi: int = None) -> list[tuple]:
    """H2: the ten largest per-order revenues of ship days [lo, hi)
    (default: 1994)."""
    lo = _day(1994, 1, 1) if lo is None else lo
    hi = _day(1995, 1, 1) if hi is None else hi
    keep = (cols["ship"] >= lo) & (cols["ship"] < hi)
    keys, inv = np.unique(cols["orderkey"][keep], return_inverse=True)
    rev = np.zeros(len(keys), np.int64)
    np.add.at(rev, inv, cols["price"][keep].astype(np.int64)
              * (100 - cols["disc"][keep]))
    order = np.lexsort((keys, -rev))[:10]
    return [(int(keys[i]), _dec(rev[i], 4)) for i in order]


def oracle_q15(cols: dict, sign: int = -1) -> list[tuple]:
    """Phase 10's Q15: the suppliers of the largest revenue of ship days
    [1996-01-01, 1996-04-01), each line's price times (1 - discount) (or
    with ``sign`` 1, phase 13's replaced body, times (1 + discount))."""
    keep = ((cols["ship"] >= _day(1996, 1, 1))
            & (cols["ship"] < _day(1996, 4, 1)))
    rev = np.zeros(SUPPLIERS + 1, np.int64)
    np.add.at(rev, cols["suppkey"][keep], cols["price"][keep].astype(np.int64)
              * (100 + sign * cols["disc"][keep]))
    top = rev.max()
    return [(int(s), _dec(top, 4)) for s in np.nonzero(rev == top)[0]]


def oracle_p1(cols: dict, day: int = 1) -> list[tuple]:
    """P1: the lines shipped on 1994-06-<day> with a discount of 9 % or
    more."""
    keep = (cols["ship"] == _day(1994, 6, day)) & (cols["disc"] >= 9)
    rows = sorted(zip(cols["orderkey"][keep].tolist(),
                      cols["qty"][keep].tolist(),
                      cols["price"][keep].tolist()))
    return [(k, _dec(q, 2), _dec(p, 2)) for k, q, p in rows]


def month_mask(cols: dict) -> np.ndarray:
    """The rows of phase 11's month (June 1994)."""
    return (cols["ship"] >= _day(1994, 6, 1)) & (cols["ship"] < _day(1994, 7, 1))


def oracle_q6_month(cols: dict) -> list[tuple]:
    """Phase 11's Q6 of June 1994."""
    keep = (month_mask(cols) & (cols["disc"] >= 5) & (cols["disc"] <= 7)
            & (cols["qty"] < 2400))
    rev = int((cols["price"][keep].astype(np.int64)
               * cols["disc"][keep]).sum())
    return [(_dec(rev, 4),)]


def oracle_target(cols: dict, keep) -> list[tuple]:
    """PH11_TARGET_CHECK over the rows ``keep`` selects."""
    ok = cols["orderkey"][keep]
    if not ok.size:
        return [(0, None, None, None, None, None)]
    return [(int(ok.size), _dec(int(cols["qty"][keep].sum()), 2),
             _dec(int(cols["price"][keep].astype(np.int64).sum()), 2),
             int(ok.min()), int(ok.max()), int(cols["suppkey"][keep].sum()))]


def oracle_daily(cols: dict, times: int = 1) -> list[tuple]:
    """DAILY_CHECK after INSERT_DAILY, with ``n`` summed ``times``
    times (the upsert adds the count again)."""
    days, inv = np.unique(cols["ship"], return_inverse=True)
    cnt = np.bincount(inv)
    rev = np.zeros(len(days), np.int64)
    np.add.at(rev, inv, cols["price"].astype(np.int64) * (100 - cols["disc"]))
    epoch = datetime.date(1970, 1, 1)
    return [(epoch + datetime.timedelta(days=int(d)), int(c) * times,
             _dec(int(r), 4)) for d, c, r in zip(days, cnt, rev)]


def oracle_h1_month(cols: dict, threshold: int = 30) -> list[tuple]:
    """H1_MONTH_CHECK: per-order quantity sums of June 1994 above
    ``threshold``."""
    keep = month_mask(cols)
    return oracle_h1({"orderkey": cols["orderkey"][keep],
                      "qty": cols["qty"][keep]}, threshold)


def day_rows(cols: dict, day: int, second: str) -> list[tuple]:
    """(l_orderkey, ``second``) of the rows shipped on 1994-06-<day>,
    sorted: ``second`` is "tax" (UPDATE_RETURNING sets it to 0.01) or
    "qty"."""
    keep = cols["ship"] == _day(1994, 6, day)
    ok = cols["orderkey"][keep].tolist()
    if second == "tax":
        return sorted((k, _dec(1, 2)) for k in ok)
    return sorted(zip(ok, (_dec(q, 2) for q in cols["qty"][keep].tolist())))


# ------------------------------------------------------------- phase 1


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0] if out else ""


# ------------------------------------------------------------- phase 3


def time_cuda(fn, reps: int = 25, rounds: int = 3) -> float:
    """Milliseconds per call of ``fn``: CUDA events around ``reps``
    back-to-back calls, the median over ``rounds`` such runs."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return float(np.median(times))


#: calls a phase-3 device time is the mean of, and the idle seconds at
#: each end of its profiler session (a session that starts or ends busy
#: may lose its record)
DEVICE_REPS = 20
DEVICE_PAUSE_S = 0.3


def device_time(fn, reps: int = DEVICE_REPS) -> tuple:
    """``fn``'s device time a call from torch.profiler: -> (ms a call
    over its kernels, copies and sets, {name: ms a call}); (None, {})
    when the session lost its device record."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(DEVICE_PAUSE_S)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(DEVICE_PAUSE_S)
    per = {e.key: e.self_device_time_total / 1e3 / reps
           for e in prof.key_averages()
           if e.device_type.name == "CUDA" and e.self_device_time_total > 0}
    return (sum(per.values()) if per else None), per


def fmt_ms(ms) -> str:
    return "not measured (no device record)" if ms is None else f"{ms:.4f} ms"


def fmt_kernels(per: dict) -> str:
    return ", ".join(f"{k.split('(')[0][:40]} {v:.4f}"
                     for k, v in sorted(per.items(), key=lambda kv: -kv[1]))


def regime_name(regime: int) -> str:
    """A fold launch's regime (``last_regime``) in words."""
    if regime > 1:
        return f"shared-memory table in {regime} query chunks"
    return {1: "shared-memory table", 0: "global atomics"}.get(regime,
                                                               "none")


def fold_masks(call):
    """The [N] row mask of a fold call (``scan_agg_fold``'s arguments) or
    the [Q, N] masks of a batched one (``scan_agg_fold_batched``'s)."""
    return call[-1]


#: bytes of one DRAM sector: the least a load of a scattered row moves
SECTOR_BYTES = 32


def sector_bytes(t, rows) -> int:
    """Bytes of the 32-byte sectors of ``t`` (an [N] column) that hold at
    least one row of ``rows`` (bool [N])."""
    import torch
    per = max(1, SECTOR_BYTES // t.element_size())
    pad = (-rows.numel()) % per
    if pad:
        rows = torch.cat([rows, rows.new_zeros(pad)])
    hit = int(rows.view(-1, per).any(dim=1).sum())
    return min(t.numel() * t.element_size(), hit * SECTOR_BYTES)


def _column_names(exprs) -> set:
    from citus_tpu_torch.planner.bound import BColumn, walk
    return {n.name for x in exprs if x is not None for n in walk(x)
            if isinstance(n, BColumn)}


def read_rows(prog, cols, params, mask):
    """-> (the rows whose WHERE a generated fold or insert evaluates, the
    rows whose keys and arguments it evaluates) on this call's data.  One
    query (``mask`` [N], the row mask): the WHERE where the row mask is
    set, the keys and arguments where the WHERE passes too.  Q queries
    (``mask`` [Q, N], each query's WHERE already in its mask): no WHERE,
    the keys and arguments where some query's mask is set."""
    if mask.dim() == 2:
        return None, mask.any(dim=0)
    return mask, prog.plain_eval(cols, params, mask)[0]


def column_bytes(prog, cols, params, mask) -> int:
    """Bytes of the scan columns and validities a generated fold or insert
    must read on this call's data (``read_rows``): of a column the WHERE
    reads, the sectors that hold a row whose WHERE it evaluates; of a
    column only the keys and arguments read, the sectors that hold a row
    whose keys and arguments it evaluates.  A column both read is charged
    once, as the WHERE's: the second load of a row hits the cache."""
    where_rows, value_rows = read_rows(prog, cols, params, mask)
    e = prog.exprs
    where = set() if where_rows is None else _column_names((e.filter,))
    seen, total = set(), 0
    for c in sorted(where | _column_names((*e.keys, *e.args))):
        rows = where_rows if c in where else value_rows
        for t in cols[c]:
            if t is not None and t.data_ptr() not in seen:
                seen.add(t.data_ptr())
                total += sector_bytes(t, rows)
    return total


def call_params(call) -> dict:
    """The host parameters of a one-query fold or insert call ({} for a
    batched one, whose WHERE arrives in its masks)."""
    return call[-2] if call[-1].dim() == 1 else {}


def fold_bytes(call) -> int:
    """Bytes one fold must move on this call's data: the row mask (or the
    Q masks) read once, the scan columns and validities as
    ``column_bytes`` charges them, each register read and written once.
    The expressions' intermediate values stay in registers."""
    prog, regs, rows, cols = call[:4]
    mask = fold_masks(call)
    outs = list(regs) + ([rows] if rows is not None else [])
    return (mask.numel() + column_bytes(prog, cols, call_params(call), mask)
            + 2 * sum(t.numel() * t.element_size() for t in outs))


def fold_ops(call, op_cost=lambda op: 1) -> int:
    """Operations of a fold on this call's data (``read_rows``): one to
    read each mask entry; one per bound node of the WHERE for each row
    whose WHERE it evaluates; one per bound node of the keys and
    arguments and four per key for the group id for each row whose keys
    and arguments it evaluates; ``op_cost(op)`` per partial op for each
    (query, row) it folds."""
    from citus_tpu_torch.planner.bound import walk
    prog, mask = call[0], fold_masks(call)
    where_rows, value_rows = read_rows(prog, call[3], call_params(call),
                                       mask)
    e = prog.exprs

    def nodes(xs):
        return sum(1 for x in xs if x is not None for _ in walk(x))
    folded = value_rows if mask.dim() == 1 else mask
    where = 0 if where_rows is None else \
        int(where_rows.sum()) * nodes((e.filter,))
    return (mask.numel() + where
            + int(value_rows.sum()) * (nodes((*e.keys, *e.args))
                                       + 4 * len(e.keys))
            + int(folded.sum()) * sum(op_cost(op) for op in prog.ops))


def clone_call(call):
    """The call with fresh copies of its registers and group-row counts."""
    prog, regs, rows = call[:3]
    return (prog, [r.clone() for r in regs],
            None if rows is None else rows.clone()) + tuple(call[3:])


def fold_abs_sums(call) -> list:
    """Per partial op of a fold call, the plain version's per-group sum
    of the magnitudes of a float sum's argument over the rows the call
    folds (registers shaped as the op's), None for every other op."""
    import torch
    from citus_tpu_torch.ops.scan_agg_fold import (
        FoldOp, plain_fold_inputs, scan_agg_fold_batched_plain,
        scan_agg_fold_plain,
    )
    prog, regs, cols, mask = call[0], call[1], call[3], fold_masks(call)
    if mask.dim() == 2:
        _, keys, args = plain_fold_inputs(prog, cols, {}, mask[0],
                                          with_filter=False)
        fold = scan_agg_fold_batched_plain
    else:
        mask, keys, args = plain_fold_inputs(prog, cols, call[4], mask)
        fold = scan_agg_fold_plain
    mags = [(v.abs(), ok) if v.is_floating_point() else (v, ok)
            for v, ok in args]
    out = []
    for op, r in zip(prog.ops, regs):
        if op.kind != "sum" or not r.is_floating_point():
            out.append(None)
            continue
        a = torch.zeros(r.shape, dtype=torch.float64, device=r.device)
        fold([a], None, mask.contiguous(), keys, mags,
             [FoldOp("sum", op.arg)], prog.n_groups)
        out.append(a)
    return out


def compare_fold(name: str, call, kernel, plain, abs_sums=False) -> float:
    """Kernel vs plain on one input; -> max abs error of float sums.

    int64 registers, counts, min/max and NaN positions identical; a
    float64 sum within rel 1e-12 of the plain version's (atomics add in
    another order).  With ``abs_sums`` (a case over signed float data),
    each float sum is held instead to 1e-12 times the plain version's
    sum of the magnitudes of its group's values (``fold_abs_sums``):
    near cancellation a bound relative to the sum itself is wrong."""
    import torch
    kc, pc = clone_call(call), clone_call(call)
    kernel(*kc)
    plain(*pc)
    if fold_masks(call).is_cuda:
        torch.cuda.synchronize()
    scales = fold_abs_sums(call) if abs_sums else None
    max_err = 0.0
    for i, (op, k, p) in enumerate(zip(call[0].ops, kc[1], pc[1])):
        k, p = k.cpu().numpy(), p.cpu().numpy()
        if op.kind == "sum" and np.issubdtype(k.dtype, np.floating):
            if not np.array_equal(np.isnan(k), np.isnan(p)):
                raise AssertionError(f"{name}: op {i} NaN positions differ")
            fin = np.isfinite(k) & np.isfinite(p)
            if not np.array_equal(k[~fin & ~np.isnan(k)],
                                  p[~fin & ~np.isnan(p)]):
                raise AssertionError(f"{name}: op {i} infinities differ")
            err = np.abs(k[fin] - p[fin])
            scale = np.abs(p) if scales is None else scales[i].cpu().numpy()
            tol = 1e-12 * scale[fin]
            if (err > tol).any():
                raise AssertionError(
                    f"{name}: op {i} float sum beyond 1e-12 x "
                    f"{'its sum of magnitudes' if abs_sums else 'itself'}"
                    f": max err {err.max()}")
            if err.size:
                max_err = max(max_err, float(err.max()))
        elif not np.array_equal(k, p, equal_nan=np.issubdtype(
                k.dtype, np.floating)):
            raise AssertionError(f"{name}: op {i} ({op.kind}) differs")
    if kc[2] is not None and not torch.equal(kc[2], pc[2]):
        raise AssertionError(f"{name}: group row counts differ")
    return max_err


def column_program(filter_, keys: list, args: list, ops, col_types: dict,
                   cols: dict, **kw):
    """A ``FoldProgram`` over synthetic columns: ``keys`` and ``args``
    are column names (or bound expressions), ``col_types`` their SQL
    types, ``cols`` their (values, validity) tensors."""
    import torch
    from citus_tpu_torch.ops.expr_codegen import FoldExprs
    from citus_tpu_torch.ops.scan_agg_fold import FoldProgram
    from citus_tpu_torch.planner.bound import BColumn

    def expr(x):
        return BColumn(x, col_types[x]) if isinstance(x, str) else x
    return FoldProgram(
        FoldExprs(filter_, tuple(expr(k) for k in keys),
                  tuple(expr(a) for a in args)), ops,
        {c: torch.empty(0, dtype=v.dtype).numpy().dtype
         for c, (v, _) in cols.items()}, {}, **kw)


def synthetic_global_case(device, n: int, G: int, seed: int, all_false: bool):
    """A direct fold past the shared-memory table: G groups, every op
    kind and register type, nulls, NaN, +-inf, +-0.0.  -> the arguments
    of ``scan_agg_fold``."""
    import torch
    from citus_tpu_torch import types as T
    from citus_tpu_torch.ops.scan_agg_fold import FoldOp
    g = torch.Generator().manual_seed(seed)
    mask = (torch.rand(n, generator=g) < 0.8) & (not all_false)
    key = torch.randint(0, G - 1, (n,), generator=g)
    key_valid = torch.rand(n, generator=g) < 0.97
    ints = torch.randint(-10**12, 10**12, (n,), generator=g)
    pos = torch.rand(n, generator=g, dtype=torch.float64) * 1000
    mixed = torch.randn(n, generator=g, dtype=torch.float64)
    for t in (pos, mixed):
        idx = torch.randint(0, n, (64,), generator=g)
        t[idx[:16]] = float("nan")
        t[idx[16:32]] = float("inf")
        t[idx[32:40]] = float("-inf")
        t[idx[40:52]] = 0.0
        t[idx[52:]] = -0.0
    i32 = torch.randint(-2**31, 2**31 - 1, (n,), generator=g,
                        dtype=torch.int32)
    f32 = mixed.to(torch.float32)
    valid = torch.rand(n, generator=g) < 0.9
    cols = {"key": (key, key_valid), "ints": (ints, valid),
            "pos": (pos, valid), "mixed": (mixed, None), "i32": (i32, valid),
            "f32": (f32, None)}
    types = {"key": T.INT64_T, "ints": T.INT64_T, "pos": T.FLOAT64_T,
             "mixed": T.FLOAT64_T, "i32": T.INT32_T, "f32": T.FLOAT32_T}
    ops = [FoldOp("count_star"), FoldOp("count", 0), FoldOp("sum", 0),
           FoldOp("sum", 1), FoldOp("min", 0), FoldOp("max", 0),
           FoldOp("min", 2), FoldOp("max", 2), FoldOp("min", 3),
           FoldOp("max", 3), FoldOp("min", 4), FoldOp("max", 4),
           FoldOp("count", 1)]
    dts = [torch.int64, torch.int64, torch.int64, torch.float64,
           torch.int64, torch.int64, torch.float64, torch.float64,
           torch.int32, torch.int32, torch.float32, torch.float32,
           torch.int64]
    prog = column_program(None, ["key"], ["ints", "pos", "mixed", "i32",
                                          "f32"], ops, types, cols,
                          domains=[(0, 1, 1)], n_groups=G)
    regs = []
    for op, dt in zip(ops, dts):
        fill = 0
        if op.kind in ("min", "max"):
            if dt.is_floating_point:
                fill = float("inf") if op.kind == "min" else float("-inf")
            else:
                info = torch.iinfo(dt)
                fill = info.max if op.kind == "min" else info.min
        regs.append(torch.full((G,), fill, dtype=dt, device=device))
    rows = torch.zeros(G, dtype=torch.int64, device=device)
    dcols = {c: (v.to(device), None if m is None else m.to(device))
             for c, (v, m) in cols.items()}
    return (prog, regs, rows, dcols, {}, mask.to(device))


def cancellation_case(device, n: int, G: int, seed: int):
    """A direct fold of signed float64 values whose group sums nearly
    cancel (each group's values drawn around 0 with magnitudes up to
    1e9).  -> the arguments of ``scan_agg_fold``."""
    import torch
    from citus_tpu_torch import types as T
    from citus_tpu_torch.ops.scan_agg_fold import FoldOp
    rng = np.random.default_rng(seed)
    key = rng.integers(0, G, n)
    x = rng.standard_normal(n) * 10.0 ** rng.integers(0, 10, n)
    # pull each group's sum to (nearly) zero: subtract its mean
    sums = np.bincount(key, weights=x, minlength=G)
    counts = np.maximum(np.bincount(key, minlength=G), 1)
    x = x - (sums / counts)[key]
    types = {"key": T.INT64_T, "x": T.FLOAT64_T}
    ops = [FoldOp("count_star"), FoldOp("sum", 0)]

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    cols = {"key": (t(key), None), "x": (t(x), None)}
    prog = column_program(None, ["key"], ["x"], ops, types, cols,
                          domains=[(0, 1, 1)], n_groups=G + 1)
    regs = [torch.zeros(G + 1, dtype=torch.int64, device=device),
            torch.zeros(G + 1, dtype=torch.float64, device=device)]
    rows = torch.zeros(G + 1, dtype=torch.int64, device=device)
    return (prog, regs, rows, cols, {}, t(np.ones(n, bool)))


SYN_DDL = """CREATE TABLE syn (k bigint NOT NULL, a bigint, b int,
        s double, f real, p decimal(12,2))"""

#: a synthetic predicate over nulls, NaN, zero divisors and three-valued
#: AND/OR (filter_mask's adversarial case)
SYN_WHERE = ("(a / b > 1 OR s > 0.5) AND (NOT (f < 0.25) OR a % b = 1) "
             "OR (s <> s AND b = 0) OR (p * 2 > 90 AND s IS NULL)")

BENCH_HASH = ("SELECT l_orderkey, count(*), sum(l_quantity) "
              "FROM lineitem GROUP BY l_orderkey")


def plan_as_cluster_does(cl, sql: str):
    """-> (plan, encoded parameters) of one SELECT, its SQL functions
    inlined, bound, auto-parameterized and planned as ``Cluster.execute``
    does it."""
    from citus_tpu_torch.executor.executor import encode_params
    from citus_tpu_torch.planner import parse_sql
    from citus_tpu_torch.planner.auto_param import auto_parameterize
    from citus_tpu_torch.planner.bind import bind_select
    from citus_tpu_torch.planner.physical import plan_select
    stmt = parse_sql(sql)[0]
    if cl.catalog.functions:
        from citus_tpu_torch.commands.select_exec import (
            _expand_functions_stmt,
        )
        stmt = _expand_functions_stmt(cl, stmt)
    bound = bind_select(cl.catalog, stmt)
    values = None
    ap = auto_parameterize(bound)
    if ap is not None:
        bound, values = ap
    plan = plan_select(cl.catalog, bound,
                       direct_limit=cl.settings.planner.direct_gid_limit)
    return plan, encode_params(cl.catalog, bound, values)


def filter_program(cl, sql: str):
    """-> (FilterProgram, host parameter env) of a query's WHERE, as the
    executor builds it."""
    from citus_tpu_torch.executor.executor import (
        _build_filter_mask, _params_env,
    )
    plan, params = plan_as_cluster_does(cl, sql)
    return _build_filter_mask(plan, params), _params_env(plan, params)


def smoke_plans(device, tmp: str, n: int = FOLD_N):
    """The port's plans over a small lineitem (for the key domains) and a
    synthetic table, the main path's fold inputs for Q6 and Q1 applied
    to one padded batch of ``n`` generated rows, and the filter
    programs of Q6, P1 and the synthetic predicate.  -> dict."""
    import torch
    import citus_tpu_torch as ctt
    from citus_tpu_torch.executor.batches import pad_to_batch
    from citus_tpu_torch.executor.executor import (
        _hash_key_dtypes, _param_dtypes, _params_env,
    )
    from citus_tpu_torch.ops.scan_agg import (
        build_fold_inputs, empty_device_partials,
    )
    from citus_tpu_torch.ops.scan_agg_fold import FoldProgram
    cl = ctt.Cluster(os.path.join(tmp, "plans"), device=device)
    cl.execute(LINEITEM_DDL)
    cl.execute(f"SELECT create_distributed_table('lineitem', 'l_orderkey', {SHARDS})")
    cl.copy_from("lineitem", columns=copy_columns(next(lineitem_chunks(20_000))))
    cl.execute(SYN_DDL)
    cl.execute("SELECT create_distributed_table('syn', 'k', 2)")
    cl.execute(EV_DDL)
    cl.execute(f"SELECT create_distributed_table('events', 'id', {SHARDS})")
    cl.copy_from("events", columns=events_copy_columns(
        next(events_chunks(20_000))))

    def ids(col, words):
        return np.array([cl.catalog.lookup_string_id("lineitem", col, w)
                         for w in words], np.int32)
    chunks = list(lineitem_chunks(n))
    c = {k: np.concatenate([ch[k] for ch in chunks]) for k in chunks[0]}
    physical = {  # the engine's encoding: cents, dictionary ids, days
        "l_orderkey": c["orderkey"], "l_quantity": c["qty"],
        "l_extendedprice": c["price"], "l_discount": c["disc"],
        "l_tax": c["tax"], "l_returnflag": ids("l_returnflag", RF)[c["rf"]],
        "l_linestatus": ids("l_linestatus", LS)[c["ls"]],
        "l_shipdate": c["ship"],
    }
    calls = {}
    for name, sql in (("q6", Q6), ("q1", Q1)):
        plan, params = plan_as_cluster_does(cl, sql)
        values = {k: physical[k] for k in plan.scan_columns}
        masks = {k: np.ones(n, bool) for k in plan.scan_columns}
        hb = pad_to_batch(plan.bound.table, plan, values, masks, n, n, 0)
        dcols = tuple(torch.from_numpy(a).to(device) for a in hb.cols)
        dvalids = tuple(torch.from_numpy(a).to(device) for a in hb.valids)
        dmask = torch.from_numpy(hb.row_mask).to(device)
        acc = empty_device_partials(plan, device)
        calls[name] = build_fold_inputs(plan, _param_dtypes(plan, params))(
            acc, dcols, dvalids, dmask, _params_env(plan, params))
    filters = {
        "q6": filter_program(cl, Q6),
        "p1": filter_program(cl, P1),
        "syn": filter_program(cl, f"SELECT k FROM syn WHERE {SYN_WHERE}"),
        "c1_all": filter_program(
            cl, f"SELECT id FROM events WHERE {ALL_NODES_WHERE}"),
    }
    # the programs phase 8's C1 projections run (built in phase 2)
    c1_programs = {
        w: filter_program(cl, f"SELECT id FROM events WHERE {w} "
                              "ORDER BY id")[0] for w in C1_WHERES}
    fams = family_plans(cl, {
        **families(), **c1_families(),
        "C1all": ("projection", [(all_nodes_variant(i), None)
                                 for i in range(Q_BATCH)])})
    events = events_columns(cl, n, 41)
    # the hash inserts phase 4 and the H family run (SF1 plans them to the
    # hash mode; here the key domain is small, so cut direct_gid_limit)
    cl.execute("SET citus.direct_gid_limit = 100")
    hash_programs = {}
    for name, sql in (("bench", BENCH_HASH), ("H1", H1), ("H2", H2)):
        plan, params = plan_as_cluster_does(cl, sql)
        hash_programs[name] = FoldProgram.of_plan(
            plan, _param_dtypes(plan, params),
            _hash_key_dtypes(plan, _params_env(plan, params)))
    hfam = family_plans(cl, {"H": families()["H"]})["H"]
    cl.close()
    return {"fold_calls": calls, "physical": physical, "filters": filters,
            "families": fams, "events": events, "c1_programs": c1_programs,
            "hash_programs": hash_programs, "h_family": hfam}


def generated_programs(plans, splans, tmp: str) -> list:
    """The fold and insert programs phases 3-7 launch: phase 3's cases
    (their main-path plans and the synthetic ones), phase 4's Q1, Q6,
    H1, H2 and S1, phase 5's families, phase 7's R1 and S1."""
    from citus_tpu_torch.executor.executor import _hash_key_dtypes, _params_env
    from citus_tpu_torch.executor.megabatch import _fold_program
    from citus_tpu_torch.ops.scan_agg_fold import FoldProgram
    progs = [plans["fold_calls"]["q6"][0], plans["fold_calls"]["q1"][0],
             synthetic_global_case("cpu", 16, 4, 1, False)[0],
             cancellation_case("cpu", 16, 4, 1)[0],
             adversarial_sketch_call("cpu", 8192)[0],
             adversarial_hash_call("cpu", 16, 8, 1, False)[0],
             splans["s1_call"][0], *plans["hash_programs"].values()]
    for name in ("Q6", "Q1"):
        plan, params = plans["families"][name]
        progs.append(_fold_program(plan, params[0], "cpu"))
    plan, params = splans["family"]
    progs.append(_fold_program(plan, params[0], "cpu"))
    hplan, hparams = plans["h_family"]
    progs.append(_fold_program(hplan, hparams[0], "cpu", _hash_key_dtypes(
        hplan, _params_env(hplan, hparams[0]))))
    rplan, rkd = r1_plan("cpu", os.path.join(tmp, "phase2"))
    progs.append(FoldProgram.of_plan(rplan, {}, rkd))
    return progs


def rehearsal_sources(tmp: str, name: str, body) -> list:
    """(build, source) of each generated kernel ``body(cl)`` launches,
    recorded from the programs it hands the kernels' wrappers on a CPU
    cluster over 20,000 generated lineitem rows (the plain versions run
    there), so that phase 2 builds them with the rest."""
    import citus_tpu_torch as ctt
    from citus_tpu_torch.ops import filter_mask as fm
    from citus_tpu_torch.ops import hash_agg_insert as hi
    from citus_tpu_torch.ops import scan_agg_fold as saf
    seen = {}

    def recording(module, name, build, source):
        plain = getattr(module, name)

        def record(prog, *args, **kw):
            seen.setdefault(source(prog), build(prog))
            return plain(prog, *args, **kw)
        setattr(module, name, record)
        return module, name, plain

    cl = ctt.Cluster(os.path.join(tmp, name), device="cpu")
    patched = [
        recording(saf, "fold_plain", lambda p: saf.FOLD_BUILD,
                  lambda p: p.row.source),
        recording(hi, "insert_plain", lambda p: hi.INSERT_BUILD,
                  lambda p: p.row.source),
        recording(fm, "filter_mask_plain", lambda p: "filter_mask",
                  lambda p: p.predicate.source)]
    try:
        cl.execute(LINEITEM_DDL)
        cl.execute("SELECT create_distributed_table('lineitem', "
                   f"'l_orderkey', {SHARDS})")
        cl.copy_from("lineitem",
                     columns=copy_columns(next(lineitem_chunks(20_000))))
        cl.execute("SET citus.hash_agg_slots = auto")
        body(cl)
    finally:
        for module, name, plain in patched:
            setattr(module, name, plain)
        cl.close()
    return [(build, src) for src, build in seen.items()]


def start_rehearsals(tmp: str, n_orders: int):
    """Start ``phase10_sources``, ``phase11_sources``, ``phase12_sources``
    and ``phase13_sources`` (the last two over ``n_orders`` orders' value
    ranges) in a process of their own, with no CUDA device visible to it,
    so that their CPU rehearsals run beside phase 2's builds.  -> a
    handle for ``finish_rehearsals``."""
    out = os.path.join(tmp, "rehearsals.json")
    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
            "import chip_smoke as c; "
            "json.dump({'p10': c.phase10_sources(sys.argv[2]), "
            "'p11': c.phase11_sources(sys.argv[2]), "
            "'p12': c.phase12_sources(sys.argv[2], int(sys.argv[4])), "
            "'p13': c.phase13_sources(sys.argv[2], int(sys.argv[4]))}, "
            "open(sys.argv[3], 'w'))")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.Popen([sys.executable, "-c", code, here, tmp, out,
                             str(n_orders)], env=env)
    return proc, out


def finish_rehearsals(handle) -> tuple:
    """Wait for ``start_rehearsals``; -> (phase 10's, 11's, 12's and
    13's (build, source) lists)."""
    proc, out = handle
    try:
        rc = proc.wait(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if rc != 0:
        raise AssertionError(f"the kernel-source rehearsals exited {rc}")
    with open(out) as fh:
        got = json.load(fh)
    return tuple([tuple(b) for b in got[k]]
                 for k in ("p10", "p11", "p12", "p13"))


def phase10_sources(tmp: str) -> list:
    """``rehearsal_sources`` of phase 10's queries.  The IN-subquery's
    drill-down is missing: its IN list, and so its source, depends on
    the rows."""
    def body(cl):
        for _, sql in phase10_queries():
            cl.execute(sql)
        cl.execute(Q6_PARAM, params=q6_params(0))
    return rehearsal_sources(tmp, "phase10", body)


def phase11_sources(tmp: str) -> list:
    """``rehearsal_sources`` of phase 11's statements (its loads, the
    queries on the parent, the INSERT ... SELECT ladder, the FK checks;
    not the profiled run or the retention)."""
    def body(cl):
        chunk = next(lineitem_chunks(20_000))
        for sql in PH11_DDL:
            cl.execute(sql)
        cl.copy_from("lineitem_m", columns=copy_columns(chunk))
        for p in cl.catalog.partitions_of("lineitem_m"):
            cl.execute(f"SELECT count(*) FROM {p.name}")
        for sql in PH11_QUERIES.values():
            cl.execute(sql)
        for table, key, sql in PH11_INSERTS.values():
            cl.execute(lineitem_named(table))
            cl.execute(f"SELECT create_distributed_table('{table}', "
                       f"'{key}', {SHARDS})")
            cl.execute(sql)
            cl.execute(PH11_TARGET_CHECK.format(t=table))
        cl.execute(DAILY_DDL)
        cl.execute(f"SELECT create_distributed_table('daily', 'l_shipdate', "
                   f"{SHARDS})")
        for sql in (INSERT_DAILY, DAILY_CHECK, UPSERT_DAILY, CTAS_H1,
                    H1_MONTH_CHECK, UPDATE_RETURNING, DELETE_RETURNING,
                    REINSERT_JUNE_16, "SELECT count(*) FROM li_copy WHERE "
                    "l_shipdate = date '1994-06-16'"):
            cl.execute(sql)
        cl.execute(ORDERS_REF_DDL)
        cl.execute("SELECT create_reference_table('orders_ref')")
        cl.copy_from("orders_ref",
                     columns={"o_orderkey": np.unique(chunk["orderkey"])})
        cl.execute(lineitem_named("li_fk0", "orders_ref (o_orderkey)"))
        cl.execute(f"SELECT create_distributed_table('li_fk0', 'l_orderkey', "
                   f"{SHARDS})")
        june = month_mask(chunk)
        cl.copy_from("li_fk0", columns=copy_columns(
            {k: v[june] for k, v in chunk.items()}))
        cl.execute(PH11_TARGET_CHECK.format(t="li_fk0"))
        k0 = int(chunk["orderkey"][june][0])
        try:
            cl.execute(f"DELETE FROM orders_ref WHERE o_orderkey = {k0}")
        except Exception:  # noqa: BLE001 -- refused, as on the card
            pass
    return rehearsal_sources(tmp, "phase11", body)


def phase12_sources(tmp: str, n_orders: int) -> list:
    """``rehearsal_sources`` of phase 12's reads, over the first 20,000
    of ``n_orders`` orders (their custkeys span the full scale's range,
    so each plan takes the card's mode): the Q checks, COPY (SELECT
    ...) TO, the statistics' counts, the CHECK validations, the index
    lookup (the MERGEs, COPYs and DDL launch no kernel)."""
    def body(cl):
        state = ph12_orders(n_orders, 20_000)
        tbl = os.path.join(tmp, "phase12_orders.tbl")
        with open(tbl, "w") as fh:
            fh.write("\n".join(ph12_lines(state, "|")) + "\n")
        bin_path = os.path.join(tmp, "phase12_orders.bin")

        def checks(t, f="o_flag"):
            for sql in PH12_CHECKS.values():
                cl.execute(sql.format(t=t, f=f))
        for t in ("orders_m", "orders_m2"):
            cl.execute(ORDERS_M_DDL.format(t=t))
            cl.execute(f"SELECT create_distributed_table('{t}', "
                       f"'o_orderkey', {SHARDS})")
        cl.execute(f"COPY orders_m FROM '{tbl}' WITH (delimiter '|')")
        checks("orders_m")
        cl.execute(PH12_FLAGS_QUERY.format(
            path=os.path.join(tmp, "phase12_flags.csv")))
        cl.execute(f"COPY orders_m TO '{bin_path}' WITH (format binary)")
        cl.execute(f"COPY orders_m2 FROM '{bin_path}' WITH (format binary)")
        checks("orders_m2")
        cl.execute("CREATE STATISTICS st_cust_flag ON o_custkey, o_flag "
                   "FROM orders_m")
        cl.execute("ANALYZE orders_m")
        cl.execute(PH12_CHECK_OK)
        try:
            cl.execute(PH12_CHECK_BAD)
            cl.execute("ALTER TABLE orders_m DROP CONSTRAINT cust_pos")
        except Exception:  # noqa: BLE001 -- refused, as on the card
            pass
        cl.execute("ALTER TABLE orders_m RENAME COLUMN o_flag TO o_status")
        checks("orders_m", "o_status")
        cl.execute("ALTER TABLE orders_m RENAME COLUMN o_status TO o_flag")
        cl.execute("SELECT alter_distributed_table('orders_m', 8)")
        checks("orders_m")
        cl.execute("SELECT undistribute_table('orders_m2')")
        checks("orders_m2")
        cl.execute("CREATE INDEX ix_cust ON orders_m (o_custkey)")
        cl.execute(PH12_LOOKUP.format(k=int(state["cust"][0])))
    return rehearsal_sources(tmp, "phase12", body)


def family_plans(cl, fams: dict = None) -> dict:
    """name -> (plan of the first variant, encoded parameters of every
    variant) of each family of ``fams`` (phase 5's and phase 8's); every
    variant must share the plan family (one ``plan_fingerprint``), or
    the family cannot coalesce."""
    from citus_tpu_torch.executor.kernel_cache import plan_fingerprint
    out = {}
    for name, (_kind, variants) in (fams or families()).items():
        planned = [plan_as_cluster_does(cl, sql) for sql, _ in variants]
        fps = {plan_fingerprint(plan) for plan, _ in planned}
        if len(fps) != 1:
            raise AssertionError(f"family {name}: {len(fps)} plan families")
        out[name] = (planned[0][0], [p for _, p in planned])
    return out


def syn_columns(n: int, seed: int) -> dict:
    """Columns of the synthetic table, device dtypes, with nulls, NaN,
    +-inf, +-0.0 and zero divisors: {name: (values, valid)}."""
    rng = np.random.default_rng(seed)
    s = rng.normal(0.3, 1, n)
    f = rng.normal(0.2, 0.5, n).astype(np.float32)
    for v in (s, f):
        idx = rng.integers(0, n, 4096)
        v[idx[:1024]] = np.nan
        v[idx[1024:1536]] = np.inf
        v[idx[1536:2048]] = -np.inf
        v[idx[2048:3072]] = 0.0
        v[idx[3072:]] = -0.0
    cols = {"a": rng.integers(-1000, 1000, n), "b": rng.integers(-3, 4, n),
            "s": s, "f": f, "p": rng.integers(-10_000, 10_000, n)}
    return {k: (v, rng.random(n) > 0.1) for k, v in cols.items()}


def lineitem_filter_columns(physical: dict) -> dict:
    return {k: (v, np.ones(v.shape[0], bool)) for k, v in physical.items()}


def filter_call(prog, columns: dict, params: dict, device, n: int):
    """-> (cols, params, row_mask) of one filter_mask launch over
    ``columns`` with the last 1,000 rows padding."""
    import torch
    cols = {c: (torch.from_numpy(np.ascontiguousarray(
                    columns[c][0][:n].astype(prog.col_dtypes[c]))).to(device),
                torch.from_numpy(np.ascontiguousarray(
                    columns[c][1][:n])).to(device))
            for c in prog.columns}
    mask = np.ones(n, bool)
    mask[-1000:] = False
    return cols, params, torch.from_numpy(mask).to(device)


def filter_bytes(cols: dict, row_mask) -> int:
    """Bytes one predicate launch must move: each column and validity
    read once, the row mask (if any) read once, the mask written once."""
    n = next(iter(cols.values()))[0].numel()
    total = n if row_mask is None else 2 * n
    for v, m in cols.values():
        total += v.numel() * v.element_size() + (0 if m is None
                                                 else m.numel())
    return total


# ------------------------------------------------------------- hash phase


def clone_table(t):
    """A copy of a hash table in slot records, as the kernels take it."""
    from citus_tpu_torch.ops.hash_agg import record_views
    return record_views(t.records.clone(), [v.dtype for v in t.key_values],
                        [p.dtype for p in t.partials])


def copy_table_(dst, src) -> None:
    dst.records.copy_(src.records)


def hash_partial_ops(table, ops):
    """HostGroupAccumulator ops of one insert's partial tables."""
    from citus_tpu_torch.planner.physical import PartialOp
    out = []
    for op, t in zip(ops, table.partials):
        if op.kind == "count_star":
            out.append(PartialOp("count", -1, "int64"))
        else:
            out.append(PartialOp(op.kind, op.arg,
                                 str(t.dtype).replace("torch.", "")))
    return out


def _host_rows(n: int, keys, args) -> tuple:
    """Keys and arguments ((values, validity or None) tensors, [N] or a
    broadcast [1]) as [N] numpy arrays."""
    def host(t):
        if t is None:
            return np.ones(n, bool)
        a = t.cpu().numpy()
        return np.broadcast_to(a, (n,)) if a.shape[0] != n else a
    return ([(host(kv), host(kvm)) for kv, kvm in keys],
            [(host(v), host(valid)) for v, valid in args])


def host_groups(table, spill, mask, keys, args, ops) -> dict:
    """The merged groups of one insert: the table's occupied slots and
    the spilled rows through HostGroupAccumulator (executor/host_agg.py),
    -> {canonical key bytes: partial values}."""
    from citus_tpu_torch.executor.host_agg import HostGroupAccumulator
    acc = HostGroupAccumulator(len(keys), hash_partial_ops(table, ops))
    acc.add_batch(spill.cpu().numpy(), *_host_rows(mask.shape[0], keys,
                                                   args))
    key_tables, partials, rows = table.to_host()
    acc.merge_partials(rows > 0, [(kv, kf == 2) for kv, kf in key_tables],
                       list(partials), rows)
    return {kb: tuple(acc._accs[gi]) for kb, gi in acc._groups.items()}


def abs_groups(table, mask, keys, args, ops) -> dict:
    """Per group of the masked rows, each partial op over the magnitudes
    of its argument (HostGroupAccumulator): a float sum's entry is its
    group's sum of magnitudes.  -> {canonical key bytes: values}."""
    from citus_tpu_torch.executor.host_agg import HostGroupAccumulator
    acc = HostGroupAccumulator(len(keys), hash_partial_ops(table, ops))
    hkeys, hargs = _host_rows(mask.shape[0], keys, args)
    acc.add_batch(mask.cpu().numpy(), hkeys,
                  [(np.abs(v) if v.dtype.kind == "f" else v, ok)
                   for v, ok in hargs])
    return {kb: tuple(acc._accs[gi]) for kb, gi in acc._groups.items()}


def compare_groups(name: str, got: dict, want: dict, pops,
                   scale: dict = None) -> float:
    """Identical groups; int64 partials identical, float min/max
    identical, float sums within rel 1e-12 (atomics add in another
    order) or, with ``scale`` (``abs_groups``: a case over signed float
    data), within 1e-12 times their group's sum of magnitudes.
    -> max abs error of float sums."""
    if got.keys() != want.keys():
        raise AssertionError(
            f"{name}: {len(got)} groups, the plain version {len(want)}; "
            f"{len(got.keys() ^ want.keys())} differ")
    max_err = 0.0
    for kb, w in want.items():
        for i, (op, a, b) in enumerate(zip(pops, got[kb], w)):
            a, b = np.asarray(a), np.asarray(b)
            if op.kind == "sum" and b.dtype.kind == "f":
                if np.isnan(a) != np.isnan(b) or (
                        np.isinf(b) and a != b):
                    raise AssertionError(f"{name}: sum {a} vs {b}")
                if np.isfinite(b):
                    err = abs(float(a) - float(b))
                    tol = abs(float(b)) if scale is None \
                        else float(scale[kb][i])
                    if err > 1e-12 * tol:
                        raise AssertionError(
                            f"{name}: float sum {a} vs {b} beyond 1e-12 x "
                            f"{'itself' if scale is None else 'its sum of magnitudes'}")
                    max_err = max(max_err, err)
            elif not np.array_equal(a, b, equal_nan=b.dtype.kind == "f"):
                raise AssertionError(f"{name}: {op.kind} {a} vs {b}")
    return max_err


def check_hash_invariants(name: str, table, spill, mask) -> None:
    """Each key sits in at most one slot; every masked row is placed or
    spilled exactly once; the claim words mirror the occupancy."""
    placed, spilled = int(table.rows.sum()), int(spill.sum())
    if placed + spilled != int(mask.sum()):
        raise AssertionError(f"{name}: {placed} placed + {spilled} spilled "
                             f"!= {int(mask.sum())} masked rows")
    check_table(name, table)


def check_table(name: str, table) -> None:
    """The claim words mirror the occupancy, and each key sits in at most
    one slot."""
    import torch
    if not torch.equal(table.state, 2 * (table.rows > 0).to(torch.int32)):
        raise AssertionError(f"{name}: claim words disagree with rows")
    occ = (table.rows > 0).cpu().numpy()
    parts = []
    for kv, kf in zip(table.key_values, table.key_flags):
        a = kv.cpu().numpy()[occ]
        if a.dtype == np.float64:
            a = a.view(np.int64)
        elif a.dtype == np.float32:
            a = a.view(np.int32)
        parts += [a.astype(np.int64), kf.cpu().numpy()[occ].astype(np.int64)]
    if occ.any() and len(np.unique(np.stack(parts, 1), axis=0)) != occ.sum():
        raise AssertionError(f"{name}: a key sits in more than one slot")


def hash_bytes(call, occupied: int) -> int:
    """Bytes one insert into a fresh table must move on this call's data:
    the row mask (or the Q masks) read and the spill mask(s) written
    once, the scan columns and validities as ``column_bytes`` charges
    them, and each of the ``occupied`` slots it fills read and written
    once (claim word, keys, flags, partials, rows).  A row that spills
    only probes slots already occupied, so no other slot needs to be
    touched."""
    prog, table, cols = call[:3]
    mask = call[-1]
    slot = sum(t.element_size() for t in table.key_values + table.key_flags
               + table.partials + [table.rows, table.state])
    return (2 * mask.numel() + column_bytes(prog, cols, call_params(call),
                                            mask)
            + 2 * occupied * slot)


def main_path_hash_call(cl, device):
    """The kernel inputs of bench.py's hash GROUP BY for the first padded
    shard batch of the loaded lineitem, on a fresh table sized as the
    main path sizes it (citus.hash_agg_slots = auto)."""
    import torch
    from citus_tpu_torch.executor.executor import (
        _hash_key_dtypes, _hash_slots, _iter_padded_batches,
    )
    from citus_tpu_torch.ops.hash_agg import (
        build_hash_insert_inputs, empty_hash_state,
    )
    cl.execute("SET citus.hash_agg_slots = auto")
    plan, _ = plan_as_cluster_does(cl, BENCH_HASH)
    if plan.group_mode.kind != "hash_host":
        raise AssertionError(f"{BENCH_HASH} plans to {plan.group_mode.kind}")
    S = _hash_slots(cl.catalog, plan, cl.settings)
    key_dtypes = _hash_key_dtypes(plan, {})
    batches = _iter_padded_batches(cl.catalog, plan, cl.settings)
    hb = next(batches)
    batches.close()
    table = empty_hash_state(plan, S, key_dtypes, device)
    call = build_hash_insert_inputs(plan, key_dtypes)(
        table, tuple(torch.from_numpy(a).to(device) for a in hb.cols),
        tuple(torch.from_numpy(a).to(device) for a in hb.valids),
        torch.from_numpy(hb.row_mask).to(device))
    return call, hb.n_rows


def clustered_hash_call(call, n_real: int, seed: int = 17):
    """The main path's hash call with its real rows' l_orderkey in runs
    of 1 to 7 consecutive rows, as dbgen writes TPC-H lineitem (an
    order's lines together; dbgen's sparse order keys, 8 of every 32),
    on the call's (fresh) table: one group a run, about n_real / 4
    groups."""
    import torch
    prog, table, cols, params, row_mask = call
    rng = np.random.default_rng(seed)
    runs = rng.integers(1, 8, n_real // 4 + 8)
    runs = runs[:np.searchsorted(np.cumsum(runs), n_real) + 1]
    order = np.arange(runs.size)
    keys = np.repeat(order // 8 * 32 + order % 8 + 1, runs)[:n_real]
    values, valid = cols["l_orderkey"]
    values = values.clone()
    values[:n_real] = torch.from_numpy(keys).to(values.device)
    return (prog, table, dict(cols, l_orderkey=(values, valid)), params,
            row_mask)


def adversarial_hash_call(device, n: int, S: int, seed: int,
                          all_false: bool):
    """Three keys (int64; float64 with +-0.0, NaN payloads, +-inf; int32),
    each 5 % NULL, a float64 sum, min and max with NaN and +-inf, on S
    slots (S = 1000: most rows spill).  -> the arguments of
    ``hash_agg_insert``."""
    import torch
    from citus_tpu_torch import types as T
    from citus_tpu_torch.ops.hash_agg import record_layout, record_views
    from citus_tpu_torch.ops.scan_agg_fold import FoldOp
    rng = np.random.default_rng(seed)
    nan_bits = np.array([0x7FF8000000000000, 0x7FF0000000000001,
                         0xFFF8000000000000, 0x7FFFFFFFFFFFFFFF], np.uint64)
    fpool = np.concatenate([[0.0, -0.0, np.inf, -np.inf, 1.5, -2.25],
                            nan_bits.view(np.float64),
                            rng.normal(0, 100, 6)])
    k1 = rng.integers(-2**62, 2**62, 600)[rng.integers(0, 600, n)]
    k2 = fpool[rng.integers(0, fpool.size, n)]
    k3 = rng.integers(-2**31, 2**31 - 1, 5, dtype=np.int64).astype(
        np.int32)[rng.integers(0, 5, n)]
    v = rng.uniform(0, 1000, n)
    idx = rng.integers(0, n, 64)
    v[idx[:16]] = np.nan
    v[idx[16:40]] = np.inf
    v[idx[40:]] = -np.inf
    mask = (rng.random(n) < 0.9) & (not all_false)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    cols = {c: (t(k), t(rng.random(n) > 0.05))
            for c, k in (("k1", k1), ("k2", k2), ("k3", k3))}
    cols["v"] = (t(v), t(rng.random(n) > 0.1))
    ops = [FoldOp("count_star"), FoldOp("count", 0), FoldOp("sum", 0),
           FoldOp("min", 0), FoldOp("max", 0)]
    types = {"k1": T.INT64_T, "k2": T.FLOAT64_T, "k3": T.INT32_T,
             "v": T.FLOAT64_T}
    prog = column_program(None, ["k1", "k2", "k3"], ["v"], ops, types, cols,
                          key_dtypes=(np.int64, np.float64, np.int32))
    i64, f64 = torch.int64, torch.float64
    kdts, adts = [i64, f64, torch.int32], [i64, i64, f64, f64, f64]
    table = record_views(torch.zeros(
        (S, record_layout(len(kdts), len(adts)).words), dtype=i64,
        device=device), kdts, adts)
    for v, fill in zip(table.key_values + table.partials[3:],
                       (-2**63, float("-inf"), -2**31, float("inf"),
                        float("-inf"))):
        v.fill_(fill)
    return prog, table, cols, {}, t(mask)


def compare_hash(name: str, call, kernel, plain, abs_sums=False) -> float:
    """Kernel vs plain (``hash_agg_insert``'s arguments) on fresh copies
    of one insert's table: the invariants of each side, then the merged
    groups of table and spill (``compare_groups``; with ``abs_sums``, the
    float sums held to their groups' sums of magnitudes).  -> max abs
    error of float sums in the merged groups."""
    import torch
    from citus_tpu_torch.ops.hash_agg_insert import plain_insert_inputs
    prog, table, cols, params, row_mask = call
    kt, pt = clone_table(table), clone_table(table)
    ks = kernel(prog, kt, cols, params, row_mask)
    ps = plain(prog, pt, cols, params, row_mask)
    if row_mask.is_cuda:
        torch.cuda.synchronize()
    mask, keys, args = plain_insert_inputs(prog, cols, params, row_mask)
    check_hash_invariants(f"{name} kernel", kt, ks, mask)
    check_hash_invariants(f"{name} plain", pt, ps, mask)
    pops = hash_partial_ops(table, prog.ops)
    scale = abs_groups(table, mask, keys, args, prog.ops) if abs_sums \
        else None
    return compare_groups(
        name, host_groups(kt, ks, mask, keys, args, prog.ops),
        host_groups(pt, ps, mask, keys, args, prog.ops), pops, scale)


def compare_hash_batched(name: str, call, kernel, plain, abs_sums=False):
    """Kernel vs plain (``hash_agg_insert_batched``'s arguments) on fresh
    copies of the Q tables, query by query as ``compare_hash`` holds one
    insert.  -> (max abs error of float sums, the kernel's tables, its
    [Q, N] spill masks)."""
    import torch
    from citus_tpu_torch.ops.hash_agg_insert import plain_insert_inputs
    prog, table, cols, masks = call
    _, keys, args = plain_insert_inputs(prog, cols, {}, masks[0],
                                        with_filter=False)
    kt, pt = clone_table(table), clone_table(table)
    ks = kernel(prog, kt, cols, masks)
    ps = plain(prog, pt, cols, masks)
    if masks.is_cuda:
        torch.cuda.synchronize()
    pops = hash_partial_ops(table, prog.ops)
    max_err = 0.0
    for qi in range(masks.shape[0]):
        for what, t, sp in (("kernel", kt, ks), ("plain", pt, ps)):
            check_hash_invariants(f"{name} q{qi} {what}", t.query(qi),
                                  sp[qi], masks[qi])
        scale = abs_groups(table.query(qi), masks[qi], keys, args,
                           prog.ops) if abs_sums else None
        max_err = max(max_err, compare_groups(
            f"{name} q{qi}",
            host_groups(kt.query(qi), ks[qi], masks[qi], keys, args,
                        prog.ops),
            host_groups(pt.query(qi), ps[qi], masks[qi], keys, args,
                        prog.ops), pops, scale))
    return max_err, kt, ks


def time_cuda_fresh(fn, reset, reps: int = 10) -> float:
    """Milliseconds of one call of ``fn`` on state that ``reset`` restores
    before each call (outside the timed events); the median of ``reps``."""
    import torch
    reset()
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        reset()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


# ------------------------------------------------------- merge phase (B3)

#: phase 7's pushed hash GROUP BY: TPC-H Q17's per-part quantity
#: aggregate, decorrelated (its subquery's GROUP BY l_partkey), 200,000
#: groups at SF1, present on both coordinators
R1 = """SELECT l_partkey, count(*), sum(l_quantity), avg(l_quantity),
       min(l_extendedprice), max(l_extendedprice)
FROM lineitem GROUP BY l_partkey ORDER BY l_partkey"""


def r1_plan(device, tmp: str):
    """R1's plan over a small sketch table (20,000 rows; the key domain
    of l_partkey is wider than direct_gid_limit, so it plans to the hash
    mode).  -> (plan, key dtypes)."""
    import citus_tpu_torch as ctt
    from citus_tpu_torch.executor.executor import _hash_key_dtypes
    cl = ctt.Cluster(os.path.join(tmp, "merge_plans"), device=device)
    try:
        cl.execute(S_DDL)
        cl.execute("SELECT create_distributed_table('lineitem', "
                   f"'l_suppkey', {SHARDS})")
        cl.copy_from("lineitem", columns=sketch_copy_columns(
            next(sketch_chunks(20_000, 3, 20_000))))
        plan, _ = plan_as_cluster_does(cl, R1)
    finally:
        cl.close()
    if plan.group_mode.kind != "hash_host":
        raise AssertionError(f"R1 plans to {plan.group_mode.kind}")
    return plan, _hash_key_dtypes(plan, {})


def r1_table(device, plan, key_dtypes, n: int, slots: int, seed: int):
    """The hash table one shard's insert leaves for R1: ``n`` generated
    sketch-table rows (padded to a power of two, as a shard batch is)
    through ``hash_agg_insert`` into ``slots`` slots."""
    import torch
    from citus_tpu_torch.executor.batches import pad_to_batch
    from citus_tpu_torch.ops.hash_agg import (
        build_hash_insert_inputs, empty_hash_state,
    )
    from citus_tpu_torch.ops.hash_agg_insert import hash_agg_insert
    chunks = list(sketch_chunks(n, seed, SF1_ROWS))
    physical = sketch_physical(
        {k: np.concatenate([ch[k] for ch in chunks]) for k in chunks[0]})
    values = {k: physical[k] for k in plan.scan_columns}
    masks = {k: np.ones(n, bool) for k in plan.scan_columns}
    hb = pad_to_batch(plan.bound.table, plan, values, masks, n,
                      1 << (n - 1).bit_length(), 0)
    table = empty_hash_state(plan, slots, key_dtypes, device)
    hash_agg_insert(*build_hash_insert_inputs(plan, key_dtypes)(
        table, tuple(torch.from_numpy(a).to(device) for a in hb.cols),
        tuple(torch.from_numpy(a).to(device) for a in hb.valids),
        torch.from_numpy(hb.row_mask).to(device)))
    return table


def main_path_merge_call(device, tmp: str, n: int = SF1_ROWS // SHARDS,
                         slots: int = 1 << 20):
    """The merge R1 makes on the main path: into the table one padded
    shard batch of the sketch table left (2^20 slots: what
    citus.hash_agg_slots = auto gives at SF1), the table of another
    shard batch, as a peer ships it.  Both hold nearly all 200,000 parts,
    so most entries match.  -> ((table, keys, partials, rows, kinds), n)."""
    plan, key_dtypes = r1_plan(device, tmp)
    table = r1_table(device, plan, key_dtypes, n, slots, 21)
    peer = r1_table(device, plan, key_dtypes, n, slots, 22)
    # the peer's table as it arrives: one contiguous [M] array a field
    c = [t.contiguous() for t in peer.key_values + peer.key_flags
         + peer.partials + [peer.rows]]
    k = len(peer.key_values)
    return ((table, list(zip(c[:k], c[k:2 * k])), c[2 * k:-1], c[-1],
             [op.kind for op in plan.partial_ops]), n)


def adversarial_merge_call(device, n: int, S: int, S_peer: int, seed: int,
                           empty: bool = False):
    """phase 3's adversarial insert (three keys: int64; float64 with
    +-0.0, NaN payloads and NULLs; int32; NaN and +-inf arguments) twice
    over the same rows: the coordinator's table of S slots holds the
    first eighth of them, the peer's of S_peer slots (not a multiple of
    the block) all of them, so its entries match, claim and spill.  Half
    of the peer's empty entries get garbage keys under flag 0 (a
    citus_tpu peer keeps the dtype minimum there): the merge must never
    read them.  With ``empty``, every entry is empty."""
    import torch
    from citus_tpu_torch.ops.hash_agg_insert import (
        hash_agg_insert_plain, plain_insert_inputs,
    )
    prog, table, cols, params, row_mask = adversarial_hash_call(
        device, n, S, seed, False)
    mask, keys, args = plain_insert_inputs(prog, cols, params, row_mask)
    ops = prog.ops
    first = torch.arange(n, device=device) < n // 8
    hash_agg_insert_plain(table, mask & first, keys, args, ops)
    peer = adversarial_hash_call(device, n, S_peer, seed, False)[1]
    hash_agg_insert_plain(peer, mask, keys, args, ops)
    rng = np.random.default_rng(seed)
    if empty:
        peer.rows.zero_()
        peer.key_flags = [torch.zeros_like(f) for f in peer.key_flags]
    holes = ((peer.rows == 0).cpu().numpy()
             & (rng.random(S_peer) < 0.5))
    for kv in peer.key_values:
        junk = rng.normal(0, 1e6, S_peer) if kv.is_floating_point() \
            else rng.integers(-1000, 1000, S_peer)
        host = kv.cpu().numpy().copy()
        host[holes] = junk[holes].astype(host.dtype)
        kv.copy_(torch.from_numpy(host))
    kinds = ["count" if op.kind == "count_star" else op.kind for op in ops]
    c = lambda ts: [t.contiguous() for t in ts]  # noqa: E731  as shipped
    return (table, list(zip(c(peer.key_values), c(peer.key_flags))),
            c(peer.partials), peer.rows.contiguous(), kinds)


def compare_merge(name: str, call, kernel, plain) -> float:
    """Kernel vs plain on fresh copies of the coordinator's table with
    the same entries; both must keep the table invariants, conserve the
    rows, and give the same merged groups.  -> max abs error of float
    sums."""
    import torch
    table, keys, parts, rows, kinds = call
    kt, pt = clone_table(table), clone_table(table)
    ks = kernel(kt, keys, parts, rows, kinds)
    ps = plain(pt, keys, parts, rows, kinds)
    if rows.is_cuda:
        torch.cuda.synchronize()
    before, shipped = int(table.rows.sum()), int(rows.sum())
    for who, t, sp in (("kernel", kt, ks), ("plain", pt, ps)):
        check_table(f"{name} {who}", t)
        if int(t.rows.sum()) + int(rows[sp].sum()) != before + shipped:
            raise AssertionError(f"{name} {who}: rows not conserved")
    got, want = (group_merge(t, sp, keys, parts, rows, kinds)
                 for t, sp in ((kt, ks), (pt, ps)))
    if got.keys() != want.keys():
        raise AssertionError(
            f"{name}: {len(got)} groups, the plain version {len(want)}; "
            f"{len(got.keys() ^ want.keys())} differ")
    max_err = 0.0
    for kb, w in want.items():
        for kind, a, b in zip(kinds + ["rows"], got[kb], w):
            if kind == "sum" and isinstance(b, float):
                if math.isnan(a) != math.isnan(b) or (
                        math.isinf(b) and a != b):
                    raise AssertionError(f"{name}: sum {a} vs {b}")
                if math.isfinite(b):
                    err = abs(a - b)
                    if err > 1e-12 * abs(b):
                        raise AssertionError(
                            f"{name}: float sum {a} vs {b} beyond rel 1e-12")
                    max_err = max(max_err, err)
            elif not (a == b or (isinstance(b, float) and math.isnan(a)
                                 and math.isnan(b))):
                raise AssertionError(f"{name}: {kind} {a} vs {b}")
    return max_err


def group_merge(table, spill, keys, parts, rows, kinds) -> dict:
    """The groups of a merge: the table's occupied slots and the spilled
    entries, reduced by canonical key (count and sum add, min and max
    keep the NaN-propagating extremum, as the device merge does; the
    host accumulator's merge_partials would keep the first of a NaN and
    a number).  -> {key: (partials..., rows)}."""
    def host(t):
        return t.cpu().numpy()
    occ = host(table.rows) > 0
    sp = host(spill).astype(bool)
    kcols = []
    for (tv, tf), (ev, ef) in zip(zip(table.key_values, table.key_flags),
                                  keys):
        v = np.concatenate([host(tv)[occ], host(ev)[sp]])
        f = np.concatenate([host(tf)[occ], host(ef)[sp]])
        kcols.append((v, f))
    vals = [np.concatenate([host(tp)[occ], host(ep)[sp]])
            for tp, ep in zip(list(table.partials) + [table.rows],
                              list(parts) + [rows])]
    out: dict = {}
    for r in range(vals[-1].shape[0]):
        key = []
        for v, f in kcols:
            x = v[r].item()
            if f[r] != 2:
                key.append(None)
            elif isinstance(x, float) and math.isnan(x):
                key.append("nan")
            else:
                key.append(0.0 if x == 0 else x)
        key = tuple(key)
        cur = out.get(key)
        new = [v[r].item() for v in vals]
        if cur is None:
            out[key] = new
            continue
        for i, kind in enumerate(kinds + ["rows"]):
            a, b = cur[i], new[i]
            if kind in ("min", "max") and isinstance(a, float) and (
                    math.isnan(a) or math.isnan(b)):
                cur[i] = math.nan
            elif kind == "min":
                cur[i] = min(a, b)
            elif kind == "max":
                cur[i] = max(a, b)
            else:
                cur[i] = a + b
    return out


def merge_bytes(call, claims: int, matches: int) -> int:
    """Bytes one merge must move for this run's entries.  Every entry's
    spill flag is written, and its emptiness read from one byte, the
    first key's flag, where this run's entries have flag 0 exactly when
    they hold no rows (both packages' layouts), else from its row count.
    An occupied entry's keys, flags, partial states and row count are
    read once.  A match reads its slot's claim word, keys and flags and
    reads and writes its partials and row count; a claim reads and
    writes the whole slot.  A spilled entry is charged nothing more."""
    table, keys, parts, rows, _kinds = call
    m = rows.numel()
    occ = rows > 0
    occupied = int(occ.sum())
    by_flag = (keys[0][1] != 0).equal(occ)
    marker = 1 if by_flag else rows.element_size()
    entry = sum(t.element_size() for kv in keys for t in kv) \
        + sum(p.element_size() for p in parts) + rows.element_size() \
        - marker
    probe = table.state.element_size() + sum(
        t.element_size() for t in table.key_values + table.key_flags)
    state = sum(t.element_size() for t in table.partials + [table.rows])
    return m * (marker + 1) + occupied * entry \
        + matches * (probe + 2 * state) + claims * 2 * (probe + state)


# ------------------------------------------------------------- phase 4


def q1_max_charge(cols: dict) -> int:
    """Largest per-group sum of Q1's sum_charge argument at its bound
    scale (8: price x (1 - discount) x (1 + tax), decimal(38,8))."""
    keep = cols["ship"] <= _day(1998, 9, 2)
    gid = (cols["rf"] * 2 + cols["ls"])[keep]
    charge = (cols["price"][keep].astype(np.int64) * (100 - cols["disc"][keep])
              * (100 + cols["tax"][keep]))
    sums = np.zeros(6, np.int64)
    np.add.at(sums, gid, charge)  # scale 6; fits int64 at SF1
    return int(sums.max()) * 100


def q1_guard_fires(cols: dict) -> bool:
    """Whether the engine's overflow guard rejects Q1 on these rows: it
    refuses an int64 sum whose float64 shadow reaches 2^62."""
    return q1_max_charge(cols) >= 2 ** 62


def load_lineitem(ctt, path: str, n_rows: int):
    """-> (Cluster on CUDA, generated integer columns)."""
    t0 = time.perf_counter()
    cl = ctt.Cluster(path)
    if cl.device.type != "cuda":
        raise AssertionError(f"Cluster runs on {cl.device}, not CUDA")
    cl.execute(LINEITEM_DDL)
    cl.execute(f"SELECT create_distributed_table('lineitem', 'l_orderkey', {SHARDS})")
    chunks = []
    for c in lineitem_chunks(n_rows):
        cl.copy_from("lineitem", columns=copy_columns(c))
        chunks.append(c)
    cols = {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}
    say(f"phase 4 load: {n_rows} rows in {SHARDS} shards in "
        f"{time.perf_counter() - t0:.3f} s")
    return cl, cols


def launch_counters() -> dict:
    """The launch counter of every kernel of the port, by name."""
    from citus_tpu_torch.ops.filter_mask import (
        filter_mask, filter_mask_batched,
    )
    from citus_tpu_torch.ops.hash_agg_insert import (
        hash_agg_insert, hash_agg_insert_batched,
    )
    from citus_tpu_torch.ops.hash_agg_merge import hash_agg_merge
    from citus_tpu_torch.ops.scan_agg_fold import (
        scan_agg_fold, scan_agg_fold_batched,
    )
    from citus_tpu_torch.parallel.mesh import mesh_combine
    from citus_tpu_torch.parallel.shuffle import (
        exchange_blocks, pack_blocks, sorted_join,
    )
    from citus_tpu_torch.rollup.kernels import rollup_delta
    return {"scan_agg_fold": scan_agg_fold,
            "hash_agg_insert": hash_agg_insert, "filter_mask": filter_mask,
            "filter_mask_batched": filter_mask_batched,
            "scan_agg_fold_batched": scan_agg_fold_batched,
            "hash_agg_insert_batched": hash_agg_insert_batched,
            "rollup_delta": rollup_delta, "hash_agg_merge": hash_agg_merge,
            "partition_pack": pack_blocks, "sorted_join": sorted_join,
            "mesh_combine": mesh_combine, "exchange_blocks": exchange_blocks}


#: the batched kernels each phase-5 family's coalesced run must launch,
#: once per shard batch of its one group
FAMILY_KERNELS = {
    "scalar": ("filter_mask_batched", "scan_agg_fold_batched"),
    "direct": ("filter_mask_batched", "scan_agg_fold_batched"),
    "hash_host": ("filter_mask_batched", "hash_agg_insert_batched"),
    "projection": ("filter_mask_batched",),
}


def fanout(cl, sqls) -> tuple[dict, dict]:
    """Run one SQL per thread, all released together by a barrier so they
    land inside one coalescing window.  -> (results, errors)."""
    import threading
    results, errors = {}, {}
    bar = threading.Barrier(len(sqls))

    def run(i, sql):
        bar.wait()
        try:
            results[i] = cl.execute(sql)
        except Exception as e:  # noqa: BLE001 - reported by the caller
            errors[i] = e
    ts = [threading.Thread(target=run, args=(i, q)) for i, q in
          enumerate(sqls)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=600)
    if any(t.is_alive() for t in ts):
        raise AssertionError("a coalesced query did not finish in 600 s")
    return results, errors


def run_family(cl, name: str, kind: str, variants: list, cols: dict,
               n_rows: int, card: str = "") -> dict:
    """Phase 5 for one family: its Q_BATCH variants run serially (window
    0, one after another) and then coalesced (8 threads at once with
    citus.megabatch_window_ms = 1000, megabatch_max_size = 8), cold and
    warm.  Every query's rows must equal the numpy oracle; the coalesced
    runs must ride batches with occupancy above 1, launch each of the
    family's batched kernels once per shard batch per group and no other
    kernel.  -> the batched kernels' launches of the coalesced runs."""
    import torch
    from citus_tpu_torch.executor.megabatch import GLOBAL_MEGABATCH
    on_card = cl.device.type == "cuda"
    sqls = [sql for sql, _ in variants]
    wants = [oracle(cols) for _, oracle in variants]
    counters = launch_counters()
    cl.execute("SET citus.megabatch_window_ms = 0")
    serial_s = {}
    for run_kind in ("cold", "warm"):
        t0 = time.perf_counter()
        for sql, want in zip(sqls, wants):
            r = cl.execute(sql)
            if r.rows != want:
                raise AssertionError(
                    f"phase 5 {name} serial: rows differ from the numpy "
                    f"oracle:\n{r.rows[:5]}\n{want[:5]}")
        if on_card:
            torch.cuda.synchronize()
        serial_s[run_kind] = time.perf_counter() - t0
        say(f"phase 5 {name} serial {run_kind} (window 0, one query after "
            f"another): {len(sqls)} queries in {serial_s[run_kind]:.4f} s, "
            f"{len(sqls) / serial_s[run_kind]:.3f} queries/s, "
            f"{len(sqls) * n_rows / serial_s[run_kind]:.1f} rows/s ({card})")
    cl.execute("SET citus.megabatch_window_ms = 1000")
    cl.execute(f"SET citus.megabatch_max_size = {Q_BATCH}")
    launched = dict.fromkeys(counters, 0)
    try:
        for run_kind in ("cold", "warm"):
            for f in counters.values():
                f.launches = 0
            s0 = GLOBAL_MEGABATCH.stats()
            t0 = time.perf_counter()
            results, errors = fanout(cl, sqls)
            if on_card:
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            got = {k: f.launches for k, f in counters.items()}
            s1 = GLOBAL_MEGABATCH.stats()
            if errors:
                raise AssertionError(f"phase 5 {name} {run_kind}: {errors}")
            for i, want in enumerate(wants):
                if results[i].rows != want:
                    raise AssertionError(
                        f"phase 5 {name} {run_kind}: query {i} rows differ "
                        f"from the numpy oracle:\n{results[i].rows[:5]}\n"
                        f"{want[:5]}")
                if results[i].explain["strategy"] != kind:
                    raise AssertionError(
                        f"phase 5 {name}: strategy "
                        f"{results[i].explain['strategy']}, not {kind}")
            queries = s1["queries"] - s0["queries"]
            batches = s1["batches"] - s0["batches"]
            dispatches = s1["dispatches"] - s0["dispatches"]
            if queries != len(sqls) or not 1 <= batches < queries:
                raise AssertionError(
                    f"phase 5 {name} {run_kind}: {queries} queries rode "
                    f"{batches} batches (occupancy must be above 1)")
            if dispatches == 0:
                raise AssertionError(f"phase 5 {name}: no shard batch")
            if on_card:
                for k, v in got.items():
                    want_n = dispatches if k in FAMILY_KERNELS[kind] else 0
                    if v != want_n:
                        raise AssertionError(
                            f"phase 5 {name} {run_kind}: {k} launched {v} "
                            f"times for {dispatches} shard batches of "
                            f"{batches} groups")
            for k in launched:
                launched[k] += got[k]
            occ = sorted({r.explain["megabatch"]["occupancy"]
                          for r in results.values()})
            say(f"phase 5 {name} coalesced {run_kind}: {queries} queries in "
                f"{batches} batches (occupancy {occ}), {dispatches} shard "
                f"batches, launches "
                f"{ {k: v for k, v in got.items() if v} }, rows equal the "
                f"numpy oracle; {dt:.4f} s, {queries / dt:.3f} queries/s, "
                f"{queries * n_rows / dt:.1f} rows/s, "
                f"{serial_s[run_kind] / dt:.3f}x the serial {run_kind} rate "
                f"({card})")
    finally:
        cl.execute("SET citus.megabatch_window_ms = 0")
    return launched


#: profiled runs of a warm query before phase 4 gives up measuring it
PROFILE_TRIES = 10
#: seconds a profiler session idles before and after the query: in the
#: first run, and in each run after it
PROFILE_PAUSE_S = 0.02
PROFILE_RETRY_PAUSE_S = 2.0
#: sessions ``profile_phase10`` runs, at most, until every query's
#: window holds the kernels its wrappers launched
PROFILE_SESSIONS = 5

#: name fragments of the port's kernels as the profiler reports them
PORT_KERNELS = ("fold_shared_q", "fold_global_q", "hash_insert", "fm_kernel",
                "fm_batched_kernel", "hash_merge", "rd_direct", "rd_private",
                "rd_fill_topk", "partition", "pp_pass",
                "pp_fill", "sorted_join", "mc_kernel")


def device_kernels(cl, sql, pause: float = PROFILE_PAUSE_S) -> tuple:
    """The card's work for one more run of ``sql`` (SQL text, or a
    callable that runs the query), from torch.profiler's
    CUDA activity, the session idling ``pause`` s at each end: -> (the
    port's kernels, other kernels, copies and sets, {name: count} of the
    other kernels, the port's launches the wrappers counted in that run,
    where the device records lie in the session)."""
    import collections
    import torch
    from torch.profiler import ProfilerActivity, profile
    counters = launch_counters()
    before = sum(f.launches for f in counters.values())
    torch.cuda.synchronize()
    # a pause at each end of the session: without one, a short session
    # lost its whole device record in 2 of 1,500 runs, with 20 ms in none
    # (scripts/profiler_sessions.py, NVIDIA H100 80GB HBM3, torch 2.11)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(pause)
        sql() if callable(sql) else cl.execute(sql)
        torch.cuda.synchronize()
        time.sleep(pause)
    session_ms = (time.perf_counter() - t0) * 1e3
    launched = sum(f.launches for f in counters.values()) - before
    port = other = copies = 0
    names = collections.Counter()
    starts = []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        starts.append(e.time_range.start / 1e3)
        n = e.name
        if n.lower().startswith(("memcpy", "memset")):
            copies += 1
        elif any(k in n for k in PORT_KERNELS):
            port += 1
        else:
            other += 1
            names[n] += 1
    where = (f"device records at {min(starts):.3f}-{max(starts):.3f} ms"
             if starts else "no device record")
    where += (f" of a {session_ms:.3f} ms session idling {pause:g} s at "
              f"each end")
    return port, other, copies, dict(names), launched, where


def profiled_kernels(cl, qname: str, sql, phase: str = "phase 4") -> tuple:
    """``device_kernels`` of the first of up to PROFILE_TRIES profiled
    runs whose record holds every kernel of the port that its wrappers
    launched.  The profiler loses all or part of a session's device
    records now and then (scripts/profiler_sessions.py); late in a long
    process it lost them in most sessions under a second for seconds at
    a time, while sessions idling 2 s at each end kept theirs.  So a run
    with fewer is run again in such a session.  -> (port's kernels,
    other kernels, copies and sets, {name: count} of the others, the
    runs it took, where its device records lay); raises when no run
    recorded them all."""
    pause = PROFILE_PAUSE_S
    for tries in range(1, PROFILE_TRIES + 1):
        port, other, copies, names, launched, where = device_kernels(
            cl, sql, pause)
        if port >= launched:
            return port, other, copies, names, tries, where
        say(f"{phase} {qname} warm: profiled run {tries} recorded {port} "
            f"of the port's {launched} kernels, {other} other, {copies} "
            f"copies and sets; {where}")
        pause = PROFILE_RETRY_PAUSE_S
    raise AssertionError(
        f"{qname} warm: torch.profiler recorded fewer kernels than were "
        f"launched in {PROFILE_TRIES} runs (the last: {port} of the "
        f"port's {launched}, {other} other, {copies} copies): the device "
        f"kernels per batch are not measured")


#: phase 4's warm seconds of a query on the single stream, set beside
#: phase 9's over the mesh: the median of WARM_REPEATS more runs
SINGLE_STREAM_WARM_S: dict = {}
WARM_REPEATS = 7


def median_warm_s(cl, sql: str) -> float:
    """The median wall seconds of WARM_REPEATS more runs of ``sql``, each
    synchronized."""
    import torch
    times = []
    for _ in range(WARM_REPEATS):
        t0 = time.perf_counter()
        cl.execute(sql)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def run_checked(cl, qname: str, sql: str, want: list, n_rows: int,
                run_kind: str, kernel: str = "scan_agg_fold") -> int:
    """Run one query; its rows must equal the oracle's, ``kernel`` must
    launch once per batch of the query and no other kernel may launch.
    A warm run goes once more under torch.profiler: the card must run
    exactly one kernel of the port per batch and no other kernel (no
    PyTorch elementwise kernel; for a projection, no row mask filled
    per batch).  A warm run under 0.1 s also keeps the median of
    WARM_REPEATS more runs, set beside phase 9's.  -> kernel launches."""
    import torch
    from citus_tpu_torch.ops import cuda_build
    counters = launch_counters()
    for f in counters.values():
        f.launches = 0
    builds0 = dict(cuda_build.BUILDS)
    t0 = time.perf_counter()
    r = cl.execute(sql)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = {k: f.launches for k, f in counters.items()}
    pipe = r.explain["pipeline"]
    batches = pipe["filter_dispatches" if kernel == "filter_mask"
                   else "fused_dispatches"]
    if got[kernel] != batches or got[kernel] == 0:
        raise AssertionError(f"{qname} {run_kind}: {got[kernel]} {kernel} "
                             f"launches for {batches} batches")
    others = {k: v for k, v in got.items() if k != kernel and v}
    if others:
        raise AssertionError(f"{qname} {run_kind}: other kernels launched: "
                             f"{others}")
    if r.rows != want:
        raise AssertionError(f"{qname} {run_kind}: rows differ from the "
                             f"numpy oracle:\n{r.rows[:20]}\n{want[:20]}")
    extra = (f", nvcc builds during the run "
             f"{cuda_build.BUILDS['count'] - builds0['count']} "
             f"({cuda_build.BUILDS['seconds'] - builds0['seconds']:.3f} s)")
    if run_kind == "warm":
        if dt < 0.1:
            SINGLE_STREAM_WARM_S[qname] = median_warm_s(cl, sql)
        port, other, copies, names, tries, where = profiled_kernels(
            cl, qname, sql)
        if port != batches or other:
            raise AssertionError(
                f"{qname} warm: the profiler saw {port} kernels of the "
                f"port for {batches} batches and {other} others {names}")
        extra += (f", device kernels per query (torch.profiler): "
                  f"{port} of the port ({port / batches:g} a batch), "
                  f"{other} other, {copies} copies and sets (profiled run "
                  f"{tries} of at most {PROFILE_TRIES}; {where})")
    if kernel == "hash_agg_insert":
        extra += (f", hash_slots {pipe['hash_slots']}, hash_occupancy_pct "
                 f"{pipe['hash_occupancy_pct']}, hash_spilled_rows "
                 f"{pipe['hash_spilled_rows']}, host merge of the table "
                 f"{pipe['host_merge_ms']} ms, host merge of spilled rows "
                 f"{pipe['hash_spill_merge_ms']} ms")
    say(f"phase 4 {qname} {run_kind} at {n_rows} rows: {len(r.rows)} rows "
        f"equal the numpy oracle; {n_rows / dt:.1f} rows/s ({dt:.4f} s), "
        f"{kernel} launches {got[kernel]} for {batches} batches, "
        f"stream_window_peak_bytes {pipe.get('stream_window_peak_bytes', 0)}, "
        f"host_decode_ms {pipe.get('host_decode_ms', 0)}, "
        f"device_ms {pipe.get('device_ms', 0)}{extra}")
    return got[kernel]


# ------------------------------------------------------------- main


def phase3_fold(device, plans, rows: list) -> None:
    """scan_agg_fold (the kernel generated for each plan) against its
    plain version; appends its JSON row."""
    import torch
    from citus_tpu_torch.ops.scan_agg_fold import fold_plain, scan_agg_fold
    calls = plans["fold_calls"]
    cases = [("q6 scalar G=1", calls["q6"], False),
             ("q1 direct G=12", calls["q1"], False)]
    for all_false in (False, True):
        cases.append((f"direct G=65536{' all-false mask' if all_false else ''}",
                      synthetic_global_case(device, FOLD_N + 3, 65536, 21,
                                            all_false), False))
    cases.append(("signed float64 sums near cancellation, G=4097",
                  cancellation_case(device, FOLD_N + 3, 4096, 27), True))
    max_err, main, q6 = 0.0, None, None
    for name, call, abs_of in cases:
        err = compare_fold(name, call, scan_agg_fold, fold_plain, abs_of)
        max_err = max(max_err, err)
        regime = regime_name(scan_agg_fold.last_regime)
        kc = clone_call(call)
        ms = time_cuda(lambda: scan_agg_fold(*kc))
        pc = clone_call(call)
        plain_ms = time_cuda(lambda: fold_plain(*pc), reps=3)
        nbytes, nops = fold_bytes(call), fold_ops(call)
        bound_ms = max(nbytes / HBM_BYTES_PER_S, nops / SIMT_OPS_PER_S) * 1e3
        # yardstick: ONE index_add_ of one int64 sum at the same N, G
        G = call[0].n_groups
        acc = torch.zeros(G, dtype=torch.int64, device=device)
        n = fold_masks(call).numel()
        gid = torch.randint(0, G, (n,), device=device)
        val = torch.randint(0, 1000, (n,), device=device)
        lib_ms = time_cuda(lambda: acc.index_add_(0, gid, val))
        if name.startswith("q1"):
            main = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms)
        if name.startswith("q6"):
            q6 = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms)
        say(f"phase 3 scan_agg_fold [{name}]: N={n} G={G} "
            f"ops={len(call[0].ops)} columns {list(call[0].row.columns)} "
            f"regime={regime} agrees (max abs err of float sums "
            f"{err!r}{'; sums held to 1e-12 x their sum of magnitudes' if abs_of else ''}); "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({nbytes} B at 3.35 TB/s: row mask, the "
            f"sectors of the scan columns and validity the rows read, "
            f"registers), library yardstick "
            f"(one int64 index_add_, one op) {lib_ms:.4f} ms")
    say(f"phase 3 scan_agg_fold: Q1 {main['ms']:.4f} ms (bound "
        f"{main['bound_ms']:.4f}), Q6 {q6['ms']:.4f} ms (bound "
        f"{q6['bound_ms']:.4f}, plain {q6['plain_ms']:.4f})")
    rows.append({"name": "scan_agg_fold", "route": "cuda",
                 "source": "citus_tpu_torch/csrc/scan_agg_fold.cu",
                 "replaces": "citus_tpu/ops/scan_agg.py:277",
                 "max_abs_err": max_err, **main, "bound_by": "bytes",
                 "library_ms": None})


def phase3_hash(device, cl, rows: list) -> None:
    """hash_agg_insert against its plain version: the main path's first
    SF1 shard batch of bench.py's hash GROUP BY on 2^20 slots, the same
    rows with dbgen's clustered order keys, and the adversarial case;
    appends its JSON row."""
    import torch
    from citus_tpu_torch.ops.hash_agg_insert import (
        hash_agg_insert, insert_plain,
    )
    main_call, n_real = main_path_hash_call(cl, device)
    cases = [(f"bench hash GROUP BY l_orderkey, one shard ({n_real} rows)",
              main_call),
             ("the same rows, l_orderkey in runs of 1-7 rows as dbgen "
              "writes it", clustered_hash_call(main_call, n_real))]
    for all_false in (False, True):
        cases.append((f"adversarial 3 keys S=1000"
                      f"{' all-false mask' if all_false else ''}",
                      adversarial_hash_call(device, FOLD_N + 3, 1000, 31,
                                            all_false)))
    max_err, main = 0.0, None
    for name, call in cases:
        err = compare_hash(name, call, hash_agg_insert, insert_plain)
        max_err = max(max_err, err)
        prog, table, cols, params, mask = call
        n_keys, ops = len(prog.exprs.keys), prog.ops
        work = clone_table(table)
        ms = time_cuda_fresh(
            lambda: hash_agg_insert(prog, work, cols, params, mask),
            lambda: copy_table_(work, table))
        plain_ms = time_cuda_fresh(
            lambda: insert_plain(prog, work, cols, params, mask),
            lambda: copy_table_(work, table), reps=3)
        copy_table_(work, table)
        spill = hash_agg_insert(prog, work, cols, params, mask)
        torch.cuda.synchronize()
        placed = int(work.rows.sum())
        occupied = int((work.rows > 0).sum())
        nbytes = hash_bytes(call, occupied)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        # slot traffic: every placed row touches its slot's record (the
        # claim word, keys, flags, registers and row count) at random
        record = table.records.shape[-1] * 8
        S = table.slots
        acc = torch.zeros(S, dtype=torch.int64, device=device)
        n = mask.numel()
        slot = torch.randint(0, S, (n,), device=device)
        val = torch.randint(0, 1000, (n,), device=device)
        lib_ms = time_cuda(lambda: acc.index_add_(0, slot, val))
        if main is None:
            main = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms)
        say(f"phase 3 hash_agg_insert [{name}]: N={n} S={S} "
            f"keys={n_keys} ops={len(ops)} agrees (merged groups of "
            f"table and spill; max abs err of float sums {err!r}); placed "
            f"{placed}, spilled {int(spill.sum())}, occupied "
            f"{occupied} slots; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({nbytes} B at "
            f"3.35 TB/s: row mask, the sectors of the scan columns and "
            f"validity the rows read, the spill mask, each occupied slot "
            f"read and written once); slot traffic: one {record}-byte "
            f"record a placed row, {placed * record} B; library yardstick (one int64 "
            f"index_add_ into S slots, one op) {lib_ms:.4f} ms")
    rows.append({"name": "hash_agg_insert", "route": "cuda",
                 "source": "citus_tpu_torch/csrc/hash_agg_insert.cu",
                 "replaces": "citus_tpu/ops/hash_agg.py:179",
                 "max_abs_err": max_err, **main, "bound_by": "bytes",
                 "library_ms": None})


def phase3_merge(device, tmp: str, rows: list) -> None:
    """hash_agg_merge against its plain version: R1's merge of one SF1
    shard batch's table into another's (2^20 slots each), and the
    adversarial cases; appends its JSON row."""
    import torch
    from citus_tpu_torch.ops.hash_agg_merge import (
        hash_agg_merge, hash_agg_merge_plain,
    )
    main_call, n_real = main_path_merge_call(device, tmp)
    cases = [(f"R1 GROUP BY l_partkey, a shard's table into another's "
              f"({n_real} rows each)", main_call),
             ("adversarial 3 keys S=1000, M=1003",
              adversarial_merge_call(device, FOLD_N + 3, 1000, 1003, 37)),
             ("adversarial all-empty entries, M=1003",
              adversarial_merge_call(device, FOLD_N + 3, 1000, 1003, 37,
                                     empty=True))]
    max_err, main = 0.0, None
    for name, call in cases:
        err = compare_merge(name, call, hash_agg_merge, hash_agg_merge_plain)
        max_err = max(max_err, err)
        table, keys, parts, erows, kinds = call
        work = clone_table(table)
        reset = lambda: copy_table_(work, table)  # noqa: E731
        ms = time_cuda_fresh(
            lambda: hash_agg_merge(work, keys, parts, erows, kinds), reset)
        plain_ms = time_cuda_fresh(
            lambda: hash_agg_merge_plain(work, keys, parts, erows, kinds),
            reset, reps=3)
        copy_table_(work, table)
        spill = hash_agg_merge(work, keys, parts, erows, kinds)
        torch.cuda.synchronize()
        occupied = int((erows > 0).sum())
        spilled = int(spill.sum())
        claims = int((work.rows > 0).sum()) - int((table.rows > 0).sum())
        matches = occupied - spilled - claims
        nbytes = merge_bytes(call, claims, matches)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        S, M = table.slots, erows.numel()
        acc = torch.zeros(S, dtype=torch.int64, device=device)
        slot = torch.randint(0, S, (M,), device=device)
        val = torch.randint(0, 1000, (M,), device=device)
        lib_ms = time_cuda(lambda: acc.index_add_(0, slot, val))
        if main is None:
            main = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms)
        say(f"phase 3 hash_agg_merge [{name}]: M={M} S={S} keys={len(keys)} "
            f"ops={len(kinds)} agrees (merged groups of table and spilled "
            f"entries; max abs err of float sums {err!r}); occupied entries "
            f"{occupied}: {matches} matched, {claims} claimed, {spilled} "
            f"spilled; kernel {ms:.4f} ms (its wrapper's call), plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({nbytes} B at 3.35 TB/s: every entry's emptiness marker and "
            f"spill flag, an occupied entry once, a match's claim word and "
            f"keys read and its states read and written, a claim's slot "
            f"read and written); library yardstick (one "
            f"int64 index_add_ of the M entries into S slots) {lib_ms:.4f} ms")
    rows.append({"name": "hash_agg_merge", "route": "cuda",
                 "source": "citus_tpu_torch/csrc/hash_agg_merge.cu",
                 "replaces": "citus_tpu/ops/hash_agg.py:239 "
                             "build_fused_entry_merge (jit_hash_merge)",
                 "max_abs_err": max_err, **main, "bound_by": "bytes",
                 "library_ms": None})


def filter_cases(device, plans) -> list:
    """-> [(name, FilterProgram, (cols, params, row_mask))]: the
    one-query predicate (B4) over FOLD_N rows in P1's, Q6's and the
    synthetic predicate's columns and C1's predicate over every node
    kind, the last 1,000 rows padding."""
    line = lineitem_filter_columns(plans["physical"])
    out = []
    for name, key, cols in (("P1", "p1", line), ("Q6", "q6", line),
                            ("syn", "syn", syn_columns(FOLD_N, 41)),
                            ("C1all", "c1_all", plans["events"])):
        prog, params = plans["filters"][key]
        out.append((name, prog, filter_call(prog, cols, params, device,
                                            FOLD_N)))
    return out


def misaligned_filter_call(call, offset: int = 3):
    """``call``'s first N - ``offset`` rows of every column and validity
    as views starting ``offset`` elements into their buffers (no base
    16-byte aligned, nor the row count a multiple of 16), and no row
    mask: -> (cols, params, None)."""
    import torch
    cols, params, row_mask = call
    n = row_mask.numel() - offset

    def view(t):
        buf = torch.empty(n + offset, dtype=t.dtype, device=t.device)
        buf[offset:] = t[:n]
        return buf[offset:]
    return ({c: (view(v), None if m is None else view(m))
             for c, (v, m) in cols.items()}, params, None)


def phase3_filter(device, plans, rows: list) -> None:
    """filter_mask against its plain version on FOLD_N rows: P1's and
    Q6's predicates over generated lineitem, the synthetic one and C1's
    over every node kind, then each over views that start 3 elements
    into their buffers, with no row mask; appends its JSON row."""
    import torch
    from citus_tpu_torch.ops.filter_mask import filter_mask, filter_mask_plain
    main = None
    cases = filter_cases(device, plans)
    cases += [(f"{name} misaligned views, no row mask", prog,
               misaligned_filter_call(call))
              for name, prog, call in cases]
    for name, prog, call in cases:
        got = filter_mask(prog, *call)
        want = filter_mask_plain(prog, *call)
        if not torch.equal(got, want):
            raise AssertionError(f"filter_mask [{name}]: masks differ in "
                                 f"{int((got != want).sum())} rows")
        ms = time_cuda(lambda: filter_mask(prog, *call))
        plain_ms = time_cuda(lambda: filter_mask_plain(prog, *call))
        nbytes = filter_bytes(call[0], call[2])
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        first = next(iter(call[0].values()))[0]
        lib_ms = time_cuda(lambda: torch.ge(first, 1))
        if main is None:
            main = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms)
        say(f"phase 3 filter_mask [{name}]: N={got.numel()} columns "
            f"{list(prog.columns)} params {len(call[1])}: masks identical "
            f"({int(got.sum())} rows pass); kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({nbytes} B at "
            f"3.35 TB/s), library yardstick (one torch.ge over one column, "
            f"one op) {lib_ms:.4f} ms")
    rows.append({"name": "filter_mask", "route": "cuda",
                 "source": "citus_tpu_torch/ops/expr_codegen.py",
                 "replaces": "citus_tpu/executor/executor.py:971",
                 "max_abs_err": 0.0, **main, "bound_by": "bytes",
                 "library_ms": None})


# ------------------------------------------------------------- phase 3, B5


def family_filter(device, plan, params):
    """-> (FilterProgram, StackedParams) of one family's WHERE, as the
    megabatch path builds them."""
    from citus_tpu_torch.executor.executor import _build_filter_mask, _params_env
    from citus_tpu_torch.ops.filter_mask import stack_params
    prog = _build_filter_mask(plan, params[0])
    return prog, stack_params(prog, [_params_env(plan, p) for p in params],
                              device)


def padded_batch(device, plan, physical: dict, valids=None):
    """One batch of the generated rows (FOLD_N on the card) in the plan's
    scan columns on ``device``: (cols, valids, row_mask).  ``valids``:
    the columns' validity (default: no nulls)."""
    import torch
    from citus_tpu_torch.executor.batches import pad_to_batch
    n = len(next(iter(physical.values())))
    values = {k: physical[k] for k in plan.scan_columns}
    masks = {k: np.ones(n, bool) if valids is None else valids[k]
             for k in plan.scan_columns}
    hb = pad_to_batch(plan.bound.table, plan, values, masks, n, n, 0)
    return (tuple(torch.from_numpy(a).to(device) for a in hb.cols),
            tuple(torch.from_numpy(a).to(device) for a in hb.valids),
            torch.from_numpy(hb.row_mask).to(device))


def predicate_columns(plan, prog, cols, valids) -> dict:
    env = dict(zip(plan.scan_columns, zip(cols, valids)))
    return {c: env[c] for c in prog.columns}


def batched_fold_call(device, plans, name: str, repeat: int = 1):
    """The batched fold's main-path inputs for family ``name`` (Q6 or Q1)
    on one FOLD_N-row batch: the family's fold program, fresh [Q, G]
    registers, the scan columns and every variant's mask from the
    batched predicate kernel.  ``repeat`` > 1 sends each variant that
    many times (Q = 8 * repeat).  -> the arguments of
    ``scan_agg_fold_batched``."""
    from citus_tpu_torch.executor.megabatch import (
        _empty_stacked_partials, _fold_program,
    )
    from citus_tpu_torch.ops.filter_mask import filter_mask_batched
    plan, params = plans["families"][name]
    params = params * repeat
    cols, valids, row_mask = padded_batch(device, plan, plans["physical"])
    prog, stacked = family_filter(device, plan, params)
    masks = filter_mask_batched(
        prog, predicate_columns(plan, prog, cols, valids), stacked, row_mask)
    regs, rows = _empty_stacked_partials(plan, len(params), device)
    return (_fold_program(plan, params[0], device), regs, rows,
            dict(zip(plan.scan_columns, zip(cols, valids))), masks)


def batched_filter_cases(device, plans,
                         names=("Q6", "Q1", "H", "P", "C1", "C1all")) -> list:
    """-> [(name, FilterProgram, (cols, StackedParams, row_mask))]: the
    batched predicate (B5a) of each phase-5 family ``names`` under its
    Q_BATCH parameter sets over one FOLD_N-row batch (generated
    lineitem; the events table for C1's families)."""
    ev = plans["events"]
    out = []
    for name in names:
        plan, params = plans["families"][name]
        if name.startswith("C1"):
            cols, valids, row_mask = padded_batch(
                device, plan, {k: v for k, (v, _) in ev.items()},
                {k: m for k, (_, m) in ev.items()})
        else:
            cols, valids, row_mask = padded_batch(device, plan,
                                                  plans["physical"])
        prog, stacked = family_filter(device, plan, params)
        out.append((name, prog, (predicate_columns(plan, prog, cols, valids),
                                 stacked, row_mask)))
    return out


def phase3_batched_filter(device, plans, rows: list) -> None:
    """filter_mask_batched against its plain version: each phase-5
    family's predicate under its Q_BATCH parameter sets over FOLD_N
    generated lineitem rows, Q6's family at Q = 32 too, and Q6's over
    views that start 3 elements into their buffers, with no row mask;
    appends its JSON row."""
    import torch
    from citus_tpu_torch.ops.filter_mask import (
        filter_mask_batched, filter_mask_batched_plain,
    )
    main = None
    cases = [(f"{name} family", prog, call)
             for name, prog, call in batched_filter_cases(device, plans)]
    plan, params = plans["families"]["Q6"]
    prog, stacked = family_filter(device, plan, params * 4)
    q6 = cases[0][2]
    cases.append(("Q6 family at Q = 32", prog, (q6[0], stacked, q6[2])))
    mis = misaligned_filter_call((q6[0], q6[1], q6[2]))
    cases.append(("Q6 family, misaligned views, no row mask", cases[0][1],
                  mis))
    for name, prog, call in cases:
        fcols, stacked, row_mask = call
        got = filter_mask_batched(prog, fcols, stacked, row_mask)
        want = filter_mask_batched_plain(prog, fcols, stacked, row_mask)
        if not torch.equal(got, want):
            raise AssertionError(f"filter_mask_batched [{name}]: masks "
                                 f"differ in {int((got != want).sum())} "
                                 "places")
        ms = time_cuda(lambda: filter_mask_batched(prog, fcols, stacked,
                                                   row_mask))
        plain_ms = time_cuda(lambda: filter_mask_batched_plain(
            prog, fcols, stacked, row_mask), reps=3)
        q, n = got.shape
        # the predicate's columns and the row mask read once, Q masks out
        nbytes = filter_bytes(fcols, row_mask) - n + q * n
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        first = next(iter(fcols.values()))[0]
        thr = torch.arange(q, device=device, dtype=first.dtype)
        lib_ms = time_cuda(lambda: torch.ge(first.unsqueeze(0),
                                            thr.unsqueeze(1)))
        if main is None:
            main = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms)
        say(f"phase 3 filter_mask_batched [{name}]: Q={q} N={n} "
            f"columns {list(prog.columns)}: masks identical "
            f"({got.sum(dim=1).tolist()} rows pass); kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({nbytes} B "
            f"at 3.35 TB/s), library yardstick (one broadcast torch.ge of "
            f"one column against Q thresholds, [Q, N] out) {lib_ms:.4f} ms")
    rows.append({"name": "filter_mask_batched", "route": "cuda",
                 "source": "citus_tpu_torch/ops/expr_codegen.py",
                 "replaces": "citus_tpu/executor/megabatch.py:518",
                 "max_abs_err": 0.0, **main, "bound_by": "bytes",
                 "library_ms": None})


def synthetic_batched_global_case(device, q: int = 3):
    """The G = 65,536 fold of ``synthetic_global_case`` for ``q``
    queries with different masks: the batched fold's global-atomics
    regime."""
    import torch
    prog, regs, rows, cols, _params, mask = synthetic_global_case(
        device, FOLD_N + 3, 65536, 21, False)
    masks = torch.stack([mask, ~mask] + [mask] * (q - 2)).contiguous()
    return (prog, [r.unsqueeze(0).repeat(q, 1).contiguous() for r in regs],
            rows.unsqueeze(0).repeat(q, 1).contiguous(), cols, masks)


def phase3_batched_fold(device, plans, rows: list) -> None:
    """scan_agg_fold_batched against its plain version: the Q6 (scalar)
    and Q1 (direct, G = 12) families at Q = Q_BATCH on one padded
    FOLD_N-row batch, the Q1 family at Q = 32 (a 52 KB shared-memory
    table, past the 48 KB default), and a G = 65,536 fold of 3 queries
    (global atomics); appends its JSON row."""
    import torch
    from citus_tpu_torch.ops.scan_agg_fold import (
        fold_batched_plain, scan_agg_fold_batched,
    )
    max_err, main = 0.0, None
    cases = [("Q6 family", lambda: batched_fold_call(device, plans, "Q6"), 1),
             ("Q1 family", lambda: batched_fold_call(device, plans, "Q1"), 1),
             ("Q1 family x4 (Q=32)",
              lambda: batched_fold_call(device, plans, "Q1", repeat=4), 1),
             ("synthetic direct G=65536",
              lambda: synthetic_batched_global_case(device), 0)]
    for name, make, want_regime in cases:
        call = make()
        err = compare_fold(f"{name} batched", call, scan_agg_fold_batched,
                           fold_batched_plain)
        max_err = max(max_err, err)
        if scan_agg_fold_batched.last_regime != want_regime:
            raise AssertionError(
                f"scan_agg_fold_batched [{name}]: regime "
                f"{scan_agg_fold_batched.last_regime}, not {want_regime}")
        regime = regime_name(scan_agg_fold_batched.last_regime)
        kc = clone_call(call)
        ms = time_cuda(lambda: scan_agg_fold_batched(*kc))
        pc = clone_call(call)
        plain_ms = time_cuda(lambda: fold_batched_plain(*pc), reps=3)
        nbytes = fold_bytes(call)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        masks, G = fold_masks(call), call[0].n_groups
        q, n = masks.shape
        acc = torch.zeros(q * G, dtype=torch.int64, device=device)
        gid = torch.randint(0, q * G, (n,), device=device)
        val = torch.randint(0, 1000, (n,), device=device)
        lib_ms = time_cuda(lambda: acc.index_add_(0, gid, val))
        if name == "Q1 family":
            main = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms)
        say(f"phase 3 scan_agg_fold_batched [{name}]: Q={q} N={n} "
            f"G={G} ops={len(call[0].ops)} regime={regime} agrees (max abs "
            f"err of float sums {err!r}); kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({nbytes} B at "
            f"3.35 TB/s: Q x N masks, the sectors of the key and "
            f"argument columns holding a row some query passes, "
            f"registers), "
            f"library yardstick (one int64 index_add_ into Q x G slots, one "
            f"op) {lib_ms:.4f} ms")
    rows.append({"name": "scan_agg_fold_batched", "route": "cuda",
                 "source": "citus_tpu_torch/csrc/scan_agg_fold_batched.cu",
                 "replaces": "citus_tpu/executor/megabatch.py:343",
                 "max_abs_err": max_err, **main, "bound_by": "bytes",
                 "library_ms": None})


def batched_hash_call(cl, device):
    """The batched insert's main-path inputs for the H family: the
    family's insert program, Q_BATCH fresh tables of the size
    citus.hash_agg_slots = auto gives, the first padded SF1 shard
    batch's scan columns and every variant's mask from the batched
    predicate kernel: the arguments of ``hash_agg_insert_batched``."""
    import torch
    from citus_tpu_torch.executor.executor import (
        _hash_key_dtypes, _hash_slots, _iter_padded_batches,
    )
    from citus_tpu_torch.executor.megabatch import _fold_program
    from citus_tpu_torch.ops.filter_mask import filter_mask_batched
    from citus_tpu_torch.ops.hash_agg import empty_hash_state
    cl.execute("SET citus.hash_agg_slots = auto")
    planned = [plan_as_cluster_does(cl, sql) for sql, _ in
               families()["H"][1]]
    plan, params = planned[0][0], [p for _, p in planned]
    if plan.group_mode.kind != "hash_host":
        raise AssertionError(f"H family plans to {plan.group_mode.kind}")
    S = _hash_slots(cl.catalog, plan, cl.settings)
    key_dtypes = _hash_key_dtypes(plan, {})
    batches = _iter_padded_batches(cl.catalog, plan, cl.settings)
    hb = next(batches)
    batches.close()
    cols = tuple(torch.from_numpy(a).to(device) for a in hb.cols)
    valids = tuple(torch.from_numpy(a).to(device) for a in hb.valids)
    row_mask = torch.from_numpy(hb.row_mask).to(device)
    prog, stacked = family_filter(device, plan, params)
    masks = filter_mask_batched(
        prog, predicate_columns(plan, prog, cols, valids), stacked, row_mask)
    table = empty_hash_state(plan, S, key_dtypes, device,
                             n_queries=len(params))
    return (_fold_program(plan, params[0], device, key_dtypes), table,
            dict(zip(plan.scan_columns, zip(cols, valids))), masks), hb.n_rows


def phase3_batched_hash(device, cl, rows: list) -> None:
    """hash_agg_insert_batched against its plain version: the H family
    at Q = Q_BATCH on the first SF1 shard batch into Q tables of 2^20
    slots.  Per query: the merged groups of table and spill agree, each
    key sits in at most one slot, placed + spilled = masked rows.
    Appends its JSON row."""
    import torch
    from citus_tpu_torch.ops.hash_agg_insert import (
        hash_agg_insert_batched, insert_batched_plain,
    )
    from citus_tpu_torch.ops.hash_agg import record_views
    call, n_real = batched_hash_call(cl, device)
    prog, table, cols, masks = call
    ops, n_keys, q = prog.ops, len(prog.exprs.keys), masks.shape[0]
    # and the same inputs into Q tables of 1,000 slots: most rows spill
    small = record_views(table.records[:1000].clone(),
                         [v.dtype for v in table.key_values],
                         [p.dtype for p in table.partials])
    max_err = 0.0
    for case, tab in (("S=2^20", table), ("S=1000", small)):
        err, kt, ks = compare_hash_batched(
            f"H family {case}", (prog, tab, cols, masks),
            hash_agg_insert_batched, insert_batched_plain)
        max_err = max(max_err, err)
        say(f"phase 3 hash_agg_insert_batched [H family, {case}]: per query "
            f"placed {kt.rows.sum(dim=1).tolist()}, spilled "
            f"{ks.sum(dim=1).tolist()}, masked "
            f"{masks.sum(dim=1).tolist()}: agrees with the plain version")
        del kt
    work = clone_table(table)
    ms = time_cuda_fresh(
        lambda: hash_agg_insert_batched(prog, work, cols, masks),
        lambda: copy_table_(work, table))
    plain_ms = time_cuda_fresh(
        lambda: insert_batched_plain(prog, work, cols, masks),
        lambda: copy_table_(work, table), reps=3)
    copy_table_(work, table)
    hash_agg_insert_batched(prog, work, cols, masks)
    occupied = int((work.rows > 0).sum())
    nbytes = hash_bytes(call, occupied)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    S = table.slots
    n = masks.shape[1]
    acc = torch.zeros(q * S, dtype=torch.int64, device=device)
    slot = torch.randint(0, q * S, (n,), device=device)
    val = torch.randint(0, 1000, (n,), device=device)
    lib_ms = time_cuda(lambda: acc.index_add_(0, slot, val))
    say(f"phase 3 hash_agg_insert_batched [H family, one SF1 shard batch "
        f"({n_real} rows)]: Q={q} N={n} S={S} keys={n_keys} "
        f"ops={len(ops)} agrees per query (merged groups of table and "
        f"spill; max abs err of float sums {max_err!r}); "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({nbytes} B at 3.35 TB/s: Q masks and "
        f"Q spill masks, the sectors of the key and argument columns "
        f"holding a row some query passes, each of the "
        f"{occupied} occupied slots of the Q tables read and written "
        f"once), kernel at {ms / bound_ms:.1f}x its bound, library yardstick (one int64 index_add_ into Q x S "
        f"slots, one op) {lib_ms:.4f} ms")
    rows.append({"name": "hash_agg_insert_batched", "route": "cuda",
                 "source": "citus_tpu_torch/csrc/hash_agg_insert_batched.cu",
                 "replaces": "citus_tpu/executor/megabatch.py:435",
                 "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": bound_ms, "bound_by": "bytes",
                 "library_ms": None})


# ------------------------------------------- sketch aggregates and rollups

#: TPC-H: S = SF * 10,000 suppliers, P = SF * 200,000 parts
SUPPLIERS, PARTS = 10_000, 200_000
#: the sketch table: TPC-H lineitem's columns of the sketch queries and
#: the rollup, distributed by l_suppkey (a rollup's group columns must
#: hold the source's distribution column); l_quantity holds TPC-H's
#: integral quantities as bigint, the type a rollup sum takes
S_DDL = """CREATE TABLE lineitem (
        l_orderkey bigint NOT NULL, l_partkey bigint,
        l_suppkey bigint NOT NULL, l_quantity bigint,
        l_extendedprice decimal(12,2), l_shipdate date)"""

S1 = """SELECT count(*), approx_count_distinct(l_orderkey),
       approx_percentile(0.5) WITHIN GROUP (ORDER BY l_extendedprice),
       approx_top_k(l_suppkey, 10)
FROM lineitem
WHERE l_shipdate >= date '1995-01-01' AND l_shipdate < date '1996-01-01'"""

#: phase 5's S family: S1 over one ship year each, 1992-1998, and 1995-H2
S_RANGES = [((y, 1, 1), (y + 1, 1, 1)) for y in range(1992, 1999)] \
    + [((1995, 7, 1), (1996, 1, 1))]

ROLLUP_AGGS = ("count(*), sum(l_quantity), approx_count_distinct(l_partkey), "
               "approx_percentile(l_extendedprice), approx_top_k(l_partkey)")
DASHBOARD = ("SELECT l_suppkey, count(*), approx_count_distinct(l_partkey) "
             "FROM lineitem GROUP BY l_suppkey")
#: rows COPYed after the backfill, in DELTA_BATCHES batches of the
#: default citus.rollup_max_batch_rows
#: phase 6's CDC rows after the backfill, COPYed in DELTA_BATCHES
#: batches (halved from 262,144 in 4 to keep the script under its time
#: limit with phase 11)
DELTA_ROWS, DELTA_BATCHES = 131_072, 2
I64_MIN = np.iinfo(np.int64).min


def s_variant(lo: tuple, hi: tuple) -> str:
    head, _ = S1.split("WHERE")
    return (f"{head}WHERE l_shipdate >= date '{'%d-%02d-%02d' % lo}' "
            f"AND l_shipdate < date '{'%d-%02d-%02d' % hi}'")


def sketch_chunks(n_rows: int, seed: int, key_rows: int):
    """TPC-H dbgen's rules for these columns (spec 4.2.3): L_PARTKEY
    uniform in [1, P]; L_SUPPKEY one of the part's 4 suppliers,
    (partkey + i * (S/4 + (partkey - 1) / S)) mod S + 1; L_QUANTITY
    1..50; L_EXTENDEDPRICE = quantity * P_RETAILPRICE (cents:
    90000 + (partkey / 10) mod 20001 + 100 * (partkey mod 1000)); ship
    date = order date (1992-01-01 .. 1998-08-02) + 1..121 days; order
    keys as bench.py draws them.  Integer arrays, 1M-row chunks."""
    rng = np.random.default_rng(seed)
    lo, hi = _day(1992, 1, 1), _day(1998, 8, 2)
    for start in range(0, n_rows, 1_000_000):
        n = min(1_000_000, n_rows - start)
        pk = rng.integers(1, PARTS + 1, n)
        i = rng.integers(0, 4, n)
        sk = (pk + i * (SUPPLIERS // 4 + (pk - 1) // SUPPLIERS)) \
            % SUPPLIERS + 1
        qty = rng.integers(1, 51, n)
        retail = 90_000 + (pk // 10) % 20_001 + 100 * (pk % 1000)
        order = rng.integers(lo, hi + 1, n)
        yield {"orderkey": rng.integers(0, max(key_rows // 4, 1), n),
               "partkey": pk, "suppkey": sk, "qty": qty,
               "price": qty * retail,
               "ship": (order + rng.integers(1, 122, n)).astype(np.int32)}


def sketch_copy_columns(c: dict) -> dict:
    return {"l_orderkey": c["orderkey"], "l_partkey": c["partkey"],
            "l_suppkey": c["suppkey"], "l_quantity": c["qty"],
            "l_extendedprice": c["price"] / 100.0, "l_shipdate": c["ship"]}


def sketch_physical(c: dict) -> dict:
    """The engine's encoding of the generated rows (cents, days)."""
    return {"l_orderkey": c["orderkey"], "l_partkey": c["partkey"],
            "l_suppkey": c["suppkey"], "l_quantity": c["qty"],
            "l_extendedprice": c["price"], "l_shipdate": c["ship"]}


def load_sketch_table(ctt, path: str, n_rows: int):
    t0 = time.perf_counter()
    cl = ctt.Cluster(path)
    cl.execute(S_DDL)
    cl.execute("SELECT create_distributed_table('lineitem', 'l_suppkey', "
               f"{SHARDS})")
    chunks = []
    for c in sketch_chunks(n_rows, 11, n_rows):
        cl.copy_from("lineitem", columns=sketch_copy_columns(c))
        chunks.append(c)
    cols = {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}
    say(f"phase 4 load of the sketch table: {n_rows} rows (TPC-H "
        f"l_orderkey, l_partkey, l_suppkey, l_quantity, l_extendedprice, "
        f"l_shipdate; {SUPPLIERS} suppliers) in {SHARDS} shards by "
        f"l_suppkey in {time.perf_counter() - t0:.3f} s")
    return cl, cols


def _hll_regs(bits, ok, flat_base=None, groups=1):
    from citus_tpu_torch.planner import aggregates as agg
    b, rho = agg.hll_rho_buckets(np, bits.astype(np.int64), ok)
    regs = np.zeros(groups * agg.HLL_M, np.int32)
    np.maximum.at(regs, b if flat_base is None else flat_base * agg.HLL_M + b,
                  rho)
    return regs.reshape(groups, agg.HLL_M)


def oracle_s1(cols: dict, lo: tuple = (1995, 1, 1),
              hi: tuple = (1996, 1, 1)) -> list[tuple]:
    """S1's row from the generated arrays with the port's numpy bucket
    functions (planner/aggregates.py, the cpu backend's oracle)."""
    import math
    from citus_tpu_torch.planner import aggregates as agg
    m = (cols["ship"] >= _day(*lo)) & (cols["ship"] < _day(*hi))
    n = int(m.sum())
    if n == 0:
        return [(0, 0, None, None)]
    acd = agg.hll_estimate(_hll_regs(cols["orderkey"][m], np.ones(n, bool))[0])
    counts = np.bincount(agg.ddsk_bucket_indexes(np, cols["price"][m] / 100.0),
                         minlength=agg.DDSK_M)
    cum = np.cumsum(counts)
    pct = float(agg.ddsk_bucket_values()[int(np.searchsorted(
        cum, int(math.floor(0.5 * (n - 1))) + 1, side="left"))])
    sk = cols["suppkey"][m].astype(np.int64)
    tb = agg.topk_buckets(np, sk)
    tc = np.bincount(tb, minlength=agg.TOPK_M)
    tv = np.full(agg.TOPK_M, I64_MIN)
    np.maximum.at(tv, tb, sk)
    order = sorted(np.nonzero(tc)[0], key=lambda b: (-int(tc[b]), int(tv[b])))
    topk = json.dumps([{"value": int(tv[b]), "count": int(tc[b])}
                       for b in order[:10]])
    return [(n, acd, pct, topk)]


def sketch_families() -> dict:
    return {"S": ("scalar", [
        (s_variant(lo, hi), lambda c, lo=lo, hi=hi: oracle_s1(c, lo, hi))
        for lo, hi in S_RANGES])}


def sketch_plans(device, tmp: str, n: int = FOLD_N) -> dict:
    """The S1 plan over a small sketch table, its fold inputs on one
    padded batch of ``n`` generated rows (the main path's shapes: one
    SF1 shard of four pads to 2^21), and the S family's plan and
    parameters.  -> dict."""
    import torch
    import citus_tpu_torch as ctt
    from citus_tpu_torch.executor.batches import pad_to_batch
    from citus_tpu_torch.executor.kernel_cache import plan_fingerprint
    from citus_tpu_torch.executor.executor import _param_dtypes, _params_env
    from citus_tpu_torch.ops.scan_agg import (
        build_fold_inputs, empty_device_partials,
    )
    cl = ctt.Cluster(os.path.join(tmp, "sketch_plans"), device=device)
    cl.execute(S_DDL)
    cl.execute("SELECT create_distributed_table('lineitem', 'l_suppkey', "
               f"{SHARDS})")
    cl.copy_from("lineitem", columns=sketch_copy_columns(
        next(sketch_chunks(20_000, 3, 20_000))))
    chunks = list(sketch_chunks(n, 5, SF1_ROWS))
    physical = sketch_physical(
        {k: np.concatenate([ch[k] for ch in chunks]) for k in chunks[0]})
    plan, params = plan_as_cluster_does(cl, S1)
    if plan.group_mode.kind != "scalar":
        raise AssertionError(f"S1 plans to {plan.group_mode.kind}")
    values = {k: physical[k] for k in plan.scan_columns}
    masks = {k: np.ones(n, bool) for k in plan.scan_columns}
    hb = pad_to_batch(plan.bound.table, plan, values, masks, n, n, 0)
    call = build_fold_inputs(plan, _param_dtypes(plan, params))(
        empty_device_partials(plan, device),
        tuple(torch.from_numpy(a).to(device) for a in hb.cols),
        tuple(torch.from_numpy(a).to(device) for a in hb.valids),
        torch.from_numpy(hb.row_mask).to(device), _params_env(plan, params))
    planned = [plan_as_cluster_does(cl, sql)
               for sql, _ in sketch_families()["S"][1]]
    if len({plan_fingerprint(p) for p, _ in planned}) != 1:
        raise AssertionError("the S family spans several plan families")
    cl.close()
    return {"s1_call": call, "physical": physical,
            "family": (planned[0][0], [p for _, p in planned])}


def adversarial_sketch_call(device, n: int, q=None, all_false=False):
    """Every sketch op (and count/sum) over a float argument holding NaN,
    +-inf, +-0.0, 1e-300, the smallest subnormal, every DDSketch bucket
    edge and its neighbours, and nulls, and an int argument holding
    INT64_MIN/MAX, 0 and -1; n not a multiple of the block.  Registers
    [M] (one query) or [q, M].  -> the arguments of ``scan_agg_fold``
    (``scan_agg_fold_batched`` with ``q``)."""
    import torch
    from citus_tpu_torch import types as T
    from citus_tpu_torch.ops.scan_agg_fold import SKETCH_M, FoldOp
    from citus_tpu_torch.planner import aggregates as agg
    rng = np.random.default_rng(23)
    e = np.exp(agg.DDSK_LOG_MIN + np.arange(-2, 1030) * agg.DDSK_LNG)
    edges = np.concatenate([e, np.nextafter(e, 0), np.nextafter(e, np.inf)])
    special = np.concatenate([[np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-300,
                               5e-324], edges, -edges])
    f = rng.standard_normal(n) * 10.0 ** rng.integers(-12, 12, n)
    f[:special.size] = special
    i = rng.integers(I64_MIN, np.iinfo(np.int64).max, n)
    i[:4] = [I64_MIN, np.iinfo(np.int64).max, 0, -1]

    def to(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    cols = {"f": (to(f), to(rng.random(n) > 0.05)), "i": (to(i), None)}
    ops = [FoldOp("count_star"), FoldOp("hll", 0), FoldOp("ddsk", 0),
           FoldOp("hll", 1), FoldOp("topk", 1), FoldOp("topkv", 1),
           FoldOp("count", 0), FoldOp("sum", 1)]
    prog = column_program(None, [], ["f", "i"], ops,
                          {"f": T.FLOAT64_T, "i": T.INT64_T}, cols)
    pre = () if q is None else (q,)
    regs = []
    for op in ops:
        if op.kind in SKETCH_M:
            regs.append(torch.full(
                pre + (SKETCH_M[op.kind],), I64_MIN if op.kind == "topkv"
                else 0, dtype=torch.int32 if op.kind == "hll"
                else torch.int64, device=device))
        else:
            regs.append(torch.zeros(pre + (1,), dtype=torch.int64,
                                    device=device))
    shape = (n,) if q is None else (q, n)
    mask = to((rng.random(shape) > 0.3) & (not all_false))
    if q is None:
        return (prog, regs, None, cols, {}, mask)
    return (prog, regs, None, cols, mask)


def sketch_fold_ops(call) -> int:
    """Operations of a sketch fold on this call's data (``fold_ops``),
    with a few per (query, row) folded for a count or sum and ~40 for a
    sketch (splitmix64, the leading-zero count or a float64 log, the
    bucket and its atomic)."""
    from citus_tpu_torch.ops.scan_agg_fold import SKETCH_M
    return fold_ops(call, lambda op: 40 if op.kind in SKETCH_M else 2)


def phase3_sketch_folds(device, splans, rows: list) -> None:
    """scan_agg_fold and scan_agg_fold_batched with the sketch ops against
    their plain versions: S1's ops on one padded 2^21-row batch of the
    generated sketch table, the adversarial case (and an all-false
    mask), the S family at Q = 8 (~264 KB of registers: the shared-memory
    table in two query chunks of 4) and at Q = 6 (one table), the Q = 8
    family against eight serial S1 folds.  Registers identical, float
    sums within rel 1e-12.  Appends the two sketch rows of the JSON."""
    import torch
    from citus_tpu_torch.executor.megabatch import (
        _empty_stacked_partials, _fold_program,
    )
    from citus_tpu_torch.ops.filter_mask import filter_mask_batched
    from citus_tpu_torch.ops.scan_agg_fold import (
        fold_batched_plain, fold_plain, scan_agg_fold, scan_agg_fold_batched,
    )
    plan, params = splans["family"]
    cols, valids, row_mask = padded_batch(device, plan, splans["physical"])
    prog, stacked = family_filter(device, plan, params)
    masks = filter_mask_batched(
        prog, predicate_columns(plan, prog, cols, valids), stacked, row_mask)
    fold = _fold_program(plan, params[0], device)
    by_name = dict(zip(plan.scan_columns, zip(cols, valids)))

    def family_call(q):
        regs, rr = _empty_stacked_partials(plan, q, device)
        return (fold, regs, rr, by_name, masks[:q].contiguous())
    n = FOLD_N + 3
    for batched, cases in (
            (False, [("S1", lambda: splans["s1_call"], 1),
                     ("adversarial", lambda: adversarial_sketch_call(
                         device, n), 1),
                     ("adversarial all-false mask",
                      lambda: adversarial_sketch_call(device, n,
                                                      all_false=True), 1)]),
            (True, [("S family Q=8", lambda: family_call(8), 2),
                    ("S family Q=6", lambda: family_call(6), 1),
                    ("adversarial Q=2", lambda: adversarial_sketch_call(
                        device, n, q=2), 1)])):
        kernel = scan_agg_fold_batched if batched else scan_agg_fold
        plain = fold_batched_plain if batched else fold_plain
        name = "scan_agg_fold_batched" if batched else "scan_agg_fold"
        max_err, main = 0.0, None
        for case, make, want_regime in cases:
            call = make()
            err = compare_fold(f"{name} [{case}]", call, kernel, plain)
            if case == "S family Q=8":
                q8 = call
            max_err = max(max_err, err)
            if kernel.last_regime != want_regime:
                raise AssertionError(f"{name} [{case}]: regime "
                                     f"{kernel.last_regime}, not "
                                     f"{want_regime}")
            kc, pc = clone_call(call), clone_call(call)
            ms = time_cuda(lambda: kernel(*kc))
            plain_ms = time_cuda(lambda: plain(*pc), reps=3)
            nbytes, nops = fold_bytes(call), sketch_fold_ops(call)
            by = "bytes" if nbytes / HBM_BYTES_PER_S >= \
                nops / SIMT_OPS_PER_S else "operations"
            bound_ms = max(nbytes / HBM_BYTES_PER_S,
                           nops / SIMT_OPS_PER_S) * 1e3
            if main is None:
                main = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=by)
            if case == "S1":
                s1_ms = ms
            mask = fold_masks(call)
            # yardstick: ONE index_add_ of the passing (query, row) pairs
            # into the DDSketch registers, buckets drawn beforehand
            ddsk = next(r for r, op in zip(call[1], call[0].ops)
                        if op.kind == "ddsk")
            flat = torch.zeros(ddsk.numel(), dtype=torch.int64,
                               device=device)
            folded = mask if batched else \
                read_rows(call[0], call[3], call[4], mask)[1]
            hits = int(folded.sum())
            idx = torch.randint(0, flat.numel(), (hits,), device=device)
            ones = torch.ones(hits, dtype=torch.int64, device=device)
            lib_ms = time_cuda(lambda: flat.index_add_(0, idx, ones))
            say(f"phase 3 {name} [{case}, sketch ops]: N={mask.shape[-1]}"
                f"{f' Q={mask.shape[0]}' if batched else ''} "
                f"ops={[op.kind for op in call[0].ops]} regime="
                f"{regime_name(kernel.last_regime)}: "
                f"registers identical (max abs err of float sums {err!r}); "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms ({nbytes} B at 3.35 TB/s, {nops} "
                f"operations at 67 TFLOP/s: {by}), library yardstick (one "
                f"int64 index_add_ of the {hits} passing rows into the "
                f"DDSketch registers, one op) {lib_ms:.4f} ms")
        if batched:
            # the same 8 queries folded one after another, each by the
            # batched kernel at Q = 1 over its own mask
            fold_q8, regs8, _, cols8, masks8 = q8
            singles = [(fold_q8, [r[q:q + 1].clone() for r in regs8], None,
                        cols8, masks8[q:q + 1].contiguous())
                       for q in range(8)]
            serial_ms = time_cuda(lambda: [scan_agg_fold_batched(*c)
                                           for c in singles])
            say(f"phase 3 scan_agg_fold_batched [S family Q=8, sketch ops]: "
                f"{main['ms']:.4f} ms against its 8 queries folded one at "
                f"a time {serial_ms:.4f} ms (8 launches at Q = 1; 8 x S1's "
                f"serial fold {8 * s1_ms:.4f} ms)")
        rows.append({"name": f"{name}[sketch]", "route": "cuda",
                     "source": f"citus_tpu_torch/csrc/{name}.cu",
                     "replaces": "citus_tpu/ops/scan_agg.py:84",
                     "max_abs_err": max_err, **main, "library_ms": None})


#: phase 3's rollup_delta batches: one refresh batch of the default
#: citus.rollup_max_batch_rows and SF1's backfill, padded
ROLLUP_BATCHES = (65_536, 1 << 23)


def rollup_batch(device, n: int, seed: int) -> dict:
    """One delta batch of ``n`` rows into SUPPLIERS groups (1 % of the
    rows not ok): -> {kind: (values, gidx, ok)}, float prices with NaN,
    +-inf, +-0.0, 1e-300 and a subnormal for sum_float and ddsk, part
    keys for the int64 kinds, None for count."""
    import torch
    from citus_tpu_torch.rollup import kernels as K
    rng = np.random.default_rng(seed)
    g = torch.from_numpy(rng.integers(0, SUPPLIERS, n).astype(np.int32)
                         ).to(device)
    ok = torch.from_numpy(rng.random(n) > 0.01).to(device)
    prices = rng.integers(90_000, 10_500_000, n) / 100.0
    prices[:7] = [np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-300, 5e-324]
    fvals = torch.from_numpy(prices).to(device)
    ivals = torch.from_numpy(rng.integers(1, PARTS + 1, n)).to(device)
    return {kind: (None if kind == "count" else
                   fvals if kind in ("sum_float", "ddsk") else ivals, g, ok)
            for kind in K.KINDS}


def compare_rollup(name: str, got, want) -> float:
    """One kind's tables against the plain version's: identical, a float
    sum within rel 1e-12 (atomics and blocks add in another order) with
    its NaN and +-inf where the plain version's are.  -> max abs error."""
    import torch
    err_max = 0.0
    got = got if isinstance(got, tuple) else (got,)
    for k, p in zip(got, want):
        if not k.dtype.is_floating_point:
            if not torch.equal(k, p):
                raise AssertionError(f"{name}: tables differ")
            continue
        fin = torch.isfinite(p)
        nan = torch.isnan(p)
        if not torch.equal(torch.isnan(k), nan) \
                or not torch.equal(k[~fin & ~nan], p[~fin & ~nan]):
            raise AssertionError(f"{name}: non-finite sums differ")
        err = (k[fin] - p[fin]).abs()
        if (err > 1e-12 * p[fin].abs()).any():
            raise AssertionError(f"{name}: sum beyond rel 1e-12")
        err_max = max(err_max, float(err.max()))
    return err_max


def phase3_rollup_delta(device, rows: list) -> None:
    """rollup_delta against its plain version for all six kinds, one
    delta batch of the default citus.rollup_max_batch_rows (65,536) and
    one of SF1's backfill (2^23 padded) into 10,000 groups (16,384
    padded): the regime the wrapper chooses (direct; privatized for
    count and the sums at 2^23, checked), each time beside the bytes
    bound and a one-op yardstick into a table of the same size: the
    wrapper's call (its table allocated and filled, then the fold; event
    time and device time from torch.profiler, each kernel's beside) and
    its kernel alone into a table allocated beforehand.  At 2^23 the
    count and sums also run in the direct regime, held to the plain
    version and timed on the device.  Appends its JSON row: one
    65,536-row refresh batch of phase 6's five aggregates (count,
    sum_int, hll, ddsk, topk), the wrapper's calls."""
    import torch
    from citus_tpu_torch.rollup import kernels as K
    G = K._pad_to(SUPPLIERS)
    main = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    max_err = 0.0
    for n in ROLLUP_BATCHES:
        batch = rollup_batch(device, n, 31 + n)
        ivals = batch["topk"][0]
        for kind, (vals, g, ok) in batch.items():
            name = f"rollup_delta {kind} n={n}"
            regime = K.regime(kind, n, G)
            if (regime != "direct") != (n > 65_536 and kind in K.PRIVATE_KINDS):
                raise AssertionError(f"{name}: regime {regime}")
            got = K.rollup_delta(kind, vals, g, ok, G)
            if K.rollup_delta.last_regime != regime:
                raise AssertionError(f"{name}: launched in "
                                     f"{K.rollup_delta.last_regime}")
            want = K._tables(kind, G, device)
            K.rollup_delta_plain(kind, vals, g, ok, *want)
            torch.cuda.synchronize()
            max_err = max(max_err, compare_rollup(name, got, want))
            others = []
            if regime != "direct":
                for other in (r for r in K.REGIMES if r != regime):
                    t = K._table(kind, G, device)
                    K.launch_fold(kind, vals, g, ok, t, other)
                    torch.cuda.synchronize()
                    compare_rollup(f"{name} in {other}", t, want)
                    dev_ms, _ = device_time(lambda: K.launch_fold(
                        kind, vals, g, ok, t, other))
                    others.append(f"{other} {fmt_ms(dev_ms)}")
            ms = time_cuda(lambda: K.rollup_delta(kind, vals, g, ok, G),
                           reps=5)
            dev_ms, per = device_time(
                lambda: K.rollup_delta(kind, vals, g, ok, G))
            table = K._table(kind, G, device)
            fold_ms = time_cuda(lambda: K.launch_fold(
                kind, vals, g, ok, table, regime, fill=False), reps=5)
            plain_ms = time_cuda(lambda: K.rollup_delta_plain(
                kind, vals, g, ok, *K._tables(kind, G, device)), reps=2)
            out_bytes = table.numel() * table.element_size()
            in_bytes = g.numel() * 4 + ok.numel() + (
                0 if vals is None else vals.numel() * 8)
            bound_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
            # yardstick: one index_add_ (scatter_reduce amax for hll) of
            # the rows into a table of the same size
            flat = torch.zeros(want[0].numel(), dtype=want[0].dtype,
                               device=device)
            idx = (g.to(torch.int64) * (flat.numel() // G)
                   + (ivals % (flat.numel() // G)))
            src = ok.to(flat.dtype)
            if kind == "hll":
                lib_ms = time_cuda(lambda: flat.scatter_reduce_(
                    0, idx, src, "amax"), reps=5)
            else:
                lib_ms = time_cuda(lambda: flat.index_add_(0, idx, src),
                                   reps=5)
            if n == 65_536 and kind != "sum_float":
                main["ms"] += ms
                main["plain_ms"] += plain_ms
                main["bound_ms"] += bound_ms
            say(f"phase 3 rollup_delta [{kind}, n={n}, G={SUPPLIERS} "
                f"({G} padded), {regime}]: tables identical"
                f"{' (sum within rel 1e-12)' if kind == 'sum_float' else ''}; "
                f"the wrapper's call {ms:.4f} ms (its table allocated and "
                f"filled, then the fold), device {fmt_ms(dev_ms)} "
                f"(torch.profiler: {fmt_kernels(per)}); the fold alone "
                f"into a table allocated beforehand {fold_ms:.4f} ms"
                + (f"; the fold's device time in the other regimes: "
                   f"{', '.join(others)} (identical to the plain version)"
                   if others else "")
                + f"; plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                f"({in_bytes} B in, {out_bytes} B of tables out, at 3.35 "
                f"TB/s), library yardstick (one "
                f"{'scatter_reduce_ amax' if kind == 'hll' else 'index_add_'}"
                f" into a table of the same size allocated beforehand, one "
                f"op; to set beside the fold alone) {lib_ms:.4f} ms")
    rows.append({"name": "rollup_delta", "route": "cuda",
                 "source": "citus_tpu_torch/csrc/rollup_delta.cu",
                 "replaces": "citus_tpu/rollup/kernels.py:47",
                 "max_abs_err": max_err, **main, "bound_by": "bytes",
                 "library_ms": None})


def run_sketch_phases(ctt, tmp: str, n_rows: int, launches: dict,
                      card: str) -> None:
    """Phases 4 (S1), 9 (S1 over the mesh), 5 (the S family) and 6
    (rollups) on the sketch table; adds the main path's launches of the
    sketch fold, the mesh's combine, the batched sketch fold, the
    batched predicate and the rollup kernel."""
    import torch
    from citus_tpu_torch.ops.scan_agg_fold import (
        scan_agg_fold, scan_agg_fold_batched,
    )
    from citus_tpu_torch.rollup import kernels as K
    cl, cols = load_sketch_table(ctt, os.path.join(tmp, "sketch"), n_rows)
    try:
        # ---- phase 4: S1, cold then warm
        want = oracle_s1(cols)
        for run_kind in ("cold", "warm"):
            launches["scan_agg_fold[sketch]"] += run_checked(
                cl, "S1", S1, want, n_rows, run_kind)
        # ---- phase 9: S1 over the mesh
        mcl = mesh_cluster(ctt, os.path.join(tmp, "sketch"), cl.device)
        try:
            for run_kind in ("cold", "warm"):
                run_mesh_query(mcl, "S1", S1, want, n_rows, run_kind,
                               launches, card, "scan_agg_fold[sketch]")
        finally:
            mcl.close()
        # ---- phase 5: the S family, serial and coalesced
        kind, variants = sketch_families()["S"]
        got = run_family(cl, "S", kind, variants, cols, n_rows, card)
        launches["scan_agg_fold_batched[sketch]"] += \
            got.pop("scan_agg_fold_batched")
        for k, v in got.items():
            launches[k] += v
        run_rollup_phase(cl, cols, n_rows, launches)
    finally:
        cl.close()


def rollup_oracle(cols: dict) -> dict:
    """Per supplier: count, sum(l_quantity) and the HLL, DDSketch and
    top-k registers over all generated rows, with the port's numpy
    bucket functions.  -> {name: [S + 1, ...] arrays}."""
    from citus_tpu_torch.planner import aggregates as agg
    sk = cols["suppkey"].astype(np.int64)
    G = SUPPLIERS + 1
    n = sk.size
    out = {"count": np.bincount(sk, minlength=G),
           "sum": np.bincount(sk, weights=cols["qty"], minlength=G
                              ).astype(np.int64)}
    pk = cols["partkey"].astype(np.int64)
    out["hll"] = _hll_regs(pk, np.ones(n, bool), sk, G)
    out["ddsk"] = np.bincount(
        sk * agg.DDSK_M + agg.ddsk_bucket_indexes(np, cols["price"] / 100.0),
        minlength=G * agg.DDSK_M).reshape(G, agg.DDSK_M)
    flat = sk * agg.TOPK_M + agg.topk_buckets(np, pk)
    out["topk"] = np.bincount(flat, minlength=G * agg.TOPK_M
                              ).reshape(G, agg.TOPK_M)
    tv = np.full(G * agg.TOPK_M, I64_MIN)
    np.maximum.at(tv, flat, pk)
    out["topkv"] = tv.reshape(G, agg.TOPK_M)
    return out


def run_rollup_phase(cl, cols: dict, n_rows: int, launches: dict) -> None:
    """Phase 6: a CDC-fed rollup of the sketch table by l_suppkey, its
    backfill, DELTA_ROWS more rows by COPY and a refresh to the CDC
    head; the stored registers and the routed dashboard must equal the
    numpy oracle over every generated row, and rollup_delta must launch
    once per aggregate per fold."""
    import torch
    from citus_tpu_torch.rollup import kernels as K
    n_aggs = len(ROLLUP_AGGS.split(","))
    cl.execute("SET citus.enable_change_data_capture = on")
    K.rollup_delta.launches = 0
    t0 = time.perf_counter()
    cl.execute(f"SELECT citus_create_rollup('li_r', 'lineitem', 'l_suppkey',"
               f" '{ROLLUP_AGGS}')")
    torch.cuda.synchronize()
    backfill_s = time.perf_counter() - t0
    if K.rollup_delta.launches != n_aggs:
        raise AssertionError(f"backfill: {K.rollup_delta.launches} "
                             f"rollup_delta launches for {n_aggs} aggregates")
    launches["rollup_delta"] += K.rollup_delta.launches
    say(f"phase 6 backfill of li_r over {n_rows} rows: {backfill_s:.3f} s, "
        f"{n_rows / backfill_s:.1f} rows folded/s, rollup_delta launches "
        f"{K.rollup_delta.launches}")
    t0 = time.perf_counter()
    delta = list(sketch_chunks(DELTA_ROWS, 12, n_rows))
    dcols = {k: np.concatenate([c[k] for c in delta]) for k in delta[0]}
    per = DELTA_ROWS // DELTA_BATCHES
    for b in range(DELTA_BATCHES):
        cl.copy_from("lineitem", columns=sketch_copy_columns(
            {k: v[b * per:(b + 1) * per] for k, v in dcols.items()}))
    say(f"phase 6 COPY of {DELTA_ROWS} more rows in {DELTA_BATCHES} batches "
        f"with change data capture on: {time.perf_counter() - t0:.3f} s")
    K.rollup_delta.launches = 0
    t0 = time.perf_counter()
    folded = cl.execute("SELECT citus_refresh_rollups()").rows[0][0]
    torch.cuda.synchronize()
    refresh_s = time.perf_counter() - t0
    folds = -(-DELTA_ROWS // cl.settings.rollup.rollup_max_batch_rows)
    if folded != DELTA_ROWS or K.rollup_delta.launches != n_aggs * folds:
        raise AssertionError(f"refresh folded {folded} rows with "
                             f"{K.rollup_delta.launches} rollup_delta "
                             f"launches ({folds} folds of {n_aggs})")
    launches["rollup_delta"] += K.rollup_delta.launches
    view = cl.execute("SELECT citus_rollups()").rows[0]
    if view[4] != view[5] or view[6] != 0:
        raise AssertionError(f"refresh stopped short of the CDC head: {view}")
    say(f"phase 6 refresh to the CDC head: {folded} rows in {folds} folds, "
        f"{refresh_s:.3f} s, {folded / refresh_s:.1f} rows folded/s, "
        f"rollup_delta launches {K.rollup_delta.launches}")
    allc = {k: np.concatenate([cols[k], dcols[k]]) for k in cols}
    n_groups, n_dash = check_rollup_state(cl, allc)
    say(f"phase 6 li_r: {n_groups} groups (count, sum, and the HLL, "
        f"DDSketch and top-k registers decoded from the sketch words) "
        f"equal the numpy oracle over all {allc['suppkey'].size} rows; the "
        f"routed dashboard ({n_dash} rows) equals it too")


def check_rollup_state(cl, allc: dict) -> tuple[int, int]:
    """li_r's stored counts, sums and sketch registers, and the routed
    dashboard's rows, against the numpy oracle over ``allc`` (every
    generated row).  -> (groups, dashboard rows)."""
    from citus_tpu_torch.planner.aggregates import TOPK_M, hll_estimate
    from citus_tpu_torch.rollup.sketches import decode_sketch
    want = rollup_oracle(allc)
    got = cl.execute("SELECT l_suppkey, n_rows, sum_l_quantity, "
                     "acd_l_partkey, apct_l_extendedprice, atopk_l_partkey "
                     "FROM li_r").rows
    present = np.nonzero(want["count"])[0]
    if sorted(r[0] for r in got) != present.tolist():
        raise AssertionError("li_r holds other suppliers than the oracle")
    for sk, n, s, hll, ddsk, topk in got:
        state = decode_sketch(topk)[1]
        if n != want["count"][sk] or s != want["sum"][sk] \
                or not np.array_equal(decode_sketch(hll)[1], want["hll"][sk]) \
                or not np.array_equal(decode_sketch(ddsk)[1],
                                      want["ddsk"][sk]) \
                or not np.array_equal(state[:TOPK_M], want["topk"][sk]) \
                or not np.array_equal(state[TOPK_M:], want["topkv"][sk]):
            raise AssertionError(f"li_r row of supplier {sk} differs from "
                                 "the numpy oracle")
    r = cl.execute(DASHBOARD)
    if r.explain.get("strategy") != "rollup":
        raise AssertionError(f"the dashboard query was not routed: "
                             f"{r.explain.get('strategy')}")
    oracle_rows = [(int(sk), int(want["count"][sk]),
                    hll_estimate(want["hll"][sk])) for sk in present]
    if sorted(r.rows) != oracle_rows:
        raise AssertionError("the routed dashboard differs from the oracle")
    return len(got), len(r.rows)


# ------------------------------------------------------------- phase 7

#: phase 7's pushed projection: one ship day's lines of the first 500
#: suppliers
R3 = """SELECT l_orderkey, l_partkey, l_quantity FROM lineitem
WHERE l_shipdate = date '1994-06-01' AND l_suppkey < 500
ORDER BY l_orderkey, l_partkey"""
#: rows COPYed through coordinator A after the first queries
PAIR_DELTA_ROWS = 262_144


def oracle_r1(cols: dict) -> list[tuple]:
    """R1 per part: count, sum and exact avg of l_quantity, min and max
    of l_extendedprice."""
    keys, inv = np.unique(cols["partkey"], return_inverse=True)
    cnt = np.bincount(inv)
    qsum = np.zeros(keys.size, np.int64)
    np.add.at(qsum, inv, cols["qty"])
    pmin = np.full(keys.size, np.iinfo(np.int64).max)
    pmax = np.full(keys.size, np.iinfo(np.int64).min)
    np.minimum.at(pmin, inv, cols["price"])
    np.maximum.at(pmax, inv, cols["price"])
    return [(int(k), int(c), int(q), _avg(q, c, 0), _dec(lo, 2), _dec(hi, 2))
            for k, c, q, lo, hi in zip(keys, cnt, qsum, pmin, pmax)]


def oracle_r3(cols: dict) -> list[tuple]:
    m = (cols["ship"] == _day(1994, 6, 1)) & (cols["suppkey"] < 500)
    return sorted(zip(cols["orderkey"][m].tolist(),
                      cols["partkey"][m].tolist(), cols["qty"][m].tolist()))


def open_pair(ctt, tmp: str, device=None):
    """Coordinator A (metadata authority, data plane) and B (attached to
    A, data plane), each hosting one node of the cluster, both on
    ``device`` (None: the card).  -> (a, b)."""
    a = ctt.Cluster(os.path.join(tmp, "pair_a"), serve_port=0, data_port=0,
                    hosted_nodes=set(), n_nodes=0, device=device)
    try:
        a.register_node()
        b = ctt.Cluster(os.path.join(tmp, "pair_b"), data_port=0,
                        hosted_nodes=set(), n_nodes=0, device=device,
                        coordinator=("127.0.0.1", a.control_port))
    except BaseException:
        a.close()
        raise
    try:
        b.register_node()
        a._maybe_reload_catalog(force_sync=True)
    except BaseException:
        b.close()
        a.close()
        raise
    return a, b


def remote_stats(a) -> dict:
    r = a.execute("SELECT citus_remote_stats()")
    return dict(zip(r.columns, r.rows[0]))


def run_pair_query(a, qname: str, sql: str, want: list, mode: str,
                   run_kind: str, n_remote: int, launches: dict) -> float:
    """One query on coordinator A; its rows must equal the oracle.
    Pushed: one task per remote shard, no fallback, and for R1 one hash
    partial table and one hash_agg_merge launch per remote shard.
    Pulled: nothing pushed, nothing merged.  Adds the kernels' launches
    to ``launches``.  -> wall seconds."""
    import torch
    from citus_tpu_torch.executor.device_cache import GLOBAL_CACHE
    from citus_tpu_torch.executor.executor import GLOBAL_COUNTERS
    counters = launch_counters()
    if run_kind == "cold":
        GLOBAL_CACHE.clear()
    for f in counters.values():
        f.launches = 0
    c0 = GLOBAL_COUNTERS.snapshot()
    st0 = remote_stats(a)
    t0 = time.perf_counter()
    r = a.execute(sql)
    if a.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    c1 = GLOBAL_COUNTERS.snapshot()
    st1 = remote_stats(a)
    got = {k: f.launches for k, f in counters.items()}
    for k, v in got.items():
        # S1's folds carry its sketch registers
        launches[f"{k}[sketch]" if qname == "S1" and k == "scan_agg_fold"
                 else k] += v

    def delta(name):
        return c1.get(name, 0) - c0.get(name, 0)
    rows = sorted(r.rows) if qname == "R3" else r.rows
    if rows != want:
        raise AssertionError(f"phase 7 {qname} {mode} {run_kind}: rows "
                             f"differ from the numpy oracle:\n{rows[:10]}\n"
                             f"{want[:10]}")
    pushed, fallbacks = delta("remote_tasks_pushed"), \
        delta("remote_task_fallbacks")
    partials, merges = delta("hash_partials_pushed"), got["hash_agg_merge"]
    want_pushed = n_remote if mode == "push" else 0
    want_merges = want_pushed if qname == "R1" else 0
    # on the CPU (the tests' rehearsal) the merge runs its plain version
    want_launches = want_merges if a.device.type == "cuda" else 0
    if (pushed, fallbacks, partials, merges) != (
            want_pushed, 0, want_merges, want_launches):
        raise AssertionError(
            f"phase 7 {qname} {mode} {run_kind}: remote_tasks_pushed "
            f"{pushed}, remote_task_fallbacks {fallbacks}, "
            f"hash_partials_pushed {partials}, hash_agg_merge launches "
            f"{merges}; expected {want_pushed}, 0, {want_merges}, "
            f"{want_merges}")
    pipe = r.explain["pipeline"]
    say(f"phase 7 {qname} {mode} {run_kind}: {len(r.rows)} rows equal the "
        f"numpy oracle in {dt:.4f} s; remote_tasks_pushed {pushed}, "
        f"remote_task_fallbacks {fallbacks}, hash_partials_pushed "
        f"{partials}; pushed result bytes "
        f"{delta('remote_task_result_bytes')}, placement sync bytes "
        f"{delta('placement_sync_bytes')} (files fetched "
        f"{st1['files_fetched'] - st0['files_fetched']}, bytes fetched "
        f"{st1['bytes_fetched'] - st0['bytes_fetched']}); remote wait "
        f"{pipe.get('remote_wait_ms', 0)} ms, overlapped "
        f"{pipe.get('remote_overlapped_ms', 0)} ms, remote merge "
        f"{pipe.get('hash_remote_merge_ms', 0)} ms, host merge "
        f"{pipe.get('host_merge_ms', 0)} ms; kernel launches "
        f"{ {k: v for k, v in got.items() if v} }")
    return dt


def run_pair_phase(ctt, tmp: str, n_rows: int, launches: dict,
                   card: str, device=None) -> None:
    """Phase 7: two coordinators on the card.  The sketch table of phase
    4 loaded through A (4 shards by l_suppkey over A's and B's nodes:
    the rows of B's shards ship over the data plane); R1 (hash GROUP BY,
    pushed as a hash task whose tables merge through hash_agg_merge),
    S1 (pushed as an agg task with sketch registers) and R3 (pushed as a
    projection task), each cold and warm, pushed and then pulled; then
    PAIR_DELTA_ROWS more rows by COPY through A, and R1 and R3 warm
    again, pushed and pulled, against the new oracle."""
    from citus_tpu_torch.executor.executor import GLOBAL_COUNTERS
    a, b = open_pair(ctt, tmp, device)
    try:
        # the hash table sized from the row counts, as phase 4 sizes it:
        # each coordinator sizes the tables of the tasks it runs
        for cl in (a, b):
            cl.execute("SET citus.hash_agg_slots = auto")
        t0 = time.perf_counter()
        c0 = GLOBAL_COUNTERS.snapshot()
        a.execute(S_DDL)
        a.execute("SELECT create_distributed_table('lineitem', 'l_suppkey', "
                  f"{SHARDS})")
        chunks = []
        for c in sketch_chunks(n_rows, 11, n_rows):
            a.copy_from("lineitem", columns=sketch_copy_columns(c))
            chunks.append(c)
        cols = {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}
        c1 = GLOBAL_COUNTERS.snapshot()
        remote_rows = c1.get("rows_ingested_remote", 0) \
            - c0.get("rows_ingested_remote", 0)
        t = a.catalog.table("lineitem")
        n_remote = sum(a.catalog.is_remote_node(s.placements[0])
                       for s in t.shards)
        if not 0 < remote_rows < n_rows or n_remote != SHARDS // 2:
            raise AssertionError(f"phase 7 load: {remote_rows} rows reached "
                                 f"B, {n_remote} of {SHARDS} shards remote")
        st = remote_stats(a)
        say(f"phase 7 load through A: {n_rows} rows of the sketch table in "
            f"{time.perf_counter() - t0:.3f} s; {remote_rows} rows of B's "
            f"{n_remote} shards shipped to B in {st['batches_shipped']} "
            f"CTFR batches ({card})")
        queries = [("R1", R1, oracle_r1(cols)), ("S1", S1, oracle_s1(cols)),
                   ("R3", R3, oracle_r3(cols))]
        for mode in ("push", "pull"):
            a.execute("SET citus.remote_task_execution = "
                      + ("auto" if mode == "push" else "pull"))
            for qname, sql, want in queries:
                for run_kind in ("cold", "warm"):
                    run_pair_query(a, qname, sql, want, mode, run_kind,
                                   n_remote, launches)
        a.execute("SET citus.remote_task_execution = auto")
        t0 = time.perf_counter()
        delta = list(sketch_chunks(PAIR_DELTA_ROWS, 13, n_rows))
        for c in delta:
            a.copy_from("lineitem", columns=sketch_copy_columns(c))
        say(f"phase 7 COPY of {PAIR_DELTA_ROWS} more rows through A: "
            f"{time.perf_counter() - t0:.3f} s")
        cols = {k: np.concatenate([cols[k]] + [c[k] for c in delta])
                for k in cols}
        for mode in ("push", "pull"):
            a.execute("SET citus.remote_task_execution = "
                      + ("auto" if mode == "push" else "pull"))
            for qname, sql, want in (("R1", R1, oracle_r1(cols)),
                                     ("R3", R3, oracle_r3(cols))):
                run_pair_query(a, qname, sql, want, mode, "warm",
                               n_remote, launches)
        st = remote_stats(a)
        say(f"phase 7 data plane totals (citus_remote_stats on A): {st}")
    finally:
        b.close()
        a.close()


# ------------------------------------------------- joins and C1 (phase 8)

#: bench.py's QJOIN (BASELINE.json config 5), verbatim
#: (tests/test_torch_join.py runs bench.py's own through both packages)
QJOIN = """SELECT count(*), sum(l.l_quantity)
FROM lineitem l JOIN orders_b o ON l.l_orderkey = o.o_orderkey
WHERE o.o_flag = 'H'"""
#: the device join refuses an outer join: the bucket path (B7 and the
#: host join) answers it
QJOIN_LEFT = ("SELECT count(*), sum(l.l_quantity), count(o.o_orderkey), "
              "count(o.o_flag) FROM lineitem l LEFT JOIN orders_b o "
              "ON l.l_orderkey = o.o_orderkey")
ORDERS_B_DDL = """CREATE TABLE orders_b (
        o_orderkey bigint NOT NULL, o_custkey bigint NOT NULL,
        o_flag text)"""
FLAGS = np.array(["H", "L", "M"])

EV_DDL = """CREATE TABLE events (
        id bigint NOT NULL, device bigint, kind text, qty decimal(12,2),
        score double, d date, ts timestamp)"""
EV_KINDS = np.array(["click", "view", "buy"])
#: ROADMAP.md C1's five WHEREs (tests/test_torch_projection.py C1_WHERES)
C1_WHERES = (
    "extract(year FROM d) = 2021",
    "abs(score - 50) < 3",
    "CASE WHEN qty > 5 THEN score ELSE 0 END > 40",
    "upper(kind) = 'BUY'",
    "date_trunc('month', d) = date '2021-03-01'",
)
#: one predicate over every node kind the generator gained for C1:
#: BExtract, BCase (CASE and abs), BDictRemap (upper), BDictLookup
#: (length), BMathFunc (sqrt, ln, power, round, floor, greatest, sign,
#: exp), BDateTrunc (week), BDateTruncCivil (month), BAddMonths
ALL_NODES_WHERE = (
    "(extract(year FROM d) = 2021 AND extract(dow FROM ts) < 3 "
    "AND extract(hour FROM ts) > 11) "
    "OR abs(score - 50) < 1 "
    "OR CASE WHEN qty > 5 THEN score WHEN qty IS NULL THEN 0 "
    "ELSE -1 END > 99.5 "
    "OR (upper(kind) = 'BUY' AND length(kind) = 3 AND device = 7) "
    "OR date_trunc('month', d) = date '2021-03-01' "
    "OR date_trunc('week', ts) = timestamp '2022-05-02 00:00:00' "
    "OR d + interval '1 month' = date '2023-02-28' "
    "OR (sqrt(score) > 9.99 AND ln(score) > 4.6 AND power(score, 0.5) > 9.99) "
    "OR (round(qty, 1) = 50.5 AND floor(score) = 50) "
    "OR (greatest(device, 48) > 48 AND sign(qty - 50) = -1 "
    "AND exp(score / 50) > 7)")


def all_nodes_variant(i: int) -> str:
    """Variant i of a literal family over ALL_NODES_WHERE (phase 3's
    batched predicate)."""
    return (f"SELECT id FROM events WHERE device <> {i} AND "
            f"({ALL_NODES_WHERE})")


def c1_family_variant(i: int) -> str:
    """Variant i of a literal family over C1's nodes: one device's rows
    among those C1's five WHEREs keep (the literals inside the CASE and
    abs are not hoisted by either package, the others are)."""
    return (f"SELECT id FROM events WHERE device = {i} AND ("
            "extract(year FROM d) = 2021 OR abs(score - 50) < 3 "
            "OR CASE WHEN qty > 5 THEN score ELSE 0 END > 99 "
            "OR (upper(kind) = 'BUY' AND id < 1000000) "
            "OR date_trunc('month', d) = date '2021-03-01') ORDER BY id")


def events_chunks(n_rows: int, seed: int = 11):
    """The events table's generator, vectorized (the schema and
    distributions of tests/test_torch_slice.py's _events_rows, seed
    11): kinds click/view/buy and NULL, quantities in cents, scores to
    6 places, dates 202[0-3]-0[1-9]-1[0-9], timestamps on those days."""
    rng = np.random.default_rng(seed)
    table = np.array([_day(2020 + y, 1 + m, 10 + d) for y in range(4)
                      for m in range(9) for d in range(10)], np.int32)
    chunk = 1_000_000
    for start in range(0, n_rows, chunk):
        n = min(chunk, n_rows - start)
        d = table[rng.integers(0, len(table), n)]
        yield {
            "id": np.arange(start, start + n, dtype=np.int64),
            "device": rng.integers(0, 50, n),
            "kind": rng.integers(0, 4, n),          # 3: NULL
            "qty": rng.integers(0, 10_000, n),      # cents
            "score": np.round(rng.random(n) * 100, 6),
            "d": d,
            "ts": d.astype(np.int64) * 86_400_000_000
            + rng.integers(0, 86_400_000_000, n),
        }


def events_copy_columns(c: dict) -> dict:
    kinds = np.append(EV_KINDS, None).astype(object)
    return {"id": c["id"], "device": c["device"],
            "kind": kinds[c["kind"]].tolist(), "qty": c["qty"] / 100.0,
            "score": c["score"], "d": c["d"], "ts": c["ts"]}


def events_columns(cl, n: int, seed: int) -> dict:
    """Generated events rows in the engine's encoding (dictionary ids of
    ``cl``'s catalog, cents, days, microseconds) with nulls in every
    column: {name: (values, valid)}."""
    c = {k: np.concatenate([ch[k] for ch in events_chunks(n, seed)])
         for k in next(events_chunks(1, seed))}
    rng = np.random.default_rng(seed + 1)
    ids = np.array([cl.catalog.lookup_string_id("events", "kind", w)
                    for w in EV_KINDS] + [0], np.int32)
    cols = {"id": c["id"], "device": c["device"], "kind": ids[c["kind"]],
            "qty": c["qty"], "score": c["score"], "d": c["d"],
            "ts": c["ts"]}
    out = {}
    for k, v in cols.items():
        valid = rng.random(n) > 0.05
        if k == "kind":
            valid &= c["kind"] != 3
        out[k] = (v, valid)
    return out


def c1_oracle(cols: dict, where: str) -> list[tuple]:
    """Rows (id,) in id order of ``SELECT id FROM events WHERE <where>``
    for one of C1_WHERES, straight from the generated arrays."""
    d = cols["d"].astype("datetime64[D]")
    year = d.astype("datetime64[Y]").astype(np.int64) + 1970
    month = d.astype("datetime64[M]").astype(np.int64) % 12 + 1
    keep = {
        C1_WHERES[0]: year == 2021,
        C1_WHERES[1]: np.abs(cols["score"] - 50) < 3,
        C1_WHERES[2]: (cols["qty"] > 500) & (cols["score"] > 40),
        C1_WHERES[3]: cols["kind"] == 2,
        C1_WHERES[4]: (year == 2021) & (month == 3),
    }[where]
    return [(int(i),) for i in cols["id"][keep]]


def c1_family_oracle(cols: dict, i: int) -> list[tuple]:
    d = cols["d"].astype("datetime64[D]")
    year = d.astype("datetime64[Y]").astype(np.int64) + 1970
    month = d.astype("datetime64[M]").astype(np.int64) % 12 + 1
    score = cols["score"]
    keep = (cols["device"] == i) & (
        (year == 2021) | (np.abs(score - 50) < 3)
        | (np.where(cols["qty"] > 500, score, 0.0) > 99)
        | ((cols["kind"] == 2) & (cols["id"] < 1_000_000))
        | ((year == 2021) & (month == 3)))
    return [(int(x),) for x in cols["id"][keep]]


def c1_families() -> dict:
    """name -> (kind, variants) of phase 8's coalesced C1 family."""
    return {"C1": ("projection",
                   [(c1_family_variant(i),
                     (lambda c, i=i: c1_family_oracle(c, i)))
                    for i in range(Q_BATCH)])}


def load_events(cl, n_rows: int) -> dict:
    """Create and fill ``events`` through ``cl``; -> generated columns."""
    t0 = time.perf_counter()
    cl.execute(EV_DDL)
    cl.execute(f"SELECT create_distributed_table('events', 'id', {SHARDS})")
    chunks = []
    for c in events_chunks(n_rows):
        cl.copy_from("events", columns=events_copy_columns(c))
        chunks.append(c)
    cols = {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}
    say(f"phase 8 load of events: {n_rows} rows in {SHARDS} shards in "
        f"{time.perf_counter() - t0:.3f} s")
    return cols


def orders_b_chunks(n_orders: int):
    """bench.py's ensure_join_data generator (seed 11, 1M-row chunks)."""
    rng = np.random.default_rng(11)
    chunk = 1_000_000
    for start in range(0, n_orders, chunk):
        n = min(chunk, n_orders - start)
        yield {"o_orderkey": np.arange(start, start + n, dtype=np.int64),
               "o_custkey": rng.integers(0, n_orders // 8 + 1, n),
               "flag": rng.integers(0, 3, n)}


def load_orders_b(cl, n_orders: int) -> np.ndarray:
    """bench.py's orders_b through ``cl``; -> the flag index per order."""
    t0 = time.perf_counter()
    cl.execute(ORDERS_B_DDL)
    cl.execute(f"SELECT create_distributed_table('orders_b', 'o_custkey', "
               f"{SHARDS})")
    flags = []
    for c in orders_b_chunks(n_orders):
        cl.copy_from("orders_b", columns={
            "o_orderkey": c["o_orderkey"], "o_custkey": c["o_custkey"],
            "o_flag": FLAGS[c["flag"]].tolist()})
        flags.append(c["flag"])
    say(f"phase 8 load of orders_b: {n_orders} rows in {SHARDS} shards by "
        f"o_custkey in {time.perf_counter() - t0:.3f} s")
    return np.concatenate(flags)


def oracle_qjoin(cols: dict, flag: np.ndarray) -> list[tuple]:
    """QJOIN's row: every l_orderkey has exactly one order (keys below
    n_orders = n_rows // 4), flagged 'H' when its flag index is 0."""
    hit = flag[cols["orderkey"]] == 0
    return [(int(hit.sum()), _dec(int(cols["qty"][hit].sum()), 2))]


def oracle_qjoin_left(cols: dict) -> list[tuple]:
    n = len(cols["orderkey"])
    return [(n, _dec(int(cols["qty"].sum()), 2), n, n)]


def pack_bytes(values, n: int, n_dev: int, capacity: int) -> int:
    """Bytes one partition must move: each column, the target and the
    mask read once; each block, the packed validity and the overflow
    written once."""
    slots = n_dev * capacity
    return (sum(v.numel() * v.element_size() for v in values) + 5 * n
            + sum(slots * v.element_size() for v in values) + slots + 8)


def join_bytes(lvalid, rvalid, J: int, lcols, rcols, l_idx, r_idx,
               out_valid) -> int:
    """Bytes one sort join must move on this run's data: both sides'
    validity read once and the gids of their valid rows; of every
    gathered column, the distinct rows its side's index reaches in the
    valid slots; l_idx, r_idx, out_valid, total and every gathered
    output written once."""
    import torch
    valid = int(lvalid.sum()) + int(rvalid.sum())
    reach_l = torch.unique(l_idx[out_valid]).numel()
    reach_r = torch.unique(r_idx[out_valid]).numel()
    return (lvalid.numel() + rvalid.numel() + 8 * valid
            + sum(reach_l * c.element_size() for c in lcols)
            + sum(reach_r * c.element_size() for c in rcols)
            + 17 * J + 8
            + sum(J * c.element_size() for c in list(lcols) + list(rcols)))


def qjoin_sides(n_rows: int, device):
    """QJOIN's device join inputs at ``n_rows`` lineitem rows, as
    ``_device_join_step`` builds them: the group ids of l_orderkey and of
    the flagged o_orderkey (np.unique's inverse over both), and each
    side's frame columns with validity (lineitem: l_orderkey,
    l_quantity; orders_b: o_flag's dictionary id, o_orderkey).
    -> (left, right, U); a side is (gid, columns, capacity)."""
    import torch
    n_orders = n_rows // 4
    lkey = np.concatenate([c["orderkey"] for c in lineitem_chunks(n_rows)])
    qty = np.concatenate([c["qty"] for c in lineitem_chunks(n_rows)])
    flag = np.concatenate([c["flag"] for c in orders_b_chunks(n_orders)])
    rkey = np.nonzero(flag == 0)[0].astype(np.int64)
    _, inv = np.unique(np.concatenate([lkey, rkey]), return_inverse=True)
    U = int(inv.max()) + 1
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa
    ones = lambda n: t(np.ones(n, bool))  # noqa: E731
    left = (t(inv[:len(lkey)].astype(np.int64)),
            (t(lkey), ones(len(lkey)), t(qty), ones(len(lkey))),
            len(lkey))
    right = (t(inv[len(lkey):].astype(np.int64)),
             (t(np.zeros(len(rkey), np.int32)), ones(len(rkey)), t(rkey),
              ones(len(rkey))), len(rkey))
    return left, right, U


def compare_exact(name: str, got, want) -> None:
    for i, (g, w) in enumerate(zip(got, want)):
        if g.dtype != w.dtype or g.shape != w.shape \
                or not bool((g == w).all()):
            raise AssertionError(f"{name}: output {i} differs from the "
                                 "plain version")


def partition_cases(device, sides, wide: bool = False) -> list:
    """-> [(name, pack_blocks' arguments)]: both sides of QJOIN's device
    join at SF1 (n_dev = 1, the one card's mesh), the lineitem side to 8
    destinations with a capacity that overflows, and one member's rows
    of phase 9's 4-member mesh (a quarter of lineitem to gid % 4, the
    capacity its largest block).  ``wide``: also the lineitem side to
    1,023 destinations (the most one launch takes), 1 % of rows
    masked."""
    import torch
    (lgid, lcols, cap_l), (rgid, rcols, cap_r), _U = sides
    cases = []
    for side, gid, cols, cap in (("lineitem", lgid, lcols, cap_l),
                                 ("orders_b", rgid, rcols, cap_r)):
        n = gid.numel()
        cases.append((f"QJOIN {side} n_dev=1", ((gid,) + cols,
                      torch.zeros(n, dtype=torch.int32, device=device),
                      torch.ones(n, dtype=torch.bool, device=device), 1,
                      cap)))
    gen = torch.Generator(device=device)
    gen.manual_seed(8)
    keep = torch.rand(lgid.numel(), device=device, generator=gen) > 0.01

    def spread(n_dev, rows, cap_of_need):
        tgt = (lgid[:rows] % n_dev).to(torch.int32)
        need = int(torch.bincount(tgt.long()[keep[:rows]],
                                  minlength=n_dev).max())
        return ((lgid[:rows],) + tuple(c[:rows] for c in lcols), tgt,
                keep[:rows], n_dev, cap_of_need(need))
    cases.append(("lineitem n_dev=8 overflowing",
                  spread(8, lgid.numel(), lambda need: need // 2)))
    per = -(-lgid.numel() // MESH_MEMBERS)
    cases.append((f"phase 9 member n_dev={MESH_MEMBERS}",
                  spread(MESH_MEMBERS, per, lambda need: need)))
    if wide:
        cases.append(("lineitem n_dev=1023",
                      spread(1023, lgid.numel(), lambda need: need)))
    return cases


def phase3_partition_pack(device, n_rows: int, rows: list, sides) -> None:
    """partition_pack (B7) against its plain version, outputs identical,
    in each of ``partition_cases`` (n_dev = 1023 too); appends its JSON
    row."""
    import torch
    from citus_tpu_torch.parallel.shuffle import (
        pack_blocks, pack_blocks_plain,
    )
    cases = [(name,) + args
             for name, args in partition_cases(device, sides, wide=True)]
    main = None
    for name, values, target, mask, n_dev, cap in cases:
        got = pack_blocks(values, target, mask, n_dev, cap)
        want = pack_blocks_plain(values, target, mask, n_dev, cap)
        compare_exact(f"partition_pack [{name}]",
                      got[0] + (got[1], got[2]), want[0] + (want[1], want[2]))
        ms = time_cuda(lambda: pack_blocks(values, target, mask, n_dev, cap),
                       reps=10)
        plain_ms = time_cuda(lambda: pack_blocks_plain(values, target, mask,
                                                       n_dev, cap), reps=3)
        n = target.numel()
        nbytes = pack_bytes(values, n, n_dev, cap)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        lib_ms = time_cuda(lambda: torch.argsort(target, stable=True), reps=5)
        if main is None:
            main = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms)
        say(f"phase 3 partition_pack [{name}]: N={n} columns {len(values)} "
            f"capacity {cap}: blocks, validity and overflow identical "
            f"(overflow {int(got[2])}); kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({nbytes} B at "
            f"3.35 TB/s); for scale, one stable torch.argsort of the "
            f"targets (the order alone, not the partition) {lib_ms:.4f} ms")
    rows.append({"name": "partition_pack", "route": "cuda",
                 "source": "citus_tpu_torch/csrc/partition_pack.cu",
                 "replaces": "citus_tpu/parallel/shuffle.py:32",
                 "max_abs_err": 0.0, **main, "bound_by": "bytes",
                 "library_ms": None})


def sorted_join_cases(device, sides, n: int = 1 << 20) -> list:
    """-> [(name, sorted_join's arguments)]: QJOIN's join at SF1 (both
    sides packed by B7, join_cap its pairs), a many-to-many join (``n`` x
    n / 4 rows over n / 10 gids), an empty (all-invalid) right side,
    invalid rows on both sides, and one gid holding 60 % of n left rows
    (the others spread over n / 10 gids; the right side holds it twice)."""
    import torch
    from citus_tpu_torch.parallel.shuffle import pack_blocks
    (lgid, lcols, cap_l), (rgid, rcols, cap_r), U = sides
    packed = []
    for gid, cols, cap in ((lgid, lcols, cap_l), (rgid, rcols, cap_r)):
        m = gid.numel()
        p, pv, _ = pack_blocks((gid,) + cols,
                               torch.zeros(m, dtype=torch.int32,
                                           device=device),
                               torch.ones(m, dtype=torch.bool, device=device),
                               1, cap)
        packed.append((p[0][0], pv[0], tuple(c[0] for c in p[1:])))
    (lg, lv, lc), (rg, rv, rc) = packed
    lcnt = torch.bincount(lg[lv], minlength=U)
    pairs = int(lcnt[rg[rv]].sum())
    cases = [("QJOIN SF1", (lg, lv, rg, rv, lc, rc, U, pairs))]
    rng = np.random.default_rng(5)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa
    for name, L, R, u, lmiss, rmiss in (("many-to-many", n, n // 4,
                                         n // 10, 0.0, 0.0),
                                        ("empty right side", n // 16,
                                         n // 256, 300, 0.0, 1.1),
                                        ("invalid rows both sides", n, n,
                                         n // 2, 0.3, 0.3),
                                        ("one gid holding 60 % of the left "
                                         "rows", n, n // 4, n // 10, 0.0,
                                         0.0)):
        g1 = rng.integers(0, u, L).astype(np.int64)
        g2 = rng.integers(0, u, R).astype(np.int64)
        if name.startswith("one gid"):
            g1[rng.random(L) < 0.6] = u // 3
            g2[g2 == u // 3] = u // 3 + 1
            g2[rng.integers(0, R, 2)] = u // 3
        v1, v2 = rng.random(L) >= lmiss, rng.random(R) >= rmiss
        c = np.bincount(g1[v1], minlength=u)
        total = int(c[g2[v2]].sum())
        cases.append((name, (t(g1), t(v1), t(g2), t(v2),
                             (t(rng.integers(0, 10**9, L)), t(v1)),
                             (t(rng.random(R)),), u, total + 1000)))
    return cases


def phase3_sorted_join(device, rows: list, sides, n: int = 1 << 20) -> None:
    """sorted_join (B8) against its plain version, every output
    identical, in each of ``sorted_join_cases``; appends its JSON row."""
    from citus_tpu_torch.parallel.shuffle import (
        sorted_join, sorted_join_plain,
    )
    cases = sorted_join_cases(device, sides, n)
    main = None
    for name, args in cases:
        got = sorted_join(*args)
        want = sorted_join_plain(*args)
        compare_exact(f"sorted_join [{name}]",
                      got[:4] + got[4] + got[5], want[:4] + want[4] + want[5])
        ms = time_cuda(lambda: sorted_join(*args), reps=10)
        plain_ms = time_cuda(lambda: sorted_join_plain(*args), reps=3)
        L, R, J = args[0].numel(), args[2].numel(), args[7]
        nbytes = join_bytes(args[1], args[3], J, args[4], args[5], *got[:3])
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        if main is None:
            main = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms)
        say(f"phase 3 sorted_join [{name}]: L={L} R={R} U={args[6]} "
            f"join_cap={J} pairs {int(got[3])}: l_idx, r_idx, out_valid, "
            f"total and {len(args[4]) + len(args[5])} gathered columns "
            f"identical; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({nbytes} B at 3.35 TB/s)")
    rows.append({"name": "sorted_join", "route": "cuda",
                 "source": "citus_tpu_torch/csrc/sorted_join.cu",
                 "replaces": "citus_tpu/parallel/shuffle.py:95",
                 "max_abs_err": 0.0, **main, "bound_by": "bytes",
                 "library_ms": None})


# ------------------------------------------------ the mesh (B6, exchange)

#: members of phase 3's and phase 9's meshes, all on the one card
MESH_MEMBERS = 4
#: the combine over members of each fold op's registers
MESH_KINDS = {"count_star": "sum", "count": "sum", "sum": "sum",
              "min": "min", "max": "max", "hll": "max", "ddsk": "sum",
              "topk": "sum", "topkv": "max"}


def member_registers(call, n: int, empty: int = -1) -> tuple:
    """The registers of ``n`` mesh members for one fold call: member m
    folds the rows ``i % n == m`` of the call's batch through the
    generated fold kernel into its own fresh registers (member ``empty``
    folds no row: its registers keep their seeds, the +-inf and integer
    extremes of min and max).  -> (combine kinds, [member's registers])."""
    import torch
    from citus_tpu_torch.ops.scan_agg_fold import scan_agg_fold
    prog, mask = call[0], fold_masks(call)
    idx = torch.arange(mask.numel(), device=mask.device)
    members = []
    for m in range(n):
        c = clone_call(call)
        mm = mask & (idx % n == m) & (m != empty)
        scan_agg_fold(c[0], c[1], c[2], c[3], c[4], mm)
        members.append(tuple(c[1]) + (() if c[2] is None else (c[2],)))
    kinds = [MESH_KINDS[op.kind] for op in prog.ops]
    if call[2] is not None:
        kinds.append("sum")
    return kinds, members


def compare_bits(name: str, got, want) -> None:
    """Identical outputs; a float's NaN where the other has NaN (any
    payload), its other values bit for bit."""
    import torch
    for i, (g, w) in enumerate(zip(got, want)):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{name}: output {i} dtype or shape differs")
        g, w = g.reshape(-1), w.reshape(-1)
        if g.dtype.is_floating_point:
            nan = torch.isnan(w)
            if not torch.equal(torch.isnan(g), nan):
                raise AssertionError(f"{name}: output {i} NaN positions "
                                     "differ")
            g, w = g[~nan], w[~nan]
            itype = torch.int64 if g.element_size() == 8 else torch.int32
            g, w = g.view(itype), w.view(itype)
        if not torch.equal(g, w):
            raise AssertionError(f"{name}: output {i} differs from the plain "
                                 "version")


def member_arenas(kinds: list, members: list) -> tuple:
    """The members' registers as the executor keeps them: one allocation
    a member, laid out by ``RegisterLayout``.  -> (layout, arenas)."""
    import torch
    from citus_tpu_torch.parallel.mesh import RegisterLayout
    first = members[0]
    layout = RegisterLayout(kinds, [r.dtype for r in first],
                            [r.shape for r in first], len(members))
    arenas = []
    for regs in members:
        arena = torch.empty(layout.nbytes, dtype=torch.uint8,
                            device=first[0].device)
        for v, r in zip(layout.views(arena), regs):
            v.copy_(r)
        arenas.append(arena)
    return layout, arenas


def phase3_mesh_combine(device, plans, splans, rows: list) -> None:
    """mesh_combine (B6) against its plain version, every output bit for
    bit: the registers of Q1's fold (12 groups x 17 positions), of S1's
    (scalar counts and sums, HLL, DDSketch and top-k registers) and of a
    direct fold of 65,536 groups with nulls, NaN, +-inf and +-0.0 (one
    member folding no row), each over 4 members on the card, as the
    executor holds them (one allocation a member, one launch into one
    output allocation: the main path's call) and as separate tensors
    (``mesh_combine``); each timed by events and on the device
    (torch.profiler); appends its JSON row (the main path's call)."""
    import torch
    from citus_tpu_torch.parallel.mesh import (
        mesh_combine, mesh_combine_arenas, mesh_combine_plain,
    )
    n = MESH_MEMBERS
    cases = [("Q1", plans["fold_calls"]["q1"], -1),
             ("S1", splans["s1_call"], -1),
             ("G=65,536 direct, NaN, +-inf, +-0.0, one empty member",
              synthetic_global_case(device, FOLD_N, 65_536, 3, False), 2)]
    main = None
    for name, call, empty in cases:
        kinds, members = member_registers(call, n, empty)
        layout, arenas = member_arenas(kinds, members)
        want = mesh_combine_plain(kinds, members)
        compare_bits(f"mesh_combine [{name}]", mesh_combine(kinds, members),
                     want)
        compare_bits(f"mesh_combine_arenas [{name}]", layout.out_views(
            mesh_combine_arenas(layout, arenas)), want)
        ms = time_cuda(lambda: mesh_combine_arenas(layout, arenas))
        dev_ms, per = device_time(lambda: mesh_combine_arenas(layout,
                                                              arenas))
        sep_ms = time_cuda(lambda: mesh_combine(kinds, members))
        sep_dev, _ = device_time(lambda: mesh_combine(kinds, members))
        plain_ms = time_cuda(lambda: mesh_combine_plain(kinds, members),
                             reps=5)
        lib = {"sum": lambda t: t.sum(0), "min": lambda t: t.amin(0),
               "max": lambda t: t.amax(0), "none": lambda t: t}

        def library():
            return [lib[k](torch.stack([m[i] for m in members]))
                    for i, k in enumerate(kinds)]
        lib_ms = time_cuda(library)
        nbytes = sum((n + (n if k == "none" else 1)) * r.numel()
                     * r.element_size() for k, r in zip(kinds, members[0]))
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        if main is None:
            main = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                        library_ms=lib_ms)
        say(f"phase 3 mesh_combine [{name}]: {n} members, {len(kinds)} "
            f"positions ({', '.join(sorted(set(kinds)))}), "
            f"{sum(r.numel() for r in members[0])} elements a member: "
            f"identical to the plain version, from one allocation a member "
            f"and from separate tensors; the main path's call (one "
            f"allocation a member, one launch into one output) {ms:.4f} ms, "
            f"device {fmt_ms(dev_ms)} ({fmt_kernels(per)}); separate "
            f"tensors (mesh_combine) {sep_ms:.4f} ms, device "
            f"{fmt_ms(sep_dev)}; plain {plain_ms:.4f} ms, bound "
            f"{bound_ms:.6f} ms ({nbytes} B at 3.35 TB/s), one torch.stack "
            f"and sum/amin/amax a position (the library yardstick) "
            f"{lib_ms:.4f} ms")
    rows.append({"name": "mesh_combine", "route": "cuda",
                 "source": "citus_tpu_torch/csrc/mesh_combine.cu",
                 "replaces": "citus_tpu/parallel/mesh.py:46",
                 "max_abs_err": 0.0, **main, "bound_by": "bytes"})


def mesh_blocks(gid, cols, n: int):
    """One side of QJOIN's device join split over ``n`` members as
    ``_device_join_step`` splits it (rows in order, the last member
    padded with masked rows), routed ``gid % n`` and packed by each
    member (B7) with the exact block capacity.  -> (each member's packed
    columns and validity, capacity)."""
    import torch
    from citus_tpu_torch.parallel.shuffle import pack_blocks
    N = gid.numel()
    per = -(-N // n)
    pad = per * n - N
    dev = gid.device

    def stack(t, fill):
        return torch.cat([t, torch.full((pad,), fill, dtype=t.dtype,
                                        device=dev)]).reshape(n, per)
    g2 = stack(gid, 0)
    tgt = (g2 % n).to(torch.int32)
    mask = stack(torch.ones(N, dtype=torch.bool, device=dev), False)
    cols2 = [stack(c, 0) for c in cols]
    cap = max(int(torch.bincount(tgt[s][mask[s]].long(), minlength=n).max())
              for s in range(n))
    blocks = []
    for s in range(n):
        packed, pvalid, _ = pack_blocks(
            (g2[s].contiguous(),) + tuple(c[s].contiguous() for c in cols2),
            tgt[s].contiguous(), mask[s].contiguous(), n, cap)
        blocks.append(packed + (pvalid,))
    return blocks, cap


def phase3_mesh_exchange(device, rows: list, sides) -> None:
    """exchange_blocks against its plain version, outputs identical: the
    lineitem side of QJOIN's device join at SF1 (gid, l_orderkey,
    l_quantity and their validity, the packed validity) over 4 members on
    the card, in one launch; the wrapper call timed beside its kernel
    alone, launched from a prebuilt parameter block (the wrapper's host
    time apart); appends its JSON row."""
    import torch
    from citus_tpu_torch.parallel.mesh import DeviceMesh
    from citus_tpu_torch.parallel.shuffle import (
        exchange_blocks, exchange_blocks_plain, exchange_prepare,
        exchange_run,
    )
    n = MESH_MEMBERS
    mesh = DeviceMesh([device] * n)
    (lgid, lcols, _), _, _ = sides
    blocks, cap = mesh_blocks(lgid, lcols, n)
    launches = exchange_blocks.launches
    got = exchange_blocks(blocks, mesh)
    launched = exchange_blocks.launches - launches
    want = exchange_blocks_plain(blocks, mesh)
    for d in range(n):
        compare_exact(f"exchange_blocks [QJOIN lineitem, destination {d}]",
                      got[d], want[d])
    if device.type == "cuda" and launched != 1:
        raise AssertionError(f"exchange_blocks: {launched} launches for one "
                             "exchange on one card")
    ms = time_cuda(lambda: exchange_blocks(blocks, mesh), reps=10)
    kernel_ms = None
    if device.type == "cuda":
        received, prepared, _ = exchange_prepare(blocks, mesh)
        kernel_ms = time_cuda(lambda: exchange_run(prepared), reps=10)
        for d in range(n):
            compare_exact(f"exchange_run [QJOIN lineitem, destination {d}]",
                          received[d], want[d])
    plain_ms = time_cuda(lambda: exchange_blocks_plain(blocks, mesh), reps=5)
    lib_ms = time_cuda(lambda: [
        torch.stack([b[c] for b in blocks]).transpose(0, 1).contiguous()
        for c in range(len(blocks[0]))], reps=10)
    # every slot of every block read once, every received slot written once
    nbytes = 2 * sum(b.numel() * b.element_size() for bl in blocks
                     for b in bl)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    alone = "not measured" if kernel_ms is None else f"{kernel_ms:.4f} ms"
    say(f"phase 3 exchange_blocks [QJOIN lineitem side at SF1]: {n} members, "
        f"{lgid.numel()} rows, {len(blocks[0])} columns, capacity {cap}: "
        f"identical to the plain version; {launched} launch(es), the "
        f"wrapper call {ms:.4f} ms, its kernel alone (from a prebuilt "
        f"parameter block) {alone}, plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({nbytes} B at 3.35 TB/s), "
        f"torch.stack(...).transpose(0, 1).contiguous() a column (the "
        f"library yardstick) {lib_ms:.4f} ms")
    rows.append({"name": "exchange_blocks", "route": "cuda",
                 "source": "citus_tpu_torch/csrc/mesh_exchange.cu",
                 "replaces": "citus_tpu/parallel/shuffle.py:62",
                 "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": bound_ms, "bound_by": "bytes",
                 "library_ms": lib_ms})


def mesh_cluster(ctt, path: str, device):
    """A second Cluster over ``path``'s tables whose mesh has
    MESH_MEMBERS members on ``device`` (the card); the device cache is
    emptied first, so the mesh path cannot take a single-stream entry of
    the same scan (a single-batch entry wins there, as in the
    reference)."""
    from citus_tpu_torch.executor.device_cache import GLOBAL_CACHE
    GLOBAL_CACHE.clear()
    cl = ctt.Cluster(path, device=device,
                     mesh_devices=[device] * MESH_MEMBERS)
    if cl.mesh.shape["shard"] != MESH_MEMBERS:
        raise AssertionError(f"phase 9: mesh {cl.mesh}")
    return cl


def run_mesh_query(cl, qname: str, sql: str, want: list, n_rows: int,
                   run_kind: str, launches: dict, card: str,
                   fold: str = "scan_agg_fold") -> None:
    """One aggregate over the mesh: rows equal to the oracle, one fold
    per member per round and one mesh_combine (on the card: launches, no
    other kernel)."""
    import torch
    counters = launch_counters()
    for f in counters.values():
        f.launches = 0
    t0 = time.perf_counter()
    r = cl.execute(sql)
    if cl.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = {k: f.launches for k, f in counters.items()}
    if r.rows != want:
        raise AssertionError(f"phase 9 {qname} {run_kind}: rows differ from "
                             f"the numpy oracle:\n{r.rows[:20]}\n{want[:20]}")
    pl = r.explain["pipeline"]
    rounds = pl.get("mesh_rounds", 0)
    expect = {"scan_agg_fold": rounds * MESH_MEMBERS, "mesh_combine": 1}
    if cl.device.type != "cuda":
        got = dict.fromkeys(got, 0)
        got.update(expect)      # the plain versions ran: nothing launched
    if pl.get("mesh_members") != MESH_MEMBERS or rounds == 0 \
            or {k: v for k, v in got.items() if v} != expect \
            or pl["fused_dispatches"] != expect["scan_agg_fold"]:
        raise AssertionError(f"phase 9 {qname} {run_kind}: pipeline {pl}, "
                             f"launches {got}, expected {expect}")
    extra = ""
    if cl.device.type == "cuda":
        launches[fold] += got["scan_agg_fold"]
        launches["mesh_combine"] += got["mesh_combine"]
        if run_kind == "warm":
            d2h = mesh_d2h_copies(cl, sql)
            if d2h != 1:
                raise AssertionError(f"phase 9 {qname} warm: {d2h} "
                                     "device-to-host copies, not 1")
            single = SINGLE_STREAM_WARM_S.get(qname)
            extra = (f"; device-to-host copies per query (torch.profiler) "
                     f"{d2h}; warm, the median of {WARM_REPEATS} more runs: "
                     f"here {median_warm_s(cl, sql):.4f} s, phase 4's "
                     f"{qname} on the single stream "
                     + ("not run" if single is None else f"{single:.4f} s"))
    say(f"phase 9 {qname} {run_kind} at {n_rows} rows on a "
        f"{MESH_MEMBERS}-member mesh of the card: {len(r.rows)} rows equal "
        f"the numpy oracle in {dt:.4f} s ({n_rows / dt:.1f} rows/s); "
        f"{rounds} rounds, scan_agg_fold launches {got['scan_agg_fold']} "
        f"({MESH_MEMBERS} a round), mesh_combine launches "
        f"{got['mesh_combine']}, h2d_bytes {pl.get('h2d_bytes', 0)}, "
        f"host_decode_ms {pl.get('host_decode_ms', 0)}, device_ms "
        f"{pl.get('device_ms', 0)}{extra} ({card})")


def mesh_d2h_copies(cl, sql: str) -> int:
    """Device-to-host copies of one more run of ``sql`` (torch.profiler;
    up to PROFILE_TRIES sessions, until one records the run's kernels)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    pause = PROFILE_PAUSE_S
    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(pause)
            cl.execute(sql)
            torch.cuda.synchronize()
            time.sleep(pause)
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if any("mc_kernel" in k for k in names):
            return sum(1 for k in names if "DtoH" in k)
        pause = PROFILE_RETRY_PAUSE_S
    raise AssertionError("phase 9: torch.profiler recorded no combine in "
                         f"{PROFILE_TRIES} runs")


def run_join_query(cl, qname: str, sql: str, want: list, run_kind: str,
                   n_rows: int, n_orders: int, launches: dict,
                   devjoin: bool, card: str, phase: str = "phase 8") -> None:
    """One join on ``cl``: rows equal to the oracle, EXPLAIN's strategy
    join:repartition and (``devjoin``) the device join, and on the card
    partition_pack launched twice and sorted_join once (devjoin) or not
    at all, no other kernel; over a mesh of n > 1 members, a device join
    step packs 2n times, exchanges twice, joins on
    each member and sums the overflow with one mesh_combine.  An exchange
    is one launch per card."""
    import torch
    counters = launch_counters()
    for f in counters.values():
        f.launches = 0
    t0 = time.perf_counter()
    r = cl.execute(sql)
    if cl.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = {k: f.launches for k, f in counters.items()}
    for k, v in got.items():
        launches[k] += v
    if r.rows != want:
        raise AssertionError(f"{phase} {qname} {run_kind}: rows differ from "
                             f"the numpy oracle: {r.rows} != {want}")
    shuffle = r.explain.get("shuffle", "")
    if r.explain["strategy"] != "join:repartition" \
            or ("devjoin" in shuffle) != devjoin:
        raise AssertionError(f"{phase} {qname}: EXPLAIN {r.explain}")
    if cl.device.type == "cuda":
        m = cl.mesh.shape["shard"]
        want_l = {"partition_pack": 2, "sorted_join": 1 if devjoin else 0}
        if m > 1:
            cards = len({cl.mesh.device_of(d) for d in range(m)})
            want_l = {"partition_pack": 2 * m, "exchange_blocks": 2 * cards,
                      "sorted_join": m if devjoin else 0,
                      "mesh_combine": 1 if devjoin else 2}
        if {k: v for k, v in got.items() if v} != \
                {k: v for k, v in want_l.items() if v}:
            raise AssertionError(f"{phase} {qname} {run_kind}: launches "
                                 f"{got}, expected {want_l}")
    steps = r.explain.get("device_join_steps", [])
    detail = "; ".join(
        f"device join step: {s['rows_left']} x {s['rows_right']} rows, "
        f"{s['groups']} groups, capacities {s['capacity_left']} / "
        f"{s['capacity_right']}, join_cap {s['join_cap']}; host group ids "
        f"(keys, np.unique, counts, stacking) {s['gid_host_ms']:.3f} ms, "
        f"H2D {s['h2d_ms']:.3f} ms, on the card (launch to overflow read) "
        f"{s['device_ms']:.3f} ms, D2H {s['d2h_ms']:.3f} ms"
        for s in steps)
    say(f"{phase} {qname} {run_kind}: rows {r.rows} equal the numpy oracle "
        f"in {dt:.4f} s, {(n_rows + n_orders) / dt:.1f} rows/s "
        f"((lineitem + orders_b rows) / s); EXPLAIN {r.explain['strategy']} "
        f"{shuffle}; kernel launches {({k: v for k, v in got.items() if v})}"
        f"{'; ' + detail if detail else ''} ({card})")


def run_c1_projections(cl, cols: dict, n_rows: int, launches: dict,
                       card: str, phase: str = "phase 8",
                       remote_batches: int = 0) -> None:
    """C1's five WHEREs as projections over ``events``: rows equal to
    numpy's, one generated filter_mask launch per scanned batch on the
    card (``remote_batches`` more where a second coordinator in this
    process scans its shards for pushed tasks) and no other kernel."""
    import torch
    for where in C1_WHERES:
        counters = launch_counters()
        for f in counters.values():
            f.launches = 0
        t0 = time.perf_counter()
        r = cl.execute(f"SELECT id FROM events WHERE {where} ORDER BY id")
        if cl.device.type == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = {k: f.launches for k, f in counters.items()}
        for k, v in got.items():
            launches[k] += v
        want = c1_oracle(cols, where)
        if r.rows != want:
            raise AssertionError(f"{phase} C1 [{where}]: {len(r.rows)} rows, "
                                 f"the numpy oracle {len(want)}")
        batches = r.explain["pipeline"]["filter_dispatches"]
        if cl.device.type == "cuda" and (
                got["filter_mask"] != batches + remote_batches
                or batches == 0
                or any(v for k, v in got.items() if k != "filter_mask")):
            raise AssertionError(f"{phase} C1 [{where}]: launches {got} for "
                                 f"{batches} batches")
        say(f"{phase} C1 [{where}]: {len(r.rows)} rows equal the numpy oracle "
            f"in {dt:.4f} s ({n_rows / dt:.1f} rows/s), filter_mask launches "
            f"{got['filter_mask']} for {batches} batches ({card})")


#: events rows of the two-coordinator C1 check
PAIR_C1_ROWS = 262_144


def run_c1_pushed(ctt, tmp: str, launches: dict, card: str,
                  device=None) -> None:
    """C1's five WHEREs pushed: two coordinators, events loaded through
    A with half its shards on B; each projection pushes one task per
    remote shard (B filters its shards through its own generated
    predicate) with no fallback, and its rows equal numpy's."""
    from citus_tpu_torch.executor.executor import GLOBAL_COUNTERS
    a, b = open_pair(ctt, os.path.join(tmp, "c1pair"), device)
    try:
        cols = load_events(a, PAIR_C1_ROWS)
        t = a.catalog.table("events")
        n_remote = sum(a.catalog.is_remote_node(s.placements[0])
                       for s in t.shards)
        a.execute("SET citus.remote_task_execution = auto")
        c0 = GLOBAL_COUNTERS.snapshot()
        # each of B's shards holds one batch at this size
        run_c1_projections(a, cols, PAIR_C1_ROWS, launches, card,
                           "phase 8 pushed", remote_batches=n_remote)
        c1 = GLOBAL_COUNTERS.snapshot()
        pushed = c1.get("remote_tasks_pushed", 0) \
            - c0.get("remote_tasks_pushed", 0)
        fallbacks = c1.get("remote_task_fallbacks", 0) \
            - c0.get("remote_task_fallbacks", 0)
        if n_remote != SHARDS // 2 or pushed != n_remote * len(C1_WHERES) \
                or fallbacks:
            raise AssertionError(f"phase 8 pushed C1: {pushed} tasks pushed, "
                                 f"{fallbacks} fallbacks, {n_remote} remote "
                                 "shards")
        say(f"phase 8 pushed C1: {pushed} tasks pushed to B "
            f"({n_remote} remote shards x {len(C1_WHERES)} queries), no "
            f"fallback ({card})")
    finally:
        b.close()
        a.close()


def run_join_phase(ctt, cl, cols: dict, tmp: str, n_rows: int,
                   launches: dict, card: str) -> list:
    """Phase 8 on the SF1 lineitem of ``cl``: bench.py's orders_b,
    QJOIN cold and warm through the device join (B7 twice, B8 once),
    its LEFT JOIN through the bucket path (B7 twice), then an events
    table of the same scale for C1's five projections, serial and
    coalesced, and pushed between two coordinators.  -> QJOIN's oracle
    rows."""
    n_orders = n_rows // 4
    flag = load_orders_b(cl, n_orders)
    want = oracle_qjoin(cols, flag)
    for run_kind in ("cold", "warm"):
        run_join_query(cl, "QJOIN", QJOIN, want, run_kind, n_rows, n_orders,
                       launches, True, card)
    run_join_query(cl, "QJOIN LEFT JOIN", QJOIN_LEFT, oracle_qjoin_left(cols),
                   "cold", n_rows, n_orders, launches, False, card)
    ev = load_events(cl, n_rows)
    run_c1_projections(cl, ev, n_rows, launches, card)
    kind, variants = c1_families()["C1"]
    for k, v in run_family(cl, "C1", kind, variants, ev, n_rows,
                           card).items():
        launches[k] += v
    run_c1_pushed(ctt, tmp, launches, card, cl.device)
    return want


# ------------------------------------------------------------- phase 10

#: warm runs of each phase-10 query after its cold run, and the warm
#: runs of Q15 between the two reads of the allocated device memory
#: phase 10's warm runs a query (3, not 5, to keep the script under its
#: time limit with phase 11)
P10_WARM = 3
P10_MEMORY_RUNS = 20


def cpu_backend_rows(cl, sql: str, params=None) -> list:
    """The rows of the port's numpy ``cpu`` backend on the same tables."""
    cl.execute("SET citus.task_executor_backend = cpu")
    try:
        return cl.execute(sql, params=params).rows
    finally:
        cl.execute("SET citus.task_executor_backend = gpu")


def same_rows(got: list, want: list) -> bool:
    """Identical rows, floats within rel 1e-12 (an intermediate table
    reorders rows, so a float sum may differ in its last bits)."""
    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        if len(g) != len(w):
            return False
        for a, b in zip(g, w):
            if isinstance(a, float) and isinstance(b, float):
                if not (a == b or abs(a - b) <= 1e-12 * max(abs(a), abs(b))
                        or (a != a and b != b)):
                    return False
            elif type(a) is not type(b) or a != b:
                return False
    return True


def phase10_run(cl, label: str, sql: str, want: list, launches: dict,
                card: str) -> None:
    """One phase-10 query cold, then P10_WARM times warm: rows equal
    ``want`` every time, no nvcc build in the warm runs, a kernel of the
    port launched in each.  Adds the launches of every run to
    ``launches``."""
    import torch
    from citus_tpu_torch.ops import cuda_build
    counters = launch_counters()
    times, builds, warm_launches = [], [], {}
    for i in range(1 + P10_WARM):
        for f in counters.values():
            f.launches = 0
        b0 = cuda_build.BUILDS["count"]
        t0 = time.perf_counter()
        rows = cl.execute(sql).rows
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        builds.append(cuda_build.BUILDS["count"] - b0)
        if not same_rows(rows, want):
            raise AssertionError(
                f"phase 10 {label} run {i}: rows differ from the cpu "
                f"backend's:\n{rows[:10]}\n{want[:10]}")
        warm_launches = {k: f.launches for k, f in counters.items()
                         if f.launches}
        for k, v in warm_launches.items():
            launches[k] += v
    if sum(builds[1:]):
        raise AssertionError(f"phase 10 {label}: {builds[1:]} nvcc builds "
                             "in the warm runs")
    if not warm_launches:
        raise AssertionError(f"phase 10 {label}: no kernel of the port "
                             "launched in a warm run")
    say(f"phase 10 {label}: {len(want)} rows equal the cpu backend's; cold "
        f"{times[0]:.4f} s (nvcc builds {builds[0]}), warm median "
        f"{float(np.median(times[1:])) * 1e3:.3f} ms of {P10_WARM} runs "
        f"(nvcc builds 0); launches in one warm run {warm_launches} "
        f"({card})")


def profile_phase10(cl, runs: list, card: str,
                    phase: str = "phase 10") -> None:
    """One more warm run of each phase-10 query, all in one
    torch.profiler session idling PROFILE_RETRY_PAUSE_S at each end (a
    session of one short query loses its device records late in a long
    process, see ``profiled_kernels``), each query's device records
    told apart by its window on the session's clock (a query ends
    synchronized, and 50 ms pass before the next): the card must run
    the port's kernels and no other.  The queries whose window lacks
    kernels the wrappers launched run again in another session, up to
    PROFILE_SESSIONS sessions in all; a kernel not of the port in any
    session fails.  ``runs``: (label, run the query)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    counters = launch_counters()
    done, others, pending = {}, {}, list(runs)
    for attempt in range(1, PROFILE_SESSIONS + 1):
        windows = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_RETRY_PAUSE_S)
            for label, run in pending:
                start = (time.perf_counter() - t0) * 1e3
                n0 = sum(f.launches for f in counters.values())
                run()
                torch.cuda.synchronize()
                windows.append((label, start,
                                (time.perf_counter() - t0) * 1e3,
                                sum(f.launches for f in counters.values())
                                - n0))
                time.sleep(0.05)
            time.sleep(PROFILE_RETRY_PAUSE_S)
        seen = {label: [0, 0, 0] for label, _ in pending}
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            at = e.time_range.start / 1e3
            label = next((w[0] for w in windows if w[1] <= at <= w[2]),
                         None)
            if label is None:
                continue
            rec = seen[label]
            if e.name.lower().startswith(("memcpy", "memset")):
                rec[2] += 1
            elif any(k in e.name for k in PORT_KERNELS):
                rec[0] += 1
            else:
                rec[1] += 1
                others.setdefault(label, {})
                others[label][e.name] = others[label].get(e.name, 0) + 1
        for label, start, end, n in windows:
            port, other, copies = seen[label]
            if port >= n:
                done[label] = (port, other, copies, n, end - start, attempt)
        pending = [(label, run) for label, run in pending
                   if label not in done]
        if not pending:
            break
        say(f"{phase} profiled session {attempt} lacked kernels the "
            f"wrappers launched for {[label for label, _ in pending]}; "
            "those once more")
    if pending:
        raise AssertionError(f"{phase}: torch.profiler recorded fewer "
                             f"kernels than were launched for "
                             f"{[label for label, _ in pending]} in "
                             f"{PROFILE_SESSIONS} sessions")
    for label, _ in runs:
        port, other, copies, n, ms, attempt = done[label]
        say(f"{phase} {label} warm under torch.profiler: {port} kernels of "
            f"the port ({n} launched), {other} other, {copies} copies and "
            f"sets in its {ms:.3f} ms window (session {attempt}) ({card})")
        if label in others or port != n:
            raise AssertionError(f"{phase} {label} warm: the profiler saw "
                                 f"{port} of the port's {n} kernels and "
                                 f"others {others.get(label)}")


def phase10_params(cl, cols: dict, launches: dict, card: str):
    """Q6 with $1..$5 under phase 5's 8 value sets, through
    ``execute(sql, params)`` and then PREPARE, 8 EXECUTEs and
    DEALLOCATE: each set's rows equal the literal Q6's (on the card) and
    the numpy oracle's; one plan-cache miss and 15 hits; no nvcc build
    after the first execution.  -> a run of it to profile."""
    import torch
    from citus_tpu_torch.ops import cuda_build
    sets = [q6_params(i) for i in range(Q_BATCH)]
    wants = []
    for i in range(Q_BATCH):
        year, disc, qty = 1993 + i % 5, 2 + i, 24 + i % 2
        want = oracle_q6(cols, year, disc, qty)
        literal = cl.execute(q6_variant(year, disc, qty)).rows
        if literal != want:
            raise AssertionError(f"phase 10 i: the literal Q6 {i} gives "
                                 f"{literal}, the oracle {want}")
        wants.append(want)
    counters = launch_counters()
    for f in counters.values():
        f.launches = 0
    c0 = cl.counters.snapshot()
    session = cl.session()
    times, builds = [], []
    for way in ("execute", "prepare"):
        if way == "prepare":
            session.execute("PREPARE q6 (date, date, numeric, numeric, "
                            f"bigint) AS {Q6_PARAM}")
        for i, p in enumerate(sets):
            b0 = cuda_build.BUILDS["count"]
            t0 = time.perf_counter()
            if way == "execute":
                rows = cl.execute(Q6_PARAM, params=p).rows
            else:
                args = (f"date '{p[0]}', date '{p[1]}', {p[2]}, {p[3]}, "
                        f"{p[4]}")
                rows = session.execute(f"EXECUTE q6 ({args})").rows
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            builds.append(cuda_build.BUILDS["count"] - b0)
            if rows != wants[i]:
                raise AssertionError(
                    f"phase 10 i {way} set {i}: {rows} != {wants[i]}")
    session.execute("DEALLOCATE q6")
    c1 = cl.counters.snapshot()
    misses = c1.get("plan_cache_misses", 0) - c0.get("plan_cache_misses", 0)
    hits = c1.get("plan_cache_hits", 0) - c0.get("plan_cache_hits", 0)
    if (misses, hits) != (1, 2 * Q_BATCH - 1):
        raise AssertionError(f"phase 10 i: {misses} plan-cache misses and "
                             f"{hits} hits, not 1 and {2 * Q_BATCH - 1}")
    if sum(builds[1:]):
        raise AssertionError(f"phase 10 i: nvcc builds after the first "
                             f"execution: {builds}")
    got = {k: f.launches for k, f in counters.items() if f.launches}
    for k, v in got.items():
        launches[k] += v
    say(f"phase 10 i Q6 $1..$5: {2 * Q_BATCH} executions (8 through "
        f"execute(sql, params), 8 through PREPARE/EXECUTE) equal the "
        f"literal Q6 and the numpy oracle; plan cache {misses} miss, "
        f"{hits} hits; first execution {times[0]:.4f} s (nvcc builds "
        f"{builds[0]}), the other {len(times) - 1} median "
        f"{float(np.median(times[1:])) * 1e3:.3f} ms (nvcc builds 0); "
        f"launches {got} ({card})")
    return lambda: cl.execute(Q6_PARAM, params=sets[-1])


def run_phase10(cl, cols: dict, launches: dict, card: str) -> None:
    """The rest of SELECT on phase 4's SF1 lineitem, on the card: the
    queries of ``phase10_queries``, each against the cpu backend (Q15
    also against numpy), the allocated device memory around 20 more
    warm runs of Q15, the parameterized Q6, then one more warm run of
    each under torch.profiler."""
    import torch
    t_phase = time.perf_counter()
    cl.execute("SET citus.megabatch_window_ms = 0")
    keys = len(cl.execute(in_subquery()).rows)
    say(f"phase 10 b: the IN-subquery returns {keys} keys (suppliers with "
        f"more than {IN_THRESHOLD} shipped in June 1995)")
    runs = []
    for label, sql in phase10_queries():
        t0 = time.perf_counter()
        want = cpu_backend_rows(cl, sql)
        cpu_s = time.perf_counter() - t0
        if label.startswith("a "):
            oracle = oracle_q15(cols)
            if want != oracle:
                raise AssertionError(f"phase 10 Q15: the cpu backend gives "
                                     f"{want}, numpy {oracle}")
        say(f"phase 10 {label}: the cpu backend's rows in {cpu_s:.4f} s")
        phase10_run(cl, label, sql, want, launches, card)
        runs.append((label, lambda sql=sql: cl.execute(sql)))
    before = torch.cuda.memory_allocated()
    for _ in range(P10_MEMORY_RUNS):
        cl.execute(Q15)
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    leftovers = [n for n in cl.catalog.tables if n.startswith("__")]
    if after > before or leftovers:
        raise AssertionError(f"phase 10 Q15: allocated device memory "
                             f"{before} -> {after} B over "
                             f"{P10_MEMORY_RUNS} warm runs; tables left "
                             f"{leftovers}")
    say(f"phase 10 a Q15: torch.cuda.memory_allocated() {before} B before "
        f"and {after} B after {P10_MEMORY_RUNS} more warm runs, no "
        f"intermediate table left ({card})")
    runs.append(("i Q6 $1..$5", phase10_params(cl, cols, launches, card)))
    profile_phase10(cl, runs, card)
    say(f"phase 10 took {time.perf_counter() - t_phase:.3f} s ({card})")


def ph11_statement(cl, label: str, run, got, want: list, launches: dict,
                   card: str, reset=None, cpu_want=None,
                   phase: str = "phase 11", warm: int = P11_WARM) -> list:
    """One statement of ``phase`` cold, then ``warm`` times warm:
    ``reset()`` (untimed) before each run, ``run()`` timed,
    ``got(result)`` -> the rows to hold against ``want`` (numpy's) and,
    when given, against ``cpu_want(result)`` (the port's numpy ``cpu``
    backend's, after the cold run); no nvcc build in a warm run.  Adds
    each run's launches to ``launches``.  -> [seconds of each run]."""
    import torch
    from citus_tpu_torch.ops import cuda_build
    counters = launch_counters()
    times, builds, per_run = [], [], {}
    for i in range(1 + warm):
        if reset is not None:
            reset()
        for f in counters.values():
            f.launches = 0
        b0 = cuda_build.BUILDS["count"]
        t0 = time.perf_counter()
        r = run()
        if cl.device.type == "cuda":
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        builds.append(cuda_build.BUILDS["count"] - b0)
        per_run = {k: f.launches for k, f in counters.items() if f.launches}
        for k, v in per_run.items():
            launches[k] += v
        rows = got(r)
        if not same_rows(rows, want):
            raise AssertionError(f"{phase} {label} run {i}: rows differ "
                                 f"from numpy's:\n{rows[:8]}\n{want[:8]}")
        if i == 0 and cpu_want is not None:
            cpu = cpu_want(r)
            if not same_rows(rows, cpu):
                raise AssertionError(f"{phase} {label}: rows differ from "
                                     f"the cpu backend's:\n{rows[:8]}\n"
                                     f"{cpu[:8]}")
    if sum(builds[1:]):
        raise AssertionError(f"{phase} {label}: {builds[1:]} nvcc builds "
                             "in the warm runs")
    say(f"{phase} {label}: {len(want)} rows equal numpy's"
        + (" and the cpu backend's" if cpu_want is not None else "")
        + f"; cold {times[0]:.4f} s (nvcc builds {builds[0]}), warm "
        f"{', '.join(f'{t:.4f}' for t in times[1:])} s (nvcc builds 0); "
        f"launches in the last run {per_run} ({card})")
    return times


def ph11_load(ctt, cl, cols: dict, card: str) -> None:
    """(a) lineitem_m: 84 monthly partitions, distributed, one copy_from
    of phase 4's rows routed to them; each partition's count against
    numpy's."""
    t0 = time.perf_counter()
    for sql in PH11_DDL:
        cl.execute(sql)
    parts = cl.catalog.partitions_of("lineitem_m")
    if len(parts) != PH11_PARTITIONS:
        raise AssertionError(f"phase 11: {len(parts)} partitions, not "
                             f"{PH11_PARTITIONS}")
    ddl_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    n = cl.copy_from("lineitem_m", columns=copy_columns(cols))
    load_s = time.perf_counter() - t0
    if n != len(cols["ship"]):
        raise AssertionError(f"phase 11 load: {n} rows of "
                             f"{len(cols['ship'])}")
    from citus_tpu_torch.catalog.stats import table_row_count
    for p in parts:
        lo, hi = p.partition_of["lo"], p.partition_of["hi"]
        want = int(((cols["ship"] >= lo) & (cols["ship"] < hi)).sum())
        got = table_row_count(cl.catalog, p)
        if got != want:
            raise AssertionError(f"phase 11: {p.name} holds {got} rows, "
                                 f"numpy {want}")
    say(f"phase 11 a load: {PH11_PARTITIONS} partitions x {SHARDS} shards "
        f"created in {ddl_s:.3f} s; one copy_from of {n} rows routed to "
        f"them in {load_s:.3f} s ({n / load_s:.1f} rows/s); each "
        f"partition's row count (its placements' stripe metadata) equals "
        f"numpy's ({card})")


def ph11_queries(cl, cols: dict, launches: dict, card: str) -> list:
    """(b) Q6 of one month (one survivor), Q6 as written (12 survivors,
    the UNION ALL of pruned arms), P1 over the parent, and the EXPLAIN.
    -> (label, run) for the profiled run."""
    wants = {"b1 Q6 of June 1994": oracle_q6_month(cols),
             "b2 Q6": oracle_q6(cols), "b3 P1": oracle_p1(cols)}
    runs = []
    for label, sql in PH11_QUERIES.items():
        ph11_statement(cl, label, lambda sql=sql: cl.execute(sql),
                       lambda r: r.rows, wants[label], launches, card,
                       cpu_want=lambda r, sql=sql: cpu_backend_rows(cl, sql))
        runs.append((label, lambda sql=sql: cl.execute(sql)))
    plan = [r[0] for r in cl.execute(PH11_EXPLAIN).rows]
    if not plan[0].startswith("Append on lineitem_m (partitions: 12/84)"):
        raise AssertionError(f"phase 11 EXPLAIN: {plan}")
    say("phase 11 b EXPLAIN of Q6 as written: " + " | ".join(plan))
    return runs


def ph11_inserts(cl, cols: dict, launches: dict, card: str) -> list:
    """(c) INSERT ... SELECT of June 1994 through the colocated and the
    repartition rungs, the pull rung and its upsert, CREATE TABLE AS of
    H1 over the month, UPDATE and DELETE ... RETURNING of one day.
    -> (label, run) for the profiled run."""
    june = month_mask(cols)
    runs = []
    for label, (table, key, sql) in PH11_INSERTS.items():
        cl.execute(lineitem_named(table))
        cl.execute(f"SELECT create_distributed_table('{table}', '{key}', "
                   f"{SHARDS})")
        check = PH11_TARGET_CHECK.format(t=table)

        def run(sql=sql, label=label):
            r = cl.execute(sql)
            if r.explain["strategy"] != "insert_select:" + label.split()[1]:
                raise AssertionError(f"phase 11 {label}: {r.explain}")
            return r
        ph11_statement(cl, label, run,
                       lambda r, check=check: cl.execute(check).rows,
                       oracle_target(cols, june), launches, card,
                       reset=lambda t=table: cl.execute(f"TRUNCATE {t}"),
                       cpu_want=lambda r, check=check: cpu_backend_rows(
                           cl, check))
        runs.append((label, lambda run=run, t=table: (
            cl.execute(f"TRUNCATE {t}"), run())))
    cl.execute(DAILY_DDL)
    cl.execute(f"SELECT create_distributed_table('daily', 'l_shipdate', "
               f"{SHARDS})")

    def pull():
        r = cl.execute(INSERT_DAILY)
        if r.explain["strategy"] != "insert_select:pull":
            raise AssertionError(f"phase 11 c3: {r.explain}")
        return r
    ph11_statement(cl, "c3 pull", pull,
                   lambda r: cl.execute(DAILY_CHECK).rows,
                   oracle_daily(cols), launches, card,
                   reset=lambda: cl.execute("TRUNCATE daily"),
                   cpu_want=lambda r: cpu_backend_rows(cl, DAILY_CHECK))
    runs.append(("c3 pull", lambda: (cl.execute("TRUNCATE daily"), pull())))

    def upsert():
        r = cl.execute(UPSERT_DAILY)
        if r.explain["strategy"] != "insert_select:upsert_pull" \
                or r.explain["updated"] != len(np.unique(cols["ship"])):
            raise AssertionError(f"phase 11 c4: {r.explain}")
        return r
    ph11_statement(cl, "c4 upsert_pull (ON CONFLICT DO UPDATE n = n + "
                   "excluded.n)", upsert,
                   lambda r: cl.execute(DAILY_CHECK).rows,
                   oracle_daily(cols, 2), launches, card,
                   reset=lambda: (cl.execute("TRUNCATE daily"),
                                  cl.execute(INSERT_DAILY)),
                   cpu_want=lambda r: cpu_backend_rows(cl, DAILY_CHECK))

    def ctas():
        r = cl.execute(CTAS_H1)
        return r
    ph11_statement(cl, "c5 CREATE TABLE AS H1 of the month", ctas,
                   lambda r: cl.execute(H1_MONTH_CHECK).rows,
                   oracle_h1_month(cols), launches, card,
                   reset=lambda: cl.execute("DROP TABLE IF EXISTS h1_month"),
                   cpu_want=lambda r: cpu_backend_rows(cl, H1_MONTH_CHECK))
    runs.append(("c5 CREATE TABLE AS", lambda: (
        cl.execute("DROP TABLE IF EXISTS h1_month"), ctas())))
    ph11_statement(cl, "c6 UPDATE ... RETURNING",
                   lambda: cl.execute(UPDATE_RETURNING),
                   lambda r: sorted(r.rows), day_rows(cols, 15, "tax"),
                   launches, card)
    ph11_statement(cl, "c7 DELETE ... RETURNING",
                   lambda: cl.execute(DELETE_RETURNING),
                   lambda r: sorted(r.rows), day_rows(cols, 16, "qty"),
                   launches, card,
                   reset=lambda: cl.execute(REINSERT_JUNE_16)
                   if not cl.execute("SELECT count(*) FROM li_copy WHERE "
                                     "l_shipdate = date '1994-06-16'"
                                     ).rows[0][0] else None)
    return runs


def ph11_integrity(ctt, cl, cols: dict, card: str) -> None:
    """(d) orders_ref (PRIMARY KEY, a reference table of the distinct
    order keys); COPY of June 1994 into a fresh li_fk (distributed,
    l_orderkey REFERENCES orders_ref) cold and P11_WARM times more (the
    FK probe of tens of thousands of keys: ROADMAP.md C12); a batch with
    one missing key refused, the table unchanged; a DELETE of a
    referenced parent row refused."""
    import torch
    from citus_tpu_torch.integrity import ForeignKeyViolation
    from citus_tpu_torch.ops import cuda_build
    keys = np.unique(cols["orderkey"])
    cl.execute(ORDERS_REF_DDL)
    cl.execute("SELECT create_reference_table('orders_ref')")
    t0 = time.perf_counter()
    cl.copy_from("orders_ref", columns={"o_orderkey": keys})
    ref_s = time.perf_counter() - t0
    june = month_mask(cols)
    sub = {k: v[june] for k, v in cols.items()}
    batch = copy_columns(sub)
    n_keys = len(np.unique(sub["orderkey"]))
    times, builds = [], []
    for i in range(1 + P11_WARM):
        name = f"li_fk{i}"
        cl.execute(lineitem_named(name, "orders_ref (o_orderkey)"))
        cl.execute(f"SELECT create_distributed_table('{name}', "
                   f"'l_orderkey', {SHARDS})")
        b0 = cuda_build.BUILDS["count"]
        t0 = time.perf_counter()
        n = cl.copy_from(name, columns=batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        builds.append(cuda_build.BUILDS["count"] - b0)
        if n != int(june.sum()):
            raise AssertionError(f"phase 11 d: {n} rows into {name}")
    if sum(builds):
        raise AssertionError(f"phase 11 d: nvcc builds in the FK loads "
                             f"{builds}")
    check = PH11_TARGET_CHECK.format(t="li_fk0")
    before = cl.execute(check).rows
    if not same_rows(before, oracle_target(cols, june)):
        raise AssertionError(f"phase 11 d: li_fk0 holds {before}")
    missing = int(keys.max()) + 5
    bad = {k: (list(v[:99]) + [missing if k == "l_orderkey" else v[0]])
           for k, v in batch.items()}
    bad = {k: np.asarray(v) if isinstance(batch[k], np.ndarray) else v
           for k, v in bad.items()}
    try:
        cl.copy_from("li_fk0", columns=bad)
    except ForeignKeyViolation as e:
        refused = str(e)
    else:
        raise AssertionError("phase 11 d: a missing key was loaded")
    if cl.execute(check).rows != before:
        raise AssertionError("phase 11 d: the refused batch changed li_fk0")
    k0 = int(sub["orderkey"][0])
    try:
        cl.execute(f"DELETE FROM orders_ref WHERE o_orderkey = {k0}")
    except ForeignKeyViolation as e:
        restrict = str(e)
    else:
        raise AssertionError("phase 11 d: a referenced parent row was "
                             "deleted")
    say(f"phase 11 d: orders_ref loaded with {len(keys)} keys (PRIMARY "
        f"KEY, reference table) in {ref_s:.3f} s; COPY of {int(june.sum())} "
        f"rows with {n_keys} distinct keys into a fresh FK-checked li_fk: "
        f"cold {times[0]:.4f} s, warm "
        f"{', '.join(f'{t:.4f}' for t in times[1:])} s "
        f"({int(june.sum()) / float(np.median(times[1:])):.1f} rows/s), "
        f"nvcc builds {builds}; a batch with one missing key refused "
        f"({refused!r}), li_fk0 unchanged; DELETE of a referenced row "
        f"refused ({restrict!r}) ({card})")
    for i in range(1 + P11_WARM):
        cl.execute(f"DROP TABLE li_fk{i}")
    cl.execute("DROP TABLE orders_ref")


def ph11_retention(cl, cols: dict, card: str) -> None:
    """(e) drop_old_time_partitions before 1993, the parent's count,
    DROP of the parent."""
    t0 = time.perf_counter()
    r = cl.execute(PH11_RETENTION)
    drop_s = time.perf_counter() - t0
    left = len(cl.catalog.partitions_of("lineitem_m"))
    t0 = time.perf_counter()
    got = cl.execute("SELECT count(*) FROM lineitem_m").rows
    count_s = time.perf_counter() - t0
    want = [(int((cols["ship"] >= _day(1993, 1, 1)).sum()),)]
    if r.rows != [(12,)] or left != PH11_PARTITIONS - 12 or got != want:
        raise AssertionError(f"phase 11 e: dropped {r.rows}, {left} left, "
                             f"count {got} against numpy's {want}")
    cl.execute("DROP TABLE lineitem_m")
    rest = [n for n in cl.catalog.tables if n.startswith("lineitem_m")]
    if rest:
        raise AssertionError(f"phase 11 e: DROP left {rest}")
    say(f"phase 11 e: drop_old_time_partitions dropped 12 partitions in "
        f"{drop_s:.3f} s, {left} left; the parent counts {got[0][0]} rows "
        f"(numpy's) in {count_s:.3f} s (a UNION ALL of {left} arms); DROP "
        f"TABLE lineitem_m dropped its partitions ({card})")


def run_phase11(ctt, cl, cols: dict, launches: dict, card: str,
                sources: list) -> None:
    """A11's local write surface on phase 4's SF1 lineitem, on the card:
    (a)-(e) of ``ph11_*``, then one more warm run of (b) and (c) under
    torch.profiler; the B1, B2 and B4 launches of the phase.  The
    generated ``sources`` (``phase11_sources``) build during the load,
    one nvcc each, all started together."""
    from citus_tpu_torch.ops import cuda_build
    t_phase = time.perf_counter()
    p11 = dict.fromkeys(launch_counters(), 0)
    jobs = [cuda_build.start_generated(name, src) for name, src in sources]
    ph11_load(ctt, cl, cols, card)
    t0 = time.perf_counter()
    for job in jobs:
        cuda_build.finish_generated(job)
    say(f"phase 11 build of its {len(jobs)} generated kernels during the "
        f"load: {time.perf_counter() - t0:.3f} s of it after the load")
    runs = ph11_queries(cl, cols, p11, card)
    runs += ph11_inserts(cl, cols, p11, card)
    ph11_integrity(ctt, cl, cols, card)
    profile_phase10(cl, runs, card, "phase 11")
    for t in ("li_copy", "li_supp", "daily", "h1_month"):
        cl.execute(f"DROP TABLE {t}")
    ph11_retention(cl, cols, card)
    for k, v in p11.items():
        launches[k] += v
    say(f"phase 11 launches: B1 scan_agg_fold {p11['scan_agg_fold']}, B2 "
        f"hash_agg_insert {p11['hash_agg_insert']}, B4 filter_mask "
        f"{p11['filter_mask']} ({card})")
    say(f"phase 11 took {time.perf_counter() - t_phase:.3f} s ({card})")


# ------------------------------------------------------------- phase 12

def ph12_orders(n_orders: int, rows: int = None) -> dict:
    """Phase 8's orders_b arrays (bench.py's generator, seed 11), or
    their first ``rows``: key, custkey, flag index."""
    chunks, got = [], 0
    for c in orders_b_chunks(n_orders):
        chunks.append(c)
        got += len(c["o_orderkey"])
        if rows is not None and got >= rows:
            break
    out = {"key": np.concatenate([c["o_orderkey"] for c in chunks]),
           "cust": np.concatenate([c["o_custkey"] for c in chunks]),
           "flag": np.concatenate([c["flag"] for c in chunks])}
    return {k: v[:rows] for k, v in out.items()} if rows else out


def ph12_staging(orders: dict, n_orders: int, seed: int = 12,
                 updates: int = PH12_UPDATES, rf1: int = PH12_RF1,
                 rf2: int = PH12_RF2) -> dict:
    """Phase 12 (b)'s staging rows: ``delta`` (RF1's ``rf1`` new orders
    after the last key and ``updates`` existing orders with a new
    custkey and flag), ``rf2`` (that many existing orders the delta
    leaves alone) and ``dup`` (one existing key twice)."""
    rng = np.random.default_rng(seed)
    keys = orders["key"]
    upd = np.sort(rng.choice(keys, updates, replace=False))
    top = int(keys.max()) + 1
    dkeys = np.concatenate([upd, np.arange(top, top + rf1)])
    delta = {"key": dkeys,
             "cust": rng.integers(0, n_orders // 8 + 1, len(dkeys)),
             "flag": rng.integers(0, 3, len(dkeys))}
    rf2 = np.sort(rng.choice(np.setdiff1d(keys, upd), rf2,
                             replace=False))
    return {"delta": delta, "rf2": rf2,
            "dup": np.array([int(upd[0]), int(upd[0])], np.int64)}


def ph12_merge_state(state: dict, delta: dict) -> dict:
    """numpy's MERGE of ``delta`` into ``state`` (both by key; state
    sorted by key): matched rows take the delta's custkey and flag,
    the others are inserted."""
    k = state["key"]
    i = np.minimum(np.searchsorted(k, delta["key"]), len(k) - 1)
    hit = k[i] == delta["key"]
    cust, flag = state["cust"].copy(), state["flag"].copy()
    cust[i[hit]] = delta["cust"][hit]
    flag[i[hit]] = delta["flag"][hit]
    out = {"key": np.concatenate([k, delta["key"][~hit]]),
           "cust": np.concatenate([cust, delta["cust"][~hit]]),
           "flag": np.concatenate([flag, delta["flag"][~hit]])}
    order = np.argsort(out["key"], kind="stable")
    return {c: v[order] for c, v in out.items()}


def ph12_oracle(state: dict, check: str) -> list:
    """numpy's rows of PH12_CHECKS[check] over ``state``."""
    if check == "count and sums":
        return [(len(state["key"]), int(state["cust"].sum()),
                 int(state["key"].sum()))]
    counts = np.bincount(state["flag"], minlength=len(FLAGS))
    return [(str(FLAGS[f]), int(n)) for f, n in enumerate(counts) if n]


def ph12_ndistinct(state: dict) -> int:
    return len(np.unique(state["cust"] * len(FLAGS) + state["flag"]))


def ph12_lines(state: dict, delim: str) -> list:
    """The rows of ``state`` as dbgen / COPY write them, one a line."""
    return [f"{k}{delim}{c}{delim}{w}" for k, c, w in zip(
        state["key"].tolist(), state["cust"].tolist(),
        FLAGS[state["flag"]].tolist())]


def ph12_columns(state: dict) -> dict:
    return {"o_orderkey": state["key"], "o_custkey": state["cust"],
            "o_flag": FLAGS[state["flag"]].tolist()}


def ph12_checks(cl, table: str, state: dict, launches: dict, card: str,
                label: str, flag: str = "o_flag", warm: int = P12_WARM):
    """The Q checks of ``table`` (its count, sum(o_custkey) and
    sum(o_orderkey), its o_flag counts), each cold and ``warm`` times warm, against numpy's
    ``state`` and the cpu backend."""
    for name, sql in PH12_CHECKS.items():
        q = sql.format(t=table, f=flag)
        ph11_statement(cl, f"{label}: {name}", lambda q=q: cl.execute(q),
                       lambda r: r.rows, ph12_oracle(state, name), launches,
                       card, cpu_want=lambda r, q=q: cpu_backend_rows(cl, q),
                       phase="phase 12", warm=warm)


def ph12_check_rows(cl) -> list:
    """The rows of the Q checks of orders_m, run once."""
    return [tuple(r) for sql in PH12_CHECKS.values()
            for r in cl.execute(sql.format(t="orders_m", f="o_flag")).rows]


def ph12_want(state: dict) -> list:
    """numpy's rows of ``ph12_check_rows``."""
    return [r for name in PH12_CHECKS for r in ph12_oracle(state, name)]


def ph12_create(cl, name: str, ddl: str, columns: dict) -> None:
    cl.execute(ddl)
    cl.execute(f"SELECT create_distributed_table('{name}', 'o_orderkey', "
               f"{SHARDS})")
    cl.copy_from(name, columns=columns)


def ph12_copy(cl, tmp: str, state: dict, launches: dict, card: str,
              sources: list) -> list:
    """(a) orders_m loaded from a dbgen-style `|` file by COPY FROM, its
    CSV export, a binary round trip into orders_m2, COPY (SELECT ...)
    TO.  The generated ``sources`` build during the load.  -> (label,
    run) for the profiled run."""
    from citus_tpu_torch.ops import cuda_build
    n = len(state["key"])
    cl.execute(ORDERS_M_DDL.format(t="orders_m"))
    cl.execute("SELECT create_distributed_table('orders_m', 'o_orderkey', "
               f"{SHARDS})")
    tbl = os.path.join(tmp, "orders.tbl")
    t0 = time.perf_counter()
    with open(tbl, "w") as fh:
        fh.write("\n".join(ph12_lines(state, "|")) + "\n")
    write_s = time.perf_counter() - t0
    jobs = [cuda_build.start_generated(name, src) for name, src in sources]
    t0 = time.perf_counter()
    r = cl.execute(f"COPY orders_m FROM '{tbl}' WITH (delimiter '|')")
    load_s = time.perf_counter() - t0
    if r.explain != {"copied": n}:
        raise AssertionError(f"phase 12 a load: {r.explain}")
    t0 = time.perf_counter()
    for job in jobs:
        cuda_build.finish_generated(job)
    say(f"phase 12 a COPY orders_m FROM a `|` file ({n} rows, "
        f"{os.path.getsize(tbl)} B, written by numpy in {write_s:.3f} s): "
        f"{load_s:.3f} s ({n / load_s:.1f} rows/s); its {len(jobs)} "
        f"generated kernels built during it, "
        f"{time.perf_counter() - t0:.3f} s after it ({card})")
    ph12_checks(cl, "orders_m", state, launches, card, "a after the load")
    csv_path = os.path.join(tmp, "orders_out.csv")
    first = {}

    def exported(r):
        body = open(csv_path, "rb").read()
        if not first:
            lines = sorted(body.decode().splitlines())
            first["same"] = lines == sorted(ph12_lines(state, ","))
            first["body"] = body
        return [(r.explain["copied"], first["same"] and body == first["body"])]
    times = ph11_statement(
        cl, "a COPY orders_m TO CSV", lambda: cl.execute(
            f"COPY orders_m TO '{csv_path}'"), exported, [(n, True)],
        launches, card, phase="phase 12", warm=P12_WARM_HEAVY)
    say(f"phase 12 a COPY TO CSV: {os.path.getsize(csv_path)} B, its lines "
        f"as a multiset equal numpy's, {n / float(np.median(times)):.1f} "
        f"rows/s (median) ({card})")
    bin_path = os.path.join(tmp, "orders.bin")
    times = ph11_statement(
        cl, "a COPY orders_m TO a binary file", lambda: cl.execute(
            f"COPY orders_m TO '{bin_path}' WITH (format binary)"),
        lambda r: [(r.explain["copied"],)], [(n,)], launches, card,
        phase="phase 12", warm=P12_WARM_HEAVY)
    cl.execute(ORDERS_M_DDL.format(t="orders_m2"))
    cl.execute("SELECT create_distributed_table('orders_m2', 'o_orderkey', "
               f"{SHARDS})")
    t0 = time.perf_counter()
    r = cl.execute(f"COPY orders_m2 FROM '{bin_path}' WITH (format binary)")
    bload_s = time.perf_counter() - t0
    if r.explain != {"copied": n}:
        raise AssertionError(f"phase 12 a binary load: {r.explain}")
    say(f"phase 12 a binary round trip: {os.path.getsize(bin_path)} B "
        f"written at {n / float(np.median(times)):.1f} rows/s (median), "
        f"loaded into orders_m2 in {bload_s:.3f} s ({n / bload_s:.1f} "
        f"rows/s) ({card})")
    ph12_checks(cl, "orders_m2", state, launches, card,
                "a orders_m2 after the binary load", warm=0)
    flags_path = os.path.join(tmp, "flags.csv")
    flags_sql = PH12_FLAGS_QUERY.format(path=flags_path)

    def flag_rows(r):
        rows = [tuple(line.split(",")) for line in
                open(flags_path).read().splitlines()]
        return [(r.explain["copied"],)] + sorted((f, int(c))
                                                 for f, c in rows)
    want = ph12_oracle(state, "o_flag counts")
    ph11_statement(cl, "a COPY (SELECT o_flag, count(*) ...) TO CSV",
                   lambda: cl.execute(flags_sql), flag_rows,
                   [(len(want),)] + want, launches, card,
                   phase="phase 12", warm=P12_WARM)
    return [("a COPY (SELECT ...) TO", lambda: cl.execute(flags_sql))]


def ph12_statistics(cl, state: dict, launches: dict, card: str,
                    label: str, sql: str, reset=None,
                    warm: int = P12_WARM_HEAVY) -> None:
    """CREATE STATISTICS or ANALYZE, cold and ``warm`` times warm: the
    stored ndistinct of (o_custkey, o_flag) equals numpy's."""
    want = ph12_ndistinct(state)

    def got(r):
        refreshed = r.explain.get("statistics_refreshed", 1)
        return [(refreshed, cl.catalog.statistics["st_cust_flag"]
                 ["ndistinct"])]
    ph11_statement(cl, label, lambda: cl.execute(sql), got, [(1, want)],
                   launches, card, reset=reset, phase="phase 12",
                   warm=warm)


def ph12_merge(cl, state: dict, n_orders: int, launches: dict,
               card: str) -> dict:
    """(b) MERGE of the staging table (RF1's new orders and the update
    stream) cold and P12_MERGE_WARM times warm, the RF2 MERGE ...
    DELETE, a source with a duplicate key refused.  A MERGE launches no
    kernel (its join runs on the host, as in the reference).  -> the
    state after it."""
    stage = ph12_staging(state, n_orders)
    delta = stage["delta"]
    ph12_create(cl, "orders_delta", ORDERS_M_DDL.format(
        t="orders_delta").replace(" PRIMARY KEY", " NOT NULL"),
        ph12_columns(delta))
    ph12_create(cl, "orders_rf2", "CREATE TABLE orders_rf2 "
                "(o_orderkey bigint NOT NULL)", {"o_orderkey": stage["rf2"]})
    ph12_create(cl, "orders_dup", "CREATE TABLE orders_dup (o_orderkey "
                "bigint NOT NULL, o_custkey bigint)",
                {"o_orderkey": stage["dup"], "o_custkey": np.zeros(2, int)})
    merged = ph12_merge_state(state, delta)
    counters = launch_counters()
    runs = []

    def merge_rows(r):
        want = ({"updated": PH12_UPDATES, "deleted": 0,
                 "inserted": PH12_RF1} if not runs else
                {"updated": PH12_UPDATES + PH12_RF1, "deleted": 0,
                 "inserted": 0})
        runs.append(r.explain)
        if r.explain != want:
            raise AssertionError(f"phase 12 b MERGE run {len(runs)}: "
                                 f"{r.explain}, not {want}")
        launched = {k: f.launches for k, f in counters.items()
                    if f.launches}
        if launched:
            raise AssertionError(f"phase 12 b: a MERGE launched {launched}")
        rows = ph12_check_rows(cl)
        for k, f in counters.items():
            launches[k] += f.launches
        return rows
    ph11_statement(cl, "b MERGE of orders_delta (WHEN MATCHED UPDATE, WHEN "
                   "NOT MATCHED INSERT); the Q checks after each run",
                   lambda: cl.execute(PH12_MERGE), merge_rows,
                   ph12_want(merged), launches, card, phase="phase 12",
                   warm=P12_MERGE_WARM)
    say(f"phase 12 b MERGE explains: {runs} ({card})")
    ph12_checks(cl, "orders_m", merged, launches, card, "b after MERGE")
    keep = ~np.isin(merged["key"], stage["rf2"])
    after = {c: v[keep] for c, v in merged.items()}
    t0 = time.perf_counter()
    r = cl.execute(PH12_MERGE_RF2)
    rf2_s = time.perf_counter() - t0
    if r.explain != {"updated": 0, "deleted": PH12_RF2, "inserted": 0}:
        raise AssertionError(f"phase 12 b RF2: {r.explain}")
    if ph12_check_rows(cl) != ph12_want(after):
        raise AssertionError("phase 12 b RF2: rows differ from numpy's")
    say(f"phase 12 b RF2's MERGE ... WHEN MATCHED THEN DELETE of "
        f"{PH12_RF2} orders: {rf2_s:.4f} s, {r.explain} ({card})")
    ph12_checks(cl, "orders_m", after, launches, card, "b after RF2")
    from citus_tpu_torch.errors import ExecutionError
    t0 = time.perf_counter()
    try:
        cl.execute(PH12_MERGE_DUP)
    except ExecutionError as e:
        refused = str(e)
    else:
        raise AssertionError("phase 12 b: a duplicate source key merged")
    dup_s = time.perf_counter() - t0
    if ph12_check_rows(cl) != ph12_want(after):
        raise AssertionError("phase 12 b: the refused MERGE changed rows")
    say(f"phase 12 b MERGE of a source with a duplicate key refused in "
        f"{dup_s:.4f} s ({refused!r}); orders_m unchanged ({card})")
    return after


def ph12_alter(cl, state: dict, state2: dict, launches: dict,
               card: str) -> list:
    """(c) ADD COLUMN, ADD CONSTRAINT CHECK validated through B1, a
    violated CHECK refused with numpy's count, RENAME COLUMN, DROP
    COLUMN, RENAME TO, alter_distributed_table to 8 shards,
    undistribute_table of orders_m2.  -> (label, run) for the profiled
    run."""
    from citus_tpu_torch.errors import AnalysisError

    def timed(sql):
        t0 = time.perf_counter()
        cl.execute(sql)
        return time.perf_counter() - t0
    add_s = timed("ALTER TABLE orders_m ADD COLUMN o_comment text")

    def drop_check(name="cust_nonneg"):
        if any(c["name"] == name
               for c in cl.catalog.table("orders_m").check_constraints):
            cl.execute(f"ALTER TABLE orders_m DROP CONSTRAINT {name}")
    ph11_statement(cl, "c ADD CONSTRAINT CHECK (o_custkey >= 0), "
                   "validated", lambda: cl.execute(PH12_CHECK_OK),
                   lambda r: [tuple(c["name"] for c in cl.catalog.table(
                       "orders_m").check_constraints)],
                   [("cust_nonneg",)], launches, card, reset=drop_check,
                   phase="phase 12", warm=P12_WARM)
    zeros = int((state["cust"] == 0).sum())

    def violated():
        try:
            cl.execute(PH12_CHECK_BAD)
        except AnalysisError as e:
            return str(e)
        return "accepted"
    ph11_statement(cl, "c ADD CONSTRAINT CHECK (o_custkey > 0), refused",
                   violated, lambda msg: [(msg,)],
                   [(f'check constraint of relation "orders_m" is violated '
                     f"by {zeros} existing row(s)",)], launches, card,
                   phase="phase 12", warm=P12_WARM)
    ren_s = timed("ALTER TABLE orders_m RENAME COLUMN o_flag TO o_status")
    ph12_checks(cl, "orders_m", state, launches, card,
                "c after RENAME COLUMN o_flag TO o_status", "o_status")
    ren_s += timed("ALTER TABLE orders_m RENAME COLUMN o_status TO o_flag")
    drop_s = timed("ALTER TABLE orders_m DROP COLUMN o_comment")
    names = cl.catalog.table("orders_m").schema.names
    if names != ["o_orderkey", "o_custkey", "o_flag"]:
        raise AssertionError(f"phase 12 c: orders_m has {names}")
    rent_s = timed("ALTER TABLE orders_m RENAME TO orders_r")
    ph12_checks(cl, "orders_r", state, launches, card,
                "c after RENAME TO orders_r", warm=0)
    rent_s += timed("ALTER TABLE orders_r RENAME TO orders_m")
    say(f"phase 12 c: ADD COLUMN {add_s:.4f} s, RENAME COLUMN there and "
        f"back {ren_s:.4f} s, DROP COLUMN {drop_s:.4f} s, RENAME TO there "
        f"and back {rent_s:.4f} s ({card})")
    adt_s = timed("SELECT alter_distributed_table('orders_m', 8)")
    if cl.catalog.table("orders_m").shard_count != 8:
        raise AssertionError("phase 12 c: orders_m did not reshard")
    ph12_checks(cl, "orders_m", state, launches, card,
                "c after alter_distributed_table to 8 shards")
    und_s = timed("SELECT undistribute_table('orders_m2')")
    if cl.catalog.table("orders_m2").method != "local":
        raise AssertionError("phase 12 c: orders_m2 is still distributed")
    ph12_checks(cl, "orders_m2", state2, launches, card,
                "c after undistribute_table of orders_m2")
    say(f"phase 12 c: alter_distributed_table('orders_m', 8) {adt_s:.4f} s "
        f"({len(state['key'])} rows), undistribute_table('orders_m2') "
        f"{und_s:.4f} s ({len(state2['key'])} rows) ({card})")
    return [("c ADD CONSTRAINT CHECK", lambda: (
        drop_check(), cl.execute(PH12_CHECK_OK)))]


def ph12_index(cl, state: dict, launches: dict, card: str) -> list:
    """(d) CREATE INDEX on o_custkey, an index lookup, REINDEX TABLE
    after its segment files are deleted, the lookup again.  -> (label,
    run) for the profiled run."""
    t0 = time.perf_counter()
    cl.execute("CREATE INDEX ix_cust ON orders_m (o_custkey)")
    ix_s = time.perf_counter() - t0
    k = int(state["cust"][0])
    hit = state["cust"] == k
    want = [(int(hit.sum()), int(state["key"][hit].sum()))]
    lookup = PH12_LOOKUP.format(k=k)

    def lookup_runs(label):
        ph11_statement(cl, f"{label} (o_custkey = {k})",
                       lambda: cl.execute(lookup), lambda r: r.rows, want,
                       launches, card,
                       cpu_want=lambda r: cpu_backend_rows(cl, lookup),
                       phase="phase 12", warm=P12_WARM)
    lookup_runs("d index lookup")
    t = cl.catalog.table("orders_m")
    removed = 0
    for shard in t.shards:
        for node in shard.placements:
            d = cl.catalog.shard_dir("orders_m", shard.shard_id, node)
            for f in os.listdir(d):
                if f.endswith(".idx.o_custkey.npz"):
                    os.remove(os.path.join(d, f))
                    removed += 1
    # the cpu backend's REINDEX first: its count is the one to equal
    cl.execute("SET citus.task_executor_backend = cpu")
    try:
        rebuilt = cl.execute("REINDEX TABLE orders_m").explain[
            "segments_rebuilt"]
    finally:
        cl.execute("SET citus.task_executor_backend = gpu")
    ph11_statement(cl, "d REINDEX TABLE orders_m",
                   lambda: cl.execute("REINDEX TABLE orders_m"),
                   lambda r: [(r.explain["segments_rebuilt"],)],
                   [(rebuilt,)], launches, card, phase="phase 12",
                   warm=P12_WARM_HEAVY)
    say(f"phase 12 d: CREATE INDEX ix_cust {ix_s:.4f} s; {removed} "
        f"segment files deleted; REINDEX rebuilt {rebuilt} segments, the "
        f"cpu backend's count ({card})")
    lookup_runs("d index lookup after REINDEX")
    return [("d index lookup", lambda: cl.execute(lookup))]


def run_phase12(cl, n_orders: int, launches: dict, card: str,
                sources: list, tmp: str, profile: bool = True) -> None:
    """The rest of A11 on phase 8's orders_b arrays, on the card: (a)
    COPY, (d) CREATE STATISTICS, (b) MERGE, (d) ANALYZE, (c) ALTER, (d)
    the index and REINDEX, then (``profile``) one more warm run of the
    reads under torch.profiler; the B1, B2 and B4 launches of the
    phase.  The generated ``sources`` (``phase12_sources``) build during
    the load."""
    t_phase = time.perf_counter()
    p12 = dict.fromkeys(launch_counters(), 0)
    state = ph12_orders(n_orders)
    runs = ph12_copy(cl, tmp, state, p12, card, sources)
    stats = ("CREATE STATISTICS st_cust_flag ON o_custkey, o_flag "
             "FROM orders_m")
    ph12_statistics(cl, state, p12, card, "d CREATE STATISTICS on "
                    "(o_custkey, o_flag)", stats,
                    reset=lambda: cl.execute(
                        "DROP STATISTICS IF EXISTS st_cust_flag"), warm=1)
    merged = ph12_merge(cl, state, n_orders, p12, card)
    ph12_statistics(cl, merged, p12, card, "d ANALYZE after the MERGEs",
                    "ANALYZE orders_m")
    runs += ph12_alter(cl, merged, state, p12, card)
    runs += ph12_index(cl, merged, p12, card)
    runs += [(f"Q check {name}", lambda sql=sql: cl.execute(
        sql.format(t="orders_m", f="o_flag")))
        for name, sql in PH12_CHECKS.items()]
    runs.append(("d ANALYZE", lambda: cl.execute("ANALYZE orders_m")))
    if profile:
        profile_phase10(cl, runs, card, "phase 12")
    for t in ("orders_m", "orders_m2", "orders_delta", "orders_rf2",
              "orders_dup"):
        cl.execute(f"DROP TABLE {t}")
    for k, v in p12.items():
        launches[k] += v
    say(f"phase 12 launches: B1 scan_agg_fold {p12['scan_agg_fold']}, B2 "
        f"hash_agg_insert {p12['hash_agg_insert']}, B4 filter_mask "
        f"{p12['filter_mask']} ({card})")
    say(f"phase 12 took {time.perf_counter() - t_phase:.3f} s ({card})")


# ------------------------------------------------------------- phase 13

# phase 13: A14a's catalog objects on the card.  (a) TPC-H Q15 as its
# specification writes it (the view revenue0; no supplier table, so no
# supplier join), the discounted price an SQL function the view's
# aggregate calls: the function inlines into the fold, and the view is
# materialized once for each reference to it (the outer FROM and the
# scalar subquery), as in the reference
Q15_DATES = ("l_shipdate >= date '1996-01-01' "
             "AND l_shipdate < date '1996-04-01'")
DISC_PRICE = ("CREATE FUNCTION disc_price(p decimal, d decimal) "
              "RETURNS decimal AS 'p * (1 - d)'")
#: the replacing body (a surcharge where TPC-H discounts)
DISC_PRICE_NEW = ("CREATE OR REPLACE FUNCTION disc_price(p decimal, "
                  "d decimal) RETURNS decimal AS 'p * (1 + d)'")
REVENUE0_BODY = ("SELECT l_suppkey AS supplier_no, "
                 "sum(disc_price(l_extendedprice, l_discount)) AS "
                 f"total_revenue FROM lineitem WHERE {Q15_DATES} "
                 "GROUP BY l_suppkey")
REVENUE0 = f"CREATE VIEW revenue0 AS {REVENUE0_BODY}"
Q15_VIEW = ("SELECT supplier_no, total_revenue FROM revenue0 "
            "WHERE total_revenue = (SELECT max(total_revenue) FROM revenue0) "
            "ORDER BY supplier_no")
#: a decimal times a numeric literal in a function body (golden
#: ``objects``'s bonus(): the product's scale is the reference's)
BONUS = ("CREATE FUNCTION bonus(amount decimal) RETURNS decimal AS "
         "'amount * 1.5'")
P13_BONUS = ("SELECT sum(bonus(l_extendedprice)), max(bonus(l_extendedprice)) "
             f"FROM lineitem WHERE {Q15_DATES}")
#: the view's body with the function written out, as phase 10's CTE has it
REVENUE_WRITTEN = ("SELECT l_suppkey AS supplier_no, sum(l_extendedprice * "
                   "(1 - l_discount)) AS total_revenue FROM lineitem WHERE "
                   f"{Q15_DATES} GROUP BY l_suppkey")
# (b) an enum and a domain column over phase 8's orders_b arrays
PRIO = "CREATE TYPE prio AS ENUM ('L', 'M', 'H')"
PRIO_LABELS = ("L", "M", "H")
CUSTKEY_T = "CREATE DOMAIN custkey_t AS bigint CHECK (VALUE >= 0)"
ORDERS_E_DDL = ("CREATE TABLE orders_e (o_orderkey bigint NOT NULL, "
                "o_custkey custkey_t, o_flag prio)")
P13_GROUP = ("SELECT o_flag, count(*), sum(o_custkey) FROM orders_e "
             "GROUP BY o_flag ORDER BY o_flag")
P13_RANK = "SELECT count(*) FROM orders_e WHERE o_flag >= 'M'"
P13_TOTALS = "SELECT count(*), sum(o_custkey) FROM orders_e"
P13_UPDATE_OK = ("UPDATE orders_e SET o_custkey = o_custkey + 7 "
                 "WHERE o_orderkey = 5")
P13_UPDATE_BAD = ("UPDATE orders_e SET o_custkey = o_custkey - 1000000000 "
                  "WHERE o_orderkey = 6")
P13_EXPLAIN_UPDATE = ("EXPLAIN UPDATE orders_e SET o_custkey = 0 "
                      "WHERE o_orderkey = 5")
#: a table whose enum column's dictionary an INSERT grows ('H' is new)
PRIO_G_DDL = "CREATE TABLE prio_g (k bigint NOT NULL, f prio)"
PRIO_G_ROWS = 65_536
#: 'H' alone passes: a rank table left from before the INSERT would
#: clip 'H' to 'M' and count nothing
P13_GROW = "SELECT count(*), sum(k) FROM prio_g WHERE f > 'M'"
P13_WARM = 1
#: phase 13's time on the card, its load included
P13_LIMIT_S = 40.0


def p13_columns(state: dict) -> dict:
    return {"o_orderkey": state["key"], "o_custkey": state["cust"],
            "o_flag": FLAGS[state["flag"]].tolist()}


def p13_group_oracle(state: dict) -> list:
    """P13_GROUP's rows: the labels in their declaration order."""
    out = []
    for label in PRIO_LABELS:
        hit = state["flag"] == int(np.flatnonzero(FLAGS == label)[0])
        if hit.any():
            out.append((label, int(hit.sum()), int(state["cust"][hit].sum())))
    return out


def p13_rank_oracle(state: dict) -> list:
    return [(sum(n for label, n, _ in p13_group_oracle(state)
                 if label in ("M", "H")),)]


def oracle_bonus(cols: dict) -> list:
    """P13_BONUS's row: cents times 15, at scale 3."""
    keep = ((cols["ship"] >= _day(1996, 1, 1))
            & (cols["ship"] < _day(1996, 4, 1)))
    v = cols["price"][keep].astype(np.int64) * 15
    return [(_dec(int(v.sum()), 3), _dec(int(v.max()), 3))]


def p13_totals(state: dict) -> list:
    return [(len(state["key"]), int(state["cust"].sum()))]


def p13_grow_oracle(k: np.ndarray, f: np.ndarray) -> list:
    hit = f > 1  # rank of 'M'
    return [(int(hit.sum()), int(k[hit].sum()) if hit.any() else None)]


def p13_fold_source(cl, sql: str) -> str:
    """The generated fold (or insert) source of one single-table SELECT
    as ``Cluster.execute`` plans it, its SQL functions inlined."""
    from citus_tpu_torch.executor.executor import (
        _hash_key_dtypes, _param_dtypes, _params_env,
    )
    from citus_tpu_torch.ops.scan_agg_fold import FoldProgram
    plan, params = plan_as_cluster_does(cl, sql)
    kd = None
    if plan.group_mode.kind == "hash_host":
        kd = _hash_key_dtypes(plan, _params_env(plan, params))
    return FoldProgram.of_plan(plan, _param_dtypes(plan, params),
                               kd).row.source


def _digest(text: str) -> str:
    import hashlib
    return hashlib.sha256(text.encode()).hexdigest()[:12]


def p13_timed(cl, sql: str) -> tuple:
    """-> (result, nvcc builds it waited for, seconds)."""
    import torch
    from citus_tpu_torch.ops import cuda_build
    b0 = cuda_build.BUILDS["count"]
    t0 = time.perf_counter()
    r = cl.execute(sql)
    if cl.device.type == "cuda":
        torch.cuda.synchronize()
    return r, cuda_build.BUILDS["count"] - b0, time.perf_counter() - t0


def p13_launches(cl, sql: str) -> dict:
    """The kernel launches of one more run of ``sql``."""
    counters = launch_counters()
    for f in counters.values():
        f.launches = 0
    cl.execute(sql)
    return {k: f.launches for k, f in counters.items() if f.launches}


def p13_refused(cl, sql: str, error, totals: list, label: str) -> str:
    """``sql`` raises ``error`` and leaves P13_TOTALS at ``totals``;
    -> the error's text."""
    try:
        cl.execute(sql)
    except error as e:
        msg = f"{type(e).__name__}: {e}"
    else:
        raise AssertionError(f"phase 13 {label}: {sql!r} was not refused")
    got = cl.execute(P13_TOTALS).rows
    if got != totals:
        raise AssertionError(f"phase 13 {label}: the table changed: {got} "
                             f"!= {totals}")
    return msg


def p13_q15(cl, cols: dict, launches: dict, card: str) -> None:
    """(a) Q15 through the view revenue0 and disc_price(), then with the
    function replaced."""
    cl.execute(DISC_PRICE)
    cl.execute(REVENUE0)
    inlined = p13_fold_source(cl, REVENUE0_BODY)
    same = inlined == p13_fold_source(cl, REVENUE_WRITTEN)
    want = oracle_q15(cols)
    cte, _, cte_s = p13_timed(cl, Q15)
    if not same_rows(cte.rows, want):
        raise AssertionError(f"phase 13 a: phase 10's CTE Q15 gives "
                             f"{cte.rows}, numpy {want}")
    cte_launches = p13_launches(cl, Q15)
    times = ph11_statement(
        cl, "a Q15 through the view revenue0 and disc_price()",
        lambda: cl.execute(Q15_VIEW), lambda r: r.rows, want, launches,
        card, cpu_want=lambda r: cpu_backend_rows(cl, Q15_VIEW),
        phase="phase 13", warm=P13_WARM)
    say("phase 13 a: the fold disc_price() inlines into is "
        + ("the same generated source as the written-out expression's "
           f"({_digest(inlined)}: phase 10's CTE Q15 built it, no new "
           "nvcc build for it)" if same else
           "NOT the written-out expression's source")
        + "; rows equal phase 10's CTE Q15 on the card, numpy's and the "
        "cpu backend's; the view is materialized for each of its 2 "
        f"references: warm {times[-1]:.4f} s, launches "
        f"{p13_launches(cl, Q15_VIEW)}, beside the CTE form's "
        f"{cte_s:.4f} s and {cte_launches} ({card})")
    cl.execute(DISC_PRICE_NEW)
    replaced = p13_fold_source(cl, REVENUE0_BODY)
    if replaced == inlined:
        raise AssertionError("phase 13 a: the replaced body generates the "
                             "old fold source")
    want_new = oracle_q15(cols, sign=1)
    r, builds, secs = p13_timed(cl, Q15_VIEW)
    if not same_rows(r.rows, want_new):
        raise AssertionError(f"phase 13 a: after CREATE OR REPLACE FUNCTION "
                             f"the view gives {r.rows}, numpy {want_new}")
    say(f"phase 13 a CREATE OR REPLACE FUNCTION disc_price as p * (1 + d): "
        f"a new fold source ({_digest(inlined)} -> {_digest(replaced)}); "
        f"the view's rows equal numpy's for the new body, so the old "
        f"kernel was not reused: {secs:.4f} s, nvcc builds {builds} "
        f"({card})")
    cl.execute(BONUS)
    cpu = {}

    def as_text(r):
        rows = [tuple(str(v) for v in row) for row in r.rows]
        cpu.setdefault("rows", [tuple(str(v) for v in row) for row in
                                cpu_backend_rows(cl, P13_BONUS)])
        if rows != cpu["rows"]:
            raise AssertionError(f"phase 13 a bonus(): {rows} on the card, "
                                 f"{cpu['rows']} on the cpu backend")
        return r.rows
    ph11_statement(cl, "a sum(bonus(l_extendedprice)): decimal(12,2) * 1.5",
                   lambda: cl.execute(P13_BONUS), as_text,
                   oracle_bonus(cols), launches, card, phase="phase 13",
                   warm=P13_WARM)
    say(f"phase 13 a bonus(): the card's decimals print as the cpu "
        f"backend's, scale and all: {cpu['rows']} ({card})")


def p13_load(cl, state: dict, card: str, jobs: list) -> None:
    """(b) orders_e (a domain and an enum column) loaded by copy_from
    from phase 8's arrays; then the phase's generated kernels, started
    before phase 12 (``jobs``), are waited for."""
    from citus_tpu_torch.ops import cuda_build
    for sql in (PRIO, CUSTKEY_T, ORDERS_E_DDL,
                "SELECT create_distributed_table('orders_e', 'o_orderkey', "
                f"{SHARDS})"):
        cl.execute(sql)
    columns = p13_columns(state)
    n = len(state["key"])
    check = cl._check_domains
    dom = []

    def timed_check(t, cols):
        t0 = time.perf_counter()
        check(t, cols)
        dom.append(time.perf_counter() - t0)
    cl._check_domains = timed_check
    try:
        t0 = time.perf_counter()
        got = cl.copy_from("orders_e", columns=columns)
        load_s = time.perf_counter() - t0
    finally:
        del cl._check_domains
    if got != n or len(dom) != 1:
        raise AssertionError(f"phase 13 b load: {got} rows of {n}, "
                             f"{len(dom)} domain checks")
    t0 = time.perf_counter()
    for job in jobs:
        cuda_build.finish_generated(job)
    after_s = time.perf_counter() - t0
    say(f"phase 13 b load: copy_from of {n} orders into orders_e (o_custkey "
        f"custkey_t over {len(np.unique(state['cust']))} distinct values, "
        f"o_flag prio) in {load_s:.3f} s ({n / load_s:.1f} rows/s), both "
        f"checks included; the domain CHECK, on the host once per "
        f"distinct value, {dom[0]:.3f} s of it; the phase's {len(jobs)} "
        f"generated kernels, started before phase 12, waited for "
        f"{after_s:.3f} s after it ({card})")


def p13_enum(cl, state: dict, launches: dict, card: str) -> None:
    """(b) the enum GROUP BY and rank comparison cold and warm, the
    refused INSERTs and UPDATE, a kept UPDATE, an INSERT then the warm
    query with no build, and an enum dictionary grown by an INSERT."""
    from citus_tpu_torch.errors import AnalysisError, ExecutionError
    n_orders = len(state["key"])

    def statement(label, sql, want, warm=P13_WARM):
        ph11_statement(cl, label, lambda: cl.execute(sql), lambda r: r.rows,
                       want, launches, card,
                       cpu_want=lambda r: cpu_backend_rows(cl, sql),
                       phase="phase 13", warm=warm)
    want = p13_group_oracle(state)
    if [r[0] for r in want] != list(PRIO_LABELS):
        raise AssertionError(f"phase 13 b: numpy's labels {want}")
    statement("b GROUP BY o_flag ORDER BY o_flag (L, M, H: declaration "
              "order)", P13_GROUP, want)
    statement("b count(*) WHERE o_flag >= 'M'", P13_RANK,
              p13_rank_oracle(state))
    totals = p13_totals(state)
    bad_label = p13_refused(
        cl, f"INSERT INTO orders_e VALUES ({n_orders}, 1, 'X')",
        AnalysisError, totals, "an INSERT of label 'X'")
    bad_cust = p13_refused(
        cl, f"INSERT INTO orders_e VALUES ({n_orders}, -1, 'L')",
        ExecutionError, totals, "an INSERT of custkey -1")
    r = cl.execute(P13_UPDATE_OK)
    if r.explain.get("updated") != 1:
        raise AssertionError(f"phase 13 b UPDATE: {r.explain}")
    state["cust"][5] += 7
    totals = p13_totals(state)
    if cl.execute(P13_TOTALS).rows != totals:
        raise AssertionError("phase 13 b: the kept UPDATE is not read back")
    bad_update = p13_refused(cl, P13_UPDATE_BAD, ExecutionError, totals,
                             "an UPDATE violating the domain")
    say(f"phase 13 b refused, the table unchanged: an INSERT of label 'X' "
        f"({bad_label}), one of custkey -1 ({bad_cust}), an UPDATE of "
        f"o_custkey - 1000000000 ({bad_update}); the UPDATE of o_custkey "
        f"+ 7 kept ({card})")
    cl.execute(f"INSERT INTO orders_e VALUES ({n_orders}, 3, 'H'), "
               f"({n_orders + 1}, 4, 'M')")
    for c, v in (("key", [n_orders, n_orders + 1]), ("cust", [3, 4]),
                 ("flag", [int(np.flatnonzero(FLAGS == "H")[0]),
                           int(np.flatnonzero(FLAGS == "M")[0])])):
        state[c] = np.concatenate([state[c], np.asarray(v, np.int64)])
    r, builds, secs = p13_timed(cl, P13_GROUP)
    if r.rows != p13_group_oracle(state) or builds:
        raise AssertionError(f"phase 13 b after an INSERT: {r.rows} "
                             f"(numpy {p13_group_oracle(state)}), nvcc "
                             f"builds {builds}")
    cl.execute(PRIO_G_DDL)
    cl.execute(f"SELECT create_distributed_table('prio_g', 'k', {SHARDS})")
    k = np.arange(PRIO_G_ROWS, dtype=np.int64)
    f = (k % 3 == 0).astype(np.int64)  # 'L' 0, 'M' 1: no 'H' yet
    cl.copy_from("prio_g", columns={"k": k, "f": np.array(
        PRIO_LABELS)[f].tolist()})
    statement("b prio_g count(*), sum(k) WHERE f > 'M' (2 words in f's "
              "dictionary, none passes)", P13_GROW, p13_grow_oracle(k, f))
    cl.execute(f"INSERT INTO prio_g VALUES ({PRIO_G_ROWS}, 'H'), "
               f"({PRIO_G_ROWS + 1}, 'H')")
    k = np.concatenate([k, [PRIO_G_ROWS, PRIO_G_ROWS + 1]])
    f = np.concatenate([f, [2, 2]])
    r2, builds2, secs2 = p13_timed(cl, P13_GROW)
    if r2.rows != p13_grow_oracle(k, f) or builds2:
        raise AssertionError(f"phase 13 b prio_g after 'H': {r2.rows} "
                             f"(numpy {p13_grow_oracle(k, f)}), nvcc builds "
                             f"{builds2}")
    say(f"phase 13 b an INSERT of 2 orders, then {P13_GROUP!r} warm: rows "
        f"equal numpy's, nvcc builds 0, {secs:.4f} s; an INSERT of 'H' "
        f"grows prio_g.f's dictionary (its rank table 2 -> 3 entries in "
        f"the parameter block), then {P13_GROW!r}: rows equal numpy's, "
        f"nvcc builds 0, {secs2:.4f} s ({card})")


def p13_explain(cl, n_queries: dict, launches: dict, card: str) -> None:
    """(c) EXPLAIN of an UPDATE, of QJOIN (nothing runs) and of the enum
    GROUP BY; EXPLAIN ANALYZE of Q6 and of the enum GROUP BY twice."""
    import re
    counters = launch_counters()
    for f in counters.values():
        f.launches = 0
    upd = [r[0] for r in cl.execute(P13_EXPLAIN_UPDATE).rows]
    if upd != ["Update on orders_e (shards: 1/4)",
               "  Shard/Chunk Pruning: o_orderkey",
               "  Strategy: local (deletion bitmaps + re-insert)"]:
        raise AssertionError(f"phase 13 c EXPLAIN UPDATE: {upd}")
    join = [r[0] for r in cl.execute("EXPLAIN " + QJOIN).rows]
    grp = [r[0] for r in cl.execute("EXPLAIN " + P13_GROUP).rows]
    ran = {k: f.launches for k, f in counters.items() if f.launches}
    if ran or not join[0].startswith("Join (") or grp[0] != (
            f"Distributed Scan on orders_e (shards: {SHARDS}/{SHARDS})") \
            or "combine: host)" not in grp[1]:
        raise AssertionError(f"phase 13 c EXPLAIN: launches {ran}, "
                             f"{join}, {grp}")
    say(f"phase 13 c EXPLAIN (no kernel launched): {' / '.join(upd)}; "
        f"{' / '.join(join)}; {' / '.join(grp)} ({card})")
    for label, sql in (("Q6", Q6), ("the enum GROUP BY", P13_GROUP)):
        rows = n_queries[label]
        for i in range(2):
            r, builds, wall = p13_timed(cl, "EXPLAIN ANALYZE " + sql)
            lines = [x[0] for x in r.rows]
            m = re.search(r"Rows: (\d+)  Elapsed: ([\d.]+) ms",
                          "\n".join(lines))
            hit = any("Plan Cache: hit" in ln for ln in lines)
            if m is None or int(m.group(1)) != rows \
                    or float(m.group(2)) > wall * 1e3 \
                    or (i == 1 and (not hit or builds)):
                raise AssertionError(f"phase 13 c EXPLAIN ANALYZE {label} "
                                     f"run {i}: {lines} (wall {wall} s, "
                                     f"nvcc builds {builds})")
            say(f"phase 13 c EXPLAIN ANALYZE {label} run {i} (wall "
                f"{wall * 1e3:.3f} ms, nvcc builds {builds}): "
                f"{' / '.join(ln.strip() for ln in lines)} ({card})")


def p13_analyze_profiled(cl, sql: str, card: str) -> None:
    """EXPLAIN ANALYZE's device figures of ``sql`` beside torch.profiler's
    device time of the port's kernels in the same run (recorded, not
    gated)."""
    import re
    import torch
    from torch.profiler import ProfilerActivity, profile
    pause = PROFILE_PAUSE_S
    for tries in range(1, 4):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(pause)
            lines = [x[0] for x in cl.execute("EXPLAIN ANALYZE " + sql).rows]
            torch.cuda.synchronize()
            time.sleep(pause)
        kern = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and any(k in e.name for k in PORT_KERNELS)]
        if kern:
            break
        pause = PROFILE_RETRY_PAUSE_S
    text = "\n".join(lines)

    def num(pattern):
        m = re.search(pattern, text)
        return float(m.group(1)) if m else float("nan")
    elapsed_ms = num(r"Elapsed: ([\d.]+) ms")
    task_ms = num(r"rows, ([\d.]+) ms device dispatch")
    pipe_ms = num(r"device ([\d.]+) ms, H2D")
    prof_ms = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    other = sorted({e.name for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and not any(k in e.name for k in PORT_KERNELS)
                    and not e.name.lower().startswith(("memcpy", "memset"))})
    say(f"phase 13 c EXPLAIN ANALYZE Q6 under torch.profiler (session "
        f"{tries}): Elapsed {elapsed_ms} ms, the first task's dispatch "
        f"{task_ms} ms, Pipeline device {pipe_ms} ms (host clocks around "
        f"asynchronous launches) beside the profiler's {prof_ms:.4f} ms of "
        f"the port's {len(kern)} kernels on the card; other kernels "
        f"{other} ({card})")


def start_phase13_builds(sources: list) -> list:
    """Start building phase 13's generated ``sources``
    (``phase13_sources``), one nvcc each; -> the jobs ``run_phase13``
    waits for after its load."""
    from citus_tpu_torch.ops import cuda_build
    return [cuda_build.start_generated(name, src) for name, src in sources]


def run_phase13(cl, cols: dict, n_orders: int, launches: dict, card: str,
                jobs: list, profile: bool = True) -> None:
    """A14a on the card: (b)'s load, then its generated kernels' ``jobs``
    (``start_phase13_builds``) waited for, (a) Q15 through a view and an
    SQL function, (b) the enum and domain table, (c) EXPLAIN and EXPLAIN
    ANALYZE, with (``profile``) Q6's EXPLAIN ANALYZE under
    torch.profiler; the B1, B2 and B4 launches of the phase."""
    t_phase = time.perf_counter()
    for table in ("lineitem", "orders_b"):
        if not cl.catalog.has_table(table):
            raise AssertionError(f"phase 13: {table} is gone")
    p13 = dict.fromkeys(launch_counters(), 0)
    state = ph12_orders(n_orders)
    p13_load(cl, state, card, jobs)
    p13_q15(cl, cols, p13, card)
    p13_enum(cl, state, p13, card)
    n_queries = {"Q6": cl.execute(Q6).rowcount,
                 "the enum GROUP BY": cl.execute(P13_GROUP).rowcount}
    p13_explain(cl, n_queries, p13, card)
    if profile:
        p13_analyze_profiled(cl, Q6, card)
    for sql in ("DROP VIEW revenue0", "DROP FUNCTION disc_price",
                "DROP FUNCTION bonus",
                "DROP TABLE orders_e", "DROP TABLE prio_g",
                "DROP TYPE prio", "DROP DOMAIN custkey_t"):
        cl.execute(sql)
    for k, v in p13.items():
        launches[k] += v
    took = time.perf_counter() - t_phase
    say(f"phase 13 launches: B1 scan_agg_fold {p13['scan_agg_fold']}, B2 "
        f"hash_agg_insert {p13['hash_agg_insert']}, B4 filter_mask "
        f"{p13['filter_mask']} ({card})")
    say(f"phase 13 took {took:.3f} s, "
        + ("within" if took <= P13_LIMIT_S else "OVER")
        + f" its {P13_LIMIT_S:g} s ({card})")


def phase13_sources(tmp: str, n_orders: int) -> list:
    """``rehearsal_sources`` of phase 13's reads and writes, over the
    first 20,000 of ``n_orders`` orders (their custkeys span the full
    scale's range).  The predicate of the view's outer WHERE is missing:
    its literal is this data's top revenue."""
    def body(cl):
        state = ph12_orders(n_orders, 20_000)
        cl.execute(DISC_PRICE)
        cl.execute(REVENUE0)
        cl.execute(Q15_VIEW)
        cl.execute(DISC_PRICE_NEW)
        cl.execute(Q15_VIEW)
        cl.execute(BONUS)
        cl.execute(P13_BONUS)
        for sql in (PRIO, CUSTKEY_T, ORDERS_E_DDL,
                    "SELECT create_distributed_table('orders_e', "
                    f"'o_orderkey', {SHARDS})", PRIO_G_DDL,
                    f"SELECT create_distributed_table('prio_g', 'k', "
                    f"{SHARDS})"):
            cl.execute(sql)
        cl.copy_from("orders_e", columns=p13_columns(state))
        cl.copy_from("prio_g", columns={"k": np.arange(3),
                                        "f": ["L", "M", "L"]})
        for sql in (P13_GROUP, P13_RANK, P13_TOTALS, P13_UPDATE_OK,
                    P13_GROW, "EXPLAIN ANALYZE " + P13_GROUP):
            cl.execute(sql)
        try:
            cl.execute(P13_UPDATE_BAD)
        except Exception:  # noqa: BLE001 -- refused, as on the card
            pass
    return rehearsal_sources(tmp, "phase13", body)


def run(args) -> dict:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import citus_tpu_torch as ctt
    from citus_tpu_torch import errors as ctt_errors
    from citus_tpu_torch.executor.device_cache import GLOBAL_CACHE
    from citus_tpu_torch.ops import cuda_build
    from citus_tpu_torch.ops.hash_agg_insert import INSERT_BUILD
    from citus_tpu_torch.ops.scan_agg_fold import (
        FOLD_BUILD, fold_library, scan_agg_fold,
    )

    t_run = time.perf_counter()

    def elapsed(after: str) -> None:
        say(f"elapsed after {after}: {time.perf_counter() - t_run:.1f} s")

    # ---- phase 1: card and versions
    card = card_line()
    say("phase 1 card:", card)
    nvcc = subprocess.run([cuda_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[-1]
    say(f"phase 1 versions: python {sys.version.split()[0]} torch "
        f"{torch.__version__} cuda {torch.version.cuda} nvcc {nvcc}")
    device = torch.device("cuda", 0)

    tmp = tempfile.mkdtemp(prefix="citus_tpu_torch_smoke_")
    rehearsals = start_rehearsals(tmp, args.rows // 4)
    try:
        plans = smoke_plans(device, tmp)
        splans = sketch_plans(device, tmp)
        # ---- phase 2: build every kernel, all nvcc processes at once;
        # then one more generated predicate alone, and Q1's generated
        # fold alone, for their cold build times
        t0 = time.perf_counter()
        kernels = ["rollup_delta", "hash_agg_merge", "partition_pack",
                   "sorted_join", "mesh_combine", "mesh_exchange"]
        # the predicates of Q6 and P1 and of the phase-5 families (each
        # generated source holds the one-query and the batched kernel);
        # Q6's and P's families share Q6's and P1's sources
        sources = [plans["filters"][q][0].predicate.source
                   for q in ("q6", "p1", "c1_all")]
        for where in C1_WHERES:
            sources.append(plans["c1_programs"][where].predicate.source)
        for fplan, fparams in list(plans["families"].values()) \
                + [splans["family"]]:
            src = family_filter("cpu", fplan, fparams)[0].predicate.source
            if src not in sources:
                sources.append(src)
        jobs = [cuda_build.start_generated("filter_mask", src)
                for src in sources]
        # the generated folds and inserts of phases 3-7 (each source holds
        # the one-query and the batched kernel), but Q1's
        q1_fold = plans["fold_calls"]["q1"][0]
        folds = [p for p in generated_programs(plans, splans, tmp)
                 if p.row.source != q1_fold.row.source]
        fold_sources = list(dict.fromkeys(
            (INSERT_BUILD if p.hashed else FOLD_BUILD, p.row.source)
            for p in folds))
        jobs += [cuda_build.start_generated(name, src)
                 for name, src in fold_sources]
        cuda_build.build_all(kernels)
        for job in jobs:
            cuda_build.finish_generated(job)
        say(f"phase 2 build: {len(kernels)} kernels, "
            f"{len(jobs) - len(fold_sources)} generated predicates and "
            f"{len(fold_sources)} generated folds and inserts in "
            f"{time.perf_counter() - t0:.3f} s")
        for k in kernels:
            for line in cuda_build.build_log(k).splitlines():
                if "registers" in line or "spill" in line or "error" in line:
                    say(f"phase 2 ptxas {k}: {line.strip()}")
        t0 = time.perf_counter()
        plans["filters"]["syn"][0].library()
        say(f"phase 2 cold nvcc build of one generated predicate (the "
            f"synthetic one) alone: {time.perf_counter() - t0:.3f} s")
        t0 = time.perf_counter()
        fold_library(q1_fold)
        say(f"phase 2 cold nvcc build of one generated fold (Q1's: "
            f"{len(q1_fold.row.columns)} columns, {len(q1_fold.exprs.args)} "
            f"arguments, {len(q1_fold.ops)} ops; the one-query and the "
            f"batched kernel) alone: {time.perf_counter() - t0:.3f} s")
        for line in cuda_build.build_log(
                FOLD_BUILD, q1_fold.row.source).splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                say(f"phase 2 ptxas Q1 fold: {line.strip()}")

        # phase 10's generated kernels, but those built above, build
        # while phase 4's lineitem loads (host work): one nvcc each,
        # started together, all finished before phase 3
        known = set(fold_sources) | {("filter_mask", src) for src in sources}
        t0 = time.perf_counter()
        p10_sources, p11_sources, p12_sources, p13_sources = \
            finish_rehearsals(rehearsals)
        say(f"phase 2 rehearsals of phases 10-13 on the CPU, in a "
            f"process of their own: {time.perf_counter() - t0:.3f} s of "
            f"waiting for them")
        p10 = [b for b in p10_sources
               if b not in known and b[1] != q1_fold.row.source]
        t0 = time.perf_counter()
        p10_jobs = [cuda_build.start_generated(name, src)
                    for name, src in p10]
        # phase 11's, but those above, build while its own load runs
        p11 = [b for b in p11_sources
               if b not in known and b not in set(p10)
               and b[1] != q1_fold.row.source]
        # and phase 12's, but those above, while its own COPY FROM runs
        p12 = [b for b in p12_sources
               if b not in known and b not in set(p10) | set(p11)
               and b[1] != q1_fold.row.source]
        # and phase 13's, but those above, while its own load runs
        p13 = [b for b in p13_sources
               if b not in known and b not in set(p10) | set(p11) | set(p12)
               and b[1] != q1_fold.row.source]

        elapsed("phase 2")
        # ---- phase 3: kernel vs plain version at the main path's shapes
        n_rows = args.rows
        if n_rows != SF1_ROWS:
            say(f"phase 4 NOTE: scale cut to {n_rows} rows (SF1 is {SF1_ROWS})")
        torch.cuda.reset_peak_memory_stats(device)
        hits0 = GLOBAL_CACHE.hits
        cl, cols = load_lineitem(ctt, os.path.join(tmp, "sf"), n_rows)
        t1 = time.perf_counter()
        for job in p10_jobs:
            cuda_build.finish_generated(job)
        say(f"phase 2 build of phase 10's {len(p10)} generated kernels, "
            f"during the load: {time.perf_counter() - t0:.3f} s, "
            f"{time.perf_counter() - t1:.3f} s of it after the load")
        kernel_rows: list = []
        phase3_fold(device, plans, kernel_rows)
        phase3_hash(device, cl, kernel_rows)
        phase3_merge(device, tmp, kernel_rows)
        phase3_filter(device, plans, kernel_rows)
        phase3_batched_filter(device, plans, kernel_rows)
        phase3_batched_fold(device, plans, kernel_rows)
        phase3_batched_hash(device, cl, kernel_rows)
        phase3_sketch_folds(device, splans, kernel_rows)
        phase3_rollup_delta(device, kernel_rows)
        sides = qjoin_sides(n_rows, device)
        phase3_partition_pack(device, n_rows, kernel_rows, sides)
        phase3_sorted_join(device, kernel_rows, sides)
        phase3_mesh_combine(device, plans, splans, kernel_rows)
        phase3_mesh_exchange(device, kernel_rows, sides)
        del sides
        elapsed("phase 3")
        launches = dict.fromkeys(launch_counters(), 0)
        launches.update({"scan_agg_fold[sketch]": 0,
                         "scan_agg_fold_batched[sketch]": 0})
        fams = families()

        def phase5(cl, name, cols, n_rows):
            kind, variants = fams[name]
            for k, v in run_family(cl, name, kind, variants, cols,
                                   n_rows, card).items():
                launches[k] += v

        # ---- phase 4: the main path through the port's entry points
        for run_kind in ("cold", "warm"):
            launches["scan_agg_fold"] += run_checked(
                cl, "Q6", Q6, oracle_q6(cols), n_rows, run_kind)
        cl.execute("SET citus.hash_agg_slots = auto")
        for qname, sql, want in (("H1", H1, oracle_h1(cols)),
                                 ("H2", H2, oracle_h2(cols))):
            for run_kind in ("cold", "warm"):
                launches["hash_agg_insert"] += run_checked(
                    cl, qname, sql, want, n_rows, run_kind,
                    "hash_agg_insert")
        want_p1 = oracle_p1(cols)
        for run_kind in ("cold", "warm"):
            launches["filter_mask"] += run_checked(
                cl, "P1", P1, want_p1, n_rows, run_kind, "filter_mask")
        elapsed("phase 4 at SF1")
        # ---- phase 5: literal families coalesced, on the SF1 lineitem
        for name in ("Q6", "H", "P"):
            phase5(cl, name, cols, n_rows)
        elapsed("phase 5 at SF1")
        # ---- phase 8: joins on the SF1 lineitem, and C1's projections
        qjoin_want = run_join_phase(ctt, cl, cols, tmp, n_rows, launches,
                                    card)
        elapsed("phase 8")
        # ---- phase 10: the rest of SELECT on the SF1 lineitem
        run_phase10(cl, cols, launches, card)
        elapsed("phase 10")
        # ---- phase 11: A11's local write surface on the SF1 lineitem
        run_phase11(ctt, cl, cols, launches, card, p11)
        elapsed("phase 11")
        # ---- phase 12: the rest of A11 on phase 8's orders_b arrays;
        # phase 13's generated kernels build meanwhile
        p13_jobs = start_phase13_builds(p13)
        run_phase12(cl, n_rows // 4, launches, card, p12, tmp)
        elapsed("phase 12")
        # ---- phase 13: A14a's objects on the SF1 lineitem and orders_b
        run_phase13(cl, cols, n_rows // 4, launches, card, p13_jobs)
        elapsed("phase 13")
        # ---- phase 9: Q6 and QJOIN over a mesh of MESH_MEMBERS members
        # on the card, a second Cluster over the same SF1 tables
        mcl = mesh_cluster(ctt, os.path.join(tmp, "sf"), device)
        try:
            for run_kind in ("cold", "warm"):
                run_mesh_query(mcl, "Q6", Q6, oracle_q6(cols), n_rows,
                               run_kind, launches, card)
            run_join_query(mcl, "QJOIN", QJOIN, qjoin_want, "warm", n_rows,
                           n_rows // 4, launches, True, card, "phase 9")
        finally:
            mcl.close()
        q1_rows = n_rows
        q1_dir = os.path.join(tmp, "sf")
        if q1_guard_fires(cols):
            # the engine's int64 overflow guard (executor/finalize.py
            # _check_sum_overflow, as in citus_tpu) rejects Q1's
            # sum_charge here: it must raise, after folding every batch
            scan_agg_fold.launches = 0
            try:
                cl.execute(Q1)
            except ctt_errors.ExecutionError as e:
                if "out of range" not in str(e):
                    raise
            else:
                raise AssertionError(
                    "Q1 answered where the int64 overflow guard must fire")
            if scan_agg_fold.launches != SHARDS:
                raise AssertionError(
                    f"Q1 at {n_rows} rows: {scan_agg_fold.launches} kernel "
                    f"launches for {SHARDS} one-batch shards")
            launches["scan_agg_fold"] += scan_agg_fold.launches
            say(f"phase 4 Q1 at {n_rows} rows: the int64 overflow guard "
                f"fires as the oracle predicts (largest group sum_charge "
                f"{q1_max_charge(cols)} at scale 8 >= 2^62), after "
                f"{scan_agg_fold.launches} kernel launches")
            cl.close()
            q1_rows = Q1_ROWS
            q1_dir = os.path.join(tmp, "q1")
            cl, cols = load_lineitem(ctt, q1_dir, q1_rows)
        for run_kind in ("cold", "warm"):
            launches["scan_agg_fold"] += run_checked(
                cl, "Q1", Q1, oracle_q1(cols), q1_rows, run_kind)
        phase5(cl, "Q1", cols, q1_rows)
        # ---- phase 9: Q1 over the mesh
        mcl = mesh_cluster(ctt, q1_dir, device)
        try:
            for run_kind in ("cold", "warm"):
                run_mesh_query(mcl, "Q1", Q1, oracle_q1(cols), q1_rows,
                               run_kind, launches, card)
        finally:
            mcl.close()
        cl.close()
        elapsed("phases 9 and 4-5 of Q1")
        # ---- phases 4-6 of the sketch aggregates and rollups
        run_sketch_phases(ctt, tmp, n_rows, launches, card)
        elapsed("phases 4-6 of the sketch table")
        # ---- phase 7: two coordinators on the card
        run_pair_phase(ctt, tmp, n_rows, launches, card)
        elapsed("phase 7")
        say(f"phase 4 device cache hits {GLOBAL_CACHE.hits - hits0}, "
            f"peak device memory {torch.cuda.max_memory_allocated(device)} B")
    finally:
        proc = rehearsals[0]
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)

    for row in kernel_rows:
        row["launches"] = launches[row["name"]]
        if row["launches"] == 0:
            raise AssertionError(f"{row['name']} never launched on the "
                                 "main path")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return {
        "card": card,
        "kernels": [{k: row[k] for k in keys} for row in kernel_rows],
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": torch.cuda.device_count()},
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=SF1_ROWS,
                    help="lineitem rows of the main path (default: SF1)")
    args = ap.parse_args()
    out = run(args)
    say(json.dumps({"kernels": out["kernels"]}))
    say(out["card"])
    print(json.dumps({"ok": True, "device": out["device"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
