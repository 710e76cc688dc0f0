"""Distributed EXPLAIN [ANALYZE].

Reference: planner/multi_explain.c, ported from
``citus_tpu/commands/explain.py`` line for line: the plan of a
single-table SELECT (scan, shard pruning, index lookup, chunk pruning,
the partial aggregate and its partials), a partitioned parent's
surviving partitions, a rollup scan, a join, GROUPING SETS, set
operations, UPDATE / DELETE with their strategy (the cross-host lines
too: EXPLAIN only describes, it runs nothing remote) and INSERT …
SELECT's strategy ladder.  Every line is the reference's: a direct
GROUP BY prints the reference's fixed ``combine: psum`` label, though
its partials combine on the host, or in B6 over a mesh (as the
reference's one-device stream combines on the host under the same
label).

EXPLAIN ANALYZE runs the statement under a forced trace
(``_run_analyze``) and renders every number from the span tree and the
counters.  What each measures on a CUDA device:

- ``Rows``: the rows the statement returned.
- ``Elapsed``: the ``execute`` span, the host's clock from the start of
  ``execute_select`` to the end of its finalize; the result's copy to
  the host waits for the device, so this is the statement's wall time
  less parse and plan, not the kernels' device time.
- ``Plan Cache``: hit or miss of the plan cache (keyed by the
  statement's AST), the plan's fingerprint, and ``compile``: the
  ``nvcc`` builds this statement waited for (``kernel_compile`` spans of
  ``ops/cuda_build.py``), in host milliseconds.
- ``Device Cache``: batches served from device memory and batches
  copied to it.
- ``Memory``: bytes of device batches this statement read or copied
  (``device_hbm_touched_bytes``), and what the device cache holds now.
- ``Tasks`` / ``Device Rounds``: host clocks around each batch's
  asynchronous launches (a sync every ``depth`` batches,
  ``executor/executor.py``): launch and queueing time, not kernel time.
- ``Pipeline``: host decode time, ``device`` (the same host clock around
  the launches and their periodic syncs), host-to-device bytes and the
  stalls of the double buffer.
"""

from __future__ import annotations

from citus_tpu_torch.commands.registry import handles
from citus_tpu_torch.errors import UnsupportedFeatureError
from citus_tpu_torch.executor import Result, execute_select
from citus_tpu_torch.planner import ast as A
from citus_tpu_torch.planner.bind import bind_select


#: pipeline records of the port's own (launch counts of its kernels, its
#: host merges, its mesh rounds): alone they make no ``Pipeline`` line,
#: as the reference has no record of them
_PORT_ONLY_PIPELINE = frozenset({
    "filter_dispatches", "host_merge_ms", "hash_spill_merge_ms",
    "hash_remote_merge_ms", "mesh_members", "mesh_rounds"})


def _plan_result(lines) -> Result:
    return Result(columns=["QUERY PLAN"], rows=[(ln,) for ln in lines])


@handles(A.Explain)
def execute_explain(cl, stmt: A.Explain) -> Result:
    st = stmt.statement
    if isinstance(st, A.SetOp):
        lines = [f"Set Operation: {st.op.upper()}{' ALL' if st.all else ''}"]
        for side, sub in (("left", st.left), ("right", st.right)):
            r = execute_explain(cl, A.Explain(sub, analyze=stmt.analyze))
            lines.append(f"  -> {side}:")
            lines.extend("     " + row[0] for row in r.rows)
        return _plan_result(lines)
    if isinstance(st, (A.Update, A.Delete)):
        return _explain_modify(cl, st)
    if isinstance(st, A.Insert) and st.select is not None:
        return _explain_insert_select(cl, st)
    if not isinstance(st, A.Select):
        raise UnsupportedFeatureError(
            "EXPLAIN supports SELECT, set operations, UPDATE/DELETE, "
            "and INSERT..SELECT")
    if len(st.group_by) == 1 and isinstance(st.group_by[0],
                                            A.GroupingSetsSpec):
        spec = st.group_by[0]
        full = max(spec.sets, key=len)
        lines = [f"Grouping Sets: {len(spec.sets)} grouped executions"]
        inner = A.Select(
            [i for i in st.items
             if not (isinstance(i.expr, A.FuncCall)
                     and i.expr.name == "grouping")],
            st.from_, st.where, list(full))
        sub = execute_explain(cl, A.Explain(inner, analyze=stmt.analyze))
        lines.extend("  " + row[0] for row in sub.rows)
        return _plan_result(lines)
    if isinstance(st.from_, A.Join):
        return _explain_join(cl, stmt)
    if isinstance(st.from_, A.TableRef) \
            and cl.catalog.has_table(st.from_.name) \
            and cl.catalog.table(st.from_.name).is_partitioned:
        import dataclasses

        from citus_tpu_torch.partitioning import prune_partitions
        pt = cl.catalog.table(st.from_.name)
        parts = cl.catalog.partitions_of(pt.name)
        surv = prune_partitions(cl.catalog, pt, st.where)
        lines = [f"Append on {pt.name} "
                 f"(partitions: {len(surv)}/{len(parts)})"]
        if surv:
            rep = dataclasses.replace(st, from_=A.TableRef(
                surv[0].name, st.from_.alias or pt.name))
            sub = execute_explain(cl, A.Explain(rep, analyze=False))
            lines.append(f"  Partitions Shown: One of {len(surv)}")
            lines.extend("  " + r[0] for r in sub.rows)
        return _plan_result(lines)
    if cl.catalog.rollups:
        from citus_tpu_torch.rollup.routing import match_rollup
        m = match_rollup(cl, st)
        if m is not None:
            rname, rspec, rplan = m
            lines = [f"Rollup Scan on {rspec['table']} "
                     f"(rollup: {rname}, source: {rspec['source']})"]
            aggs = [f"{k}->{o}" for k, o, _p in rplan["items"]
                    if k != "group"]
            lines.append("  Finalize From Stored Sketches: "
                         + ", ".join(aggs))
            if rplan["groups"]:
                lines.append("  Re-merge GroupBy: "
                             + ", ".join(rplan["groups"]))
            if stmt.analyze:
                lines.extend(_run_analyze(cl, stmt))
            return _plan_result(lines)
    from citus_tpu_torch.planner.physical import plan_select
    bound = bind_select(cl.catalog, st)
    plan = plan_select(cl.catalog, bound,
                       direct_limit=cl.settings.planner.direct_gid_limit)
    t = bound.table
    kind = ("Router" if plan.is_router else "Distributed") \
        if t.is_distributed else "Local"
    lines = [f"{kind} Scan on {t.name} "
             f"(shards: {len(plan.shard_indexes)}/{t.shard_count})"]
    if plan.index_eq is not None:
        icol, ival, iname = plan.index_eq
        if t.schema.scan_column(icol).type.is_text:
            # the literal was bound to its dictionary id: show the string
            decoded = cl.catalog.decode_strings(t.name, icol, [int(ival)])
            ival = decoded[0] if decoded else ival
        lines.append(f"  Index Lookup: {icol} = {ival!r} using {iname}")
    if plan.intervals:
        lines.append("  Chunk Pruning: " +
                     ", ".join(sorted({c.column for c in plan.intervals})))
    if bound.has_aggs:
        mode = plan.group_mode
        desc = {"scalar": "Global Aggregate",
                "direct": f"Direct GroupBy (groups: {mode.n_groups}, "
                          "combine: psum)",
                "hash_host": "Hash GroupBy (host combine)"}[mode.kind]
        lines.append(f"  Partial Aggregate per shard -> {desc}")
        lines.append("    Partials: " + ", ".join(
            f"{op.kind}[{op.dtype}]" for op in plan.partial_ops))
    if stmt.analyze:
        lines.extend(_run_analyze(cl, stmt))
    return _plan_result(lines)


def _explain_modify(cl, m) -> Result:
    """UPDATE / DELETE: the shards the WHERE leaves, the pruning columns
    and the strategy the statement would take (nothing runs)."""
    from citus_tpu_torch.planner.bind import Binder
    from citus_tpu_torch.planner.physical import extract_intervals, prune_shards
    t = cl.catalog.table(m.table)
    op = "Update" if isinstance(m, A.Update) else "Delete"
    if t.is_partitioned:
        from citus_tpu_torch.partitioning import prune_partitions
        surv = prune_partitions(cl.catalog, t, m.where)
        return _plan_result([
            f"{op} on {m.table} (partitions: {len(surv)}/"
            f"{len(cl.catalog.partitions_of(m.table))})"])
    where = Binder(cl.catalog, t).bind_scalar(m.where) \
        if m.where is not None else None
    sis = prune_shards(t, where)
    lines = [f"{op} on {m.table} (shards: {len(sis)}/{len(t.shards)})"]
    ivs = [c.column for c in extract_intervals(where)] \
        if where is not None else []
    if ivs:
        lines.append(f"  Shard/Chunk Pruning: {', '.join(sorted(set(ivs)))}")
    owners = {t.shards[si].placements[0] for si in sis}
    remote = {o for o in owners if cl.catalog.is_remote_node(o)}
    if remote and owners == remote and len(
            {cl.catalog.node_endpoint(o) for o in remote}) == 1:
        lines.append("  Strategy: forward to remote owner "
                     "(router, statement shipped as SQL)")
    elif remote:
        lines.append(f"  Strategy: cross-host two-phase commit "
                     f"({len(remote)} remote node(s))")
    else:
        lines.append("  Strategy: local (deletion bitmaps"
                     + (" + re-insert)" if op == "Update" else ")"))
    return _plan_result(lines)


def _explain_insert_select(cl, ins) -> Result:
    """INSERT … SELECT: the strategy ladder of ``commands/insert.py``
    and the source's plan."""
    t = cl.catalog.table(ins.table)
    names = list(ins.columns or t.schema.names)
    strategy = "pull"
    sel = ins.select
    if isinstance(sel, A.Select) and isinstance(sel.from_, A.TableRef) \
            and not (sel.group_by or sel.having or sel.order_by
                     or sel.limit or sel.distinct):
        from citus_tpu_torch.commands.insert import _insert_select_strategy
        try:
            bound = bind_select(cl.catalog, sel)
            if not bound.has_aggs and len(bound.final_exprs) == len(names):
                strategy = _insert_select_strategy(
                    t, bound, list(bound.final_exprs), names)
        # lint: disable=SWL01 -- EXPLAIN-only strategy probe; a bind failure falls back to the generic label
        except Exception:
            pass
    lines = [f"Insert into {ins.table} ({', '.join(names)})",
             f"  Strategy: {strategy}"
             + {"colocated": "  (per-shard pushdown, no re-hash)",
                "repartition": "  (array-streaming re-hash)",
                "pull": "  (coordinator row materialization)"}[strategy]]
    if isinstance(sel, (A.Select, A.SetOp)):
        sub = execute_explain(cl, A.Explain(sel, analyze=False))
        lines.append("  -> source:")
        lines.extend("     " + row[0] for row in sub.rows)
    return _plan_result(lines)


def _run_analyze(cl, stmt: A.Explain) -> list[str]:
    """Execute the statement under a FORCED trace and render every
    timing line from the resulting span tree (the tree the slow-query
    log sees), so EXPLAIN ANALYZE cannot drift from the tracing.

    Executes through the plan cache, keyed by the statement's AST repr
    (never the surrounding EXPLAIN text), so a repeated ANALYZE shows
    the cache's hit and its kernels' reuse."""
    from citus_tpu_torch.executor.device_cache import GLOBAL_CACHE
    from citus_tpu_torch.executor.kernel_cache import plan_fingerprint
    from citus_tpu_torch.observability import trace as _trace
    c0 = cl.counters.snapshot()
    qt = _trace.begin_query(f"explain analyze {stmt.statement!r:.80}",
                            cl.settings.observability, force=True)
    try:
        xbound, xplan, values = cl._cached_select_plan(
            stmt.statement, ("$explain", repr(stmt.statement)))
        r = execute_select(cl.catalog, xbound, cl.settings, plan=xplan,
                           param_values=values, device=cl.device,
                           mesh=cl.mesh)
    finally:
        qt.finish()
    c1 = cl.counters.snapshot()
    tr = qt.trace
    _trace.set_last(tr)
    lines = []
    ex = tr.find("execute")
    elapsed_ms = ex.duration_ms if ex is not None \
        else r.explain["elapsed_s"] * 1000
    lines.append(f"  Rows: {r.rowcount}  Elapsed: {elapsed_ms:.2f} ms")
    ps = tr.find("plan")
    hit = ps.attrs.get("cache_hit") if ps is not None else \
        c1.get("plan_cache_hits", 0) > c0.get("plan_cache_hits", 0)
    fp = (ps.attrs.get("fingerprint") if ps is not None else None) \
        or plan_fingerprint(xplan)[:12]
    compile_ms = int(sum(s.duration_ms
                         for s in tr.find_all("kernel_compile")))
    lines.append(f"  Plan Cache: {'hit' if hit else 'miss'}  "
                 f"fingerprint {fp}  compile {compile_ms} ms")
    dh = c1.get("device_cache_hits", 0) - c0.get("device_cache_hits", 0)
    dm = c1.get("device_cache_misses", 0) - c0.get("device_cache_misses", 0)
    lines.append(f"  Device Cache: {dh} hit(s), {dm} miss(es)")
    # the device-memory odometer of THIS statement (hits replay resident
    # bytes, streams book the transfer) and what the cache holds now
    hbm = (c1.get("device_hbm_touched_bytes", 0)
           - c0.get("device_hbm_touched_bytes", 0))
    mv = GLOBAL_CACHE.memory_view()
    lines.append(f"  Memory: {hbm} HBM bytes touched, "
                 f"cache-resident {mv['live_bytes']} bytes "
                 f"(high water {mv['high_water_bytes']})")
    mb = (ex.attrs.get("megabatch") if ex is not None else None) \
        or r.explain.get("megabatch")
    if mb:
        lines.append(
            f"  Batch: occupancy {mb.get('occupancy')}/"
            f"window {mb.get('window_ms', 0):g} ms  "
            f"(wait {mb.get('wait_ms', 0):.2f} ms)")
    rounds = tr.find_all("device_round")
    tasks = r.explain.get("tasks") or []
    if tasks:
        lines.append(f"  Tasks: {len(tasks)}  "
                     f"Tasks Shown: One of {len(tasks)}")
        si, nrows, dt = tasks[0]
        lines.append(f"    -> Task (shard index {si}): {nrows} rows, "
                     f"{dt*1000:.2f} ms device dispatch")
    elif rounds:
        lines.append(f"  Device Rounds: {len(rounds)}  "
                     f"({sum(s.duration_ms for s in rounds):.2f} ms)")
    rtasks = tr.find_all("remote_task")
    if rtasks:
        lines.append(f"  Remote Tasks: {len(rtasks)}")
        for s in rtasks:
            lines.append(
                f"    -> Task (shard index {s.attrs.get('shard_index')}): "
                f"pushed to node {s.attrs.get('node')}, "
                f"{s.attrs.get('bytes', 0)} result bytes, "
                f"{s.attrs.get('rpc_ms', 0):.2f} ms rpc, "
                f"{s.attrs.get('dec_ms', 0):.2f} ms decode")
    pl = (ex.attrs.get("pipeline") if ex is not None else None) \
        or r.explain.get("pipeline") or {}
    if set(pl) - _PORT_ONLY_PIPELINE:
        line = (
            f"  Pipeline: host decode {pl.get('host_decode_ms', 0):.2f}"
            f" ms, device {pl.get('device_ms', 0):.2f} ms, "
            f"H2D {pl.get('h2d_bytes', 0)} bytes, "
            f"stalls host={pl.get('host_stalls', 0)} "
            f"device={pl.get('device_stalls', 0)}")
        if "fused_dispatches" in pl:
            # the one-dispatch-per-batch claim, visible per statement
            line += f", fused dispatches {pl['fused_dispatches']}"
        if "stream_window_peak_bytes" in pl:
            line += (f", stream window peak "
                     f"{pl['stream_window_peak_bytes']} bytes")
        lines.append(line)
        if "hash_slots" in pl:
            lines.append(
                f"    Hash: hash slots {pl['hash_slots']}, "
                f"occupancy {pl.get('hash_occupancy_pct', 0):g}%, "
                f"spilled {pl.get('hash_spilled_rows', 0)} rows")
        if "remote_wait_ms" in pl:
            wire = f", wire {pl['wire_format']}" \
                if pl.get("wire_format") else ""
            lines.append(
                f"    Remote Wait: {pl['remote_wait_ms']:.2f} ms "
                f"(overlapped {pl['remote_overlapped_ms']:.2f} ms, "
                f"peak in-flight {pl['remote_inflight_peak']}{wire})")
    return lines


def _explain_join(cl, stmt: A.Explain) -> Result:
    from citus_tpu_torch.executor.join_executor import execute_join_select
    from citus_tpu_torch.planner.join_planner import bind_join_select
    bj = bind_join_select(cl.catalog, stmt.statement)
    lines = [f"Join ({bj.strategy}) over {len(bj.rels)} relations"]
    for s_ in bj.steps:
        keys = ", ".join(f"{lk} = {rk}" for lk, rk in
                         zip(s_.left_keys, s_.right_keys)) or "(cross)"
        lines.append(f"  {s_.kind.upper()} JOIN {s_.right_alias} ON {keys}")
    for alias, _t in bj.rels:
        rp = bj.rel_plans[alias]
        f = f" filter: {rp.filter}" if rp.filter is not None else ""
        lines.append(f"  Scan {alias} [{', '.join(rp.columns)}]{f}")
    if bj.has_aggs:
        lines.append(f"  GroupBy keys={len(bj.group_keys)} "
                     f"partials={len(bj.partial_ops)} (host combine)")
    if stmt.analyze:
        r = execute_join_select(cl.catalog, bj, cl.settings,
                                device=cl.device, mesh=cl.mesh)
        lines.append(f"  Rows: {r.rowcount}  Tasks: {r.explain['tasks']}  "
                     f"Elapsed: {r.explain['elapsed_s']*1000:.2f} ms")
    return _plan_result(lines)
