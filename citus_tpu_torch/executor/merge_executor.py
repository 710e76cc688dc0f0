"""MERGE execution.

Reference: the MERGE planner/executor
(src/backend/distributed/planner/merge_planner.c,
executor/merge_executor.c) — target⋈source matched rows drive
UPDATE/DELETE, unmatched source rows drive INSERT, all under one
distributed transaction.

Implementation: load the source frame, join it to every target
placement's rows (positions tracked) on the ON equi-keys, enforce
PostgreSQL's one-source-row-per-target-row rule, then stage deletion
bitmaps (update = delete + re-insert) and the insert batch in a single
2PC.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from citus_tpu_torch.catalog import Catalog
from citus_tpu_torch.errors import AnalysisError, ExecutionError, UnsupportedFeatureError
from citus_tpu_torch.executor.join_executor import _hash_join_indexes, _key_matrix, _load_rel_frame
from citus_tpu_torch.planner import ast_nodes as A
from citus_tpu_torch.planner.bind import Binder
from citus_tpu_torch.planner.bound import BCast, BColumn, BLiteral, compile_expr, predicate_mask
from citus_tpu_torch.planner.join_planner import RelPlan, _conjuncts, _rel_of
from citus_tpu_torch.storage import ShardReader
from citus_tpu_torch.storage.deletes import commit_staged_deletes, deleted_mask, load_deletes, stage_deletes
from citus_tpu_torch.storage.writer import _load_meta, commit_staged
from citus_tpu_torch.transaction.manager import TransactionLog, TxState
from citus_tpu_torch import types as T


def _eval_text_target(cat, source, s_alias, target, tcol, bound, env, n):
    """Evaluate a value destined for a TEXT target column.  A bare
    source column's codes live in the SOURCE table's dictionary — decode
    there and re-encode into the target column's dictionary.  Anything
    else that touches source text fails closed (a computed text value
    cannot be remapped after the fact)."""
    from citus_tpu_torch.planner.bound import referenced_columns
    pfx = s_alias + "."
    if isinstance(bound, BColumn) and bound.name.startswith(pfx):
        src_col = bound.name[len(pfx):]
        v, m = _eval(env, bound, n)
        codes = np.asarray(v).astype(np.int64)
        mm = np.asarray(m) if not isinstance(m, bool) else np.full(n, m)
        out = np.zeros(n, np.int64)
        idx = np.nonzero(mm)[0]
        if idx.size:
            words = cat.decode_strings(source.name, src_col,
                                       codes[idx].tolist())
            out[idx] = cat.encode_strings(target.name, tcol, words)
        return out, mm
    if any(c.startswith(pfx)
           and source.schema.has(c[len(pfx):])
           and source.schema.column(c[len(pfx):]).type.is_text
           for c in referenced_columns(bound)):
        raise UnsupportedFeatureError(
            f"MERGE cannot assign a computed text expression over source "
            f"columns to {tcol!r} (dictionary remap of computed values)")
    return _eval(env, bound, n)


def _eval(frame, expr, n):
    v, valid = compile_expr(expr, np)(frame)
    v = np.asarray(v)
    if v.ndim == 0:
        v = np.broadcast_to(v, (n,))
    if valid is True:
        valid = np.ones(n, bool)
    elif valid is False:
        valid = np.zeros(n, bool)
    else:
        valid = np.asarray(valid)
        if valid.ndim == 0:
            valid = np.broadcast_to(valid, (n,))
    return v, valid


def execute_merge(cat: Catalog, txlog: TransactionLog, stmt: A.Merge,
                  encode_value) -> dict:
    t_alias = stmt.target.alias or stmt.target.name
    s_alias = stmt.source.alias or stmt.source.name
    target = cat.table(stmt.target.name)
    source = cat.table(stmt.source.name)
    binder = Binder(cat, target, rels=[(t_alias, target), (s_alias, source)])

    on = binder.bind_scalar(stmt.on)
    t_keys, s_keys = [], []
    residual = []
    for c in _conjuncts(on):
        placed = False
        from citus_tpu_torch.planner.bound import BBinOp
        if isinstance(c, BBinOp) and c.op == "=":
            la, ra = _rel_of(c.left, True), _rel_of(c.right, True)
            if la == t_alias and ra == s_alias:
                t_keys.append(c.left)
                s_keys.append(c.right)
                placed = True
            elif ra == t_alias and la == s_alias:
                t_keys.append(c.right)
                s_keys.append(c.left)
                placed = True
        if not placed:
            residual.append(c)
    if not t_keys:
        raise UnsupportedFeatureError("MERGE requires an equi-join ON condition")
    if residual:
        raise UnsupportedFeatureError("non-equi MERGE ON conjuncts are not supported yet")
    if any(k.type.is_text for k in t_keys):
        # per-table dictionaries: source and target codes for the same
        # string differ, so a raw-code equi-join would be silently wrong
        raise UnsupportedFeatureError(
            "MERGE ON text join keys is not supported yet")

    matched_when = [w for w in stmt.whens if w.matched]
    notmatched_when = [w for w in stmt.whens if not w.matched]
    if len(matched_when) > 1 or len(notmatched_when) > 1:
        raise UnsupportedFeatureError("at most one WHEN [NOT] MATCHED clause each")
    mw = matched_when[0] if matched_when else None
    nw = notmatched_when[0] if notmatched_when else None
    if nw is not None and nw.action == "insert":
        ins_cols = nw.insert_columns or target.schema.names
        if len(ins_cols) != len(nw.insert_values):
            raise AnalysisError("INSERT column/value count mismatch")

    # ---- load the source frame ----------------------------------------
    src_plan = RelPlan(s_alias, source, columns=list(source.schema.names))
    src_frame, src_n = _load_rel_frame(cat, src_plan, qualified=True)
    smat, svalid = _key_matrix(src_frame, s_keys, src_n)
    src_matched = np.zeros(src_n, bool)

    xid = txlog.begin()
    try:
        return _execute_merge_tx(
            cat, txlog, target, xid, src_frame, src_n, smat, svalid,
            src_matched, binder, t_alias, t_keys, mw, nw, encode_value,
            source, s_alias)
    except BaseException:
        # stop driving the transaction; recovery decides its outcome
        txlog.release(xid)
        raise


def _execute_merge_tx(cat, txlog, target, xid, src_frame, src_n,
                      smat, svalid, src_matched, binder, t_alias, t_keys,
                      mw, nw, encode_value, source, s_alias) -> dict:
    staged_delete_dirs: list[str] = []
    insert_rows = {c: [] for c in target.schema.names}
    insert_valid = {c: [] for c in target.schema.names}
    # rows being replaced, for the delete-aware unique probe
    replaced: dict = {}
    n_updated = n_deleted = 0

    # ---- per target shard: join + stage matched actions ----------------
    for shard in target.shards:
        primary = shard.placements[0]
        d = cat.shard_dir(target.name, shard.shard_id, primary)
        if not os.path.isdir(d):
            continue
        reader = ShardReader(d, target.schema)
        dcache = load_deletes(d)
        stripe_rows = {s["file"]: s["row_count"] for s in reader.meta["stripes"]}
        # materialize live target rows with positions
        frames, positions, stripes = [], [], []
        for batch in reader.scan(target.schema.names, apply_deletes=False):
            live = np.ones(batch.row_count, bool)
            dm = deleted_mask(d, batch.stripe_file, stripe_rows[batch.stripe_file], dcache)
            if dm is not None:
                live &= ~dm[batch.chunk_row_offset:batch.chunk_row_offset + batch.row_count]
            idx = np.nonzero(live)[0]
            if idx.size == 0:
                continue
            frame = {}
            for c in target.schema.names:
                v = batch.values[c][idx]
                m = batch.validity[c]
                m = np.ones(idx.size, bool) if m is None else m[idx]
                frame[f"{t_alias}.{c}"] = (
                    v.astype(target.schema.column(c).type.device_dtype, copy=False), m)
            frames.append((frame, idx.size))
            positions.append(batch.chunk_row_offset + idx)
            stripes.append(batch.stripe_file)
        if not frames:
            continue
        # concatenate per-placement
        n_t = sum(n for _, n in frames)
        tgt_frame = {}
        for key in frames[0][0]:
            tgt_frame[key] = (np.concatenate([f[key][0] for f, _ in frames]),
                              np.concatenate([f[key][1] for f, _ in frames]))
        pos_flat = np.concatenate(positions)
        stripe_of = np.concatenate([np.full(len(p), si, np.int32)
                                    for si, p in enumerate(positions)])
        tmat, tvalid = _key_matrix(tgt_frame, t_keys, n_t)
        li, ri, _, _ = _hash_join_indexes(tmat, tvalid, smat, svalid, "inner")
        if li.size == 0:
            continue
        # PostgreSQL rule: a target row may match at most one source row
        uniq, counts = np.unique(li, return_counts=True)
        if (counts > 1).any():
            raise ExecutionError(
                "MERGE command cannot affect the same row a second time")
        src_matched[ri] = True
        if mw is None or mw.action == "nothing":
            continue
        # merged env for WHEN MATCHED condition + assignments
        env = {}
        for k, (v, m) in tgt_frame.items():
            env[k] = (v[li], m[li])
        for k, (v, m) in src_frame.items():
            vv = np.asarray(v)
            mm = m if not isinstance(m, bool) else np.full(src_n, m)
            env[k] = (vv[ri], np.asarray(mm)[ri])
        act = np.ones(li.size, bool)
        if mw.condition is not None:
            cond = binder.bind_scalar(mw.condition)
            act = np.asarray(predicate_mask(np, compile_expr(cond, np), env,
                                            np.ones(li.size, bool)))
            if act.shape == ():
                act = np.full(li.size, bool(act))
        if not act.any():
            continue
        sel = np.nonzero(act)[0]
        # stage deletions for affected target rows (per stripe)
        per_stripe: dict[str, list] = {}
        for i in sel:
            sf = stripes[stripe_of[li[i]]]
            per_stripe.setdefault(sf, []).append(pos_flat[li[i]])
        merged = {sf: (np.asarray(ix, np.int64), stripe_rows[sf])
                  for sf, ix in per_stripe.items()}
        repl = replaced.setdefault(d, {})
        for sf, (ix, _rows) in merged.items():
            repl.setdefault(sf, set()).update(ix.tolist())
        for node in shard.placements:
            pd = cat.shard_dir(target.name, shard.shard_id, node)
            if os.path.isdir(pd):
                stage_deletes(pd, xid, merged)
                staged_delete_dirs.append(pd)
        if mw.action == "delete":
            n_deleted += sel.size
            continue
        # update: re-insert assigned rows
        assign = {}
        for col, e in mw.assignments:
            tc = target.schema.column(col)
            bound = binder.bind_scalar(e)
            if tc.type.is_text:
                if isinstance(bound, BLiteral) and isinstance(bound.value, str):
                    bound = BLiteral(encode_value(target.name, col, bound.value), tc.type)
                elif not bound.type.is_text:
                    raise AnalysisError(f"cannot assign {bound.type} to {col}")
            elif bound.type != tc.type and not bound.type.is_text:
                bound = BCast(bound, tc.type)
            assign[col] = bound
        for c in target.schema.names:
            tc = target.schema.column(c)
            if c in assign:
                if tc.type.is_text:
                    v, m = _eval_text_target(cat, source, s_alias, target,
                                             c, assign[c], env, li.size)
                else:
                    v, m = _eval(env, assign[c], li.size)
            else:
                v, m = env[f"{t_alias}.{c}"]
            insert_rows[c].append(np.asarray(v)[sel].astype(tc.type.storage_dtype))
            insert_valid[c].append(np.asarray(m)[sel])
        n_updated += sel.size

    # ---- WHEN NOT MATCHED: inserts from unmatched source rows ----------
    n_inserted = 0
    if nw is not None and nw.action == "insert":
        # rows with NULL join keys are also "not matched"
        un = np.nonzero(~src_matched)[0]
        if un.size:
            act = np.ones(un.size, bool)
            sub_env = {k: (np.asarray(v)[un],
                           (np.asarray(m)[un] if not isinstance(m, bool)
                            else np.full(un.size, m)))
                       for k, (v, m) in src_frame.items()}
            if nw.condition is not None:
                cond = binder.bind_scalar(nw.condition)
                act = np.asarray(predicate_mask(np, compile_expr(cond, np), sub_env,
                                                np.ones(un.size, bool)))
                if act.shape == ():
                    act = np.full(un.size, bool(act))
            sel = np.nonzero(act)[0]
            if sel.size:
                ins_cols = nw.insert_columns or target.schema.names
                provided = {}
                for col, e in zip(ins_cols, nw.insert_values):
                    tc = target.schema.column(col)
                    bound = binder.bind_scalar(e)
                    if tc.type.is_text:
                        if isinstance(bound, BLiteral) and isinstance(bound.value, str):
                            bound = BLiteral(encode_value(target.name, col, bound.value), tc.type)
                        elif not bound.type.is_text:
                            raise AnalysisError(f"cannot insert {bound.type} into {col}")
                    elif bound.type != tc.type and not bound.type.is_text:
                        bound = BCast(bound, tc.type)
                    if tc.type.is_text:
                        v, m = _eval_text_target(cat, source, s_alias,
                                                 target, col, bound,
                                                 sub_env, un.size)
                    else:
                        v, m = _eval(sub_env, bound, un.size)
                    provided[col] = (np.asarray(v)[sel], np.asarray(m)[sel])
                for c in target.schema.names:
                    tc = target.schema.column(c)
                    if c in provided:
                        v, m = provided[c]
                        insert_rows[c].append(v.astype(tc.type.storage_dtype))
                        insert_valid[c].append(m)
                    else:
                        insert_rows[c].append(np.zeros(sel.size, tc.type.storage_dtype))
                        insert_valid[c].append(np.zeros(sel.size, bool))
                n_inserted = sel.size

    # ---- one 2PC for deletes + inserts ---------------------------------
    ingest_dirs: list[str] = []
    total_new = sum(len(a) for a in insert_rows[target.schema.names[0]])
    if total_new:
        from citus_tpu_torch.ingest import TableIngestor
        values = {c: np.concatenate(insert_rows[c]) for c in target.schema.names}
        validity = {c: np.concatenate(insert_valid[c]) for c in target.schema.names}
        if target.unique_indexes:
            # batch-internal + delete-aware live probe BEFORE anything
            # commits: rows replaced by WHEN MATCHED do not conflict
            from citus_tpu_torch.integrity import check_unique_update
            check_unique_update(cat, target, values, validity,
                                set(target.schema.names), replaced)
        ing = TableIngestor(cat, target, txlog=None)
        ing.xid = xid
        ing.append(values, validity)
        for w in ing._writers.values():
            w.flush()
        ingest_dirs = [w.directory for w in ing._writers.values()]

    if not staged_delete_dirs and not ingest_dirs:
        txlog.release(xid)
        return {"updated": 0, "deleted": 0, "inserted": 0}
    # catalog persisted before the commit record (durability ordering)
    target.version += 1
    cat.commit()
    txlog.log(xid, TxState.PREPARED,
              {"kind": "update", "table": target.name,
               "placements": staged_delete_dirs, "ingest_placements": ingest_dirs})
    txlog.log(xid, TxState.COMMITTED,
              {"table": target.name, "placements": staged_delete_dirs,
               "ingest_placements": ingest_dirs})
    from citus_tpu_torch.transaction.snapshot import flip_generation
    with flip_generation(cat.data_dir, target):
        for d in staged_delete_dirs:
            commit_staged_deletes(d, xid)
        for d in ingest_dirs:
            commit_staged(d, xid)
    txlog.log(xid, TxState.DONE)
    return {"updated": n_updated, "deleted": n_deleted, "inserted": n_inserted}
