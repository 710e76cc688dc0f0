"""Foreign-key integrity: declaration rules and runtime enforcement.

Reference mapping:
- Declaration matrix: the reference validates every foreign key against
  the distribution state of both sides
  (commands/foreign_constraint.c ErrorIfUnsupportedForeignConstraintExists):
  distributed<->distributed requires colocation AND the key covering
  both distribution columns; distributed->reference is free;
  reference->distributed is rejected.
- Reverse edges: utils/foreign_key_relationship.c caches the FK graph;
  here Catalog.referencing_fks() recomputes it (catalog is small).
- Enforcement: PostgreSQL enforces FKs with internal triggers per row;
  Citus inherits that per shard because colocation makes every FK local
  to one worker.  Here enforcement is set-based on the coordinator: an
  ingest batch probes the parent once with the batch's distinct key
  tuples, and referenced-side DELETE/UPDATE pre-images drive
  RESTRICT / CASCADE / SET NULL before the write commits.  All probes
  and cascades run under the statement's write locks.

The port of ``citus_tpu/integrity.py``, with one repair (ROADMAP.md
C12): the reference probes a parent with IN-lists of up to 1,000 keys,
which its binder turns into one left-deep OR chain (``RecursionError``
from about 500 distinct keys), and which the port's device path would
generate into a predicate kernel's source (an nvcc build for every key
set).  Here the ingest probe reads the parent's referenced columns from
its local placements on the host (the reader applies the transaction
overlay, as ``_execute_stmt`` does) and tests membership with numpy, so
it answers any number of keys and builds no kernel.  Rows, error
classes and messages are the reference's wherever the reference
answers.  Statement triggers are not ported (ROADMAP.md A14b), so a
cascade fires none.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from citus_tpu_torch import types as T
from citus_tpu_torch.errors import AnalysisError, ExecutionError, CatalogError
from citus_tpu_torch.planner import ast as A

#: IN-list chunk size of the reference's parent probe, kept for the
#: column kinds the host read does not decode (uuid, bytea, arrays)
_PROBE_CHUNK = 1000

#: physical kinds whose stored value is the ``_canon`` value itself
_HOST_KINDS = frozenset((T.BOOL, T.INT16, T.INT32, T.INT64, T.DECIMAL,
                         T.DATE, T.TIMESTAMP, T.TIMESTAMPTZ, T.TIME,
                         T.FLOAT32, T.FLOAT64, T.TEXT))
#: kinds whose physical values compare exactly with numpy (no float
#: rounding, no dictionary): the batch's physical array is probed as is
_EXACT_KINDS = _HOST_KINDS - {T.FLOAT32, T.FLOAT64, T.TEXT}


class UniqueViolation(ExecutionError):
    """Duplicate key in a UNIQUE index (PostgreSQL SQLSTATE 23505)."""


def _decode_index_value(cat, t, col: str, phys):
    typ = t.schema.column(col).type
    if typ.is_text:
        return cat.decode_strings(t.name, col, [int(phys)])[0]
    return typ.from_physical(np.asarray(phys).item())


def _unique_conflict(cat, t, ix: dict, phys_value) -> "UniqueViolation":
    v = _decode_index_value(cat, t, ix["column"], phys_value)
    return UniqueViolation(
        f'duplicate key value violates unique constraint "{ix["name"]}": '
        f'Key ({ix["column"]})=({v}) already exists')


def _probe_placement_dir(cat, t, shard) -> Optional[str]:
    """First readable placement directory of ``shard`` (same failover
    order as load_shard_batches: a missing primary directory is a failed
    placement, not an empty shard), or None when no placement was ever
    written.  Probing only placements[0] could miss existing keys — and
    admit duplicates — while the primary is unavailable."""
    import os
    for node in shard.placements:
        d = cat.shard_dir(t.name, shard.shard_id, node)
        if os.path.isdir(d):
            return d
    return None


def _probe_unique_live(cat, t, ix: dict, uniq: np.ndarray,
                       exclude: Optional[dict] = None):
    """First value of ``uniq`` (sorted physical values) with a live match
    in any shard, or None.  ``exclude``: {placement_dir: {stripe_file:
    positions about to be deleted}} — rows an in-flight UPDATE replaces
    do not conflict."""
    import os

    from citus_tpu_torch.storage.deletes import deleted_mask
    from citus_tpu_torch.storage.index import load_segment
    from citus_tpu_torch.storage.overlay import visible_deletes, visible_meta
    from citus_tpu_torch.storage.reader import ShardReader

    col = ix["column"]
    for shard in t.shards:
        d = _probe_placement_dir(cat, t, shard)
        if d is None:
            continue
        meta = visible_meta(d)
        dcache = visible_deletes(d)
        excl_dir = (exclude or {}).get(d, {})
        reader = None
        for s in meta["stripes"]:
            seg = load_segment(d, s["file"], col)
            if seg is None:
                # stripe written before the index: scan its column
                if reader is None:
                    reader = ShardReader(d, t.schema)
                for batch in reader.scan([col], only_stripes={s["file"]},
                                         apply_deletes=False):
                    bm = batch.validity[col]
                    bv = batch.values[col]
                    keep = np.ones(batch.row_count, bool) if bm is None \
                        else np.asarray(bm).copy()
                    gpos = batch.chunk_row_offset + np.arange(batch.row_count)
                    dm = deleted_mask(d, s["file"], s["row_count"], dcache) \
                        if s["file"] in dcache else None
                    if dm is not None:
                        keep &= ~dm[gpos]
                    excl = excl_dir.get(s["file"])
                    if excl is not None and len(excl):
                        keep &= ~np.isin(gpos, np.fromiter(excl, np.int64))
                    hit = np.isin(bv[keep], uniq)
                    if hit.any():
                        return bv[keep][hit][0]
                continue
            sv, pos = seg
            lo = np.searchsorted(sv, uniq, "left")
            hi = np.searchsorted(sv, uniq, "right")
            found = hi > lo
            if not found.any():
                continue
            dm = deleted_mask(d, s["file"], s["row_count"], dcache) \
                if s["file"] in dcache else None
            excl = excl_dir.get(s["file"])
            # every segment position of every found value, value by
            # value in ``uniq``'s order: the first live one names the
            # smallest conflicting value
            idx = np.nonzero(found)[0]
            lens = (hi - lo)[idx]
            ends = np.cumsum(lens)
            at = np.repeat(lo[idx] - (ends - lens), lens) \
                + np.arange(int(ends[-1]))
            p = pos[at]
            live = np.ones(p.size, bool)
            if dm is not None:
                live &= ~dm[p]
            if excl:
                live &= ~np.isin(p, np.fromiter(excl, np.int64))
            if live.any():
                owner = np.repeat(idx, lens)
                return uniq[owner[int(np.argmax(live))]]
    return None


def check_unique_ingest(cluster, t, values: dict, validity: dict) -> None:
    """Reject a physical-encoded ingest batch that would duplicate a
    UNIQUE-indexed column — within the batch or against live rows
    (delete-aware; the active transaction's staged writes included via
    the overlay).  Reference: unique-index enforcement at insert time,
    which the columnar AM gets from btree uniqueness during
    columnar_index_build_range_scan inserts."""
    cat = cluster.catalog
    for ix in t.unique_indexes:
        col = ix["column"]
        if col not in values:
            continue
        v = np.asarray(values[col])
        m = np.asarray(validity[col])
        vv = v[m]
        if vv.size == 0:
            continue
        uniq, counts = np.unique(vv, return_counts=True)
        if (counts > 1).any():
            raise _unique_conflict(cat, t, ix, uniq[counts > 1][0])
        hit = _probe_unique_live(cat, t, ix, uniq)
        if hit is not None:
            raise _unique_conflict(cat, t, ix, hit)


def check_unique_update(cat, t, values: dict, validity: dict,
                        assigned_cols: set, exclude: dict) -> None:
    """UPDATE-side uniqueness: the replacement batch must not collide
    with itself or with surviving rows (``exclude`` holds the positions
    being replaced).  Only assigned unique columns can create new
    conflicts — untouched columns keep their already-unique values."""
    for ix in t.unique_indexes:
        col = ix["column"]
        if col not in assigned_cols or col not in values:
            continue
        v = np.asarray(values[col])
        m = np.asarray(validity[col])
        vv = v[m]
        if vv.size == 0:
            continue
        uniq, counts = np.unique(vv, return_counts=True)
        if (counts > 1).any():
            raise _unique_conflict(cat, t, ix, uniq[counts > 1][0])
        hit = _probe_unique_live(cat, t, ix, uniq, exclude=exclude)
        if hit is not None:
            raise _unique_conflict(cat, t, ix, hit)


def validate_unique_backfill(cat, t, ix: dict) -> None:
    """CREATE UNIQUE INDEX on existing data: every live value must be
    distinct (per column, across all shards — uniqueness is global even
    though segments are per-stripe)."""
    import os

    from citus_tpu_torch.storage.reader import ShardReader

    col = ix["column"]
    seen: set = set()
    for shard in t.shards:
        d = _probe_placement_dir(cat, t, shard)
        if d is None:
            continue
        reader = ShardReader(d, t.schema)
        for batch in reader.scan([col]):
            bm = batch.validity[col]
            bv = batch.values[col] if bm is None else batch.values[col][np.asarray(bm)]
            u, c = np.unique(bv, return_counts=True)
            if (c > 1).any():
                raise _unique_conflict(cat, t, ix, u[c > 1][0])
            dup = seen.intersection(u.tolist())
            if dup:
                raise _unique_conflict(cat, t, ix, next(iter(dup)))
            seen.update(u.tolist())


class ForeignKeyViolation(ExecutionError):
    pass


# ------------------------------------------------------------- declaration


def declare_fks(catalog, table_name: str, fkeys: list[dict],
                schema=None) -> list[dict]:
    """Validate CREATE TABLE foreign keys -> normalized catalog records.
    Referenced columns default to the parent's distribution column."""
    out = []
    child_schema = schema if schema is not None else (
        catalog.table(table_name).schema
        if catalog.has_table(table_name) else None)
    for i, fk in enumerate(fkeys):
        ref = fk["ref_table"]
        if not catalog.has_table(ref):
            raise CatalogError(f'relation "{ref}" does not exist')
        parent = catalog.table(ref)
        ref_cols = list(fk["ref_columns"])
        if not ref_cols:
            if parent.dist_column is None:
                raise AnalysisError(
                    f'foreign key to "{ref}" must name the referenced '
                    "column(s)")
            ref_cols = [parent.dist_column]
        if len(ref_cols) != len(fk["columns"]):
            raise AnalysisError(
                "number of referencing and referenced columns for foreign "
                "key disagree")
        for c in ref_cols:
            if not parent.schema.has(c):
                raise AnalysisError(
                    f'column "{c}" referenced in foreign key constraint '
                    f'does not exist in "{ref}"')
        if child_schema is not None:
            for c, rc in zip(fk["columns"], ref_cols):
                if not child_schema.has(c):
                    raise AnalysisError(f'column "{c}" does not exist')
                ct, pt = child_schema.column(c).type, \
                    parent.schema.column(rc).type
                if ct.is_text != pt.is_text or \
                        (not ct.is_text and ct.kind != pt.kind
                         and not (ct.is_numeric and pt.is_numeric)):
                    raise AnalysisError(
                        f'foreign key constraint on "{c}" ({ct}) and '
                        f'"{ref}"."{rc}" ({pt}): incompatible types')
        out.append({"name": fk.get("name") or f"{table_name}_fk_{i + 1}",
                    "columns": list(fk["columns"]), "ref_table": ref,
                    "ref_columns": ref_cols,
                    "on_delete": fk.get("on_delete", "restrict")})
    return out


def _fk_rule_error(child, parent, fk) -> Optional[str]:
    """Citus's distribution matrix for one FK edge, or None when legal
    (reference: ErrorIfUnsupportedForeignConstraintExists)."""
    c_dist, p_dist = child.is_distributed, parent.is_distributed
    c_ref, p_ref = child.is_reference, parent.is_reference
    if c_dist and p_dist:
        if child.colocation_id == 0 or \
                child.colocation_id != parent.colocation_id:
            return ("cannot create foreign key constraint since relations "
                    "are not colocated or not distributed")
        pairs = dict(zip(fk["columns"], fk["ref_columns"]))
        if pairs.get(child.dist_column) != parent.dist_column:
            return ("cannot create foreign key constraint since the "
                    "foreign key must include the distribution column of "
                    "both relations")
        return None
    if p_ref:
        return None  # anything may reference a reference table
    if c_ref and p_dist:
        return ("cannot create foreign key constraint since foreign keys "
                "from reference tables to distributed tables are not "
                "supported")
    # local <-> local and local <-> distributed: allowed.  The reference
    # rejects FKs between distributed and plain local tables because its
    # per-worker triggers cannot see across nodes; here enforcement is
    # coordinator-side and set-based, so locality is not required — a
    # deliberate superset (like columnar UPDATE/DELETE support).
    return None


def validate_fk_distribution(catalog, table_name: str) -> None:
    """Re-check every FK edge touching ``table_name`` after its
    distribution state changed (create_distributed_table /
    create_reference_table run this before committing)."""
    t = catalog.table(table_name)
    for fk in t.foreign_keys:
        err = _fk_rule_error(t, catalog.table(fk["ref_table"]), fk)
        if err:
            raise AnalysisError(err)
    for child_name, fk in catalog.referencing_fks(table_name):
        err = _fk_rule_error(catalog.table(child_name), t, fk)
        if err:
            raise AnalysisError(err)


# ------------------------------------------------------------ enforcement


def _canon(typ, v):
    """Value -> physical comparison space (both batch inputs and decoded
    query results land on the same representation)."""
    if v is None:
        return None
    if isinstance(v, (np.generic,)):
        v = v.item()
    if typ.is_text:
        return str(v)
    if typ.kind in (T.DATE, T.TIMESTAMP) and isinstance(v, (int, float)) \
            and not isinstance(v, bool):
        return int(v)  # already physical (ingest fast path)
    return typ.to_physical(v)


def _parent_batches(cluster, parent, ref_cols: list[str]):
    """Yield ([physical array per column], all-valid row mask) over the
    live rows of every shard of ``parent``, read from its first readable
    local placement.  The reader merges the open transaction's staged
    stripes and deletes (storage/overlay.py), so the probe sees what a
    SELECT of this statement sees."""
    from citus_tpu_torch.errors import UnsupportedFeatureError
    from citus_tpu_torch.storage.reader import ShardReader
    cat = cluster.catalog
    if cat.remote_data is not None and any(
            cat.is_remote_node(nd) for s in parent.shards
            for nd in s.placements):
        raise UnsupportedFeatureError(
            f'a foreign key probe of "{parent.name}", whose shards another '
            "coordinator hosts, is not ported yet (ROADMAP.md A13)")
    for shard in parent.shards:
        d = _probe_placement_dir(cat, parent, shard)
        if d is None:
            continue
        for batch in ShardReader(d, parent.schema).scan(list(ref_cols)):
            ok = np.ones(batch.row_count, bool)
            for c in ref_cols:
                if batch.validity[c] is not None:
                    ok &= np.asarray(batch.validity[c], bool)
            yield [np.asarray(batch.values[c]) for c in ref_cols], ok


def _parent_key_set(cluster, parent_name: str, ref_cols: list[str],
                    first_vals: list) -> set:
    """The parent's distinct key tuples whose first column is one of
    ``first_vals`` -> set of canon tuples: the reference's result,
    read on the host (module note).  Column kinds the host read does
    not decode take the reference's IN-list probe."""
    cat = cluster.catalog
    parent = cat.table(parent_name)
    types = [parent.schema.column(c).type for c in ref_cols]
    if any(tt.kind not in _HOST_KINDS for tt in types):
        return _parent_key_set_by_query(cluster, parent_name, ref_cols,
                                        first_vals)
    first = {_canon(types[0], v) for v in first_vals}
    first.discard(None)
    if types[0].kind == T.TEXT:
        ids = [cat.lookup_string_id(parent_name, ref_cols[0], w)
               for w in first]
        probe = np.asarray([i for i in ids if i is not None], np.int64)
    else:
        probe = np.asarray(sorted(first))
    out: set = set()
    if probe.size == 0:
        return out
    for arrs, ok in _parent_batches(cluster, parent, ref_cols):
        keep = ok & np.isin(arrs[0], probe)
        if not keep.any():
            continue
        cols = []
        for tt, c, a in zip(types, ref_cols, arrs):
            a = a[keep]
            cols.append(cat.decode_strings(parent_name, c, a.tolist())
                        if tt.kind == T.TEXT else a.tolist())
        out.update(zip(*cols))
    return out


def _parent_key_set_by_query(cluster, parent_name: str, ref_cols: list[str],
                             first_vals: list) -> set:
    """The reference's probe: IN-list chunks through ``_execute_stmt``."""
    from citus_tpu_torch.cluster import _pylit
    parent = cluster.catalog.table(parent_name)
    types = [parent.schema.column(c).type for c in ref_cols]
    out: set = set()
    for i in range(0, len(first_vals), _PROBE_CHUNK):
        chunk = first_vals[i:i + _PROBE_CHUNK]
        where = A.InList(A.ColumnRef(ref_cols[0]),
                         tuple(_pylit(v) for v in chunk), False)
        sel = A.Select([A.SelectItem(A.ColumnRef(c)) for c in ref_cols],
                       A.TableRef(parent_name), where, distinct=True)
        for row in cluster._execute_stmt(sel).rows:
            out.add(tuple(_canon(tt, v) for tt, v in zip(types, row)))
    return out


def _all_present(cluster, fk: dict, child, values: dict,
                 validity: dict) -> bool:
    """Whether every non-null key of a physical batch is in the parent,
    tested with numpy, when child and parent columns share one exact
    physical kind (the common case: a bigint key referencing a bigint
    key).  False also when the test does not apply; the caller then
    runs the reference's exact check, which names the missing key."""
    parent = cluster.catalog.table(fk["ref_table"])
    pairs = list(zip(fk["columns"], fk["ref_columns"]))
    for c, rc in pairs:
        ct, pt = child.schema.column(c).type, parent.schema.column(rc).type
        if ct != pt or ct.kind not in _EXACT_KINDS or c not in values:
            return False
    ok = np.ones(len(values[pairs[0][0]]), bool)
    for c, _rc in pairs:
        ok &= np.asarray(validity[c], bool)
    keys = [np.asarray(values[c])[ok] for c, _rc in pairs]
    if keys[0].size == 0:
        return True
    if len(keys) == 1:
        want = np.unique(keys[0])
        seen = np.zeros(want.size, bool)
        for arrs, pok in _parent_batches(cluster, parent, fk["ref_columns"]):
            seen |= np.isin(want, arrs[0][pok])
            if seen.all():
                return True
        return bool(seen.all())
    want_set = set(zip(*(k.tolist() for k in keys)))
    first = np.unique(keys[0])
    for arrs, pok in _parent_batches(cluster, parent, fk["ref_columns"]):
        keep = pok & np.isin(arrs[0], first)
        want_set -= set(zip(*(a[keep].tolist() for a in arrs)))
        if not want_set:
            return True
    return not want_set


def check_ingest(cluster, table_meta, columns: dict, values=None,
                 validity=None) -> None:
    """Every non-null FK tuple of the batch must exist in its parent
    (the INSERT/COPY half of PostgreSQL's RI triggers, done set-based:
    one probe per FK per batch).  ``values``/``validity``, the batch
    encoded, let a batch whose keys are all present pass on a numpy
    test alone."""
    for fk in table_meta.foreign_keys:
        cols, ref_cols = fk["columns"], fk["ref_columns"]
        if any(c not in columns for c in cols):
            # column not provided -> all NULL -> no constraint to check
            continue
        if values is not None and _all_present(cluster, fk, table_meta,
                                               values, validity):
            continue
        # canonicalize BOTH sides in the parent's type space, so e.g. a
        # double child column referencing a decimal parent compares in
        # the parent's scaled-int representation
        parent = cluster.catalog.table(fk["ref_table"])
        types = [parent.schema.column(rc).type for rc in ref_cols]
        n = len(next(iter(columns.values()))) if columns else 0
        seqs = [columns[c] for c in cols]
        tuples: set = set()
        for i in range(n):
            vals = tuple(_canon(tt, s[i]) for tt, s in zip(types, seqs))
            if any(v is None for v in vals):
                continue  # MATCH SIMPLE: any NULL -> not checked
            tuples.add(vals)
        if not tuples:
            continue
        # probe literals come from the raw input (pre-physical) so text/
        # date literals bind naturally; keyed by the first column
        raw_by_first: dict = {}
        for i in range(n):
            vals = tuple(_canon(tt, s[i]) for tt, s in zip(types, seqs))
            if any(v is None for v in vals):
                continue
            v0 = seqs[0][i]
            raw_by_first.setdefault(vals[0], v0.item()
                                    if isinstance(v0, np.generic) else v0)
        parent_keys = _parent_key_set(cluster, fk["ref_table"], ref_cols,
                                      sorted(raw_by_first.values(),
                                             key=repr))
        missing = tuples - parent_keys
        if missing:
            bad = next(iter(missing))
            raise ForeignKeyViolation(
                f'insert or update on table "{table_meta.name}" violates '
                f'foreign key constraint "{fk["name"]}": Key '
                f'({", ".join(cols)})=({", ".join(map(str, bad))}) is not '
                f'present in table "{fk["ref_table"]}"')


def referenced_preimage(cluster, table_name: str, where,
                        ref_cols: list[str]) -> list[tuple]:
    """DISTINCT referenced-column tuples of the rows a DELETE/UPDATE on
    the parent is about to touch."""
    sel = A.Select([A.SelectItem(A.ColumnRef(c)) for c in ref_cols],
                   A.TableRef(table_name), where, distinct=True)
    return [tuple(r) for r in cluster._execute_stmt(sel).rows]


def _child_match_where(fk: dict, key_tuples: list[tuple]):
    """WHERE matching child rows whose FK equals any deleted parent key."""
    from citus_tpu_torch.cluster import _pylit
    cond = None
    for key in key_tuples:
        eq = None
        for c, v in zip(fk["columns"], key):
            if v is None:
                eq = None
                break
            this = A.BinOp("=", A.ColumnRef(c), _pylit(v))
            eq = this if eq is None else A.BinOp("and", eq, this)
        if eq is None:
            continue
        cond = eq if cond is None else A.BinOp("or", cond, eq)
    return cond


def on_parent_delete(cluster, table_name: str, where) -> None:
    """Apply referenced-side actions before deleting parent rows:
    RESTRICT errors, CASCADE deletes children (recursively through the
    normal DELETE path), SET NULL clears the child columns."""
    refs = cluster.catalog.referencing_fks(table_name)
    if not refs:
        return
    for child_name, fk in refs:
        keys = referenced_preimage(cluster, table_name, where,
                                   fk["ref_columns"])
        cond = _child_match_where(fk, keys)
        if cond is None:
            continue
        if fk["on_delete"] == "cascade":
            cluster._execute_stmt(A.Delete(child_name, cond))
            continue
        if fk["on_delete"] == "set null":
            assignments = [(c, A.Literal(None, "null"))
                           for c in fk["columns"]]
            cluster._execute_stmt(A.Update(child_name, assignments, cond))
            continue
        chk = A.Select([A.SelectItem(A.FuncCall("count", (A.Star(),)))],
                       A.TableRef(child_name), cond)
        if cluster._execute_stmt(chk).rows[0][0]:
            raise ForeignKeyViolation(
                f'update or delete on table "{table_name}" violates '
                f'foreign key constraint "{fk["name"]}" on table '
                f'"{child_name}"')


def on_parent_update(cluster, table_name: str, assigned_cols: set,
                     where, assignments=None) -> None:
    """NO ACTION semantics when an UPDATE rewrites referenced key
    columns that child rows still point at.  A pre-image key survives
    (no error) when the constant assignments map it to itself
    (e.g. UPDATE parent SET pk = <same value>) or when parent rows
    outside the statement's WHERE still carry it; otherwise matching
    child rows raise, conservatively pre-statement rather than at
    statement end as PostgreSQL does."""
    for child_name, fk in cluster.catalog.referencing_fks(table_name):
        if not assigned_cols.intersection(fk["ref_columns"]):
            continue
        keys = referenced_preimage(cluster, table_name, where,
                                   fk["ref_columns"])
        const = {c: e.value for c, e in (assignments or [])
                 if c in fk["ref_columns"] and isinstance(e, A.Literal)}
        all_const = all(isinstance(e, A.Literal)
                        for c, e in (assignments or [])
                        if c in fk["ref_columns"])
        at_risk = []
        for key in keys:
            if all_const and assignments is not None:
                post = tuple(const.get(c, v)
                             for c, v in zip(fk["ref_columns"], key))
                if post == key:
                    continue  # value-preserving: key survives as-is
            at_risk.append(key)
        cond = _child_match_where(fk, at_risk)
        if cond is None:
            continue
        # one batched probe finds the conflicting keys; the per-key
        # escape check below runs only for those
        probe = A.Select([A.SelectItem(A.ColumnRef(c))
                          for c in fk["columns"]],
                         A.TableRef(child_name), cond, distinct=True)
        child_keys = [tuple(r) for r in cluster._execute_stmt(probe).rows]
        if not child_keys:
            continue
        for key in at_risk:
            if not any(len(ck) == len(key)
                       and all(a == b for a, b in zip(ck, key))
                       for ck in child_keys):
                continue
            if where is not None:
                # rows with this key the WHERE does not touch keep the
                # key present in the post-update parent; a NULL WHERE
                # result also leaves its row untouched, hence coalesce
                key_eq = None
                for c, v in zip(fk["ref_columns"], key):
                    from citus_tpu_torch.cluster import _pylit
                    this = A.BinOp("=", A.ColumnRef(c), _pylit(v))
                    key_eq = this if key_eq is None \
                        else A.BinOp("and", key_eq, this)
                untouched = A.UnOp("not", A.FuncCall(
                    "coalesce", (where, A.Literal(False, "bool"))))
                cnt = A.Select([A.SelectItem(
                    A.FuncCall("count", (A.Star(),)))],
                    A.TableRef(table_name),
                    A.BinOp("and", key_eq, untouched))
                if cluster._execute_stmt(cnt).rows[0][0]:
                    continue
            raise ForeignKeyViolation(
                f'update or delete on table "{table_name}" violates '
                f'foreign key constraint "{fk["name"]}" on table '
                f'"{child_name}"')


def check_child_update(cluster, table_meta, assignments: list) -> None:
    """UPDATE assigning FK columns: constant new values must exist in
    the parent; non-constant assignments to FK columns fail closed."""
    for fk in table_meta.foreign_keys:
        touched = [(c, e) for c, e in assignments if c in fk["columns"]]
        if not touched:
            continue
        for c, e in touched:
            if not isinstance(e, A.Literal):
                from citus_tpu_torch.errors import UnsupportedFeatureError
                raise UnsupportedFeatureError(
                    f'updating foreign key column "{c}" with a '
                    "non-constant expression is not supported")
        if len(touched) != len(fk["columns"]):
            from citus_tpu_torch.errors import UnsupportedFeatureError
            raise UnsupportedFeatureError(
                "partial updates of a multi-column foreign key are not "
                "supported")
        new = {c: e.value for c, e in touched}
        vals = [new[c] for c in fk["columns"]]
        if any(v is None for v in vals):
            continue
        types = [cluster.catalog.table(fk["ref_table"]).schema.column(rc).type
                 for rc in fk["ref_columns"]]
        want = tuple(_canon(tt, v) for tt, v in zip(types, vals))
        parent_keys = _parent_key_set(cluster, fk["ref_table"],
                                      fk["ref_columns"], [vals[0]])
        if want not in parent_keys:
            raise ForeignKeyViolation(
                f'insert or update on table "{table_meta.name}" violates '
                f'foreign key constraint "{fk["name"]}": Key '
                f'({", ".join(fk["columns"])})='
                f'({", ".join(map(str, vals))}) is not present in table '
                f'"{fk["ref_table"]}"')


def forbid_truncate_referenced(catalog, table_name: str,
                               also_truncated=()) -> None:
    """A referenced parent may only be truncated when every referencing
    table is truncated in the same statement (PostgreSQL: TRUNCATE p, c
    is allowed; TRUNCATE p alone is not)."""
    refs = [c for c, _fk in catalog.referencing_fks(table_name)
            if c != table_name and c not in also_truncated]
    if refs:
        raise AnalysisError(
            f'cannot truncate a table referenced in a foreign key '
            f'constraint: table "{refs[0]}" references "{table_name}"')


def forbid_drop_referenced(catalog, table_name: str) -> None:
    refs = [c for c, _fk in catalog.referencing_fks(table_name)
            if c != table_name]
    if refs:
        raise AnalysisError(
            f'cannot drop table "{table_name}" because other objects '
            f'depend on it: constraint on table "{refs[0]}"')


class CheckViolation(ExecutionError):
    """A row failed a CHECK constraint (PostgreSQL SQLSTATE 23514)."""


#: compiled CHECK predicates keyed (table, version, sql) — re-binding
#: every write batch would put parser+binder cost on the hot path;
#: version keys the cache so DDL invalidates naturally (bounded size)
_CHECK_FN_CACHE: dict = {}


def _compiled_check(cat, t, sql: str):
    import numpy as np

    from citus_tpu_torch.planner.bind import Binder
    from citus_tpu_torch.planner.bound import compile_expr
    from citus_tpu_torch.planner.parser import Parser
    key = (t.name, t.version, sql)
    fn = _CHECK_FN_CACHE.get(key)
    if fn is None:
        bound = Binder(cat, t).bind_scalar(Parser(sql).parse_expr())
        fn = compile_expr(bound, np)
        if len(_CHECK_FN_CACHE) > 512:
            _CHECK_FN_CACHE.clear()
        _CHECK_FN_CACHE[key] = fn
    return fn


def enforce_check_constraints(cat, t, values: dict, validity: dict) -> None:
    """Evaluate every CHECK constraint over a physical-encoded batch;
    a FALSE result rejects the batch (NULL results pass, per SQL).
    Reference: pg_constraint CHECK rows enforced by the executor."""
    if not t.check_constraints:
        return
    import numpy as np
    n = len(next(iter(values.values()))) if values else 0
    if n == 0:
        return
    env = {}
    for c, v in values.items():
        m = validity.get(c)
        env[c] = (np.asarray(v), True if m is None else np.asarray(m, bool))
    for ck in t.check_constraints:
        fn = _compiled_check(cat, t, ck["sql"])
        # predicate_mask applies SQL three-valued logic: NULL -> pass
        # would be wrong for WHERE (filters out) but CHECK passes NULL,
        # so evaluate validity explicitly: violation = (valid AND false)
        val, ok = fn(env)
        val = np.asarray(val, bool)
        if val.shape == ():
            val = np.full(n, bool(val))
        if ok is True:
            okm = np.ones(n, bool)
        elif ok is False:
            okm = np.zeros(n, bool)
        else:
            okm = np.asarray(ok, bool)
        bad = okm & ~val
        if bad.any():
            raise CheckViolation(
                f'new row for relation "{t.name}" violates check '
                f'constraint "{ck["name"]}" (CHECK ({ck["sql"]}))')
