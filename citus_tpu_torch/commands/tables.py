"""Table DDL handlers: CREATE TABLE [AS / PARTITION OF], DROP TABLE,
CREATE/DROP INDEX.

Reference: commands/table.c (4601 LoC) and commands/index.c dispatched
through DistributeObjectOps.  The port of ``citus_tpu/commands/
tables.py``: PRIMARY KEY / UNIQUE (implicit unique indexes), CHECK,
FOREIGN KEY, DEFAULT, serial columns and their owned sequences,
PARTITION BY RANGE / PARTITION OF, CREATE TABLE AS and CREATE / DROP
INDEX, and ALTER TABLE (ADD / DROP / RENAME COLUMN, RENAME TO, ADD
CONSTRAINT … CHECK, DROP CONSTRAINT, ALTER COLUMN … SET DEFAULT),
cascaded from a partitioned parent to its partitions.  A column of an
enum type (CREATE TYPE … AS ENUM) is stored as text and recorded in
``catalog.enum_columns``; one of a domain takes the domain's base type
and is recorded in ``catalog.domain_columns``.
"""

from __future__ import annotations

from citus_tpu_torch.commands.registry import handles
from citus_tpu_torch.errors import (
    AnalysisError, CatalogError, UnsupportedFeatureError,
)
from citus_tpu_torch.executor import Result
from citus_tpu_torch.planner import ast as A
from citus_tpu_torch.schema import Column, Schema
from citus_tpu_torch.types import type_from_sql


@handles(A.CreateTableAs)
def create_table_as(cl, stmt):
    if cl.catalog.has_table(stmt.name):
        if stmt.if_not_exists:
            return Result(columns=[], rows=[])
        raise CatalogError(f'relation "{stmt.name}" already exists')
    from citus_tpu_torch.commands.select_exec import _schema_from_result
    r = cl._execute_stmt(stmt.select)
    names, types = _schema_from_result(cl, r, strict_empty=True)
    # atomic create+load: a load failure must not leave an empty
    # committed table behind (transparent inside a user txn)
    with cl._internal_txn():
        cl.create_table(stmt.name,
                        Schema([Column(cn, ct_)
                                for cn, ct_ in zip(names, types)]))
        if r.rows:
            cl.copy_from(stmt.name, rows=r.rows, column_names=names)
    return Result(columns=[], rows=[], explain={"selected": len(r.rows)})


@handles(A.CreateTable)
def create_table(cl, stmt):
    if stmt.partition_of is not None:
        cl._create_partition(
            stmt.name, stmt.partition_of["parent"],
            stmt.partition_of["lo"], stmt.partition_of["hi"],
            if_not_exists=stmt.if_not_exists)
        return Result(columns=[], rows=[])
    from citus_tpu_torch import types as T
    cols, enum_binds = [], []
    domain_binds = []
    serial_seqs = []  # sequences to create for serial columns
    _SERIAL = {"smallserial": "smallint", "serial": "int",
               "bigserial": "bigint"}
    for c in stmt.columns:
        default_sql = c.default_sql
        type_name = c.type_name
        if type_name in _SERIAL:
            # serial = integer + owned sequence + nextval default
            # (reference: commands/sequence.c ownership propagation)
            seq = f"{stmt.name}_{c.name}_seq"
            serial_seqs.append(seq)
            default_sql = f"nextval('{seq}')"
            type_name = _SERIAL[type_name]
        if type_name in cl.catalog.types:
            cols.append(Column(c.name, T.TEXT_T, c.not_null,
                               default_sql=default_sql))
            enum_binds.append((c.name, c.type_name))
        elif type_name in cl.catalog.domains:
            d = cl.catalog.domains[type_name]
            cols.append(Column(
                c.name,
                type_from_sql(d["base"], d["args"] or None),
                c.not_null or d["not_null"], default_sql=default_sql))
            domain_binds.append((c.name, type_name))
        else:
            cols.append(Column(
                c.name, type_from_sql(type_name, c.type_args or None),
                c.not_null, default_sql=default_sql))
    schema = Schema(cols)
    opts = {k: v for k, v in stmt.options.items() if k != "access_method"}
    fks = []
    pre_existing = cl.catalog.has_table(stmt.name)
    # pre-validate implicit PK/UNIQUE indexes and the partition clause
    # BEFORE the table commits: PostgreSQL's CREATE TABLE is
    # all-or-nothing
    want_indexes = []
    if not pre_existing:
        seen_ix: set = set()
        for c in stmt.columns:
            if not (c.primary_key or c.unique):
                continue
            iname = (f"{stmt.name}_pkey" if c.primary_key
                     else f"{stmt.name}_{c.name}_key")
            if iname in seen_ix or cl._find_index(iname)[1] is not None:
                raise CatalogError(f'index "{iname}" already exists')
            seen_ix.add(iname)
            if schema.column(c.name).type.is_float:
                raise UnsupportedFeatureError(
                    "UNIQUE indexes over floating-point columns "
                    "are not supported (no exact equality)")
            want_indexes.append((iname, c.name))
        if stmt.partition_by is not None:
            schema.column(stmt.partition_by)  # must exist
            # PostgreSQL: a unique constraint on a partitioned table
            # must include the partition column
            for _, cname in want_indexes:
                if cname != stmt.partition_by:
                    raise UnsupportedFeatureError(
                        "unique constraint on partitioned table "
                        "must include the partition column")
    if serial_seqs and not pre_existing:
        # a serial column's implicit sequence must not clobber a
        # pre-existing same-named sequence (PostgreSQL errors with
        # 'relation already exists'); the one exception is a leftover
        # OWNED by an earlier incarnation of this same table, which a
        # DROP TABLE crash could strand — that one restarts below.
        # Validated BEFORE the table commits: all-or-nothing.
        for seq in serial_seqs:
            existing = cl.catalog.sequences.get(seq)
            if existing is not None \
                    and existing.get("owner") != stmt.name:
                raise CatalogError(f'relation "{seq}" already exists')
    if stmt.checks and not pre_existing:
        # pre-validate CHECK expressions BEFORE the table commits
        # (CREATE TABLE is all-or-nothing, like the index/partition
        # validation above) — bound against a transient TableMeta
        from citus_tpu_torch.catalog.catalog import TableMeta as _TM
        from citus_tpu_torch.planner.bind import Binder
        from citus_tpu_torch.planner.parser import Parser
        probe = _TM(name=stmt.name, schema=schema)
        for sql in stmt.checks:
            bound = Binder(cl.catalog, probe).bind_scalar(
                Parser(sql).parse_expr())
            if bound.type.kind != "bool":
                raise AnalysisError(
                    f"CHECK constraint must be boolean: ({sql})")
    if stmt.foreign_keys and not pre_existing:
        from citus_tpu_torch.integrity import declare_fks
        fks = declare_fks(cl.catalog, stmt.name,
                          stmt.foreign_keys, schema=schema)
    cl.create_table(stmt.name, schema, if_not_exists=stmt.if_not_exists,
                    **opts)
    if fks and not pre_existing and cl.catalog.has_table(stmt.name):
        # IF NOT EXISTS no-op must not clobber existing constraints
        cl.catalog.table(stmt.name).foreign_keys = fks
        cl.catalog.commit()
    if enum_binds and cl.catalog.has_table(stmt.name):
        for cn, tn in enum_binds:
            cl.catalog.enum_columns[f"{stmt.name}.{cn}"] = tn
        cl.catalog.commit()
    if domain_binds and not pre_existing \
            and cl.catalog.has_table(stmt.name):
        for cn, dn in domain_binds:
            cl.catalog.domain_columns[f"{stmt.name}.{cn}"] = dn
        cl.catalog.commit()
    if want_indexes and cl.catalog.has_table(stmt.name):
        # PRIMARY KEY / UNIQUE column constraints become unique indexes
        # (PostgreSQL's implicit btree; pg_index rows) — pre-validated
        # above, so these cannot fail halfway
        for iname, cname in want_indexes:
            cl.create_index(iname, stmt.name, cname, unique=True)
    if stmt.partition_by is not None \
            and not pre_existing and cl.catalog.has_table(stmt.name):
        # validated before create_table above
        t0 = cl.catalog.table(stmt.name)
        t0.partition_by = {"column": stmt.partition_by, "kind": "range"}
        cl.catalog.commit()
    if stmt.checks and not pre_existing \
            and cl.catalog.has_table(stmt.name):
        t0 = cl.catalog.table(stmt.name)
        for i, sql in enumerate(stmt.checks):  # pre-validated above
            t0.check_constraints.append(
                {"name": f"{stmt.name}_check{i + 1}", "sql": sql})
        cl.catalog.commit()
    if serial_seqs and not pre_existing \
            and cl.catalog.has_table(stmt.name):
        # owned sequences exist only once the table does; a stale
        # same-owner sequence from an earlier incarnation restarts
        # (PostgreSQL drops owned sequences with their table) —
        # foreign sequences were rejected before the table committed
        for seq in serial_seqs:
            if seq in cl.catalog.sequences:
                cl.catalog.drop_sequence(seq)
            cl.catalog.create_sequence(seq, 1, 1)
            # ownership tag: lets the pre-validation above tell a
            # restartable leftover from somebody else's sequence
            cl.catalog.sequences[seq]["owner"] = stmt.name
        cl.catalog.commit()
    return Result(columns=[], rows=[])


@handles(A.DropTable)
def drop_table(cl, stmt):
    cl.drop_table(stmt.name, if_exists=stmt.if_exists)
    return Result(columns=[], rows=[])


@handles(A.CreateIndex)
def create_index(cl, stmt):
    return cl._execute_create_index(stmt)


@handles(A.DropIndex)
def drop_index(cl, stmt):
    return cl._execute_drop_index(stmt)


@handles(A.AlterTable)
def alter_table(cl, stmt):
    if cl.catalog.has_table(stmt.table) \
            and cl.catalog.table(stmt.table).is_partitioned:
        if stmt.action in ("rename_table", "rename_column"):
            raise UnsupportedFeatureError(
                "renaming a partitioned parent (or its columns) "
                "is not supported")
        if stmt.action == "drop_column" \
                and stmt.old_name == cl.catalog.table(
                    stmt.table).partition_by["column"]:
            raise CatalogError("cannot drop the partition column")
        # PostgreSQL: schema changes on the parent cascade to every
        # partition
        import dataclasses as _dc
        for p in cl.catalog.partitions_of(stmt.table):
            cl._execute_stmt(_dc.replace(stmt, table=p.name))
    if stmt.action == "drop_constraint":
        t0 = cl.catalog.table(stmt.table)
        kept = [c for c in t0.check_constraints
                if c["name"] != stmt.old_name]
        fks_kept = [f for f in t0.foreign_keys
                    if f.get("name") != stmt.old_name]
        if len(kept) == len(t0.check_constraints) \
                and len(fks_kept) == len(t0.foreign_keys):
            raise CatalogError(
                f'constraint "{stmt.old_name}" of relation '
                f'"{stmt.table}" does not exist')
        t0.check_constraints[:] = kept
        t0.foreign_keys[:] = fks_kept
        t0.version += 1
        cl.catalog.commit()
        cl._plan_cache.invalidate_table(stmt.table)
        return Result(columns=[], rows=[])
    if stmt.action == "set_default":
        import dataclasses as _dc
        t0 = cl.catalog.table(stmt.table)
        t0.schema.column(stmt.old_name)  # must exist
        if stmt.check_sql is not None:
            from citus_tpu_torch.planner.parser import Parser
            Parser(stmt.check_sql).parse_expr()  # must parse
        t0.schema.columns[:] = [
            _dc.replace(c, default_sql=stmt.check_sql or "")
            if c.name == stmt.old_name else c
            for c in t0.schema.columns]
        t0.version += 1
        cl.catalog.commit()
        return Result(columns=[], rows=[])
    if stmt.action == "add_check":
        from citus_tpu_torch.planner.bind import Binder
        from citus_tpu_torch.planner.parser import Parser
        from citus_tpu_torch.transaction.locks import EXCLUSIVE
        t0 = cl.catalog.table(stmt.table)
        bound = Binder(cl.catalog, t0).bind_scalar(
            Parser(stmt.check_sql).parse_expr())
        if bound.type.kind != "bool":
            raise AnalysisError(
                f"CHECK constraint must be boolean: ({stmt.check_sql})")
        # PostgreSQL validates existing rows at ADD time: any row where
        # the expression is FALSE (NULL passes) rejects the DDL.  The
        # validation scan and the catalog commit hold the colocation
        # group's EXCLUSIVE write lock as ONE critical section — a
        # writer landing between them could commit a violating row the
        # scan never saw (PostgreSQL holds AccessExclusiveLock across
        # ADD CONSTRAINT's validation for the same reason); reads are
        # snapshot-based and never block behind this lock
        with cl._write_lock(t0, EXCLUSIVE):
            t0 = cl.catalog.table(stmt.table)  # re-fetch under lock
            r = cl._execute_stmt(A.Select(
                [A.SelectItem(A.FuncCall("count", (A.Star(),)))],
                A.TableRef(stmt.table),
                A.UnOp("not", Parser(stmt.check_sql).parse_expr())))
            if r.rows and r.rows[0][0]:
                raise AnalysisError(
                    f'check constraint of relation "{stmt.table}" is '
                    f"violated by {r.rows[0][0]} existing row(s)")
            ck_name = stmt.new_name or \
                f"{stmt.table}_check{len(t0.check_constraints) + 1}"
            if any(c["name"] == ck_name for c in t0.check_constraints):
                raise CatalogError(
                    f'constraint "{ck_name}" already exists')
            t0.check_constraints.append({"name": ck_name,
                                         "sql": stmt.check_sql})
            cl.catalog.commit()
        cl._plan_cache.invalidate_table(stmt.table)
        return Result(columns=[], rows=[])
    if stmt.action == "add_column":
        from citus_tpu_torch import types as T
        tn = stmt.column.type_name
        if tn in cl.catalog.types:  # enum
            col = Column(stmt.column.name, T.TEXT_T,
                         stmt.column.not_null)
            cl.catalog.add_column(stmt.table, col)
            cl.catalog.enum_columns[
                f"{stmt.table}.{stmt.column.name}"] = tn
        elif tn in cl.catalog.domains:
            d = cl.catalog.domains[tn]
            col = Column(stmt.column.name,
                         type_from_sql(d["base"], d["args"] or None),
                         stmt.column.not_null or d["not_null"])
            cl.catalog.add_column(stmt.table, col)
            cl.catalog.domain_columns[
                f"{stmt.table}.{stmt.column.name}"] = tn
        else:
            col = Column(stmt.column.name,
                         type_from_sql(tn, stmt.column.type_args or None),
                         stmt.column.not_null)
            cl.catalog.add_column(stmt.table, col)
    elif stmt.action == "drop_column":
        t0 = cl.catalog.table(stmt.table)
        if t0.index_on(stmt.old_name) is not None:
            from citus_tpu_torch.storage.overlay import current_overlay
            txn0 = current_overlay()
            if txn0 is not None:
                # irreversible file removal: defer to COMMIT
                col0 = stmt.old_name
                tname0 = t0.name
                txn0.on_commit.append(
                    lambda: cl._drop_index_segments_if_unindexed(
                        tname0, col0))
            else:
                cl._drop_index_segments(t0, stmt.old_name)
            t0.indexes[:] = [ix for ix in t0.indexes
                             if ix["column"] != stmt.old_name]
        # PostgreSQL drops the table's own FK constraints that include
        # the column; a referenced parent column needs CASCADE
        # (unsupported here), so fail closed instead of leaving a stale
        # constraint behind.
        for child, fk in cl.catalog.referencing_fks(stmt.table):
            if child == stmt.table:
                continue  # self-FK belongs to this table: dropped
            if stmt.old_name in fk["ref_columns"]:
                raise AnalysisError(
                    f'cannot drop column "{stmt.old_name}" of '
                    f'table "{stmt.table}" because foreign key '
                    f'constraint "{fk["name"]}" on table '
                    f'"{child}" depends on it')
        t = cl.catalog.table(stmt.table)
        t.foreign_keys[:] = [
            fk for fk in t.foreign_keys
            if stmt.old_name not in fk["columns"]
            and not (fk["ref_table"] == stmt.table
                     and stmt.old_name in fk["ref_columns"])]
        key = f"{stmt.table}.{stmt.old_name}"
        if cl.catalog.domain_columns.pop(key, None) is not None:
            cl.catalog.tombstone("domain_columns", key)
        if cl.catalog.enum_columns.pop(key, None) is not None:
            cl.catalog.tombstone("enum_columns", key)
        # PostgreSQL auto-drops extended statistics with a column
        for sname in [n for n, st in cl.catalog.statistics.items()
                      if st["table"] == stmt.table
                      and stmt.old_name in st["columns"]]:
            del cl.catalog.statistics[sname]
            cl.catalog.tombstone("statistics", sname)
        cl.catalog.drop_column(stmt.table, stmt.old_name)
    elif stmt.action == "rename_column":
        t0 = cl.catalog.table(stmt.table)
        if t0.index_on(stmt.old_name) is not None:
            # segments are keyed by logical column name on disk: rename
            # them with the column
            import os as _os
            suffix = f".idx.{stmt.old_name}.npz"
            for shard in t0.shards:
                for node in shard.placements:
                    d = cl.catalog.shard_dir(
                        t0.name, shard.shard_id, node)
                    if not _os.path.isdir(d):
                        continue
                    for f in _os.listdir(d):
                        if f.endswith(suffix):
                            base = f[:-len(suffix)]
                            _os.replace(
                                _os.path.join(d, f),
                                _os.path.join(
                                    d, base + f".idx.{stmt.new_name}.npz"))
            for ix in t0.indexes:
                if ix["column"] == stmt.old_name:
                    ix["column"] = stmt.new_name
        cl.catalog.rename_column(stmt.table, stmt.old_name, stmt.new_name)
        # keep FK metadata consistent: this table's own key columns and
        # every child's referenced-column names
        for fk in cl.catalog.table(stmt.table).foreign_keys:
            fk["columns"] = [stmt.new_name if c == stmt.old_name
                             else c for c in fk["columns"]]
        for _child, fk in cl.catalog.referencing_fks(stmt.table):
            fk["ref_columns"] = [stmt.new_name if c == stmt.old_name
                                 else c for c in fk["ref_columns"]]
    elif stmt.action == "rename_table":
        from citus_tpu_torch.transaction.locks import EXCLUSIVE
        t = cl.catalog.table(stmt.table)
        with cl._write_lock(t, EXCLUSIVE):
            cl.catalog.rename_table(stmt.table, stmt.new_name)
        # repoint children's FK edges at the new name
        for other in cl.catalog.tables.values():
            for fk in other.foreign_keys:
                if fk["ref_table"] == stmt.table:
                    fk["ref_table"] = stmt.new_name
    else:
        raise UnsupportedFeatureError(
            f"ALTER TABLE {stmt.action} not supported")
    cl.catalog.commit()
    # rename included: entries under the old name drop naturally — the
    # old name no longer resolves to this TableMeta object
    cl._plan_cache.invalidate_table(stmt.table)
    return Result(columns=[], rows=[])
