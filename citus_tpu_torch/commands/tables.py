"""Table DDL handlers: CREATE TABLE [AS / PARTITION OF], DROP TABLE,
CREATE/DROP INDEX.

Reference: commands/table.c (4601 LoC) and commands/index.c dispatched
through DistributeObjectOps.  The port of ``citus_tpu/commands/
tables.py``: PRIMARY KEY / UNIQUE (implicit unique indexes), CHECK,
FOREIGN KEY, DEFAULT, serial columns and their owned sequences,
PARTITION BY RANGE / PARTITION OF, CREATE TABLE AS and CREATE / DROP
INDEX.  Enum and domain column types need CREATE TYPE / DOMAIN
(ROADMAP.md A14) and ALTER TABLE needs operations/alter_table.py
(ROADMAP.md A11): both raise UnsupportedFeatureError.
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
    cols = []
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
        if type_name in cl.catalog.types or type_name in cl.catalog.domains:
            raise UnsupportedFeatureError(
                "CREATE TABLE with enum or domain types is not ported yet "
                "(ROADMAP.md A14)")
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
    raise UnsupportedFeatureError(
        "ALTER TABLE is not ported yet (operations/alter_table.py, "
        "ROADMAP.md A11)")
