"""SQL abstract syntax tree.

A deliberately small, typed AST — the stand-in for PostgreSQL's parse
tree that the reference receives from the postgres parser.  Desugaring
(BETWEEN, IN, NOT LIKE, avg->sum/count) happens in later phases, not here.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

# ---------------------------------------------------------------- exprs


class Expr:
    pass


@dataclass(frozen=True)
class ColumnRef(Expr):
    name: str
    table: Optional[str] = None  # qualified a.b

    def __str__(self):
        return f"{self.table}.{self.name}" if self.table else self.name


@dataclass(frozen=True)
class Literal(Expr):
    value: Any          # python int/float/Decimal/str/bool/None
    type_name: str = "" # inferred literal category: int/decimal/float/string/bool/null

    def __str__(self):
        if self.type_name == "string":
            return "'" + str(self.value).replace("'", "''") + "'"
        return str(self.value)


@dataclass(frozen=True)
class Star(Expr):
    def __str__(self):
        return "*"


@dataclass(frozen=True)
class BinOp(Expr):
    op: str  # + - * / % = <> < <= > >= and or
    left: Expr
    right: Expr

    def __str__(self):
        return f"({self.left} {self.op} {self.right})"


@dataclass(frozen=True)
class UnOp(Expr):
    op: str  # not, -
    operand: Expr

    def __str__(self):
        return f"({self.op} {self.operand})"


@dataclass(frozen=True)
class FuncCall(Expr):
    name: str
    args: tuple[Expr, ...] = ()
    distinct: bool = False
    # ordered-set / ordered aggregate: string_agg(x, ',' ORDER BY y DESC)
    agg_order: tuple = ()  # tuple[(Expr, asc: bool)]
    # agg(...) FILTER (WHERE cond) — desugared at bind time by wrapping
    # the value argument in CASE WHEN cond THEN arg END
    filter: Optional[Expr] = None

    def __str__(self):
        inner = ", ".join(str(a) for a in self.args)
        if self.distinct:
            inner = "distinct " + inner
        return f"{self.name}({inner})"


@dataclass(frozen=True)
class IntervalLiteral(Expr):
    """INTERVAL 'n' unit / INTERVAL '1 year 2 days' — PostgreSQL's
    months/days/microseconds decomposition."""
    months: int = 0
    days: int = 0
    micros: int = 0


@dataclass(frozen=True)
class Between(Expr):
    expr: Expr
    lo: Expr
    hi: Expr
    negated: bool = False


@dataclass(frozen=True)
class InList(Expr):
    expr: Expr
    items: tuple[Expr, ...]
    negated: bool = False


@dataclass(frozen=True)
class IsNull(Expr):
    expr: Expr
    negated: bool = False


@dataclass(frozen=True)
class Cast(Expr):
    expr: Expr
    type_name: str
    type_args: tuple[int, ...] = ()


@dataclass(frozen=True)
class CaseExpr(Expr):
    whens: tuple[tuple[Expr, Expr], ...]
    else_: Optional[Expr] = None


@dataclass(frozen=True)
class WindowCall(Expr):
    """fn(...) OVER (PARTITION BY ... ORDER BY ... [frame]) or
    fn(...) OVER name / OVER (name ...) referencing a WINDOW clause."""
    func: "FuncCall" = None
    partition_by: tuple = ()
    order_by: tuple = ()  # tuple[OrderItem-like (expr, asc)]
    # frame: (mode, (dir, n|None), (dir, n|None)) with mode rows|range,
    # dir in preceding|current|following, None = unbounded;
    # frame None = default (RANGE UNBOUNDED PRECEDING .. CURRENT ROW)
    frame: Optional[tuple] = None
    # named-window reference: OVER w (verbatim=True, uses w including
    # its frame) or OVER (w ...) (copy rules: partition from w, own
    # order only if w has none, own frame)
    ref_name: Optional[str] = None
    ref_verbatim: bool = False

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other


@dataclass(frozen=True)
class Param(Expr):
    """$N placeholder bound at execute time (prepared-statement analog)."""
    index: int  # 1-based


@dataclass(frozen=True)
class Exists(Expr):
    """EXISTS (SELECT ...) — executed ahead of the outer query via
    recursive planning (reference: recursive_planning.c handles EXISTS
    sublinks as subplans); LIMIT 1 semantics."""
    select: object  # A.Select | A.SetOp
    negated: bool = False

    def __hash__(self):
        return id(self.select)

    def __eq__(self, other):
        return self is other


@dataclass(frozen=True)
class Subquery(Expr):
    """Scalar subquery or IN-subquery source; executed ahead of the outer
    query as an intermediate result (reference: recursive planning,
    planner/recursive_planning.c + read_intermediate_result)."""
    select: object  # A.Select (unhashable field kept opaque)

    def __hash__(self):
        return id(self.select)

    def __eq__(self, other):
        return self is other


# ------------------------------------------------------------ statements


class Statement:
    pass


@dataclass
class ColumnDef:
    name: str
    type_name: str
    type_args: list[int] = field(default_factory=list)
    not_null: bool = False
    primary_key: bool = False   # implies not_null + unique index
    unique: bool = False        # column-level UNIQUE constraint
    default_sql: str = ""       # DEFAULT expression (SQL text)


@dataclass
class CreateSchema(Statement):
    name: str
    if_not_exists: bool = False


@dataclass
class DropSchema(Statement):
    name: str
    cascade: bool = False


@dataclass
class CreateTable(Statement):
    name: str
    columns: list[ColumnDef]
    if_not_exists: bool = False
    options: dict = field(default_factory=dict)  # USING/WITH columnar opts
    # foreign keys (column-level REFERENCES + table-level FOREIGN KEY):
    # [{"columns", "ref_table", "ref_columns", "on_delete"}]
    foreign_keys: list = field(default_factory=list)
    # PARTITION BY RANGE (col) -> the partition column name
    partition_by: "str | None" = None
    # CREATE TABLE x PARTITION OF parent FOR VALUES FROM (a) TO (b):
    # {"parent", "lo", "hi"} with raw literal values (None = MINVALUE/
    # MAXVALUE); physical conversion happens at DDL execution
    partition_of: "dict | None" = None
    # CHECK constraints (column- or table-level), SQL text each
    checks: list = field(default_factory=list)


@dataclass
class DropTable(Statement):
    name: str
    if_exists: bool = False


@dataclass
class CreateTableAs(Statement):
    """CREATE TABLE name AS SELECT ... — schema inferred from the
    result (planner types where known, value inference otherwise)."""
    name: str
    select: object = None   # Select | SetOp | WithSelect
    if_not_exists: bool = False


@dataclass
class CreateExtension(Statement):
    """Reference: commands/extension.c propagation."""
    name: str
    if_not_exists: bool = False
    version: "str | None" = None


@dataclass
class DropExtension(Statement):
    name: str
    if_exists: bool = False


@dataclass
class CreateDomain(Statement):
    """CREATE DOMAIN name AS type [NOT NULL] [CHECK (expr)].
    Reference: commands/domain.c propagation; VALUE refers to the
    checked value inside the CHECK expression."""
    name: str
    base: str
    type_args: list = field(default_factory=list)
    not_null: bool = False
    check_sql: "str | None" = None


@dataclass
class DropDomain(Statement):
    name: str
    if_exists: bool = False


@dataclass
class CreateCollation(Statement):
    """Reference: commands/collation.c propagation (metadata object)."""
    name: str
    options: dict = field(default_factory=dict)


@dataclass
class DropCollation(Statement):
    name: str
    if_exists: bool = False


@dataclass
class CreatePublication(Statement):
    """CREATE PUBLICATION name FOR TABLE t1, t2 | FOR ALL TABLES.
    Reference: commands/publication.c; gates the CDC stream."""
    name: str
    tables: "list | str" = "all"   # list of names, or "all"


@dataclass
class DropPublication(Statement):
    name: str
    if_exists: bool = False


@dataclass
class CreateStatistics(Statement):
    """CREATE STATISTICS name ON c1, c2 FROM t.
    Reference: commands/statistics.c propagation."""
    name: str
    columns: list = field(default_factory=list)
    table: str = ""


@dataclass
class DropStatistics(Statement):
    name: str
    if_exists: bool = False


@dataclass
class Prepare(Statement):
    """PREPARE name [(types)] AS statement — the stored unit is the
    statement's SQL text, so EXECUTE rides the text-keyed generic-plan
    cache (reference: prepared statements + Job->deferredPruning)."""
    name: str
    sql: str = ""


@dataclass
class ExecutePrepared(Statement):
    name: str
    args: list = field(default_factory=list)   # literal Exprs


@dataclass
class Deallocate(Statement):
    name: "str | None" = None   # None = ALL


@dataclass
class SetConfig(Statement):
    """SET [citus.]name = value | TO value — runtime settings (the GUC
    surface; reference: ~139 citus.* GUCs, shared_library_init.c)."""
    name: str
    value: object = None


@dataclass
class ShowConfig(Statement):
    """SHOW [citus.]name | SHOW ALL."""
    name: str = "all"


@dataclass
class Analyze(Statement):
    """ANALYZE [table]: refresh derived statistics (extended-statistics
    ndistinct; column bounds are always skip-list-live here).
    Reference: commands/vacuum.c ANALYZE propagation."""
    table: "str | None" = None


@dataclass
class VacuumAnalyze(Statement):
    table: str = ""
    full: bool = False


@dataclass
class Reindex(Statement):
    """REINDEX INDEX name | REINDEX TABLE name: rebuild segment files
    (reference: reindex propagated through commands/index.c)."""
    kind: str = "index"   # index | table
    name: str = ""


@dataclass
class CreateIndex(Statement):
    """CREATE [UNIQUE] INDEX name ON table (column).
    Reference: commands/index.c (DDL propagation) +
    columnar_tableam.c:1444 (index build over columnar)."""
    name: str
    table: str
    column: str
    unique: bool = False
    if_not_exists: bool = False


@dataclass
class DropIndex(Statement):
    name: str
    if_exists: bool = False


@dataclass(frozen=True)
class OnConflict:
    """INSERT ... ON CONFLICT (cols) DO NOTHING | DO UPDATE SET ...
    [WHERE ...].  Assignments/where may reference ``excluded.col``."""
    targets: tuple = ()        # conflict target column names
    action: str = "nothing"    # nothing | update
    assignments: tuple = ()    # tuple[(col, Expr)]
    where: Optional[Expr] = None


@dataclass
class Insert(Statement):
    table: str
    columns: Optional[list[str]]
    rows: list[list[Expr]]
    select: Optional["Select"] = None  # INSERT ... SELECT
    returning: Optional[list] = None   # [SelectItem] | None
    on_conflict: Optional[OnConflict] = None


@dataclass
class OrderItem:
    expr: Expr
    ascending: bool = True
    nulls_first: Optional[bool] = None


@dataclass
class TableRef:
    name: str
    alias: Optional[str] = None


@dataclass
class SubqueryRef:
    """Derived table: FROM (SELECT ...) alias — materialized as an
    intermediate result before the outer query runs (reference:
    recursive planning of subqueries in FROM,
    recursive_planning.c RecursivelyPlanSubqueryWalker)."""
    select: object  # Select | SetOp
    alias: str


@dataclass
class FunctionRef:
    """Set-returning function in FROM: generate_series(a, b [, step]).
    Materialized like a derived table (reference: SRFs run through the
    standard executor; here the recursive-planning temp-table seam)."""
    name: str
    args: tuple = ()
    alias: Optional[str] = None


@dataclass
class Join:
    left: "FromItem"
    right: "FromItem"
    kind: str            # inner, left, right, full, cross
    condition: Optional[Expr] = None


FromItem = "TableRef | Join"


@dataclass(frozen=True)
class GroupingSetsSpec(Expr):
    """GROUP BY ROLLUP(...)/CUBE(...)/GROUPING SETS(...) — expands to a
    union of per-set grouped executions with NULL padding (reference:
    PostgreSQL executes these natively; recursive composition here)."""
    sets: tuple = ()  # tuple[tuple[Expr, ...]]


@dataclass
class SelectItem:
    expr: Expr
    alias: Optional[str] = None


@dataclass
class WithSelect(Statement):
    """WITH [RECURSIVE] name AS (SELECT ...) [, ...] SELECT ... — each
    CTE materializes as an intermediate result (reference: cte_inline.c
    / recursive_planning.c materialization path; recursive CTEs iterate
    coordinator-side like recursive_planning.c:1175's supported case)."""
    ctes: list = field(default_factory=list)  # [(name, Select)]
    body: "Select" = None
    recursive: bool = False
    # name -> explicit column alias list (WITH r(n) AS ...)
    cte_cols: dict = field(default_factory=dict)


@dataclass
class Select(Statement):
    items: list[SelectItem]
    from_: Optional[object] = None   # TableRef | Join | None
    where: Optional[Expr] = None
    group_by: list[Expr] = field(default_factory=list)
    having: Optional[Expr] = None
    order_by: list[OrderItem] = field(default_factory=list)
    limit: Optional[int] = None
    offset: Optional[int] = None
    distinct: bool = False
    # WINDOW name AS (spec) declarations: tuple[(name, WindowCall-spec)]
    # (the spec is a WindowCall with func=None)
    windows: tuple = ()
    # SELECT DISTINCT ON (expr, ...): keep the first row per key in
    # ORDER BY order (PostgreSQL extension)
    distinct_on: tuple = ()


@dataclass
class CreateView(Statement):
    """CREATE VIEW name AS SELECT ... — stored as SQL text in the
    catalog (reference: views propagate as distributed objects,
    commands/view.c); references expand like derived tables."""
    name: str = ""
    select: object = None       # parsed body (validation only)
    sql: str = ""               # body text, reparsed at each use
    or_replace: bool = False


@dataclass
class DropView(Statement):
    name: str = ""
    if_exists: bool = False


@dataclass
class CreateSequence(Statement):
    """Reference: commands/sequence.c — distributed sequences hand out
    disjoint ranges; here a catalog-backed counter with block caching."""
    name: str = ""
    start: int = 1
    increment: int = 1
    if_not_exists: bool = False


@dataclass
class DropSequence(Statement):
    name: str = ""
    if_exists: bool = False


@dataclass
class CreateFunction(Statement):
    """CREATE FUNCTION name(a type, ...) RETURNS type AS 'expr'
    LANGUAGE SQL — an expression macro inlined at planning time, the
    analog of distributed functions executing next to the data
    (commands/function.c + function_call_delegation.c)."""
    name: str = ""
    arg_names: list = field(default_factory=list)
    arg_types: list = field(default_factory=list)   # sql type names
    returns: str = ""
    body: str = ""                                  # expression SQL text
    or_replace: bool = False


@dataclass
class DropFunction(Statement):
    name: str = ""
    if_exists: bool = False


@dataclass
class CreatePolicy(Statement):
    """CREATE POLICY name ON table [FOR cmd] [TO roles] [USING (expr)]
    [WITH CHECK (expr)] — row-level security (reference:
    commands/policy.c propagation; enforcement here is engine-native)."""
    name: str = ""
    table: str = ""
    cmd: str = "all"            # all | select | insert | update | delete
    roles: tuple = ("public",)
    using_sql: Optional[str] = None
    check_sql: Optional[str] = None


@dataclass
class DropPolicy(Statement):
    name: str = ""
    table: str = ""
    if_exists: bool = False


@dataclass
class AlterTableRls(Statement):
    """ALTER TABLE t ENABLE|DISABLE ROW LEVEL SECURITY."""
    table: str = ""
    enable: bool = True


@dataclass
class CreateTrigger(Statement):
    """CREATE TRIGGER name AFTER event ON table [FOR EACH STATEMENT]
    EXECUTE FUNCTION f() — statement-level AFTER triggers running a
    stored SQL-statement function (reference: commands/trigger.c
    propagates triggers; row-level procedural bodies are PL/pgSQL and
    out of scope)."""
    name: str = ""
    event: str = "insert"       # insert | update | delete
    table: str = ""
    function: str = ""


@dataclass
class DropTrigger(Statement):
    name: str = ""
    table: str = ""
    if_exists: bool = False


@dataclass
class CreateTsConfig(Statement):
    """CREATE TEXT SEARCH CONFIGURATION name (PARSER = p | COPY = c) —
    propagated catalog objects (reference: commands/text_search.c; FTS
    execution itself is the host database's concern in the reference,
    so these are metadata-only here too)."""
    name: str = ""
    options: dict = field(default_factory=dict)


@dataclass
class DropTsConfig(Statement):
    name: str = ""
    if_exists: bool = False


@dataclass
class CreateType(Statement):
    """CREATE TYPE name AS ENUM (...) — enum columns store the label's
    declaration index; labels validate at ingest (reference: types
    propagate as distributed objects, commands/type.c)."""
    name: str = ""
    labels: list = field(default_factory=list)


@dataclass
class DropType(Statement):
    name: str = ""
    if_exists: bool = False


@dataclass
class CreateRole(Statement):
    """Reference: roles propagate as distributed objects
    (commands/role.c); here a catalog-registered principal."""
    name: str = ""
    if_not_exists: bool = False


@dataclass
class DropRole(Statement):
    name: str = ""
    if_exists: bool = False


@dataclass
class Grant(Statement):
    """GRANT/REVOKE privileges ON table TO/FROM role (commands/grant.c)."""
    privileges: list = field(default_factory=list)  # select/insert/update/delete or ["all"]
    table: str = ""
    role: str = ""
    revoke: bool = False


@dataclass
class SetOp(Statement):
    """UNION / INTERSECT / EXCEPT [ALL] over two selects (or nested set
    operations).  Trailing ORDER BY / LIMIT / OFFSET bind to the whole
    operation, as in PostgreSQL.  Reference: set operations route through
    recursive planning when they cannot be pushed down
    (recursive_planning.c:223)."""
    op: str = "union"          # union | intersect | except
    all: bool = False
    left: object = None        # Select | SetOp
    right: object = None       # Select | SetOp
    order_by: list = field(default_factory=list)   # [OrderItem]
    limit: Optional[int] = None
    offset: Optional[int] = None


@dataclass
class AlterTable(Statement):
    table: str
    action: str   # add_column | drop_column | rename_column | rename_table
                  # | add_check
    column: Optional[ColumnDef] = None
    old_name: Optional[str] = None
    new_name: Optional[str] = None
    check_sql: Optional[str] = None  # ADD [CONSTRAINT n] CHECK (expr)


@dataclass
class CopyFrom(Statement):
    table: str
    path: str
    options: dict = field(default_factory=dict)


@dataclass
class CopyTo(Statement):
    table: str
    path: str
    options: dict = field(default_factory=dict)


@dataclass
class CopyQueryTo(Statement):
    """COPY (SELECT ...) TO 'path' — query-result export."""
    select: object = None
    path: str = ""
    options: dict = field(default_factory=dict)


@dataclass
class Delete(Statement):
    table: str
    where: Optional[Expr] = None
    returning: Optional[list] = None   # [SelectItem] | None


@dataclass
class Update(Statement):
    table: str
    assignments: list[tuple[str, Expr]] = field(default_factory=list)
    where: Optional[Expr] = None
    returning: Optional[list] = None   # [SelectItem] | None


@dataclass
class Truncate(Statement):
    table: str
    # TRUNCATE a, b, c — additional tables beyond the first
    more: tuple = ()


@dataclass
class TransactionStmt(Statement):
    """BEGIN / COMMIT / ROLLBACK / SAVEPOINT family (reference:
    transaction/transaction_management.c wraps exactly these)."""

    kind: str  # begin | commit | rollback | savepoint | rollback_to | release
    name: Optional[str] = None  # savepoint name


@dataclass
class Vacuum(Statement):
    table: str
    full: bool = False


@dataclass
class MergeWhen:
    matched: bool
    action: str                       # update | delete | insert | nothing
    condition: Optional[Expr] = None  # AND <cond> on the WHEN clause
    assignments: list = field(default_factory=list)   # update
    insert_columns: Optional[list] = None             # insert
    insert_values: list = field(default_factory=list) # insert


@dataclass
class Merge(Statement):
    target: "TableRef" = None
    source: "TableRef" = None
    on: Expr = None
    whens: list = field(default_factory=list)


@dataclass
class UtilityCall(Statement):
    """SELECT create_distributed_table('t', 'col') style UDF utilities —
    the reference exposes its control plane as SQL-callable UDFs
    (src/backend/distributed/sql/udfs/)."""

    name: str
    args: list[Any]


@dataclass
class Explain(Statement):
    statement: Statement
    analyze: bool = False
