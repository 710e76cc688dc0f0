"""SQL tokenizer + recursive-descent parser.

Covers the analytical subset the engine executes: CREATE/DROP TABLE,
INSERT ... VALUES / INSERT ... SELECT, SELECT with joins, WHERE, GROUP BY,
HAVING, ORDER BY, LIMIT/OFFSET, EXPLAIN [ANALYZE], and the UDF-style
utility calls the reference exposes (create_distributed_table, ...).
The reference delegates parsing to PostgreSQL; we own it, so the grammar
is intentionally a strict, unambiguous subset.
"""

from __future__ import annotations

import dataclasses
import decimal
import re
from dataclasses import dataclass
from typing import Optional

from citus_tpu_torch.errors import SqlSyntaxError, UnsupportedFeatureError
from citus_tpu_torch.planner import ast_nodes as A

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+|--[^\n]*)
  | (?P<num>\d+\.\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?|\d+[eE][+-]?\d+|\d+)
  | (?P<str>'(?:[^']|'')*')
  | (?P<ident>[A-Za-z_][A-Za-z_0-9$]*)
  | (?P<param>\$\d+)
  | (?P<op><=|>=|<>|!=|::|=|<|>|\+|-|\*|/|%|\(|\)|\[|\]|,|;|\.)
    """,
    re.VERBOSE,
)

KEYWORDS = {
    "select", "from", "where", "group", "by", "having", "order", "limit",
    "offset", "as", "and", "or", "not", "in", "between", "is", "null",
    "true", "false", "create", "drop", "table", "if", "exists", "insert",
    "into", "values", "distinct", "asc", "desc", "nulls", "first", "last",
    "join", "inner", "left", "right", "full", "outer", "cross", "on",
    "case", "when", "then", "else", "end", "cast", "explain", "analyze",
    "using", "with", "like", "ilike", "delete", "update", "set", "truncate",
    "vacuum", "copy", "alter", "add", "column", "rename", "to",
    "schema", "cascade", "merge", "matched", "nothing", "do", "over",
    "partition", "union", "intersect", "except", "all", "within",
    "rows", "range", "unbounded", "preceding", "following", "current", "row",
    "grant", "revoke", "returning", "window",
}


@dataclass
class Token:
    kind: str  # num | str | ident | kw | op | eof
    value: str
    pos: int


def tokenize(text: str) -> list[Token]:
    out, pos = [], 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if not m:
            raise SqlSyntaxError(f"unexpected character {text[pos]!r}", pos, text)
        pos = m.end()
        if m.lastgroup == "ws":
            continue
        kind, value = m.lastgroup, m.group()
        if kind == "ident":
            low = value.lower()
            if low in KEYWORDS:
                out.append(Token("kw", low, m.start()))
            else:
                out.append(Token("ident", low, m.start()))
        else:
            out.append(Token(kind, value, m.start()))
    out.append(Token("eof", "", len(text)))
    return out


class Parser:
    def __init__(self, text: str):
        self.text = text
        self.toks = tokenize(text)
        self.i = 0

    # ---- token helpers -------------------------------------------------
    def peek(self, offset: int = 0) -> Token:
        return self.toks[min(self.i + offset, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.i]
        if t.kind != "eof":
            self.i += 1
        return t

    def at_kw(self, *kws: str) -> bool:
        t = self.peek()
        return t.kind == "kw" and t.value in kws

    def at_op(self, *ops: str) -> bool:
        t = self.peek()
        return t.kind == "op" and t.value in ops

    def accept_kw(self, *kws: str) -> Optional[Token]:
        if self.at_kw(*kws):
            return self.next()
        return None

    def accept_op(self, *ops: str) -> Optional[Token]:
        if self.at_op(*ops):
            return self.next()
        return None

    def expect_kw(self, kw: str) -> Token:
        if not self.at_kw(kw):
            self.error(f"expected {kw.upper()}")
        return self.next()

    def expect_op(self, op: str) -> Token:
        if not self.at_op(op):
            self.error(f"expected {op!r}")
        return self.next()

    def expect_ident(self) -> str:
        t = self.peek()
        if t.kind != "ident":
            self.error("expected identifier")
        self.next()
        return t.value

    def error(self, msg: str):
        t = self.peek()
        got = t.value or "end of input"
        raise SqlSyntaxError(f"{msg}, got {got!r}", t.pos, self.text)

    # ---- statements ----------------------------------------------------
    def _try_parse_transaction_stmt(self) -> "Optional[A.Statement]":
        """BEGIN/START TRANSACTION, COMMIT/END, ROLLBACK/ABORT,
        SAVEPOINT, ROLLBACK TO [SAVEPOINT], RELEASE [SAVEPOINT]
        (PostgreSQL spellings; reference wraps these in
        transaction_management.c:319)."""
        t = self.peek()
        word = t.value.lower() if t.kind in ("ident", "kw") else None

        def _eat_work_transaction():
            n = self.peek()
            if n.kind == "ident" and n.value.lower() in ("work", "transaction"):
                self.next()

        if word in ("begin", "start"):
            self.next()
            if word == "start":
                n = self.peek()
                if not (n.kind == "ident"
                        and n.value.lower() == "transaction"):
                    self.error("expected TRANSACTION after START")
                self.next()
            else:
                _eat_work_transaction()
            return A.TransactionStmt("begin")
        if word in ("commit", "end"):
            self.next()
            _eat_work_transaction()
            return A.TransactionStmt("commit")
        if word in ("rollback", "abort"):
            self.next()
            if word == "rollback" and self.accept_kw("to"):
                n = self.peek()
                if n.kind == "ident" and n.value.lower() == "savepoint":
                    self.next()
                return A.TransactionStmt("rollback_to", self.expect_ident())
            _eat_work_transaction()
            return A.TransactionStmt("rollback")
        if word == "savepoint":
            self.next()
            return A.TransactionStmt("savepoint", self.expect_ident())
        if word == "release":
            self.next()
            n = self.peek()
            if n.kind == "ident" and n.value.lower() == "savepoint":
                self.next()
            return A.TransactionStmt("release", self.expect_ident())
        return None

    def parse_statements(self) -> list[A.Statement]:
        stmts = []
        while self.peek().kind != "eof":
            stmts.append(self.parse_statement())
            while self.accept_op(";"):
                pass
        return stmts

    def parse_statement(self) -> A.Statement:
        ts = self._try_parse_transaction_stmt()
        if ts is not None:
            return ts
        if self.at_kw("explain"):
            return self.parse_explain()
        if self.at_kw("with"):
            return self.parse_with_select()
        if self.at_kw("select"):
            return self.parse_select_or_utility()
        if self.at_kw("create"):
            return self.parse_create_table()
        if self.at_kw("drop"):
            return self.parse_drop_table()
        if self.at_kw("insert"):
            return self.parse_insert()
        if self.at_kw("delete"):
            self.next()
            self.expect_kw("from")
            name = self.parse_table_name()
            where = self.parse_expr() if self.accept_kw("where") else None
            return A.Delete(name, where, self._parse_returning())
        if self.at_kw("update"):
            self.next()
            name = self.parse_table_name()
            self.expect_kw("set")
            assignments = []
            while True:
                col = self.expect_ident()
                self.expect_op("=")
                assignments.append((col, self.parse_expr()))
                if not self.accept_op(","):
                    break
            where = self.parse_expr() if self.accept_kw("where") else None
            return A.Update(name, assignments, where,
                            self._parse_returning())
        if self.at_kw("truncate"):
            self.next()
            self.accept_kw("table")
            names = [self.parse_table_name()]
            while self.accept_op(","):
                names.append(self.parse_table_name())
            return A.Truncate(names[0], tuple(names[1:]))
        if self.at_kw("alter"):
            return self.parse_alter_table()
        if self.at_kw("merge"):
            return self.parse_merge()
        if self.at_kw("copy"):
            self.next()
            if self.at_op("("):
                # COPY (query) TO 'path' — export a query result
                self.next()
                sub: A.Statement = self.parse_with_select() \
                    if self.at_kw("with") else self.parse_select()
                self.expect_op(")")
                self.expect_kw("to")
                path, options = self._parse_copy_path_and_options()
                return A.CopyQueryTo(sub, path, options)
            name = self.parse_table_name()
            to = False
            if self.accept_kw("to"):
                to = True
            else:
                self.expect_kw("from")
            path, options = self._parse_copy_path_and_options()
            return (A.CopyTo if to else A.CopyFrom)(name, path, options)
        if self.peek().kind == "ident" and self.peek().value == "prepare":
            self.next()
            name = self.expect_ident()
            if self.accept_op("("):  # optional parameter-type list
                while True:
                    self.parse_type_name()
                    if not self.accept_op(","):
                        break
                self.expect_op(")")
            self.expect_kw("as")
            start = self.peek().pos
            body = self.parse_statement()  # validate + consume
            if isinstance(body, (A.Prepare, A.ExecutePrepared,
                                 A.Deallocate, A.TransactionStmt)):
                self.error("PREPARE body must be a plannable statement")
            sql = self.text[start:self.peek().pos].strip().rstrip(";")
            return A.Prepare(name, sql)
        if self.peek().kind == "ident" and self.peek().value == "execute" \
                and self.peek(1).kind == "ident":
            self.next()
            name = self.expect_ident()
            args = []
            if self.accept_op("("):
                while True:
                    args.append(self.parse_expr())
                    if not self.accept_op(","):
                        break
                self.expect_op(")")
            return A.ExecutePrepared(name, args)
        if self.peek().kind == "ident" and self.peek().value == "deallocate":
            self.next()
            if self.peek().kind == "ident" and self.peek().value == "prepare":
                self.next()
            if self.at_kw("all"):
                self.next()
                return A.Deallocate(None)
            return A.Deallocate(self.expect_ident())
        if self.peek().value == "set" and self.peek().kind in ("kw", "ident"):
            self.next()
            name = self.expect_ident()
            if self.accept_op("."):
                name = f"{name}.{self.expect_ident()}"
            if not (self.accept_op("=") or self.accept_kw("to")):
                self.error("expected = or TO after SET name")
            t = self.next()
            # SET citus.log_min_duration_ms = -1 (negative sentinel)
            if t.kind == "op" and t.value == "-" and self.peek().kind == "num":
                t = self.next()
                n = float(t.value) \
                    if ("." in t.value or "e" in t.value.lower()) \
                    else int(t.value)
                return A.SetConfig(name, -n)
            if t.kind == "str":
                value: object = t.value[1:-1].replace("''", "'")
            elif t.kind == "num":
                value = float(t.value) \
                    if ("." in t.value or "e" in t.value.lower()) \
                    else int(t.value)
            elif t.value in ("true", "false", "on", "off"):
                value = t.value in ("true", "on")
            else:
                value = t.value
            return A.SetConfig(name, value)
        if self.peek().kind == "ident" and self.peek().value == "show":
            self.next()
            if self.at_kw("all"):
                self.next()
                return A.ShowConfig("all")
            name = self.expect_ident()
            if self.accept_op("."):
                name = f"{name}.{self.expect_ident()}"
            return A.ShowConfig(name)
        if self.at_kw("vacuum"):
            self.next()
            # "full" lexes as a keyword (FULL OUTER JOIN)
            full = bool(self.peek().value == "full" and self.next())
            if self.accept_kw("analyze"):
                name = self.parse_table_name()
                return A.VacuumAnalyze(name, full)
            return A.Vacuum(self.parse_table_name(), full)
        if self.at_kw("analyze"):
            self.next()
            name = self.parse_table_name() if self.peek().kind in (
                "ident",) else None
            return A.Analyze(name)
        if self.peek().kind == "ident" and self.peek().value == "reindex":
            self.next()
            t = self.peek()
            if t.kind in ("ident", "kw") and t.value in ("index", "table"):
                self.next()
                kind = t.value
            else:
                self.error("expected INDEX or TABLE after REINDEX")
            return A.Reindex(kind, self.parse_table_name())
        if self.at_kw("grant", "revoke"):
            revoke = self.next().value == "revoke"
            privs = []
            if self.at_kw("all"):
                self.next()
                if self.peek().kind == "ident" and self.peek().value == "privileges":
                    self.next()
                privs = ["all"]
            else:
                while True:
                    t = self.next()
                    name = t.value
                    if name not in ("select", "insert", "update", "delete",
                                    "truncate"):
                        self.error("expected a privilege name")
                    privs.append(name)
                    if not self.accept_op(","):
                        break
            self.expect_kw("on")
            self.accept_kw("table")
            table = self.parse_table_name()
            if revoke:
                self.expect_kw("from")
            else:
                self.expect_kw("to")
            role = self.expect_ident()
            return A.Grant(privs, table, role, revoke)
        self.error("expected a statement")

    def parse_with_select(self) -> A.WithSelect:
        self.expect_kw("with")
        recursive = False
        if self.peek().kind == "ident" and self.peek().value == "recursive":
            self.next()
            recursive = True
        ctes = []
        cte_cols: dict = {}
        while True:
            name = self.expect_ident()
            if self.at_op("("):
                self.next()
                cols = [self.expect_ident()]
                while self.accept_op(","):
                    cols.append(self.expect_ident())
                self.expect_op(")")
                cte_cols[name] = cols
            self.expect_kw("as")
            self.expect_op("(")
            ctes.append((name, self.parse_select()))
            self.expect_op(")")
            if not self.accept_op(","):
                break
        body = self.parse_select()
        return A.WithSelect(ctes, body, recursive, cte_cols)

    def parse_merge(self) -> A.Merge:
        self.expect_kw("merge")
        self.expect_kw("into")
        target = self.parse_table_ref()
        self.expect_kw("using")
        source = self.parse_table_ref()
        self.expect_kw("on")
        on = self.parse_expr()
        whens = []
        while self.at_kw("when"):
            self.next()
            matched = True
            if self.accept_kw("not"):
                self.expect_kw("matched")
                matched = False
            else:
                self.expect_kw("matched")
            cond = None
            if self.accept_kw("and"):
                cond = self.parse_expr()
            self.expect_kw("then")
            if self.accept_kw("update"):
                self.expect_kw("set")
                assignments = []
                while True:
                    col = self.expect_ident()
                    self.expect_op("=")
                    assignments.append((col, self.parse_expr()))
                    if not self.accept_op(","):
                        break
                whens.append(A.MergeWhen(matched, "update", cond, assignments))
            elif self.accept_kw("delete"):
                whens.append(A.MergeWhen(matched, "delete", cond))
            elif self.accept_kw("insert"):
                cols = None
                if self.at_op("("):
                    self.next()
                    cols = []
                    while True:
                        cols.append(self.expect_ident())
                        if not self.accept_op(","):
                            break
                    self.expect_op(")")
                self.expect_kw("values")
                self.expect_op("(")
                vals = []
                while True:
                    vals.append(self.parse_expr())
                    if not self.accept_op(","):
                        break
                self.expect_op(")")
                whens.append(A.MergeWhen(matched, "insert", cond,
                                         insert_columns=cols, insert_values=vals))
            elif self.accept_kw("do"):
                self.expect_kw("nothing")
                whens.append(A.MergeWhen(matched, "nothing", cond))
            else:
                self.error("expected UPDATE, DELETE, INSERT, or DO NOTHING")
        if not whens:
            self.error("MERGE requires at least one WHEN clause")
        return A.Merge(target, source, on, whens)

    def parse_alter_table(self) -> A.AlterTable:
        self.expect_kw("alter")
        self.expect_kw("table")
        name = self.parse_table_name()
        if self.accept_kw("add"):
            # ADD [CONSTRAINT name] CHECK (expr)
            if self.peek().kind == "ident" \
                    and self.peek().value in ("constraint", "check"):
                ck_name = None
                if self.peek().value == "constraint":
                    self.next()
                    ck_name = self.expect_ident()
                if not (self.peek().kind == "ident"
                        and self.peek().value == "check"):
                    self.error("expected CHECK")
                self.next()
                return A.AlterTable(name, "add_check",
                                    check_sql=self._parse_paren_expr_text(),
                                    new_name=ck_name)
            self.accept_kw("column")
            cname = self.expect_ident()
            tname, targs = self.parse_type_name()
            not_null = False
            if self.accept_kw("not"):
                self.expect_kw("null")
                not_null = True
            return A.AlterTable(name, "add_column",
                                column=A.ColumnDef(cname, tname, targs, not_null))
        if self.accept_kw("drop"):
            if self.peek().kind == "ident" \
                    and self.peek().value == "constraint":
                self.next()
                return A.AlterTable(name, "drop_constraint",
                                    old_name=self.expect_ident())
            self.accept_kw("column")
            return A.AlterTable(name, "drop_column", old_name=self.expect_ident())
        if self.accept_kw("rename"):
            if self.accept_kw("column"):
                old = self.expect_ident()
                self.expect_kw("to")
                return A.AlterTable(name, "rename_column", old_name=old,
                                    new_name=self.expect_ident())
            if self.accept_kw("to"):
                return A.AlterTable(name, "rename_table",
                                    new_name=self.expect_ident())
            old = self.expect_ident()
            self.expect_kw("to")
            return A.AlterTable(name, "rename_column", old_name=old,
                                new_name=self.expect_ident())
        if self.accept_kw("alter"):
            # ALTER COLUMN c SET DEFAULT expr / DROP DEFAULT
            self.accept_kw("column")
            cname = self.expect_ident()
            if self.accept_kw("set"):
                if not (self.peek().kind == "ident"
                        and self.peek().value == "default"):
                    self.error("expected DEFAULT")
                self.next()
                start = self.peek().pos
                self.parse_additive()
                end = self.peek().pos if self.peek().kind != "eof" \
                    else len(self.text)
                return A.AlterTable(name, "set_default", old_name=cname,
                                    check_sql=self.text[start:end].strip())
            if self.accept_kw("drop"):
                if not (self.peek().kind == "ident"
                        and self.peek().value == "default"):
                    self.error("expected DEFAULT")
                self.next()
                return A.AlterTable(name, "set_default", old_name=cname,
                                    check_sql=None)
            self.error("expected SET DEFAULT or DROP DEFAULT")
        if self.peek().kind == "ident" \
                and self.peek().value in ("enable", "disable"):
            enable = self.next().value == "enable"
            for word, kinds in (("row", ("kw", "ident")),
                                ("level", ("ident",)),
                                ("security", ("ident",))):
                t = self.peek()
                if not (t.kind in kinds and t.value == word):
                    self.error("expected ROW LEVEL SECURITY")
                self.next()
            return A.AlterTableRls(name, enable)
        self.error("expected ADD, DROP, RENAME, or ENABLE/DISABLE ROW "
                   "LEVEL SECURITY")

    def parse_explain(self) -> A.Explain:
        self.expect_kw("explain")
        analyze = bool(self.accept_kw("analyze"))
        return A.Explain(self.parse_statement(), analyze=analyze)

    def _maybe_grouping_sets(self):
        """ROLLUP(e...) | CUBE(e...) | GROUPING SETS((..), (..), e) as the
        whole GROUP BY clause -> GroupingSetsSpec, else None."""
        t = self.peek()
        if t.kind != "ident" or t.value not in ("rollup", "cube", "grouping"):
            return None
        kind = self.next().value
        if kind == "grouping":
            if not (self.peek().kind == "ident" and self.peek().value == "sets"):
                self.error("expected SETS after GROUPING")
            self.next()
            self.expect_op("(")
            sets = []
            while True:
                if self.accept_op("("):
                    exprs = []
                    if not self.at_op(")"):
                        while True:
                            exprs.append(self.parse_expr())
                            if not self.accept_op(","):
                                break
                    self.expect_op(")")
                    sets.append(tuple(exprs))
                else:
                    sets.append((self.parse_expr(),))
                if not self.accept_op(","):
                    break
            self.expect_op(")")
            return A.GroupingSetsSpec(tuple(sets))
        self.expect_op("(")
        exprs = []
        while True:
            exprs.append(self.parse_expr())
            if not self.accept_op(","):
                break
        self.expect_op(")")
        if kind == "rollup":
            sets = [tuple(exprs[:i]) for i in range(len(exprs), -1, -1)]
        else:  # cube
            if len(exprs) > 5:
                self.error("CUBE supports at most 5 expressions")
            from itertools import combinations
            sets = []
            for r in range(len(exprs), -1, -1):
                for combo in combinations(range(len(exprs)), r):
                    sets.append(tuple(exprs[i] for i in combo))
        return A.GroupingSetsSpec(tuple(sets))

    def _parse_window_spec(self):
        """'(' [base_window_name] [PARTITION BY ...] [ORDER BY ...]
        [ROWS|RANGE frame] ')' -> (partition tuple, order tuple,
        frame|None, base_name|None)."""
        self.expect_op("(")
        base = None
        if self.peek().kind == "ident" and not self.at_op(")"):
            base = self.expect_ident()
        part, order = [], []
        if self.accept_kw("partition"):
            self.expect_kw("by")
            while True:
                part.append(self.parse_expr())
                if not self.accept_op(","):
                    break
        if self.accept_kw("order"):
            self.expect_kw("by")
            while True:
                e_ = self.parse_expr()
                asc = True
                if self.accept_kw("asc"):
                    pass
                elif self.accept_kw("desc"):
                    asc = False
                order.append((e_, asc))
                if not self.accept_op(","):
                    break
        frame = None
        if self.at_kw("rows", "range"):
            mode = self.next().value
            if self.accept_kw("between"):
                start = self._parse_frame_bound()
                self.expect_kw("and")
                end = self._parse_frame_bound()
            else:
                # shorthand: frame start only, end = CURRENT ROW
                start = self._parse_frame_bound()
                end = ("current", 0)
            frame = (mode, start, end)
        self.expect_op(")")
        return tuple(part), tuple(order), frame, base

    def _parse_frame_bound(self):
        """UNBOUNDED PRECEDING|FOLLOWING | CURRENT ROW | N PRECEDING|
        FOLLOWING -> ('preceding'|'following', n|None) with None =
        unbounded, or ('current', 0)."""
        if self.accept_kw("unbounded"):
            d = self.next().value
            if d not in ("preceding", "following"):
                self.error("expected PRECEDING or FOLLOWING")
            return (d, None)
        if self.accept_kw("current"):
            self.expect_kw("row")
            return ("current", 0)
        t = self.next()
        if t.kind != "num":
            self.error("expected a frame bound")
        d = self.next().value
        if d not in ("preceding", "following"):
            self.error("expected PRECEDING or FOLLOWING")
        return (d, int(t.value))

    def _parse_paren_expr_text(self) -> str:
        """'(' expr ')' -> the expression's source text (validated by
        parsing, persisted as SQL so it survives the catalog)."""
        self.expect_op("(")
        start = self.peek().pos
        self.parse_expr()
        end = self.peek().pos   # position of the closing ')'
        self.expect_op(")")
        return self.text[start:end].strip()

    def parse_table_name(self) -> str:
        name = self.expect_ident()
        if self.accept_op("."):
            return f"{name}.{self.expect_ident()}"
        return name

    # -- CREATE TABLE t (col type [not null], ...) [using columnar] [with (...)]
    def parse_create_table(self):
        self.expect_kw("create")
        if self.accept_kw("schema"):
            if_not_exists = False
            if self.accept_kw("if"):
                self.expect_kw("not")
                self.expect_kw("exists")
                if_not_exists = True
            return A.CreateSchema(self.expect_ident(), if_not_exists)
        if self.peek().kind == "ident" and self.peek().value in ("role", "user"):
            self.next()
            if_not_exists = False
            if self.accept_kw("if"):
                self.expect_kw("not")
                self.expect_kw("exists")
                if_not_exists = True
            return A.CreateRole(self.expect_ident(), if_not_exists)
        if self.peek().kind == "ident" and self.peek().value == "extension":
            self.next()
            ine = self._accept_if_not_exists()
            name = self.expect_ident()
            version = None
            if self.peek().kind == "ident" and self.peek().value == "version":
                self.next()
                vt = self.next()
                version = vt.value.strip("'")
            return A.CreateExtension(name, ine, version)
        if self.peek().kind == "ident" and self.peek().value == "domain":
            self.next()
            name = self.expect_ident()
            self.expect_kw("as")
            base, targs = self.parse_type_name()
            not_null = False
            check_sql = None
            while True:
                if self.accept_kw("not"):
                    self.expect_kw("null")
                    not_null = True
                    continue
                if self.peek().kind == "ident" and self.peek().value == "check":
                    self.next()
                    check_sql = self._parse_paren_expr_text()
                    continue
                break
            return A.CreateDomain(name, base, targs, not_null, check_sql)
        if self.peek().kind == "ident" and self.peek().value == "collation":
            self.next()
            name = self.expect_ident()
            options: dict = {}
            if self.accept_op("("):
                while True:
                    key = self.next().value
                    self.expect_op("=")
                    options[key] = self.next().value.strip("'")
                    if not self.accept_op(","):
                        break
                self.expect_op(")")
            return A.CreateCollation(name, options)
        if self.peek().kind == "ident" and self.peek().value == "publication":
            self.next()
            name = self.expect_ident()
            # no FOR clause = EMPTY publication (PostgreSQL semantics),
            # not FOR ALL TABLES
            tables: "list | str" = []
            if self.peek().value == "for":
                self.next()
                if self.peek().value == "all":
                    self.next()
                    if self.peek().value != "tables":
                        self.error("expected TABLES")
                    self.next()
                    tables = "all"
                else:
                    self.expect_kw("table")
                    tables = [self.parse_table_name()]
                    while self.accept_op(","):
                        tables.append(self.parse_table_name())
            return A.CreatePublication(name, tables)
        if self.peek().kind == "ident" and self.peek().value == "statistics":
            self.next()
            name = self.expect_ident()
            self.expect_kw("on")
            cols = [self.expect_ident()]
            while self.accept_op(","):
                cols.append(self.expect_ident())
            self.expect_kw("from")
            return A.CreateStatistics(name, cols, self.parse_table_name())
        if self.peek().kind == "ident" and self.peek().value in ("unique",
                                                                 "index"):
            unique = self.next().value == "unique"
            if unique:
                if not (self.peek().kind == "ident"
                        and self.peek().value == "index"):
                    self.error("expected INDEX after UNIQUE")
                self.next()
            if_not_exists = False
            if self.accept_kw("if"):
                self.expect_kw("not")
                self.expect_kw("exists")
                if_not_exists = True
            name = self.expect_ident()
            self.expect_kw("on")
            table = self.parse_table_name()
            self.expect_op("(")
            column = self.expect_ident()
            if self.accept_op(","):
                self.error("multi-column indexes are not supported")
            self.expect_op(")")
            return A.CreateIndex(name, table, column, unique, if_not_exists)
        or_replace = False
        if self.peek().kind == "kw" and self.peek().value == "or":
            # CREATE OR REPLACE FUNCTION
            self.next()
            if not (self.peek().kind == "ident" and self.peek().value == "replace"):
                self.error("expected REPLACE")
            self.next()
            or_replace = True
        if self.peek().kind == "ident" and self.peek().value == "function":
            self.next()
            name = self.expect_ident()
            self.expect_op("(")
            arg_names, arg_types = [], []
            if not self.at_op(")"):
                while True:
                    arg_names.append(self.expect_ident())
                    tn, targs = self.parse_type_name()
                    arg_types.append(tn)
                    if not self.accept_op(","):
                        break
            self.expect_op(")")
            if not (self.peek().kind == "ident" and self.peek().value == "returns"):
                self.error("expected RETURNS")
            self.next()
            ret, _ = self.parse_type_name()
            self.expect_kw("as")
            bt = self.next()
            if bt.kind != "str":
                self.error("expected a quoted function body")
            body = bt.value[1:-1].replace("''", "'")
            if self.peek().kind == "ident" and self.peek().value == "language":
                self.next()
                self.next()  # sql
            return A.CreateFunction(name, arg_names, arg_types, ret, body,
                                    or_replace)
        if or_replace and not (self.peek().kind == "ident"
                               and self.peek().value == "view"):
            self.error("expected FUNCTION or VIEW after OR REPLACE")
        if self.peek().kind == "ident" and self.peek().value == "type":
            self.next()
            name = self.expect_ident()
            self.expect_kw("as")
            if not (self.peek().kind == "ident" and self.peek().value == "enum"):
                self.error("only CREATE TYPE ... AS ENUM is supported")
            self.next()
            self.expect_op("(")
            labels = []
            while True:
                lt = self.next()
                if lt.kind != "str":
                    self.error("expected a quoted enum label")
                labels.append(lt.value[1:-1].replace("''", "'"))
                if not self.accept_op(","):
                    break
            self.expect_op(")")
            return A.CreateType(name, labels)
        if self.peek().kind == "ident" and self.peek().value == "policy":
            self.next()
            name = self.expect_ident()
            self.expect_kw("on")
            table = self.parse_table_name()
            cmd = "all"
            if self.peek().kind == "ident" and self.peek().value == "for":
                self.next()
                t = self.next()
                if t.value not in ("all", "select", "insert", "update",
                                   "delete"):
                    self.error("expected ALL/SELECT/INSERT/UPDATE/DELETE")
                cmd = t.value
            roles: tuple = ("public",)
            if self.accept_kw("to"):
                rs = [self.expect_ident()]
                while self.accept_op(","):
                    rs.append(self.expect_ident())
                roles = tuple(rs)
            using_sql = check_sql = None
            if self.accept_kw("using"):
                using_sql = self._parse_paren_expr_text()
            if self.accept_kw("with"):
                if not (self.peek().kind == "ident"
                        and self.peek().value == "check"):
                    self.error("expected CHECK")
                self.next()
                check_sql = self._parse_paren_expr_text()
            return A.CreatePolicy(name, table, cmd, roles, using_sql,
                                  check_sql)
        if self.peek().kind == "ident" and self.peek().value == "trigger":
            self.next()
            name = self.expect_ident()
            if not (self.peek().kind == "ident"
                    and self.peek().value == "after"):
                self.error("only AFTER triggers are supported")
            self.next()
            evt = self.next()
            if evt.value not in ("insert", "update", "delete"):
                self.error("expected INSERT, UPDATE, or DELETE")
            self.expect_kw("on")
            table = self.parse_table_name()
            if self.peek().kind == "ident" and self.peek().value == "for":
                self.next()
                if self.peek().kind == "ident" and self.peek().value == "each":
                    self.next()
                t = self.next()
                if t.value != "statement":
                    self.error("only FOR EACH STATEMENT triggers are "
                               "supported")
            if not (self.peek().kind == "ident"
                    and self.peek().value == "execute"):
                self.error("expected EXECUTE FUNCTION")
            self.next()
            if self.peek().kind == "ident" \
                    and self.peek().value in ("function", "procedure"):
                self.next()
            fname = self.expect_ident()
            self.expect_op("(")
            self.expect_op(")")
            return A.CreateTrigger(name, evt.value, table, fname)
        if self.peek().kind == "ident" and self.peek().value == "text":
            self.next()
            for word in ("search", "configuration"):
                if not (self.peek().kind == "ident"
                        and self.peek().value == word):
                    self.error(f"expected {word.upper()}")
                self.next()
            name = self.expect_ident()
            options: dict = {}
            if self.accept_op("("):
                while True:
                    key = self.next().value
                    self.expect_op("=")
                    options[key] = self.next().value.strip("'")
                    if not self.accept_op(","):
                        break
                self.expect_op(")")
            return A.CreateTsConfig(name, options)
        if self.peek().kind == "ident" and self.peek().value == "view":
            self.next()
            name = self.parse_table_name()
            self.expect_kw("as")
            body_start = self.peek().pos
            sel = self.parse_with_select() if self.at_kw("with") \
                else self.parse_select()
            return A.CreateView(name, sel,
                                self.text[body_start:self.peek().pos].strip(),
                                or_replace)
        if self.peek().kind == "ident" and self.peek().value == "sequence":
            self.next()
            if_not_exists = False
            if self.accept_kw("if"):
                self.expect_kw("not")
                self.expect_kw("exists")
                if_not_exists = True
            name = self.parse_table_name()
            start, increment = 1, 1
            while self.peek().kind == "ident" and self.peek().value in ("start", "increment"):
                kw = self.next().value
                self.accept_kw("with") or (self.peek().kind == "ident"
                                           and self.peek().value == "by" and self.next())
                neg = bool(self.accept_op("-"))
                t = self.next()
                if t.kind != "num":
                    self.error("expected a number")
                v = -int(t.value) if neg else int(t.value)
                if kw == "start":
                    start = v
                else:
                    increment = v
            return A.CreateSequence(name, start, increment, if_not_exists)
        self.expect_kw("table")
        if_not_exists = False
        if self.accept_kw("if"):
            self.expect_kw("not") if self.at_kw("not") else self.error("expected NOT")
            self.expect_kw("exists")
            if_not_exists = True
        name = self.parse_table_name()
        if self.accept_kw("partition"):
            # CREATE TABLE x PARTITION OF parent FOR VALUES FROM (a) TO (b)
            if not (self.peek().kind == "ident" and self.peek().value == "of"):
                self.error("expected OF")
            self.next()
            parent = self.parse_table_name()
            lo = hi = None
            if self.peek().value == "for":
                self.next()
                if self.peek().value != "values":
                    self.error("expected VALUES")
                self.next()
                self.expect_kw("from")
                self.expect_op("(")
                lo = self._parse_partition_bound()
                self.expect_op(")")
                self.expect_kw("to")
                self.expect_op("(")
                hi = self._parse_partition_bound()
                self.expect_op(")")
            else:
                self.error("expected FOR VALUES FROM (..) TO (..)")
            return A.CreateTable(name, [], if_not_exists,
                                 partition_of={"parent": parent,
                                               "lo": lo, "hi": hi})
        if self.at_kw("as"):
            # CREATE TABLE x AS SELECT ... (CTAS)
            self.next()
            if self.at_kw("with"):
                sel: A.Statement = self.parse_with_select()
            else:
                sel = self.parse_select()
            return A.CreateTableAs(name, sel, if_not_exists)
        self.expect_op("(")
        cols = []
        fkeys = []
        table_pk: list = []
        table_unique: list = []
        table_checks: list = []
        while True:
            if self.peek().kind == "ident" and self.peek().value == "foreign":
                # table constraint: FOREIGN KEY (cols) REFERENCES t (cols)
                self.next()
                if not (self.peek().kind == "ident"
                        and self.peek().value == "key"):
                    self.error("expected KEY")
                self.next()
                self.expect_op("(")
                fcols = [self.expect_ident()]
                while self.accept_op(","):
                    fcols.append(self.expect_ident())
                self.expect_op(")")
                fkeys.append(self._parse_references(fcols))
                if not self.accept_op(","):
                    break
                continue
            if self.peek().kind == "ident" \
                    and self.peek().value == "check" \
                    and self.peek(1).kind == "op" \
                    and self.peek(1).value == "(":
                # table constraint: CHECK (expr)
                self.next()
                table_checks.append(self._parse_paren_expr_text())
                if not self.accept_op(","):
                    break
                continue
            if self.peek().kind == "ident" \
                    and self.peek().value in ("primary", "unique") \
                    and self.peek(1).kind in ("ident", "op") \
                    and (self.peek(1).value == "key"
                         or self.peek(1).value == "("):
                # table constraint: PRIMARY KEY (cols) / UNIQUE (cols)
                is_pk = self.next().value == "primary"
                if is_pk:
                    if not (self.peek().kind == "ident"
                            and self.peek().value == "key"):
                        self.error("expected KEY after PRIMARY")
                    self.next()
                self.expect_op("(")
                kcols = [self.expect_ident()]
                while self.accept_op(","):
                    kcols.append(self.expect_ident())
                self.expect_op(")")
                if len(kcols) > 1:
                    self.error("multi-column PRIMARY KEY/UNIQUE "
                               "constraints are not supported")
                (table_pk if is_pk else table_unique).append(kcols[0])
                if not self.accept_op(","):
                    break
                continue
            cname = self.expect_ident()
            tname, targs = self.parse_type_name()
            not_null = False
            primary_key = False
            unique = False
            default_sql = ""
            while True:
                if self.peek().kind == "ident" \
                        and self.peek().value == "check" \
                        and self.peek(1).kind == "op" \
                        and self.peek(1).value == "(":
                    self.next()
                    table_checks.append(self._parse_paren_expr_text())
                    continue
                if self.peek().kind == "ident" \
                        and self.peek().value == "default":
                    self.next()
                    start = self.peek().pos
                    self.parse_additive()  # validate the expression
                    end = self.peek().pos if self.peek().kind != "eof" \
                        else len(self.text)
                    default_sql = self.text[start:end].strip()
                    continue
                if self.accept_kw("not"):
                    self.expect_kw("null")
                    not_null = True
                    continue
                if self.peek().kind == "ident" \
                        and self.peek().value == "primary":
                    self.next()
                    if not (self.peek().kind == "ident"
                            and self.peek().value == "key"):
                        self.error("expected KEY after PRIMARY")
                    self.next()
                    primary_key = True
                    not_null = True
                    continue
                if self.peek().kind == "ident" \
                        and self.peek().value == "unique":
                    self.next()
                    unique = True
                    continue
                if self.peek().kind == "ident" \
                        and self.peek().value == "references":
                    fkeys.append(self._parse_references([cname]))
                    continue
                break
            cols.append(A.ColumnDef(cname, tname, targs, not_null,
                                    primary_key, unique, default_sql))
            if not self.accept_op(","):
                break
        self.expect_op(")")
        if table_pk or table_unique:
            # table-level single-column constraints fold onto the column
            import dataclasses as _dc
            by_name = {c.name: i for i, c in enumerate(cols)}
            for cn in table_pk:
                i = by_name.get(cn)
                if i is None:
                    self.error(f"PRIMARY KEY column {cn!r} not defined")
                cols[i] = _dc.replace(cols[i], primary_key=True,
                                      not_null=True)
            for cn in table_unique:
                i = by_name.get(cn)
                if i is None:
                    self.error(f"UNIQUE column {cn!r} not defined")
                cols[i] = _dc.replace(cols[i], unique=True)
        options: dict = {}
        partition_by = None
        if self.accept_kw("partition"):
            self.expect_kw("by")
            # "range" lexes as a keyword (window frames use it)
            if self.peek().value != "range":
                self.error("only PARTITION BY RANGE is supported")
            self.next()
            self.expect_op("(")
            partition_by = self.expect_ident()
            self.expect_op(")")
        if self.accept_kw("using"):
            options["access_method"] = self.expect_ident()
        if self.accept_kw("with"):
            self.expect_op("(")
            while True:
                key = self.expect_ident()
                self.expect_op("=")
                t = self.next()
                options[key] = t.value.strip("'")
                if not self.accept_op(","):
                    break
            self.expect_op(")")
        return A.CreateTable(name, cols, if_not_exists, options, fkeys,
                             partition_by=partition_by,
                             checks=table_checks)

    def _parse_copy_path_and_options(self):
        """'path' [WITH (opt [value], ...)] — shared by every COPY form."""
        t = self.next()
        if t.kind != "str":
            self.error("expected a quoted file path after COPY")
        path = t.value[1:-1].replace("''", "'")
        options: dict = {}
        if self.accept_kw("with"):
            self.expect_op("(")
            while True:
                key = self.expect_ident() \
                    if self.peek().kind == "ident" else self.next().value
                if self.at_op(")") or self.at_op(","):
                    options[key] = True
                else:
                    v = self.next()
                    options[key] = v.value.strip("'")
                if not self.accept_op(","):
                    break
            self.expect_op(")")
        return path, options

    def _accept_if_not_exists(self) -> bool:
        if self.accept_kw("if"):
            self.expect_kw("not")
            self.expect_kw("exists")
            return True
        return False

    def _parse_partition_bound(self):
        """One FOR VALUES bound: literal, MINVALUE, or MAXVALUE (both
        map to None = unbounded)."""
        t = self.peek()
        if t.kind == "ident" and t.value in ("minvalue", "maxvalue"):
            self.next()
            return None
        neg = bool(self.accept_op("-"))
        t = self.next()
        if t.kind == "num":
            v = float(t.value) if "." in t.value else int(t.value)
            return -v if neg else v
        if t.kind == "str":
            return t.value[1:-1].replace("''", "'")
        self.error("expected a partition bound literal")

    def _parse_references(self, fcols: list[str]) -> dict:
        """REFERENCES tbl [(cols)] [ON DELETE CASCADE|RESTRICT|SET NULL|
        NO ACTION] — the referenced columns default to the referenced
        table's distribution column (resolved at DDL time)."""
        if not (self.peek().kind == "ident"
                and self.peek().value == "references"):
            self.error("expected REFERENCES")
        self.next()
        ref_table = self.parse_table_name()
        ref_cols: list[str] = []
        if self.accept_op("("):
            ref_cols.append(self.expect_ident())
            while self.accept_op(","):
                ref_cols.append(self.expect_ident())
            self.expect_op(")")
        on_delete = "restrict"
        if self.accept_kw("on"):
            self.expect_kw("delete")
            if self.accept_kw("cascade"):
                on_delete = "cascade"
            elif self.accept_kw("set"):
                self.expect_kw("null")
                on_delete = "set null"
            elif self.peek().kind == "ident" \
                    and self.peek().value in ("restrict", "no"):
                if self.next().value == "no":
                    if not (self.peek().kind == "ident"
                            and self.peek().value == "action"):
                        self.error("expected ACTION")
                    self.next()
            else:
                self.error("expected CASCADE, RESTRICT, SET NULL or "
                           "NO ACTION")
        return {"columns": list(fcols), "ref_table": ref_table,
                "ref_columns": ref_cols, "on_delete": on_delete}

    def parse_type_name(self) -> tuple[str, list[int]]:
        t = self.peek()
        if t.kind not in ("ident", "kw"):
            self.error("expected type name")
        self.next()
        name = t.value
        # two-word types: double precision, character varying,
        # timestamp with[out] time zone
        if name == "double" and self.peek().kind == "ident" and self.peek().value == "precision":
            self.next()
        elif name == "character":
            if self.peek().kind == "ident" and self.peek().value == "varying":
                self.next()
            name = "varchar"
        elif name == "timestamp" and self.peek().kind in ("ident", "kw") \
                and self.peek().value in ("with", "without"):
            with_tz = self.next().value == "with"
            if not (self.peek().value == "time"
                    and self.peek(1).value == "zone"):
                self.error("expected TIME ZONE after WITH/WITHOUT")
            self.next()
            self.next()
            if with_tz:
                name = "timestamptz"
        args: list[int] = []
        if self.at_op("("):
            self.next()
            while True:
                nt = self.next()
                if nt.kind != "num":
                    self.error("expected number in type args")
                args.append(int(nt.value))
                if not self.accept_op(","):
                    break
            self.expect_op(")")
        if self.at_op("[") :
            # 1-D array type: elem[]
            self.next()
            self.expect_op("]")
            name = name + "[]"
        return name, args

    def parse_drop_table(self):
        self.expect_kw("drop")
        if self.accept_kw("schema"):
            name = self.expect_ident()
            cascade = bool(self.accept_kw("cascade"))
            return A.DropSchema(name, cascade)
        if self.peek().kind == "ident" and self.peek().value in ("role", "user"):
            self.next()
            if_exists = False
            if self.accept_kw("if"):
                self.expect_kw("exists")
                if_exists = True
            return A.DropRole(self.expect_ident(), if_exists)
        if self.peek().kind == "ident" and self.peek().value == "function":
            self.next()
            if_exists = False
            if self.accept_kw("if"):
                self.expect_kw("exists")
                if_exists = True
            return A.DropFunction(self.expect_ident(), if_exists)
        if self.peek().kind == "ident" and self.peek().value == "type":
            self.next()
            if_exists = False
            if self.accept_kw("if"):
                self.expect_kw("exists")
                if_exists = True
            return A.DropType(self.expect_ident(), if_exists)
        if self.peek().kind == "ident" and self.peek().value == "policy":
            self.next()
            if_exists = False
            if self.accept_kw("if"):
                self.expect_kw("exists")
                if_exists = True
            name = self.expect_ident()
            self.expect_kw("on")
            return A.DropPolicy(name, self.parse_table_name(), if_exists)
        if self.peek().kind == "ident" and self.peek().value == "trigger":
            self.next()
            if_exists = False
            if self.accept_kw("if"):
                self.expect_kw("exists")
                if_exists = True
            name = self.expect_ident()
            self.expect_kw("on")
            return A.DropTrigger(name, self.parse_table_name(), if_exists)
        if self.peek().kind == "ident" and self.peek().value == "text":
            self.next()
            for word in ("search", "configuration"):
                if not (self.peek().kind == "ident"
                        and self.peek().value == word):
                    self.error(f"expected {word.upper()}")
                self.next()
            if_exists = False
            if self.accept_kw("if"):
                self.expect_kw("exists")
                if_exists = True
            return A.DropTsConfig(self.expect_ident(), if_exists)
        if self.peek().kind == "ident" and self.peek().value == "index":
            self.next()
            if_exists = False
            if self.accept_kw("if"):
                self.expect_kw("exists")
                if_exists = True
            return A.DropIndex(self.expect_ident(), if_exists)
        if self.peek().kind == "ident" and self.peek().value in (
                "extension", "domain", "collation", "publication",
                "statistics"):
            kind = self.next().value
            if_exists = False
            if self.accept_kw("if"):
                self.expect_kw("exists")
                if_exists = True
            node = {"extension": A.DropExtension, "domain": A.DropDomain,
                    "collation": A.DropCollation,
                    "publication": A.DropPublication,
                    "statistics": A.DropStatistics}[kind]
            return node(self.expect_ident(), if_exists)
        if self.peek().kind == "ident" and self.peek().value in ("view", "sequence"):
            kind = self.next().value
            if_exists = False
            if self.accept_kw("if"):
                self.expect_kw("exists")
                if_exists = True
            name = self.parse_table_name()
            return (A.DropView if kind == "view" else A.DropSequence)(name, if_exists)
        self.expect_kw("table")
        if_exists = False
        if self.accept_kw("if"):
            self.expect_kw("exists")
            if_exists = True
        return A.DropTable(self.parse_table_name(), if_exists)

    def parse_insert(self) -> A.Insert:
        self.expect_kw("insert")
        self.expect_kw("into")
        name = self.parse_table_name()
        cols = None
        if self.at_op("("):
            self.next()
            cols = []
            while True:
                cols.append(self.expect_ident())
                if not self.accept_op(","):
                    break
            self.expect_op(")")
        if self.at_kw("select"):
            sel = self.parse_select()
            return A.Insert(name, cols, [], select=sel,
                            on_conflict=self._parse_on_conflict(),
                            returning=self._parse_returning())
        if self.peek().kind == "ident" \
                and self.peek().value == "default" \
                and self.peek(1).kind == "kw" \
                and self.peek(1).value == "values":
            # INSERT INTO t DEFAULT VALUES: one row, all defaults
            self.next()
            self.next()
            return A.Insert(name, [], [[]],
                            on_conflict=self._parse_on_conflict(),
                            returning=self._parse_returning())
        self.expect_kw("values")
        rows = []
        while True:
            self.expect_op("(")
            row = []
            while True:
                row.append(self.parse_expr())
                if not self.accept_op(","):
                    break
            self.expect_op(")")
            rows.append(row)
            if not self.accept_op(","):
                break
        return A.Insert(name, cols, rows,
                        on_conflict=self._parse_on_conflict(),
                        returning=self._parse_returning())

    def _parse_on_conflict(self):
        """ON CONFLICT [(col, ...)] DO NOTHING | DO UPDATE SET col =
        expr [, ...] [WHERE cond] — expressions may reference
        ``excluded.col`` (the proposed row, as in PostgreSQL)."""
        save = self.i
        if not self.accept_kw("on"):
            return None
        if not (self.peek().kind == "ident" and self.peek().value == "conflict"):
            self.i = save
            return None
        self.next()
        targets = []
        if self.accept_op("("):
            while True:
                targets.append(self.expect_ident())
                if not self.accept_op(","):
                    break
            self.expect_op(")")
        self.expect_kw("do")
        if self.accept_kw("nothing"):
            return A.OnConflict(tuple(targets), "nothing")
        self.expect_kw("update")
        self.expect_kw("set")
        assignments = []
        while True:
            col = self.expect_ident()
            self.expect_op("=")
            assignments.append((col, self.parse_expr()))
            if not self.accept_op(","):
                break
        where = self.parse_expr() if self.accept_kw("where") else None
        return A.OnConflict(tuple(targets), "update", tuple(assignments),
                            where)

    def _parse_returning(self):
        """RETURNING expr [AS alias] [, ...] on INSERT/UPDATE/DELETE —
        reference: RETURNING support in the adaptive executor's DML path
        (distributed/executor/adaptive_executor.c returns tuples from
        worker DML)."""
        if not self.accept_kw("returning"):
            return None
        items = []
        while True:
            if self.at_op("*"):
                self.next()
                items.append(A.SelectItem(A.Star()))
            else:
                e = self.parse_expr()
                alias = None
                if self.accept_kw("as"):
                    alias = self.expect_ident()
                elif self.peek().kind == "ident":
                    alias = self.expect_ident()
                items.append(A.SelectItem(e, alias))
            if not self.accept_op(","):
                break
        return items

    # -- SELECT ----------------------------------------------------------
    _UTILITY_FNS = {
        "create_distributed_table", "create_reference_table",
        "undistribute_table", "citus_add_node", "citus_remove_node",
        "citus_set_coordinator_host", "rebalance_table_shards",
        "get_rebalance_table_shards_plan", "citus_rebalance_start",
        "citus_job_wait", "citus_cleanup_orphaned_resources",
        "citus_move_shard_placement", "citus_copy_shard_placement",
        "citus_table_size", "citus_shard_sizes",
        "master_get_active_worker_nodes",
        "citus_stat_counters", "citus_stat_counters_reset",
        "citus_stat_statements", "citus_stat_statements_reset",
        "citus_metrics", "citus_slow_queries", "citus_slow_queries_reset",
        "citus_cluster_metrics", "citus_cluster_slow_queries",
        "citus_stat_activity", "citus_locks", "citus_lock_waits",
        "citus_shards", "citus_tables", "recover_prepared_transactions",
        "nextval", "currval", "setval", "citus_views", "citus_sequences",
        "citus_cdc_events", "citus_roles", "citus_grants",
        "citus_version", "citus_dist_stat_activity", "citus_types",
        "citus_policies", "citus_triggers", "citus_text_search_configs",
        "get_shard_id_for_distribution_column", "citus_relation_size",
        "citus_total_relation_size", "citus_disable_node",
        "citus_activate_node", "citus_get_active_worker_nodes",
        "citus_get_node_clock", "citus_get_transaction_clock",
        "citus_create_restore_point", "citus_list_restore_points",
        "alter_distributed_table", "citus_check_cluster_node_health",
        "citus_stat_tenants", "get_rebalance_progress", "citus_schemas",
        "citus_split_shard_by_split_points", "isolate_tenant_to_new_shard",
        "citus_schema_tenant_set", "citus_schema_tenant_unset",
        "run_command_on_workers", "run_command_on_shards",
        "run_command_on_placements", "master_get_table_ddl_events",
        "citus_backend_gpid", "citus_coordinator_nodeid",
        "create_time_partitions", "drop_old_time_partitions",
        "time_partitions", "citus_stat_pool", "citus_megabatch_stats",
        "citus_shard_move_stats", "citus_remote_stats",
        "citus_add_tenant_quota", "citus_remove_tenant_quota",
        "citus_tenant_quotas", "citus_isolate_tenant_to_node",
        "citus_add_priority_class", "citus_priority_classes",
        "citus_activate_node_metadata", "citus_sync_metadata",
        "citus_extensions",
        "citus_domains", "citus_collations", "citus_publications",
        "citus_statistics_objects",
        "citus_stat_history", "citus_health_events",
        "citus_device_memory",
        "citus_shard_load", "citus_rebalance_plan", "citus_autopilot_log",
        "citus_create_rollup", "citus_drop_rollup",
        "citus_refresh_rollups", "citus_rollups",
    }

    def parse_select_or_utility(self) -> A.Statement:
        save = self.i
        self.expect_kw("select")
        t = self.peek()
        if (t.kind == "ident" and t.value in self._UTILITY_FNS
                and self.peek(1).kind == "op" and self.peek(1).value == "("):
            self.next()
            self.expect_op("(")
            args = []
            if not self.at_op(")"):
                while True:
                    args.append(self.parse_utility_arg())
                    if not self.accept_op(","):
                        break
            self.expect_op(")")
            return A.UtilityCall(t.value, args)
        self.i = save
        return self.parse_select()

    def parse_utility_arg(self):
        t = self.next()
        if t.kind == "op" and t.value == "-":
            nt = self.next()
            if nt.kind != "num":
                self.error("expected number after '-'")
            return -(int(nt.value) if "." not in nt.value else float(nt.value))
        if t.kind == "str":
            return t.value[1:-1].replace("''", "'")
        if t.kind == "num":
            return int(t.value) if "." not in t.value else float(t.value)
        if t.kind == "kw" and t.value in ("true", "false"):
            return t.value == "true"
        if t.kind == "ident" and self.at_op("="):  # named arg: name => ignored
            self.error("named utility arguments not supported")
        if t.kind == "ident":
            return t.value
        self.error("bad utility argument")

    def parse_select(self):
        """select_core (UNION|INTERSECT|EXCEPT [ALL] select_core)*
        [ORDER BY ...] [LIMIT ...] [OFFSET ...] — INTERSECT binds
        tighter, as in PostgreSQL; trailing ORDER BY/LIMIT bind to the
        whole set operation.  Returns A.Select or A.SetOp."""
        node = self._parse_setop_union()
        order_by, limit, offset = self._parse_order_limit()
        if order_by or limit is not None or offset is not None:
            if node.order_by or node.limit is not None or node.offset is not None:
                self.error("ORDER BY/LIMIT may only follow the last SELECT "
                           "of a set operation")
            node.order_by = order_by
            node.limit = limit
            node.offset = offset
        return node

    def _parse_setop_union(self):
        left = self._parse_setop_intersect()
        while self.at_kw("union", "except"):
            op = self.next().value
            all_ = bool(self.accept_kw("all"))
            self.accept_kw("distinct")
            right = self._parse_setop_intersect()
            left = A.SetOp(op, all_, left, right)
        return left

    def _parse_setop_intersect(self):
        left = self._parse_select_core()
        while self.accept_kw("intersect"):
            all_ = bool(self.accept_kw("all"))
            self.accept_kw("distinct")
            right = self._parse_select_core()
            left = A.SetOp("intersect", all_, left, right)
        return left

    def _parse_order_limit(self):
        order_by: list[A.OrderItem] = []
        if self.accept_kw("order"):
            self.expect_kw("by")
            while True:
                e = self.parse_expr()
                asc = True
                if self.accept_kw("asc"):
                    pass
                elif self.accept_kw("desc"):
                    asc = False
                nulls_first = None
                if self.accept_kw("nulls"):
                    if self.accept_kw("first"):
                        nulls_first = True
                    else:
                        self.expect_kw("last")
                        nulls_first = False
                order_by.append(A.OrderItem(e, asc, nulls_first))
                if not self.accept_op(","):
                    break
        limit = offset = None
        if self.accept_kw("limit"):
            t = self.next()
            if t.kind != "num":
                self.error("expected number after LIMIT")
            limit = int(t.value)
        if self.accept_kw("offset"):
            t = self.next()
            if t.kind != "num":
                self.error("expected number after OFFSET")
            offset = int(t.value)
        return order_by, limit, offset

    def _parse_select_core(self):
        if self.at_op("("):
            # parenthesized select / set operation as an operand
            save = self.i
            self.next()
            if self.at_kw("select", "with") or self.at_op("("):
                node = self.parse_select()
                self.expect_op(")")
                return node
            self.i = save
            self.error("expected SELECT")
        self.expect_kw("select")
        distinct = bool(self.accept_kw("distinct"))
        distinct_on: tuple = ()
        if distinct and self.accept_kw("on"):
            # SELECT DISTINCT ON (expr, ...): first row per key
            self.expect_op("(")
            on_list = [self.parse_expr()]
            while self.accept_op(","):
                on_list.append(self.parse_expr())
            self.expect_op(")")
            distinct_on = tuple(on_list)
            distinct = False
        items = []
        while True:
            if self.at_op("*"):
                self.next()
                items.append(A.SelectItem(A.Star()))
            else:
                e = self.parse_expr()
                alias = None
                if self.accept_kw("as"):
                    alias = self.expect_ident()
                elif self.peek().kind == "ident":
                    alias = self.expect_ident()
                items.append(A.SelectItem(e, alias))
            if not self.accept_op(","):
                break
        from_ = None
        if self.accept_kw("from"):
            from_ = self.parse_from()
        where = None
        if self.accept_kw("where"):
            where = self.parse_expr()
        group_by: list[A.Expr] = []
        if self.accept_kw("group"):
            self.expect_kw("by")
            spec = self._maybe_grouping_sets()
            if spec is not None:
                group_by = [spec]
            else:
                while True:
                    group_by.append(self.parse_expr())
                    if not self.accept_op(","):
                        break
        having = None
        if self.accept_kw("having"):
            having = self.parse_expr()
        windows = []
        if self.accept_kw("window"):
            # WINDOW w AS (spec) [, w2 AS (spec)]: named windows for
            # OVER w / OVER (w ...) references
            while True:
                wname = self.expect_ident()
                self.expect_kw("as")
                part, order, frame, base = self._parse_window_spec()
                windows.append((wname, A.WindowCall(
                    None, part, order, frame, ref_name=base)))
                if not self.accept_op(","):
                    break
        return A.Select(items, from_, where, group_by, having, [],
                        None, None, distinct, tuple(windows), distinct_on)

    def parse_from(self):
        left = self.parse_table_ref()
        while True:
            if self.accept_kw("cross"):
                self.expect_kw("join")
                right = self.parse_table_ref()
                left = A.Join(left, right, "cross", None)
                continue
            kind = None
            if self.accept_kw("join") or self.accept_kw("inner"):
                if self.peek(-1).value == "inner":
                    self.expect_kw("join")
                kind = "inner"
            elif self.at_kw("left", "right", "full"):
                kind = self.next().value
                self.accept_kw("outer")
                self.expect_kw("join")
            if kind is None:
                if self.accept_op(","):  # comma join = cross join
                    right = self.parse_table_ref()
                    left = A.Join(left, right, "cross", None)
                    continue
                break
            right = self.parse_table_ref()
            self.expect_kw("on")
            cond = self.parse_expr()
            left = A.Join(left, right, kind, cond)
        return left

    def parse_table_ref(self):
        if self.at_op("("):
            # derived table: FROM (SELECT ...) [AS] alias
            self.next()
            sel = self.parse_select()
            self.expect_op(")")
            self.accept_kw("as")
            if self.peek().kind != "ident":
                self.error("derived table requires an alias")
            alias = self.expect_ident()
            return A.SubqueryRef(sel, alias)
        if self.peek().kind == "ident" and self.peek(1).kind == "op" \
                and self.peek(1).value == "(":
            # set-returning function: FROM generate_series(1, 10) g
            fname = self.expect_ident()
            self.expect_op("(")
            args = []
            if not self.at_op(")"):
                while True:
                    args.append(self.parse_expr())
                    if not self.accept_op(","):
                        break
            self.expect_op(")")
            alias = None
            if self.accept_kw("as"):
                alias = self.expect_ident()
            elif self.peek().kind == "ident":
                alias = self.expect_ident()
            return A.FunctionRef(fname, tuple(args), alias)
        name = self.parse_table_name()
        alias = None
        if self.accept_kw("as"):
            alias = self.expect_ident()
        elif self.peek().kind == "ident":
            alias = self.expect_ident()
        return A.TableRef(name, alias)

    # ---- expressions: precedence climbing ------------------------------
    def parse_expr(self) -> A.Expr:
        return self.parse_or()

    def parse_or(self) -> A.Expr:
        left = self.parse_and()
        while self.accept_kw("or"):
            left = A.BinOp("or", left, self.parse_and())
        return left

    def parse_and(self) -> A.Expr:
        left = self.parse_not()
        while self.accept_kw("and"):
            left = A.BinOp("and", left, self.parse_not())
        return left

    def parse_not(self) -> A.Expr:
        if self.accept_kw("not"):
            return A.UnOp("not", self.parse_not())
        return self.parse_comparison()

    def parse_comparison(self) -> A.Expr:
        left = self.parse_additive()
        while True:
            if self.at_op("=", "<>", "!=", "<", "<=", ">", ">="):
                op = self.next().value
                if op == "!=":
                    op = "<>"
                left = A.BinOp(op, left, self.parse_additive())
                continue
            negated = False
            save = self.i
            if self.accept_kw("not"):
                if self.at_kw("between", "in", "like", "ilike"):
                    negated = True
                else:
                    self.i = save
                    break
            if self.accept_kw("between"):
                lo = self.parse_additive()
                self.expect_kw("and")
                hi = self.parse_additive()
                left = A.Between(left, lo, hi, negated)
                continue
            if self.accept_kw("in"):
                self.expect_op("(")
                if self.at_kw("select"):
                    sub = self.parse_select()
                    self.expect_op(")")
                    left = A.InList(left, (A.Subquery(sub),), negated)
                    continue
                items = []
                while True:
                    items.append(self.parse_additive())
                    if not self.accept_op(","):
                        break
                self.expect_op(")")
                left = A.InList(left, tuple(items), negated)
                continue
            if self.at_kw("like", "ilike"):
                fname = self.next().value
                pattern = self.parse_additive()
                left = A.FuncCall(fname, (left, pattern))
                if negated:
                    left = A.UnOp("not", left)
                continue
            if self.accept_kw("is"):
                neg = bool(self.accept_kw("not"))
                if self.accept_kw("distinct"):
                    self.expect_kw("from")
                    right = self.parse_additive()
                    # null-safe equality: never yields NULL
                    same = A.BinOp(
                        "or",
                        A.BinOp("and", A.IsNull(left), A.IsNull(right)),
                        A.BinOp("and",
                                A.BinOp("and", A.IsNull(left, True),
                                        A.IsNull(right, True)),
                                A.BinOp("=", left, right)))
                    left = same if neg else A.UnOp("not", same)
                    continue
                self.expect_kw("null")
                left = A.IsNull(left, neg)
                continue
            break
        return left

    def parse_additive(self) -> A.Expr:
        left = self.parse_multiplicative()
        while self.at_op("+", "-"):
            op = self.next().value
            left = A.BinOp(op, left, self.parse_multiplicative())
        return left

    def parse_multiplicative(self) -> A.Expr:
        left = self.parse_unary()
        while self.at_op("*", "/", "%"):
            op = self.next().value
            left = A.BinOp(op, left, self.parse_unary())
        return left

    def parse_unary(self) -> A.Expr:
        if self.at_op("-"):
            self.next()
            return A.UnOp("-", self.parse_unary())
        if self.at_op("+"):
            self.next()
            return self.parse_unary()
        return self.parse_postfix()

    def parse_postfix(self) -> A.Expr:
        e = self.parse_primary()
        while self.accept_op("::"):
            tname, targs = self.parse_type_name()
            e = A.Cast(e, tname, tuple(targs))
        return e

    def parse_case(self) -> A.Expr:
        self.expect_kw("case")
        operand = None
        if not self.at_kw("when"):
            # simple CASE: CASE x WHEN v THEN ... desugars to the
            # searched form CASE WHEN x = v THEN ...
            operand = self.parse_expr()
        whens = []
        while self.accept_kw("when"):
            cond = self.parse_expr()
            if operand is not None:
                cond = A.BinOp("=", operand, cond)
            self.expect_kw("then")
            whens.append((cond, self.parse_expr()))
        else_ = None
        if self.accept_kw("else"):
            else_ = self.parse_expr()
        self.expect_kw("end")
        return A.CaseExpr(tuple(whens), else_)

    def parse_primary(self) -> A.Expr:
        t = self.peek()
        if t.kind == "num":
            self.next()
            if "." in t.value or "e" in t.value.lower():
                if "e" in t.value.lower():
                    return A.Literal(float(t.value), "float")
                return A.Literal(decimal.Decimal(t.value), "decimal")
            return A.Literal(int(t.value), "int")
        if t.kind == "str":
            self.next()
            return A.Literal(t.value[1:-1].replace("''", "'"), "string")
        if t.kind == "kw":
            if t.value in ("true", "false"):
                self.next()
                return A.Literal(t.value == "true", "bool")
            if t.value == "null":
                self.next()
                return A.Literal(None, "null")
            if t.value == "case":
                return self.parse_case()
            if t.value == "cast":
                self.next()
                self.expect_op("(")
                e = self.parse_expr()
                self.expect_kw("as")
                tname, targs = self.parse_type_name()
                self.expect_op(")")
                return A.Cast(e, tname, tuple(targs))
            if t.value == "not":
                self.next()
                return A.UnOp("not", self.parse_comparison())
            if t.value == "exists":
                self.next()
                self.expect_op("(")
                sel = self.parse_select()
                self.expect_op(")")
                return A.Exists(sel)
            if t.value in ("left", "right") and self.peek(1).kind == "op" \
                    and self.peek(1).value == "(":
                # left()/right() string functions share spellings with the
                # join keywords; the call parenthesis disambiguates
                self.next()
                self.expect_op("(")
                args = [self.parse_expr()]
                while self.accept_op(","):
                    args.append(self.parse_expr())
                self.expect_op(")")
                return A.FuncCall(t.value, tuple(args))
        if t.kind == "param":
            self.next()
            return A.Param(int(t.value[1:]))
        if t.kind == "op" and t.value == "(":
            self.next()
            if self.at_kw("select"):
                sub = self.parse_select()
                self.expect_op(")")
                return A.Subquery(sub)
            e = self.parse_expr()
            self.expect_op(")")
            return e
        if t.kind == "ident" \
                and t.value in ("date", "timestamp", "timestamptz",
                                "time", "uuid", "bytea") \
                and self.peek(1).kind == "str":
            # typed literal: date '1998-12-01' / uuid 'a0ee...' / ...
            tname = t.value
            self.next()
            lit = self.next()
            return A.Cast(A.Literal(lit.value[1:-1], "string"), tname, ())
        if t.kind == "ident" and t.value == "interval" \
                and self.peek(1).kind == "str":
            self.next()
            body = self.next().value[1:-1].strip()
            # optional trailing unit token: INTERVAL '90' day
            unit = None
            if self.peek().kind == "ident" and self.peek().value in _IVL_UNITS:
                unit = self.next().value
            return _parse_interval(body, unit, self.error)
        if t.kind == "ident" and t.value == "array" \
                and self.peek(1).kind == "op" and self.peek(1).value == "[":
            # ARRAY[e1, e2, ...] literal (1-D, literal elements)
            self.next()
            self.next()
            items = []
            if not (self.peek().kind == "op" and self.peek().value == "]"):
                while True:
                    e = self.parse_expr()
                    v = _const_literal_value(e)
                    if v is _NOT_CONST:
                        self.error("ARRAY elements must be literals")
                    items.append(v)
                    if not self.accept_op(","):
                        break
            self.expect_op("]")
            return A.Literal(items, "array")
        if t.kind == "ident" and t.value in ("current_date",
                                             "current_timestamp"):
            self.next()
            return A.FuncCall(t.value, ())
        if t.kind == "ident" and t.value == "position" and \
                self.peek(1).kind == "op" and self.peek(1).value == "(":
            # position(substring IN string) -> strpos(string, substring)
            self.next()
            self.expect_op("(")
            sub = self.parse_additive()
            self.expect_kw("in")
            s = self.parse_expr()
            self.expect_op(")")
            return A.FuncCall("strpos", (s, sub))
        if t.kind == "ident" and t.value == "extract" and \
                self.peek(1).kind == "op" and self.peek(1).value == "(":
            self.next()
            self.expect_op("(")
            ft = self.next()
            if ft.kind not in ("ident", "kw"):
                self.error("expected EXTRACT field")
            self.expect_kw("from")
            inner = self.parse_expr()
            self.expect_op(")")
            return A.FuncCall("extract", (A.Literal(ft.value, "string"), inner))
        if t.kind == "ident":
            self.next()
            if self.at_op("("):  # function call
                self.next()
                distinct = bool(self.accept_kw("distinct"))
                args: list[A.Expr] = []
                if self.at_op("*"):
                    self.next()
                    args.append(A.Star())
                elif not self.at_op(")"):
                    while True:
                        args.append(self.parse_expr())
                        if not self.accept_op(","):
                            break
                agg_order = []
                if self.accept_kw("order"):
                    # ordered aggregate: fn(args ORDER BY expr [DESC], ...)
                    self.expect_kw("by")
                    while True:
                        oe = self.parse_expr()
                        asc = True
                        if self.accept_kw("asc"):
                            pass
                        elif self.accept_kw("desc"):
                            asc = False
                        agg_order.append((oe, asc))
                        if not self.accept_op(","):
                            break
                self.expect_op(")")
                fc = A.FuncCall(t.value, tuple(args), distinct, tuple(agg_order))
                if self.at_kw("within"):
                    # ordered-set aggregate: percentile_cont(f) WITHIN
                    # GROUP (ORDER BY x) desugars to fn(f, x)
                    self.next()
                    self.expect_kw("group")
                    self.expect_op("(")
                    self.expect_kw("order")
                    self.expect_kw("by")
                    sort_expr = self.parse_expr()
                    if self.accept_kw("desc"):
                        self.error("WITHIN GROUP (ORDER BY ... DESC) is not "
                                   "supported; use 1 - fraction")
                    self.accept_kw("asc")
                    self.expect_op(")")
                    fc = A.FuncCall(t.value, tuple(args) + (sort_expr,), distinct)
                if self.peek().kind == "ident" and self.peek().value == "filter" \
                        and self.peek(1).kind == "op" and self.peek(1).value == "(":
                    # agg(...) FILTER (WHERE cond) [OVER ...]
                    self.next()
                    self.expect_op("(")
                    self.expect_kw("where")
                    cond = self.parse_expr()
                    self.expect_op(")")
                    fc = dataclasses.replace(fc, filter=cond)
                if self.at_kw("over"):
                    self.next()
                    if self.peek().kind == "ident":
                        # OVER w: use the named window verbatim
                        return A.WindowCall(fc, ref_name=self.expect_ident(),
                                            ref_verbatim=True)
                    part, order, frame, base = self._parse_window_spec()
                    return A.WindowCall(fc, part, order, frame, ref_name=base)
                return fc
            if self.accept_op("."):
                col = self.expect_ident()
                return A.ColumnRef(col, table=t.value)
            return A.ColumnRef(t.value)
        self.error("expected expression")


_IVL_UNITS = {
    "year": ("months", 12), "years": ("months", 12),
    "month": ("months", 1), "months": ("months", 1),
    "week": ("days", 7), "weeks": ("days", 7),
    "day": ("days", 1), "days": ("days", 1),
    "hour": ("micros", 3_600_000_000), "hours": ("micros", 3_600_000_000),
    "minute": ("micros", 60_000_000), "minutes": ("micros", 60_000_000),
    "second": ("micros", 1_000_000), "seconds": ("micros", 1_000_000),
}


_NOT_CONST = object()


def _const_literal_value(e):
    """Literal (or negated numeric literal) -> Python value, else
    _NOT_CONST."""
    if isinstance(e, A.Literal):
        return e.value
    if isinstance(e, A.UnOp) and e.op == "-" \
            and isinstance(e.operand, A.Literal) \
            and isinstance(e.operand.value, (int, float)):
        return -e.operand.value
    return _NOT_CONST


def _parse_interval(body: str, unit, error) -> A.IntervalLiteral:
    """'90' + unit, or PostgreSQL's verbose form '1 year 2 days'."""
    parts = {"months": 0, "days": 0, "micros": 0}
    toks = body.split()
    if unit is not None:
        try:
            qty = int(body)
        except ValueError:
            error(f"bad interval quantity {body!r}")
        field, mult = _IVL_UNITS[unit]
        parts[field] += qty * mult
        return A.IntervalLiteral(**parts)
    if len(toks) == 1:
        # bare number means days? PostgreSQL: seconds for interval-only;
        # analytics usage virtually always writes a unit — require one
        error("interval requires a unit (e.g. interval '90 days')")
    i = 0
    while i < len(toks):
        try:
            qty = int(toks[i])
        except ValueError:
            error(f"bad interval {body!r}")
        if i + 1 >= len(toks) or toks[i + 1].lower() not in _IVL_UNITS:
            error(f"bad interval {body!r}")
        field, mult = _IVL_UNITS[toks[i + 1].lower()]
        parts[field] += qty * mult
        i += 2
    return A.IntervalLiteral(**parts)


def parse_sql(text: str) -> list[A.Statement]:
    return Parser(text).parse_statements()


def parse_statement(text: str) -> A.Statement:
    stmts = parse_sql(text)
    if len(stmts) != 1:
        raise SqlSyntaxError(f"expected exactly one statement, got {len(stmts)}")
    return stmts[0]
