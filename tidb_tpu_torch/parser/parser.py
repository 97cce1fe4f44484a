"""Recursive-descent SQL parser (MySQL dialect subset).

Reference: TiDB's parser/parser.y (6,404-line goyacc LALR grammar).
Deliberately NOT a grammar port (SURVEY.md §7 stage 4: "do not rebuild the
6.4k-line grammar; grow it feature-by-feature"): a hand-written
Pratt/recursive-descent parser covering the SQL surface the framework
executes — TPC-H-class SELECT (joins, subqueries, aggregates, CASE),
DML, DDL, txn control, SET/SHOW/EXPLAIN/ANALYZE/ADMIN.
"""

from __future__ import annotations

import decimal

from tidb_tpu_torch import sqltypes as st
from tidb_tpu_torch.parser import ast
from tidb_tpu_torch.parser.lexer import (Lexer, NON_RESERVED, Token,
                                   TokenType)

__all__ = ["parse", "parse_one", "ParseError"]


class ParseError(Exception):
    def __init__(self, msg: str, tok: Token | None = None):
        if tok is not None:
            msg = f"{msg} near {tok.val!r} (pos {tok.pos})"
        super().__init__(msg)


def parse(sql: str) -> list[ast.StmtNode]:
    """Parse a semicolon-separated statement list.
    Ref: parser.Parse (parser/yy_parser.go:88) -> []ast.StmtNode."""
    toks = Lexer(sql).tokens()
    p = Parser(toks)
    stmts = []
    while not p.at_eof():
        if p.try_op(";"):
            continue
        stmts.append(p.statement())
        if not p.at_eof():
            p.expect_op(";")
    return stmts


def parse_one(sql: str) -> ast.StmtNode:
    stmts = parse(sql)
    if len(stmts) != 1:
        raise ParseError(f"expected one statement, got {len(stmts)}")
    return stmts[0]


_AGG_FUNCS = {"COUNT", "SUM", "AVG", "MIN", "MAX", "GROUP_CONCAT",
              "BIT_AND", "BIT_OR", "BIT_XOR"}

_CMP_OPS = {"=", "<", "<=", ">", ">=", "<>", "!=", "<=>"}


MAX_EXPR_DEPTH = 64  # explicit cap: clean error instead of RecursionError


class Parser:
    def __init__(self, toks: list[Token]):
        self.toks = toks
        self.i = 0
        self.depth = 0

    # -- token helpers -------------------------------------------------------

    def peek(self, k: int = 0) -> Token:
        j = min(self.i + k, len(self.toks) - 1)
        return self.toks[j]

    def next(self) -> Token:
        t = self.toks[self.i]
        if t.tp != TokenType.EOF:
            self.i += 1
        return t

    def at_eof(self) -> bool:
        return self.peek().tp == TokenType.EOF

    def try_kw(self, *kws: str) -> bool:
        t = self.peek()
        if t.tp == TokenType.KEYWORD and t.val in kws:
            self.next()
            return True
        return False

    def expect_kw(self, kw: str) -> None:
        if not self.try_kw(kw):
            raise ParseError(f"expected {kw}", self.peek())

    # word helpers: match a KEYWORD *or* IDENT by (upper-cased) value —
    # for MySQL's many non-reserved words (ISOLATION, LOCAL, DISABLE...)
    def peek_word(self, k: int = 0) -> str:
        t = self.peek(k)
        return t.val.upper() if t.tp in (TokenType.KEYWORD,
                                         TokenType.IDENT) else ""

    # non-reserved words (lexer.NON_RESERVED): keyword meaning only in
    # LOAD DATA / SPLIT TABLE clauses, plain identifiers elsewhere
    def try_word(self, *words: str) -> bool:
        unknown = [w for w in words if w not in NON_RESERVED]
        if unknown:   # programming-error guard: keep the registry honest
            raise ParseError(
                f"internal: {unknown} missing from lexer.NON_RESERVED")
        t = self.peek()
        if t.tp in (TokenType.IDENT, TokenType.KEYWORD) and \
                t.val.upper() in words:
            self.next()
            return True
        return False

    def expect_word(self, word: str) -> None:
        if not self.try_word(word):
            raise ParseError(f"expected {word}", self.peek())

    def try_op(self, op: str) -> bool:
        t = self.peek()
        if t.tp == TokenType.OP and t.val == op:
            self.next()
            return True
        return False

    def expect_op(self, op: str) -> None:
        if not self.try_op(op):
            raise ParseError(f"expected {op!r}", self.peek())

    def ident(self) -> str:
        t = self.peek()
        if t.tp == TokenType.IDENT:
            self.next()
            return t.val
        # many keywords double as identifiers in practice
        if t.tp == TokenType.KEYWORD and t.val not in (
                "SELECT", "FROM", "WHERE", "AND", "OR", "NOT"):
            self.next()
            return t.val.lower()
        raise ParseError("expected identifier", t)

    # -- statements ----------------------------------------------------------

    def statement(self) -> ast.StmtNode:
        t = self.peek()
        if t.tp == TokenType.IDENT and \
                t.val.upper() in ("LOAD", "SPLIT", "KILL", "DO",
                                  "FLUSH", "TRACE"):
            # non-reserved statement heads (see lexer.NON_RESERVED)
            head = t.val.upper()
            if head == "LOAD":
                return self.load_data()
            if head == "SPLIT":
                return self.split_table()
            if head == "KILL":
                return self.kill_stmt()
            if head == "TRACE":
                return self.trace_stmt()
            if head == "DO":
                self.next()
                exprs = [self.expr()]
                while self.try_op(","):
                    exprs.append(self.expr())
                return ast.DoStmt(exprs=exprs)
            self.next()                      # FLUSH
            # FLUSH [NO_WRITE_TO_BINLOG|LOCAL] TABLES [t, ...]
            #       [WITH READ LOCK] / PRIVILEGES / STATUS ...
            self.try_word("NO_WRITE_TO_BINLOG", "LOCAL")
            kind = self.ident().lower()
            if kind in ("tables", "table"):
                kind = "tables"
                while self.peek().tp == TokenType.IDENT:
                    self.ident()
                    if not self.try_op(","):
                        break
                if self.try_kw("WITH"):
                    self.expect_word("READ")
                    self.expect_word("LOCK")
            return ast.FlushStmt(tp=kind)
        if t.tp != TokenType.KEYWORD and not (t.tp == TokenType.OP and
                                              t.val == "("):
            raise ParseError("expected statement", t)
        kw = t.val
        if kw == "SELECT" or kw == "(":
            return self.select_or_union()
        if kw in ("INSERT", "REPLACE"):
            return self.insert()
        if kw == "UPDATE":
            return self.update()
        if kw == "DELETE":
            return self.delete()
        if kw == "CREATE":
            return self.create()
        if kw == "DROP":
            return self.drop()
        if kw == "ALTER":
            return self.alter()
        if kw == "TRUNCATE":
            self.next()
            self.try_kw("TABLE")
            return ast.TruncateTableStmt(table=self.table_name())
        if kw == "RENAME":
            return self.rename()
        if kw == "USE":
            self.next()
            return ast.UseStmt(db=self.ident())
        if kw == "BEGIN":
            self.next()
            return ast.BeginStmt()
        if kw == "START":
            self.next()
            self.expect_kw("TRANSACTION")
            return ast.BeginStmt()
        if kw == "COMMIT":
            self.next()
            return ast.CommitStmt()
        if kw == "ROLLBACK":
            self.next()
            return ast.RollbackStmt()
        if kw == "SET":
            return self.set_stmt()
        if kw == "SHOW":
            return self.show()
        if kw in ("EXPLAIN", "DESCRIBE"):
            self.next()
            if self.peek().tp in (TokenType.IDENT,) or (
                    self.peek().tp == TokenType.KEYWORD and
                    self.peek().val not in ("SELECT", "INSERT", "UPDATE",
                                            "DELETE", "EXTENDED",
                                            "ANALYZE")):
                # DESCRIBE <table>
                return ast.ShowStmt(tp="columns", table=self.table_name())
            analyze = bool(self.try_kw("ANALYZE"))
            self.try_kw("EXTENDED")
            return ast.ExplainStmt(stmt=self.statement(), analyze=analyze)
        if kw == "PREPARE":
            self.next()
            name = self.ident()
            self.expect_kw("FROM")
            if self.try_op("@"):
                # PREPARE s FROM @v: text read from the user variable at
                # execution time (session layer)
                return ast.PrepareStmt(name=name, sql="",
                                       from_var="@" + self.ident())
            tok = self.next()
            if tok.tp != TokenType.STRING:
                raise ParseError("PREPARE requires a string literal")
            return ast.PrepareStmt(name=name, sql=tok.val)
        if kw == "EXECUTE":
            self.next()
            name = self.ident()
            using = []
            if self.try_kw("USING"):
                while True:
                    if not self.try_op("@"):
                        raise ParseError("EXECUTE USING takes @variables")
                    using.append("@" + self.ident())
                    if not self.try_op(","):
                        break
            return ast.ExecuteStmt(name=name, using=using)
        if kw == "DEALLOCATE":
            self.next()
            self.expect_kw("PREPARE")
            return ast.DeallocateStmt(name=self.ident())
        if kw == "ANALYZE":
            self.next()
            self.expect_kw("TABLE")
            tables = [self.table_name()]
            while self.try_op(","):
                tables.append(self.table_name())
            idx_names = None
            if self.try_kw("INDEX"):
                # ANALYZE TABLE t INDEX [a, b]: restrict to index stats
                idx_names = []
                while self.peek().tp == TokenType.IDENT:
                    idx_names.append(self.ident())
                    if not self.try_op(","):
                        break
            return ast.AnalyzeStmt(tables=tables, index_names=idx_names)
        if kw == "GRANT":
            return self.grant_revoke(is_grant=True)
        if kw == "REVOKE":
            return self.grant_revoke(is_grant=False)
        if kw == "ADMIN":
            self.next()
            if self.try_kw("SHOW"):
                if self.peek().tp == TokenType.IDENT and \
                        self.peek().val.upper() == "DDL":
                    self.next()
                    if self.peek().tp == TokenType.IDENT and \
                            self.peek().val.upper() == "JOBS":
                        self.next()
                        return ast.AdminStmt(tp="show_ddl_jobs")
                return ast.AdminStmt(tp="show_ddl")
            if self.try_word("CANCEL"):
                # ADMIN CANCEL DDL JOBS id [, id]
                if self.peek_word() == "DDL":
                    self.next()
                self.expect_word("JOBS")
                ids = [self._int_lit()]
                while self.try_op(","):
                    ids.append(self._int_lit())
                return ast.AdminStmt(tp="cancel_ddl_jobs", job_ids=ids)
            self.expect_kw("CHECK")
            self.expect_kw("TABLE")
            tables = [self.table_name()]
            while self.try_op(","):
                tables.append(self.table_name())
            return ast.AdminStmt(tp="check_table", tables=tables)
        raise ParseError("unsupported statement", t)

    # -- LOAD DATA / SPLIT ---------------------------------------------------

    def _str_lit(self) -> str:
        tok = self.next()
        if tok.tp != TokenType.STRING:
            raise ParseError("expected string literal", tok)
        return tok.val

    def load_data(self) -> ast.LoadDataStmt:
        """LOAD DATA [LOCAL] INFILE 'p' [REPLACE|IGNORE] INTO TABLE t
        [FIELDS ...] [LINES ...] [IGNORE n LINES] [(cols)]
        (ref: parser.y LoadDataStmt; executor/write.go:1373)."""
        self.expect_word("LOAD")
        self.expect_word("DATA")
        stmt = ast.LoadDataStmt()
        stmt.local = self.try_word("LOCAL")
        self.expect_word("INFILE")
        stmt.path = self._str_lit()
        if self.try_kw("REPLACE"):
            stmt.dup_mode = "replace"
        elif self.try_kw("IGNORE"):
            stmt.dup_mode = "ignore"
        elif stmt.local:
            stmt.dup_mode = "ignore"   # MySQL: LOCAL implies IGNORE
        self.expect_kw("INTO")
        self.expect_kw("TABLE")
        stmt.table = self.table_name()
        if self.try_kw("FIELDS", "COLUMNS"):
            while True:
                if self.try_word("TERMINATED"):
                    self.expect_kw("BY")
                    stmt.fields_terminated = self._str_lit()
                elif self.try_word("OPTIONALLY"):
                    self.expect_word("ENCLOSED")
                    self.expect_kw("BY")
                    stmt.fields_enclosed = self._str_lit()
                elif self.try_word("ENCLOSED"):
                    self.expect_kw("BY")
                    stmt.fields_enclosed = self._str_lit()
                elif self.try_word("ESCAPED"):
                    self.expect_kw("BY")
                    stmt.fields_escaped = self._str_lit()
                else:
                    break
        if self.try_word("LINES"):
            while True:
                if self.try_word("STARTING"):
                    self.expect_kw("BY")
                    stmt.lines_starting = self._str_lit()
                elif self.try_word("TERMINATED"):
                    self.expect_kw("BY")
                    stmt.lines_terminated = self._str_lit()
                else:
                    break
        if self.try_kw("IGNORE"):
            tok = self.next()
            if tok.tp != TokenType.INT:
                raise ParseError("IGNORE requires a row count", tok)
            stmt.ignore_lines = int(tok.val)
            self.expect_word("LINES")
        if self.try_op("("):
            while True:
                stmt.columns.append(self.ident())
                if not self.try_op(","):
                    break
            self.expect_op(")")
        return stmt

    def kill_stmt(self) -> ast.KillStmt:
        """KILL [TIDB] [CONNECTION | QUERY] <id>."""
        self.expect_word("KILL")
        self.try_word("TIDB")
        query_only = False
        if self.try_word("QUERY"):
            query_only = True
        else:
            self.try_word("CONNECTION")
        tok = self.next()
        if tok.tp != TokenType.INT:
            raise ParseError("KILL requires a connection id", tok)
        return ast.KillStmt(conn_id=int(tok.val), query_only=query_only)

    def trace_stmt(self) -> ast.TraceStmt:
        """TRACE [FORMAT = 'row'|'json'] <stmt>."""
        self.expect_word("TRACE")
        fmt = "row"
        if self.try_word("FORMAT"):
            self.expect_op("=")
            tok = self.next()
            if tok.tp != TokenType.STRING:
                raise ParseError(
                    "TRACE FORMAT takes a string literal", tok)
            fmt = tok.val.lower()
            if fmt not in ("row", "json"):
                raise ParseError(
                    f"unsupported TRACE FORMAT {tok.val!r} "
                    f"(use 'row' or 'json')", tok)
        return ast.TraceStmt(stmt=self.statement(), format=fmt)

    def split_table(self) -> ast.SplitTableStmt:
        """SPLIT TABLE t AT (v)[,(v)...] | SPLIT TABLE t REGIONS n."""
        self.expect_word("SPLIT")
        self.expect_kw("TABLE")
        stmt = ast.SplitTableStmt(table=self.table_name())
        if self.try_word("AT"):
            while True:
                self.expect_op("(")
                stmt.at_values.append(self.expr())
                self.expect_op(")")
                if not self.try_op(","):
                    break
        else:
            self.expect_word("REGIONS")
            tok = self.next()
            if tok.tp != TokenType.INT:
                raise ParseError("REGIONS requires a count", tok)
            stmt.regions = int(tok.val)
        return stmt

    # -- SELECT --------------------------------------------------------------

    def select_or_union(self) -> ast.StmtNode:
        first = self.select_core()
        if not (self.peek().is_kw("UNION")):
            return first
        selects = [first]
        alls = []
        while self.try_kw("UNION"):
            is_all = self.try_kw("ALL")
            self.try_kw("DISTINCT") or self.try_word("DISTINCTROW")
            alls.append(is_all)
            selects.append(self.select_core())
        u = ast.UnionStmt(selects=selects, alls=alls)
        if self.try_kw("ORDER"):
            self.expect_kw("BY")
            u.order_by = self.by_list()
        if self.try_kw("LIMIT"):
            u.limit, u.offset = self.limit_clause()
        # MySQL: a trailing ORDER BY / LIMIT binds to the WHOLE union, not
        # the final branch (select_core consumed it while parsing the
        # last SELECT) — hoist it up when the union carries none
        last = selects[-1]
        if not u.order_by and u.limit is None and \
                isinstance(last, ast.SelectStmt) and \
                not getattr(last, "_parenthesized", False) and \
                (last.order_by or last.limit is not None):
            u.order_by, last.order_by = last.order_by, []
            u.limit, u.offset = last.limit, last.offset
            last.limit, last.offset = None, 0
        return u

    def select_core(self) -> ast.SelectStmt:
        if self.try_op("("):
            s = self.select_or_union()
            self.expect_op(")")
            # parenthesized branches keep their own ORDER BY / LIMIT
            # (select_or_union's union-level hoist must skip them)
            s._parenthesized = True
            return s
        self.expect_kw("SELECT")
        s = ast.SelectStmt()
        s.distinct = self.try_kw("DISTINCT") or \
            self.try_word("DISTINCTROW")
        self.try_kw("ALL")
        s.fields.append(self.select_field())
        while self.try_op(","):
            s.fields.append(self.select_field())
        if self.try_kw("FROM"):
            s.from_clause = self.table_refs()
        if self.try_kw("WHERE"):
            s.where = self.expr()
        if self.try_kw("GROUP"):
            self.expect_kw("BY")
            s.group_by = self.by_list()
        if self.try_kw("HAVING"):
            s.having = self.expr()
        if self.try_kw("ORDER"):
            self.expect_kw("BY")
            s.order_by = self.by_list()
        if self.try_kw("LIMIT"):
            s.limit, s.offset = self.limit_clause()
        if self.try_kw("FOR"):
            self.expect_kw("UPDATE")
            s.for_update = True
        elif self.try_word("LOCK"):
            # LOCK IN SHARE MODE: reads are snapshot-consistent already;
            # accepted as the weaker cousin of FOR UPDATE (no row locks)
            self.expect_kw("IN")
            self.expect_word("SHARE")
            self.expect_word("MODE")
        return s

    def select_field(self) -> ast.SelectField:
        t = self.peek()
        if t.tp == TokenType.OP and t.val == "*":
            self.next()
            return ast.SelectField(expr=ast.Star())
        # t.* / db.t.* forms
        if t.tp == TokenType.IDENT and self.peek(1).val == "." and \
                self.peek(2).val == "*":
            self.next(); self.next(); self.next()
            return ast.SelectField(expr=ast.Star(table=t.val))
        if t.tp == TokenType.IDENT and self.peek(1).val == "." and \
                self.peek(2).tp == TokenType.IDENT and \
                self.peek(3).val == "." and self.peek(4).val == "*":
            self.next()
            tbl = self.peek(1).val
            self.next(); self.next(); self.next(); self.next()
            return ast.SelectField(expr=ast.Star(table=tbl))
        e = self.expr()
        alias = ""
        if self.try_kw("AS"):
            if self.peek().tp == TokenType.STRING:
                alias = self.next().val
            else:
                alias = self.ident()
        elif self.peek().tp == TokenType.IDENT:
            alias = self.ident()
        return ast.SelectField(expr=e, alias=alias)

    def by_list(self) -> list[ast.ByItem]:
        items = [self.by_item()]
        while self.try_op(","):
            items.append(self.by_item())
        return items

    def by_item(self) -> ast.ByItem:
        e = self.expr()
        desc = False
        if self.try_kw("DESC"):
            desc = True
        else:
            self.try_kw("ASC")
        return ast.ByItem(expr=e, desc=desc)

    def limit_clause(self) -> tuple[int, int]:
        a = self._int_lit()
        if self.try_op(","):
            return self._int_lit(), a       # LIMIT offset, count
        if self.try_kw("OFFSET"):
            return a, self._int_lit()
        return a, 0

    def _int_lit(self) -> int:
        t = self.next()
        if t.tp != TokenType.INT:
            raise ParseError("expected integer", t)
        return int(t.val)

    # -- table refs ----------------------------------------------------------

    def table_refs(self):
        left = self.table_ref()
        while True:
            if self.try_op(","):
                right = self.table_ref()
                left = ast.Join(left, right, ast.JoinType.CROSS)
            elif self.peek().is_kw("JOIN") or self.peek().is_kw("INNER") or \
                    self.peek().is_kw("CROSS") or self.peek().is_kw("LEFT") \
                    or self.peek().is_kw("RIGHT"):
                left = self._join_rest(left)
            elif self.peek().tp == TokenType.IDENT and \
                    self.peek().val.upper() == "STRAIGHT_JOIN":
                # optimizer-order hint; join order is the planner's call
                self.next()
                right = self.table_ref()
                j = ast.Join(left, right, ast.JoinType.INNER)
                if self.try_kw("ON"):
                    j.on = self.expr()
                left = j
            elif self.peek().tp == TokenType.IDENT and \
                    self.peek().val.upper() == "NATURAL":
                self.next()
                left = self._join_rest(left)
                left.natural = True     # join columns = common names
            else:
                return left

    def _join_rest(self, left):
        tp = ast.JoinType.INNER
        if self.try_kw("LEFT"):
            tp = ast.JoinType.LEFT
            self.try_kw("OUTER")
        elif self.try_kw("RIGHT"):
            tp = ast.JoinType.RIGHT
            self.try_kw("OUTER")
        elif self.try_kw("CROSS"):
            tp = ast.JoinType.CROSS
        else:
            self.try_kw("INNER")
        self.expect_kw("JOIN")
        right = self.table_ref()
        j = ast.Join(left, right, tp)
        if self.try_kw("ON"):
            j.on = self.expr()
        elif self.try_kw("USING"):
            self.expect_op("(")
            j.using = [self.ident()]
            while self.try_op(","):
                j.using.append(self.ident())
            self.expect_op(")")
        return j

    def table_ref(self):
        if self.try_op("("):
            if self.peek().is_kw("SELECT"):
                sub = self.select_or_union()
                self.expect_op(")")
                alias = ""
                self.try_kw("AS")
                if self.peek().tp == TokenType.IDENT:
                    alias = self.ident()
                return ast.SubqueryTable(select=sub, alias=alias)
            inner = self.table_refs()
            self.expect_op(")")
            return inner
        ts = self.table_name()
        if self.try_kw("AS"):
            ts.alias = self.ident()
        elif self.peek().tp == TokenType.IDENT and \
                self.peek().val.upper() not in ("LOCK", "STRAIGHT_JOIN",
                                                "NATURAL") and \
                not self._at_index_hint():
            ts.alias = self.ident()
        while self._at_index_hint():
            kind = self.next().val.upper()
            self.next()                       # INDEX | KEY
            if self.try_kw("FOR"):            # FOR JOIN|ORDER BY|GROUP BY
                if not self.try_kw("JOIN"):
                    self.try_kw("ORDER") or self.try_kw("GROUP")
                    self.expect_kw("BY")
            self.expect_op("(")
            names = []
            if not (self.peek().tp == TokenType.OP and
                    self.peek().val == ")"):
                names.append(self.ident())
                while self.try_op(","):
                    names.append(self.ident())
            self.expect_op(")")
            ts.index_hints.append((kind, names))
        return ts

    def _at_index_hint(self) -> bool:
        """USE|IGNORE|FORCE INDEX|KEY ( ... ) after a table factor."""
        t, t1 = self.peek(), self.peek(1)
        w = t.val.upper() if t.tp in (TokenType.KEYWORD,
                                      TokenType.IDENT) else ""
        w1 = t1.val.upper() if t1.tp in (TokenType.KEYWORD,
                                         TokenType.IDENT) else ""
        return w in ("USE", "IGNORE", "FORCE") and w1 in ("INDEX", "KEY")

    def table_name(self) -> ast.TableSource:
        a = self.ident()
        if self.try_op("."):
            return ast.TableSource(name=self.ident(), db=a)
        return ast.TableSource(name=a)

    # -- INSERT / UPDATE / DELETE -------------------------------------------

    def insert(self) -> ast.InsertStmt:
        is_replace = self.peek().val == "REPLACE"
        self.next()
        stmt = ast.InsertStmt(is_replace=is_replace)
        stmt.ignore = self.try_kw("IGNORE")
        self.try_kw("INTO")
        stmt.table = self.table_name()
        if self.peek().tp == TokenType.OP and self.peek().val == "(":
            # could be column list or SELECT
            if self.peek(1).is_kw("SELECT"):
                self.next()
                stmt.select = self.select_or_union()
                self.expect_op(")")
                return stmt
            self.expect_op("(")
            if not self.try_op(")"):       # () = explicit empty list
                stmt.columns.append(self.ident())
                while self.try_op(","):
                    stmt.columns.append(self.ident())
                self.expect_op(")")
        if self.try_kw("VALUES") or self.try_kw("VALUE"):
            stmt.values.append(self.value_row())
            while self.try_op(","):
                stmt.values.append(self.value_row())
        elif self.peek().is_kw("SELECT"):
            stmt.select = self.select_or_union()
        elif self.try_kw("SET"):
            row = []
            while True:
                c = self.column_name()
                self.expect_op("=")
                stmt.columns.append(c.name)
                row.append(self.expr_or_default())
                if not self.try_op(","):
                    break
            stmt.values = [row]
        else:
            raise ParseError("expected VALUES or SELECT", self.peek())
        if self.try_kw("ON"):
            self.expect_kw("DUPLICATE")
            self.expect_kw("KEY")
            self.expect_kw("UPDATE")
            stmt.on_duplicate.append(self.assignment())
            while self.try_op(","):
                stmt.on_duplicate.append(self.assignment())
        return stmt

    def value_row(self) -> list:
        self.expect_op("(")
        if self.try_op(")"):
            return []
        row = [self.expr_or_default()]
        while self.try_op(","):
            row.append(self.expr_or_default())
        self.expect_op(")")
        return row

    def expr_or_default(self):
        nt = self.peek(1)
        if self.peek().is_kw("DEFAULT") and not (
                nt.tp == TokenType.OP and nt.val == "("):
            self.next()
            return ast.DefaultExpr()
        return self.expr()

    def assignment(self) -> ast.Assignment:
        c = self.column_name()
        self.expect_op("=")
        return ast.Assignment(col=c, expr=self.expr_or_default())

    def update(self) -> ast.UpdateStmt:
        self.expect_kw("UPDATE")
        stmt = ast.UpdateStmt()
        stmt.table = self.table_refs()
        self.expect_kw("SET")
        stmt.assignments.append(self.assignment())
        while self.try_op(","):
            stmt.assignments.append(self.assignment())
        if self.try_kw("WHERE"):
            stmt.where = self.expr()
        if self.try_kw("ORDER"):
            self.expect_kw("BY")
            stmt.order_by = self.by_list()
        if self.try_kw("LIMIT"):
            stmt.limit, _ = self.limit_clause()
        return stmt

    def delete(self) -> ast.DeleteStmt:
        self.expect_kw("DELETE")
        if not self.peek().is_kw("FROM"):
            # DELETE t1, t2 FROM <refs> ...
            targets = [self.table_name()]
            while self.try_op(","):
                targets.append(self.table_name())
            self.expect_kw("FROM")
            refs = self.table_refs()
            stmt = ast.DeleteStmt(targets=targets, refs=refs)
            if self.try_kw("WHERE"):
                stmt.where = self.expr()
            return stmt
        self.expect_kw("FROM")
        first = self.table_name()
        if self.try_op(",") or self.peek_word() == "USING":
            # DELETE FROM t1[, t2] USING <refs> ...
            targets = [first]
            while self.peek().tp == TokenType.IDENT:
                targets.append(self.table_name())
                if not self.try_op(","):
                    break
            self.expect_word("USING")
            refs = self.table_refs()
            stmt = ast.DeleteStmt(targets=targets, refs=refs)
            if self.try_kw("WHERE"):
                stmt.where = self.expr()
            return stmt
        stmt = ast.DeleteStmt(table=first)
        if self.try_kw("WHERE"):
            stmt.where = self.expr()
        if self.try_kw("ORDER"):
            self.expect_kw("BY")
            stmt.order_by = self.by_list()
        if self.try_kw("LIMIT"):
            stmt.limit, _ = self.limit_clause()
        return stmt

    # -- DDL -----------------------------------------------------------------

    def create(self) -> ast.StmtNode:
        self.expect_kw("CREATE")
        if self.try_kw("USER"):
            ine = self._if_not_exists()
            users = [self._user_spec(with_password=True)]
            while self.try_op(","):
                users.append(self._user_spec(with_password=True))
            return ast.CreateUserStmt(users=users, if_not_exists=ine)
        if self.try_kw("DATABASE") or self.try_kw("SCHEMA"):
            ine = self._if_not_exists()
            return ast.CreateDatabaseStmt(name=self.ident(),
                                          if_not_exists=ine)
        # CREATE [OR REPLACE] [ALGORITHM=...] [DEFINER=...]
        # [SQL SECURITY ...] VIEW v [(cols)] AS select ... — parsed to
        # the AST like the reference (ast/ddl.go CreateViewStmt), and
        # like the reference's planner, EXECUTION rejects it loudly
        # (views are unimplemented there too)
        save = self.i
        or_replace = False
        if self.try_kw("OR"):
            if not self.try_word("REPLACE") and not self.try_kw("REPLACE"):
                self.i = save
            else:
                or_replace = True
        while self.peek_word() in ("ALGORITHM", "DEFINER", "SQL"):
            w = self.next().val.upper()
            if w == "SQL":
                self.expect_word("SECURITY")
                self.next()                 # DEFINER | INVOKER
            else:
                self.try_op("=")
                self.next()                 # undefined/merge/'root'/...
        if self.try_word("VIEW"):
            name = self.table_name()
            cols = []
            if self.peek().tp == TokenType.OP and self.peek().val == "(":
                cols = self._paren_idents()
            self.expect_kw("AS")
            sel = self.select_or_union()
            if self.try_kw("WITH"):
                self.try_word("LOCAL") or self.try_word("CASCADED")
                self.expect_kw("CHECK")
                self.expect_word("OPTION")
            return ast.CreateViewStmt(view=name, columns=cols,
                                      select=sel, or_replace=or_replace)
        if or_replace or self.i != save:
            raise ParseError("expected VIEW", self.peek())
        unique = self.try_kw("UNIQUE")
        if self.try_kw("INDEX"):
            name = self.ident()
            self._index_using()            # CREATE INDEX i USING BTREE ON ...
            self.expect_kw("ON")
            table = self.table_name()
            # _paren_idents accepts prefix lengths col(10) and ASC/DESC
            # (prefix indexing stores the full value — DEVIATIONS.md)
            cols = self._paren_idents()
            # trailing index options: USING, COMMENT (accepted, fixed
            # implementation — there is one index layout)
            while True:
                if self._index_using():
                    continue
                if self.try_kw("COMMENT"):
                    self.next()
                    continue
                break
            return ast.CreateIndexStmt(index_name=name, table=table,
                                       columns=cols, unique=unique)
        if unique:
            raise ParseError("expected INDEX after UNIQUE", self.peek())
        self.try_kw("TEMPORARY")
        self.expect_kw("TABLE")
        ine = self._if_not_exists()
        stmt = ast.CreateTableStmt(table=self.table_name(),
                                   if_not_exists=ine)
        if self.try_kw("LIKE"):
            stmt.like_table = self.table_name()
            return stmt
        if self.peek().tp == TokenType.OP and self.peek().val == "(" \
                and self.peek(1).tp == TokenType.KEYWORD and \
                self.peek(1).val == "LIKE":
            self.next()
            self.next()
            stmt.like_table = self.table_name()
            self.expect_op(")")
            return stmt
        self.expect_op("(")
        while True:
            if self.try_kw("PRIMARY"):
                self.expect_kw("KEY")
                if self.peek().tp == TokenType.IDENT:
                    self.ident()     # optional constraint name, ignored
                stmt.indexes.append(ast.IndexDef(
                    name="PRIMARY", columns=self._paren_idents(),
                    unique=True, primary=True))
            elif self.try_kw("UNIQUE"):
                self.try_kw("KEY") or self.try_kw("INDEX")
                name = "" if self.peek().val == "(" else self.ident()
                stmt.indexes.append(ast.IndexDef(
                    name=name, columns=self._paren_idents(), unique=True))
                self._index_tail_options()
            elif self.try_kw("KEY") or self.try_kw("INDEX"):
                name = "" if self.peek().val == "(" else self.ident()
                stmt.indexes.append(ast.IndexDef(
                    name=name, columns=self._paren_idents()))
                self._index_tail_options()
            elif self.try_kw("CHECK"):
                # table-level CHECK constraint: parsed + IGNORED (as
                # MySQL did before 8.0.16)
                self.expect_op("(")
                depth = 1
                while depth:
                    tk = self.next()
                    if tk.tp == TokenType.OP and tk.val == "(":
                        depth += 1
                    elif tk.tp == TokenType.OP and tk.val == ")":
                        depth -= 1
                    elif tk.tp == TokenType.EOF:
                        raise ParseError("unterminated CHECK", tk)
            elif self.peek_word() == "FULLTEXT":
                # fulltext layout: stored as a plain secondary index
                # (MATCH() search is unsupported — DEVIATIONS.md)
                self.next()
                self.try_kw("KEY") or self.try_kw("INDEX")
                name = "" if self.peek().val == "(" else self.ident()
                stmt.indexes.append(ast.IndexDef(
                    name=name, columns=self._paren_idents()))
                self._index_tail_options()
            elif self.try_kw("CONSTRAINT"):
                # CONSTRAINT [name] UNIQUE/PRIMARY/FOREIGN KEY ...
                if self.peek().tp == TokenType.IDENT:
                    self.ident()
                continue
            elif self.try_kw("FOREIGN"):
                self.expect_kw("KEY")
                self._paren_idents()
                self.expect_kw("REFERENCES")
                self.table_name()
                self._paren_idents()
                # FK constraints parsed + ignored (reference also defers FKs)
            else:
                stmt.columns.append(self.column_def())
            if not self.try_op(","):
                break
        self.expect_op(")")
        # table options (ref: parser.y TableOption — the storage-engine
        # tuning knobs are accepted and recorded, not acted on)
        _OPTS = ("ENGINE", "CHARSET", "COLLATE", "COMMENT",
                 "AUTO_INCREMENT", "ROW_FORMAT", "KEY_BLOCK_SIZE",
                 "CHECKSUM", "DELAY_KEY_WRITE", "MAX_ROWS", "MIN_ROWS",
                 "AVG_ROW_LENGTH", "CONNECTION", "PASSWORD",
                 "STATS_PERSISTENT", "COMPRESSION")
        while True:
            self.try_op(",")       # options may be comma-separated
            t = self.peek()
            name = t.val.upper() if t.tp in (TokenType.KEYWORD,
                                             TokenType.IDENT) else ""
            if name == "DEFAULT":
                self.next()
                name = self.peek().val.upper()
                if name == "CHARACTER":
                    self.next()
                    self.expect_kw("SET")
                    self.try_op("=")
                    stmt.options["charset"] = self.next().val
                    continue
                if name in ("CHARSET", "COLLATE"):
                    opt = self.next().val
                    self.try_op("=")
                    stmt.options[opt.lower()] = self.next().val
                    continue
                raise ParseError("expected CHARSET/COLLATE", self.peek())
            if name == "CHARACTER":
                self.next()
                self.expect_kw("SET")
                self.try_op("=")
                stmt.options["charset"] = self.next().val
                continue
            if name in _OPTS:
                self.next()
                self.try_op("=")
                stmt.options[name.lower()] = self.next().val
                continue
            if name == "PARTITION" and self.peek_word(1) == "BY":
                # partitioning clause: parsed + IGNORED (regions already
                # range-partition storage; DEVIATIONS.md)
                depth = 0
                while True:
                    t2 = self.peek()
                    if t2.tp == TokenType.EOF:
                        break
                    if t2.tp == TokenType.OP and t2.val == "(":
                        depth += 1
                    elif t2.tp == TokenType.OP and t2.val == ")":
                        depth -= 1
                    elif t2.tp == TokenType.OP and t2.val == ";" and \
                            depth == 0:
                        break
                    self.next()
                continue
            break
        return stmt

    def _index_tail_options(self) -> None:
        """Inline index definitions accept [USING ...] [COMMENT '...']."""
        while True:
            if self._index_using():
                continue
            if self.try_kw("COMMENT"):
                self.next()
                continue
            break

    def _index_using(self) -> bool:
        """[USING BTREE|HASH] — accepted; one index layout exists."""
        if self.try_kw("USING"):
            t = self.next()
            if t.val.upper() not in ("BTREE", "HASH"):
                raise ParseError("expected BTREE or HASH", t)
            return True
        return False

    def _if_not_exists(self) -> bool:
        if self.try_kw("IF"):
            self.expect_kw("NOT")
            self.expect_kw("EXISTS")
            return True
        return False

    def _paren_idents(self) -> list[str]:
        self.expect_op("(")
        out = [self.ident()]
        # ignore optional key length e.g. col(10) and ASC/DESC order
        if self.try_op("("):
            self._int_lit()
            self.expect_op(")")
        self.try_kw("ASC") or self.try_kw("DESC")
        while self.try_op(","):
            out.append(self.ident())
            if self.try_op("("):
                self._int_lit()
                self.expect_op(")")
            self.try_kw("ASC") or self.try_kw("DESC")
        self.expect_op(")")
        return out

    def column_def(self) -> ast.ColumnDef:
        name = self.ident()
        ft = self.field_type()
        d = ast.ColumnDef(name=name, ft=ft)
        if getattr(self, "_last_type_collation", None) is not None:
            d.explicit_collation = True
        flags = ft.flags
        while True:
            if self.try_kw("NOT"):
                self.expect_kw("NULL")
                flags |= st.Flag.NOT_NULL
            elif self.try_kw("NULL"):
                pass
            elif self.try_kw("DEFAULT"):
                d.default = self.expr_or_null_literal()
                d.has_default = True
            elif self.try_kw("AUTO_INCREMENT"):
                d.auto_increment = True
                flags |= st.Flag.AUTO_INCREMENT
            elif self.try_kw("PRIMARY"):
                self.expect_kw("KEY")
                d.is_primary = True
                flags |= st.Flag.PRI_KEY | st.Flag.NOT_NULL
            elif self.try_kw("UNIQUE"):
                self.try_kw("KEY")
                d.is_unique = True
                flags |= st.Flag.UNIQUE_KEY
            elif self.try_kw("KEY"):
                pass
            elif self.try_kw("COMMENT"):
                d.comment = self.next().val
            elif self.try_kw("COLLATE"):
                coll = self.next().val.lower()
                if ft.eval_type == st.EvalType.STRING:
                    import dataclasses
                    ft = dataclasses.replace(ft, collation=coll)
                    d.ft = ft
                    d.explicit_collation = True
            elif self.try_kw("CHARSET"):
                self.next()
            elif self.peek_word() == "CHARACTER" and \
                    self.peek_word(1) == "SET":
                self.next()
                self.next()
                self.next()
            elif self.try_kw("ON"):
                # ON UPDATE CURRENT_TIMESTAMP[(n)]: parsed + ignored
                # (auto-update timestamps — DEVIATIONS.md)
                self.expect_kw("UPDATE")
                self.next()
                if self.try_op("("):
                    if self.peek().tp == TokenType.INT:
                        self.next()
                    self.expect_op(")")
            elif self.try_kw("CHECK"):
                # inline CHECK constraints: parsed + IGNORED, as MySQL
                # did before 8.0.16
                self.expect_op("(")
                depth = 1
                while depth:
                    tk = self.next()
                    if tk.tp == TokenType.OP and tk.val == "(":
                        depth += 1
                    elif tk.tp == TokenType.OP and tk.val == ")":
                        depth -= 1
                    elif tk.tp == TokenType.EOF:
                        raise ParseError("unterminated CHECK", tk)
            elif self.try_kw("REFERENCES"):
                # inline column REFERENCES (incl. MATCH / ON DELETE /
                # ON UPDATE): parsed and IGNORED, exactly as MySQL does
                # (only table-level FOREIGN KEY creates the constraint)
                self.table_name()
                if self.peek().tp == TokenType.OP and \
                        self.peek().val == "(":
                    self._paren_idents()
                while True:
                    if self.peek().tp == TokenType.IDENT and \
                            self.peek().val.upper() == "MATCH":
                        self.next()
                        self.ident()
                    elif self.try_kw("ON"):
                        if not (self.try_kw("DELETE") or
                                self.try_kw("UPDATE")):
                            raise ParseError("expected DELETE or UPDATE",
                                             self.peek())
                        if not (self.try_kw("SET") and
                                self.try_kw("NULL")):
                            if self.peek().val.upper() in (
                                    "CASCADE", "RESTRICT"):
                                self.next()
                            elif self.try_kw("NOT"):
                                self.ident()   # NO ACTION spelled oddly
                            else:
                                self.ident()   # NO / ACTION words
                                if self.peek().val.upper() == "ACTION":
                                    self.next()
                    else:
                        break
            else:
                break
        d.ft = ft.with_flags(flags)
        return d

    def expr_or_null_literal(self):
        if self.try_kw("NULL"):
            return ast.Literal(None)
        return self.expr()

    def field_type(self) -> st.FieldType:
        t = self.next()
        # ENUM is deliberately NOT a reserved word (matching MySQL);
        # type names arrive as IDENT or KEYWORD alike
        if t.tp not in (TokenType.KEYWORD, TokenType.IDENT):
            raise ParseError("expected type", t)
        name = t.val.upper()
        if name == "NATIONAL":
            t = self.next()
            name = t.val.upper()          # national char/varchar
        _SYNONYMS = {"INT1": "TINYINT", "INT2": "SMALLINT",
                     "INT3": "MEDIUMINT", "INT4": "INT",
                     "INT8": "BIGINT", "MIDDLEINT": "MEDIUMINT",
                     "DEC": "DECIMAL", "FIXED": "DECIMAL",
                     "NCHAR": "CHAR", "NVARCHAR": "VARCHAR",
                     "SERIAL": "BIGINT"}
        name = _SYNONYMS.get(name, name)
        if name in ("ENUM", "SET"):
            # ENUM('a','b',...) / SET('a','b',...)
            self.expect_op("(")
            elems = [self._str_lit()]
            while self.try_op(","):
                elems.append(self._str_lit())
            self.expect_op(")")
            TC = st.TypeCode
            return st.FieldType(TC.ENUM if name == "ENUM" else TC.SET,
                                elems=tuple(elems))
        # two-word type names are consumed up front, before length/flags
        if name == "DOUBLE":
            self.try_kw("PRECISION")
        if name == "CHAR":
            self.try_kw("VARYING")
        flen, frac = -1, -1
        if self.try_op("("):
            flen = self._int_lit()
            if self.try_op(","):
                frac = self._int_lit()
            self.expect_op(")")
        flags = 0
        collation = None
        while True:
            if self.try_kw("UNSIGNED"):
                flags |= st.Flag.UNSIGNED
            elif self.try_kw("SIGNED") or self.try_kw("ZEROFILL"):
                pass
            elif self.try_word("BINARY"):
                pass   # binary attribute == the default _bin collation
            elif self.peek_word() == "CHARACTER" and \
                    self.peek_word(1) == "SET":
                self.next()
                self.next()
                self.next()               # charset name: accepted, fixed
            elif self.try_kw("CHARSET"):
                self.next()
            elif self.try_kw("COLLATE"):
                collation = self.next().val.lower()
            else:
                break
        TC = st.TypeCode
        mapping = {
            "INT": TC.LONG, "INTEGER": TC.LONG, "BIGINT": TC.LONGLONG,
            "SMALLINT": TC.SHORT, "TINYINT": TC.TINY, "MEDIUMINT": TC.INT24,
            "BOOL": TC.TINY, "BOOLEAN": TC.TINY,
            "FLOAT": TC.FLOAT, "DOUBLE": TC.DOUBLE, "REAL": TC.DOUBLE,
            "DECIMAL": TC.NEWDECIMAL, "NUMERIC": TC.NEWDECIMAL,
            "CHAR": TC.STRING, "VARCHAR": TC.VARCHAR, "TEXT": TC.BLOB,
            "BLOB": TC.BLOB, "BINARY": TC.STRING, "VARBINARY": TC.VARCHAR,
            "TINYTEXT": TC.BLOB, "MEDIUMTEXT": TC.BLOB,
            "LONGTEXT": TC.BLOB, "TINYBLOB": TC.BLOB,
            "MEDIUMBLOB": TC.BLOB, "LONGBLOB": TC.BLOB,
            "BIT": TC.TINY,
            "DATE": TC.DATE, "DATETIME": TC.DATETIME,
            "TIMESTAMP": TC.TIMESTAMP, "TIME": TC.DURATION,
            "YEAR": TC.YEAR, "JSON": TC.JSON,
        }
        if name not in mapping:
            raise ParseError(f"unsupported type {name}", t)
        tp = mapping[name]
        if tp == TC.NEWDECIMAL:
            if flen < 0:
                flen = 10
            if frac < 0:
                frac = 0
        ft = st.FieldType(tp, flags=flags, flen=flen, frac=frac)
        if collation is not None and \
                ft.eval_type == st.EvalType.STRING:
            import dataclasses
            ft = dataclasses.replace(ft, collation=collation)
        # column_def checks this to mark an explicit column collation
        self._last_type_collation = collation
        return ft

    # -- account management (ref: parser.y GrantStmt/CreateUserStmt) --------

    def _user_spec(self, with_password: bool = False) -> ast.UserSpec:
        """'name'[@'host'] [IDENTIFIED BY 'pw'] — name/host accept quoted
        strings or bare identifiers."""
        t = self.peek()
        if t.tp == TokenType.STRING:
            self.next()
            name = t.val
        else:
            name = self.ident()
        host = "%"
        if self.try_op("@"):
            t = self.peek()
            if t.tp == TokenType.STRING:
                self.next()
                host = t.val
            else:
                host = self.ident()
        spec = ast.UserSpec(user=name, host=host)
        if with_password and self.try_kw("IDENTIFIED"):
            self.expect_kw("BY")
            t = self.next()
            if t.tp != TokenType.STRING:
                raise ParseError("IDENTIFIED BY takes a string literal", t)
            spec.password = t.val
        return spec

    _PRIV_NAMES = {"SELECT", "INSERT", "UPDATE", "DELETE", "CREATE", "DROP",
                   "ALTER", "INDEX", "SUPER"}

    def grant_revoke(self, is_grant: bool) -> ast.StmtNode:
        self.next()          # GRANT / REVOKE
        privs = []
        if self.try_kw("ALL"):
            self.try_kw("PRIVILEGES")
            privs.append("ALL")
        else:
            while True:
                t = self.next()
                name = t.val.upper()
                if name == "CREATE" and self.peek_word() == "USER":
                    self.next()
                    name = "CREATE USER"
                elif name == "GRANT" and self.peek_word() == "OPTION":
                    self.next()
                    name = "GRANT"
                elif name not in self._PRIV_NAMES:
                    raise ParseError(f"unknown privilege {t.val!r}", t)
                privs.append(name)
                if not self.try_op(","):
                    break
        self.expect_kw("ON")
        # *.* (global) | * (current db) | db.* | db.tbl | tbl
        if self.try_op("*"):
            if self.try_op("."):
                self.expect_op("*")
                db = tbl = "*"           # *.*: global scope
            else:
                db, tbl = "", "*"        # bare *: current database (MySQL)
        else:
            first = self.ident()
            if self.try_op("."):
                db = first
                if self.try_op("*"):
                    tbl = "*"
                else:
                    tbl = self.ident()
            else:
                db, tbl = "", first      # current db at execution time
        self.expect_kw("TO" if is_grant else "FROM")
        users = [self._user_spec()]
        while self.try_op(","):
            users.append(self._user_spec())
        if is_grant and self.try_kw("WITH"):
            # WITH GRANT OPTION == granting the GRANT privilege bit
            self.expect_kw("GRANT")
            self.expect_kw("OPTION")
            privs.append("GRANT")
        cls = ast.GrantStmt if is_grant else ast.RevokeStmt
        return cls(privs=privs, db=db, table=tbl, users=users)

    def drop(self) -> ast.StmtNode:
        self.expect_kw("DROP")
        if self.try_kw("USER"):
            ie = self._if_exists()
            users = [self._user_spec()]
            while self.try_op(","):
                users.append(self._user_spec())
            return ast.DropUserStmt(users=users, if_exists=ie)
        if self.try_kw("DATABASE") or self.try_kw("SCHEMA"):
            ie = self._if_exists()
            return ast.DropDatabaseStmt(name=self.ident(), if_exists=ie)
        if self.try_kw("INDEX"):
            name = self.ident()
            self.expect_kw("ON")
            return ast.DropIndexStmt(index_name=name,
                                     table=self.table_name())
        if self.try_word("VIEW"):
            # views don't exist here: DROP VIEW IF EXISTS is the common
            # migration-script form — accept it as a no-op; plain DROP
            # VIEW on a missing view errors like MySQL
            ie = self._if_exists()
            tables = [self.table_name()]
            while self.try_op(","):
                tables.append(self.table_name())
            return ast.DropViewStmt(tables=tables, if_exists=ie)
        if self.try_word("STATS"):
            return ast.DropStatsStmt(table=self.table_name())
        if not (self.try_kw("TABLE") or self.try_word("TABLES")):
            raise ParseError("expected TABLE", self.peek())
        ie = self._if_exists()
        tables = [self.table_name()]
        while self.try_op(","):
            tables.append(self.table_name())
        return ast.DropTableStmt(tables=tables, if_exists=ie)

    def _if_exists(self) -> bool:
        if self.try_kw("IF"):
            self.expect_kw("EXISTS")
            return True
        return False

    def alter(self) -> ast.AlterTableStmt:
        self.expect_kw("ALTER")
        self.expect_kw("TABLE")
        stmt = ast.AlterTableStmt(table=self.table_name())
        while True:
            stmt.specs.append(self.alter_spec())
            if not self.try_op(","):
                break
        return stmt

    def alter_spec(self) -> ast.AlterSpec:
        if self.try_kw("ADD"):
            self.try_word("FULLTEXT")   # fulltext layout: plain index here
            if self.try_kw("INDEX") or self.try_kw("KEY"):
                name = "" if self.peek().val == "(" else self.ident()
                spec = ast.AlterSpec(tp="add_index", index=ast.IndexDef(
                    name=name, columns=self._paren_idents()))
                self._index_tail_options()
                return spec
            if self.try_kw("UNIQUE"):
                self.try_kw("INDEX") or self.try_kw("KEY")
                name = "" if self.peek().val == "(" else self.ident()
                spec = ast.AlterSpec(tp="add_index", index=ast.IndexDef(
                    name=name, columns=self._paren_idents(), unique=True))
                self._index_tail_options()
                return spec
            if self.try_kw("PRIMARY"):
                self.expect_kw("KEY")
                spec = ast.AlterSpec(tp="add_index", index=ast.IndexDef(
                    name="PRIMARY", columns=self._paren_idents(),
                    unique=True, primary=True))
                self._index_tail_options()
                return spec
            self.try_kw("COLUMN")
            if self.peek().tp == TokenType.OP and self.peek().val == "(":
                # ADD COLUMN (a INT, b VARCHAR(10)): multi-column form
                self.next()
                cols = [self.column_def()]
                while self.try_op(","):
                    cols.append(self.column_def())
                self.expect_op(")")
                return ast.AlterSpec(tp="add_columns", columns=cols)
            spec = ast.AlterSpec(tp="add_column", column=self.column_def())
            if self.try_kw("FIRST"):
                spec.position = "first"
            elif self.try_kw("AFTER"):
                spec.position = "after"
                spec.after_col = self.ident()
            return spec
        if self.try_kw("DROP"):
            if self.try_kw("INDEX") or self.try_kw("KEY"):
                return ast.AlterSpec(tp="drop_index", name=self.ident())
            if self.try_kw("PRIMARY"):
                self.expect_kw("KEY")
                return ast.AlterSpec(tp="drop_index", name="PRIMARY")
            self.try_kw("COLUMN")
            return ast.AlterSpec(tp="drop_column", name=self.ident())
        if self.try_kw("MODIFY"):
            self.try_kw("COLUMN")
            return ast.AlterSpec(tp="modify_column", column=self.column_def())
        if self.try_kw("CHANGE"):
            self.try_kw("COLUMN")
            old = self.ident()
            spec = ast.AlterSpec(tp="change_column",
                                 column=self.column_def())
            spec.name = old
            if self.try_kw("FIRST"):
                spec.position = "first"
            elif self.try_kw("AFTER"):
                spec.position = "after"
                spec.after_col = self.ident()
            return spec
        if self.try_kw("ALTER"):
            # ALTER [COLUMN] a SET DEFAULT v | DROP DEFAULT
            self.try_kw("COLUMN")
            col = self.ident()
            if self.try_kw("SET"):
                self.expect_kw("DEFAULT")
                return ast.AlterSpec(tp="set_default", name=col,
                                     default=self.expr())
            self.expect_kw("DROP")
            self.expect_kw("DEFAULT")
            return ast.AlterSpec(tp="drop_default", name=col)
        if self.try_kw("RENAME"):
            self.try_kw("TO") or self.try_kw("AS")
            tn = self.table_name()
            return ast.AlterSpec(tp="rename", name=tn.name,
                                 new_db=tn.db)
        if self.try_word("DISABLE") or self.try_word("ENABLE"):
            # DISABLE/ENABLE KEYS: MyISAM bulk-load hint, no-op here
            self.expect_word("KEYS")
            return ast.AlterSpec(tp="noop")
        word = self.peek_word()
        if word in ("LOCK", "ALGORITHM"):
            # online-DDL hints: LOCK=NONE|DEFAULT|SHARED|EXCLUSIVE,
            # ALGORITHM=INPLACE|COPY|DEFAULT — accepted; this DDL is
            # always online (F1 states), so the hints are no-ops
            self.next()
            self.try_op("=")
            self.next()
            return ast.AlterSpec(tp="noop")
        if word == "DEFAULT" and self.peek_word(1) in (
                "COLLATE", "CHARSET", "CHARACTER"):
            self.next()
            word = self.peek_word()
        if word in ("ENGINE", "COMMENT", "COLLATE", "CHARSET",
                    "ROW_FORMAT", "KEY_BLOCK_SIZE", "CHECKSUM",
                    "AUTO_INCREMENT", "DELAY_KEY_WRITE"):
            # ALTER-time table options: accepted + ignored (no storage
            # engines / formats to switch)
            self.next()
            self.try_op("=")
            self.next()
            return ast.AlterSpec(tp="noop")
        if word == "CHARACTER" and self.peek_word(1) == "SET":
            self.next()
            self.next()
            self.try_op("=")
            self.next()
            return ast.AlterSpec(tp="noop")
        raise ParseError("unsupported ALTER spec", self.peek())

    def rename(self) -> ast.RenameTableStmt:
        self.expect_kw("RENAME")
        self.expect_kw("TABLE")
        pairs = []
        while True:
            old = self.table_name()
            self.expect_kw("TO")
            pairs.append((old, self.table_name()))
            if not self.try_op(","):
                break
        return ast.RenameTableStmt(pairs=pairs)

    # -- SET / SHOW ----------------------------------------------------------

    def set_stmt(self) -> ast.SetStmt:
        self.expect_kw("SET")
        stmt = ast.SetStmt()
        # client-preamble forms: SET NAMES cs [COLLATE c] / SET CHARACTER
        # SET cs — recorded as plain session sysvars
        if self.peek().tp == TokenType.IDENT and \
                self.peek().val.upper() == "NAMES":
            self.next()
            cs = self.ident() if self.peek().tp != TokenType.STRING \
                else self.next().val
            if self.try_kw("COLLATE"):
                self.ident()
            for n in ("character_set_client", "character_set_results",
                      "character_set_connection"):
                stmt.assignments.append(ast.VarAssignment(
                    name=n, is_system=True, value=ast.Literal(cs)))
            return stmt
        if self.peek().tp in (TokenType.IDENT, TokenType.KEYWORD) and \
                self.peek().val.upper() == "CHARACTER":
            self.next()
            self.expect_kw("SET")
            cs = self.ident() if self.peek().tp != TokenType.STRING \
                else self.next().val
            stmt.assignments.append(ast.VarAssignment(
                name="character_set_client", is_system=True,
                value=ast.Literal(cs)))
            return stmt
        if self.peek().val.upper() == "PASSWORD" and \
                self.peek().tp in (TokenType.IDENT, TokenType.KEYWORD):
            # SET PASSWORD [FOR user] = 'pw'
            self.next()
            user = None
            if self.try_kw("FOR"):
                user = self._user_spec()
            self.expect_op("=")
            t = self.next()
            if t.tp != TokenType.STRING:
                raise ParseError("SET PASSWORD takes a string", t)
            return ast.SetPasswordStmt(user=user, password=t.val)
        if self.peek().val.upper() == "TRANSACTION" or (
                self.peek().val.upper() in ("SESSION", "GLOBAL", "LOCAL")
                and self.peek(1).val.upper() == "TRANSACTION"):
            # SET [SESSION|GLOBAL] TRANSACTION ISOLATION LEVEL ... /
            # READ ONLY|WRITE — mapped onto the isolation sysvars
            is_global = False
            if self.peek().val.upper() in ("SESSION", "GLOBAL", "LOCAL"):
                is_global = self.next().val.upper() == "GLOBAL"
            self.next()                    # TRANSACTION
            if self.try_word("READ"):
                t = self.next()            # ONLY | WRITE
                if t.val.upper() not in ("ONLY", "WRITE"):
                    raise ParseError("expected ONLY or WRITE", t)
                stmt.assignments.append(ast.VarAssignment(
                    name="transaction_read_only", is_system=True,
                    is_global=is_global,
                    value=ast.Literal(1 if t.val.upper() == "ONLY"
                                      else 0)))
                return stmt
            self.expect_word("ISOLATION")
            self.expect_word("LEVEL")
            words = [self.next().val.upper()]
            if words[0] in ("READ", "REPEATABLE"):
                words.append(self.next().val.upper())
            level = " ".join(words)
            if level not in ("READ UNCOMMITTED", "READ COMMITTED",
                             "REPEATABLE READ", "SERIALIZABLE"):
                raise ParseError(f"bad isolation level {level}",
                                 self.peek())
            stmt.assignments.append(ast.VarAssignment(
                name="tx_isolation", is_system=True, is_global=is_global,
                value=ast.Literal(level.replace(" ", "-"))))
            return stmt
        while True:
            va = ast.VarAssignment(name="")
            if self.try_kw("GLOBAL"):
                va.is_global = True
                va.is_system = True
                va.name = self.ident()
            elif self.try_kw("SESSION") or self.try_word("LOCAL"):
                va.is_system = True
                va.name = self.ident()
            elif self.try_op("@"):
                if self.try_op("@"):
                    va.is_system = True
                    # @@global.x / @@session.x / @@local.x / @@x
                    nm = self.ident()
                    if nm in ("global", "session", "local") and \
                            self.try_op("."):
                        va.is_global = nm == "global"
                        nm = self.ident()
                    va.name = nm
                else:
                    va.name = "@" + self.ident()
            else:
                va.is_system = True
                va.name = self.ident()
            if not (self.try_op("=") or self.try_op(":=")):
                raise ParseError("expected =", self.peek())
            va.value = self.expr()
            stmt.assignments.append(va)
            if not self.try_op(","):
                return stmt

    def show(self) -> ast.ShowStmt:
        self.expect_kw("SHOW")
        s = ast.ShowStmt()
        if self.try_kw("GLOBAL"):
            s.is_global = True
        else:
            self.try_kw("SESSION")
        s.full = self.try_kw("FULL")
        if self.try_kw("DATABASES") or self.try_kw("SCHEMA"):
            s.tp = "databases"
        elif self.try_kw("TABLES"):
            s.tp = "tables"
            if self.try_kw("FROM"):
                s.db = self.ident()
        elif self.try_kw("CREATE"):
            self.expect_kw("TABLE")
            s.tp = "create_table"
            s.table = self.table_name()
        elif self.try_kw("COLUMNS") or self.try_kw("FIELDS"):
            s.tp = "columns"
            if not (self.try_kw("FROM") or self.try_kw("IN")):
                raise ParseError("expected FROM", self.peek())
            s.table = self.table_name()
        elif self.try_kw("INDEX", "KEY"):
            s.tp = "index"
            self.try_kw("FROM", "IN")
            s.table = self.table_name()
        elif self.peek().tp == TokenType.IDENT and \
                self.peek().val.upper() in ("INDEXES", "KEYS"):
            self.next()
            s.tp = "index"
            self.try_kw("FROM", "IN")
            s.table = self.table_name()
        elif self.peek().tp == TokenType.IDENT and \
                self.peek().val.upper() == "GRANTS":
            self.next()
            s.tp = "grants"
            if self.try_kw("FOR"):
                if self.peek().val.upper() == "CURRENT_USER":
                    self.next()
                    if self.try_op("("):
                        self.expect_op(")")
                else:
                    spec = self._user_spec()
                    s.pattern = f"{spec.user}@{spec.host}"
        elif self.try_kw("VARIABLES"):
            s.tp = "variables"
        elif self.peek().tp == TokenType.IDENT and \
                self.peek().val.upper() == "PROCESSLIST":
            self.next()
            s.tp = "processlist"
        elif self.try_kw("STATUS"):
            s.tp = "status"
        elif self.try_kw("ENGINES"):
            s.tp = "engines"
        elif self.try_kw("COLLATION"):
            s.tp = "collation"
        elif self.peek_word() == "CHARACTER" and \
                self.peek_word(1) == "SET":
            self.next()
            self.next()
            s.tp = "charset"
        elif self.try_kw("CHARSET"):
            s.tp = "charset"
        elif self.peek_word() in ("STATS_META", "STATS_HISTOGRAMS",
                                  "STATS_BUCKETS"):
            s.tp = self.next().val.lower()
        elif self.peek_word() in ("WARNINGS", "ERRORS", "PLUGINS",
                                  "PROFILES", "TRIGGERS", "EVENTS",
                                  "MASTER"):
            word = self.next().val.lower()
            if word == "master":
                self.expect_kw("STATUS")
                word = "master_status"
            s.tp = word
        elif self.peek_word() in ("PROCEDURE", "FUNCTION") and \
                self.peek(1).is_kw("STATUS"):
            w = self.next().val.lower()
            self.next()
            s.tp = f"{w}_status"
        else:
            raise ParseError("unsupported SHOW", self.peek())
        if self.try_kw("LIKE"):
            t = self.next()
            s.pattern = t.val
        elif self.try_kw("WHERE"):
            s.where = self.expr()
        return s

    # -- expressions (Pratt-ish precedence ladder) --------------------------

    def expr(self) -> ast.ExprNode:
        self.depth += 1
        if self.depth > MAX_EXPR_DEPTH:
            raise ParseError("expression too deeply nested", self.peek())
        try:
            return self.or_expr()
        finally:
            self.depth -= 1

    def or_expr(self):
        left = self.xor_expr()
        while True:
            if self.try_kw("OR") or self.try_op("||"):
                left = ast.BinaryOp("OR", left, self.xor_expr())
            else:
                return left

    def xor_expr(self):
        left = self.and_expr()
        while self.try_kw("XOR"):
            left = ast.BinaryOp("XOR", left, self.and_expr())
        return left

    def and_expr(self):
        left = self.not_expr()
        while True:
            if self.try_kw("AND") or self.try_op("&&"):
                left = ast.BinaryOp("AND", left, self.not_expr())
            else:
                return left

    def not_expr(self):
        if self.try_kw("NOT"):
            return ast.UnaryOp("NOT", self.not_expr())
        return self.predicate()

    def predicate(self):
        left = self.bit_or_expr()
        while True:
            t = self.peek()
            if t.tp == TokenType.OP and t.val in _CMP_OPS:
                self.next()
                qt = self.peek()
                if qt.tp in (TokenType.IDENT, TokenType.KEYWORD) and \
                        qt.val.upper() in ("ANY", "SOME", "ALL") and \
                        self.peek(1).tp == TokenType.OP and \
                        self.peek(1).val == "(":
                    if t.val == "<=>":
                        raise ParseError(
                            "<=> cannot be quantified with ANY/ALL", t)
                    self.next()
                    self.expect_op("(")
                    sub = self.select_or_union()
                    self.expect_op(")")
                    left = ast.QuantSubquery(
                        expr=left, op=t.val,
                        quant="all" if qt.val.upper() == "ALL" else "any",
                        select=sub)
                    continue
                left = ast.BinaryOp(t.val, left, self.bit_or_expr())
                continue
            if t.is_kw("IS"):
                self.next()
                neg = self.try_kw("NOT")
                if self.try_kw("NULL"):
                    left = ast.IsNullExpr(expr=left, negated=neg)
                elif self.try_kw("TRUE"):
                    # null-safe desugar: x IS TRUE == IFNULL(x,0) <> 0
                    # (a plain '= 1' would yield NULL for NULL, not 0)
                    e = ast.BinaryOp("<>", ast.FuncCall(
                        name="IFNULL", args=[left, ast.Literal(0)]),
                        ast.Literal(0))
                    left = ast.UnaryOp("NOT", e) if neg else e
                elif self.try_kw("FALSE"):
                    # x IS FALSE == IFNULL(x,1) = 0
                    e = ast.BinaryOp("=", ast.FuncCall(
                        name="IFNULL", args=[left, ast.Literal(1)]),
                        ast.Literal(0))
                    left = ast.UnaryOp("NOT", e) if neg else e
                else:
                    raise ParseError("expected NULL/TRUE/FALSE", self.peek())
                continue
            neg = False
            j = self.i
            if t.is_kw("NOT"):
                self.next()
                neg = True
                t = self.peek()
            if t.is_kw("IN"):
                self.next()
                self.expect_op("(")
                if self.peek().is_kw("SELECT"):
                    sub = self.select_or_union()
                    self.expect_op(")")
                    left = ast.InExpr(expr=left,
                                      items=ast.SubqueryExpr(select=sub),
                                      negated=neg)
                else:
                    items = [self.expr()]
                    while self.try_op(","):
                        items.append(self.expr())
                    self.expect_op(")")
                    left = ast.InExpr(expr=left, items=items, negated=neg)
                continue
            if t.is_kw("BETWEEN"):
                self.next()
                low = self.bit_or_expr()
                self.expect_kw("AND")
                high = self.bit_or_expr()
                left = ast.BetweenExpr(expr=left, low=low, high=high,
                                       negated=neg)
                continue
            if t.is_kw("LIKE"):
                self.next()
                pat = self.bit_or_expr()
                esc = "\\"
                if self.try_word("ESCAPE"):
                    et = self.next()
                    if et.tp != TokenType.STRING or len(et.val) > 1:
                        raise ParseError(
                            "ESCAPE must be a one-character string", et)
                    esc = et.val
                left = ast.LikeExpr(expr=left, pattern=pat, negated=neg,
                                    escape=esc)
                continue
            if t.tp in (TokenType.IDENT, TokenType.KEYWORD) and \
                    t.val.upper() in ("REGEXP", "RLIKE"):
                self.next()
                fc = ast.FuncCall(name="REGEXP_LIKE",
                                  args=[left, self.bit_or_expr()])
                left = ast.UnaryOp("NOT", fc) if neg else fc
                continue
            if neg:
                self.i = j  # lone NOT belongs to a higher level
            return left

    def bit_or_expr(self):
        left = self.bit_and_expr()
        while self.peek().tp == TokenType.OP and self.peek().val == "|":
            self.next()
            left = ast.BinaryOp("|", left, self.bit_and_expr())
        return left

    def bit_and_expr(self):
        left = self.shift_expr()
        while self.peek().tp == TokenType.OP and self.peek().val == "&":
            self.next()
            left = ast.BinaryOp("&", left, self.shift_expr())
        return left

    def shift_expr(self):
        left = self.add_expr()
        while self.peek().tp == TokenType.OP and self.peek().val in ("<<", ">>"):
            op = self.next().val
            left = ast.BinaryOp(op, left, self.add_expr())
        return left

    def add_expr(self):
        left = self.mul_expr()
        while self.peek().tp == TokenType.OP and self.peek().val in ("+", "-"):
            op = self.next().val
            if self.peek().is_kw("INTERVAL"):
                # expr +/- INTERVAL n UNIT (TPC-H date arithmetic)
                self.next()
                left = ast.FuncCall(
                    name="DATE_SUB" if op == "-" else "DATE_ADD",
                    args=[left, self._interval_expr()])
                continue
            left = ast.BinaryOp(op, left, self.mul_expr())
        return left

    def mul_expr(self):
        left = self.bitxor_expr()
        while True:
            t = self.peek()
            if t.tp == TokenType.OP and t.val in ("*", "/", "%"):
                self.next()
                left = ast.BinaryOp(t.val, left, self.bitxor_expr())
            elif t.is_kw("DIV") or t.is_kw("MOD"):
                self.next()
                left = ast.BinaryOp(t.val, left, self.bitxor_expr())
            else:
                return left

    def bitxor_expr(self):
        # bitwise ^ binds tighter than * (MySQL precedence), unlike | and &
        left = self.unary_expr()
        while self.peek().tp == TokenType.OP and self.peek().val == "^":
            self.next()
            left = ast.BinaryOp("^", left, self.unary_expr())
        return left

    def unary_expr(self):
        t = self.peek()
        if t.is_kw("BINARY") and not (
                self.peek(1).tp == TokenType.OP and
                self.peek(1).val in (")", ",")):
            # BINARY expr: collation cast — a no-op here, comparisons
            # are utf8_bin everywhere (docs/DEVIATIONS.md)
            self.next()
            return self.unary_expr()
        if t.tp == TokenType.OP and t.val in ("-", "+", "~", "!"):
            self.next()
            if t.val == "+":
                return self.unary_expr()
            if t.val == "!":
                return ast.UnaryOp("NOT", self.unary_expr())
            return ast.UnaryOp(t.val, self.unary_expr())
        return self.primary()

    def primary(self) -> ast.ExprNode:
        t = self.peek()
        if t.tp == TokenType.INT:
            self.next()
            return ast.Literal(int(t.val))
        if t.tp == TokenType.DECIMAL:
            self.next()
            return ast.Literal(decimal.Decimal(t.val))
        if t.tp == TokenType.FLOAT:
            self.next()
            return ast.Literal(float(t.val))
        if t.tp == TokenType.STRING:
            self.next()
            return ast.Literal(t.val)
        if t.tp == TokenType.OP and t.val == "(":
            self.next()
            if self.peek().is_kw("SELECT"):
                sub = self.select_or_union()
                self.expect_op(")")
                return ast.SubqueryExpr(select=sub)
            e = self.expr()
            if self.try_op(","):
                items = [e, self.expr()]
                while self.try_op(","):
                    items.append(self.expr())
                self.expect_op(")")
                return ast.RowExpr(items=items)
            self.expect_op(")")
            return e
        if t.tp == TokenType.OP and t.val == "@":
            self.next()
            if self.try_op("@"):
                nm = self.ident()
                is_global = False
                if nm in ("global", "session") and self.try_op("."):
                    is_global = nm == "global"
                    nm = self.ident()
                return ast.VariableExpr(name=nm, is_global=is_global,
                                        is_system=True)
            nm = self.ident()
            if self.try_op(":="):
                # @v := expr — assignment in expression position; MySQL
                # gives := the lowest precedence, so take a full expr
                return ast.VarAssignExpr(name=nm, value=self.expr())
            return ast.VariableExpr(name=nm)
        if t.tp == TokenType.OP and t.val == "?":
            self.next()
            return ast.ParamMarker()
        if t.tp == TokenType.KEYWORD:
            return self._keyword_primary(t)
        if t.tp == TokenType.IDENT:
            return self._ident_primary()
        raise ParseError("expected expression", t)

    def _keyword_primary(self, t: Token) -> ast.ExprNode:
        kw = t.val
        if kw == "NULL":
            self.next()
            return ast.Literal(None)
        if kw == "TRUE":
            self.next()
            return ast.Literal(1)
        if kw == "FALSE":
            self.next()
            return ast.Literal(0)
        if kw == "CASE":
            return self.case_expr()
        if kw in ("CAST", "CONVERT"):
            self.next()
            self.expect_op("(")
            e = self.expr()
            if kw == "CAST":
                self.expect_kw("AS")
                ft = self.cast_type()
            else:
                self.expect_op(",")
                ft = self.cast_type()
            self.expect_op(")")
            return ast.CastExpr(expr=e, ft=ft)
        if kw == "EXISTS":
            self.next()
            self.expect_op("(")
            sub = self.select_or_union()
            self.expect_op(")")
            return ast.ExistsSubquery(select=sub)
        if kw == "INTERVAL":
            if self.peek(1).tp == TokenType.OP and self.peek(1).val == "(":
                # INTERVAL(n, a1, a2, ...) — the compare function
                self.next()
                return self.func_call(kw)
            # INTERVAL n DAY — only inside date_add/sub handled there
            raise ParseError("INTERVAL outside date arithmetic", t)
        if kw in ("IF", "IFNULL", "COALESCE", "NULLIF", "REPLACE", "LEFT",
                  "RIGHT", "YEAR", "DATE", "TIME", "DEFAULT", "DATABASE",
                  "CHARSET", "MOD", "TRUNCATE"):
            # keyword-named functions
            if self.peek(1).tp == TokenType.OP and self.peek(1).val == "(":
                self.next()
                return self.func_call(kw)
        if kw in ("DISTINCT",):
            raise ParseError("unexpected DISTINCT", t)
        if kw in ("DATE", "TIMESTAMP", "TIME") and \
                self.peek(1).tp == TokenType.STRING:
            # typed literal: DATE '1998-12-01'
            self.next()
            return ast.Literal(self.next().val)
        return self._ident_primary()

    def case_expr(self) -> ast.CaseExpr:
        self.expect_kw("CASE")
        operand = None
        if not self.peek().is_kw("WHEN"):
            operand = self.expr()
        whens = []
        while self.try_kw("WHEN"):
            c = self.expr()
            self.expect_kw("THEN")
            whens.append((c, self.expr()))
        els = None
        if self.try_kw("ELSE"):
            els = self.expr()
        self.expect_kw("END")
        return ast.CaseExpr(operand=operand, when_clauses=whens,
                            else_clause=els)

    def cast_type(self) -> st.FieldType:
        t = self.next()
        name = t.val
        TC = st.TypeCode
        flen = frac = -1
        if self.try_op("("):
            flen = self._int_lit()
            if self.try_op(","):
                frac = self._int_lit()
            self.expect_op(")")
        if name in ("SIGNED", "INT", "INTEGER"):
            self.try_kw("INTEGER") or self.try_kw("INT")
            return st.new_int_field()
        if name == "UNSIGNED":
            self.try_kw("INTEGER") or self.try_kw("INT")
            return st.new_uint_field()
        if name in ("DECIMAL", "NUMERIC"):
            return st.new_decimal_field(flen if flen > 0 else 10,
                                        frac if frac >= 0 else 0)
        if name in ("CHAR", "BINARY"):
            if self.peek_word() == "CHARACTER" and \
                    self.peek_word(1) == "SET":
                self.next()
                self.next()
                self.next()        # charset name: accepted, fixed utf8
            return st.new_string_field(flen if flen > 0 else 255)
        if name in ("DOUBLE", "REAL", "FLOAT"):
            return st.new_double_field()
        if name == "DATE":
            return st.new_date_field()
        if name == "DATETIME":
            return st.new_datetime_field()
        if name == "TIME":
            return st.new_duration_field()
        if name == "JSON":
            return st.FieldType(TC.JSON)
        raise ParseError(f"unsupported cast type {name}", t)

    def _ident_primary(self) -> ast.ExprNode:
        name = self.ident()
        # function call?
        if self.peek().tp == TokenType.OP and self.peek().val == "(":
            return self.func_call(name.upper())
        # qualified column
        if self.try_op("."):
            b = self.ident()
            if self.try_op("."):
                return ast.ColName(name=self.ident(), table=b, db=name)
            return ast.ColName(name=b, table=name)
        return ast.ColName(name=name)

    def func_call(self, name: str) -> ast.ExprNode:
        self.expect_op("(")
        if name == "EXTRACT":
            # EXTRACT(unit FROM e) desugars to the field functions
            return self._extract_expr()
        if name in ("SUBSTRING", "SUBSTR", "MID"):
            # SUBSTRING(s FROM pos [FOR len]) == SUBSTRING(s, pos[, len])
            first = self.expr()
            args = [first]
            if self.try_kw("FROM"):
                args.append(self.expr())
                if self.try_kw("FOR"):
                    args.append(self.expr())
            else:
                while self.try_op(","):
                    args.append(self.expr())
            self.expect_op(")")
            return ast.FuncCall(name="SUBSTRING", args=args)
        if name == "GET_FORMAT":
            # first argument is a bare DATE/TIME/DATETIME/TIMESTAMP word
            ut = self.next()
            if ut.tp not in (TokenType.IDENT, TokenType.KEYWORD):
                raise ParseError("expected DATE/TIME/DATETIME", ut)
            self.expect_op(",")
            loc = self.expr()
            self.expect_op(")")
            return ast.FuncCall(name="GET_FORMAT",
                                args=[ast.Literal(ut.val.upper()), loc])
        if name in ("TIMESTAMPDIFF", "TIMESTAMPADD"):
            # first argument is a bare unit word, not an expression
            ut = self.next()
            if ut.tp not in (TokenType.IDENT, TokenType.KEYWORD):
                raise ParseError("expected time unit", ut)
            unit = ut.val.upper()
            self.expect_op(",")
            a1 = self.expr()
            self.expect_op(",")
            a2 = self.expr()
            self.expect_op(")")
            if name == "TIMESTAMPADD":
                return ast.FuncCall(name="DATE_ADD", args=[
                    a2, ast.FuncCall(name="INTERVAL",
                                     args=[a1, ast.Literal(unit)])])
            return ast.FuncCall(name="TIMESTAMPDIFF",
                                args=[ast.Literal(unit), a1, a2])
        if name in _AGG_FUNCS:
            distinct = self.try_kw("DISTINCT")
            if self.try_op("*"):
                self.expect_op(")")
                return ast.AggregateCall(name=name, star=True)
            args = [self.expr()]
            while self.try_op(","):
                args.append(self.expr())
            sep = ","
            if name == "GROUP_CONCAT" and \
                    self.peek().tp == TokenType.IDENT and \
                    self.peek().val.upper() == "SEPARATOR":
                self.next()
                sep = self._str_lit()
            self.expect_op(")")
            return ast.AggregateCall(name=name, args=args,
                                     distinct=distinct, sep=sep)
        args = []
        if not self.try_op(")"):
            # DATE_ADD(d, INTERVAL n DAY)
            while True:
                if self.peek().is_kw("INTERVAL") and not (
                        self.peek(1).tp == TokenType.OP and
                        self.peek(1).val == "("):
                    # DATE_ADD(d, INTERVAL n DAY); INTERVAL( stays the
                    # compare function and parses as a normal expr
                    self.next()
                    args.append(self._interval_expr())
                else:
                    args.append(self.expr())
                if not self.try_op(","):
                    break
            self.expect_op(")")
        return ast.FuncCall(name=name, args=args)

    def _extract_expr(self) -> ast.ExprNode:
        ut = self.next()
        if ut.tp not in (TokenType.IDENT, TokenType.KEYWORD):
            raise ParseError("expected time unit", ut)
        unit = ut.val.upper()
        self.expect_kw("FROM")
        e = self.expr()
        self.expect_op(")")
        if unit in ("YEAR", "MONTH", "DAY", "HOUR", "MINUTE", "SECOND",
                    "WEEK", "QUARTER", "MICROSECOND"):
            return ast.FuncCall(name=unit, args=[e])
        if unit == "YEAR_MONTH":
            return ast.BinaryOp("+", ast.BinaryOp(
                "*", ast.FuncCall(name="YEAR", args=[e]),
                ast.Literal(100)), ast.FuncCall(name="MONTH", args=[e]))
        raise ParseError(f"unsupported EXTRACT unit {unit}", ut)

    def _interval_expr(self) -> ast.FuncCall:
        """`n UNIT` after a consumed INTERVAL keyword."""
        n = self.expr()
        unit = self.ident().upper()
        return ast.FuncCall(name="INTERVAL", args=[n, ast.Literal(unit)])

    def column_name(self) -> ast.ColName:
        a = self.ident()
        if self.try_op("."):
            b = self.ident()
            if self.try_op("."):
                return ast.ColName(name=self.ident(), table=b, db=a)
            return ast.ColName(name=b, table=a)
        return ast.ColName(name=a)
