"""SQL lexer.

Reference: TiDB's parser/lexer.go (hand-written scanner feeding the
goyacc grammar) — here feeding a recursive-descent parser instead. MySQL
dialect essentials: backquoted identifiers, single/double-quoted strings
with '' and \\ escapes, numeric literals (int/decimal/float), line (--, #)
and block comments, multi-char operators (<=, >=, <>, !=, <=>, ||, &&, <<, >>).
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum, auto

__all__ = ["TokenType", "Token", "Lexer", "LexError", "KEYWORDS"]


class LexError(Exception):
    pass


class TokenType(Enum):
    IDENT = auto()
    KEYWORD = auto()
    INT = auto()
    DECIMAL = auto()     # numeric literal with a fraction part
    FLOAT = auto()       # scientific notation
    STRING = auto()
    OP = auto()
    EOF = auto()


KEYWORDS = {
    "SELECT", "FROM", "WHERE", "GROUP", "BY", "HAVING", "ORDER", "LIMIT",
    "OFFSET", "AS", "AND", "OR", "NOT", "XOR", "IN", "BETWEEN", "LIKE",
    "IS", "NULL", "TRUE", "FALSE", "DISTINCT", "ALL", "ASC", "DESC",
    "JOIN", "INNER", "LEFT", "RIGHT", "FULL", "OUTER", "CROSS", "ON",
    "USING", "UNION", "EXISTS", "ANY", "CASE", "WHEN", "THEN", "ELSE",
    "END", "CAST", "CONVERT", "DIV", "MOD", "INTERVAL",
    "INSERT", "INTO", "VALUES", "VALUE", "REPLACE", "UPDATE", "SET",
    "DELETE", "DUPLICATE", "KEY", "DEFAULT",
    "CREATE", "TABLE", "DATABASE", "SCHEMA", "INDEX", "UNIQUE", "PRIMARY",
    "DROP", "ALTER", "ADD", "COLUMN", "TRUNCATE", "RENAME", "TO", "MODIFY",
    "CHANGE", "CONSTRAINT", "REFERENCES", "FOREIGN", "AUTO_INCREMENT",
    "IF", "IFNULL", "COALESCE", "NULLIF",
    "INT", "INTEGER", "BIGINT", "SMALLINT", "TINYINT", "MEDIUMINT",
    "FLOAT", "DOUBLE", "REAL", "DECIMAL", "NUMERIC", "CHAR", "VARCHAR",
    "TEXT", "BLOB", "DATE", "DATETIME", "TIMESTAMP", "TIME", "YEAR",
    "BOOL", "BOOLEAN", "UNSIGNED", "SIGNED", "ZEROFILL", "BINARY",
    "PRECISION", "VARYING",
    "BEGIN", "START", "TRANSACTION", "COMMIT", "ROLLBACK",
    "USE", "SHOW", "DATABASES", "TABLES", "COLUMNS", "FIELDS", "EXPLAIN",
    "DESCRIBE", "ANALYZE", "ADMIN", "CHECK",
    "GLOBAL", "SESSION", "VARIABLES", "STATUS", "ENGINES", "ENGINE",
    "CHARSET", "COLLATE", "COLLATION", "COMMENT", "FIRST", "AFTER",
    "GRANT", "REVOKE", "PRIVILEGES", "IDENTIFIED", "WITH", "OPTION", "USER",
    "FOR", "FORCE", "IGNORE", "LOW_PRIORITY", "HIGH_PRIORITY", "QUICK",
    "PARTITION", "TEMPORARY", "EXTENDED",
    "PREPARE", "EXECUTE", "DEALLOCATE",
}

# Words with meaning only inside LOAD DATA / SPLIT TABLE clauses. They
# stay ordinary identifiers everywhere else (reserving them would break
# queries using e.g. `data` or `at` as column/alias names); the parser
# matches them by value via try_word/expect_word.
NON_RESERVED = {
    "LOAD", "DATA", "INFILE", "TERMINATED", "ENCLOSED", "ESCAPED",
    "LINES", "OPTIONALLY", "STARTING", "SPLIT", "AT", "REGIONS", "LOCAL",
    "KILL", "TIDB", "CONNECTION", "QUERY", "DO", "FLUSH", "ESCAPE",
    # ALTER/SET/SHOW long tail (keyword meaning only in those clauses)
    "DISABLE", "ENABLE", "KEYS", "READ", "ONLY", "ISOLATION", "LEVEL",
    "BINARY", "CHARACTER", "FULLTEXT", "TRANSACTION", "PASSWORD",
    "TABLES", "STATS", "NO_WRITE_TO_BINLOG", "SHARE", "MODE",
    "DISTINCTROW", "CHARSET", "LOCK", "VIEW", "JOBS", "CANCEL",
    "REPLACE", "ALGORITHM", "DEFINER", "SQL", "SECURITY", "CASCADED",
    "OPTION", "STRAIGHT_JOIN", "USING",
    # TRACE [FORMAT='row'|'json'] <stmt> (session._exec_trace): both
    # words stay ordinary identifiers outside that statement head
    "TRACE", "FORMAT",
}


@dataclass
class Token:
    tp: TokenType
    val: str
    pos: int

    def is_kw(self, kw: str) -> bool:
        return self.tp == TokenType.KEYWORD and self.val == kw

    def __repr__(self):
        return f"{self.tp.name}({self.val})"


_TWO_CHAR_OPS = {"<=", ">=", "<>", "!=", "||", "&&", "<<", ">>", ":="}
_THREE_CHAR_OPS = {"<=>"}
_ONE_CHAR_OPS = set("+-*/%(),.;=<>!~&|^@?")


class Lexer:
    def __init__(self, sql: str):
        self.sql = sql
        self.pos = 0
        self.n = len(sql)

    def tokens(self) -> list[Token]:
        out = []
        while True:
            t = self._next()
            out.append(t)
            if t.tp == TokenType.EOF:
                return out

    def _peek(self, k: int = 0) -> str:
        p = self.pos + k
        return self.sql[p] if p < self.n else ""

    def _next(self) -> Token:
        self._skip_space_and_comments()
        if self.pos >= self.n:
            return Token(TokenType.EOF, "", self.pos)
        c = self.sql[self.pos]
        start = self.pos
        if c in "xX" and self._peek(1) == "'":
            return self._hex_literal(start)          # X'0a'
        if c in "bB" and self._peek(1) == "'":
            return self._bit_literal(start)          # b'1010'
        if c in "nN" and self._peek(1) == "'":
            self.pos += 1                            # N'...' national str
            return self._string(self.pos, "'")
        if c == "0" and self._peek(1) in "xX" and \
                self._is_hex(self._peek(2)):
            return self._hex0x_literal(start)        # 0x0a
        if c.isdigit() or (c == "." and self._peek(1).isdigit()):
            return self._number(start)
        if c.isalpha() or c == "_":
            return self._ident(start)
        if c == "`":
            return self._quoted_ident(start)
        if c in ("'", '"'):
            return self._string(start, c)
        return self._op(start)

    def _skip_space_and_comments(self):
        while self.pos < self.n:
            c = self.sql[self.pos]
            if c.isspace():
                self.pos += 1
            elif c == "-" and self._peek(1) == "-" and \
                    (self._peek(2) in ("", " ", "\t", "\n")):
                while self.pos < self.n and self.sql[self.pos] != "\n":
                    self.pos += 1
            elif c == "#":
                while self.pos < self.n and self.sql[self.pos] != "\n":
                    self.pos += 1
            elif c == "/" and self._peek(1) == "*":
                end = self.sql.find("*/", self.pos + 2)
                if end < 0:
                    raise LexError(f"unterminated comment at {self.pos}")
                self.pos = end + 2
            else:
                return

    @staticmethod
    def _is_hex(c: str) -> bool:
        return bool(c) and c in "0123456789abcdefABCDEF"

    def _hex_literal(self, start: int) -> Token:
        """X'0a' -> INT token (MySQL hex literals act as numbers in
        numeric context; string-context binary semantics are out of
        scope — docs/DEVIATIONS.md)."""
        end = self.sql.find("'", start + 2)
        if end < 0:
            raise LexError(f"unterminated hex literal at {start}")
        digits = self.sql[start + 2:end]
        if digits and not all(self._is_hex(c) for c in digits):
            raise LexError(f"bad hex literal at {start}")
        self.pos = end + 1
        return Token(TokenType.INT, str(int(digits or "0", 16)), start)

    def _bit_literal(self, start: int) -> Token:
        end = self.sql.find("'", start + 2)
        if end < 0:
            raise LexError(f"unterminated bit literal at {start}")
        digits = self.sql[start + 2:end]
        if digits and not all(c in "01" for c in digits):
            raise LexError(f"bad bit literal at {start}")
        self.pos = end + 1
        return Token(TokenType.INT, str(int(digits or "0", 2)), start)

    def _hex0x_literal(self, start: int) -> Token:
        self.pos = start + 2
        while self.pos < self.n and self._is_hex(self.sql[self.pos]):
            self.pos += 1
        return Token(TokenType.INT,
                     str(int(self.sql[start + 2:self.pos], 16)), start)

    def _number(self, start: int) -> Token:
        has_dot = has_exp = False
        while self.pos < self.n:
            c = self.sql[self.pos]
            if c.isdigit():
                self.pos += 1
            elif c == "." and not has_dot and not has_exp:
                # "1.e3" / "1.5" ok; but "1..2" stops
                has_dot = True
                self.pos += 1
            elif c in "eE" and not has_exp and self.pos + 1 < self.n and \
                    (self.sql[self.pos + 1].isdigit() or
                     self.sql[self.pos + 1] in "+-"):
                has_exp = True
                self.pos += 1
                if self.sql[self.pos] in "+-":
                    self.pos += 1
            else:
                break
        text = self.sql[start:self.pos]
        if has_exp:
            return Token(TokenType.FLOAT, text, start)
        if has_dot:
            return Token(TokenType.DECIMAL, text, start)
        return Token(TokenType.INT, text, start)

    def _ident(self, start: int) -> Token:
        while self.pos < self.n and (self.sql[self.pos].isalnum() or
                                     self.sql[self.pos] in "_$"):
            self.pos += 1
        text = self.sql[start:self.pos]
        up = text.upper()
        if up in KEYWORDS:
            return Token(TokenType.KEYWORD, up, start)
        return Token(TokenType.IDENT, text, start)

    def _quoted_ident(self, start: int) -> Token:
        self.pos += 1
        out = []
        while self.pos < self.n:
            c = self.sql[self.pos]
            if c == "`":
                if self._peek(1) == "`":
                    out.append("`")
                    self.pos += 2
                    continue
                self.pos += 1
                return Token(TokenType.IDENT, "".join(out), start)
            out.append(c)
            self.pos += 1
        raise LexError(f"unterminated identifier at {start}")

    def _string(self, start: int, quote: str) -> Token:
        self.pos += 1
        out = []
        while self.pos < self.n:
            c = self.sql[self.pos]
            if c == "\\" and self.pos + 1 < self.n:
                nxt = self.sql[self.pos + 1]
                esc = {"n": "\n", "t": "\t", "r": "\r", "0": "\0",
                       "\\": "\\", "'": "'", '"': '"', "%": "\\%",
                       "_": "\\_"}.get(nxt, nxt)
                out.append(esc)
                self.pos += 2
                continue
            if c == quote:
                if self._peek(1) == quote:   # '' escape
                    out.append(quote)
                    self.pos += 2
                    continue
                self.pos += 1
                return Token(TokenType.STRING, "".join(out), start)
            out.append(c)
            self.pos += 1
        raise LexError(f"unterminated string at {start}")

    def _op(self, start: int) -> Token:
        three = self.sql[self.pos:self.pos + 3]
        if three in _THREE_CHAR_OPS:
            self.pos += 3
            return Token(TokenType.OP, three, start)
        two = self.sql[self.pos:self.pos + 2]
        if two in _TWO_CHAR_OPS:
            self.pos += 2
            return Token(TokenType.OP, two, start)
        c = self.sql[self.pos]
        if c in _ONE_CHAR_OPS:
            self.pos += 1
            return Token(TokenType.OP, c, start)
        raise LexError(f"unexpected character {c!r} at {self.pos}")
