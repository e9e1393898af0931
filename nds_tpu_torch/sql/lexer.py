# Copied from nds_tpu/sql/lexer.py; only import paths changed.
"""SQL tokenizer for the NDS (Spark-SQL subset) dialect."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Token:
    kind: str   # KW, IDENT, NUMBER, STRING, OP, EOF
    value: str  # keywords/idents lowercased; strings unquoted; ops literal
    pos: int = 0


_MULTI_OPS = ("<=", ">=", "<>", "!=", "||")
_SINGLE_OPS = "+-*/%(),.;=<>"

_KEYWORDS = {
    "select", "from", "where", "group", "by", "having", "order", "limit",
    "with", "as", "distinct", "all", "union", "intersect", "except",
    "join", "inner", "left", "right", "full", "outer", "cross", "on",
    "and", "or", "not", "in", "exists", "between", "like", "is", "null",
    "case", "when", "then", "else", "end", "cast", "interval", "asc",
    "desc", "nulls", "first", "last", "over", "partition", "rollup",
    "date", "rows", "range", "unbounded", "preceding", "following",
    "current", "row", "create", "temp", "temporary", "view", "insert",
    "into", "delete", "drop", "table", "if", "replace", "values", "using",
}


class SqlLexError(ValueError):
    pass


def tokenize(sql: str) -> list[Token]:
    tokens: list[Token] = []
    i, n = 0, len(sql)
    while i < n:
        ch = sql[i]
        if ch.isspace():
            i += 1
            continue
        # comments
        if sql.startswith("--", i):
            j = sql.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if sql.startswith("/*", i):
            j = sql.find("*/", i)
            if j < 0:
                raise SqlLexError(f"unterminated block comment at {i}")
            i = j + 2
            continue
        # string literal (single quotes, '' escape)
        if ch == "'":
            j = i + 1
            buf = []
            while j < n:
                if sql[j] == "'":
                    if j + 1 < n and sql[j + 1] == "'":
                        buf.append("'")
                        j += 2
                        continue
                    break
                buf.append(sql[j])
                j += 1
            else:
                raise SqlLexError(f"unterminated string at {i}")
            tokens.append(Token("STRING", "".join(buf), i))
            i = j + 1
            continue
        # quoted identifier: backticks (Spark) or double quotes
        if ch in "`\"":
            j = sql.find(ch, i + 1)
            if j < 0:
                raise SqlLexError(f"unterminated quoted identifier at {i}")
            tokens.append(Token("IDENT", sql[i + 1:j].lower(), i))
            i = j + 1
            continue
        # number
        if ch.isdigit() or (ch == "." and i + 1 < n and sql[i + 1].isdigit()):
            j = i
            seen_dot = seen_exp = False
            while j < n:
                c = sql[j]
                if c.isdigit():
                    j += 1
                elif c == "." and not seen_dot and not seen_exp:
                    seen_dot = True
                    j += 1
                elif c in "eE" and not seen_exp and j + 1 < n and (
                        sql[j + 1].isdigit() or sql[j + 1] in "+-"):
                    seen_exp = True
                    j += 2
                else:
                    break
            tokens.append(Token("NUMBER", sql[i:j], i))
            i = j
            continue
        # identifier / keyword
        if ch.isalpha() or ch == "_":
            j = i
            while j < n and (sql[j].isalnum() or sql[j] == "_"):
                j += 1
            word = sql[i:j].lower()
            tokens.append(Token("KW" if word in _KEYWORDS else "IDENT", word, i))
            i = j
            continue
        # operators
        if sql[i:i + 2] in _MULTI_OPS:
            tokens.append(Token("OP", sql[i:i + 2], i))
            i += 2
            continue
        if ch in _SINGLE_OPS:
            tokens.append(Token("OP", ch, i))
            i += 1
            continue
        raise SqlLexError(f"unexpected character {ch!r} at {i}")
    tokens.append(Token("EOF", "", n))
    return tokens
