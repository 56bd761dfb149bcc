"""SQL lexer.

Reference: sql3/parser (hand-written lexer). Token set covers the dialect
subset this engine implements; keywords are case-insensitive.

Port of ``pilosa_tpu/sql/lexer.py``: the same tokens and error texts.
"""

from __future__ import annotations

import dataclasses
from typing import List


class SQLError(ValueError):
    pass


KEYWORDS = {
    "SELECT", "FROM", "WHERE", "GROUP", "BY", "HAVING", "ORDER", "LIMIT",
    "OFFSET", "DISTINCT", "AS", "AND", "OR", "NOT", "IN", "BETWEEN", "IS",
    "NULL", "TRUE", "FALSE", "LIKE", "ASC", "DESC", "TOP",
    "CREATE", "TABLE", "DROP", "ALTER", "ADD", "COLUMN", "IF", "EXISTS",
    "INSERT", "REPLACE", "INTO", "VALUES", "BULK", "MAP", "TRANSFORM",
    "WITH", "SHOW", "TABLES", "COLUMNS", "DATABASES", "DELETE",
    "MIN", "MAX", "TIMEUNIT", "TIMEQUANTUM", "TTL", "CACHETYPE", "SIZE",
    "COMMENT", "KEYPARTITIONS", "EXTRACT", "CAST",
    "JOIN", "INNER", "LEFT", "OUTER", "ON", "VIEW",
    # recognized so unsupported join kinds error clearly instead of
    # parsing the kind word as a table alias of an INNER join
    "RIGHT", "FULL", "CROSS",
    "FUNCTION", "RETURNS", "BEGIN", "END", "MODEL", "PREDICT", "USING",
    "COPY", "TO", "URL", "APIKEY", "LANGUAGE",
}

# multi-char operators first
OPERATORS = ["<>", "!=", ">=", "<=", "=", "<", ">", "(", ")", ",", "*", "+",
             "-", "/", "%", "[", "]", "{", "}", ".", ";", "@"]


@dataclasses.dataclass
class Token:
    kind: str  # KEYWORD, IDENT, NUMBER, STRING, OP, EOF
    value: str
    pos: int


def tokenize(src: str) -> List[Token]:
    toks: List[Token] = []
    i, n = 0, len(src)
    while i < n:
        c = src[i]
        if c.isspace():
            i += 1
            continue
        if src.startswith("--", i):  # line comment
            j = src.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if c == "'":
            j = i + 1
            buf = []
            while j < n:
                if src[j] == "'" and j + 1 < n and src[j + 1] == "'":
                    buf.append("'")
                    j += 2
                elif src[j] == "'":
                    break
                else:
                    buf.append(src[j])
                    j += 1
            if j >= n:
                raise SQLError(f"unterminated string at {i}")
            toks.append(Token("STRING", "".join(buf), i))
            i = j + 1
            continue
        if c == '"':  # quoted identifier
            j = src.find('"', i + 1)
            if j < 0:
                raise SQLError(f"unterminated identifier at {i}")
            toks.append(Token("IDENT", src[i + 1:j], i))
            i = j + 1
            continue
        if c.isdigit() or (c == "." and i + 1 < n and src[i + 1].isdigit()):
            j = i
            seen_dot = False
            while j < n and (src[j].isdigit() or (src[j] == "." and not seen_dot)):
                if src[j] == ".":
                    # lookahead: "1." followed by non-digit is NUMBER then OP
                    if j + 1 >= n or not src[j + 1].isdigit():
                        break
                    seen_dot = True
                j += 1
            toks.append(Token("NUMBER", src[i:j], i))
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (src[j].isalnum() or src[j] == "_"):
                j += 1
            word = src[i:j]
            if word.upper() in KEYWORDS:
                toks.append(Token("KEYWORD", word.upper(), i))
            else:
                toks.append(Token("IDENT", word, i))
            i = j
            continue
        for op in OPERATORS:
            if src.startswith(op, i):
                toks.append(Token("OP", "!=" if op == "<>" else op, i))
                i += len(op)
                break
        else:
            raise SQLError(f"unexpected character {c!r} at {i}")
    toks.append(Token("EOF", "", n))
    return toks
