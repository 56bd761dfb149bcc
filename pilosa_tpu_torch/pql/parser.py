"""Hand-written PQL lexer + recursive-descent parser.

Clean-room implementation of the language accepted by the reference's PEG
grammar (reference: pql/pql.peg:8-24 lists the calls; pql/pql.peg.go is the
generated parser). Supports:

    Call(...)Call(...)                 # a query is a sequence of calls
    Row(f=1)  Row(f="key")             # row specs
    Row(f > 5)  Row(3 < f < 7)         # BSI conditions, chained comparisons
    Set(10, f=1)  Set(10, f=1, 2010-01-02T03:04)   # bare ISO timestamps
    TopN(f, n=5)                       # positional field name
    GroupBy(Rows(a), Rows(b), limit=3) # child calls
    ConstRow(columns=[1, 2, "k"])      # lists
    true / false / null, 1.5, -3, 'str', "str"
"""

from __future__ import annotations

import re
from typing import Any, List, Optional, Tuple

from pilosa_tpu_torch.pql.ast import Call, Condition, Query

_TIMESTAMP = r"\d{4}-\d{2}-\d{2}T\d{2}:\d{2}(?::\d{2})?(?:Z|[+-]\d{2}:\d{2})?"

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<timestamp>""" + _TIMESTAMP + r""")
  | (?P<number>-?\d+\.\d+|-?\.\d+|-?\d+)
  | (?P<ident>[A-Za-z_][A-Za-z0-9_-]*)
  | (?P<string>"(?:[^"\\]|\\.)*"|'(?:[^'\\]|\\.)*')
  | (?P<op><=|>=|==|!=|<|>)
  | (?P<punct>[(),=\[\]])
    """,
    re.VERBOSE,
)

_ESCAPES = {"n": "\n", "t": "\t", '"': '"', "'": "'", "\\": "\\"}


class ParseError(ValueError):
    pass


def _lex(src: str) -> List[Tuple[str, str]]:
    tokens = []
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if not m:
            raise ParseError(f"unexpected character {src[pos]!r} at offset {pos}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        tokens.append((kind, m.group()))
    tokens.append(("eof", ""))
    return tokens


def _unquote(s: str) -> str:
    body = s[1:-1]
    out, i = [], 0
    while i < len(body):
        c = body[i]
        if c == "\\" and i + 1 < len(body):
            out.append(_ESCAPES.get(body[i + 1], body[i + 1]))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


class _Parser:
    def __init__(self, src: str):
        self.tokens = _lex(src)
        self.i = 0

    def peek(self, ahead=0) -> Tuple[str, str]:
        return self.tokens[min(self.i + ahead, len(self.tokens) - 1)]

    def next(self) -> Tuple[str, str]:
        tok = self.tokens[self.i]
        self.i += 1
        return tok

    def expect(self, kind: str, text: Optional[str] = None) -> str:
        k, t = self.next()
        if k != kind or (text is not None and t != text):
            raise ParseError(f"expected {text or kind}, got {t!r}")
        return t

    # -- grammar ---------------------------------------------------------------

    def query(self) -> Query:
        calls = []
        while self.peek()[0] != "eof":
            calls.append(self.call())
        return Query(calls)

    def call(self) -> Call:
        name = self.expect("ident")
        if not name[0].isupper():
            raise ParseError(f"call name must be capitalized: {name!r}")
        self.expect("punct", "(")
        call = Call(name)
        first = True
        while True:
            k, t = self.peek()
            if k == "punct" and t == ")":
                self.next()
                break
            if not first:
                self.expect("punct", ",")
                k, t = self.peek()
                if k == "punct" and t == ")":  # trailing comma
                    self.next()
                    break
            first = False
            self.argument(call)
        return call

    def argument(self, call: Call) -> None:
        k, t = self.peek()
        if k == "ident" and t[0].isupper() and self.peek(1) == ("punct", "("):
            call.children.append(self.call())
            return
        if k == "ident":
            nk, nt = self.peek(1)
            if (nk, nt) == ("punct", "="):
                self.next(); self.next()
                key = t
                v = self.value(allow_call=True)
                # kwarg timestamps (from=/to=) surface as plain ISO text,
                # same as positional ones (pql/ast.go reserved args)
                call.args[key] = v.text if isinstance(v, _Timestamp) else v
                return
            if nk == "op":
                # field <op> value  [possibly invalid: handled in cond]
                self.next()
                op = self.next()[1]
                val = self.scalar()
                call.args[t] = Condition(_COND_OPS[op], val)
                return
            # bare word: positional field name (unquoted ident) or literal
            self.next()
            v = self._word_value(t)
            self._positional(call, v, is_word=isinstance(v, str))
            return
        if k in ("number", "string", "timestamp"):
            # Could be `lo < field < hi` chained condition.
            if k == "number" and self.peek(1)[0] == "op":
                lo = _num(t)
                self.next()
                op1 = self.next()[1]
                fieldname = self.expect("ident")
                op2 = self.next()[1]
                hi = self.scalar()
                call.args[fieldname] = _between(lo, op1, op2, hi)
                return
            self.next()
            self._positional(call, _scalar_from_token(k, t))
            return
        if k == "punct" and t == "[":
            self._positional(call, self.list_value())
            return
        raise ParseError(f"unexpected token {t!r} in argument list")

    def _positional(self, call: Call, value: Any, is_word: bool = False) -> None:
        """Positional args map to the reference's reserved keys
        (pql/ast.go: _field, _col, _timestamp for Set/Clear/TopN/Rows).
        Unquoted idents are field names (TopN(f)); quoted strings and
        numbers are column ids/keys (Set("alice", ...))."""
        if isinstance(value, _Timestamp):
            call.args["_timestamp"] = value.text
        elif is_word and "_field" not in call.args and not call.children:
            call.args["_field"] = value
        elif "_col" not in call.args and not call.children and "_field" not in call.args:
            call.args["_col"] = value
        else:
            call.args.setdefault("_args", []).append(value)

    def value(self, allow_call=False) -> Any:
        k, t = self.peek()
        if allow_call and k == "ident" and t[0].isupper() and self.peek(1) == ("punct", "("):
            return self.call()
        if k == "punct" and t == "[":
            return self.list_value()
        return self.scalar()

    def list_value(self) -> list:
        self.expect("punct", "[")
        out = []
        while True:
            k, t = self.peek()
            if k == "punct" and t == "]":
                self.next()
                break
            if out:
                self.expect("punct", ",")
            out.append(self.scalar())
        return out

    def scalar(self) -> Any:
        k, t = self.next()
        if k == "ident":
            return self._word_value(t)
        if k in ("number", "string", "timestamp"):
            return _scalar_from_token(k, t)
        raise ParseError(f"expected value, got {t!r}")

    @staticmethod
    def _word_value(t: str) -> Any:
        if t == "true":
            return True
        if t == "false":
            return False
        if t == "null":
            return None
        return t


class _Timestamp:
    def __init__(self, text: str):
        self.text = text


def _scalar_from_token(kind: str, text: str) -> Any:
    if kind == "number":
        return _num(text)
    if kind == "string":
        return _unquote(text)
    return _Timestamp(text)


def _num(text: str):
    return float(text) if "." in text else int(text)


_COND_OPS = {"==": "==", "!=": "!=", "<": "<", "<=": "<=", ">": ">", ">=": ">="}


def _between(lo, op1: str, op2: str, hi) -> Condition:
    """`lo <[=] field <[=] hi` chains; normalize to inclusive BETWEEN
    (reference: pql condition binop folding)."""
    if op1 not in ("<", "<=") or op2 not in ("<", "<="):
        raise ParseError(f"unsupported chained comparison {op1} .. {op2}")
    if op1 == "<":
        lo = lo + 1
    if op2 == "<":
        hi = hi - 1
    return Condition("between", [lo, hi])


def parse(src: str) -> Query:
    return _Parser(src).query()
