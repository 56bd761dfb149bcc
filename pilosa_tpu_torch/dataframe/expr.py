"""Vector expression language for Apply(), the ivy/APL replacement.

Port of ``pilosa_tpu/dataframe/expr.py`` (reference: apply.go:195
executeApplyShard -> ivy.RunArrow), with the same grammar:

    expr     := sum(e) | mean(e) | min(e) | max(e) | count(e) | e
    e        := term (('+'|'-') term)*
    term     := unary (('*'|'/') unary)*
    unary    := '-' unary | factor
    factor   := NUMBER | COLUMN | '(' e ')' | fn '(' e ')'
    fn       := abs | sqrt | log | exp

Semantics: elementwise over the shard-stacked ``float32[S, N]`` column
tensors; reductions fold over both axes under the mask (bitmap filter AND
column validity). The compiled function runs eager ``torch`` ops on the
columns' device: the JAX package's one XLA program becomes a short chain
of launches.
"""

from __future__ import annotations

import re
from typing import Callable, List, Set, Tuple

import torch

_TOKEN = re.compile(r"\s*(?:(\d+\.\d*|\.\d+|\d+)|([A-Za-z_][A-Za-z_0-9]*)|(.))")

_REDUCERS = ("sum", "mean", "min", "max", "count")
_ELEMENTWISE = {"abs": torch.abs, "sqrt": torch.sqrt, "log": torch.log,
                "exp": torch.exp}


class ExprError(ValueError):
    pass


def _f32(x):
    """A Python constant as a float32 scalar tensor (jnp's functions take
    a constant as float32); tensors pass through."""
    return x if isinstance(x, torch.Tensor) else torch.tensor(
        x, dtype=torch.float32)


def _tokenize(src: str) -> List[Tuple[str, str]]:
    out, i = [], 0
    while i < len(src):
        m = _TOKEN.match(src, i)
        if not m or m.end() == i and not src[i:].strip():
            break
        i = m.end()
        num, ident, punct = m.groups()
        if num is not None:
            out.append(("num", num))
        elif ident is not None:
            out.append(("ident", ident))
        elif punct.strip():
            out.append(("punct", punct))
    return out


class _Parser:
    def __init__(self, tokens: List[Tuple[str, str]]):
        self.toks = tokens
        self.pos = 0
        self.columns: Set[str] = set()

    def peek(self):
        return self.toks[self.pos] if self.pos < len(self.toks) else ("eof", "")

    def next(self):
        t = self.peek()
        self.pos += 1
        return t

    def expect(self, punct: str):
        k, t = self.next()
        if (k, t) != ("punct", punct):
            raise ExprError(f"expected {punct!r}, got {t!r}")

    # each node compiles to fn(cols: dict[str, [S,N]]) -> [S,N] tensor or
    # a constant
    def expr(self):
        node = self.term()
        while self.peek() == ("punct", "+") or self.peek() == ("punct", "-"):
            op = self.next()[1]
            rhs = self.term()
            lhs = node
            node = ((lambda l, r: lambda c: l(c) + r(c)) if op == "+"
                    else (lambda l, r: lambda c: l(c) - r(c)))(lhs, rhs)
        return node

    def term(self):
        node = self.unary()
        while self.peek() in (("punct", "*"), ("punct", "/")):
            op = self.next()[1]
            rhs = self.unary()
            lhs = node
            node = ((lambda l, r: lambda c: l(c) * r(c)) if op == "*"
                    else (lambda l, r: lambda c: l(c) / r(c)))(lhs, rhs)
        return node

    def unary(self):
        if self.peek() == ("punct", "-"):
            self.next()
            inner = self.unary()
            return lambda c: -inner(c)
        return self.factor()

    def factor(self):
        k, t = self.next()
        if k == "num":
            v = float(t)
            return lambda c: v
        if k == "ident":
            if self.peek() == ("punct", "("):
                fn = _ELEMENTWISE.get(t)
                if fn is None:
                    raise ExprError(
                        f"unknown function {t!r} (reductions go outermost)")
                self.next()
                inner = self.expr()
                self.expect(")")
                return lambda c, fn=fn: fn(_f32(inner(c)))
            self.columns.add(t)
            return lambda c, t=t: c[t]
        if (k, t) == ("punct", "("):
            inner = self.expr()
            self.expect(")")
            return inner
        raise ExprError(f"unexpected token {t!r}")


def _on(x, mask: torch.Tensor) -> torch.Tensor:
    """``x`` (a tensor or a constant) as float32 on the mask's device."""
    return _f32(x).to(mask.device)


def compile_expr(src: str) -> Tuple[Callable, Set[str], bool]:
    """Compile to ``fn(cols, mask) -> tensor``.

    cols: dict column -> float32[S, N]; mask: bool[S, N] (filter AND
    validity). Returns (fn, columns_used, is_reduction); reductions return
    a 0-d tensor (int32 for ``count``, float32 otherwise), plain
    expressions a masked float32[S, N] vector (NaN outside the mask)."""
    toks = _tokenize(src.strip())
    if not toks:
        raise ExprError("empty Apply expression")
    reducer = None
    if (toks[0][0] == "ident" and toks[0][1] in _REDUCERS
            and len(toks) > 1 and toks[1] == ("punct", "(")
            and toks[-1] == ("punct", ")")):
        reducer = toks[0][1]
        toks = toks[2:-1]
    p = _Parser(toks)
    body = p.expr()
    if p.peek()[0] != "eof":
        raise ExprError(f"trailing tokens at {p.peek()[1]!r}")

    if reducer is None:
        def vec_fn(cols, mask):
            return torch.where(mask, _on(body(cols), mask), float("nan"))
        return vec_fn, p.columns, False

    def red_fn(cols, mask, _r=reducer):
        if _r == "count":
            return mask.sum(dtype=torch.int32)
        x = _on(body(cols), mask)
        if not p.columns:
            x = torch.broadcast_to(x, mask.shape)
        if _r == "sum":
            return torch.where(mask, x, 0.0).sum()
        if _r == "mean":
            n = mask.sum(dtype=torch.float32)
            return torch.where(mask, x, 0.0).sum() / torch.clamp(n, min=1.0)
        if _r == "min":
            return torch.where(mask, x, float("inf")).min()
        return torch.where(mask, x, float("-inf")).max()

    return red_fn, p.columns, True
