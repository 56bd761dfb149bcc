"""PQL AST: nested calls with named args and child calls.

Reference: pql/ast.go:374 (Call with Name/Args/Children), conditions as
arg values (pql/ast.go Condition). Positional specials use the same
reserved arg keys as the reference: ``_field`` (e.g. TopN(f, ...)),
``_col`` (Set/Clear column), ``_timestamp``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional


# Comparison operators (reference: pql token kinds for conditions).
OPS = ("==", "!=", "<", "<=", ">", ">=", "between")


@dataclasses.dataclass
class Condition:
    op: str
    value: Any  # scalar, or [lo, hi] for between

    def __post_init__(self):
        if self.op not in OPS:
            raise ValueError(f"bad condition op {self.op!r}")

    def to_pql(self, field: str) -> str:
        if self.op == "between":
            lo, hi = self.value
            return f"{_pql_value(lo)} <= {field} <= {_pql_value(hi)}"
        return f"{field} {self.op} {_pql_value(self.value)}"


def _pql_value(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if v is None:
        return "null"
    if isinstance(v, str):
        body = v.replace("\\", "\\\\").replace('"', '\\"')
        return f'"{body}"'
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_pql_value(x) for x in v) + "]"
    if isinstance(v, Call):
        return v.to_pql()
    return str(v)


@dataclasses.dataclass
class Call:
    name: str
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)
    children: List["Call"] = dataclasses.field(default_factory=list)

    def arg(self, key: str, default=None):
        return self.args.get(key, default)

    def field_arg(self, exclude: frozenset = frozenset()) -> Optional[tuple]:
        """The (field, value) pair of a Row-style call: the first arg key
        that isn't an option of this call (reference: pql/ast.go
        Call.FieldArg). Which names are options is per-call — e.g. ``n``
        is TopN's count but a perfectly good field name in Set/Row — so
        callers pass the excludes for their own call."""
        for k, v in self.args.items():
            if not k.startswith("_") and k not in exclude:
                return k, v
        return None

    def __repr__(self):
        parts = [repr(c) for c in self.children]
        parts += [f"{k}={v!r}" for k, v in self.args.items()]
        return f"{self.name}({', '.join(parts)})"

    def to_pql(self) -> str:
        """Serialize back to PQL text (round-trips through the parser).
        Used to forward calls to peer nodes (the reference ships the
        pre-translated call tree in its remote query payload,
        executor.go:6392 remoteExec)."""
        parts: List[str] = []
        if "_col" in self.args:
            parts.append(_pql_value(self.args["_col"]))
        elif "_field" in self.args:
            parts.append(str(self.args["_field"]))
        parts += [c.to_pql() for c in self.children]
        for k, v in self.args.items():
            if k in ("_col", "_field", "_timestamp"):
                continue
            if isinstance(v, Condition):
                parts.append(v.to_pql(k))
            else:
                parts.append(f"{k}={_pql_value(v)}")
        if "_timestamp" in self.args:
            parts.append(str(self.args["_timestamp"]))
        return f"{self.name}({', '.join(parts)})"


# Option-arg names per call, for field_arg() exclusion (reference: the
# per-call arg handling in executor.go's execute* functions).
ROW_OPTIONS = frozenset({"from", "to"})


def unwrap_options(call: "Call") -> "Call":
    """The innermost non-Options call. ``Options(...)`` is a transparent
    execution wrapper — the executor applies its args and evaluates the
    child — so anything classifying a call by name (scheduler op-family
    grouping, fusion maskability) must look through every layer; the one
    shared unwrap keeps those classifications from drifting. Note the
    wrapper's ARGS still matter to callers: an ``Options(shards=...)``
    override re-scopes the child, which both the result cache
    (cache/keys.py is_cacheable) and superset fusion must respect."""
    while call.name == "Options" and call.children:
        call = call.children[0]
    return call


@dataclasses.dataclass
class Query:
    calls: List[Call]

    def __repr__(self):
        return "".join(repr(c) for c in self.calls)

    def to_pql(self) -> str:
        return "".join(c.to_pql() for c in self.calls)
