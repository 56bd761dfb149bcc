"""ORM-style PQL query builder (port of ``pilosa_tpu/client/orm.py``).

Reference: client/orm.go — Schema/Index/Field objects whose methods
build PQL call trees; `serialize()` renders the wire query. The builder
is write-through-free: it only produces strings, the Client executes
them.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union


def _fmt(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, str):
        # backslashes BEFORE quotes, or a trailing backslash escapes the
        # closing quote (parse failure at best, PQL injection at worst)
        return "'" + v.replace("\\", "\\\\").replace("'", "\\'") + "'"
    return str(v)


class PQLQuery:
    """A renderable PQL expression (reference: client/orm.go PQLQuery)."""

    def __init__(self, pql: str, index: "Index"):
        self._pql = pql
        self.index = index

    def serialize(self) -> str:
        return self._pql

    def __repr__(self):  # pragma: no cover - debugging nicety
        return f"PQLQuery({self._pql!r})"


class PQLRowQuery(PQLQuery):
    """A bitmap-valued expression; composes with set algebra
    (reference: client/orm.go PQLRowQuery + Union/Intersect/...)."""

    def union(self, *others: "PQLRowQuery") -> "PQLRowQuery":
        return self._combine("Union", others)

    def intersect(self, *others: "PQLRowQuery") -> "PQLRowQuery":
        return self._combine("Intersect", others)

    def difference(self, *others: "PQLRowQuery") -> "PQLRowQuery":
        return self._combine("Difference", others)

    def xor(self, *others: "PQLRowQuery") -> "PQLRowQuery":
        return self._combine("Xor", others)

    def _combine(self, op: str, others: Sequence["PQLRowQuery"]
                 ) -> "PQLRowQuery":
        parts = [self.serialize()] + [o.serialize() for o in others]
        return PQLRowQuery(f"{op}({', '.join(parts)})", self.index)

    def __and__(self, other):
        return self.intersect(other)

    def __or__(self, other):
        return self.union(other)

    def __sub__(self, other):
        return self.difference(other)

    def __xor__(self, other):
        return self.xor(other)

    def __invert__(self):
        return PQLRowQuery(f"Not({self.serialize()})", self.index)


class Schema:
    """Schema container; indexes are created lazily and reused
    (reference: client/orm.go Schema)."""

    def __init__(self):
        self._indexes: Dict[str, Index] = {}

    def index(self, name: str, keys: bool = False) -> "Index":
        if name not in self._indexes:
            self._indexes[name] = Index(name, keys=keys)
        return self._indexes[name]

    def indexes(self) -> List["Index"]:
        return list(self._indexes.values())


class Index:
    def __init__(self, name: str, keys: bool = False):
        self.name = name
        self.keys = keys
        self._fields: Dict[str, Field] = {}

    def field(self, name: str, **options) -> "Field":
        if name not in self._fields:
            self._fields[name] = Field(self, name, options)
        return self._fields[name]

    def fields(self) -> List["Field"]:
        return list(self._fields.values())

    # -- index-level calls (reference: orm.go Index methods) ---------------

    def all(self) -> PQLRowQuery:
        return PQLRowQuery("All()", self)

    def count(self, row: PQLRowQuery) -> PQLQuery:
        return PQLQuery(f"Count({row.serialize()})", self)

    def not_(self, row: PQLRowQuery) -> PQLRowQuery:
        return PQLRowQuery(f"Not({row.serialize()})", self)

    def union(self, *rows: PQLRowQuery) -> PQLRowQuery:
        return PQLRowQuery(
            f"Union({', '.join(r.serialize() for r in rows)})", self)

    def intersect(self, *rows: PQLRowQuery) -> PQLRowQuery:
        return PQLRowQuery(
            f"Intersect({', '.join(r.serialize() for r in rows)})", self)

    def group_by(self, *rows_calls: PQLQuery, limit: Optional[int] = None,
                 filter: Optional[PQLRowQuery] = None,
                 aggregate: Optional[PQLQuery] = None) -> PQLQuery:
        parts = [r.serialize() for r in rows_calls]
        if limit is not None:
            parts.append(f"limit={limit}")
        if filter is not None:
            parts.append(f"filter={filter.serialize()}")
        if aggregate is not None:
            parts.append(f"aggregate={aggregate.serialize()}")
        return PQLQuery(f"GroupBy({', '.join(parts)})", self)

    def batch_query(self, *queries: PQLQuery) -> PQLQuery:
        return PQLQuery("".join(q.serialize() for q in queries), self)

    def raw_query(self, pql: str) -> PQLQuery:
        return PQLQuery(pql, self)


class Field:
    def __init__(self, index: Index, name: str, options: Optional[dict] = None):
        self.index = index
        self.name = name
        self.options = options or {}

    # -- rows --------------------------------------------------------------

    def row(self, value: Any) -> PQLRowQuery:
        return PQLRowQuery(f"Row({self.name}={_fmt(value)})", self.index)

    def set(self, value: Any, column: Any) -> PQLQuery:
        return PQLQuery(
            f"Set({_fmt(column)}, {self.name}={_fmt(value)})", self.index)

    def clear(self, value: Any, column: Any) -> PQLQuery:
        return PQLQuery(
            f"Clear({_fmt(column)}, {self.name}={_fmt(value)})", self.index)

    def rows(self, limit: Optional[int] = None,
             previous: Any = None) -> PQLQuery:
        args = [self.name]
        if previous is not None:
            args.append(f"previous={_fmt(previous)}")
        if limit is not None:
            args.append(f"limit={limit}")
        return PQLQuery(f"Rows({', '.join(args)})", self.index)

    def topn(self, n: int, row: Optional[PQLRowQuery] = None) -> PQLQuery:
        if row is not None:
            return PQLQuery(
                f"TopN({self.name}, {row.serialize()}, n={n})", self.index)
        return PQLQuery(f"TopN({self.name}, n={n})", self.index)

    # -- BSI comparisons (reference: orm.go Field.GT/LT/...) ---------------

    def _cmp(self, op: str, value: Any) -> PQLRowQuery:
        return PQLRowQuery(
            f"Row({self.name} {op} {_fmt(value)})", self.index)

    def gt(self, v) -> PQLRowQuery:
        return self._cmp(">", v)

    def gte(self, v) -> PQLRowQuery:
        return self._cmp(">=", v)

    def lt(self, v) -> PQLRowQuery:
        return self._cmp("<", v)

    def lte(self, v) -> PQLRowQuery:
        return self._cmp("<=", v)

    def equals(self, v) -> PQLRowQuery:
        return self._cmp("==", v)

    def not_null(self) -> PQLRowQuery:
        return PQLRowQuery(f"Row({self.name} != null)", self.index)

    def between(self, lo, hi) -> PQLRowQuery:
        return PQLRowQuery(
            f"Row({lo} <= {self.name} <= {hi})", self.index)

    # -- aggregates --------------------------------------------------------

    def _agg(self, call: str, filter: Optional[PQLRowQuery]) -> PQLQuery:
        if filter is not None:
            return PQLQuery(
                f"{call}({filter.serialize()}, field={self.name})",
                self.index)
        return PQLQuery(f"{call}(field={self.name})", self.index)

    def sum(self, filter: Optional[PQLRowQuery] = None) -> PQLQuery:
        return self._agg("Sum", filter)

    def min(self, filter: Optional[PQLRowQuery] = None) -> PQLQuery:
        return self._agg("Min", filter)

    def max(self, filter: Optional[PQLRowQuery] = None) -> PQLQuery:
        return self._agg("Max", filter)

    def set_value(self, column: Any, value: int) -> PQLQuery:
        return PQLQuery(
            f"Set({_fmt(column)}, {self.name}={value})", self.index)
