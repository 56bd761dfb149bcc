"""Query result value types.

JSON-facing shapes mirror the reference's wire formats (reference:
row.go:15 Row, executor Pair/PairsField cache.go:374-507, GroupCount
executor.go groupBy types) so clients of the reference find the same
response structure. Copied from ``pilosa_tpu/pql/result.py``: the result
types this slice of the port returns.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional


@dataclasses.dataclass
class RowResult:
    """A set of record IDs (and/or keys when the index is keyed)."""
    columns: List[int] = dataclasses.field(default_factory=list)
    keys: Optional[List[str]] = None

    def to_json(self) -> dict:
        if self.keys is not None:
            return {"keys": self.keys}
        return {"columns": self.columns}


@dataclasses.dataclass
class Pair:
    id: Optional[int]
    key: Optional[str]
    count: int

    def to_json(self) -> dict:
        d: Dict[str, Any] = {"count": self.count}
        if self.key is not None:
            d["key"] = self.key
        else:
            d["id"] = self.id
        return d


@dataclasses.dataclass
class PairsField:
    pairs: List[Pair]
    field: str

    def to_json(self) -> dict:
        return {"rows": [p.to_json() for p in self.pairs], "field": self.field}


@dataclasses.dataclass
class FieldRow:
    field: str
    row_id: Optional[int] = None
    row_key: Optional[str] = None
    value: Optional[int] = None  # for grouped BSI values

    def to_json(self) -> dict:
        d: Dict[str, Any] = {"field": self.field}
        if self.value is not None:
            d["value"] = self.value
        elif self.row_key is not None:
            d["rowKey"] = self.row_key
        else:
            d["rowID"] = self.row_id
        return d


@dataclasses.dataclass
class GroupCount:
    group: List[FieldRow]
    count: int
    agg: Optional[int] = None

    def to_json(self) -> dict:
        d: Dict[str, Any] = {"group": [g.to_json() for g in self.group],
                             "count": self.count}
        if self.agg is not None:
            d["agg"] = self.agg
        return d
