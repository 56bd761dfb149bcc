"""Query result value types.

JSON-facing shapes mirror the reference's wire formats (reference:
row.go:15 Row, executor Pair/PairsField cache.go:374-507, GroupCount
executor.go groupBy types) so clients of the reference find the same
response structure. Copied from ``pilosa_tpu/pql/result.py``: the result
types, their JSON form (``result_to_json``) and the node-to-node wire
codec (``result_to_wire`` / ``result_from_wire``), which both packages
encode alike.
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
class ValCount:
    """Sum / Min / Max / Percentile result: ``val`` is the value (a float
    for decimal fields, None when no column matched) and ``count`` the
    columns it covers."""
    val: Optional[float] = None
    count: int = 0

    def to_json(self) -> dict:
        return {"value": self.val, "count": self.count}


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


@dataclasses.dataclass
class ExtractedField:
    name: str
    type: str


@dataclasses.dataclass
class ExtractedColumn:
    column: int
    key: Optional[str]
    rows: List[Any]  # one entry per field: list of row ids/keys, value, or bool


@dataclasses.dataclass
class ExtractedTable:
    fields: List[ExtractedField]
    columns: List[ExtractedColumn]

    def to_json(self) -> dict:
        return {
            "fields": [dataclasses.asdict(f) for f in self.fields],
            "columns": [
                {
                    ("key" if c.key is not None else "column"):
                        (c.key if c.key is not None else c.column),
                    "rows": c.rows,
                }
                for c in self.columns
            ],
        }


@dataclasses.dataclass
class SortedRow:
    """Sort() output (reference: executor.go:9321 executeSort SortedRow):
    record ids ordered by a field's value, with the values alongside."""
    columns: List[int]
    values: List[Any]
    keys: Optional[List[str]] = None

    def to_json(self) -> dict:
        out = {"columns": self.columns, "values": self.values}
        if self.keys is not None:
            out["keys"] = self.keys
        return out


@dataclasses.dataclass
class ApplyResult:
    """Apply() output (reference: apply.go ApplyResult = *arrow.Column):
    a scalar for reductions, else the masked per-record vector."""
    value: Any  # float/int scalar, or List[float]

    def to_json(self) -> Any:
        return self.value


@dataclasses.dataclass
class ArrowTable:
    """Arrow() output (reference: arrow.go:110 BasicTable JSON marshal):
    named typed columns for the filtered records."""
    fields: List[ExtractedField]
    columns: List[List[Any]]  # one list per field, aligned with ids
    ids: List[int] = dataclasses.field(default_factory=list)

    def to_json(self) -> dict:
        return {
            "fields": [dataclasses.asdict(f) for f in self.fields],
            "columns": self.columns,
            "ids": self.ids,
        }


def result_to_json(r) -> Any:
    if hasattr(r, "to_json"):
        return r.to_json()
    if isinstance(r, list):  # GroupBy / Rows / Distinct results
        return [result_to_json(x) for x in r]
    return r


# -- internal wire codec (node-to-node results) ------------------------------
#
# The reference ships remote per-shard results as typed protobuf unions
# (encoding/proto, wire_response.go); here the union tag is a JSON "type"
# field. Remote results carry raw IDs only — translation happens at the
# coordinator (reference: executor.go:7519 translateResults).

def result_to_wire(r) -> dict:
    if r is None:
        return {"type": "null"}
    if isinstance(r, bool):
        return {"type": "bool", "data": r}
    if isinstance(r, int):
        return {"type": "int", "data": r}
    if isinstance(r, RowResult):
        return {"type": "row", "columns": r.columns, "keys": r.keys}
    if isinstance(r, ValCount):
        return {"type": "valcount", "val": r.val, "count": r.count}
    if isinstance(r, PairsField):
        return {"type": "pairs", "field": r.field,
                "pairs": [[p.id, p.key, p.count] for p in r.pairs]}
    if isinstance(r, ExtractedTable):
        return {"type": "extract",
                "fields": [dataclasses.asdict(f) for f in r.fields],
                "columns": [{"column": c.column, "key": c.key, "rows": c.rows}
                            for c in r.columns]}
    if isinstance(r, ApplyResult):
        return {"type": "apply", "data": r.value}
    if isinstance(r, SortedRow):
        return {"type": "sorted", "columns": r.columns, "values": r.values,
                "keys": r.keys}
    if isinstance(r, ArrowTable):
        return {"type": "arrow",
                "fields": [dataclasses.asdict(f) for f in r.fields],
                "columns": r.columns, "ids": r.ids}
    if isinstance(r, list):
        if r and isinstance(r[0], GroupCount):
            return {"type": "groupcounts", "data": [
                {"group": [dataclasses.asdict(fr) for fr in gc.group],
                 "count": gc.count, "agg": gc.agg} for gc in r]}
        return {"type": "list", "data": r}
    raise TypeError(f"unknown result type {type(r).__name__}")


def result_from_wire(d: dict) -> Any:
    t = d["type"]
    if t == "null":
        return None
    if t in ("bool", "int", "list"):
        return d["data"]
    if t == "row":
        return RowResult(columns=d.get("columns") or [], keys=d.get("keys"))
    if t == "valcount":
        return ValCount(val=d.get("val"), count=d.get("count", 0))
    if t == "pairs":
        return PairsField(field=d["field"], pairs=[
            Pair(id=i, key=k, count=c) for i, k, c in d["pairs"]])
    if t == "extract":
        return ExtractedTable(
            fields=[ExtractedField(**f) for f in d["fields"]],
            columns=[ExtractedColumn(column=c["column"], key=c.get("key"),
                                     rows=c["rows"]) for c in d["columns"]])
    if t == "groupcounts":
        return [GroupCount(group=[FieldRow(**fr) for fr in gc["group"]],
                           count=gc["count"], agg=gc.get("agg"))
                for gc in d["data"]]
    if t == "apply":
        return ApplyResult(value=d["data"])
    if t == "sorted":
        return SortedRow(columns=d["columns"], values=d["values"],
                         keys=d.get("keys"))
    if t == "arrow":
        return ArrowTable(fields=[ExtractedField(**f) for f in d["fields"]],
                          columns=d["columns"], ids=d.get("ids", []))
    raise ValueError(f"unknown wire result type {t!r}")
