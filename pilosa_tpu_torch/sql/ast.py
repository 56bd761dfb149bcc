"""SQL AST nodes.

Reference: sql3/parser/ast.go (4.9k LoC of node types). Only the dialect
subset implemented by the planner is modeled.

Port of ``pilosa_tpu/sql/ast.py``; the planner lowers these nodes to the
port's PQL AST (``pilosa_tpu_torch/pql/ast.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple


# -- expressions -------------------------------------------------------------

@dataclasses.dataclass
class Expr:
    pass


@dataclasses.dataclass
class Literal(Expr):
    value: Any  # int, float, str, bool, None, or list of literals


@dataclasses.dataclass
class ColumnRef(Expr):
    name: str
    table: Optional[str] = None


@dataclasses.dataclass
class Star(Expr):
    pass


@dataclasses.dataclass
class TupleLiteral(Expr):
    """{a, b}: only meaningful as a quantum {timestamp, set} insert
    value (reference: sql3 tuple literals, defs_timequantum.go)."""
    items: List[Expr] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Binary(Expr):
    op: str  # = != < <= > >= AND OR + - * / %
    left: Expr
    right: Expr


@dataclasses.dataclass
class Unary(Expr):
    op: str  # NOT, -
    operand: Expr


@dataclasses.dataclass
class InList(Expr):
    operand: Expr
    items: List[Expr]
    negated: bool = False


@dataclasses.dataclass
class Between(Expr):
    operand: Expr
    low: Expr
    high: Expr
    negated: bool = False


@dataclasses.dataclass
class IsNull(Expr):
    operand: Expr
    negated: bool = False


@dataclasses.dataclass
class Like(Expr):
    operand: Expr
    pattern: str
    negated: bool = False


@dataclasses.dataclass
class FuncCall(Expr):
    name: str  # upper-cased: COUNT, SUM, AVG, MIN, MAX, PERCENTILE,
    #            SETCONTAINS, SETCONTAINSANY, SETCONTAINSALL, UPPER, LOWER...
    args: List[Expr] = dataclasses.field(default_factory=list)
    distinct: bool = False  # COUNT(DISTINCT col)


@dataclasses.dataclass
class PQLFilter(Expr):
    """A pre-lowered PQL bitmap predicate carried as WHERE conjunct
    (planner-internal, never produced by the parser). The semi-join
    planner (sql/joins.py) rewrites star joins into single-table fact
    selects whose WHERE carries the broadcast dimension bitmaps as
    PQLFilter nodes; lower_filter parses the text back to a Call, so
    the whole single-table pipeline — aggregate fusion, fanout,
    order/limit pushdown — applies unchanged. Stored as PQL text (not a
    Call) so dataclass repr/equality stay cheap and wire-safe."""
    pql: str


# -- statements --------------------------------------------------------------

@dataclasses.dataclass
class SelectItem:
    expr: Expr
    alias: Optional[str] = None


@dataclasses.dataclass
class OrderTerm:
    expr: Expr
    desc: bool = False


@dataclasses.dataclass
class SelectStatement:
    items: List[SelectItem]
    table: Optional[str] = None
    table_alias: Optional[str] = None
    #: derived-table source: FROM (SELECT ...) AS alias
    derived: Optional["SelectStatement"] = None
    joins: List["JoinClause"] = dataclasses.field(default_factory=list)
    where: Optional[Expr] = None
    group_by: List[Expr] = dataclasses.field(default_factory=list)
    having: Optional[Expr] = None
    order_by: List[OrderTerm] = dataclasses.field(default_factory=list)
    limit: Optional[int] = None
    offset: Optional[int] = None
    distinct: bool = False
    top: Optional[int] = None


@dataclasses.dataclass
class CreateView:
    """CREATE VIEW name AS SELECT ... (reference: sql3 CREATE VIEW,
    sql3/parser createview statement)."""
    name: str
    select: "SelectStatement"
    if_not_exists: bool = False


@dataclasses.dataclass
class DropView:
    name: str
    if_exists: bool = False


@dataclasses.dataclass
class CreateFunction:
    """CREATE FUNCTION name (@p type, ...) RETURNS type AS BEGIN...END
    (reference: sql3/parser CreateFunctionStatement; evaluation is
    refused by the reference too — userdefinedfunctions.go returns
    'user defined functions' unsupported)."""
    name: str
    params: List[Tuple[str, str]]
    returns: str
    body: str
    if_not_exists: bool = False
    language: str = "sql"


@dataclasses.dataclass
class DropFunction:
    name: str
    if_exists: bool = False


@dataclasses.dataclass
class CreateModel:
    """CREATE MODEL (reference: parseCreateModelStatement; execution is
    cloud-gated in the reference — registered here, PREDICT refuses)."""
    name: str
    options: str = ""
    if_not_exists: bool = False


@dataclasses.dataclass
class DropModel:
    name: str
    if_exists: bool = False


@dataclasses.dataclass
class Predict:
    """PREDICT USING model <select> (reference: PredictStatement)."""
    model: str
    select: "SelectStatement" = None


@dataclasses.dataclass
class CopyStatement:
    """COPY src TO target [WHERE e] [WITH URL '...' [APIKEY '...']]
    (reference: parseCopyStatement — ships rows to another FeatureBase;
    here: local table copy, or remote over the client when URL given)."""
    source: str
    target: str
    where: Optional[Expr] = None
    url: Optional[str] = None
    api_key: Optional[str] = None


@dataclasses.dataclass
class JoinClause:
    """One JOIN term (reference: sql3/parser ast.go JoinOperator +
    OnConstraint; sources form a left-deep chain here)."""
    table: str
    alias: Optional[str] = None
    on: Optional[Expr] = None
    kind: str = "INNER"  # INNER | LEFT


@dataclasses.dataclass
class ColumnDef:
    name: str
    type: str  # upper-cased SQL type: ID, STRING, IDSET, STRINGSET, INT,
    #            DECIMAL, TIMESTAMP, BOOL, IDSETQ, STRINGSETQ
    type_arg: Optional[int] = None  # DECIMAL(2)
    min: Optional[int] = None
    max: Optional[int] = None
    time_unit: Optional[str] = None
    time_quantum: Optional[str] = None
    ttl: Optional[str] = None
    cache_type: Optional[str] = None
    cache_size: Optional[int] = None


@dataclasses.dataclass
class CreateTable:
    name: str
    columns: List[ColumnDef]
    if_not_exists: bool = False
    comment: Optional[str] = None
    key_partitions: Optional[int] = None


@dataclasses.dataclass
class DropTable:
    name: str
    if_exists: bool = False


@dataclasses.dataclass
class AlterTable:
    name: str
    add: Optional[ColumnDef] = None
    drop: Optional[str] = None


@dataclasses.dataclass
class InsertStatement:
    table: str
    columns: List[str]
    rows: List[List[Expr]]
    replace: bool = False


@dataclasses.dataclass
class BulkInsert:
    table: str
    columns: List[str]           # target table columns
    map_defs: List[Tuple[str, str]]  # (source expr/position, sql type)
    source: str                  # file path or inline data
    options: dict = dataclasses.field(default_factory=dict)
    # WITH options: FORMAT 'CSV', INPUT 'FILE'|'STREAM', HEADER_ROW, BATCHSIZE n


@dataclasses.dataclass
class DeleteStatement:
    table: str
    where: Optional[Expr] = None


@dataclasses.dataclass
class ShowTables:
    pass


@dataclasses.dataclass
class ShowColumns:
    table: str


@dataclasses.dataclass
class ShowDatabases:
    pass
