"""Distributed SQL subtree execution: a plan subtree fanned out to the
shard owners.

Port of ``pilosa_tpu/sql/fanout.py`` (reference:
sql3/planner/executionplanner.go:212-338, mapReducePlanOp and opfanout
shipping serialized plan subtrees to shard owners over /sql-exec-graph;
sql3/planner/wireprotocol.go). The subtree is a *logical* spec: the
scanned fields, a PQL pushdown filter, a host filter, computed columns
and an optional partial aggregation, serialized as JSON and run on each
node against only that node's shards. What crosses the wire is the
filtered rows, or the per-group partial aggregate states.

Three pieces:

- ``expr_to_json`` / ``expr_from_json``: the SQL expression wire codec
  (the AST is plain dataclasses; the reference's typed tokens become
  tagged JSON, byte for byte the JAX package's);
- ``execute_subtree``: the node-local evaluation, on the shard owner,
  through the node's own translator, so that strings resolve where the
  data is. Its scan launches the node's kernels through
  ``ClusterExecutor.local``;
- ``FanoutScanOp`` / ``FanoutAggOp``: the coordinator's plan operators,
  which fan the spec out with the PQL map/reduce's primary-to-replica
  failover (``ClusterExecutor.sql_subtree``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, List, Optional, Tuple

from pilosa_tpu_torch.sql import ast
from pilosa_tpu_torch.sql.lexer import SQLError
from pilosa_tpu_torch.sql.plan import (AggSpec, AggState, CallbackOp,
                                       FilterOp, PlanOp, ProjectOp, Row,
                                       Schema, _hashable)

_EXPR_TYPES = {c.__name__: c for c in (
    ast.Literal, ast.ColumnRef, ast.Star, ast.Binary, ast.Unary,
    ast.InList, ast.Between, ast.IsNull, ast.Like, ast.FuncCall)}


def expr_to_json(e: Optional[ast.Expr]):
    """``{"_t": class name, field: value, ...}`` in the dataclass's field
    order, sub-expressions nested the same way; None stays None."""
    if e is None:
        return None
    d: Dict[str, Any] = {"_t": type(e).__name__}
    for f in dataclasses.fields(e):
        v = getattr(e, f.name)
        if isinstance(v, ast.Expr):
            v = expr_to_json(v)
        elif isinstance(v, list):
            v = [expr_to_json(x) if isinstance(x, ast.Expr) else x
                 for x in v]
        d[f.name] = v
    return d


def expr_from_json(d) -> Optional[ast.Expr]:
    if d is None:
        return None
    cls = _EXPR_TYPES.get(d.get("_t"))
    if cls is None:
        raise SQLError(f"bad wire expression {d.get('_t')!r}")
    kwargs = {}
    for f in dataclasses.fields(cls):
        v = d.get(f.name)
        if isinstance(v, dict) and "_t" in v:
            v = expr_from_json(v)
        elif isinstance(v, list):
            v = [expr_from_json(x) if isinstance(x, dict) and "_t" in x
                 else x for x in v]
        kwargs[f.name] = v
    return cls(**kwargs)


# ---------------------------------------------------------------------------
# Node-local execution
# ---------------------------------------------------------------------------

def _local_scan(api, idx, field_names: List[str], pql: Optional[str],
                shards: List[int]) -> CallbackOp:
    """Extract over ONLY ``shards`` (this node's), translated through this
    node's translator: the rows a node sends carry final values and the
    coordinator never translates them again (the reference translates
    before its remote call; here translation moves to the data node
    because a host filter needs the string values)."""
    from pilosa_tpu_torch.pql.ast import Call, Query
    from pilosa_tpu_torch.pql.parser import parse
    from pilosa_tpu_torch.sql.planner import _convert_scan_value
    from pilosa_tpu_torch.sql.types import field_to_sql_type, id_sql_type

    ce = api.executor  # the node's ClusterExecutor
    fields = [idx.field(f) for f in field_names]
    schema: Schema = [("_id", id_sql_type(idx.options.keys))]
    schema += [(f.name, field_to_sql_type(f.options)) for f in fields]

    def thunk():
        filter_call = parse(pql).calls[0] if pql else Call("All")
        call = Call("Extract",
                    children=[filter_call] +
                             [Call("Rows", {"_field": f})
                              for f in field_names])
        call = ce._pre_translate(idx, call, create=False)
        # local execution only: no second fan-out, also where this node
        # serves the shards as a failover replica
        raw = ce.local.execute(idx.name, Query([call]), shards=shards)[0]
        table = ce._post_translate(idx, call, raw)
        for col in table.columns:
            row: List[Any] = [col.key if idx.options.keys else col.column]
            for f, v in zip(fields, col.rows):
                row.append(_convert_scan_value(f, v))
            yield row

    return CallbackOp(schema, thunk, name="LocalShardScan")


def _specs_from_wire(aggs) -> List[Tuple[str, AggSpec]]:
    return [(name, AggSpec(func, expr_from_json(ej), distinct=bool(dist)))
            for name, func, ej, dist in aggs]


def execute_subtree(api, spec: dict, shards: List[int]) -> dict:
    """Run a subtree spec against this node's ``shards``: JSON-safe
    ``{"rows": [...]}``, the filtered scan rows, or the per-group partial
    aggregate states when the spec carries ``aggs``."""
    idx = api.holder.index(spec["index"])
    op: PlanOp = _local_scan(api, idx, spec.get("fields") or [],
                             spec.get("pql"), [int(s) for s in shards])
    hf = expr_from_json(spec.get("host_filter"))
    if hf is not None:
        op = FilterOp(op, hf)
    computed = [(name, "INT", expr_from_json(ej))
                for name, ej in spec.get("computed") or []]
    if computed:
        passthrough = [(n, t, ast.ColumnRef(n)) for n, t in op.schema]
        op = ProjectOp(op, passthrough + computed)
    if spec.get("aggs") is not None:
        return {"rows": _partial_groupby(
            op, spec.get("group_by") or [],
            _specs_from_wire(spec["aggs"]))}
    rows = [list(r) for r in op.rows()]
    order = spec.get("order_by")
    if order:
        names = [n for n, _ in op.schema]
        for col, desc in reversed(order):
            i = names.index(col)
            rows.sort(key=lambda r: (r[i] is None, _hashable(r[i])),
                      reverse=bool(desc))
    limit = spec.get("limit")
    if limit is not None:
        # truncating a node's stream is sound because the coordinator's
        # OrderBy / Limit operators above the fan-out sort and cut again
        rows = rows[: int(limit)]
    return {"rows": rows}


def _partial_groupby(op: PlanOp, group_names: List[str],
                     specs: List[Tuple[str, AggSpec]]) -> List[list]:
    """GroupByOp's accumulation, emitting mergeable partial states
    ``[count, total, min, max, distinct values]`` instead of results."""
    names = [n for n, _ in op.schema]
    groups: Dict[tuple, List[AggState]] = {}
    order: List[tuple] = []
    for row in op.rows():
        env = dict(zip(names, row))
        key = tuple(_hashable(env[g]) for g in group_names)
        if key not in groups:
            groups[key] = [AggState(spec) for _, spec in specs]
            order.append(key)
        for st in groups[key]:
            st.add(env)
    out = []
    for key in order:
        out.append([
            [list(k) if isinstance(k, tuple) else k for k in key],
            [[st.count, st.total, st.mn, st.mx,
              [list(v) if isinstance(v, tuple) else v
               for v in st.distinct]]
             for st in groups[key]]])
    return out


# ---------------------------------------------------------------------------
# Coordinator operators
# ---------------------------------------------------------------------------

class FanoutScanOp(PlanOp):
    """A filtered scan run on the shard owners: the streams come back
    host-filtered already (and, with a pushed ORDER BY + LIMIT, sorted
    and cut on each node) and are concatenated."""

    def __init__(self, cluster, spec: dict, schema: Schema):
        self.cluster = cluster
        self.spec = spec
        self.schema = schema

    def rows(self) -> Iterator[Row]:
        for part in self.cluster.sql_subtree(self.spec):
            yield from part["rows"]

    def plan_json(self) -> dict:
        d = super().plan_json()
        d["fanout"] = {k: v for k, v in self.spec.items()
                       if k in ("index", "fields", "pql")}
        return d


class FanoutAggOp(PlanOp):
    """Distributed partial aggregation: the nodes group and accumulate
    their own rows, the coordinator merges the states and finishes them
    (GroupByOp's monoid reduce, as the reference's pushed-down
    oppqlmultigroupby, for aggregates evaluated on the host)."""

    def __init__(self, cluster, spec: dict, group_schema: Schema,
                 specs: List[Tuple[str, str, AggSpec]]):
        self.cluster = cluster
        self.spec = spec
        self._specs = specs
        self.schema = group_schema + [(n, t) for n, t, _ in specs]

    def rows(self) -> Iterator[Row]:
        merged: Dict[tuple, List[AggState]] = {}
        order: List[tuple] = []
        for part in self.cluster.sql_subtree(self.spec):
            for key_w, states_w in part["rows"]:
                key = tuple(tuple(k) if isinstance(k, list) else k
                            for k in key_w)
                if key not in merged:
                    merged[key] = [AggState(spec)
                                   for _, _, spec in self._specs]
                    order.append(key)
                for st, (cnt, total, mn, mx, dist) in zip(
                        merged[key], states_w):
                    st.count += cnt
                    st.total += total
                    if mn is not None:
                        st.mn = mn if st.mn is None else min(st.mn, mn)
                    if mx is not None:
                        st.mx = mx if st.mx is None else max(st.mx, mx)
                    st.distinct.update(
                        tuple(v) if isinstance(v, list) else v
                        for v in dist)
        if not order and not self.spec.get("group_by"):
            yield [spec.new_state().result() for _, _, spec in self._specs]
            return
        for key in order:
            yield list(key) + [st.result() for st in merged[key]]
