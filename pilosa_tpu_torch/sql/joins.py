"""Bitwise semi-join plane for star-schema SQL joins.

Reference: "Enabling Relational Database Analytical Processing in
Bulk-Bitwise Processing-In-Memory" — an FK equi-join against a filtered
dimension IS a bitmap operation: evaluate the dimension predicate to a
row-id set on the dimension index, then select exactly those rows of the
fact table's FK field. Here that selection is ``UnionRows(Rows(fk,
in=[ids]))`` — a plane the tape/fusion machinery already knows how to
mask, fuse and fan out — so the whole star join runs as ONE compiled
fact dispatch per shard group instead of a host hash join over
materialized scans.

Two strategies, picked by whether dimension attributes are referenced
outside the ON clause:

* **pure semi-join** (Q1-style: dimensions only filter): the statement
  is rewritten to a single-table fact SELECT whose WHERE carries the
  broadcast bitmaps as :class:`ast.PQLFilter` conjuncts. Every
  single-table optimization — aggregate fusion into kernel calls,
  GroupBy fast path, cluster fanout, ORDER/LIMIT pushdown — applies
  unchanged.
* **decorated scan** (Q2–Q4: grouping/projecting dimension attributes):
  the fact side still runs as one semi-filtered Extract dispatch; a
  host-side :class:`DimDecorateOp` then appends the dimension
  attributes by FK lookup into the (small) dimension leg result. An FK
  equi-join on ``dim._id`` matches at most one dimension row per fact
  row, so decoration reproduces INNER join semantics exactly.

Shapes the rewriter can't prove safe (OUTER joins, non-FK ON
conditions, unlowerable dimension predicates, cross-table residuals)
return ``None`` and the planner falls back to the host hash join —
never a silently wrong answer. ``PILOSA_TPU_SEMIJOIN=0`` disables the
plane entirely (the bench baseline).

Port of ``pilosa_tpu/sql/joins.py``. The dimension legs charge a tenant
registry when the API has one (``api.tenants``); the port's API has none
yet, so they charge nothing.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, List, Optional, Tuple

from pilosa_tpu_torch.core.index import Index
from pilosa_tpu_torch.core.schema import FieldType
from pilosa_tpu_torch.obs import metrics as M
from pilosa_tpu_torch.obs import tenants as obs_tenants
from pilosa_tpu_torch.obs.tracing import active_span
from pilosa_tpu_torch.pql.ast import Call, Query
from pilosa_tpu_torch.sql import ast, plan
from pilosa_tpu_torch.sql.lexer import SQLError
from pilosa_tpu_torch.sql.plan import PlanOp
from pilosa_tpu_torch.sql.planner import (CannotLower, _columns_of, _convert_scan_value,
                                    _flatten_and, _qualified_refs, _unqualify)
from pilosa_tpu_torch.sql.types import field_to_sql_type, id_sql_type


class _CannotSemiJoin(Exception):
    """The join shape has no provably-correct bitmap form; the caller
    falls back to the host hash join."""


def _enabled() -> bool:
    return os.environ.get("PILOSA_TPU_SEMIJOIN", "1") != "0"


def try_semi_join(planner, s: ast.SelectStatement,
                  tables: List[Tuple[str, str]], idxs: Dict[str, Index],
                  items: List[ast.SelectItem], ons: List[ast.Expr],
                  where: Optional[ast.Expr], group_by: List[ast.Expr],
                  having: Optional[ast.Expr],
                  order_by: List[ast.OrderTerm]) -> Optional[PlanOp]:
    """Compile a star join to the semi-join plane, or ``None`` to fall
    back. All expression arguments are post-qualification (every
    ColumnRef carries its owning alias)."""
    if not _enabled():
        return None
    try:
        op = _plan(planner, s, tables, idxs, items, ons, where,
                   group_by, having, order_by)
    except (_CannotSemiJoin, CannotLower):
        M.REGISTRY.count(M.METRIC_SQL_JOIN_FALLBACK)
        return None
    M.REGISTRY.count(M.METRIC_SQL_JOIN_QUERIES)
    return op


# -- shape analysis ----------------------------------------------------------

def _fk_fields(s: ast.SelectStatement, tables: List[Tuple[str, str]],
               idxs: Dict[str, Index], ons: List[ast.Expr]
               ) -> Dict[str, str]:
    """dim alias -> fact FK field name, when every join is an INNER
    FK equi-join ``fact.fk = dim._id`` (either operand order)."""
    fact_alias = tables[0][0]
    fact_idx = idxs[fact_alias]
    fks: Dict[str, str] = {}
    for j, on in zip(s.joins, ons):
        if j.kind != "INNER":
            raise _CannotSemiJoin("outer join")
        a = j.alias or j.table
        conjs = _flatten_and(on)
        if len(conjs) != 1:
            raise _CannotSemiJoin("compound ON")
        c = conjs[0]
        if not (isinstance(c, ast.Binary) and c.op == "="
                and isinstance(c.left, ast.ColumnRef)
                and isinstance(c.right, ast.ColumnRef)):
            raise _CannotSemiJoin("non-equi ON")
        l, r = c.left, c.right
        if l.table == a and r.table == fact_alias:
            l, r = r, l
        if not (l.table == fact_alias and r.table == a):
            raise _CannotSemiJoin("snowflake ON")  # dim-to-dim chain
        if r.name != "_id" or l.name == "_id":
            raise _CannotSemiJoin("ON is not fact.fk = dim._id")
        fk = fact_idx.field(l.name)
        if fk.options.type != FieldType.MUTEX:
            raise _CannotSemiJoin("fk is not a mutex field")
        # the fk row domain must BE the dimension's record-id domain for
        # the broadcast ids to mean the same thing on both sides
        if bool(fk.options.keys) != bool(idxs[a].options.keys):
            raise _CannotSemiJoin("fk/dim key domains differ")
        fks[a] = l.name
    return fks


def _split_where(planner, where: Optional[ast.Expr], fact_alias: str,
                 dims: List[str], idxs: Dict[str, Index]
                 ) -> Tuple[List[ast.Expr], Dict[str, List[Call]]]:
    """WHERE conjuncts -> (fact-side conjuncts, per-dim lowered PQL).
    Any cross-table conjunct or unlowerable dimension predicate bails:
    both would need the hash join's row-level visibility."""
    fact_conjs: List[ast.Expr] = []
    dim_calls: Dict[str, List[Call]] = {a: [] for a in dims}
    for c in (_flatten_and(where) if where is not None else []):
        owners = {r.table for r in _qualified_refs(c)}
        if len(owners) > 1:
            raise _CannotSemiJoin("cross-table WHERE conjunct")
        a = owners.pop() if owners else fact_alias
        if a == fact_alias:
            fact_conjs.append(c)
            continue
        try:
            dim_calls[a].append(planner.lower_filter(idxs[a], _unqualify(c)))
        except CannotLower:
            raise _CannotSemiJoin("unlowerable dimension predicate")
    return fact_conjs, dim_calls


def _dim_refs(fact_alias: str, dims: List[str], items, group_by, having,
              order_by) -> Tuple[set, Dict[str, List[str]]]:
    """(fact columns, dim alias -> attribute names) referenced anywhere
    outside the ON clauses."""
    refs: List[ast.ColumnRef] = []
    for e in ([it.expr for it in items] + list(group_by) +
              ([having] if having is not None else []) +
              [t.expr for t in order_by]):
        refs.extend(_qualified_refs(e))
    fact_cols: set = set()
    dim_attrs: Dict[str, List[str]] = {a: [] for a in dims}
    for r in refs:
        if r.table == fact_alias:
            fact_cols.add(r.name)
        elif r.table in dim_attrs:
            if r.name not in dim_attrs[r.table]:
                dim_attrs[r.table].append(r.name)
        # bare refs (output-alias ORDER BY) resolve downstream
    return fact_cols, dim_attrs


# -- dimension legs ----------------------------------------------------------

def _dim_leg(planner, idx: Index, calls: List[Call], attrs: List[str]
             ) -> Tuple[List[Any], Optional[Dict[Any, list]]]:
    """Evaluate one dimension leg: predicate -> matching row ids, plus
    (when attributes are referenced) an id -> attribute-values map for
    host-side decoration. No predicate means every dimension row — the
    broadcast still applies so INNER semantics hold for dangling FKs.
    Runs on the read executor, so on a cluster the leg fans out over the
    dimension's own shard owners like any other query."""
    executor = planner._read_executor()
    filt = (calls[0] if len(calls) == 1
            else Call("Intersect", children=calls) if calls else None)
    t0 = time.perf_counter()
    keyed = idx.options.keys
    vals: Optional[Dict[Any, list]] = None
    cols = [n for n in attrs if n != "_id"]
    if cols:
        call = Call("Extract", children=[filt or Call("All")] +
                    [Call("Rows", {"_field": n}) for n in cols])
        table = executor.execute(idx.name, Query([call]))[0]
        fields = [idx.field(n) for n in cols]
        ids: List[Any] = []
        vals = {}
        for col in table.columns:
            rid = col.key if keyed else col.column
            ids.append(rid)
            by_name = {n: _convert_scan_value(f, v)
                       for n, f, v in zip(cols, fields, col.rows)}
            by_name["_id"] = rid
            vals[rid] = [by_name[n] for n in attrs]
    else:
        res = executor.execute(idx.name, Query([filt or Call("All")]))[0]
        ids = list(res.keys if res.keys is not None else res.columns)
        if attrs:  # only "_id" referenced
            vals = {rid: [rid] for rid in ids}
    dt = time.perf_counter() - t0
    active_span().record("sql.join.dim_scan", dt, index=idx.name,
                         rows=len(ids))
    M.REGISTRY.count(M.METRIC_SQL_JOIN_DIM_ROWS, len(ids))
    # the dimension side is real work on another index: charge it to the
    # tenant alongside the fact-side query (device seconds accrue via
    # the installed dispatch hooks as usual)
    reg = getattr(planner.api, "tenants", None)
    if reg is not None:
        reg.note(obs_tenants.current_tenant_id(), queries=1)
    return ids, vals


# -- decorated scan ----------------------------------------------------------

class DimDecorateOp(PlanOp):
    """Append dimension attributes to a semi-filtered fact stream by FK
    lookup (the probe side of the join, against a leg result that is
    tiny by star-schema construction). Rows whose FK misses the map are
    dropped — INNER semantics for dangling references."""

    def __init__(self, child: PlanOp, fk_col: str,
                 out_cols: List[Tuple[str, str]], values: Dict[Any, list]):
        self.child = child
        self._fk_col = fk_col
        self._values = values
        self.schema = child.schema + out_cols

    def child_ops(self) -> List[PlanOp]:
        return [self.child]

    def plan_json(self) -> dict:
        d = super().plan_json()
        d["op"] = "DimSemiDecorate"
        d["fk"] = self._fk_col
        d["dim_rows"] = len(self._values)
        return d

    def rows(self):
        i = [n for n, _ in self.child.schema].index(self._fk_col)
        for row in self.child.rows():
            vals = self._values.get(row[i])
            if vals is None:
                continue
            yield row + vals


# -- planning ----------------------------------------------------------------

def _plan(planner, s, tables, idxs, items, ons, where, group_by, having,
          order_by) -> PlanOp:
    fact_alias = tables[0][0]
    fact_idx = idxs[fact_alias]
    dims = [a for a, _ in tables[1:]]
    fks = _fk_fields(s, tables, idxs, ons)
    fact_conjs, dim_calls = _split_where(planner, where, fact_alias,
                                         dims, idxs)
    fact_cols, dim_attrs = _dim_refs(fact_alias, dims, items, group_by,
                                     having, order_by)

    # dimension legs -> broadcast planes. Ids ship inside the PQL call
    # itself (Rows in=), so cluster fan-out legs and the per-shard rleg
    # caches see them exactly like any other literal operand.
    t0 = time.perf_counter()
    legs: Dict[str, Tuple[List[Any], Optional[Dict[Any, list]]]] = {}
    semi_calls: List[Call] = []
    nbytes = 0
    for a in dims:
        ids, vals = _dim_leg(planner, idxs[a], dim_calls[a], dim_attrs[a])
        legs[a] = (ids, vals)
        semi_calls.append(Call("UnionRows", children=[
            Call("Rows", {"_field": fks[a], "in": list(ids)})]))
        nbytes += sum(len(str(i)) + 1 for i in ids)
    active_span().record("sql.join.broadcast", time.perf_counter() - t0,
                         dims=len(dims),
                         row_ids=sum(len(legs[a][0]) for a in dims))
    M.REGISTRY.count(M.METRIC_SQL_JOIN_BROADCAST_BYTES, nbytes)

    if not any(dim_attrs[a] for a in dims):
        # pure semi-join: rewrite to a single-table fact SELECT carrying
        # the broadcasts as PQLFilter conjuncts; the whole single-table
        # pipeline (kernel aggregate fusion, fanout, pushdowns) applies
        w: Optional[ast.Expr] = None
        for c in list(fact_conjs) + [ast.PQLFilter(c.to_pql())
                                     for c in semi_calls]:
            w = c if w is None else ast.Binary("AND", w, c)
        s2 = dataclasses.replace(s, joins=[], items=items, where=w,
                                 group_by=list(group_by), having=having,
                                 order_by=list(order_by))
        try:
            return planner.plan_select(s2)
        except SQLError:
            # the single-table pipeline refuses some shapes the host
            # hash join can still evaluate (e.g. SUM over a non-int
            # column): never be stricter than the fallback
            raise _CannotSemiJoin("single-table rewrite refused")

    # decorated scan: one semi-filtered fact dispatch + host decoration
    need = set(fact_cols)
    for a in dims:
        if dim_attrs[a]:
            need.add(fks[a])
    f_low: List[Call] = []
    host_pred: Optional[ast.Expr] = None
    for c in fact_conjs:
        u = _unqualify(c)
        try:
            f_low.append(planner.lower_filter(fact_idx, u))
        except CannotLower:
            host_pred = u if host_pred is None \
                else ast.Binary("AND", host_pred, u)
            need |= _columns_of(u)
    filter_call = (f_low + semi_calls)[0] \
        if len(f_low) + len(semi_calls) == 1 \
        else Call("Intersect", children=f_low + semi_calls)
    scan = planner._filtered_scan(fact_idx, sorted(need - {"_id"}),
                                  filter_call, host_pred)
    op: PlanOp = plan.AliasOp(scan, fact_alias)
    for a in dims:
        if not dim_attrs[a]:
            continue
        out_cols = [(f"{a}.{n}", _attr_type(idxs[a], n))
                    for n in dim_attrs[a]]
        op = DimDecorateOp(op, f"{fact_alias}.{fks[a]}", out_cols,
                           legs[a][1])
    aliases = [a for a, _ in tables]
    return planner._finish_join_plan(op, s, idxs, aliases, items,
                                     group_by, having, order_by)


def _attr_type(idx: Index, name: str) -> str:
    if name == "_id":
        return id_sql_type(idx.options.keys)
    return field_to_sql_type(idx.field(name).options)
