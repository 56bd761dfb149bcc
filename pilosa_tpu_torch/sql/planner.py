"""SQL planner: analyze + compile statements to plan-operator trees.

Reference: sql3/planner/executionplanner.go:32 (CompilePlan: analyze ->
compile -> optimize). The central optimization here is the same one the
reference's planoptimizer.go performs — push WHERE trees down into the
bitmap engine (filter pushdown into PQL table scans, aggregate fusion
into PQL aggregate/groupby calls) — so the heavy work runs as the
executor's kernels and the host only sees reduced streams. Expressions
with no bitmap form fall back to a host filter over the scan.

Port of ``pilosa_tpu/sql/planner.py``. Plan nodes read through
``read_executor``: on a single node the scheduling facade when it is on
(SELECT kernels micro-batch), on a cluster node the cluster executor.
On a cluster node a host filter, with its scan, ships to the shard
owners as a fan-out subtree (``FanoutScanOp``, with an ORDER BY + LIMIT
pushed into it where each term is a scanned column), and a host
aggregate becomes a distributed partial aggregate (``FanoutAggOp``):
see ``sql/fanout.py``.
"""

from __future__ import annotations

import dataclasses
import datetime as dt
import threading
from typing import Any, Dict, List, Optional, Tuple

from pilosa_tpu_torch.core.field import Field
from pilosa_tpu_torch.core.index import Index
from pilosa_tpu_torch.core.schema import FieldType
from pilosa_tpu_torch.pql.ast import Call, Condition, Query
from pilosa_tpu_torch.sql import ast, plan
from pilosa_tpu_torch.sql.lexer import SQLError
from pilosa_tpu_torch.sql.plan import AggSpec, CallbackOp, PlanOp, Schema, StaticOp
from pilosa_tpu_torch.sql.types import field_to_sql_type, id_sql_type

AGGS = {"COUNT", "SUM", "AVG", "MIN", "MAX", "PERCENTILE"}

_TIME_UNITS_PER_S = {"s": 1, "ms": 1000, "us": 10**6, "ns": 10**9}


class CannotLower(Exception):
    """Raised when a WHERE expression has no PQL/bitmap form."""


class _QueryCtx:
    """Per-query planning state (hidden ORDER BY columns, aggregate
    naming). One instance per plan_select call so a shared Planner is
    safe under the threaded HTTP server."""

    def __init__(self):
        self.hidden: list = []
        self.agg_names: Dict[str, str] = {}
        self.grp_rewrites: Dict[str, str] = {}  # repr(group expr) -> name


class Planner:
    def __init__(self, api):
        self.api = api
        # CREATE VIEW definitions (reference: sql3 CREATE VIEW; node-
        # local, engine-lifetime). Shared with the SQLEngine.
        self.views: Dict[str, ast.SelectStatement] = {}
        # per-THREAD view expansion stack: the planner is shared across
        # HTTP server threads, so a planner-level set would make
        # concurrent reads of one view trip the cycle guard
        self._expanding_local = threading.local()

    def _read_executor(self):
        """Executor for read-only plan nodes: the scheduling facade when
        the api has one enabled (micro-batches concurrent SELECT kernels),
        else the raw executor. Resolved per-plan so enabling/disabling the
        scheduler at runtime affects subsequent queries."""
        return self.api.read_executor()

    # -- entry ---------------------------------------------------------------

    def plan_select(self, s: ast.SelectStatement) -> PlanOp:
        if s.derived is not None:
            # derived table: the outer select runs over the subquery's
            # row stream, exactly like a view over its definition
            # (reference: defs_subquery.go FROM (SELECT ...) sources)
            if s.joins:
                raise SQLError(
                    "JOIN over a derived table is not supported")
            inner = self.plan_select(s.derived)
            return self._plan_over_inner(s, inner, "subquery")
        if s.table is None:
            return self._select_no_table(s)
        if s.joins:
            return self._plan_join_select(s)
        if s.table in self.views:
            return self._plan_view_select(s)
        s = _strip_single_table_quals(s)
        ctx = _QueryCtx()
        idx = self.api.holder.index(s.table)
        items = self._expand_star(idx, s.items)
        if s.group_by or any(_contains_agg(it.expr) for it in items):
            op = self._plan_aggregate(idx, s, items, ctx)
        else:
            op = self._plan_scan_select(idx, s, items, ctx)
        if s.order_by:
            op = self._apply_order(op, s, items, ctx)
        if s.distinct:
            op = plan.DistinctOp(op)
        limit = s.limit if s.limit is not None else s.top
        if limit is not None or s.offset:
            op = plan.LimitOp(op, limit, s.offset)
        return op

    def _select_no_table(self, s: ast.SelectStatement) -> PlanOp:
        row = [plan.eval_expr(it.expr, {}) for it in s.items]
        schema = [(it.alias or f"col_{i}", _literal_type(v))
                  for i, (it, v) in enumerate(zip(s.items, row))]
        return StaticOp(schema, [row])

    # -- star expansion & naming ---------------------------------------------

    def _expand_star(self, idx: Index, items: List[ast.SelectItem]
                     ) -> List[ast.SelectItem]:
        out: List[ast.SelectItem] = []
        for it in items:
            if isinstance(it.expr, ast.Star):
                out.append(ast.SelectItem(ast.ColumnRef("_id")))
                for f in idx.public_fields():
                    out.append(ast.SelectItem(ast.ColumnRef(f.name)))
            else:
                out.append(it)
        return out

    def _item_name(self, it: ast.SelectItem, i: int) -> str:
        if it.alias:
            return it.alias
        if isinstance(it.expr, ast.ColumnRef):
            return it.expr.name
        if isinstance(it.expr, ast.FuncCall):
            return it.expr.name.lower()
        return f"col_{i}"

    def _item_type(self, idx: Index, expr: ast.Expr) -> str:
        if isinstance(expr, ast.ColumnRef):
            if expr.name == "_id":
                return id_sql_type(idx.options.keys)
            return field_to_sql_type(idx.field(expr.name).options)
        if isinstance(expr, ast.FuncCall):
            if expr.name == "COUNT":
                return "INT"
            if expr.name in ("SUM", "MIN", "MAX", "PERCENTILE"):
                if expr.args and isinstance(expr.args[0], ast.ColumnRef):
                    return self._item_type(idx, expr.args[0])
                return "INT"
            if expr.name == "AVG":
                return "DECIMAL(4)"
            if expr.name in ("SETCONTAINS", "SETCONTAINSANY", "SETCONTAINSALL"):
                return "BOOL"
            return "INT"
        if isinstance(expr, ast.Literal):
            return _literal_type(expr.value)
        if isinstance(expr, (ast.Binary,)) and expr.op in (
                "=", "!=", "<", "<=", ">", ">=", "AND", "OR"):
            return "BOOL"
        return "INT"

    # -- plain scan select ----------------------------------------------------

    def _plan_scan_select(self, idx: Index, s: ast.SelectStatement,
                          items: List[ast.SelectItem],
                          ctx: _QueryCtx) -> PlanOp:
        needed = set()
        for it in items:
            needed |= _columns_of(it.expr)
        out_names = {self._item_name(it, i) for i, it in enumerate(items)}
        for t in s.order_by:
            # alias refs resolve against projected output, not the table
            needed |= _columns_of(t.expr) - out_names
        filter_call, host_pred = self._split_filter(idx, s.where)
        if host_pred is not None:
            needed |= _columns_of(host_pred)
        op: PlanOp = self._filtered_scan(
            idx, sorted(needed - {"_id"}), filter_call, host_pred)
        self._push_order_limit(op, s, items)
        proj = [(self._item_name(it, i), self._item_type(idx, it.expr), it.expr)
                for i, it in enumerate(items)]
        # hidden order-by columns ride along; trimmed after the sort
        names = {p[0] for p in proj}
        for t in s.order_by:
            for c in _columns_of(t.expr):
                if c not in names:
                    ctx.hidden.append((c, self._item_type(idx, ast.ColumnRef(c)),
                                       ast.ColumnRef(c)))
                    names.add(c)
        return plan.ProjectOp(op, proj + ctx.hidden)

    def _apply_order(self, op: PlanOp, s: ast.SelectStatement,
                     items: List[ast.SelectItem], ctx: _QueryCtx) -> PlanOp:
        # an ORDER BY term structurally equal to a projected item sorts by
        # that output column; otherwise aggregates/group-exprs resolve via
        # the same structural rewrites as projections
        by_item = {repr(it.expr): self._item_name(it, i)
                   for i, it in enumerate(items)}
        terms = []
        for t in s.order_by:
            if repr(t.expr) in by_item:
                terms.append((ast.ColumnRef(by_item[repr(t.expr)]), t.desc))
            else:
                terms.append((_rewrite_ctx(t.expr, ctx), t.desc))
        op = plan.OrderByOp(op, terms)
        if ctx.hidden:
            op = _TrimOp(op, len(op.schema) - len(ctx.hidden))
        return op

    # -- distributed subtree fanout (reference: executionplanner.go:212
    #    mapReducePlanOp; see sql/fanout.py) -----------------------------------

    def _dist_executor(self):
        """The cluster executor when planning on a cluster node (fanout
        available), else None (single-node: host ops run in-process)."""
        ex = getattr(self.api, "executor", None)
        if ex is not None and getattr(ex, "_node_api", None) is not None:
            return ex
        return None

    def _filtered_scan(self, idx: Index, field_names: List[str],
                       filter_call: Optional[Call],
                       host_pred: Optional[ast.Expr]) -> PlanOp:
        """Scan with the host filter applied where the data is: on a
        cluster, a WHERE with no PQL form ships with the subtree and runs
        on each shard owner, so only matching rows cross the wire; a
        single node keeps FilterOp."""
        from pilosa_tpu_torch.sql.fanout import FanoutScanOp, expr_to_json

        scan = self._scan_op(idx, field_names, filter_call)
        if host_pred is None:
            return scan
        dist = self._dist_executor()
        if dist is None:
            return plan.FilterOp(scan, host_pred)
        spec = {"index": idx.name, "fields": field_names,
                "pql": filter_call.to_pql() if filter_call else None,
                "host_filter": expr_to_json(host_pred)}
        return FanoutScanOp(dist, spec, scan.schema)

    def _push_order_limit(self, op: PlanOp, s: ast.SelectStatement,
                          items: List[ast.SelectItem]) -> None:
        """ORDER BY + LIMIT pushdown into a fanout scan: every order term
        must resolve, the way _apply_order will resolve it, to a plain
        scanned column, so each node can sort its own stream and return
        only its top limit+offset rows; the global top-k is contained in
        the union of per-node top-k, and the coordinator's OrderBy/Limit
        ops above the fanout sort and cut again (reference:
        planoptimizer.go pushing top-N toward the scans). An alias that
        shadows a scan column (``select v % 4 as v ... order by v``)
        makes the coordinator sort by the projected expression, so a
        node sort by the raw column would cut the wrong rows: no push."""
        from pilosa_tpu_torch.sql.fanout import FanoutScanOp

        limit = s.limit if s.limit is not None else s.top
        if not isinstance(op, FanoutScanOp) or not s.order_by \
                or limit is None or s.distinct:
            return
        scan_names = {n for n, _ in op.schema}
        by_item = {repr(it.expr): it.expr for it in items}
        out_exprs = {self._item_name(it, i): it.expr
                     for i, it in enumerate(items)}
        terms = []
        for t in s.order_by:
            e = t.expr
            if repr(e) in by_item:
                # _apply_order sorts by that OUTPUT column; push only a
                # pure passthrough of a scanned column
                if not (isinstance(e, ast.ColumnRef) and e.table is None
                        and e.name in scan_names):
                    return
                terms.append([e.name, bool(t.desc)])
                continue
            if not (isinstance(e, ast.ColumnRef) and e.table is None
                    and e.name in scan_names):
                return
            shadow = out_exprs.get(e.name)
            if shadow is not None and not (
                    isinstance(shadow, ast.ColumnRef)
                    and shadow.table is None and shadow.name == e.name):
                return  # alias shadowing: the coordinator sorts the alias
            terms.append([e.name, bool(t.desc)])
        op.spec["order_by"] = terms
        op.spec["limit"] = int(limit) + int(s.offset or 0)

    # -- scan (PQL Extract bridge) --------------------------------------------

    def _scan_op(self, idx: Index, field_names: List[str],
                 filter_call: Optional[Call]) -> CallbackOp:
        """Table scan: Extract(filter, Rows(f)...) on the kernel engine
        (reference: sql3/planner/oppqltablescan.go)."""
        fields = [idx.field(f) for f in field_names]
        schema: Schema = [("_id", id_sql_type(idx.options.keys))]
        schema += [(f.name, field_to_sql_type(f.options)) for f in fields]
        executor = self._read_executor()

        def thunk():
            call = Call("Extract",
                        children=[filter_call or Call("All")] +
                                 [Call("Rows", {"_field": f}) for f in field_names])
            table = executor.execute(idx.name, Query([call]))[0]
            for col in table.columns:
                row: List[Any] = [col.key if idx.options.keys else col.column]
                for f, v in zip(fields, col.rows):
                    row.append(_convert_scan_value(f, v))
                yield row

        return CallbackOp(schema, thunk, name="PQLTableScan")

    # -- WHERE lowering --------------------------------------------------------

    def _split_filter(self, idx: Index, where: Optional[ast.Expr]
                      ) -> Tuple[Optional[Call], Optional[ast.Expr]]:
        """Lower as much of WHERE as possible to a PQL call. Top-level AND
        conjuncts are lowered independently (reference:
        planoptimizer.go filter pushdown); whatever can't be lowered is
        returned as a host predicate."""
        if where is None:
            return None, None
        conjuncts = _flatten_and(where)
        lowered: List[Call] = []
        host: List[ast.Expr] = []
        for c in conjuncts:
            try:
                lowered.append(self.lower_filter(idx, c))
            except CannotLower:
                host.append(c)
        fc = None
        if len(lowered) == 1:
            fc = lowered[0]
        elif lowered:
            fc = Call("Intersect", children=lowered)
        hp = None
        for h in host:
            hp = h if hp is None else ast.Binary("AND", hp, h)
        return fc, hp

    def lower_filter(self, idx: Index, e: ast.Expr) -> Call:
        if isinstance(e, ast.PQLFilter):
            # planner-internal semi-join broadcast (sql/joins.py): the
            # bitmap predicate is already PQL text
            from pilosa_tpu_torch.pql.parser import parse as _pql_parse
            return _pql_parse(e.pql).calls[0]
        if isinstance(e, ast.Binary):
            if e.op == "AND":
                return Call("Intersect", children=[
                    self.lower_filter(idx, e.left),
                    self.lower_filter(idx, e.right)])
            if e.op == "OR":
                return Call("Union", children=[
                    self.lower_filter(idx, e.left),
                    self.lower_filter(idx, e.right)])
            if e.op in ("=", "!=", "<", "<=", ">", ">="):
                return self._lower_cmp(idx, e)
            raise CannotLower(e.op)
        if isinstance(e, ast.Unary) and e.op == "NOT":
            return self._lower_not(idx, e.operand)
        if isinstance(e, ast.InList):
            col, vals = _col_and_literals(e.operand, e.items)
            if col is None:
                raise CannotLower("IN")
            inner = self._lower_in(idx, col, vals)
            if not e.negated:
                return inner
            if col == "_id":
                return Call("Not", children=[inner])
            # NOT IN excludes NULL rows (three-valued logic, as above)
            return Call("Difference",
                        children=[self._notnull_call(idx, col), inner])
        if isinstance(e, ast.Between):
            if not isinstance(e.operand, ast.ColumnRef):
                raise CannotLower("BETWEEN")
            lo, hi = _literal(e.low), _literal(e.high)
            f = self._bsi_field(idx, e.operand.name)
            if e.negated:
                # NOT BETWEEN = < lo OR > hi; BSI compares exclude NULL
                # rows, preserving three-valued logic
                return Call("Union", children=[
                    Call("Row", {f.name: Condition("<", lo)}),
                    Call("Row", {f.name: Condition(">", hi)})])
            return Call("Row", {f.name: Condition("between", [lo, hi])})
        if isinstance(e, ast.IsNull):
            if not isinstance(e.operand, ast.ColumnRef):
                raise CannotLower("IS NULL")
            name = e.operand.name
            field = idx.field(name)
            if field.options.type.is_bsi:
                notnull = Call("Row", {name: Condition("!=", None)})
            else:
                notnull = Call("UnionRows",
                               children=[Call("Rows", {"_field": name})])
            return notnull if e.negated else Call("Not", children=[notnull])
        if isinstance(e, ast.FuncCall):
            return self._lower_func(idx, e)
        if isinstance(e, ast.Literal):
            if e.value is True:
                return Call("All")
            raise CannotLower("literal")
        if isinstance(e, ast.ColumnRef):
            field = idx.field(e.name)
            if field.options.type == FieldType.BOOL:
                return Call("Row", {e.name: True})
            raise CannotLower("bare column")
        raise CannotLower(type(e).__name__)

    def _lower_cmp(self, idx: Index, e: ast.Binary) -> Call:
        col, lit, op = None, None, e.op
        if isinstance(e.left, ast.ColumnRef) and isinstance(e.right, ast.Literal):
            col, lit = e.left.name, e.right.value
        elif isinstance(e.right, ast.ColumnRef) and isinstance(e.left, ast.Literal):
            col, lit = e.right.name, e.left.value
            op = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}.get(op, op)
        if col is None:
            raise CannotLower("cmp")
        if lit is None:
            # comparing to a NULL literal is NULL for every row (use IS
            # NULL for null checks); the host filter's three-valued
            # eval drops every row
            raise CannotLower("null literal comparison")
        if col == "_id":
            if op == "=":
                return Call("ConstRow", {"columns": [lit]})
            if op == "!=":
                return Call("Not",
                            children=[Call("ConstRow", {"columns": [lit]})])
            raise CannotLower("_id range")
        field = idx.field(col)
        t = field.options.type
        if t.is_bsi:
            if lit is None:
                c = Call("Row", {col: Condition("!=", None)})
                return c if op == "!=" else Call("Not", children=[c])
            pql_op = {"=": "==", "!=": "!=", "<": "<", "<=": "<=",
                      ">": ">", ">=": ">="}[op]
            return Call("Row", {col: Condition(pql_op, lit)})
        # set/mutex/bool/time equality
        if op == "=":
            return Call("Row", {col: lit})
        if op == "!=":
            # SQL three-valued logic: NULL != lit is unknown, so complement
            # within the not-null set, not within all records
            return Call("Difference",
                        children=[self._notnull_call(idx, col),
                                  Call("Row", {col: lit})])
        raise CannotLower(f"{t.value} {op}")

    def _lower_not(self, idx: Index, e: ast.Expr) -> Call:
        """Lower NOT <expr> with SQL three-valued logic: push the negation
        down to the leaves (De Morgan is exact in 3VL), where each negated
        comparison excludes NULL rows the same way != does."""
        if isinstance(e, ast.Unary) and e.op == "NOT":
            return self.lower_filter(idx, e.operand)
        if isinstance(e, ast.Binary) and e.op == "AND":
            return Call("Union", children=[self._lower_not(idx, e.left),
                                           self._lower_not(idx, e.right)])
        if isinstance(e, ast.Binary) and e.op == "OR":
            return Call("Intersect", children=[self._lower_not(idx, e.left),
                                               self._lower_not(idx, e.right)])
        if isinstance(e, ast.Binary) and e.op in ("=", "!=", "<", "<=",
                                                  ">", ">="):
            neg = {"=": "!=", "!=": "=", "<": ">=", "<=": ">",
                   ">": "<", ">=": "<="}[e.op]
            return self.lower_filter(idx, ast.Binary(neg, e.left, e.right))
        if isinstance(e, (ast.InList, ast.Between, ast.IsNull, ast.Like)):
            return self.lower_filter(
                idx, dataclasses.replace(e, negated=not e.negated))
        if isinstance(e, ast.ColumnRef):
            field = idx.field(e.name)
            if field.options.type == FieldType.BOOL:
                return Call("Row", {e.name: False})
            raise CannotLower("bare column")
        if isinstance(e, ast.FuncCall) and e.name in (
                "SETCONTAINS", "SETCONTAINSANY", "SETCONTAINSALL"):
            # SETCONTAINS on an empty set is False (not NULL) in the host
            # eval too, so NOT complements within existence
            return Call("Not", children=[self._lower_func(idx, e)])
        raise CannotLower(f"NOT {type(e).__name__}")

    def _notnull_call(self, idx: Index, col: str) -> Call:
        field = idx.field(col)
        if field.options.type.is_bsi:
            return Call("Row", {col: Condition("!=", None)})
        return Call("UnionRows", children=[Call("Rows", {"_field": col})])

    def _lower_in(self, idx: Index, col: str, vals: List[Any]) -> Call:
        if col == "_id":
            return Call("ConstRow", {"columns": list(vals)})
        rows = [Call("Row", {col: v}) for v in vals]
        if len(rows) == 1:
            return rows[0]
        return Call("Union", children=rows)

    def _lower_func(self, idx: Index, e: ast.FuncCall) -> Call:
        if e.name == "RANGEQ":
            # rangeq(quantum_col, from[, to]): records with ANY event in
            # the range (reference: defs_timequantum.go; lowers to a
            # view-ranged UnionRows over the covering quantum views)
            if not e.args or not isinstance(e.args[0], ast.ColumnRef):
                raise SQLError(
                    "rangeq() requires a time-quantum column as its "
                    "first argument")
            fld = idx.field(e.args[0].name)
            if fld.options.type != FieldType.TIME:
                raise SQLError(
                    f"rangeq() column {fld.name!r} is not a time-quantum "
                    "field")
            bounds = [_literal(a) for a in e.args[1:3]]
            args = {"_field": fld.name}
            for key, b in zip(("from", "to"), bounds):
                if b is None:
                    continue
                # a bad bound must be a SQL error, not a bare ValueError
                # from the executor (HTTP 500); the executor parses ISO
                # strings only
                try:
                    if not isinstance(b, str):
                        raise ValueError
                    dt.datetime.fromisoformat(b.replace("Z", "+00:00"))
                except ValueError:
                    raise SQLError(
                        f"rangeq() bound {b!r} is not a timestamp")
                args[key] = b
            return Call("UnionRows", children=[Call("Rows", args)])
        if e.name in ("SETCONTAINS", "SETCONTAINSANY", "SETCONTAINSALL"):
            if not isinstance(e.args[0], ast.ColumnRef):
                raise CannotLower(e.name)
            col = e.args[0].name
            probe = _literal(e.args[1])
            vals = probe if isinstance(probe, list) else [probe]
            rows = [Call("Row", {col: v}) for v in vals]
            if len(rows) == 1:
                return rows[0]
            comb = "Intersect" if e.name == "SETCONTAINSALL" else "Union"
            return Call(comb, children=rows)
        raise CannotLower(e.name)

    def _bsi_field(self, idx: Index, name: str) -> Field:
        f = idx.field(name)
        if not f.options.type.is_bsi:
            raise CannotLower(f"{name} is not int-like")
        return f

    # -- aggregate queries -----------------------------------------------------

    def _plan_aggregate(self, idx: Index, s: ast.SelectStatement,
                        items: List[ast.SelectItem],
                        ctx: _QueryCtx) -> PlanOp:
        aggs = _collect_aggs(items, s.having, s.order_by)
        if s.group_by:
            return self._plan_groupby(idx, s, items, aggs, ctx)
        # no GROUP BY: single output row, each aggregate is one kernel query
        filter_call, host_pred = self._split_filter(idx, s.where)
        if host_pred is not None or not all(_agg_kernel_ok(a) for a in aggs):
            return self._plan_host_aggregate(idx, s, items, aggs, ctx)
        executor = self._read_executor()
        agg_names = self._name_aggs(aggs, ctx)
        hidden = self._hidden_agg_items(idx, items, aggs, s.order_by, ctx)
        schema = [(self._item_name(it, i), self._item_type(idx, it.expr))
                  for i, it in enumerate(items)]
        schema += [(n, t) for n, t, _ in hidden]

        def thunk():
            env: Dict[str, Any] = {}
            for a in aggs:
                env[agg_names[_agg_key(a)]] = self._run_agg(idx, a, filter_call)
            row = [plan.eval_expr(_rewrite_aggs(it.expr, agg_names), env)
                   for it in items]
            row += [plan.eval_expr(e, env) for _, _, e in hidden]
            rows = [row]
            if s.having is not None:
                hv = _rewrite_aggs(s.having, agg_names)
                rows = [r for r in rows if plan.eval_expr(hv, env)]
            return iter(rows)

        return CallbackOp(schema, thunk, name="PQLAggregate")

    def _name_aggs(self, aggs: List[ast.FuncCall],
                   ctx: _QueryCtx) -> Dict[str, str]:
        ctx.agg_names = {_agg_key(a): f"__agg{i}" for i, a in enumerate(aggs)}
        return ctx.agg_names

    def _hidden_agg_items(self, idx: Index, items: List[ast.SelectItem],
                          aggs: List[ast.FuncCall],
                          order_by: List[ast.OrderTerm], ctx: _QueryCtx):
        """Aggregates referenced only by ORDER BY ride along as hidden
        output columns and are trimmed after the sort."""
        if not order_by:
            ctx.hidden = []
            return []
        # every aggregate rides along under its __aggN name so rewritten
        # ORDER BY terms always resolve (projected copies may be aliased)
        hidden = []
        for a in aggs:
            name = ctx.agg_names[_agg_key(a)]
            hidden.append((name, self._item_type(idx, a),
                           ast.ColumnRef(name)))
        ctx.hidden = hidden
        return hidden

    def _run_agg(self, idx: Index, a: ast.FuncCall,
                 filter_call: Optional[Call]) -> Any:
        """One aggregate -> one PQL call (reference:
        sql3/planner/oppqlaggregate.go + planoptimizer aggregate fusion)."""
        executor = self._read_executor()

        def run(call: Call):
            return executor.execute(idx.name, Query([call]))[0]

        if a.distinct and a.name in ("SUM", "AVG", "MIN", "MAX"):
            # distinct numeric aggregates: reduce over the Distinct values
            col = _agg_col(a)
            if not idx.field(col).options.type.is_bsi:
                raise SQLError(f"{a.name}(DISTINCT) requires an int-like column")
            vals = run(Call("Distinct", {"_field": col},
                            children=[filter_call] if filter_call else []))
            if not vals:
                return None
            if a.name == "SUM":
                return sum(vals)
            if a.name == "AVG":
                return sum(vals) / len(vals)
            return min(vals) if a.name == "MIN" else max(vals)
        if a.name == "COUNT":
            if a.distinct:
                col = _agg_col(a)
                dcall = Call("Distinct", {"_field": col},
                             children=[filter_call] if filter_call else [])
                res = run(dcall)
                if isinstance(res, list):
                    return len(res)
                return len(res.keys if res.keys is not None else res.columns)
            if isinstance(a.args[0], ast.Star):
                return run(Call("Count",
                                children=[filter_call or Call("All")]))
            col = _agg_col(a)
            field = idx.field(col)
            if field.options.type.is_bsi:
                vc = run(Call("Sum", {"field": col},
                              children=[filter_call] if filter_call else []))
                return vc.count
            exists = Call("UnionRows", children=[Call("Rows", {"_field": col})])
            target = Call("Intersect", children=[filter_call, exists]) \
                if filter_call else exists
            return run(Call("Count", children=[target]))
        col = _agg_col(a)
        if a.name == "PERCENTILE":
            nth = _literal(a.args[1]) if len(a.args) > 1 else 50
            vc = run(Call("Percentile",
                          {"field": col, "nth": nth},
                          children=[filter_call] if filter_call else []))
            return vc.val
        field = idx.field(col)
        if not field.options.type.is_bsi:
            raise SQLError(f"{a.name}() requires an int-like column")
        if a.name == "AVG":
            vc = run(Call("Sum", {"field": col},
                          children=[filter_call] if filter_call else []))
            return (vc.val / vc.count) if vc.count else None
        call_name = {"SUM": "Sum", "MIN": "Min", "MAX": "Max"}[a.name]
        vc = run(Call(call_name, {"field": col},
                      children=[filter_call] if filter_call else []))
        return vc.val if vc.count else None

    # -- GROUP BY --------------------------------------------------------------

    def _plan_groupby(self, idx: Index, s: ast.SelectStatement,
                      items: List[ast.SelectItem],
                      aggs: List[ast.FuncCall], ctx: _QueryCtx) -> PlanOp:
        group_cols: List[str] = []
        for g in s.group_by:
            if not isinstance(g, ast.ColumnRef):
                return self._plan_host_aggregate(idx, s, items, aggs, ctx)
            group_cols.append(g.name)
        filter_call, host_pred = self._split_filter(idx, s.where)
        fast = host_pred is None and self._groupby_fast_ok(idx, group_cols, aggs)
        if not fast:
            return self._plan_host_aggregate(idx, s, items, aggs, ctx)
        return self._plan_pql_groupby(idx, s, items, aggs, group_cols,
                                      filter_call, ctx)

    def _groupby_fast_ok(self, idx: Index, group_cols: List[str],
                         aggs: List[ast.FuncCall]) -> bool:
        for c in group_cols:
            if c == "_id":
                return False
            t = idx.field(c).options.type
            if t.is_bsi:
                return False
        sum_cols = set()
        for a in aggs:
            if a.name == "COUNT" and not a.distinct and a.args and \
                    isinstance(a.args[0], ast.Star):
                continue
            if a.name == "SUM" and not a.distinct and \
                    isinstance(a.args[0], ast.ColumnRef):
                sum_cols.add(a.args[0].name)
                continue
            return False
        return len(sum_cols) <= 1

    def _plan_pql_groupby(self, idx: Index, s: ast.SelectStatement,
                          items: List[ast.SelectItem],
                          aggs: List[ast.FuncCall], group_cols: List[str],
                          filter_call: Optional[Call],
                          ctx: _QueryCtx) -> PlanOp:
        """GroupBy on the kernel engine (reference:
        sql3/planner/oppqlgroupby.go + oppqlmultigroupby fusion)."""
        executor = self._read_executor()
        agg_names = self._name_aggs(aggs, ctx)
        hidden = self._hidden_agg_items(idx, items, aggs, s.order_by, ctx)
        sum_col = next((a.args[0].name for a in aggs if a.name == "SUM"), None)
        gfields = [idx.field(c) for c in group_cols]
        schema = [(self._item_name(it, i), self._item_type(idx, it.expr))
                  for i, it in enumerate(items)]
        schema += [(n, t) for n, t, _ in hidden]

        def thunk():
            args: Dict[str, Any] = {}
            if filter_call is not None:
                args["filter"] = filter_call
            if sum_col is not None:
                args["aggregate"] = Call("Sum", {"field": sum_col})
            call = Call("GroupBy", args,
                        children=[Call("Rows", {"_field": c})
                                  for c in group_cols])
            groups = executor.execute(idx.name, Query([call]))[0]
            for gc in groups:
                env: Dict[str, Any] = {}
                for f, fr in zip(gfields, gc.group):
                    v = fr.row_key if fr.row_key is not None else fr.row_id
                    if f.options.type == FieldType.BOOL:
                        v = bool(v)
                    env[f.name] = v
                for a in aggs:
                    if a.name == "COUNT":
                        env[agg_names[_agg_key(a)]] = gc.count
                    else:
                        sv = gc.agg
                        if sv is not None:
                            sv = idx.field(sum_col).from_stored(sv) \
                                if idx.field(sum_col).options.type == \
                                FieldType.DECIMAL else sv
                        env[agg_names[_agg_key(a)]] = sv
                if s.having is not None:
                    hv = _rewrite_aggs(s.having, agg_names)
                    if not plan.eval_expr(hv, env):
                        continue
                yield [plan.eval_expr(_rewrite_aggs(it.expr, agg_names), env)
                       for it in items] + \
                    [plan.eval_expr(e, env) for _, _, e in hidden]

        return CallbackOp(schema, thunk, name="PQLGroupBy")

    # -- views -----------------------------------------------------------------

    def _plan_view_select(self, s: ast.SelectStatement) -> PlanOp:
        """SELECT over a stored view: plan the view's definition, then
        run the outer select host-side over its row stream (reference:
        sql3 views compile to their definition as a subquery source).
        PQL pushdown happens INSIDE the view's own plan; the outer
        filter/aggregate layer operates on the reduced stream."""
        name = s.table
        expanding = getattr(self._expanding_local, "names", None)
        if expanding is None:
            expanding = self._expanding_local.names = set()
        if name in expanding:
            raise SQLError(f"circular view reference through {name!r}")
        expanding.add(name)
        try:
            inner = self.plan_select(self.views[name])
        finally:
            expanding.discard(name)
        return self._plan_over_inner(s, inner, f"view {name!r}")

    def _plan_over_inner(self, s: ast.SelectStatement, inner: PlanOp,
                         label: str) -> PlanOp:
        """Outer select over an already-planned row stream (views AND
        derived tables share this; PQL pushdown happened INSIDE the
        inner plan — the outer layer is host ops on the reduced
        stream)."""
        s = _strip_single_table_quals(s)
        types = dict(inner.schema)

        def vtype(e: ast.Expr) -> str:
            if isinstance(e, ast.ColumnRef):
                if e.name not in types:
                    raise SQLError(
                        f"unknown column {e.name!r} in {label}")
                return types[e.name]
            if isinstance(e, ast.FuncCall):
                if e.name == "COUNT":
                    return "INT"
                if e.name in ("SUM", "MIN", "MAX", "PERCENTILE") and \
                        e.args and isinstance(e.args[0], ast.ColumnRef):
                    return vtype(e.args[0])
                if e.name == "AVG":
                    return "DECIMAL(4)"
                return "INT"
            if isinstance(e, ast.Literal):
                return _literal_type(e.value)
            return "INT"

        items: List[ast.SelectItem] = []
        for it in s.items:
            if isinstance(it.expr, ast.Star):
                items += [ast.SelectItem(ast.ColumnRef(n))
                          for n, _ in inner.schema]
            else:
                items.append(it)
        op: PlanOp = inner
        if s.where is not None:
            op = plan.FilterOp(op, s.where)
        ctx = _QueryCtx()
        aggs = _collect_aggs(items, s.having, s.order_by)
        if s.group_by or aggs:
            op = self._join_aggregate(op, items, s.group_by, s.having,
                                      aggs, vtype, ctx, bool(s.order_by))
        else:
            proj = [(self._item_name(it, i), vtype(it.expr), it.expr)
                    for i, it in enumerate(items)]
            names = {p[0] for p in proj}
            for t in s.order_by:
                for r in _qualified_refs(t.expr):
                    if r.name not in names:
                        ctx.hidden.append((r.name, vtype(r),
                                           ast.ColumnRef(r.name)))
                        names.add(r.name)
            op = plan.ProjectOp(op, proj + ctx.hidden)
        if s.order_by:
            by_item = {repr(it.expr): self._item_name(it, i)
                       for i, it in enumerate(items)}
            terms = []
            for t in s.order_by:
                if repr(t.expr) in by_item:
                    terms.append((ast.ColumnRef(by_item[repr(t.expr)]),
                                  t.desc))
                else:
                    terms.append((_rewrite_ctx(t.expr, ctx), t.desc))
            op = plan.OrderByOp(op, terms)
            if ctx.hidden:
                op = _TrimOp(op, len(op.schema) - len(ctx.hidden))
        if s.distinct:
            op = plan.DistinctOp(op)
        limit = s.limit if s.limit is not None else s.top
        if limit is not None or s.offset:
            op = plan.LimitOp(op, limit, s.offset)
        return op

    # -- JOIN ------------------------------------------------------------------

    def _plan_join_select(self, s: ast.SelectStatement) -> PlanOp:
        """SELECT over a left-deep JOIN chain (reference:
        sql3/planner/executionplanner.go compileSource join handling +
        opnestedloops.go; here: per-table PQL-filtered scans feeding a
        host hash join, single-table WHERE conjuncts pushed below the
        join as in planoptimizer.go)."""
        tables: List[Tuple[str, str]] = [
            (s.table_alias or s.table, s.table)]
        tables += [(j.alias or j.table, j.table) for j in s.joins]
        aliases = [a for a, _ in tables]
        if len(set(aliases)) != len(aliases):
            raise SQLError("duplicate table alias in FROM/JOIN")
        idxs: Dict[str, Index] = {
            a: self.api.holder.index(t) for a, t in tables}
        cols: Dict[str, set] = {
            a: {"_id"} | {f.name for f in idxs[a].public_fields()}
            for a in aliases}
        # a qualifier may be the alias or (when still unambiguous) the
        # table's own name, as in `sum(orders.price) ... from orders o`
        by_name: Dict[str, str] = {}
        for a, t in tables:
            by_name.setdefault(t, a)

        def resolve(ref: ast.ColumnRef) -> str:
            """Owning alias of a column ref; validates ambiguity."""
            if ref.table is not None:
                a = ref.table if ref.table in idxs else by_name.get(ref.table)
                if a is None:
                    raise SQLError(f"unknown table alias {ref.table!r}")
                if ref.name not in cols[a]:
                    raise SQLError(f"unknown column {a}.{ref.name}")
                return a
            owners = [a for a in aliases if ref.name in cols[a]]
            if not owners:
                raise SQLError(f"unknown column {ref.name!r}")
            if len(owners) > 1:
                raise SQLError(f"ambiguous column {ref.name!r}")
            return owners[0]

        def qualify(e: ast.Expr) -> ast.Expr:
            return _map_refs(
                e, lambda r: ast.ColumnRef(r.name, table=resolve(r)))

        # star expansion over every joined table
        items: List[ast.SelectItem] = []
        for it in s.items:
            if isinstance(it.expr, ast.Star):
                for a in aliases:
                    items.append(ast.SelectItem(
                        ast.ColumnRef("_id", table=a)))
                    for f in idxs[a].public_fields():
                        items.append(ast.SelectItem(
                            ast.ColumnRef(f.name, table=a)))
            else:
                items.append(ast.SelectItem(qualify(it.expr), it.alias))
        ons = [qualify(j.on) for j in s.joins]
        where = qualify(s.where) if s.where is not None else None
        group_by = [qualify(g) for g in s.group_by]
        having = qualify(s.having) if s.having is not None else None
        out_names = {self._item_name(it, i) for i, it in enumerate(items)}

        def qualify_order(e: ast.Expr) -> ast.Expr:
            # a bare ref naming a projected output sorts by that output
            # column (alias precedence, as in the single-table path)
            if isinstance(e, ast.ColumnRef) and e.table is None \
                    and e.name in out_names:
                return e
            return qualify(e)

        order_by = [ast.OrderTerm(qualify_order(t.expr), t.desc)
                    for t in s.order_by]

        # bitwise semi-join plane (sql/joins.py): star shapes — INNER
        # joins over `fact.fk = dim._id` — compile to dimension bitmap
        # broadcasts plus ONE masked fact dispatch; shapes the rewriter
        # can't prove safe fall back to the host hash join below
        from pilosa_tpu_torch.sql import joins as _joins

        semi = _joins.try_semi_join(self, s, tables, idxs, items, ons,
                                    where, group_by, having, order_by)
        if semi is not None:
            return semi

        # split WHERE: single-table conjuncts that LOWER to PQL push into
        # that table's scan (below the join); everything else — multi-
        # table or unlowerable — stays a host residual above the join.
        # Under a LEFT join only the base table's pushdown is semantics-
        # preserving (a right-side WHERE must see the null-padded rows).
        # The split runs to completion BEFORE needed-column collection so
        # residual conjuncts' columns are always projected by the scans.
        any_left = any(j.kind == "LEFT" for j in s.joins)
        lowered: Dict[str, List[Call]] = {a: [] for a in aliases}
        host_push: Dict[str, List[ast.Expr]] = {a: [] for a in aliases}
        residual: List[ast.Expr] = []
        for c in _flatten_and(where) if where is not None else []:
            owners = {r.table for r in _qualified_refs(c)}
            if len(owners) == 1:
                a = owners.pop()
                if a == aliases[0] or not any_left:
                    try:
                        lowered[a].append(
                            self.lower_filter(idxs[a], _unqualify(c)))
                    except CannotLower:
                        # non-lowerable single-table conjunct: still
                        # pushes below the join (host filter on that
                        # table's scan; on a cluster it ships with the
                        # fanout subtree), so join build sides arrive
                        # pre-filtered
                        host_push[a].append(_unqualify(c))
                    continue
            residual.append(c)

        # needed columns per table (incl. host-residual references)
        need: Dict[str, set] = {a: set() for a in aliases}
        for e in ([it.expr for it in items] + ons + group_by +
                  ([having] if having is not None else []) +
                  [t.expr for t in order_by] + residual):
            for r in _qualified_refs(e):
                if r.table in need:  # bare refs are output-alias sorts
                    need[r.table].add(r.name)
        for a, preds in host_push.items():
            for c in preds:  # unqualified: columns of this table only
                need[a] |= _columns_of(c)

        # per-table scans: PQL pushdown + host-filter pushdown (fanout on
        # a cluster) + alias-qualified schema
        scans: Dict[str, PlanOp] = {}
        for a in aliases:
            calls = lowered[a]
            filter_call = (calls[0] if len(calls) == 1
                           else Call("Intersect", children=calls)
                           if calls else None)
            hp = None
            for c in host_push[a]:
                hp = c if hp is None else ast.Binary("AND", hp, c)
            scan: PlanOp = self._filtered_scan(
                idxs[a], sorted(need[a] - {"_id"}), filter_call, hp)
            scans[a] = plan.AliasOp(scan, a)

        # left-deep join chain
        op: PlanOp = scans[aliases[0]]
        seen = {aliases[0]}
        for j, on in zip(s.joins, ons):
            a = j.alias or j.table
            equi, extra = [], []
            for c in _flatten_and(on):
                pair = _equi_pair(c, seen, a)
                if pair is not None:
                    equi.append(pair)
                else:
                    extra.append(c)
            if not equi:
                raise SQLError(
                    "JOIN requires at least one equi condition in ON")
            res = None
            for c in extra:
                res = c if res is None else ast.Binary("AND", res, c)
            op = plan.JoinOp(op, scans[a], equi, _to_keys(res),
                             kind=j.kind)
            seen.add(a)
        for c in residual:
            op = plan.FilterOp(op, _to_keys(c))
        return self._finish_join_plan(op, s, idxs, aliases, items,
                                      group_by, having, order_by)

    def _finish_join_plan(self, op: PlanOp, s: ast.SelectStatement,
                          idxs: Dict[str, Index], aliases: List[str],
                          items: List[ast.SelectItem],
                          group_by: List[ast.Expr],
                          having: Optional[ast.Expr],
                          order_by: List[ast.OrderTerm]) -> PlanOp:
        """Shared tail of every join strategy (hash join and semi-join
        decorated scans): host aggregation/projection over the qualified
        'alias.col' stream, then order/distinct/limit."""

        def jtype(e: ast.Expr) -> str:
            if isinstance(e, ast.ColumnRef) and e.table in idxs:
                return self._item_type(idxs[e.table],
                                       ast.ColumnRef(e.name))
            if isinstance(e, ast.FuncCall):
                if e.name == "COUNT":
                    return "INT"
                if e.name in ("SUM", "MIN", "MAX", "PERCENTILE") and \
                        e.args and isinstance(e.args[0], ast.ColumnRef):
                    return jtype(e.args[0])
                if e.name == "AVG":
                    return "DECIMAL(4)"
                return "INT"
            return self._item_type(idxs[aliases[0]], _unqualify(e))

        ctx = _QueryCtx()
        aggs = _collect_aggs(items, having, order_by)
        if group_by or aggs:
            op = self._join_aggregate(op, items, group_by, having, aggs,
                                      jtype, ctx, bool(order_by))
        else:
            proj = [(self._item_name(it, i), jtype(it.expr),
                     _to_keys(it.expr))
                    for i, it in enumerate(items)]
            names = {p[0] for p in proj}
            for t in order_by:
                for r in _qualified_refs(t.expr):
                    key = f"{r.table}.{r.name}"
                    if r.name not in names and key not in names:
                        ctx.hidden.append((key, jtype(r), _to_keys(r)))
                        names.add(key)
            op = plan.ProjectOp(op, proj + ctx.hidden)
        if order_by:
            by_item = {repr(it.expr): self._item_name(it, i)
                       for i, it in enumerate(items)}
            terms = []
            for t in order_by:
                if repr(t.expr) in by_item:
                    terms.append((ast.ColumnRef(by_item[repr(t.expr)]),
                                  t.desc))
                else:
                    terms.append((_to_keys(_rewrite_ctx(t.expr, ctx)),
                                  t.desc))
            op = plan.OrderByOp(op, terms)
            if ctx.hidden:
                op = _TrimOp(op, len(op.schema) - len(ctx.hidden))
        if s.distinct:
            op = plan.DistinctOp(op)
        limit = s.limit if s.limit is not None else s.top
        if limit is not None or s.offset:
            op = plan.LimitOp(op, limit, s.offset)
        return op

    def _join_aggregate(self, op: PlanOp, items, group_by, having, aggs,
                        jtype, ctx: _QueryCtx, with_hidden: bool) -> PlanOp:
        """Host grouping over the joined stream (reference:
        opgroupby.go above the join). ``with_hidden`` rides every
        aggregate along as a hidden column for ORDER BY resolution
        (trimmed after the sort)."""
        group_names: List[str] = []
        computed: List[tuple] = []
        for i, g in enumerate(group_by):
            if isinstance(g, ast.ColumnRef):
                group_names.append(f"{g.table}.{g.name}" if g.table
                                   else g.name)
            else:
                name = f"__grp{i}"
                ctx.grp_rewrites[repr(g)] = name
                computed.append((name, jtype(g), _to_keys(g)))
                group_names.append(name)
        if computed:
            passthrough = [(n, t, ast.ColumnRef(n)) for n, t in op.schema]
            op = plan.ProjectOp(op, passthrough + computed)
        agg_names = self._name_aggs(aggs, ctx)
        hidden = []
        if with_hidden:
            for a in aggs:
                hidden.append((ctx.agg_names[_agg_key(a)], jtype(a),
                               ast.ColumnRef(ctx.agg_names[_agg_key(a)])))
        ctx.hidden = hidden
        specs = []
        for a in aggs:
            expr = None if (a.args and isinstance(a.args[0], ast.Star)) \
                else (_to_keys(a.args[0]) if a.args else None)
            specs.append((agg_names[_agg_key(a)], "INT",
                          AggSpec(a.name, expr, distinct=a.distinct)))
        op = plan.GroupByOp(op, group_names, specs)
        if having is not None:
            op = plan.FilterOp(op, _to_keys(_rewrite_ctx(having, ctx)))
        proj = [(self._item_name(it, i), jtype(it.expr),
                 _to_keys(_rewrite_ctx(it.expr, ctx)))
                for i, it in enumerate(items)] + ctx.hidden
        return plan.ProjectOp(op, proj)

    def _plan_host_aggregate(self, idx: Index, s: ast.SelectStatement,
                             items: List[ast.SelectItem],
                             aggs: List[ast.FuncCall],
                             ctx: _QueryCtx) -> PlanOp:
        """Fallback: scan + host grouping (reference: opgroupby.go when
        PQL fusion doesn't apply)."""
        needed = set()
        for it in items:
            needed |= _columns_of(it.expr)
        for g in s.group_by:
            needed |= _columns_of(g)
        if s.having is not None:
            needed |= _columns_of(s.having)
        filter_call, host_pred = self._split_filter(idx, s.where)
        if host_pred is not None:
            needed |= _columns_of(host_pred)
        field_names = sorted(needed - {"_id"})
        # expression group keys become computed ride-along columns
        group_names: List[str] = []
        computed: List[tuple] = []
        for i, g in enumerate(s.group_by):
            if isinstance(g, ast.ColumnRef):
                group_names.append(g.name)
            else:
                name = f"__grp{i}"
                ctx.grp_rewrites[repr(g)] = name
                computed.append((name, self._item_type(idx, g), g))
                group_names.append(name)
        agg_names = self._name_aggs(aggs, ctx)
        hidden = self._hidden_agg_items(idx, items, aggs, s.order_by, ctx)
        specs = []
        for a in aggs:
            expr = None if (a.args and isinstance(a.args[0], ast.Star)) \
                else (a.args[0] if a.args else None)
            specs.append((agg_names[_agg_key(a)], "INT",
                          AggSpec(a.name, expr, distinct=a.distinct)))
        dist = self._dist_executor()
        if dist is not None:
            # distributed partial aggregation: the nodes scan, filter,
            # group and accumulate their own rows, and only per-group
            # partial states cross the wire (reference: the pushed-down
            # aggregate ops, oppqlmultigroupby / mapReducePlanOp)
            from pilosa_tpu_torch.sql.fanout import FanoutAggOp, expr_to_json

            spec = {"index": idx.name, "fields": field_names,
                    "pql": filter_call.to_pql() if filter_call else None,
                    "host_filter": expr_to_json(host_pred),
                    "computed": [[n, expr_to_json(g)]
                                 for n, _, g in computed],
                    "group_by": group_names,
                    "aggs": [[n, sp.func, expr_to_json(sp.expr),
                              sp.distinct] for n, _, sp in specs]}
            scan_schema = dict(
                [("_id", id_sql_type(idx.options.keys))] +
                [(f, field_to_sql_type(idx.field(f).options))
                 for f in field_names] + [(n, t) for n, t, _ in computed])
            gschema = [(n, scan_schema[n]) for n in group_names]
            op: PlanOp = FanoutAggOp(dist, spec, gschema, specs)
        else:
            scan: PlanOp = self._filtered_scan(
                idx, field_names, filter_call, host_pred)
            if computed:
                passthrough = [(n, t, ast.ColumnRef(n))
                               for n, t in scan.schema]
                scan = plan.ProjectOp(scan, passthrough + computed)
            op = plan.GroupByOp(scan, group_names, specs)
        if s.having is not None:
            op = plan.FilterOp(op, _rewrite_ctx(s.having, ctx))
        proj = [(self._item_name(it, i), self._item_type(idx, it.expr),
                 _rewrite_ctx(it.expr, ctx))
                for i, it in enumerate(items)] + hidden
        return plan.ProjectOp(op, proj)


class _TrimOp(PlanOp):
    """Drop hidden trailing columns added for ORDER BY."""

    def __init__(self, child: PlanOp, keep: int):
        self.child, self._keep = child, keep
        self.schema = child.schema[:keep]

    def child_ops(self):
        return [self.child]

    def rows(self):
        for row in self.child.rows():
            yield row[: self._keep]


# -- helpers -----------------------------------------------------------------

def _strip_single_table_quals(s: ast.SelectStatement) -> ast.SelectStatement:
    """`SELECT o.price FROM orders o` — validate each qualifier names the
    one table (by alias or table name) and strip it so the single-table
    pipeline's unqualified env keys resolve."""
    allowed = {s.table, s.table_alias} - {None}

    def strip(e):
        for r in _qualified_refs(e):
            if r.table is not None and r.table not in allowed:
                raise SQLError(f"unknown table alias {r.table!r}")
        return _unqualify(e)

    return dataclasses.replace(
        s,
        items=[ast.SelectItem(strip(it.expr)
                              if not isinstance(it.expr, ast.Star)
                              else it.expr, it.alias) for it in s.items],
        where=strip(s.where) if s.where is not None else None,
        group_by=[strip(g) for g in s.group_by],
        having=strip(s.having) if s.having is not None else None,
        order_by=[ast.OrderTerm(strip(t.expr), t.desc) for t in s.order_by],
    )


def _map_refs(e: ast.Expr, fn) -> ast.Expr:
    """Rebuild an expression with ``fn`` applied to every ColumnRef —
    the single traversal behind qualification/stripping/collection (any
    new Expr node type needs exactly one case added here)."""
    if isinstance(e, ast.ColumnRef):
        return fn(e)
    if isinstance(e, ast.Binary):
        return ast.Binary(e.op, _map_refs(e.left, fn), _map_refs(e.right, fn))
    if isinstance(e, ast.Unary):
        return ast.Unary(e.op, _map_refs(e.operand, fn))
    if isinstance(e, ast.InList):
        return ast.InList(_map_refs(e.operand, fn),
                          [_map_refs(i, fn) for i in e.items], e.negated)
    if isinstance(e, ast.Between):
        return ast.Between(_map_refs(e.operand, fn), _map_refs(e.low, fn),
                           _map_refs(e.high, fn), e.negated)
    if isinstance(e, ast.IsNull):
        return ast.IsNull(_map_refs(e.operand, fn), e.negated)
    if isinstance(e, ast.Like):
        return ast.Like(_map_refs(e.operand, fn), e.pattern, e.negated)
    if isinstance(e, ast.FuncCall):
        return ast.FuncCall(e.name, [_map_refs(a, fn) for a in e.args],
                            distinct=e.distinct)
    return e


def _qualified_refs(e: Optional[ast.Expr]) -> List[ast.ColumnRef]:
    """All ColumnRef nodes of a (post-qualify) expression."""
    out: List[ast.ColumnRef] = []
    if e is not None:
        _map_refs(e, lambda r: (out.append(r), r)[1])
    return out


def _unqualify(e: ast.Expr) -> ast.Expr:
    """Strip table qualifiers (for lowering a single-table conjunct
    against that table's index)."""
    return _map_refs(e, lambda r: ast.ColumnRef(r.name))


def _equi_pair(c: ast.Expr, seen_aliases: set, right_alias: str):
    """(left key, right key) when c is `a.x = b.y` joining the
    accumulated left side to the table being joined; else None."""
    if not (isinstance(c, ast.Binary) and c.op == "="):
        return None
    l, r = c.left, c.right
    if not (isinstance(l, ast.ColumnRef) and isinstance(r, ast.ColumnRef)):
        return None
    if l.table == right_alias and r.table in seen_aliases:
        l, r = r, l
    if l.table in seen_aliases and r.table == right_alias:
        return (f"{l.table}.{l.name}", f"{r.table}.{r.name}")
    return None


def _to_keys(e):
    """Expressions over joined streams evaluate as-is: plan.eval_expr
    resolves qualified refs against the 'alias.col' env keys AliasOp
    establishes. Kept as the single seam where a different key scheme
    would plug in."""
    return e


def _flatten_and(e: ast.Expr) -> List[ast.Expr]:
    if isinstance(e, ast.Binary) and e.op == "AND":
        return _flatten_and(e.left) + _flatten_and(e.right)
    return [e]


def _columns_of(e: ast.Expr) -> set:
    out: set = set()
    if isinstance(e, ast.ColumnRef):
        out.add(e.name)
    elif isinstance(e, ast.Binary):
        out |= _columns_of(e.left) | _columns_of(e.right)
    elif isinstance(e, ast.Unary):
        out |= _columns_of(e.operand)
    elif isinstance(e, ast.InList):
        out |= _columns_of(e.operand)
        for it in e.items:
            out |= _columns_of(it)
    elif isinstance(e, ast.Between):
        out |= _columns_of(e.operand) | _columns_of(e.low) | _columns_of(e.high)
    elif isinstance(e, (ast.IsNull, ast.Like)):
        out |= _columns_of(e.operand)
    elif isinstance(e, ast.FuncCall):
        for a in e.args:
            out |= _columns_of(a)
    return out


def _contains_agg(e: ast.Expr) -> bool:
    if isinstance(e, ast.FuncCall):
        if e.name in AGGS:
            return True
        return any(_contains_agg(a) for a in e.args)
    if isinstance(e, ast.Binary):
        return _contains_agg(e.left) or _contains_agg(e.right)
    if isinstance(e, ast.Unary):
        return _contains_agg(e.operand)
    return False


def _agg_key(e: ast.FuncCall) -> str:
    """Structural identity of an aggregate expression (dataclass repr),
    so COUNT(*) in ORDER BY matches COUNT(*) in the projection."""
    return repr(e)


def _collect_aggs(items: List[ast.SelectItem], having: Optional[ast.Expr],
                  order_by: List[ast.OrderTerm] = ()) -> List[ast.FuncCall]:
    out: List[ast.FuncCall] = []
    seen: set = set()

    def walk(e: ast.Expr):
        if isinstance(e, ast.FuncCall) and e.name in AGGS:
            k = _agg_key(e)
            if k not in seen:
                seen.add(k)
                out.append(e)
            return
        if isinstance(e, ast.Binary):
            walk(e.left)
            walk(e.right)
        elif isinstance(e, ast.Unary):
            walk(e.operand)
        elif isinstance(e, ast.FuncCall):
            for a in e.args:
                walk(a)

    for it in items:
        walk(it.expr)
    if having is not None:
        walk(having)
    for t in order_by:
        walk(t.expr)
    return out


def _rewrite_ctx(e: ast.Expr, ctx: "_QueryCtx") -> ast.Expr:
    """Replace group-key expressions and aggregates with refs to their
    computed columns (both matched structurally)."""
    if repr(e) in ctx.grp_rewrites:
        return ast.ColumnRef(ctx.grp_rewrites[repr(e)])
    if isinstance(e, ast.FuncCall) and e.name in AGGS and \
            _agg_key(e) in ctx.agg_names:
        return ast.ColumnRef(ctx.agg_names[_agg_key(e)])
    if isinstance(e, ast.Binary):
        return ast.Binary(e.op, _rewrite_ctx(e.left, ctx),
                          _rewrite_ctx(e.right, ctx))
    if isinstance(e, ast.Unary):
        return ast.Unary(e.op, _rewrite_ctx(e.operand, ctx))
    return e


def _rewrite_aggs(e: ast.Expr, names: Dict[str, str]) -> ast.Expr:
    """Replace aggregate FuncCall nodes with refs to their computed
    columns (matched structurally via _agg_key)."""
    if isinstance(e, ast.FuncCall) and e.name in AGGS and \
            _agg_key(e) in names:
        return ast.ColumnRef(names[_agg_key(e)])
    if isinstance(e, ast.Binary):
        return ast.Binary(e.op, _rewrite_aggs(e.left, names),
                          _rewrite_aggs(e.right, names))
    if isinstance(e, ast.Unary):
        return ast.Unary(e.op, _rewrite_aggs(e.operand, names))
    return e


def _agg_kernel_ok(a: ast.FuncCall) -> bool:
    """One aggregate -> one PQL kernel call needs a plain column (or *)
    argument; expression aggregates (SUM(a*b)) evaluate host-side."""
    return not a.args or isinstance(a.args[0], (ast.ColumnRef, ast.Star))


def _agg_col(a: ast.FuncCall) -> str:
    if not a.args or not isinstance(a.args[0], ast.ColumnRef):
        raise SQLError(f"{a.name}() requires a column argument")
    return a.args[0].name


def _col_and_literals(operand: ast.Expr, items: List[ast.Expr]):
    if not isinstance(operand, ast.ColumnRef):
        return None, None
    vals = []
    for it in items:
        if not isinstance(it, ast.Literal):
            return None, None
        vals.append(it.value)
    return operand.name, vals


def _literal(e: ast.Expr):
    if isinstance(e, ast.Literal):
        return e.value
    if isinstance(e, ast.Unary) and e.op == "-" and \
            isinstance(e.operand, ast.Literal):
        return -e.operand.value
    raise CannotLower("non-literal")


def _literal_type(v) -> str:
    if isinstance(v, bool):
        return "BOOL"
    if isinstance(v, int):
        return "INT"
    if isinstance(v, float):
        return "DECIMAL(4)"
    if isinstance(v, str):
        return "STRING"
    return "STRING"


def _convert_scan_value(f: Field, v):
    """ExtractedColumn value -> SQL value (reference: sql3 type coercion
    from PQL extract results, oppqltablescan.go row materialization)."""
    t = f.options.type
    if t.is_bsi:
        if v is None:
            return None
        if t == FieldType.TIMESTAMP:
            units = _TIME_UNITS_PER_S[f.options.time_unit]
            ts = dt.datetime.fromtimestamp(v / units, tz=dt.timezone.utc)
            return ts.isoformat().replace("+00:00", "Z")
        return v
    if t == FieldType.BOOL:
        return bool(v)
    if t in (FieldType.MUTEX,):
        if isinstance(v, list):
            return v[0] if v else None
        return v
    # set-like
    if isinstance(v, list):
        return v if v else None
    return v
