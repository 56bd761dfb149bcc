"""SQL engine entry: parse -> plan -> execute -> result.

Reference: server/sql.go:17 execSQL + sql3/planner/executionplanner.go.
The JSON result shape matches the reference's POST /sql response
(http_handler.go:1440): {"schema": {"fields": [...]}, "data": [...]}.

Port of ``pilosa_tpu/sql/engine.py``: DDL, INSERT / REPLACE, BULK
INSERT, COPY, DELETE, views, functions, models, SHOW and the system
tables. Writes hold ``api.txf.qcx()``. ``COPY ... WITH URL`` ships the
rows to another server through the port's HTTP client (``client/``).
"""

from __future__ import annotations

import csv
import dataclasses
import io
import time
from typing import Any, Dict, List, Optional

from pilosa_tpu_torch.cache import keys as cache_keys
from pilosa_tpu_torch.core.schema import FieldType
from pilosa_tpu_torch.sql import ast
from pilosa_tpu_torch.sql.lexer import SQLError
from pilosa_tpu_torch.sql.parser import parse_statement
from pilosa_tpu_torch.sql.plan import PlanOp, QuantumSet, Schema, eval_expr
from pilosa_tpu_torch.sql.planner import Planner
from pilosa_tpu_torch.sql.types import (column_to_options_dict,
                                        field_to_sql_type, id_sql_type)


@dataclasses.dataclass
class SQLResult:
    schema: Schema
    data: List[List[Any]]
    changed: int = 0  # rows affected by DML
    exec_ms: float = 0.0

    def to_json(self) -> dict:
        return {
            "schema": {"fields": [{"name": n, "base-type": t.lower()}
                                  for n, t in self.schema]},
            "data": self.data,
            "rows-affected": self.changed,
            "execution-time": int(self.exec_ms * 1000),  # µs like the ref
        }


def _validate_quantum(name: str, t, v: "QuantumSet") -> None:
    """Shared INSERT/REPLACE validation of a {ts, set} tuple value."""
    from pilosa_tpu_torch.sql.plan import _parse_ts

    if t != FieldType.TIME:
        raise SQLError(
            f"a tuple expression cannot be assigned to column {name!r} "
            "(not a time-quantum field)")
    try:
        _parse_ts(v.ts)
    except (TypeError, ValueError):
        raise SQLError(f"invalid timestamp {v.ts!r} in tuple value")


class SQLEngine:
    def __init__(self, api):
        self.api = api
        self.planner = Planner(api)
        self.views = self.planner.views  # CREATE VIEW definitions
        # CREATE FUNCTION / CREATE MODEL registries (reference:
        # functionSystemObject; evaluation is refused in both codebases —
        # userdefinedfunctions.go returns unsupported)
        self.functions: dict = {}
        self.models: dict = {}

    def query(self, sql: str, parsed=None) -> SQLResult:
        t0 = time.monotonic()
        stmt = parsed if parsed is not None else parse_statement(sql)
        res = self._dispatch(stmt, sql=sql)
        res.exec_ms = (time.monotonic() - t0) * 1000
        return res

    def compile_plan(self, sql: str) -> Optional[PlanOp]:
        """Compile without executing (reference: server.go:1448
        CompileExecutionPlan, used by tests and EXPLAIN-style tooling)."""
        stmt = parse_statement(sql)
        if isinstance(stmt, ast.SelectStatement):
            return self.planner.plan_select(stmt)
        return None

    # -- statement dispatch ---------------------------------------------------

    def _dispatch(self, stmt, sql: Optional[str] = None) -> SQLResult:
        if isinstance(stmt, ast.SelectStatement):
            if stmt.table in _SYSTEM_TABLES:
                return self._system_table(stmt)
            self._reject_udf_calls(stmt)
            cache = self.api.cache
            if cache is not None:
                key = self._select_cache_key(stmt, sql)
                if key is None:
                    cache.bypass()
                else:
                    # hits (and single-flight followers) skip the
                    # admission ticket too — a cached SELECT never
                    # occupies scheduler slots
                    return cache.run(key, lambda: self._run_select(stmt))
            return self._run_select(stmt)
        if isinstance(stmt, ast.CreateTable):
            return self._create_table(stmt)
        if isinstance(stmt, ast.CreateView):
            return self._create_view(stmt)
        if isinstance(stmt, ast.DropView):
            return self._drop_view(stmt)
        if isinstance(stmt, ast.DropTable):
            return self._drop_table(stmt)
        if isinstance(stmt, ast.AlterTable):
            return self._alter_table(stmt)
        if isinstance(stmt, ast.InsertStatement):
            with self.api.txf.qcx():  # DML holds the write lock + group-commits
                return self._insert(stmt)
        if isinstance(stmt, ast.BulkInsert):
            with self.api.txf.qcx():
                return self._bulk_insert(stmt)
        if isinstance(stmt, ast.DeleteStatement):
            with self.api.txf.qcx():
                return self._delete(stmt)
        if isinstance(stmt, ast.CreateFunction):
            return self._create_function(stmt)
        if isinstance(stmt, ast.DropFunction):
            name = stmt.name.lower()
            if name not in self.functions and not stmt.if_exists:
                raise SQLError(f"function {stmt.name!r} does not exist")
            self.functions.pop(name, None)
            return SQLResult(schema=[], data=[])
        if isinstance(stmt, ast.CreateModel):
            name = stmt.name.lower()
            if name in self.models and not stmt.if_not_exists:
                raise SQLError(f"model {stmt.name!r} already exists")
            self.models[name] = stmt
            return SQLResult(schema=[], data=[])
        if isinstance(stmt, ast.DropModel):
            name = stmt.name.lower()
            if name not in self.models and not stmt.if_exists:
                raise SQLError(f"model {stmt.name!r} does not exist")
            self.models.pop(name, None)
            return SQLResult(schema=[], data=[])
        if isinstance(stmt, ast.Predict):
            # registered but not executable — the reference gates model
            # execution behind its cloud service the same way
            if stmt.model.lower() not in self.models:
                raise SQLError(f"model {stmt.model!r} does not exist")
            raise SQLError("PREDICT is not supported on this deployment")
        if isinstance(stmt, ast.CopyStatement):
            return self._copy(stmt)
        if isinstance(stmt, ast.ShowTables):
            return self._show_tables()
        if isinstance(stmt, ast.ShowColumns):
            return self._show_columns(stmt.table)
        if isinstance(stmt, ast.ShowDatabases):
            return SQLResult(schema=[("name", "STRING")], data=[])
        raise SQLError(f"unsupported statement {type(stmt).__name__}")

    def _run_select(self, stmt: ast.SelectStatement) -> SQLResult:
        sched = self.api.scheduler
        # admission ticket bounds concurrent SELECTs under overload
        # (the kernel calls inside the plan still micro-batch via the
        # planner's _read_executor facade)
        import contextlib
        admit = sched.admit() if sched is not None else (
            contextlib.nullcontext())
        with admit:
            # no dispatch_guard here: the guard is a leaf lock around
            # each kernel launch (platform.guarded_call) — holding it
            # across rows(), which on a cluster node fans subtrees out
            # over loopback HTTP, would starve the serving threads
            op = self.planner.plan_select(stmt)
            return SQLResult(schema=op.schema,
                             data=[list(r) for r in op.rows()])

    def _select_cache_key(self, stmt: ast.SelectStatement,
                          sql: Optional[str]):
        """Result-cache key for a plain single-table SELECT, or None.
        The key is the normalized SQL text + the table's full fragment
        version fingerprint (a SELECT may touch any field/shard of its
        table, so the whole table is the conservative read set). A star
        join keys on EVERY joined table's fingerprint — a dimension
        write must invalidate the joined result even though the fact
        table is untouched. Views, derived tables and system tables
        pass through uncached — their read sets span other objects."""
        if not sql or not stmt.table or stmt.derived:
            return None
        names = [stmt.table] + [j.table for j in stmt.joins]
        if any(n in _SYSTEM_TABLES or n in self.views for n in names):
            return None
        parts = []
        for n in names:
            idx = self.api.holder.indexes.get(n)
            if idx is None:
                return None  # let planning raise unknown-table as usual
            shard_list = sorted(idx.shards())
            parts.append((n, cache_keys.shard_key(shard_list),
                          cache_keys.version_fingerprint(idx, shard_list)))
        if not stmt.joins:
            # historical single-table key shape, unchanged
            n, sk, fp = parts[0]
            return ("sql", " ".join(sql.split()), n, sk, fp)
        return ("sql", " ".join(sql.split()), tuple(parts))

    def _create_function(self, cf: ast.CreateFunction) -> SQLResult:
        name = cf.name.lower()  # function names are case-insensitive
        if name in self.functions and not cf.if_not_exists:
            raise SQLError(f"function {cf.name!r} already exists")
        self.functions[name] = cf
        return SQLResult(schema=[], data=[])

    def _reject_udf_calls(self, stmt: ast.SelectStatement) -> None:
        """A registered function referenced in a query errors exactly
        like the reference (userdefinedfunctions.go: evaluation of user
        defined functions is unsupported)."""
        if not self.functions:
            return
        hits: List[str] = []

        def walk(e):
            if isinstance(e, ast.FuncCall):
                if e.name.lower() in self.functions:
                    hits.append(e.name.lower())
                for a in e.args:
                    walk(a)
            elif dataclasses.is_dataclass(e):
                for f in dataclasses.fields(e):
                    v = getattr(e, f.name)
                    if isinstance(v, ast.Expr):
                        walk(v)
                    elif isinstance(v, list):
                        for x in v:
                            if isinstance(x, ast.Expr):
                                walk(x)
        for it in stmt.items:
            walk(it.expr)
        if stmt.where is not None:
            walk(stmt.where)
        if hits:
            raise SQLError("user defined functions are not supported "
                           f"(function {hits[0]!r})")

    def _copy(self, st: ast.CopyStatement) -> SQLResult:
        """COPY source TO target: materialize the (optionally filtered)
        source rows, then recreate schema + rows locally or on a remote
        server over the client (reference: compilecopy.go ships rows to
        another FeatureBase at ``URL``)."""
        idx = self.api.holder.index(st.source)
        sel = ast.SelectStatement(items=[ast.SelectItem(ast.Star())],
                                  table=st.source, where=st.where)
        op = self.planner.plan_select(sel)
        names = [n for n, _ in op.schema]
        rows = [list(r) for r in op.rows()]
        id_type = "string" if idx.options.keys else "id"
        cols_ddl = [f"_id {id_type}"] + [
            f"{f.name} {field_to_sql_type(f.options).lower()}"
            for f in idx.public_fields()]
        ddl = (f"create table if not exists {st.target} "
               f"({', '.join(cols_ddl)})")
        if st.url:
            from pilosa_tpu_torch.client.client import Client

            c = Client(st.url, token=st.api_key)
            c.sql(ddl)
            for i in range(0, len(rows), 1000):
                chunk = rows[i:i + 1000]
                if chunk:
                    c.sql(self._insert_sql(st.target, names, chunk))
            return SQLResult(schema=[], data=[], changed=len(rows))
        self.query(ddl)
        ins = ast.InsertStatement(
            table=st.target, columns=names,
            rows=[[ast.Literal(v) for v in row] for row in rows])
        with self.api.txf.qcx():
            self._insert(ins)
        return SQLResult(schema=[], data=[], changed=len(rows))

    @staticmethod
    def _insert_sql(table: str, cols: List[str], rows: List[list]) -> str:
        def lit(v) -> str:
            if v is None:
                return "null"
            if isinstance(v, bool):
                return "true" if v else "false"
            if isinstance(v, float):
                s = repr(v)
                if "e" in s or "E" in s:  # 1e-06 does not re-parse
                    s = format(v, ".17f").rstrip("0").rstrip(".") or "0"
                return s
            if isinstance(v, int):
                return repr(v)
            if isinstance(v, list):
                return "[" + ",".join(lit(x) for x in v) + "]"
            return "'" + str(v).replace("'", "''") + "'"

        vals = ",".join("(" + ",".join(lit(v) for v in row) + ")"
                        for row in rows)
        return (f"insert into {table} ({', '.join(cols)}) values {vals}")

    # -- DDL ------------------------------------------------------------------

    def _create_table(self, ct: ast.CreateTable) -> SQLResult:
        holder = self.api.holder
        if ct.name in holder.indexes:
            if ct.if_not_exists:
                return SQLResult(schema=[], data=[])
            raise SQLError(f"table {ct.name!r} already exists")
        if ct.name in self.views:
            # views resolve before tables in plan_select; a shadowed
            # table would be silently unreachable
            raise SQLError(f"a view named {ct.name!r} already exists")
        id_cols = [c for c in ct.columns if c.name == "_id"]
        if not id_cols:
            raise SQLError("CREATE TABLE requires an _id column")
        if id_cols[0].type not in ("ID", "STRING"):
            raise SQLError("_id must be ID or STRING")
        self.api.create_index(ct.name, {"keys": id_cols[0].type == "STRING"})
        try:
            for c in ct.columns:
                if c.name == "_id":
                    continue
                # through the api surface so cluster nodes broadcast the
                # schema change to peers (node.create_field)
                self.api.create_field(ct.name, c.name,
                                      column_to_options_dict(c))
        except Exception:
            self.api.delete_index(ct.name)
            raise
        self.api.holder.save_schema()
        return SQLResult(schema=[], data=[])

    def _create_view(self, cv: ast.CreateView) -> SQLResult:
        if cv.name in self.views or cv.name in self.api.holder.indexes:
            if cv.if_not_exists:
                return SQLResult(schema=[], data=[])
            raise SQLError(f"view or table {cv.name!r} already exists")
        # validate at definition time: the view must plan (unknown
        # tables/columns fail HERE, not at first read)
        self.planner.plan_select(cv.select)
        self.views[cv.name] = cv.select
        return SQLResult(schema=[], data=[])

    def _drop_view(self, dv: ast.DropView) -> SQLResult:
        if dv.name not in self.views:
            if dv.if_exists:
                return SQLResult(schema=[], data=[])
            raise SQLError(f"view {dv.name!r} does not exist")
        del self.views[dv.name]
        return SQLResult(schema=[], data=[])

    def _drop_table(self, d: ast.DropTable) -> SQLResult:
        if d.name not in self.api.holder.indexes:
            if d.if_exists:
                return SQLResult(schema=[], data=[])
            raise SQLError(f"table {d.name!r} does not exist")
        self.api.delete_index(d.name)
        return SQLResult(schema=[], data=[])

    def _alter_table(self, a: ast.AlterTable) -> SQLResult:
        self.api.holder.index(a.name)  # existence check
        if a.add is not None:
            self.api.create_field(a.name, a.add.name,
                                  column_to_options_dict(a.add))
        elif a.drop is not None:
            self.api.delete_field(a.name, a.drop)
        self.api.holder.save_schema()
        return SQLResult(schema=[], data=[])

    # -- DML ------------------------------------------------------------------

    def _insert(self, ins: ast.InsertStatement) -> SQLResult:
        idx = self.api.holder.index(ins.table)
        # default column list follows declared order (fields dict preserves
        # creation order), not the sorted public_fields() view
        cols = ins.columns or (
            ["_id"] + [n for n in idx.fields if not n.startswith("_")])
        if "_id" not in cols:
            raise SQLError("INSERT requires the _id column")
        records = []
        for row_exprs in ins.rows:
            if len(row_exprs) != len(cols):
                raise SQLError("INSERT value count does not match column list")
            records.append({c: eval_expr(e, {})
                            for c, e in zip(cols, row_exprs)})
        if ins.replace:
            # REPLACE needs a per-record existing-rows lookup + clear
            for values in records:
                self._upsert_record(idx, values, replace=True)
        else:
            self._batch_upsert(idx, records)
        return SQLResult(schema=[], data=[], changed=len(records))

    def _batch_upsert(self, idx, records: List[dict]) -> None:
        """Accumulate a whole statement's records into ONE api import per
        field (the reference lowers inserts to the bulk Importer the same
        way, importer.go:13) — each api call is a write-lock + WAL
        group-commit and, on a cluster, an HTTP fan-out, so per-record
        calls would cost N*F round trips instead of F."""
        keyed = idx.options.keys

        def ckey(rec):
            return str(rec["_id"]) if keyed else int(rec["_id"])

        setacc: Dict[str, dict] = {}
        valacc: Dict[str, dict] = {}
        quantum = []  # (field, col, QuantumSet): timestamped writes
        lonely = []  # records whose every field is NULL/empty: exists-only
        for rec in records:
            c = ckey(rec)
            any_field = False
            for name, v in rec.items():
                if name == "_id" or v is None:
                    continue
                field = idx.field(name)
                t = field.options.type
                if isinstance(v, QuantumSet):
                    _validate_quantum(name, t, v)
                    if not v.values:
                        continue  # empty set at a timestamp: no bits —
                        # the record still rides the lonely/_exists path
                    quantum.append((name, c, v))
                    any_field = True
                    continue
                if t.is_bsi:
                    a = valacc.setdefault(name, {"cols": [], "values": []})
                    a["cols"].append(c)
                    a["values"].append(v)
                    any_field = True
                    continue
                vals = v if isinstance(v, list) else [v]
                if t == FieldType.BOOL:
                    vals = [1 if v else 0]
                if not vals:
                    continue  # empty set literal writes no bits
                a = setacc.setdefault(name, {"rows": [], "cols": []})
                for item in vals:
                    a["rows"].append(item)
                    a["cols"].append(c)
                any_field = True
            if not any_field:
                lonely.append(c)

        def colkw(cs):
            return {"col_keys": [str(x) for x in cs]} if keyed \
                else {"cols": [int(x) for x in cs]}

        for name, a in valacc.items():
            self.api.import_values(idx.name, name, values=a["values"],
                                   **colkw(a["cols"]))
        for name, a in setacc.items():
            field = idx.field(name)
            if field.options.keys:
                self.api.import_bits(
                    idx.name, name, rows=[],
                    row_keys=[str(r) for r in a["rows"]],
                    **colkw(a["cols"]))
            else:
                self.api.import_bits(
                    idx.name, name, rows=[int(r) for r in a["rows"]],
                    **colkw(a["cols"]))
        if lonely and idx.options.track_existence:
            self.api.import_bits(idx.name, "_exists",
                                 rows=[0] * len(lonely), **colkw(lonely))
        if quantum:
            # Timestamped set writes route through PQL Set(col, f=v, ts)
            # so views land per quantum AND the write fans out correctly
            # on a cluster (reference: quantum inserts land per-view,
            # field.go:1001 viewsByTime).
            from pilosa_tpu_torch.pql.ast import Call, Query

            calls = []
            for name, c, qs in quantum:
                for item in qs.values:
                    calls.append(Call("Set", {
                        "_col": c, name: item, "_timestamp": qs.ts}))
            self.api.query(idx.name, Query(calls))

    def _upsert_record(self, idx, values: dict, replace: bool = False) -> None:
        """Write one record THROUGH the api import surface so DML routes
        to shard owners + replicas on a cluster node (node.import_bits /
        import_values) and works identically on a single-node API
        (reference: sql3 insert lowering to the Importer, importer.go:13).
        """
        index = idx.name
        raw_id = values["_id"]
        col_keys = [str(raw_id)] if idx.options.keys else None
        cols = None if idx.options.keys else [int(raw_id)]

        def one_col(n: int):
            return (dict(col_keys=col_keys * n) if col_keys
                    else dict(cols=cols * n))

        set_fields = [(n, v) for n, v in values.items()
                      if n != "_id" and v is not None]
        imported = False
        for name, v in set_fields:
            field = idx.field(name)
            t = field.options.type
            if isinstance(v, QuantumSet):
                # timestamped write (same PQL Set lowering as the batch
                # path; REPLACE resets the standard view first below via
                # the quantum field's plain-set branch semantics)
                _validate_quantum(name, t, v)
                if not v.values:
                    continue
                from pilosa_tpu_torch.pql.ast import Call, Query

                c = str(raw_id) if idx.options.keys else int(raw_id)
                self.api.query(index, Query([
                    Call("Set", {"_col": c, name: item,
                                 "_timestamp": v.ts})
                    for item in v.values]))
                imported = True
                continue
            if t.is_bsi:
                self.api.import_values(index, name, values=[v],
                                       **({"col_keys": col_keys}
                                          if col_keys else {"cols": cols}))
                imported = True
                continue
            if t == FieldType.BOOL:
                self.api.import_bits(index, name,
                                     rows=[1 if v else 0], **one_col(1))
                imported = True
                continue
            vals = v if isinstance(v, list) else [v]
            if replace and t not in (FieldType.MUTEX, FieldType.BOOL):
                # REPLACE resets set-valued columns (reference: sql3
                # REPLACE INTO); the point Rows lookup + clear import both
                # ride the api surface, so it is cluster-routed too
                ident = repr(str(raw_id)) if idx.options.keys else int(raw_id)
                existing = self.api.query(
                    index, f"Rows({name}, column={ident})")[0]
                if existing:
                    self.api.import_bits(
                        index, name,
                        rows=[r for r in existing] if not field.options.keys
                        else [],
                        row_keys=([str(r) for r in existing]
                                  if field.options.keys else None),
                        clear=True, **one_col(len(existing)))
            if not vals:
                continue  # empty set literal writes no bits
            if field.options.keys:
                self.api.import_bits(index, name, rows=[],
                                     row_keys=[str(i) for i in vals],
                                     **one_col(len(vals)))
            else:
                self.api.import_bits(index, name,
                                     rows=[int(i) for i in vals],
                                     **one_col(len(vals)))
            imported = True
        if not imported and idx.options.track_existence:
            # the record exists even when every field is NULL or an
            # empty set literal
            self.api.import_bits(index, "_exists", rows=[0], **one_col(1))

    def _bulk_insert(self, bi: ast.BulkInsert) -> SQLResult:
        """CSV bulk load (reference: sql3 BULK INSERT with MAP ordinals,
        planner_bulkinsert.go; FORMAT 'CSV' INPUT 'FILE'/'STREAM')."""
        idx = self.api.holder.index(bi.table)
        fmt = str(bi.options.get("FORMAT", "CSV")).upper()
        if fmt != "CSV":
            raise SQLError(f"BULK INSERT format {fmt!r} not supported")
        inp = str(bi.options.get("INPUT", "FILE")).upper()
        cols = bi.columns
        if len(cols) != len(bi.map_defs):
            raise SQLError("BULK INSERT MAP count must match column list")
        if inp == "STREAM":
            f = io.StringIO(bi.source)
        else:
            f = open(bi.source, newline="")
        n = 0
        pending: List[dict] = []
        with f:
            rows = iter(csv.reader(f))
            if bi.options.get("HEADER_ROW"):
                next(rows, None)
            limit = bi.options.get("ROWSLIMIT")
            allow_missing = bool(bi.options.get("ALLOW_MISSING_VALUES"))
            for rec in rows:
                if limit is not None and n >= int(limit):
                    break
                values = {}
                for cname, (src, typ) in zip(cols, bi.map_defs):
                    pos = int(src)
                    if pos >= len(rec):
                        if allow_missing:
                            values[cname] = None
                            continue
                        raise SQLError(
                            f"record {n + 1} has {len(rec)} values but MAP "
                            f"references position {pos} (use "
                            f"ALLOW_MISSING_VALUES to tolerate)")
                    values[cname] = _coerce(rec[pos], typ)
                pending.append(values)
                n += 1
                if len(pending) >= 8192:  # bounded batches, F calls each
                    self._batch_upsert(idx, pending)
                    pending = []
            if pending:
                self._batch_upsert(idx, pending)
        return SQLResult(schema=[], data=[], changed=n)

    def _delete(self, d: ast.DeleteStatement) -> SQLResult:
        from pilosa_tpu_torch.pql.ast import Call, Query
        idx = self.api.holder.index(d.table)
        if d.where is None:
            target = Call("All")
        else:
            fc, host = self.planner._split_filter(idx, d.where)
            if host is not None:
                raise SQLError("DELETE WHERE must be expressible as a filter")
            target = fc or Call("All")
        n = self.api.executor.execute(
            d.table, Query([Call("Delete", children=[target])]))[0]
        return SQLResult(schema=[], data=[], changed=int(n))

    # -- SHOW -----------------------------------------------------------------

    # -- system tables (reference: systemlayer/systemlayer.go exposing the
    #    query-history ring as fb_exec_requests) ------------------------------

    def _system_table(self, stmt: ast.SelectStatement) -> SQLResult:
        if (stmt.where is not None or stmt.order_by or stmt.group_by
                or stmt.distinct or stmt.offset):
            # refuse rather than silently return unfiltered rows
            raise SQLError(
                "system tables support only SELECT <cols> [LIMIT n]")
        cols, provider = _SYSTEM_TABLES[stmt.table]
        rows = provider(self.api)
        names = [c[0] for c in cols]
        want = names
        if not (len(stmt.items) == 1
                and isinstance(stmt.items[0].expr, ast.Star)):
            want = []
            for it in stmt.items:
                if not isinstance(it.expr, ast.ColumnRef):
                    raise SQLError(
                        "system tables support only plain column selects")
                if it.expr.name not in names:
                    raise SQLError(f"unknown column {it.expr.name!r}")
                want.append(it.expr.name)
        sel = [names.index(w) for w in want]
        data = [[r[i] for i in sel] for r in rows]
        if stmt.limit is not None:
            data = data[: stmt.limit]
        schema = [cols[i] for i in sel]
        return SQLResult(schema=schema, data=data)

    def _show_tables(self) -> SQLResult:
        rows = [[name] for name in sorted(self.api.holder.indexes)]
        return SQLResult(schema=[("name", "STRING")], data=rows)

    def _show_columns(self, table: str) -> SQLResult:
        idx = self.api.holder.index(table)
        rows = [["_id", id_sql_type(idx.options.keys)]]
        for f in idx.public_fields():
            rows.append([f.name, field_to_sql_type(f.options)])
        return SQLResult(schema=[("name", "STRING"), ("type", "STRING")],
                         data=rows)


def _exec_requests_rows(api) -> List[List[Any]]:
    return [[r.request_id, r.index, r.query, r.language, r.start_time,
             r.runtime_ns, r.status, r.error]
            for r in api.history.list()]


def _performance_counters_rows(api) -> List[List[Any]]:
    from pilosa_tpu_torch.obs.metrics import REGISTRY

    j = REGISTRY.as_json()
    rows = [[k, float(v)] for k, v in j["counters"].items()]
    rows += [[k, float(v)] for k, v in j["gauges"].items()]
    return sorted(rows)


# name -> (schema, provider(api) -> rows); reference: fb_exec_requests et
# al in systemlayer/ + sql3 system tables
_SYSTEM_TABLES = {
    "fb_exec_requests": (
        [("request_id", "STRING"), ("index", "STRING"), ("query", "STRING"),
         ("language", "STRING"), ("start_time", "DECIMAL"),
         ("runtime_ns", "INT"), ("status", "STRING"), ("error", "STRING")],
        _exec_requests_rows),
    "fb_performance_counters": (
        [("name", "STRING"), ("value", "DECIMAL")],
        _performance_counters_rows),
}


def _coerce(raw: str, typ: str):
    typ = typ.upper()
    if raw == "" and typ != "STRING":
        return None
    if typ in ("ID", "INT"):
        return int(raw)
    if typ == "DECIMAL":
        return float(raw)
    if typ == "BOOL":
        return raw.strip().lower() in ("1", "true", "t", "yes")
    if typ in ("IDSET", "STRINGSET"):
        parts = [p for p in raw.split(";") if p]
        return [int(p) for p in parts] if typ == "IDSET" else parts
    return raw  # STRING, TIMESTAMP pass through


def _shard_width() -> int:
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
    return SHARD_WIDTH
