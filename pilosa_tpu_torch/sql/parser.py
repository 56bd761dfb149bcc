"""Recursive-descent SQL parser.

Reference: sql3/parser/parser.go (hand-written recursive descent; same
approach, new grammar code). Entry point: ``parse_statement``.

Port of ``pilosa_tpu/sql/parser.py``: the same grammar and error texts.
"""

from __future__ import annotations

from typing import List

from pilosa_tpu_torch.sql import ast
from pilosa_tpu_torch.sql.lexer import SQLError, Token, tokenize

SQL_TYPES = {"ID", "STRING", "IDSET", "STRINGSET", "INT", "DECIMAL",
             "TIMESTAMP", "BOOL", "IDSETQ", "STRINGSETQ", "VARCHAR"}

AGG_FUNCS = {"COUNT", "SUM", "AVG", "MIN", "MAX", "PERCENTILE", "CORR"}


class Parser:
    def __init__(self, src: str):
        self.toks: List[Token] = tokenize(src)
        self.i = 0

    # -- token helpers -------------------------------------------------------

    def peek(self, k: int = 0) -> Token:
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.i]
        if t.kind != "EOF":
            self.i += 1
        return t

    def at_kw(self, *kws: str) -> bool:
        t = self.peek()
        return t.kind == "KEYWORD" and t.value in kws

    def at_op(self, *ops: str) -> bool:
        t = self.peek()
        return t.kind == "OP" and t.value in ops

    def accept_kw(self, *kws: str) -> bool:
        if self.at_kw(*kws):
            self.next()
            return True
        return False

    def accept_op(self, op: str) -> bool:
        if self.at_op(op):
            self.next()
            return True
        return False

    def expect_kw(self, kw: str) -> None:
        if not self.accept_kw(kw):
            raise SQLError(f"expected {kw}, got {self.peek().value!r}")

    def expect_op(self, op: str) -> None:
        if not self.accept_op(op):
            raise SQLError(f"expected {op!r}, got {self.peek().value!r}")

    def ident(self) -> str:
        t = self.next()
        # allow non-reserved keywords as identifiers (MIN/MAX/SIZE/COMMENT...)
        if t.kind not in ("IDENT", "KEYWORD"):
            raise SQLError(f"expected identifier, got {t.value!r}")
        return t.value if t.kind == "IDENT" else t.value.lower()

    # -- statements ----------------------------------------------------------

    def parse_statement(self):
        if self.at_kw("SELECT"):
            stmt = self.select()
        elif self.at_kw("CREATE"):
            stmt = self.create_table()
        elif self.at_kw("DROP"):
            stmt = self.drop_table()
        elif self.at_kw("ALTER"):
            stmt = self.alter_table()
        elif self.at_kw("INSERT", "REPLACE"):
            stmt = self.insert()
        elif self.at_kw("BULK"):
            stmt = self.bulk_insert()
        elif self.at_kw("DELETE"):
            stmt = self.delete()
        elif self.at_kw("SHOW"):
            stmt = self.show()
        elif self.at_kw("COPY"):
            stmt = self.copy_statement()
        elif self.at_kw("PREDICT"):
            stmt = self.predict()
        else:
            raise SQLError(f"unexpected token {self.peek().value!r}")
        self.accept_op(";")
        if self.peek().kind != "EOF":
            raise SQLError(f"trailing input at {self.peek().value!r}")
        return stmt

    def select(self) -> ast.SelectStatement:
        self.expect_kw("SELECT")
        s = ast.SelectStatement(items=[])
        if self.accept_kw("TOP"):
            self.expect_op("(")
            s.top = int(self.next().value)
            self.expect_op(")")
        if self.accept_kw("DISTINCT"):
            s.distinct = True
        while True:
            s.items.append(self.select_item())
            if not self.accept_op(","):
                break
        if self.accept_kw("FROM"):
            if self.at_op("("):
                # derived table: FROM (SELECT ...) [AS] alias (reference:
                # sql3 subquery sources, defs_subquery.go)
                self.next()
                s.derived = self.select()
                self.expect_op(")")
            else:
                s.table = self.ident()
            if self.accept_kw("AS"):
                s.table_alias = self.ident()
            elif self.peek().kind == "IDENT":
                s.table_alias = self.ident()
            # left-deep JOIN chain (reference: sql3/parser source joins)
            while self.at_kw("JOIN", "INNER", "LEFT", "RIGHT", "FULL",
                             "CROSS"):
                if self.at_kw("RIGHT", "FULL", "CROSS"):
                    raise SQLError(
                        f"{self.peek().value} JOIN is not supported "
                        "(INNER and LEFT joins only)")
                kind = "INNER"
                if self.accept_kw("LEFT"):
                    self.accept_kw("OUTER")
                    kind = "LEFT"
                else:
                    self.accept_kw("INNER")
                self.expect_kw("JOIN")
                j = ast.JoinClause(table=self.ident(), kind=kind)
                if self.accept_kw("AS"):
                    j.alias = self.ident()
                elif self.peek().kind == "IDENT":
                    j.alias = self.ident()
                self.expect_kw("ON")
                j.on = self.expr()
                s.joins.append(j)
        if self.accept_kw("WHERE"):
            s.where = self.expr()
        if self.accept_kw("GROUP"):
            self.expect_kw("BY")
            while True:
                s.group_by.append(self.expr())
                if not self.accept_op(","):
                    break
        if self.accept_kw("HAVING"):
            s.having = self.expr()
        if self.accept_kw("ORDER"):
            self.expect_kw("BY")
            while True:
                e = self.expr()
                desc = False
                if self.accept_kw("DESC"):
                    desc = True
                else:
                    self.accept_kw("ASC")
                s.order_by.append(ast.OrderTerm(e, desc))
                if not self.accept_op(","):
                    break
        if self.accept_kw("LIMIT"):
            s.limit = int(self.next().value)
        if self.accept_kw("OFFSET"):
            s.offset = int(self.next().value)
        return s

    def select_item(self) -> ast.SelectItem:
        if self.at_op("*"):
            self.next()
            return ast.SelectItem(ast.Star())
        e = self.expr()
        alias = None
        if self.accept_kw("AS"):
            alias = self.ident()
        elif self.peek().kind == "IDENT":
            alias = self.ident()
        return ast.SelectItem(e, alias)

    def create_table(self):
        self.expect_kw("CREATE")
        if self.accept_kw("VIEW"):
            return self._create_view()
        if self.at_kw("FUNCTION"):
            return self._create_function()
        if self.at_kw("MODEL"):
            return self._create_model()
        self.expect_kw("TABLE")
        ine = False
        if self.accept_kw("IF"):
            self.expect_kw("NOT")  # NOT is a keyword
            self.expect_kw("EXISTS")
            ine = True
        name = self.ident()
        self.expect_op("(")
        cols = [self.column_def()]
        while self.accept_op(","):
            cols.append(self.column_def())
        self.expect_op(")")
        ct = ast.CreateTable(name=name, columns=cols, if_not_exists=ine)
        while True:
            if self.accept_kw("COMMENT"):
                ct.comment = self.next().value
            elif self.accept_kw("KEYPARTITIONS"):
                ct.key_partitions = int(self.next().value)
            elif self.accept_kw("WITH"):
                continue
            else:
                break
        return ct

    def column_def(self) -> ast.ColumnDef:
        name = self.ident()
        t = self.next()
        typ = t.value.upper()
        if typ not in SQL_TYPES:
            raise SQLError(f"unknown type {t.value!r} for column {name}")
        if typ == "VARCHAR":
            typ = "STRING"
        cd = ast.ColumnDef(name=name, type=typ)
        if self.accept_op("("):
            cd.type_arg = int(self.next().value)
            self.expect_op(")")
        # constraints in any order
        while True:
            if self.accept_kw("MIN"):
                cd.min = self._signed_int()
            elif self.accept_kw("MAX"):
                cd.max = self._signed_int()
            elif self.accept_kw("TIMEUNIT"):
                cd.time_unit = self.next().value
            elif self.accept_kw("TIMEQUANTUM"):
                cd.time_quantum = self.next().value
            elif self.accept_kw("TTL"):
                cd.ttl = self.next().value
            elif self.accept_kw("CACHETYPE"):
                cd.cache_type = self.ident()
                if self.accept_kw("SIZE"):
                    cd.cache_size = int(self.next().value)
            else:
                break
        return cd

    def _signed_int(self) -> int:
        neg = self.accept_op("-")
        v = int(self.next().value)
        return -v if neg else v

    def _create_view(self) -> ast.CreateView:
        ine = False
        if self.accept_kw("IF"):
            self.expect_kw("NOT")
            self.expect_kw("EXISTS")
            ine = True
        name = self.ident()
        self.expect_kw("AS")
        return ast.CreateView(name=name, select=self.select(),
                              if_not_exists=ine)

    # -- dialect tail (reference: CreateFunctionStatement,
    #    parseCreateModelStatement, parseCopyStatement,
    #    parsePredictStatement) --------------------------------------------

    def _if_not_exists(self) -> bool:
        if self.accept_kw("IF"):
            self.expect_kw("NOT")
            self.expect_kw("EXISTS")
            return True
        return False

    def _create_function(self) -> ast.CreateFunction:
        self.expect_kw("FUNCTION")
        ine = self._if_not_exists()
        name = self.ident()
        params: list = []
        self.expect_op("(")
        if not self.at_op(")"):
            while True:
                self.expect_op("@")
                pname = self.ident()
                ptype = self.next().value.upper()
                params.append((pname, ptype))
                if not self.accept_op(","):
                    break
        self.expect_op(")")
        self.expect_kw("RETURNS")
        rtype = self.next().value.upper()
        self.expect_kw("AS")
        self.expect_kw("BEGIN")
        body: list = []
        depth = 1
        while True:
            t = self.peek()
            if t.kind == "EOF":
                raise SQLError("unterminated function body (missing END)")
            if t.kind == "KEYWORD" and t.value.upper() == "BEGIN":
                depth += 1
            elif t.kind == "KEYWORD" and t.value.upper() == "END":
                depth -= 1
                if depth == 0:
                    self.next()
                    break
            body.append(str(self.next().value))
        lang = "sql"
        if self.accept_kw("LANGUAGE"):
            lang = str(self.next().value).strip("'\"").lower()
        return ast.CreateFunction(name=name, params=params, returns=rtype,
                                  body=" ".join(body), if_not_exists=ine,
                                  language=lang)

    def _create_model(self) -> ast.CreateModel:
        self.expect_kw("MODEL")
        ine = self._if_not_exists()
        name = self.ident()
        # swallow the option/column tail verbatim (the reference's model
        # options are cloud-side configuration)
        opts: list = []
        while self.peek().kind != "EOF" and not self.at_op(";"):
            opts.append(str(self.next().value))
        return ast.CreateModel(name=name, options=" ".join(opts),
                               if_not_exists=ine)

    def copy_statement(self) -> ast.CopyStatement:
        self.expect_kw("COPY")
        source = self.ident()
        self.expect_kw("TO")
        target = self.ident()
        where = None
        if self.accept_kw("WHERE"):
            where = self.expr()
        url = api_key = None
        if self.accept_kw("WITH"):
            while True:
                if self.accept_kw("URL"):
                    url = str(self.next().value)
                elif self.accept_kw("APIKEY"):
                    api_key = str(self.next().value)
                else:
                    break
        return ast.CopyStatement(source=source, target=target, where=where,
                                 url=url, api_key=api_key)

    def predict(self) -> ast.Predict:
        self.expect_kw("PREDICT")
        self.expect_kw("USING")
        model = self.ident()
        sel = self.select()
        return ast.Predict(model=model, select=sel)

    def _if_exists(self) -> bool:
        if self.accept_kw("IF"):
            self.expect_kw("EXISTS")
            return True
        return False

    def drop_table(self):
        self.expect_kw("DROP")
        for kw, node in (("FUNCTION", ast.DropFunction),
                         ("MODEL", ast.DropModel),
                         ("VIEW", ast.DropView)):
            if self.accept_kw(kw):
                ife = self._if_exists()  # IF EXISTS precedes the name
                return node(name=self.ident(), if_exists=ife)
        self.expect_kw("TABLE")
        ife = self._if_exists()
        return ast.DropTable(name=self.ident(), if_exists=ife)

    def alter_table(self) -> ast.AlterTable:
        self.expect_kw("ALTER")
        self.expect_kw("TABLE")
        name = self.ident()
        if self.accept_kw("ADD"):
            self.accept_kw("COLUMN")
            return ast.AlterTable(name=name, add=self.column_def())
        if self.accept_kw("DROP"):
            self.accept_kw("COLUMN")
            return ast.AlterTable(name=name, drop=self.ident())
        raise SQLError("ALTER TABLE supports ADD/DROP COLUMN")

    def insert(self) -> ast.InsertStatement:
        replace = self.accept_kw("REPLACE")
        if not replace:
            self.expect_kw("INSERT")
        self.expect_kw("INTO")
        table = self.ident()
        cols: List[str] = []
        if self.accept_op("("):
            cols.append(self.ident())
            while self.accept_op(","):
                cols.append(self.ident())
            self.expect_op(")")
        self.expect_kw("VALUES")
        rows: List[List[ast.Expr]] = []
        while True:
            self.expect_op("(")
            row = [self.expr()]
            while self.accept_op(","):
                row.append(self.expr())
            self.expect_op(")")
            rows.append(row)
            if not self.accept_op(","):
                break
        return ast.InsertStatement(table=table, columns=cols, rows=rows,
                                   replace=replace)

    def bulk_insert(self) -> ast.BulkInsert:
        self.expect_kw("BULK")
        self.expect_kw("INSERT")
        self.expect_kw("INTO")
        table = self.ident()
        cols: List[str] = []
        if self.accept_op("("):
            cols.append(self.ident())
            while self.accept_op(","):
                cols.append(self.ident())
            self.expect_op(")")
        self.expect_kw("MAP")
        self.expect_op("(")
        maps = []
        while True:
            src = self.next().value  # ordinal or json path
            t = self.next().value.upper()
            maps.append((src, t))
            if not self.accept_op(","):
                break
        self.expect_op(")")
        self.expect_kw("FROM")
        source = self.next().value
        opts: dict = {}
        if self.accept_kw("WITH"):
            while True:
                t = self.peek()
                if t.kind in ("IDENT", "KEYWORD") and t.value.upper() in (
                        "FORMAT", "INPUT", "HEADER_ROW", "BATCHSIZE",
                        "ROWSLIMIT", "ALLOW_MISSING_VALUES"):
                    key = self.next().value.upper()
                    if key in ("HEADER_ROW", "ALLOW_MISSING_VALUES"):
                        opts[key] = True
                    else:
                        opts[key] = self.next().value
                else:
                    break
        return ast.BulkInsert(table=table, columns=cols, map_defs=maps,
                              source=source, options=opts)

    def delete(self) -> ast.DeleteStatement:
        self.expect_kw("DELETE")
        self.expect_kw("FROM")
        table = self.ident()
        where = None
        if self.accept_kw("WHERE"):
            where = self.expr()
        return ast.DeleteStatement(table=table, where=where)

    def show(self):
        self.expect_kw("SHOW")
        if self.accept_kw("TABLES"):
            return ast.ShowTables()
        if self.accept_kw("DATABASES"):
            return ast.ShowDatabases()
        if self.accept_kw("COLUMNS"):
            self.expect_kw("FROM")
            return ast.ShowColumns(table=self.ident())
        raise SQLError("SHOW supports TABLES / DATABASES / COLUMNS FROM t")

    # -- expressions (precedence climbing) -----------------------------------

    def expr(self) -> ast.Expr:
        return self.or_expr()

    def or_expr(self) -> ast.Expr:
        left = self.and_expr()
        while self.accept_kw("OR"):
            left = ast.Binary("OR", left, self.and_expr())
        return left

    def and_expr(self) -> ast.Expr:
        left = self.not_expr()
        while self.accept_kw("AND"):
            left = ast.Binary("AND", left, self.not_expr())
        return left

    def not_expr(self) -> ast.Expr:
        if self.accept_kw("NOT"):
            return ast.Unary("NOT", self.not_expr())
        return self.comparison()

    def comparison(self) -> ast.Expr:
        left = self.additive()
        t = self.peek()
        if t.kind == "OP" and t.value in ("=", "!=", "<", "<=", ">", ">="):
            op = self.next().value
            return ast.Binary(op, left, self.additive())
        if self.at_kw("IS"):
            self.next()
            negated = self.accept_kw("NOT")
            self.expect_kw("NULL")
            return ast.IsNull(left, negated=negated)
        negated = False
        if self.at_kw("NOT") and self.peek(1).value in ("IN", "BETWEEN", "LIKE"):
            self.next()
            negated = True
        if self.accept_kw("IN"):
            self.expect_op("(")
            items = [self.expr()]
            while self.accept_op(","):
                items.append(self.expr())
            self.expect_op(")")
            return ast.InList(left, items, negated=negated)
        if self.accept_kw("BETWEEN"):
            low = self.additive()
            self.expect_kw("AND")
            high = self.additive()
            return ast.Between(left, low, high, negated=negated)
        if self.accept_kw("LIKE"):
            pat = self.next()
            if pat.kind != "STRING":
                raise SQLError("LIKE requires a string pattern")
            return ast.Like(left, pat.value, negated=negated)
        return left

    def additive(self) -> ast.Expr:
        left = self.multiplicative()
        while self.at_op("+", "-"):
            op = self.next().value
            left = ast.Binary(op, left, self.multiplicative())
        return left

    def multiplicative(self) -> ast.Expr:
        left = self.unary()
        while self.at_op("*", "/", "%"):
            op = self.next().value
            left = ast.Binary(op, left, self.unary())
        return left

    def unary(self) -> ast.Expr:
        if self.accept_op("-"):
            return ast.Unary("-", self.unary())
        return self.primary()

    def primary(self) -> ast.Expr:
        t = self.peek()
        if t.kind == "NUMBER":
            self.next()
            v = float(t.value) if "." in t.value else int(t.value)
            return ast.Literal(v)
        if t.kind == "STRING":
            self.next()
            return ast.Literal(t.value)
        if self.at_kw("TRUE"):
            self.next()
            return ast.Literal(True)
        if self.at_kw("FALSE"):
            self.next()
            return ast.Literal(False)
        if self.at_kw("NULL"):
            self.next()
            return ast.Literal(None)
        if self.at_op("{"):
            # tuple literal {ts, [vals]} — quantum insert values
            # (reference: sql3 tuple literals, defs_timequantum.go)
            self.next()
            items = []
            if not self.at_op("}"):
                items.append(self.expr())
                while self.accept_op(","):
                    items.append(self.expr())
            self.expect_op("}")
            return ast.TupleLiteral(items=items)
        if self.at_op("["):  # set literal ['a','b'] (bulk/insert values)
            self.next()
            items = []
            if not self.at_op("]"):
                items.append(self.expr())
                while self.accept_op(","):
                    items.append(self.expr())
            self.expect_op("]")
            vals = []
            for it in items:
                if not isinstance(it, ast.Literal):
                    raise SQLError("set literals must contain literals")
                vals.append(it.value)
            return ast.Literal(vals)
        if self.at_op("("):
            self.next()
            e = self.expr()
            self.expect_op(")")
            return e
        # COUNT/MIN/MAX are keywords but also functions
        if t.kind in ("IDENT", "KEYWORD"):
            name = self.next().value
            if self.at_op("("):
                self.next()
                fname = name.upper()
                if fname == "CAST":
                    # CAST(expr AS type) -> FuncCall("CAST", [e, 'TYPE'])
                    e = self.expr()
                    self.expect_kw("AS")
                    typ = self.next().value.upper()
                    if self.accept_op("("):
                        args_s = [self.next().value]
                        while self.accept_op(","):
                            args_s.append(self.next().value)
                        self.expect_op(")")
                        typ += f"({','.join(str(a) for a in args_s)})"
                    self.expect_op(")")
                    return ast.FuncCall("CAST", [e, ast.Literal(typ)])
                distinct = False
                args: List[ast.Expr] = []
                if self.at_op("*"):
                    self.next()
                    args.append(ast.Star())
                elif not self.at_op(")"):
                    if self.accept_kw("DISTINCT"):
                        distinct = True
                    args.append(self.expr())
                    while self.accept_op(","):
                        args.append(self.expr())
                self.expect_op(")")
                return ast.FuncCall(fname, args, distinct=distinct)
            if self.accept_op("."):
                col = self.ident()
                return ast.ColumnRef(col, table=name)
            if t.kind == "KEYWORD" and name not in _SOFT_KEYWORDS:
                raise SQLError(f"unexpected keyword {name!r} in expression")
            return ast.ColumnRef(name if t.kind == "IDENT" else name.lower())
        raise SQLError(f"unexpected token {t.value!r} in expression")


# Non-reserved keywords: usable as column names in expressions (the
# dialect-tail statement keywords must not break schemas that already
# use names like `url` or `model`).
_SOFT_KEYWORDS = frozenset({
    "MIN", "MAX", "COMMENT", "SIZE", "TOP",
    "URL", "APIKEY", "MODEL", "FUNCTION", "LANGUAGE", "RETURNS",
    "BEGIN", "END", "COPY", "TO", "PREDICT", "USING",
    "RIGHT", "FULL", "CROSS",
})


def parse_statement(src: str):
    return Parser(src).parse_statement()
