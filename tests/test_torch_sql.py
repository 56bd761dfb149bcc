"""SQL over the port (``pilosa_tpu_torch/sql``), held against the JAX
package's ``pilosa_tpu/sql``.

Two kinds of test:

* unit parity: each test runs once per package through the ``P``
  fixture of modules, and its body compares that package's output with
  the JAX package's: the lexer's tokens and the parser's AST (class
  names and fields, recursively) for every statement of
  ``tests/test_sql_parser.py`` and ``tests/test_sql.py`` that is a plain
  string, of ``tests/test_sql_defs.py``'s ``SETUP`` and ``CASES``, of the
  13 SSB queries and of a DDL / DML battery; the ``SQLError`` texts of
  bad statements; ``types`` over every SQL type; ``plan.eval_expr`` over
  the string, date and cast functions;
* the JAX package's SQL tests run over :class:`Dual`: every statement
  goes through ``pilosa_tpu_torch.api.API(device="cpu")`` and
  ``pilosa_tpu.api.API``, and the two results must have equal rows,
  schemas, cell types (int / float / str / bool / list / None),
  rows-affected and ``sql_join_*`` counter deltas; errors must have the
  same type name and text. The test's own assertions then read the
  port's result. Covered: the cases of ``tests/test_sql.py`` (its
  ``test_copy_remote_over_client`` runs across both packages' servers
  in ``test_copy_with_url_waits_for_the_client``), the
  single-node cases of ``tests/test_sql_defs.py`` and
  ``tests/test_sql_joins.py``'s ``TestBitIdentity`` and
  ``TestCacheInvalidation``; ``TestObservability`` runs once per package
  (its tenant case waits for the port's ``TenantRegistry``).

Tolerance: exact. Floats (AVG, decimals) are computed by the same host
code from the same integers in both packages, so they compare with
``==``.
"""

import ast as pyast
import dataclasses
import importlib
import os
import types

import pytest

import test_sql as tsql
import test_sql_defs as tsd
import test_sql_joins as tsj
from pilosa_tpu.api import API as JaxAPI
from pilosa_tpu.obs import metrics as JaxM
from pilosa_tpu.pql.result import result_to_json as jax_result_to_json
from pilosa_tpu.sql import SQLEngine as JaxEngine
from pilosa_tpu_torch.api import API as TorchAPI
from pilosa_tpu_torch.obs import metrics as TorchM
from pilosa_tpu_torch.pql.result import result_to_json as torch_result_to_json
from pilosa_tpu_torch.sql import SQLEngine as TorchEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(root: str) -> types.SimpleNamespace:
    m = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    return types.SimpleNamespace(
        root=root, lexer=m("sql.lexer"), ast=m("sql.ast"),
        parser=m("sql.parser"), types=m("sql.types"), plan=m("sql.plan"),
        planner=m("sql.planner"), engine=m("sql.engine"),
        joins=m("sql.joins"), ssb=m("loadgen.ssb"), API=m("api").API,
        M=m("obs.metrics"), T=m("obs.tracing"),
        history=m("obs.history"), logger=m("obs.logger"))


_PACKAGES = {}


def _pkg(root: str) -> types.SimpleNamespace:
    if root not in _PACKAGES:
        _PACKAGES[root] = _load(root)
    return _PACKAGES[root]


@pytest.fixture(params=["pilosa_tpu", "pilosa_tpu_torch"],
                ids=["jax", "torch"])
def P(request):
    return _pkg(request.param)


@pytest.fixture
def J():
    return _pkg("pilosa_tpu")


def _api(P):
    return P.API(device="cpu") if P.root == "pilosa_tpu_torch" else P.API()


# -- value shapes compared across packages ----------------------------------

def _shape(v):
    """A value with its Python type at every level: dataclass nodes as
    (class name, fields), enums by value, objects with a PQL form by
    their text."""
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return (type(v).__name__, tuple(
            (f.name, _shape(getattr(v, f.name)))
            for f in dataclasses.fields(v)))
    if hasattr(v, "to_pql"):
        return ("pql", v.to_pql())
    if isinstance(v, (list, tuple)):
        return (type(v).__name__, tuple(_shape(x) for x in v))
    if isinstance(v, dict):
        return ("dict", tuple((_shape(k), _shape(x)) for k, x in v.items()))
    if hasattr(v, "value") and type(v).__module__.endswith("schema"):
        return ("enum", v.value)
    return (type(v).__name__, v)


def _outcome(fn):
    """(result shape, None) or (None, (error type name, text))."""
    try:
        return _shape(fn()), None
    except Exception as e:  # noqa: BLE001 — the error is the outcome
        return None, (type(e).__name__, str(e))


# -- the statement corpus ----------------------------------------------------

def _string_statements(path):
    """Every plain string literal of a test file that is a SQL statement."""
    heads = ("SELECT", "INSERT", "CREATE", "DROP", "ALTER", "DELETE",
             "REPLACE", "SHOW", "BULK", "COPY", "PREDICT")
    with open(path) as f:
        tree = pyast.parse(f.read())
    out = []
    for node in pyast.walk(tree):
        if isinstance(node, pyast.Constant) and isinstance(node.value, str):
            s = node.value.strip()
            if s.split(" ", 1)[0].upper() in heads and " " in s:
                out.append(node.value)
    return out


_BATTERY = [
    "CREATE TABLE IF NOT EXISTS t (_id STRING, a INT MIN -5 MAX 5, "
    "b DECIMAL(3), c TIMESTAMP TIMEUNIT 'ms', d IDSETQ TIMEQUANTUM 'YMDH' "
    "TTL '30d', e STRING CACHETYPE ranked SIZE 100, f BOOL, g VARCHAR)",
    "ALTER TABLE t ADD COLUMN h INT",
    "ALTER TABLE t DROP COLUMN h",
    "DROP TABLE IF EXISTS t",
    "INSERT INTO t (_id, a) VALUES ('x', 1), ('y', -2)",
    "REPLACE INTO t VALUES ('x', 1, 2.5, '2024-01-01T00:00:00Z', "
    "{'2024-01-01T00:00:00Z', [1, 2]}, 'z', true, 'v')",
    "DELETE FROM t WHERE a > 1 AND NOT b IS NULL",
    "BULK INSERT INTO t (_id, a) MAP (0 STRING, 1 INT) FROM 'x,1' "
    "WITH FORMAT 'CSV' INPUT 'STREAM' HEADER_ROW ROWSLIMIT 10",
    "COPY t TO u WHERE a > 0",
    "COPY t TO u WITH URL 'http://localhost:1' APIKEY 'k'",
    "CREATE VIEW v AS SELECT _id FROM t WHERE a = 1",
    "DROP VIEW IF EXISTS v",
    "CREATE FUNCTION f (@x INT, @y STRING) RETURNS INT AS BEGIN END",
    "DROP FUNCTION IF EXISTS f",
    "CREATE MODEL m (v INT) WITH BUDGET 100",
    "DROP MODEL m",
    "PREDICT USING m SELECT a FROM t",
    "SHOW TABLES", "SHOW COLUMNS FROM t", "SHOW DATABASES",
    "SELECT DISTINCT TOP(3) a, b AS bb, COUNT(DISTINCT c) FROM t x "
    "WHERE a NOT IN (1, 2) AND b NOT BETWEEN 1 AND 2 AND e NOT LIKE 'a%' "
    "GROUP BY a, b HAVING COUNT(*) > 1 ORDER BY a DESC, bb LIMIT 5 "
    "OFFSET 2",
    "SELECT * FROM (SELECT _id, a FROM t) AS d WHERE d.a <> 3 -- note",
    "SELECT CAST(a AS DECIMAL(10, 2)), -a % 3, 'it''s' FROM t;",
]


def _corpus():
    out = []
    for f in ("test_sql_parser.py", "test_sql.py"):
        out += _string_statements(os.path.join(ROOT, "tests", f))
    out += list(tsd.SETUP) + [c[1] for c in tsd.CASES]
    out += list(_pkg("pilosa_tpu").ssb.QUERIES.values())
    out += _BATTERY
    return list(dict.fromkeys(out))


CORPUS = _corpus()

BAD_SQL = [
    "SELEC * FROM t", "SELECT FROM t WHERE", "SELECT a FROM", "SELECT 'abc",
    "SELECT a FROM t RIGHT JOIN d ON t.k = d._id",
    "SELECT a FROM t FULL JOIN d ON t.k = d._id",
    "SELECT a FROM f JOIN d WHERE a = 1",
    "CREATE TABLE t (_id ID, a WIDGET)", "CREATE TABLE t (_id ID, a INT",
    "INSERT INTO t VALUES (1, 2", "SELECT a FROM t LIMIT x",
    "SELECT a FROM t ORDER", "SELECT $ FROM t", "DROP", "",
]


# -- unit parity -------------------------------------------------------------

def test_corpus_covers_every_source():
    assert len(CORPUS) > 150
    for q in _pkg("pilosa_tpu").ssb.QUERIES.values():
        assert q in CORPUS
    assert tsd.SETUP[0] in CORPUS and tsd.CASES[-1][1] in CORPUS


@pytest.mark.parametrize("i", range(len(CORPUS)))
def test_tokens_and_ast(P, J, i):
    sql = CORPUS[i]
    assert _outcome(lambda: P.lexer.tokenize(sql)) == \
        _outcome(lambda: J.lexer.tokenize(sql))
    assert _outcome(lambda: P.parser.parse_statement(sql)) == \
        _outcome(lambda: J.parser.parse_statement(sql))


@pytest.mark.parametrize("sql", BAD_SQL)
def test_sql_error_texts(P, J, sql):
    got = _outcome(lambda: P.parser.parse_statement(sql))
    assert got[1] is not None  # a SQLError, or the JAX package's ValueError
    assert got == _outcome(lambda: J.parser.parse_statement(sql))


def test_sql_error_is_a_value_error(P):
    assert issubclass(P.lexer.SQLError, ValueError)


_TYPE_DEFS = [
    "a ID", "a STRING", "a IDSET", "a STRINGSET", "a IDSETQ",
    "a STRINGSETQ TIMEQUANTUM 'YM' TTL '12h'", "a IDSETQ TTL 'x'",
    "a INT", "a INT MIN -10 MAX 10", "a DECIMAL", "a DECIMAL(4)",
    "a TIMESTAMP", "a TIMESTAMP TIMEUNIT 'ms'", "a BOOL", "a VARCHAR",
    "a ID CACHETYPE lru SIZE 10", "a STRING CACHETYPE none",
]


@pytest.mark.parametrize("col", _TYPE_DEFS)
def test_types_over_every_sql_type(P, J, col):
    def run(pkg):
        ct = pkg.parser.parse_statement(f"create table t (_id id, {col})")
        cd = ct.columns[1]
        fo = pkg.types.column_to_field_options(cd)
        return (fo, pkg.types.column_to_options_dict(cd),
                pkg.types.field_to_sql_type(fo),
                pkg.types.id_sql_type(True), pkg.types.id_sql_type(False))
    assert _outcome(lambda: run(P)) == _outcome(lambda: run(J))


_EXPRS = [
    # strings
    "upper('aB')", "lower('aB')", "len('abc')", "abs(-3)", "abs(-2.5)",
    "reverse('abc')", "substring('hello', 1, 3)", "substring('hello', 2)",
    "substring('hello', 9)", "substring('hello', 1, 9)",
    "replaceall('a-b-c', '-', '+')", "charindex('b', 'abcb')",
    "charindex('b', 'abcb', 2)", "charindex('b', 'abcb', 9)",
    "trim('  x  ')", "ltrim('  x  ')", "rtrim('  x  ')", "space(3)",
    "space(-1)", "str(3.7)", "str(12345678901, 5)", "str(3.14159, 8, 2)",
    "ascii('A')", "ascii('AB')", "char(66)",
    "format('%s-%d-%t-%f-%%', 'x', 7, true, 2)", "format('%d', 'x')",
    "format('%s')", "upper(null)", "reverse(null)", "nosuchfn(1)",
    "upper()",
    # dates
    "datetimepart('yy', '2024-02-29T23:59:59Z')",
    "datetimepart('yd', '2024-02-29T23:59:59Z')",
    "datetimepart('w', '2024-02-29T23:59:59Z')",
    "datetimepart('wk', '2024-02-29T23:59:59Z')",
    "datepart('ms', '2024-02-29T23:59:59.123456Z')",
    "datepart('us', '2024-02-29T23:59:59.123456Z')",
    "datepart('ns', '2024-02-29T23:59:59.123456Z')",
    "datepart('q', '2024-02-29T23:59:59Z')",
    "datetimeadd('m', 1, '2023-01-31T00:00:00Z')",
    "datetimeadd('yy', 1, '2024-02-29T00:00:00Z')",
    "datetimeadd('m', -13, '2023-03-31T10:00:00Z')",
    "datetimeadd('d', 40, '2023-01-31T00:00:00Z')",
    "datetimeadd('ns', 5000, '2023-01-31T00:00:00Z')",
    "datetimeadd('zz', 1, '2023-01-31T00:00:00Z')",
    "datetimediff('yy', '2020-05-01T00:00:00Z', '2023-01-01T00:00:00Z')",
    "datetimediff('m', '2020-05-01T00:00:00Z', '2023-01-01T00:00:00Z')",
    "datetimediff('hh', '2023-01-02T00:00:00Z', '2023-01-01T00:00:01Z')",
    "datetimediff('ns', '2020-01-01T00:00:00Z', "
    "'2021-01-01T00:00:00.000001Z')",
    "datetimename('m', '2023-07-04T00:00:00Z')",
    "datetimename('w', '2023-07-04T00:00:00Z')",
    "datetimename('d', '2023-07-04T00:00:00Z')",
    "totimestamp(1700000000)", "totimestamp(1700000000123, 'ms')",
    "totimestamp(1700000000123456789, 'ns')", "totimestamp(1, 'weeks')",
    "datetimepart('yy', 'notadate')",
    # casts
    "cast('20' as int)", "cast('abc' as int)", "cast(true as int)",
    "cast(3.9 as int)", "cast('true' as bool)", "cast('maybe' as bool)",
    "cast(0 as bool)", "cast('1.23456' as decimal(2))",
    "cast(7 as decimal(10, 3))", "cast('abc' as decimal(2))",
    "cast(12 as string)", "cast(false as string)", "cast(5 as idset)",
    "cast(5 as stringset)", "cast(1000 as timestamp)",
    "cast('2023-01-15T10:30:45+00:00' as timestamp)",
    "cast('notadate' as timestamp)", "cast(null as int)",
    "cast(1 as widget)",
    # arithmetic and logic
    "7 / 2", "7.0 / 2", "-7 / 2", "10 % 3", "1 / 0", "2 + 3 * 4",
    "'a' = 'a'", "1 < 2 and 3 > 4", "null = 1", "not true",
    "1 in (1, 2)", "3 between 1 and 2", "'abc' like 'a%'",
    "null is null", "setcontains([1, 2], 2)",
    "setcontainsall(['a', 'b'], ['a', 'c'])",
]


@pytest.mark.parametrize("expr", _EXPRS)
def test_eval_expr_functions(P, J, expr):
    def run(pkg):
        e = pkg.parser.parse_statement(f"select {expr}").items[0].expr
        return pkg.plan.eval_expr(e, {})
    assert _outcome(lambda: run(P)) == _outcome(lambda: run(J))


def test_eval_expr_over_an_environment(P, J):
    env = {"a": 5, "t.b": "x", "s": ["p", "q"], "n": None}
    exprs = ["a * 2 + 1", "t.b", "upper(t.b)", "setcontains(s, 'q')",
             "n is null", "a > n", "coalesce(n, 3)"]
    for expr in exprs:
        def run(pkg):
            e = pkg.parser.parse_statement(f"select {expr}").items[0].expr
            return pkg.plan.eval_expr(e, dict(env))
        assert _outcome(lambda: run(P)) == _outcome(lambda: run(J)), expr


# -- both APIs side by side --------------------------------------------------

_JOIN_COUNTERS = ("sql_join_queries_total", "sql_join_fallback_total",
                  "sql_join_dim_rows_total", "sql_join_broadcast_bytes_total")


def _join_counts(M):
    c = M.REGISTRY.snapshot()["counters"]
    return [c.get(k, 0) for k in _JOIN_COUNTERS]


def _result_shape(r):
    return _shape((r.schema, r.data, r.changed))


class _DualCache:
    def __init__(self, jax_api, torch_api):
        self._apis = (jax_api, torch_api)

    def flush(self):
        for a in self._apis:
            a.cache.flush()


def _dual_call(jax_fn, torch_fn, shape):
    """Run one request through both packages; equal outcomes and equal
    join-counter deltas, else the test fails. Returns the port's result,
    or raises the JAX package's error (the JAX tests name its types)."""
    j0, t0 = _join_counts(JaxM), _join_counts(TorchM)
    jerr = terr = None
    try:
        jres = jax_fn()
    except Exception as e:  # noqa: BLE001
        jerr = e
    j1 = _join_counts(JaxM)
    try:
        tres = torch_fn()
    except Exception as e:  # noqa: BLE001
        terr = e
    t1 = _join_counts(TorchM)
    assert [b - a for a, b in zip(j0, j1)] == \
        [b - a for a, b in zip(t0, t1)], "sql_join_* deltas differ"
    if jerr is not None or terr is not None:
        assert (type(jerr).__name__, str(jerr)) == \
            (type(terr).__name__, str(terr))
        raise jerr
    assert shape(tres) == shape(jres)
    return tres


class Dual:
    """``pilosa_tpu.api.API()`` and ``pilosa_tpu_torch.api.API(device=
    "cpu")`` side by side, for the JAX package's SQL tests."""

    def __init__(self):
        self.jax = JaxAPI()
        self.torch = TorchAPI(device="cpu")

    def sql(self, q):
        return _dual_call(lambda: self.jax.sql(q), lambda: self.torch.sql(q),
                          _result_shape)

    def query(self, index, pql):
        return _dual_call(
            lambda: self.jax.query(index, pql),
            lambda: self.torch.query(index, pql),
            lambda rs: _shape([
                (jax_result_to_json if r.__class__.__module__.startswith(
                    "pilosa_tpu.") else torch_result_to_json)(r)
                for r in rs]))

    def enable_cache(self):
        self.jax.enable_cache()
        self.torch.enable_cache()

    @property
    def cache(self):
        return _DualCache(self.jax, self.torch)


class DualEngine:
    """``SQLEngine(api)`` of both packages over a :class:`Dual`."""

    def __init__(self, dual):
        self._j = JaxEngine(dual.jax)
        self._t = TorchEngine(dual.torch)

    def query(self, q):
        return _dual_call(lambda: self._j.query(q), lambda: self._t.query(q),
                          _result_shape)


@pytest.fixture(scope="module", autouse=True)
def _dual_tests():
    """The JAX tests' ``API`` and ``SQLEngine`` become the dual ones
    while this module runs."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (tsql, tsd, tsj):
            mp.setattr(mod, "API", Dual)
        for mod in (tsql, tsj):
            mp.setattr(mod, "SQLEngine", DualEngine)
        yield


def _raw(fixture):
    return fixture.__wrapped__


@pytest.fixture
def eng():
    return _raw(tsql.eng)()


_SQL_FUNCS = sorted(n for n in dir(tsql) if n.startswith("test_"))
_SQL_CLASS_CASES = [("TestDialectTail", "test_function_registry_and_refusal"),
                    ("TestDialectTail", "test_model_and_predict"),
                    ("TestDialectTail", "test_copy_local"),
                    ("TestDialectTail", "test_tail_regressions"),
                    ("TestQuantumEdges", "test_replace_with_tuple_value"),
                    ("TestQuantumEdges", "test_empty_tuple_keeps_record_alive"),
                    ("TestQuantumEdges", "test_ranged_unionrows_honors_limit"),
                    ("TestQuantumEdges", "test_rangeq_bad_bound_is_sql_error")]


def test_sql_case_lists_are_complete():
    for cls in ("TestDialectTail", "TestQuantumEdges"):
        names = {n for n in dir(getattr(tsql, cls)) if n.startswith("test_")}
        listed = {n for c, n in _SQL_CLASS_CASES if c == cls}
        assert names - listed <= {"test_copy_remote_over_client"}


@pytest.mark.parametrize("name", _SQL_FUNCS)
def test_sql_cases(eng, name):
    getattr(tsql, name)(eng)


@pytest.mark.parametrize("cls,name", _SQL_CLASS_CASES)
def test_sql_class_cases(cls, name):
    getattr(getattr(tsql, cls)(), name)()


def test_copy_with_url_waits_for_the_client():
    """``COPY ... WITH URL`` ships the rows through the port's client
    (``tests/test_sql.py``'s ``test_copy_remote_over_client``): into a
    port server and into a JAX package server, from both packages, with
    equal rows."""
    from pilosa_tpu.api import API as JaxAPI
    from pilosa_tpu.server.http import serve as jax_serve
    from pilosa_tpu_torch.server.http import serve as torch_serve

    got = []
    for make_src in (lambda: TorchAPI(device="cpu"), JaxAPI):
        for make_dst, serve in ((lambda: TorchAPI(device="cpu"),
                                 torch_serve), (JaxAPI, jax_serve)):
            src, dst = make_src(), make_dst()
            src.sql("create table r1 (_id string, v int, s string)")
            src.sql("insert into r1 values ('a', 1, 'x'), ('b', 2, 'it''s')")
            srv, _ = serve(dst, port=0, background=True)
            host, port = srv.server_address[:2]
            try:
                r = src.sql(f"copy r1 to r2 with url 'http://{host}:{port}'")
                assert r.changed == 2
                got.append(sorted(map(tuple, dst.sql(
                    "select _id, v, s from r2").data)))
            finally:
                srv.shutdown()
                srv.server_close()
    assert got == [[("a", 1, "x"), ("b", 2, "it's")]] * 4


@pytest.fixture(scope="module")
def single():
    d = Dual()
    for stmt in tsd.SETUP:
        d.sql(stmt)
    return d


@pytest.mark.parametrize("name,sql,expected,ordered",
                         tsd.CASES, ids=[c[0] for c in tsd.CASES])
def test_defs_single_node(single, name, sql, expected, ordered):
    tsd.test_defs_single_node(single, name, sql, expected, ordered)


def test_star_schema(single):
    tsd.test_star_schema(single)


_DEFS_CLASS_CASES = [
    ("TestDefsDML", "test_delete_where", None),
    ("TestDefsDML", "test_replace_resets_sets", None),
    ("TestDefsDML", "test_insert_merges_sets", None),
    ("TestReviewRegressions", "test_join_unlowerable_where_conjunct", None),
    ("TestReviewRegressions", "test_single_table_alias_qualifier", None),
    ("TestReviewRegressions", "test_insert_empty_set_literal_record_exists",
     None),
    ("TestViews", "test_view_select", "api"),
    ("TestViews", "test_view_aggregate_and_order", "api"),
    ("TestViews", "test_view_of_view_and_cycle_guard", "api"),
    ("TestViews", "test_view_ddl_semantics", "api"),
    ("TestViews", "test_view_validates_at_definition", "api"),
    ("TestFunctionEdges", "test_datetimeadd_day_overflow_normalizes", "api"),
    ("TestFunctionEdges", "test_cast_errors_are_sql_errors", "api"),
    ("TestFunctionEdges", "test_cast_timestamp_normalizes", "api"),
    ("TestFunctionEdges", "test_datetimediff_ns_exact", "api"),
]


def test_defs_case_lists_are_complete():
    for cls in ("TestDefsDML", "TestReviewRegressions", "TestViews",
                "TestFunctionEdges"):
        names = {n for n in dir(getattr(tsd, cls)) if n.startswith("test_")}
        listed = {n for c, n, _ in _DEFS_CLASS_CASES if c == cls}
        # the LocalCluster case runs in tests/test_torch_sql_fanout.py,
        # once per package
        assert names - listed <= {"test_cluster_delete"}


@pytest.mark.parametrize("cls,name,fixture", _DEFS_CLASS_CASES)
def test_defs_class_cases(cls, name, fixture):
    inst = getattr(tsd, cls)()
    args = []
    if fixture is not None:
        args.append(_raw(getattr(type(inst), fixture))(inst))
    getattr(inst, name)(*args)


@pytest.fixture
def join_eng():
    return _raw(tsj.eng)()


@pytest.mark.parametrize("sql", tsj.JOIN_SQLS)
def test_joins_semi_matches_hash(join_eng, sql):
    tsj.TestBitIdentity().test_semi_matches_hash(join_eng, sql)


@pytest.mark.parametrize("name", [
    "test_left_join_falls_back",
    "test_unlowerable_dim_pred_falls_back_not_errors",
    "test_kill_switch", "test_no_join_no_cost"])
def test_joins_bit_identity_cases(join_eng, name):
    getattr(tsj.TestBitIdentity(), name)(join_eng)


def test_joins_dim_write_invalidates_join_result():
    tsj.TestCacheInvalidation().test_dim_write_invalidates_join_result()


# -- once per package --------------------------------------------------------

def _join_engine(P, monkeypatch):
    """``tests/test_sql_joins.py``'s tables on one package's engine."""
    api = _api(P)
    monkeypatch.setattr(tsj, "SQLEngine", P.engine.SQLEngine)
    return api, tsj._mk(api)


def test_join_key_covers_all_tables(P, monkeypatch):
    _, eng = _join_engine(P, monkeypatch)
    sql = tsj.JOIN_SQLS[0]
    key = eng._select_cache_key(P.parser.parse_statement(sql), sql)
    assert key is not None
    assert [t[0] for t in key[2]] == ["fact", "dim"]


def test_join_span_stages(P, monkeypatch):
    _, eng = _join_engine(P, monkeypatch)
    prev = P.T.get_tracer()
    tracer = P.T.set_tracer(P.T.Tracer(enabled=True, sample_rate=1.0,
                                       store=P.T.TraceStore(8)))
    try:
        span = tracer.start_trace("q")
        with P.T.span_scope(span):
            eng.query(tsj.JOIN_SQLS[4])
        span.finish()
    finally:
        P.T.set_tracer(prev)
    names = set()

    def walk(s):
        names.add(s.name)
        for c in s.children:
            if not isinstance(c, dict):
                walk(c)
    walk(span)
    assert {"sql.join.dim_scan", "sql.join.broadcast"} <= names


def test_join_dim_rows_and_broadcast_bytes_counted(P, monkeypatch):
    _, eng = _join_engine(P, monkeypatch)
    c0 = P.M.REGISTRY.snapshot()["counters"]
    eng.query(tsj.JOIN_SQLS[0])
    c1 = P.M.REGISTRY.snapshot()["counters"]
    for k in ("sql_join_dim_rows_total", "sql_join_broadcast_bytes_total"):
        assert c1.get(k, 0) > c0.get(k, 0)


def test_sql_request_is_recorded(P, tmp_path):
    api = _api(P)
    api.set_query_logger(str(tmp_path / "q.log"))
    prev = P.T.get_tracer()
    P.T.set_tracer(P.T.Tracer(enabled=True, sample_rate=1.0, slow_ms=1e-9,
                              store=P.T.TraceStore(8)))
    try:
        api.sql("create table h (_id id, v int)")
        with pytest.raises(P.lexer.SQLError):
            api.sql("selec 1")
        api.query("h", "Count(All())")
    finally:
        P.T.set_tracer(prev)
    recs = api.history.list()
    assert [(r.language, r.status, r.query) for r in recs] == [
        ("pql", "complete", "Count(All())"),
        ("sql", "error", "selec 1"),
        ("sql", "complete", "create table h (_id id, v int)")]
    assert all(r.trace_id for r in recs)
    lines = api.query_logger.tail()
    assert [(x["kind"], x.get("error") is not None) for x in lines] == [
        ("sql", False), ("slow", False), ("sql", True), ("slow", False),
        ("pql", False), ("slow", False)]
    assert lines[1]["requestID"] == recs[2].request_id
    rows = api.sql("select request_id, language, status from "
                   "fb_exec_requests limit 2").data
    assert rows[1] == [recs[0].request_id, "pql", "complete"]
    counters = dict(api.sql("select * from fb_performance_counters").data)
    assert counters["sql_queries_total"] >= 3


def test_failed_request_span_carries_its_error():
    """The port's ``query.pql`` and ``query.sql`` root spans carry a
    failed request's error as their ``error`` tag (the JAX package's
    drop it), and a request that succeeds has none."""
    P = _pkg("pilosa_tpu_torch")
    api = _api(P)
    store = P.T.TraceStore(8)
    prev = P.T.get_tracer()
    P.T.set_tracer(P.T.Tracer(enabled=True, sample_rate=1.0, store=store))
    try:
        api.sql("create table h (_id id, v int)")
        with pytest.raises(P.lexer.SQLError):
            api.sql("selec 1")
        with pytest.raises(Exception) as err:
            api.query("h", "Count(Row(nosuch=1))")
    finally:
        P.T.set_tracer(prev)
    recs = api.history.list()
    assert [(t["root"], t["tags"].get("error"), t["tags"]["request_id"])
            for t in store.list()] == [
        ("query.pql", str(err.value), recs[0].request_id),
        ("query.sql", recs[1].error, recs[1].request_id),
        ("query.sql", None, recs[2].request_id)]


def test_request_ids_are_distinct_uuid4s(P):
    """Every package's request ids are version-4 UUID strings, distinct
    across rings; the port's generator is reseeded in a forked child."""
    import uuid

    rings = [P.history.ExecutionRequestsAPI(capacity=500) for _ in range(2)]
    ids = [r.begin("i", "q", "pql").request_id
           for r in rings for _ in range(500)]
    assert all(str(uuid.UUID(i)) == i and uuid.UUID(i).version == 4
               for i in ids)
    assert len(set(ids)) == len(ids)
    if P.root == "pilosa_tpu_torch":
        state = P.history._IDS.getstate()
        P.history._reseed_ids()
        assert P.history._IDS.getstate() != state


def test_history_ring_and_logger_surface(P, tmp_path):
    ring = P.history.ExecutionRequestsAPI(capacity=2)
    recs = [ring.begin("i", f"q{i}", "pql") for i in range(3)]
    ring.end(recs[2], error="boom")
    assert [r.query for r in ring.list()] == ["q2", "q1"]
    assert ring.list(limit=1)[0].status == "error"
    assert ring.get(recs[0].request_id) is None
    assert ring.get(recs[1].request_id).to_json()["status"] == "running"
    ql = P.logger.QueryLogger(str(tmp_path / "sub" / "log.jsonl"))
    ql.log("sql", "", "x" * 5000, 0.00123, error="e" * 2000,
           trace_id="t", request_id="r")
    (line,) = ql.tail()
    assert (len(line["query"]), len(line["error"]), line["duration_ms"],
            line["traceID"], line["requestID"]) == (4096, 1024, 1.23, "t",
                                                    "r")
    with P.logger.CaptureLogger("x") as cap:
        P.logger.get_logger("x").info("hello %d", 3)
    assert cap.lines == ["hello 3"]
