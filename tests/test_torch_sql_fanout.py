"""The SQL fan-out's cases, run once per package, and the two packages'
fan-out pieces held against each other.

The ``P`` fixture yields the modules of ``pilosa_tpu`` or of their
``pilosa_tpu_torch`` counterparts; ``P.API()`` and ``P.LocalCluster``
build the port's with ``device="cpu"``. Every node is served by its
package's ``serve`` on port 0 and the nodes talk over loopback HTTP.
Covered, exactly (rows, plans and JSON compare equal):

* every case of ``tests/test_cluster.py::TestSQLFanout``, each against
  its own package's single-node oracle, and each case's plan operators
  equal across the packages;
* ``tests/test_sql_defs.py``: ``test_defs_cluster_3node`` over its
  ``CASES`` on a module-scoped 3-node cluster of each package, and
  ``TestDefsDML::test_cluster_delete``;
* ``expr_to_json`` of every wire expression class equal to the JAX
  codec's, and ``expr_from_json`` of the JAX JSON round-tripping;
* ``execute_subtree`` of the same specs on the same shards and data:
  rows and partial aggregate states equal across the packages;
* ``POST /sql`` on every node against the single node, and
  ``/internal/sql/subtree`` on a node (and its 404 on a single node).
"""

import importlib
import json
import sys
import types
import urllib.error
import urllib.request
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
import test_sql_defs as tsd  # noqa: E402

JAX, TORCH = "pilosa_tpu", "pilosa_tpu_torch"


def _load(root: str) -> types.SimpleNamespace:
    m = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    kw = {"device": "cpu"} if root == TORCH else {}
    api_cls = m("api").API
    cluster = m("cluster")
    return types.SimpleNamespace(
        root=root,
        API=lambda *a, **k: api_cls(*a, **{**kw, **k}),
        LocalCluster=lambda *a, **k: cluster.LocalCluster(*a, **{**kw, **k}),
        SQLEngine=m("sql").SQLEngine,
        F=m("sql.fanout"),
        ast=m("sql.ast"),
        M=m("obs.metrics"),
        SHARD_WIDTH=m("shardwidth").SHARD_WIDTH,
        serve=m("server.http").serve,
    )


_PACKAGES = {}


def _pkg(root):
    if root not in _PACKAGES:
        _PACKAGES[root] = _load(root)
    return _PACKAGES[root]


@pytest.fixture(params=[JAX, TORCH], ids=["jax", "torch"])
def P(request):
    return _pkg(request.param)


# ---------------------------------------------------------------------------
# tests/test_cluster.py::TestSQLFanout, with one cluster per package
# ---------------------------------------------------------------------------

def _fanout_stmts(SW):
    return [
        "create table fs (_id id, seg id, v int)",
        "insert into fs values " + ",".join(
            f"({s * SW + i}, {(s + i) % 3}, {s * 10 + i})"
            for s in range(5) for i in range(8)),
        "create table fu (_id id, name string, age int)",
        "insert into fu values " + ",".join(
            f"({s * SW + i}, 'u{(s * 8 + i) % 4}', {20 + (s * 8 + i) % 30})"
            for s in range(3) for i in range(8)),
        "create table fo (_id id, uid int, amt int)",
        "insert into fo values " + ",".join(
            f"({s * SW + i}, {(s * 8 + i) * 7 % (5 * SW)}, {i + 1})"
            for s in range(4) for i in range(8)),
    ]


_CLUSTERS = {}


@pytest.fixture(scope="module")
def _clusters():
    """One 3-node cluster per package loaded with the fs / fu / fo
    tables, beside its single-node oracle; closed at module teardown."""
    yield _CLUSTERS
    for c, _ in _CLUSTERS.values():
        c.close()
    _CLUSTERS.clear()


def _fanout_cluster(P, store):
    if P.root not in store:
        c = P.LocalCluster(3)
        oracle = P.API()
        for t in (c.coordinator, oracle):
            for stmt in _fanout_stmts(P.SHARD_WIDTH):
                t.sql(stmt)
        store[P.root] = (c, oracle)
    return store[P.root][0]


@pytest.fixture
def cluster(P, _clusters):
    return _fanout_cluster(P, _clusters)


@pytest.fixture
def sqldata(P, cluster, _clusters):
    return _clusters[P.root][1]


def _plan_ops(op):
    out = []

    def walk(n):
        out.append(n["op"])
        for c in n.get("children", []):
            walk(c)
    walk(op.plan_json())
    return out


def _find_fanout(P, op):
    if isinstance(op, P.F.FanoutScanOp):
        return op
    for c in op.child_ops():
        f = _find_fanout(P, c)
        if f is not None:
            return f
    return None


class TestSQLFanout:
    def test_host_filter_ships_with_subtree(self, P, cluster, sqldata):
        sql = "select _id, v from fs where v % 4 = 1"
        assert "FanoutScanOp" in _plan_ops(
            P.SQLEngine(cluster[1]).compile_plan(sql))
        got = cluster[1].sql(sql)
        want = sqldata.sql(sql)
        assert sorted(map(tuple, got.data)) == sorted(map(tuple, want.data))
        assert got.data

    def test_fanout_transfers_reduced_streams(self, P, cluster, sqldata):
        M = P.M
        total_rows = sqldata.sql("select count(*) from fs").data[0][0]
        sel = "select _id from fs where v % 8 = 3"
        want = sqldata.sql(sel)
        before = M.REGISTRY.value(M.METRIC_SQL_FANOUT_ROWS)
        got = cluster.coordinator.sql(sel)
        shipped = M.REGISTRY.value(M.METRIC_SQL_FANOUT_ROWS) - before
        assert sorted(map(tuple, got.data)) == sorted(map(tuple, want.data))
        assert 0 < shipped <= len(want.data) < total_rows

    def test_distributed_partial_aggregation(self, P, cluster, sqldata):
        sql = ("select seg, count(*), avg(v), min(v), max(v) from fs "
               "where v % 2 = 0 group by seg order by seg")
        assert "FanoutAggOp" in _plan_ops(
            P.SQLEngine(cluster[2]).compile_plan(sql))
        got = cluster[2].sql(sql)
        want = sqldata.sql(sql)
        assert [list(r) for r in got.data] == [list(r) for r in want.data]

    def test_count_distinct_fanout(self, P, cluster, sqldata):
        sql = "select count(distinct seg) from fs where v % 2 = 1"
        assert cluster.coordinator.sql(sql).data == sqldata.sql(sql).data

    def test_join_build_side_prefiltered(self, P, cluster, sqldata):
        sql = ("select fu.name, sum(fo.amt) from fu "
               "inner join fo on fu._id = fo.uid "
               "where upper(fu.name) = 'U1' group by fu.name")
        assert "FanoutScanOp" in _plan_ops(
            P.SQLEngine(cluster[1]).compile_plan(sql))
        got = cluster[1].sql(sql)
        want = sqldata.sql(sql)
        assert sorted(map(tuple, got.data)) == sorted(map(tuple, want.data))

    def test_fanout_survives_node_loss(self, P, cluster, sqldata):
        # replica_n=1: with node1 paused its shards are gone, and the
        # query must fail loudly, not return part of the rows
        sql = "select _id from fs where v % 4 = 1"
        cluster.pause(1)
        try:
            with pytest.raises(Exception):
                cluster.coordinator.sql(sql)
        finally:
            cluster.unpause(1)
        got = cluster.coordinator.sql(sql)
        want = sqldata.sql(sql)
        assert sorted(map(tuple, got.data)) == sorted(map(tuple, want.data))

    def test_order_limit_pushdown(self, P, cluster, sqldata):
        M = P.M
        sql = ("select _id, v from fs where v % 2 = 1 "
               "order by v desc limit 3")
        fo = _find_fanout(P, P.SQLEngine(cluster[1]).compile_plan(sql))
        assert fo is not None and fo.spec.get("limit") == 3 \
            and fo.spec.get("order_by") == [["v", True]], fo and fo.spec
        before = M.REGISTRY.value(M.METRIC_SQL_FANOUT_ROWS)
        got = cluster[1].sql(sql)
        shipped = M.REGISTRY.value(M.METRIC_SQL_FANOUT_ROWS) - before
        want = sqldata.sql(sql)
        assert [list(r) for r in got.data] == [list(r) for r in want.data]
        assert shipped <= 3 * (len(cluster) - 1)

    def test_order_limit_pushdown_alias_shadowing(self, P, cluster, sqldata):
        sql = ("select v % 4 as v from fs where v % 3 = 1 "
               "order by v desc limit 2")
        fo = _find_fanout(P, P.SQLEngine(cluster[1]).compile_plan(sql))
        assert fo is not None and "order_by" not in fo.spec
        got = cluster[1].sql(sql)
        want = sqldata.sql(sql)
        assert [list(r) for r in got.data] == [list(r) for r in want.data]


def _post(url, body: bytes, ctype="text/plain"):
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, None


@pytest.mark.parametrize("node", [0, 1, 2])
def test_post_sql_on_every_node(P, cluster, sqldata, node):
    """``POST /sql`` on a node answers as the single node does."""
    for sql in ("select seg, count(*), sum(v) from fs where v % 2 = 0 "
                "group by seg order by seg",
                "select _id, v from fs where v % 4 = 1 order by _id",
                "select count(*) from fu where upper(name) = 'U2'"):
        status, body = _post(cluster[node].node.uri + "/sql", sql.encode())
        assert status == 200
        want = sqldata.sql(sql)
        assert body["data"] == json.loads(json.dumps(want.data))
        assert [f["name"] for f in body["schema"]["fields"]] == \
            [n for n, _ in want.schema]


def test_internal_sql_subtree_route(P, cluster):
    """A node serves ``/internal/sql/subtree`` as ``execute_subtree``
    answers in process; a single node answers it with its 404."""
    spec = _specs(P.F, P.ast)[2]
    n = cluster[1]
    own = sorted(n.holder.index("fs").shards())
    status, body = _post(n.node.uri + "/internal/sql/subtree",
                         json.dumps({"spec": spec, "shards": own}).encode(),
                         "application/json")
    assert status == 200
    assert body == json.loads(json.dumps(P.F.execute_subtree(n, spec, own)))
    srv, _ = P.serve(P.API(), port=0, background=True)
    try:
        status, _ = _post(
            f"http://127.0.0.1:{srv.server_address[1]}/internal/sql/subtree",
            json.dumps({"spec": spec, "shards": [0]}).encode(),
            "application/json")
        assert status == 404
    finally:
        srv.shutdown()
        srv.server_close()


_FANOUT_SQL = [
    "select _id, v from fs where v % 4 = 1",
    "select _id from fs where v % 8 = 3",
    "select seg, count(*), avg(v), min(v), max(v) from fs "
    "where v % 2 = 0 group by seg order by seg",
    "select count(distinct seg) from fs where v % 2 = 1",
    "select fu.name, sum(fo.amt) from fu inner join fo on fu._id = fo.uid "
    "where upper(fu.name) = 'U1' group by fu.name",
    "select _id, v from fs where v % 2 = 1 order by v desc limit 3",
    "select v % 4 as v from fs where v % 3 = 1 order by v desc limit 2",
    "select seg % 2, sum(v) from fs group by seg % 2",
    "select _id, v from fs where v > 20 order by v limit 4",
]


@pytest.mark.parametrize("sql", _FANOUT_SQL)
@pytest.mark.parametrize("node", [0, 1, 2])
def test_plans_equal_across_packages(sql, node, _clusters):
    """Each node plans every query into the same operator tree (with the
    same fan-out specs) in both packages."""
    plans, specs = [], []
    for root in (JAX, TORCH):
        P = _pkg(root)
        c = _fanout_cluster(P, _clusters)
        op = P.SQLEngine(c[node]).compile_plan(sql)
        plans.append(op.plan_json())
        found = []

        def walk(o):
            if isinstance(o, (P.F.FanoutScanOp, P.F.FanoutAggOp)):
                found.append(o.spec)
            for ch in o.child_ops():
                walk(ch)
        walk(op)
        specs.append(found)
    assert plans[0] == plans[1]
    assert json.dumps(specs[0]) == json.dumps(specs[1])


# ---------------------------------------------------------------------------
# the wire codec
# ---------------------------------------------------------------------------

def _exprs(a):
    """One expression of every wire class, nested, built from ``a`` (a
    package's sql.ast module)."""
    c = a.ColumnRef
    return [
        a.Literal(3), a.Literal("x"), a.Literal(None), a.Literal(1.25),
        a.Literal([1, "a"]), c("v"), c("name", table="fu"), a.Star(),
        a.Binary("+", c("v"), a.Literal(1)),
        a.Binary("AND", a.Binary("=", c("a"), a.Literal(2)),
                 a.Unary("NOT", a.IsNull(c("b")))),
        a.Unary("-", c("v")),
        a.InList(c("seg"), [a.Literal(1), a.Literal(2)]),
        a.InList(c("seg"), [a.Literal(1)], negated=True),
        a.Between(c("v"), a.Literal(1), a.Literal(9)),
        a.Between(c("v"), a.Literal(1), a.Literal(9), negated=True),
        a.IsNull(c("s"), negated=True),
        a.Like(c("name"), "u%"),
        a.Like(c("name"), "u_", negated=True),
        a.FuncCall("UPPER", [c("name")]),
        a.FuncCall("COUNT", [a.Star()], distinct=True),
        a.FuncCall("SUM", [a.Binary("*", c("p"), c("d"))]),
    ]


def test_codec_covers_every_wire_class():
    names = {type(e).__name__ for e in _exprs(_pkg(TORCH).ast)}
    assert names == set(_pkg(TORCH).F._EXPR_TYPES) \
        == set(_pkg(JAX).F._EXPR_TYPES)


@pytest.mark.parametrize("k", range(len(_exprs(_pkg(TORCH).ast))))
def test_expr_to_json_equals_the_jax_codec(k):
    J, T = _pkg(JAX), _pkg(TORCH)
    jj = J.F.expr_to_json(_exprs(J.ast)[k])
    tj = T.F.expr_to_json(_exprs(T.ast)[k])
    assert json.dumps(tj) == json.dumps(jj)
    # the JAX JSON, decoded by the port, encodes back to the same JSON
    back = T.F.expr_from_json(json.loads(json.dumps(jj)))
    assert repr(back) == repr(_exprs(T.ast)[k])
    assert json.dumps(T.F.expr_to_json(back)) == json.dumps(jj)
    # and the port's JSON decodes in the JAX package to its expression
    assert repr(J.F.expr_from_json(tj)) == repr(_exprs(J.ast)[k])


def test_expr_codec_refuses_an_unknown_class():
    for root in (JAX, TORCH):
        P = _pkg(root)
        with pytest.raises(Exception, match="bad wire expression"):
            P.F.expr_from_json({"_t": "Nope"})
        assert P.F.expr_to_json(None) is None
        assert P.F.expr_from_json(None) is None


# ---------------------------------------------------------------------------
# execute_subtree on the same shards and data
# ---------------------------------------------------------------------------

def _specs(F, a):
    c = a.ColumnRef
    rem = lambda n, k: a.Binary("=", a.Binary("%", c("v"), a.Literal(n)),  # noqa: E731
                                a.Literal(k))
    return [
        {"index": "fs", "fields": ["v"], "pql": None,
         "host_filter": F.expr_to_json(rem(4, 1))},
        {"index": "fs", "fields": ["seg", "v"], "pql": "Row(v > 12)",
         "host_filter": F.expr_to_json(rem(2, 1)),
         "order_by": [["v", True]], "limit": 3},
        {"index": "fs", "fields": ["seg", "v"], "pql": None,
         "host_filter": F.expr_to_json(rem(2, 0)),
         "computed": [], "group_by": ["seg"],
         "aggs": [["__agg0", "COUNT", None, False],
                  ["__agg1", "AVG", F.expr_to_json(c("v")), False],
                  ["__agg2", "MIN", F.expr_to_json(c("v")), False],
                  ["__agg3", "MAX", F.expr_to_json(c("v")), False]]},
        {"index": "fs", "fields": ["seg", "v"], "pql": None,
         "host_filter": None,
         "computed": [["__grp0", F.expr_to_json(
             a.Binary("%", c("seg"), a.Literal(2)))]],
         "group_by": ["__grp0"],
         "aggs": [["__agg0", "SUM", F.expr_to_json(c("v")), False],
                  ["__agg1", "COUNT", F.expr_to_json(c("seg")), True]]},
        {"index": "fu", "fields": ["age", "name"], "pql": None,
         "host_filter": F.expr_to_json(a.Binary(
             "=", a.FuncCall("UPPER", [c("name")]), a.Literal("U1")))},
        {"index": "fs", "fields": [], "pql": None, "host_filter": None,
         "computed": [], "group_by": [],
         "aggs": [["__agg0", "COUNT", None, False]]},
    ]


@pytest.mark.parametrize("k", range(6))
@pytest.mark.parametrize("node", [0, 1, 2])
def test_execute_subtree_equal_across_packages(k, node, _clusters):
    """Each node of each package runs the same spec over the same
    shards (all five of fs, as a failover replica would, and its own):
    rows and partial states equal."""
    outs = []
    for root in (JAX, TORCH):
        P = _pkg(root)
        c = _fanout_cluster(P, _clusters)
        spec = json.loads(json.dumps(_specs(P.F, P.ast)[k]))
        n = c[node]
        own = sorted(s for s in n.holder.index(spec["index"]).shards())
        outs.append([json.dumps(P.F.execute_subtree(n, spec, sh))
                     for sh in (own, list(range(5)))])
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# tests/test_sql_defs.py over a 3-node cluster of each package
# ---------------------------------------------------------------------------

_DEFS = {}


@pytest.fixture(scope="module")
def _defs_clusters():
    yield _DEFS
    for c in _DEFS.values():
        c.close()
    _DEFS.clear()


@pytest.fixture
def defs_cluster(P, _defs_clusters):
    if P.root not in _defs_clusters:
        c = P.LocalCluster(3)
        for stmt in tsd.SETUP:
            c.coordinator.sql(stmt)
        _defs_clusters[P.root] = c
    return _defs_clusters[P.root]


@pytest.mark.parametrize("name,sql,expected,ordered",
                         tsd.CASES, ids=[c[0] for c in tsd.CASES])
def test_defs_cluster_3node(P, defs_cluster, name, sql, expected, ordered):
    tsd.test_defs_cluster_3node(defs_cluster, name, sql, expected, ordered)


def test_cluster_delete(P, monkeypatch):
    monkeypatch.setattr(tsd, "LocalCluster", P.LocalCluster)
    tsd.TestDefsDML().test_cluster_delete()
