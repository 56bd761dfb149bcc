"""The front ends' modules, held against the JAX package's.

Every test of the first part runs once per package: the ``P`` fixture
yields the modules of ``pilosa_tpu`` or of their ``pilosa_tpu_torch``
counterparts, and the test body is the same. ``P.API()`` is the JAX
package's ``API()`` or the port's ``API(device="cpu")``; each server is
that package's ``serve``. Covered: the cases of ``tests/test_http.py``,
``tests/test_auth_grpc.py`` (JWT, permissions, route gating, gRPC, OIDC
against the fake IdP on loopback), ``tests/test_ctl.py`` (config,
backup / restore / chksum, the CLI, fbsql, datagen, the query log) and
``TestORM`` / ``TestClientRoundTrip`` of ``tests/test_client_idk.py``,
with the ``[tenants.<id>]`` stanzas and a stanza's quota taking effect
at the HTTP edge.

The second part holds the two packages byte for byte where no server is
needed: JWTs under one secret and one clock, ``proto.py`` encodings,
``frame`` / ``unframe``, permission parsing, ``ROUTE_LEVELS`` and
``generate-config`` (the JAX package's TOML less the sections the port
has not got yet, named in ``_A7_KEYS``, and the keys that nothing in
either package reads, named in ``_UNREAD_KEYS``).
"""

import base64
import importlib
import io
import json
import os
import struct
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest


def _load(root: str) -> types.SimpleNamespace:
    m = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    api_cls = m("api").API
    if root == "pilosa_tpu":
        make_api = api_cls
    else:
        def make_api(*a, **kw):
            return api_cls(*a, device="cpu", **kw)
    return types.SimpleNamespace(
        root=root,
        API=make_api,
        serve=m("server").serve,
        http=m("server.http"),
        auth=m("server.auth"),
        oidc=m("server.oidc"),
        proto=m("server.proto"),
        grpc=m("server.grpc"),
        cli=m("ctl.cli"),
        Shell=m("ctl.fbsql").Shell,
        Config=m("config").Config,
        Client=m("client").Client,
        Schema=m("client").Schema,
        encode_positions=m("storage.roaring").encode_positions,
        install_shard_arrays=m("storage.store").install_shard_arrays,
        SHARD_WIDTH=m("shardwidth").SHARD_WIDTH,
        schema=m("core.schema"),
        Ingester=m("ingest.ingest").Ingester,
        datagen=m("ingest.datagen"),
        logger=m("obs.logger"),
    )


_PACKAGES = {}


def _package(root):
    if root not in _PACKAGES:
        _PACKAGES[root] = _load(root)
    return _PACKAGES[root]


@pytest.fixture(params=["pilosa_tpu", "pilosa_tpu_torch"],
                ids=["jax", "torch"])
def P(request):
    return _package(request.param)


PACKAGES = pytest.mark.parametrize("root", ["pilosa_tpu", "pilosa_tpu_torch"],
                                   ids=["jax", "torch"])


class _Served:
    """A package's ``serve(api, port=0, background=True)``; closed by
    :meth:`close`."""

    def __init__(self, P, api, **kw):
        self.api = api
        self.srv, _ = P.serve(api, port=0, background=True, **kw)
        host, port = self.srv.server_address[:2]
        self.base = f"http://{host}:{port}"

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()


def req(base, method, path, body=None, ctype="application/json"):
    data = None
    if body is not None:
        data = body if isinstance(body, bytes) else json.dumps(body).encode()
    r = urllib.request.Request(base + path, data=data, method=method,
                               headers={"Content-Type": ctype})
    with urllib.request.urlopen(r) as resp:
        return resp.status, json.loads(resp.read())


def _req(base, method, path, body=b"", token=None, ctype="text/plain"):
    r = urllib.request.Request(base + path, data=body, method=method)
    r.add_header("Content-Type", ctype)
    if token:
        r.add_header("Authorization", "Bearer " + token)
    try:
        with urllib.request.urlopen(r) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.fixture
def server(P):
    s = _Served(P, P.API())
    yield s.base
    s.close()


# ---------------------------------------------------------------------------
# tests/test_http.py
# ---------------------------------------------------------------------------


class TestHTTP:
    def test_full_flow(self, server):
        base = server
        assert req(base, "POST", "/index/trips")[0] == 200
        assert req(base, "POST", "/index/trips/field/kind")[0] == 200
        assert req(base, "POST", "/index/trips/field/dist",
                   {"options": {"type": "int"}})[0] == 200
        status, out = req(base, "POST", "/index/trips/query",
                          b"Set(1, kind=2)Set(2, kind=2)", ctype="text/plain")
        assert status == 200 and out == {"results": [True, True]}
        _, out = req(base, "POST", "/index/trips/query",
                     {"query": "Count(Row(kind=2))"})
        assert out == {"results": [2]}
        _, out = req(base, "POST", "/index/trips/import",
                     {"field": "kind", "rows": [5, 5], "cols": [10, 11]})
        assert out == {"changed": 2}
        _, out = req(base, "POST", "/index/trips/import-values",
                     {"field": "dist", "cols": [1, 2], "values": [100, -3]})
        assert out == {"imported": 2}
        _, out = req(base, "POST", "/index/trips/query",
                     {"query": "Sum(field=dist)"})
        assert out["results"][0] == {"value": 97, "count": 2}
        _, out = req(base, "GET", "/schema")
        assert {f["name"] for f in out["indexes"][0]["fields"]} == \
            {"kind", "dist"}
        _, out = req(base, "GET", "/status")
        assert out["state"] == "NORMAL"
        assert req(base, "DELETE", "/index/trips/field/dist")[0] == 200
        assert req(base, "DELETE", "/index/trips")[0] == 200
        assert req(base, "GET", "/schema")[1] == {"indexes": []}

    def test_keyed_flow(self, server):
        base = server
        req(base, "POST", "/index/users", {"options": {"keys": True}})
        req(base, "POST", "/index/users/field/likes",
            {"options": {"keys": True}})
        req(base, "POST", "/index/users/query",
            b'Set("alice", likes="pizza")Set("bob", likes="pizza")',
            ctype="text/plain")
        _, out = req(base, "POST", "/index/users/query",
                     {"query": 'Row(likes="pizza")'})
        assert out == {"results": [{"keys": ["alice", "bob"]}]}
        _, out = req(base, "POST", "/index/users/import",
                     {"field": "likes", "rowKeys": ["sushi"],
                      "colKeys": ["carol"]})
        assert out == {"changed": 1}
        _, out = req(base, "POST", "/index/users/query",
                     {"query": "TopN(likes)"})
        assert out["results"][0]["rows"][0] == {"key": "pizza", "count": 2}

    def test_import_roaring(self, server, P):
        base, sw = server, P.SHARD_WIDTH
        req(base, "POST", "/index/ev")
        req(base, "POST", "/index/ev/field/f")
        pos = np.array([3 * sw + 1, 3 * sw + 2, 5 * sw + 9], dtype=np.uint64)
        blob = base64.b64encode(P.encode_positions(pos)).decode()
        _, out = req(base, "POST", "/index/ev/shard/1/import-roaring",
                     {"field": "f", "views": {"standard": blob}})
        assert out == {"success": True}
        _, out = req(base, "POST", "/index/ev/query", {"query": "Row(f=3)"})
        assert out["results"][0]["columns"] == [sw + 1, sw + 2]
        _, out = req(base, "POST", "/index/ev/query",
                     {"query": "Count(All())"})
        assert out["results"][0] == 3
        blob = base64.b64encode(P.encode_positions(
            np.array([3 * sw + 1], dtype=np.uint64))).decode()
        req(base, "POST", "/index/ev/shard/1/import-roaring",
            {"field": "f", "views": {"standard": blob}, "clear": True})
        _, out = req(base, "POST", "/index/ev/query", {"query": "Row(f=3)"})
        assert out["results"][0]["columns"] == [sw + 2]

    def test_import_guards(self, server, P):
        base = server
        req(base, "POST", "/index/g")
        req(base, "POST", "/index/g/field/m", {"options": {"type": "mutex"}})
        req(base, "POST", "/index/g/field/n", {"options": {"type": "int"}})
        req(base, "POST", "/index/g/import",
            {"field": "m", "rows": [3], "cols": [10]})
        req(base, "POST", "/index/g/import",
            {"field": "m", "rows": [5], "cols": [10]})
        _, out = req(base, "POST", "/index/g/query", {"query": "Row(m=3)"})
        assert out["results"][0]["columns"] == []
        _, out = req(base, "POST", "/index/g/query", {"query": "Row(m=5)"})
        assert out["results"][0]["columns"] == [10]
        for path, body in (
                ("/index/g/import", {"field": "n", "rows": [0], "cols": [1]}),
                ("/index/g/import-values",
                 {"field": "n", "cols": [1, 2, 3], "values": [100]}),
                ("/index/g/import", {})):
            with pytest.raises(urllib.error.HTTPError) as e:
                req(base, "POST", path, body)
            assert e.value.code == 400, path
        blob = base64.b64encode(P.encode_positions(
            np.array([999 * (1 << 20) + 5], dtype=np.uint64))).decode()
        req(base, "POST", "/index/g/field/s")
        _, out = req(base, "POST", "/index/g/shard/0/import-roaring",
                     {"field": "s", "views": {"standard": blob},
                      "clear": True})
        assert out == {"success": True}
        bad = base64.b64encode(
            struct.pack("<II", 12348, 1) + struct.pack("<QHH", 0, 3, 10)
            + struct.pack("<I", 24) + b"\xff\xff").decode()
        with pytest.raises(urllib.error.HTTPError) as e:
            req(base, "POST", "/index/g/shard/0/import-roaring",
                {"field": "s", "views": {"standard": bad}})
        assert e.value.code == 400

    def test_errors(self, server):
        base = server
        with pytest.raises(urllib.error.HTTPError) as e:
            req(base, "POST", "/index/nope/query", {"query": "Count(All())"})
        assert e.value.code == 404
        req(base, "POST", "/index/i")
        with pytest.raises(urllib.error.HTTPError) as e:
            req(base, "POST", "/index/i/query", {"query": "Row(f="})
        assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            req(base, "GET", "/not-a-route")
        assert e.value.code == 404
        with pytest.raises(urllib.error.HTTPError) as e:
            req(base, "POST", "/index/i/query", b"\xff\xfe not json",
                ctype="application/json")
        assert e.value.code in (400, 500)

    def test_sql_endpoint(self, server):
        base = server

        def sql(q):
            try:
                return req(base, "POST", "/sql", body=q.encode(),
                           ctype="text/plain")
            except urllib.error.HTTPError as e:
                return e.code, None

        code, out = sql("CREATE TABLE metros (_id ID, name STRING, pop INT)")
        assert code == 200, out
        code, out = sql("INSERT INTO metros (_id, name, pop) VALUES "
                        "(1, 'nyc', 8000000), (2, 'sf', 800000)")
        assert code == 200 and out["rows-affected"] == 2
        code, out = sql("SELECT _id, name, pop FROM metros "
                        "WHERE pop > 1000000")
        assert code == 200 and out["data"] == [[1, "nyc", 8000000]]
        assert [f["name"] for f in out["schema"]["fields"]] == \
            ["_id", "name", "pop"]
        assert sql("SELEC nonsense")[0] == 400


@pytest.fixture
def seeded(P):
    api = P.API()
    api.create_index("t")
    api.create_field("t", "f", {"type": "set"})
    api.create_field("t", "n", {"type": "int"})
    api.query("t", "Set(1, f=2)Set(3, f=2)")
    api.import_values("t", "n", cols=[1, 3], values=[7, -4])
    s = _Served(P, api)
    yield s.base, api
    s.close()


class TestSurfaceCompletion:
    def test_shard_snapshot_round_trip(self, seeded, P):
        base, _ = seeded
        with urllib.request.urlopen(
                base + "/internal/index/t/shard/0/snapshot") as r:
            raw = r.read()
        with np.load(io.BytesIO(raw)) as z:
            arrays = {k: z[k] for k in z.files}
        fresh = P.API()
        fresh.create_index("t")
        fresh.create_field("t", "f", {"type": "set"})
        fresh.create_field("t", "n", {"type": "int"})
        P.install_shard_arrays(fresh.holder.index("t"), 0, arrays)
        assert fresh.query("t", "Row(f=2)")[0].columns == [1, 3]
        assert fresh.query("t", "Sum(field=n)")[0].val == 3

    def test_idalloc_over_http(self, seeded):
        base, _ = seeded
        out = req(base, "POST", "/internal/idalloc/reserve",
                  {"session": "s1", "count": 10})[1]
        assert out["count"] == 10
        out2 = req(base, "POST", "/internal/idalloc/reserve",
                   {"session": "s1", "count": 10})[1]
        assert out2["base"] == out["base"]
        req(base, "POST", "/internal/idalloc/commit",
            {"session": "s1", "count": 4})
        out3 = req(base, "POST", "/internal/idalloc/reserve",
                   {"session": "s2", "count": 5})[1]
        assert out3["base"] == out["base"] + 4

    def test_pprof_and_query_profile(self, seeded):
        base, _ = seeded
        with urllib.request.urlopen(base + "/debug/pprof") as r:
            stacks = json.loads(r.read())["threads"]
        assert stacks and any("http" in "".join(v).lower()
                              for v in stacks.values())
        _, out = req(base, "POST", "/index/t/query?profile=true",
                     b"Count(Row(f=2))", ctype="text/plain")
        assert out["results"] == [2]
        prof = out["profile"]
        assert prof["name"] == "query.profile" and prof["duration_ns"] > 0
        assert "query.pql" in {c["name"] for c in prof["children"]}


@pytest.fixture(scope="module", params=["pilosa_tpu", "pilosa_tpu_torch"],
                ids=["jax", "torch"])
def tail(request):
    P = _package(request.param)
    api = P.API()
    api.create_index("rt")
    api.create_field("rt", "f")
    api.query("rt", "Set(1, f=2)Set(1048577, f=3)")
    s = _Served(P, api)
    yield s.base
    s.close()


class TestRouteSurfaceTail:
    def _get(self, url):
        with urllib.request.urlopen(url) as r:
            return json.loads(r.read())

    def _post(self, url, body=b"{}"):
        r = urllib.request.Request(url, data=body, method="POST")
        with urllib.request.urlopen(r) as resp:
            return json.loads(resp.read())

    def test_version_health(self, tail):
        assert self._get(tail + "/version")["version"] == "0.1.0"
        assert self._get(tail + "/health")["state"] == "healthy"

    def test_schema_details_cardinality(self, tail):
        fld = self._get(tail + "/schema/details")["indexes"][0]["fields"][0]
        assert fld["name"] == "f" and fld["cardinality"] == 2

    def test_shards_surfaces(self, tail):
        assert self._get(tail + "/internal/shards/max")["standard"]["rt"] == 1
        assert self._get(tail + "/internal/index/rt/shards")["shards"] == \
            [0, 1]
        assert self._get(tail + "/ui/shard-distribution")["rt"]["local"] == \
            [0, 1]
        nodes = self._get(tail + "/internal/nodes")
        assert nodes and nodes[0]["id"]

    def test_queries_and_caches(self, tail):
        assert self._get(tail + "/queries")["queries"] == []
        assert self._post(tail + "/recalculate-caches") == {}

    def test_cpu_profile_roundtrip(self, tail):
        self._post(tail + "/cpu-profile/start")
        self._get(tail + "/schema")
        out = self._post(tail + "/cpu-profile/stop")
        assert any("cumulative" in line for line in out["profile"])

    def test_translate_keys_like(self, P):
        api = P.API()
        api.create_index("lk", {"keys": True})
        api.create_field("lk", "tag", {"keys": True})
        api.import_bits("lk", "tag", row_keys=["alpha", "beta", "alto"],
                        col_keys=["a", "b", "c"])
        s = _Served(P, api)
        try:
            out = self._post(s.base + "/internal/translate/field/lk/tag/"
                             "keys/like", b'{"like": "al%"}')
            assert sorted(out["ids"]) == ["alpha", "alto"]
        finally:
            s.close()


# ---------------------------------------------------------------------------
# tests/test_auth_grpc.py
# ---------------------------------------------------------------------------

SECRET = "test-secret"
ADMIN_G = "admin-group"
WRITE_G = "writer-group"
READ_G = "reader-group"


def _perms(P):
    return P.auth.Permissions(
        user_groups={WRITE_G: {"t": "write"}, READ_G: {"t": "read"}},
        admin=ADMIN_G)


class TestJWT:
    def test_round_trip(self, P):
        tok = P.auth.issue_token(SECRET, [READ_G], subject="alice")
        claims = P.auth.validate_token(SECRET, tok)
        assert claims["groups"] == [READ_G] and claims["sub"] == "alice"

    def test_bad_signature(self, P):
        tok = P.auth.issue_token("other-secret", [READ_G])
        with pytest.raises(P.auth.AuthError) as e:
            P.auth.validate_token(SECRET, tok)
        assert e.value.code == 401

    def test_expired(self, P):
        tok = P.auth.issue_token(SECRET, [READ_G], ttl_s=-10)
        with pytest.raises(P.auth.AuthError):
            P.auth.validate_token(SECRET, tok)

    @pytest.mark.parametrize("bad", ["", "a.b", "x.y.z"])
    def test_malformed(self, P, bad):
        with pytest.raises(P.auth.AuthError):
            P.auth.validate_token(SECRET, bad)


class TestPermissions:
    def test_levels(self, P):
        perms = _perms(P)
        assert perms.level([ADMIN_G], "t") == 3
        assert perms.level([WRITE_G], "t") == 2
        assert perms.level([READ_G], "t") == 1
        assert perms.level([READ_G], "other") == 0
        assert perms.level(["nobody"], "t") == 0

    def test_parse_yaml_subset(self, P):
        p = P.auth.parse_permissions(
            'user-groups:\n  "g1":\n    "test": "read"\n'
            '    "test2": "write"\n  "g2":\n    "test": "admin"\n'
            'admin: "root-group"\n')
        assert p.admin == "root-group"
        assert p.level(["g1"], "test") == 1
        assert p.level(["g1"], "test2") == 2
        assert p.level(["g2"], "test") == 3

    def test_parse_json(self, P):
        p = P.auth.parse_permissions(json.dumps(
            {"user-groups": {"g": {"i": "write"}}, "admin": "a"}))
        assert p.level(["g"], "i") == 2 and p.admin == "a"


@pytest.fixture(scope="module", params=["pilosa_tpu", "pilosa_tpu_torch"],
                ids=["jax", "torch"])
def authed(request):
    P = _package(request.param)
    api = P.API()
    api.create_index("t")
    api.create_field("t", "f", {"type": "set"})
    s = _Served(P, api, auth=P.auth.Auth(SECRET, _perms(P)))
    yield s.base, P
    s.close()


class TestRouteGating:
    def tok(self, P, group):
        return P.auth.issue_token(SECRET, [group])

    @pytest.mark.parametrize("group", [ADMIN_G, WRITE_G, READ_G])
    def test_read_query(self, authed, group):
        base, P = authed
        assert _req(base, "POST", "/index/t/query", b"Count(Row(f=1))",
                    self.tok(P, group))[0] == 200

    def test_no_token_rejected(self, authed):
        base, _ = authed
        assert _req(base, "POST", "/index/t/query",
                    b"Count(Row(f=1))")[0] == 401

    @pytest.mark.parametrize("group,want", [
        (ADMIN_G, 200), (WRITE_G, 200), (READ_G, 403)])
    def test_write_query(self, authed, group, want):
        base, P = authed
        assert _req(base, "POST", "/index/t/query", b"Set(1, f=1)",
                    self.tok(P, group))[0] == want

    @pytest.mark.parametrize("group,want", [
        (ADMIN_G, 200), (WRITE_G, 403), (READ_G, 403)])
    def test_create_index_needs_admin(self, authed, group, want):
        base, P = authed
        assert _req(base, "POST", f"/index/new_{group[:4]}", b"{}",
                    self.tok(P, group), ctype="application/json")[0] == want

    @pytest.mark.parametrize("group,want", [
        (ADMIN_G, 404), (WRITE_G, 403), (READ_G, 403)])
    def test_internal_routes_need_admin(self, authed, group, want):
        base, P = authed
        assert _req(base, "POST", "/internal/index/t/query",
                    json.dumps({"query": "Count(Row(f=1))",
                                "shards": [0]}).encode(),
                    self.tok(P, group), ctype="application/json")[0] == want

    @pytest.mark.parametrize("group,want", [(WRITE_G, 200), (READ_G, 403)])
    def test_import_needs_write(self, authed, group, want):
        base, P = authed
        assert _req(base, "POST", "/index/t/import",
                    json.dumps({"field": "f", "rows": [1],
                                "cols": [2]}).encode(),
                    self.tok(P, group), ctype="application/json")[0] == want

    def test_expired_token_rejected(self, authed):
        base, P = authed
        assert _req(base, "POST", "/index/t/query", b"Count(Row(f=1))",
                    P.auth.issue_token(SECRET, [ADMIN_G], ttl_s=-5)
                    )[0] == 401

    def test_sql_write_gated(self, authed):
        base, P = authed
        assert _req(base, "POST", "/sql",
                    b"insert into t (_id, f) values (9, [1])",
                    self.tok(P, READ_G))[0] == 403
        assert _req(base, "POST", "/sql", b"select count(*) from t",
                    self.tok(P, READ_G))[0] == 200


def test_allowed_networks_bypass(P):
    api = P.API()
    api.create_index("t")
    s = _Served(P, api, auth=P.auth.Auth(SECRET, _perms(P),
                                         allowed_networks=["127.0.0.0/8"]))
    try:
        assert _req(s.base, "POST", "/index/t/field/g", b"{}",
                    ctype="application/json")[0] == 200
    finally:
        s.close()


class TestGRPC:
    def test_index_crud_round_trip(self, P):
        api = P.API()
        s, proto = P.grpc.PilosaServicer(api), P.proto
        s.call("CreateIndex", proto._str_field(1, "g1"))
        s.call("CreateIndex", proto._str_field(1, "g2"))
        resp = s.call("GetIndexes", b"")[0]
        names = [v2.decode() for _, _, v in proto.iter_fields(resp)
                 for f2, _, v2 in proto.iter_fields(v) if f2 == 1]
        assert names == ["g1", "g2"]
        s.call("DeleteIndex", proto._str_field(1, "g1"))
        assert "g1" not in api.holder.indexes

    def test_query_pql_unary(self, P):
        api = P.API()
        s, proto = P.grpc.PilosaServicer(api), P.proto
        api.create_index("t")
        api.create_field("t", "f", {"type": "set"})
        api.query("t", "Set(1, f=7)Set(2, f=7)")
        r = proto._str_field(1, "t") + proto._str_field(2, "Count(Row(f=7))")
        _, rows = proto.decode_table_response(s.call("QueryPQLUnary", r)[0])
        assert rows == [[2]]

    def test_query_sql_unary_and_stream(self, P):
        api = P.API()
        s, proto = P.grpc.PilosaServicer(api), P.proto
        api.sql("create table st (_id id, v int)")
        api.sql("insert into st values (1, 10), (2, 20)")
        r = proto._str_field(1, "select _id, v from st order by v")
        headers, rows = proto.decode_table_response(
            s.call("QuerySQLUnary", r)[0])
        assert [n for n, _ in headers] == ["_id", "v"]
        assert rows == [[1, 10], [2, 20]]
        msgs = s.call("QuerySQL", r)
        assert len(msgs) == 2
        h0, r0 = proto.decode_row_response(msgs[0])
        h1, r1 = proto.decode_row_response(msgs[1])
        assert [n for n, _ in h0] == ["_id", "v"] and r0 == [1, 10]
        assert h1 == [] and r1 == [2, 20]

    def test_http_framed_transport(self, P):
        api = P.API()
        api.sql("create table ht (_id id, n int)")
        api.sql("insert into ht values (1, 5), (2, 9)")
        s = _Served(P, api)
        try:
            r = urllib.request.Request(
                s.base + "/grpc/pilosa.Pilosa/QuerySQLUnary",
                data=P.grpc.frame(P.proto._str_field(
                    1, "select sum(n) from ht")), method="POST")
            r.add_header("Content-Type", "application/grpc")
            with urllib.request.urlopen(r) as resp:
                assert resp.headers["grpc-status"] == "0"
                msgs = P.grpc.unframe(resp.read())
            assert P.proto.decode_table_response(msgs[0])[1] == [[14]]
            r = urllib.request.Request(s.base + "/grpc/pilosa.Pilosa/Nope",
                                       data=P.grpc.frame(b""), method="POST")
            with urllib.request.urlopen(r) as resp:
                assert resp.headers["grpc-status"] == "12"
        finally:
            s.close()

    def test_decimal_and_sets_encode(self, P):
        api = P.API()
        s = P.grpc.PilosaServicer(api)
        api.sql("create table dt (_id id, d decimal(2), tag idset)")
        api.sql("insert into dt values (1, 12.34, [3, 4])")
        _, rows = P.proto.decode_table_response(s.call(
            "QuerySQLUnary", P.proto._str_field(1, "select d, tag from dt"))[0])
        assert rows[0][0] == pytest.approx(12.34) and rows[0][1] == [3, 4]

    def test_native_grpc_transport(self, P):
        grpc = pytest.importorskip("grpc")
        import socket

        api = P.API()
        api.sql("create table ng (_id id, n int)")
        api.sql("insert into ng values (1, 5), (2, 9)")
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        server = P.grpc.serve_grpc(api, port=port)
        try:
            with grpc.insecure_channel(
                    f"127.0.0.1:{port}",
                    options=[("grpc.enable_http_proxy", 0)]) as ch:
                call = ch.unary_unary(
                    f"/{P.grpc.SERVICE}/QuerySQLUnary",
                    request_serializer=lambda b: b,
                    response_deserializer=lambda b: b)
                out = call(P.proto._str_field(1, "select sum(n) from ng"),
                           timeout=30)
            assert P.proto.decode_table_response(out)[1] == [[14]]
        finally:
            server.stop(0)


@pytest.fixture(scope="module", params=["pilosa_tpu", "pilosa_tpu_torch"],
                ids=["jax", "torch"])
def grpc_authed(request):
    P = _package(request.param)
    api = P.API()
    api.create_index("t")
    api.create_field("t", "f", {"type": "set"})
    api.create_index("other")
    s = _Served(P, api, auth=P.auth.Auth(SECRET, _perms(P)))
    yield s.base, P
    s.close()


class TestGRPCAuthz:
    def _grpc(self, grpc_authed, method, msg, group):
        base, P = grpc_authed
        r = urllib.request.Request(base + f"/grpc/pilosa.Pilosa/{method}",
                                   data=P.grpc.frame(msg), method="POST")
        r.add_header("Content-Type", "application/grpc")
        r.add_header("Authorization",
                     "Bearer " + P.auth.issue_token(SECRET, [group]))
        try:
            with urllib.request.urlopen(r) as resp:
                return resp.status
        except urllib.error.HTTPError as e:
            return e.code

    def test_writer_cannot_delete_foreign_index(self, grpc_authed):
        msg = grpc_authed[1].proto._str_field(1, "other")
        assert self._grpc(grpc_authed, "DeleteIndex", msg, WRITE_G) == 403
        assert self._grpc(grpc_authed, "DeleteIndex", msg, ADMIN_G) == 200

    def test_writer_cannot_create_index(self, grpc_authed):
        msg = grpc_authed[1].proto._str_field(1, "newidx")
        assert self._grpc(grpc_authed, "CreateIndex", msg, WRITE_G) == 403

    def test_reader_read_ok_write_denied(self, grpc_authed):
        proto = grpc_authed[1].proto
        read = proto._str_field(1, "t") + proto._str_field(2, "Count(Row(f=1))")
        write = proto._str_field(1, "t") + proto._str_field(2, "Set(9, f=1)")
        assert self._grpc(grpc_authed, "QueryPQLUnary", read, READ_G) == 200
        assert self._grpc(grpc_authed, "QueryPQLUnary", write, READ_G) == 403
        assert self._grpc(grpc_authed, "QueryPQLUnary", write, WRITE_G) == 200

    def test_sql_ddl_needs_admin(self, grpc_authed):
        msg = grpc_authed[1].proto._str_field(1, "drop table t")
        assert self._grpc(grpc_authed, "QuerySQLUnary", msg, WRITE_G) == 403


@pytest.fixture(scope="module", params=["pilosa_tpu", "pilosa_tpu_torch"],
                ids=["jax", "torch"])
def precision(request):
    P = _package(request.param)
    api = P.API()
    for name in ("t", "secret"):
        api.create_index(name)
        api.create_field(name, "f", {"type": "set"})
    perms = P.auth.Permissions(user_groups={
        READ_G: {"t": "read"}, "idx-admins": {"t": "admin"}}, admin=ADMIN_G)
    s = _Served(P, api, auth=P.auth.Auth(SECRET, perms))
    yield s.base, P
    s.close()


class TestAuthPrecision:
    def test_sql_select_checks_each_table(self, precision):
        base, P = precision
        tok = P.auth.issue_token(SECRET, [READ_G])
        assert _req(base, "POST", "/sql", b"select count(*) from t",
                    tok)[0] == 200
        assert _req(base, "POST", "/sql", b"select count(*) from secret",
                    tok)[0] == 403
        assert _req(base, "POST", "/sql",
                    b"select count(*) from t inner join secret "
                    b"on t._id = secret._id", tok)[0] == 403

    def test_per_index_admin_not_global(self, precision):
        base, P = precision
        tok = P.auth.issue_token(SECRET, ["idx-admins"])
        assert _req(base, "POST", "/sql", b"drop table t", tok)[0] == 200
        assert _req(base, "POST", "/sql", b"drop table secret", tok)[0] == 403
        assert _req(base, "POST", "/sql", b"select count(*) from secret",
                    tok)[0] == 403


class TestGRPCInspect:
    def test_inspect_streams_records(self, P):
        api = P.API()
        proto = P.proto
        api.sql("create table ins (_id id, seg id, n int)")
        api.sql("insert into ins values (1, 10, 5), (2, 20, 7), (3, 10, 9)")
        s = P.grpc.PilosaServicer(api)
        ids = proto._len_field(2, proto._len_field(
            1, b"".join(proto._tag(1, 0) + proto._encode_varint(x)
                        for x in (1, 3))))
        msgs = s.call("Inspect", proto._str_field(1, "ins") + ids)
        assert len(msgs) == 2
        h0, r0 = proto.decode_row_response(msgs[0])
        assert [n for n, _ in h0] == ["_id", "n", "seg"] and r0 == [1, 5, 10]
        assert proto.decode_row_response(msgs[1])[1] == [3, 9, 10]
        req2 = proto._str_field(1, "ins") + ids + proto._str_field(3, "n")
        h, r = proto.decode_row_response(s.call("Inspect", req2)[0])
        assert [n for n, _ in h] == ["_id", "n"] and r == [1, 5]

    def test_inspect_query_filter_packed_ids_and_errors(self, P):
        api = P.API()
        proto = P.proto
        api.sql("create table iq (_id id, seg id, n int)")
        api.sql("insert into iq values (1, 10, 5), (2, 20, 7), (3, 10, 9)")
        s = P.grpc.PilosaServicer(api)
        assert len(s.call("Inspect", proto._str_field(1, "iq")
                          + proto._str_field(6, "Row(seg=10)"))) == 2
        packed = proto._len_field(2, proto._len_field(
            1, proto._len_field(1, bytes([1, 3]))))
        msgs = s.call("Inspect", proto._str_field(1, "iq") + packed)
        assert len(msgs) == 2 and proto.decode_row_response(msgs[0])[1][0] == 1
        with pytest.raises(KeyError):
            s.call("Inspect", proto._str_field(1, "iq")
                   + proto._str_field(3, "n)) Delete(All()"))
        assert api.sql("select count(*) from iq").data == [[3]]
        with pytest.raises(ValueError):
            s.call("Inspect", proto._str_field(1, "iq")
                   + proto._str_field(6, "Delete(All())"))
        api.sql("create table dq (_id id, d decimal(2))")
        api.sql("insert into dq values (1, 1.25)")
        h, r = proto.decode_row_response(
            s.call("Inspect", proto._str_field(1, "dq"))[0])
        assert ("d", "DECIMAL(2)") in h and r == [1, 1.25]


class _NoRedirect(urllib.request.HTTPRedirectHandler):
    def redirect_request(self, *a, **k):
        return None


def _get(url, cookies=None):
    r = urllib.request.Request(url)
    if cookies:
        r.add_header("Cookie", cookies)
    opener = urllib.request.build_opener(_NoRedirect())
    try:
        resp = opener.open(r)
        return resp.status, resp.headers, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read()


@pytest.fixture
def oidc_server(P):
    idp = P.oidc.FakeIdP(groups=[{"id": READ_G, "displayName": "readers"}])
    base_idp = idp.serve()
    api = P.API()
    api.create_index("t")
    api.create_field("t", "f", {"type": "set"})
    cfg = P.oidc.OAuthConfig(
        auth_url=base_idp + "/authorize", token_url=base_idp + "/token",
        group_endpoint=base_idp + "/groups",
        logout_endpoint=base_idp + "/logout",
        client_id="cid", client_secret="cs")
    oidc = P.oidc.OIDCAuth(cfg)
    s = _Served(P, api, auth=P.auth.Auth(SECRET, _perms(P), oidc=oidc))
    cfg.redirect_url = s.base + "/redirect"
    yield s.base, idp, oidc
    s.close()
    idp.close()


class TestOIDC:
    def test_full_login_round_trip(self, oidc_server):
        base, idp, oidc = oidc_server
        code_, hdrs, _ = _get(base + "/login")
        assert code_ == 302 and "/authorize?" in hdrs["Location"]
        state_c = [c for c in hdrs.get_all("Set-Cookie") or []
                   if c.startswith("molecula-chip-state=")]
        assert state_c
        assert "HttpOnly" in state_c[0] and "SameSite=Lax" in state_c[0]
        state_jar = state_c[0].split(";", 1)[0]
        code_, hdrs, _ = _get(hdrs["Location"])
        assert code_ == 302 and "code=" in hdrs["Location"]
        code_, hdrs, _ = _get(hdrs["Location"], cookies=state_jar)
        assert code_ == 302
        cookies = hdrs.get_all("Set-Cookie") or []
        pairs = dict(c.split(";", 1)[0].split("=", 1) for c in cookies)
        assert "molecula-chip" in pairs and "refresh-molecula-chip" in pairs
        assert any(c.startswith("molecula-chip-state=") and
                   "Expires=Thu, 01 Jan 1970" in c for c in cookies)
        jar = (f"molecula-chip={pairs['molecula-chip']}; "
               f"refresh-molecula-chip={pairs['refresh-molecula-chip']}")
        assert _get(base + "/schema", jar)[0] == 200
        assert _get(base + "/schema")[0] == 401

    def test_redirect_without_state_cookie_rejected(self, oidc_server):
        base, _, _ = oidc_server
        _, hdrs, _ = _get(base + "/login")
        _, hdrs, _ = _get(hdrs["Location"])
        assert _get(hdrs["Location"])[0] == 403
        _, hdrs, _ = _get(base + "/login")
        _, hdrs, _ = _get(hdrs["Location"])
        assert _get(hdrs["Location"],
                    cookies="molecula-chip-state=forged")[0] == 403

    def test_unregistered_state_rejected(self, oidc_server):
        base, _, _ = oidc_server
        assert _get(base + "/redirect?code=x&state=neverissued",
                    cookies="molecula-chip-state=neverissued")[0] == 403

    def test_state_cache_evicted(self, oidc_server):
        base, _, oidc = oidc_server
        for _ in range(3):
            _get(base + "/login")
        assert len(oidc._states) >= 3
        for k in list(oidc._states):
            oidc._states[k] -= oidc._state_ttl + 1
        oidc._clean_cache(oidc._clock())
        assert not oidc._states

    def test_secure_cookie_attribute(self, oidc_server, P):
        base, _, _ = oidc_server
        _, hdrs, _ = _get(base + "/login")
        assert all("Secure" not in c
                   for c in hdrs.get_all("Set-Cookie") or [])
        tc, sc = P.http._token_cookies, P.http._state_cookie
        assert all("Secure" not in c for c in tc("a", "r"))
        secured = tc("a", "r", secure=True)
        assert len(secured) == 2 and all(c.endswith("; Secure")
                                         for c in secured)
        assert all("Secure" in c for c in tc("", "", expire=True,
                                             secure=True))
        assert "Secure" in sc("s1", secure=True)
        assert "Secure" not in sc("s1")

    def test_group_cache_and_refresh(self, oidc_server):
        base, idp, _ = oidc_server
        access = idp.mint("bob")
        refresh = "r1"
        idp.refreshes[refresh] = "bob"
        jar = f"molecula-chip={access}; refresh-molecula-chip={refresh}"
        for _ in range(3):
            assert _get(base + "/schema", jar)[0] == 200
        assert idp.group_calls == 1
        expired = idp.mint("bob", ttl=-10)
        code_, hdrs, _ = _get(base + "/schema", f"molecula-chip={expired}; "
                              f"refresh-molecula-chip={refresh}")
        assert code_ == 200
        assert any(c.startswith("molecula-chip=")
                   for c in hdrs.get_all("Set-Cookie") or [])
        assert _get(base + "/schema", "molecula-chip=notajwt")[0] == 401

    def test_logout_clears_session(self, oidc_server):
        base, idp, oidc = oidc_server
        access = idp.mint("eve")
        jar = f"molecula-chip={access}"
        assert _get(base + "/schema", jar)[0] == 200
        code_, hdrs, _ = _get(base + "/logout", jar)
        assert code_ == 302
        assert any("Expires=Thu, 01 Jan 1970" in c
                   for c in hdrs.get_all("Set-Cookie") or [])
        assert access not in oidc._groups_cache


def test_userinfo_and_oauth_config(P):
    idp = P.oidc.FakeIdP(groups=[{"id": READ_G, "displayName": "readers"}])
    base_idp = idp.serve()
    cfg = P.oidc.OAuthConfig(
        auth_url=base_idp + "/authorize", token_url=base_idp + "/token",
        group_endpoint=base_idp + "/groups", client_id="cid",
        client_secret="SECRETVALUE")
    s = _Served(P, P.API(),
                auth=P.auth.Auth(SECRET, _perms(P), oidc=P.oidc.OIDCAuth(cfg)))
    try:
        r = urllib.request.Request(s.base + "/userinfo")
        r.add_header("Cookie", f"molecula-chip={idp.mint('carol')}")
        with urllib.request.urlopen(r) as resp:
            info = json.loads(resp.read())
        assert info["userid"] == "carol"
        assert info["groups"] == [{"id": READ_G}]
        r = urllib.request.Request(s.base + "/internal/oauth-config")
        r.add_header("Authorization", "Bearer " + P.auth.issue_token(
            SECRET, [ADMIN_G], subject="admin"))
        with urllib.request.urlopen(r) as resp:
            conf = json.loads(resp.read())
        assert conf["clientId"] == "cid"
        assert "SECRETVALUE" not in json.dumps(conf)
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(s.base + "/userinfo")
        assert e.value.code == 401
    finally:
        s.close()
        idp.close()


@pytest.fixture(scope="module", params=["pilosa_tpu", "pilosa_tpu_torch"],
                ids=["jax", "torch"])
def sql_authz(request):
    P = _package(request.param)
    api = P.API()
    for t in ("pub", "secret"):
        api.create_index(t)
        api.holder.index(t).create_field(
            "v", P.schema.FieldOptions(type=P.schema.FieldType.INT))
    api.sql("insert into pub (_id, v) values (1, 1)")
    api.sql("insert into secret (_id, v) values (1, 99)")
    perms = P.auth.Permissions(user_groups={
        READ_G: {"pub": "read"}, WRITE_G: {"pub": "write"}}, admin=ADMIN_G)
    s = _Served(P, api, auth=P.auth.Auth(SECRET, perms))
    yield s.base, P
    s.close()


class TestSQLAuthzTail:
    def _sql(self, sql_authz, text, groups):
        base, P = sql_authz
        code, body = _req(base, "POST", "/sql", text.encode(),
                          P.auth.issue_token(SECRET, groups, subject="u"))
        return code, json.loads(body)

    def test_derived_table_needs_source_read(self, sql_authz):
        assert self._sql(sql_authz, "select v from pub", [READ_G])[0] == 200
        assert self._sql(sql_authz, "select v from secret",
                         [READ_G])[0] == 403
        assert self._sql(sql_authz, "select v from (select v from secret) x",
                         [READ_G])[0] == 403
        code, body = self._sql(sql_authz,
                               "select v from (select v from pub) x",
                               [READ_G])
        assert code == 200 and body["data"] == [[1]]

    def test_copy_needs_read_and_admin(self, sql_authz):
        assert self._sql(sql_authz, "copy secret to leak",
                         [WRITE_G])[0] == 403
        assert self._sql(sql_authz, "copy pub to pub2", [READ_G])[0] == 403
        assert self._sql(sql_authz,
                         "copy pub to x with url 'http://127.0.0.1:1'",
                         [READ_G, WRITE_G])[0] == 403
        assert self._sql(sql_authz, "copy pub to pub2", [ADMIN_G])[0] == 200


def test_copy_with_url_ships_rows(P):
    """``COPY ... WITH URL`` creates the table on another server of the
    same package and inserts the rows through the client."""
    src, dst = P.API(), P.API()
    src.sql("create table cp (_id id, v int, tag idset)")
    src.sql("insert into cp values (1, 5, [2]), (2, -3, [2, 4]), (7, 9, [])")
    s = _Served(P, dst)
    try:
        out = src.sql(f"copy cp to cp2 with url '{s.base}'")
        assert out.changed == 3
        got = dst.sql("select _id, v, tag from cp2 order by _id").data
        assert got == src.sql("select _id, v, tag from cp order by _id").data
    finally:
        s.close()


# ---------------------------------------------------------------------------
# tests/test_ctl.py
# ---------------------------------------------------------------------------


def fill(api):
    api.create_index("b", {"keys": False})
    api.create_field("b", "f")
    api.create_field("b", "n", {"type": "int"})
    api.query("b", "Set(1, f=2)Set(9, f=2)Set(1, n=77)")
    api.import_dataframe("b", 0, [1, 9], {"fare": [1.5, 2.5]})
    api.create_index("k", {"keys": True})
    api.create_field("k", "g", {"keys": True})
    api.query("k", 'Set("alice", g="admin")')


@pytest.fixture
def ctl_server(P):
    s = _Served(P, P.API())
    yield s.api, s.base
    s.close()


class TestConfig:
    def test_layering(self, P, tmp_path):
        toml = tmp_path / "c.toml"
        toml.write_text('port = 7000\ndata-dir = "/x"\n[auth]\n'
                        'enable = true\n')
        cfg = P.Config.from_sources(
            toml_path=str(toml),
            env={"PILOSA_TPU_PORT": "8000",
                 "PILOSA_TPU_AUTH_ALLOWED_NETWORKS": "10.0.0.0/8,::1/128"},
            flags={"bind": "0.0.0.0", "port": None})
        assert cfg.port == 8000
        assert cfg.data_dir == "/x"
        assert cfg.auth_enable is True
        assert cfg.auth_allowed_networks == ["10.0.0.0/8", "::1/128"]
        assert cfg.bind == "0.0.0.0"
        assert P.Config.from_sources(flags={"port": None}).port == 10101

    def test_generate_config_roundtrip(self, P, tmp_path):
        p = tmp_path / "gen.toml"
        p.write_text(P.Config().to_toml())
        assert P.Config.from_sources(toml_path=str(p)) == P.Config()

    def test_front_end_fields(self, P, tmp_path):
        toml = tmp_path / "f.toml"
        toml.write_text(
            'log-level = "debug"\nlog-path = "/l"\n'
            'query-log-path = "/q"\nttl-removal-interval-s = 5\n'
            '[stream]\nenabled = true\nindex = "s"\n'
            '[auth]\nsecret = "x"\npermissions-file = "/p"\n'
            'secure-cookies = true\nallowed-networks = ["127.0.0.0/8"]\n')
        cfg = P.Config.from_sources(toml_path=str(toml), env={})
        assert (cfg.log_level, cfg.log_path, cfg.query_log_path,
                cfg.ttl_removal_interval_s) == ("debug", "/l", "/q", 5.0)
        assert (cfg.stream_enabled, cfg.stream_index) == (True, "s")
        assert (cfg.auth_secret, cfg.auth_permissions_file,
                cfg.auth_secure_cookies, cfg.auth_allowed_networks) == \
            ("x", "/p", True, ["127.0.0.0/8"])

    def test_tenant_stanzas(self, P, tmp_path):
        toml = tmp_path / "t.toml"
        toml.write_text(
            "port = 7000\n"
            "[tenants.alpha]\nqps = 50\ncache-bytes = 4096\nweight = 3.0\n"
            "[tenants.beta]\ningest-rows-s = 1000\n")
        cfg = P.Config.from_sources(toml_path=str(toml))
        assert cfg.tenants_overrides == {
            "alpha": {"qps": 50, "cache_bytes": 4096, "weight": 3.0},
            "beta": {"ingest_rows_s": 1000}}
        # per-tenant stanzas survive to_toml -> from_sources
        p = tmp_path / "gen.toml"
        p.write_text(cfg.to_toml())
        assert P.Config.from_sources(toml_path=str(p)) == cfg

    def test_tenant_stanzas_applied_at_enable(self, P, tmp_path):
        toml = tmp_path / "t.toml"
        toml.write_text(
            "[tenants.alpha]\nqps = 50\ncache-bytes = 4096\nweight = 3.0\n")
        cfg = P.Config.from_sources(toml_path=str(toml))
        api = P.API()
        api.enable_cache()
        api.enable_tenants(config=cfg)
        try:
            reg = api.tenants
            assert reg.cache_quota_for("alpha") == 4096
            # unconfigured tenants fall back to the global default
            assert reg.cache_quota_for("nobody") == reg.cache_quota_bytes
            assert api.cache.tenant_quota_of("alpha") == 4096
            assert reg.weight("alpha") == 3.0
        finally:
            api.disable_tenants()

    def test_tenant_stanza_quota_takes_effect_over_http(self, P, tmp_path):
        # [tenants.capped] qps = 1 holds a burst of 2 queries: the third
        # in the same instant is a 429 with Retry-After, and a tenant
        # without a stanza stays unlimited
        toml = tmp_path / "t.toml"
        toml.write_text("[tenants]\nenabled = true\n"
                        "[tenants.capped]\nqps = 1\n")
        cfg = P.Config.from_sources(toml_path=str(toml), env={})
        assert cfg.tenants_enabled
        api = P.API()
        api.create_index("i")
        api.create_field("i", "f")
        api.enable_tenants(config=cfg, clock=lambda: 0.0)
        srv = _Served(P, api)
        try:
            codes = []
            for tenant in ["capped"] * 3 + ["free"] * 3:
                req = urllib.request.Request(
                    srv.base + "/index/i/query", method="POST",
                    data=b"Count(Row(f=1))",
                    headers={"X-Tenant": tenant})
                try:
                    with urllib.request.urlopen(req, timeout=10) as r:
                        codes.append((r.status, None))
                except urllib.error.HTTPError as e:
                    codes.append((e.code, e.headers.get("Retry-After")))
            assert codes[:2] == [(200, None)] * 2
            assert codes[2][0] == 429 and int(codes[2][1]) >= 1
            assert codes[3:] == [(200, None)] * 3
            rows = api.tenants.stats_json()["tenants"]
            assert rows["capped"]["rejected"] == 1
            assert rows["free"]["rejected"] == 0
        finally:
            srv.close()
            api.disable_tenants()


class TestBackupRestore:
    def test_tar_roundtrip_between_servers(self, ctl_server, P):
        api, host = ctl_server
        fill(api)
        want_sum = api.checksum()
        with urllib.request.urlopen(host + "/internal/backup.tar") as r:
            blob = r.read()
        api2 = P.API()
        api2.create_index("junk")
        api2.restore_tar(io.BytesIO(blob))
        assert "junk" not in api2.holder.indexes
        assert api2.query("b", "Row(f=2)")[0].columns == [1, 9]
        assert api2.query("b", "Sum(field=n)")[0].val == 77
        assert api2.query("b", 'Apply("sum(fare)")')[0].value == \
            pytest.approx(4.0)
        assert api2.query("k", 'Row(g="admin")')[0].keys == ["alice"]
        assert api2.checksum() == want_sum

    def test_restore_into_durable_server(self, ctl_server, P, tmp_path):
        api, _ = ctl_server
        fill(api)
        buf = io.BytesIO()
        api.backup_tar(buf)
        api3 = P.API(str(tmp_path))
        api3.restore_tar(io.BytesIO(buf.getvalue()))
        del api3
        api4 = P.API(str(tmp_path))
        assert api4.query("b", "Row(f=2)")[0].columns == [1, 9]
        assert api4.checksum() == api.checksum()

    def test_checksum_changes_with_data(self, ctl_server):
        api, _ = ctl_server
        fill(api)
        a = api.checksum()
        api.query("b", "Set(5, f=2)")
        assert api.checksum() != a


class TestCLI:
    def test_generate_config_cmd(self, P, capsys):
        assert P.cli.main(["generate-config"]) == 0
        assert "data-dir" in capsys.readouterr().out

    def test_backup_restore_chksum_cmds(self, ctl_server, P, tmp_path,
                                        capsys):
        api, host = ctl_server
        fill(api)
        out = tmp_path / "b.tar.gz"
        assert P.cli.main(["backup", "--host", host, "--output",
                           str(out)]) == 0
        assert out.stat().st_size > 0
        assert P.cli.main(["chksum", "--host", host]) == 0
        assert capsys.readouterr().out.strip() == api.checksum()
        api.delete_index("b")
        assert P.cli.main(["restore", "--host", host, "--source",
                           str(out)]) == 0
        assert api.query("b", "Row(f=2)")[0].columns == [1, 9]

    def test_import_export_cmds(self, ctl_server, P, tmp_path, capsys):
        api, host = ctl_server
        api.create_index("ie")
        api.create_field("ie", "f")
        api.create_field("ie", "v", {"type": "int"})
        csvf = tmp_path / "in.csv"
        csvf.write_text("1,10\n1,11\n2,10\n")
        assert P.cli.main(["import", "--host", host, "--index", "ie",
                           "--field", "f", str(csvf)]) == 0
        assert api.query("ie", "Row(f=1)")[0].columns == [10, 11]
        vals = tmp_path / "vals.csv"
        vals.write_text("10,50\n11,-3\n")
        assert P.cli.main(["import", "--host", host, "--index", "ie",
                           "--field", "v", "--field-type", "int",
                           str(vals)]) == 0
        assert api.query("ie", "Sum(field=v)")[0].val == 47
        assert P.cli.main(["export", "--host", host, "--index", "ie",
                           "--field", "f"]) == 0
        lines = sorted(capsys.readouterr().out.strip().splitlines())
        assert lines == ["1,10", "1,11", "2,10"]


class TestFbsql:
    def test_shell_statements_and_meta(self, ctl_server, P):
        api, host = ctl_server
        api.create_index("s1")
        api.create_field("s1", "f")
        api.query("s1", "Set(1, f=1)")
        stdin = io.StringIO("select count(*) from s1\n\\dt\n\\timing\n"
                            "select _id from s1\nbogus sql here\n\\q\n")
        out = io.StringIO()
        assert P.Shell(host=host, stdin=stdin, stdout=out).run() == 0
        text = out.getvalue()
        assert "count" in text and "s1" in text
        assert "Timing is on." in text and "error:" in text


class TestRestoreSafety:
    def test_restore_never_unpickles_wal(self, P, tmp_path):
        import pickle
        import tarfile

        api = P.API()
        api.create_index("i")
        api.create_field("i", "f")
        api.query("i", "Set(3, f=1)")
        buf = io.BytesIO()
        api.backup_tar(buf)

        class Evil:
            def __reduce__(self):
                return (open, (str(tmp_path / "pwned"), "w"))

        src, out = io.BytesIO(buf.getvalue()), io.BytesIO()
        with tarfile.open(fileobj=src, mode="r|*") as tin, \
                tarfile.open(fileobj=out, mode="w|gz") as tout:
            for m in tin:
                tout.addfile(m, tin.extractfile(m) if m.isfile() else None)
            payload = pickle.dumps(Evil())
            rec = len(payload).to_bytes(8, "little") + payload
            info = tarfile.TarInfo("./indexes/i/wal.log")
            info.size = len(rec)
            tout.addfile(info, io.BytesIO(rec))
        api2 = P.API()
        api2.restore_tar(io.BytesIO(out.getvalue()))
        assert not (tmp_path / "pwned").exists()
        assert api2.query("i", "Row(f=1)")[0].columns == [3]


class TestDatagen:
    def test_scenarios_ingest_in_process(self, P):
        assert {"customer", "bank", "equipment",
                "kitchen-sink"} <= set(P.datagen.scenarios())
        api, api2 = P.API(), P.API()
        assert P.Ingester(api, "cust", P.datagen.scenario(
            "customer", rows=200)).run() == 200
        P.Ingester(api2, "cust", P.datagen.scenario(
            "customer", rows=200)).run()
        assert api.query("cust", "Sum(field=ltv)")[0].val == \
            api2.query("cust", "Sum(field=ltv)")[0].val
        assert api.query("cust", "Count(All())")[0] == 200

    def test_datagen_cli_remote(self, P):
        s = _Served(P, P.API())
        try:
            assert P.cli.main(["datagen", "--scenario", "bank", "--rows",
                               "300", "--index", "txns", "--host",
                               s.base]) == 0
            assert s.api.query("txns", "Count(All())")[0] == 300
            assert s.api.query("txns", "TopN(category, n=1)"
                               )[0].pairs[0].count > 0
        finally:
            s.close()


def test_datagen_cli_in_process_on_the_cpu(capsys):
    """The port's in-process ``datagen`` takes ``--device``."""
    cli = _package("pilosa_tpu_torch").cli
    assert cli.main(["datagen", "--scenario", "bank", "--rows", "50",
                     "--index", "txns", "--device", "cpu"]) == 0
    assert "ingested 50 'bank' records in-process" in capsys.readouterr().err


class TestQueryLogger:
    def test_query_log_records_pql_and_sql(self, P, tmp_path):
        api = P.API()
        api.set_query_logger(str(tmp_path / "queries.jsonl"))
        api.create_index("t")
        api.create_field("t", "f", {"type": "set"})
        api.query("t", "Set(1, f=2)")
        api.query("t", "Count(Row(f=2))")
        api.sql("select count(*) from t")
        with pytest.raises(ValueError):
            api.query("t", "Bogus(")
        recs = api.query_logger.tail()
        kinds = [(r["kind"], "error" in r) for r in recs]
        assert ("pql", False) in kinds and ("sql", False) in kinds
        assert ("pql", True) in kinds
        assert all("duration_ms" in r for r in recs)
        assert any(r["query"] == "Count(Row(f=2))" for r in recs)
        with P.logger.CaptureLogger("mesh") as cap:
            P.logger.get_logger("mesh").warning("hello %d", 7)
        assert cap.lines == ["hello 7"]


# ---------------------------------------------------------------------------
# tests/test_client_idk.py: TestORM, TestClientRoundTrip
# ---------------------------------------------------------------------------


class TestORM:
    def test_serialization(self, P):
        idx = P.Schema().index("i")
        f, g, n = idx.field("f"), idx.field("g"), idx.field("n")
        assert f.row(5).serialize() == "Row(f=5)"
        assert f.row("k").serialize() == "Row(f='k')"
        assert (f.row(1) & g.row(2)).serialize() == \
            "Intersect(Row(f=1), Row(g=2))"
        assert (f.row(1) | g.row(2)).serialize() == \
            "Union(Row(f=1), Row(g=2))"
        assert (f.row(1) - g.row(2)).serialize() == \
            "Difference(Row(f=1), Row(g=2))"
        assert (~f.row(1)).serialize() == "Not(Row(f=1))"
        assert idx.count(f.row(1)).serialize() == "Count(Row(f=1))"
        assert f.topn(5).serialize() == "TopN(f, n=5)"
        assert n.gt(3).serialize() == "Row(n > 3)"
        assert n.between(2, 8).serialize() == "Row(2 <= n <= 8)"
        assert n.sum(f.row(1)).serialize() == "Sum(Row(f=1), field=n)"
        assert f.set(3, 10).serialize() == "Set(10, f=3)"
        assert idx.group_by(f.rows(), limit=4).serialize() == \
            "GroupBy(Rows(f), limit=4)"
        assert idx.batch_query(f.set(1, 2), idx.count(f.row(1))
                               ).serialize() == "Set(2, f=1)Count(Row(f=1))"


class TestClientRoundTrip:
    def test_schema_sync_import_query(self, ctl_server, P):
        api, base = ctl_server
        c = P.Client(base)
        schema = P.Schema()
        idx = schema.index("ci")
        f = idx.field("f", type="set")
        n = idx.field("n", type="int")
        c.sync_schema(schema)
        assert "ci" in api.holder.indexes
        c.import_bits("ci", "f", [(1, 5), (1, P.SHARD_WIDTH + 9), (2, 7)])
        assert c.query(idx.count(f.row(1))) == [2]
        assert c.query(f.row(2))[0]["columns"] == [7]
        assert c.query(f.row(1))[0]["columns"] == [5, P.SHARD_WIDTH + 9]
        c.import_values("ci", "n", [(5, 10), (7, -3)])
        assert c.query(n.sum())[0]["value"] == 7
        c.query(f.set(9, 11))
        assert c.query(idx.count(f.row(9))) == [1]
        assert c.sql("select count(*) from ci")["data"] == [[4]]
        assert {i.name for i in c.schema().indexes()} >= {"ci"}

    def test_json_import_path_and_keyed(self, ctl_server, P):
        _, base = ctl_server
        c = P.Client(base)
        c.create_index("kj", keys=True)
        c._json("POST", "/index/kj/field/tag",
                {"options": {"type": "set", "keys": True}})
        c.import_keyed_bits("kj", "tag", [("red", "a"), ("red", "b"),
                                          ("blue", "a")])
        assert c.query("Count(Row(tag='red'))", index="kj") == [2]
        c.create_index("pj")
        c._json("POST", "/index/pj/field/f", {"options": {"type": "set"}})
        c.import_bits("pj", "f", [(1, 2), (1, 3)], roaring=False)
        assert c.query("Count(Row(f=1))", index="pj") == [2]


# ---------------------------------------------------------------------------
# Byte for byte across the packages
# ---------------------------------------------------------------------------

J, T = "pilosa_tpu", "pilosa_tpu_torch"


def test_jwt_tokens_equal_across_packages(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    toks = [_package(r).auth.issue_token(SECRET, [READ_G, "g2"],
                                         subject="alice", ttl_s=60)
            for r in (J, T)]
    assert toks[0] == toks[1]
    for r in (J, T):
        assert _package(r).auth.validate_token(SECRET, toks[0])["sub"] == \
            "alice"


def test_route_levels_and_permissions_equal_across_packages():
    j, t = _package(J).auth, _package(T).auth
    assert j.ROUTE_LEVELS == t.ROUTE_LEVELS
    text = ('user-groups:\n  "g1":\n    "a": "read"\n    "b": "admin"\n'
            '  g2:\n    a: write\n# note\nadmin: "root"\n')
    pj, pt = j.parse_permissions(text), t.parse_permissions(text)
    assert (pj.user_groups, pj.admin) == (pt.user_groups, pt.admin)
    for groups in (["g1"], ["g2"], ["root"], ["g1", "g2"], []):
        for index in ("a", "b", None, "c"):
            assert pj.level(groups, index) == pt.level(groups, index)


_PROTO_CASES = [
    ("encode_column_info", ("name", "DECIMAL(2)")),
    ("encode_decimal", (-1234, 2)),
    ("encode_row_response", ([("_id", "ID"), ("v", "INT"), ("s", "STRING"),
                              ("b", "BOOL"), ("d", "DECIMAL(2)"),
                              ("ids", "IDSET"), ("ks", "STRINGSET"),
                              ("ts", "TIMESTAMP")],
                             [7, -3, "x", True, 12.34, [1, 2], ["a", "b"],
                              "2020-01-02T03:04:05Z"],
                             ["ID", "INT", "STRING", "BOOL", "DECIMAL(2)",
                              "IDSET", "STRINGSET", "TIMESTAMP"], 42)),
    ("encode_table_response", ([("a", "INT"), ("b", "STRING")],
                               [[1, "x"], [None, "y"], [-5, ""]], 7)),
    ("encode_get_indexes_response", (["a", "bb", ""],)),
]


@pytest.mark.parametrize("name,args", _PROTO_CASES,
                         ids=[c[0] for c in _PROTO_CASES])
def test_proto_encodings_equal_across_packages(name, args):
    pj, pt = _package(J).proto, _package(T).proto
    want = getattr(pj, name)(*args)
    assert getattr(pt, name)(*args) == want
    if name == "encode_table_response":
        assert pt.decode_table_response(want) == pj.decode_table_response(want)
    if name == "encode_row_response":
        assert pt.decode_row_response(want) == pj.decode_row_response(want)


@pytest.mark.parametrize("fields", [
    {"index": "t", "pql": "Count(Row(f=1))"},
    {"sql": "select 1"},
    {"name": "i", "keys": True},
])
def test_proto_requests_decode_alike(fields):
    pj, pt = _package(J).proto, _package(T).proto
    if "pql" in fields:
        buf = pj._str_field(1, fields["index"]) + pj._str_field(
            2, fields["pql"])
        dec = "decode_query_pql_request"
    elif "sql" in fields:
        buf, dec = pj._str_field(1, fields["sql"]), "decode_query_sql_request"
    else:
        buf = pj._str_field(1, fields["name"]) + pj._varint_field(2, 1)
        dec = "decode_name_request"
    assert pt._str_field(1, "x") == pj._str_field(1, "x")
    assert getattr(pt, dec)(buf) == getattr(pj, dec)(buf)


def test_grpc_framing_equal_across_packages():
    gj, gt = _package(J).grpc, _package(T).grpc
    msgs = [b"", b"\x01\x02", bytes(range(256)) * 40]
    for m in msgs:
        assert gt.frame(m) == gj.frame(m)
    buf = b"".join(gj.frame(m) for m in msgs)
    assert gt.unframe(buf) == gj.unframe(buf) == msgs
    with pytest.raises(ValueError):
        gt.unframe(b"\x01\x00\x00\x00\x00")


#: ``generate-config`` keys of the JAX package that the port prints
#: once its cluster plane lands: the cluster section, ``gossip-enabled``,
#: ``membership-enabled`` and ``dax-enabled`` (read once a server builds
#: the planes from the config)
_A7_KEYS = ("node-id", "peers", "replicas",
            "gossip-enabled", "membership-enabled", "dax-enabled")
#: keys of the JAX package's ``Config`` that nothing in either package
#: reads; the port has no field for them, so that setting one does not
#: look as if it took effect (ROADMAP C.16)
_UNREAD_KEYS = {"name", "tracing-enable", "obs-timeline-enabled",
                "dataframe-enable"}


def test_generate_config_is_the_jax_packages_less_the_cluster_sections(
        capsys):
    outs = []
    for r in (J, T):
        assert _package(r).cli.main(["generate-config"]) == 0
        outs.append(capsys.readouterr().out)
    kept = [line for line in outs[0].splitlines()
            if not line.split(" = ")[0].startswith(_A7_KEYS)
            and line.split(" = ")[0] not in _UNREAD_KEYS]
    assert outs[1].splitlines() == kept
    assert len(kept) < len(outs[0].splitlines())


def test_dax_keys_set_from_toml_and_env_take_effect(tmp_path, monkeypatch):
    """``[dax]`` in a TOML file and ``PILOSA_TPU_DAX_*`` variables parse
    alike in both packages. The JAX package has no reader of the section,
    so its fleet takes the values by hand; the port's comes from
    ``DaxCluster.from_config`` alone, and both fleets then behave alike:
    ``sync = "always"`` fsyncs every append, ``segment-bytes`` rotates
    the log, ``snapshot-every`` sets when a computer snapshots, the
    checkin deadline buries a silent computer, the directive retries
    hold, and the autoscaler's ceiling and p99 trigger decide.
    ``dax-enabled`` has no field in the port (nothing reads it;
    ROADMAP C.16)."""
    import dataclasses

    cfg_path = tmp_path / "dax.toml"
    cfg_path.write_text('[dax]\nenabled = true\nsync = "always"\n'
                        'snapshot-every = 4\ndirective-retries = 0\n'
                        'directive-backoff-ms = 7.0\ndead-after-s = 0.5\n'
                        'autoscale-max = 2\nautoscale-cooldown-s = 0.0\n'
                        'autoscale-queue-high = 1000\n')
    env = {"PILOSA_TPU_DAX_SEGMENT_BYTES": "64",
           "PILOSA_TPU_DAX_WARM_HANDOFF": "false",
           "PILOSA_TPU_DAX_AUTOSCALE_P99_HIGH_MS": "5.0",
           "PILOSA_TPU_DAX_ENABLED": "true"}
    schema = [{"name": "f", "options": {}}]
    seen = []
    for r in (J, T):
        P = _package(r)
        cfg = P.Config.from_sources(str(cfg_path), env=env)
        assert (cfg.dax_sync, cfg.dax_snapshot_every,
                cfg.dax_directive_retries, cfg.dax_directive_backoff_ms,
                cfg.dax_dead_after_s, cfg.dax_autoscale_max,
                cfg.dax_autoscale_p99_high_ms, cfg.dax_segment_bytes,
                cfg.dax_warm_handoff) == \
            ("always", 4, 0, 7.0, 0.5, 2, 5.0, 64, False)
        m = lambda name: importlib.import_module(f"{r}.{name}")  # noqa
        clock = m("sched.clock").ManualClock()
        root = str(tmp_path / r)
        if r == T:
            assert "dax_enabled" not in {
                f.name for f in dataclasses.fields(P.Config)}
            cl = m("dax.harness").DaxCluster.from_config(
                1, cfg, shared_dir=root, http=False, autoscale=True,
                clock=clock, device="cpu")
        else:
            assert cfg.dax_enabled is True
            cl = m("dax.harness").DaxCluster(
                1, shared_dir=root, http=False, autoscale=True,
                clock=clock, dead_after_s=cfg.dax_dead_after_s,
                snapshot_every=cfg.dax_snapshot_every, sync=cfg.dax_sync,
                warm_handoff=cfg.dax_warm_handoff,
                autoscale_kw=dict(
                    min_nodes=cfg.dax_autoscale_min,
                    max_nodes=cfg.dax_autoscale_max,
                    cooldown_s=cfg.dax_autoscale_cooldown_s,
                    queue_high=cfg.dax_autoscale_queue_high,
                    p99_high_ms=cfg.dax_autoscale_p99_high_ms))
            cl.controller.directive_retries = cfg.dax_directive_retries
            cl.controller.directive_backoff_s = \
                cfg.dax_directive_backoff_ms / 1e3
            cl.computers[0].wl.segment_bytes = cfg.dax_segment_bytes
        try:
            comp = cl.computers[0]
            cl.controller.create_table("t", {}, fields=schema)
            cl.controller.ensure_shard("t", 0)
            assert ("t", 0) in comp.assigned
            fsyncs = []
            real = os.fsync
            monkeypatch.setattr(os, "fsync",
                                lambda fd: (fsyncs.append(fd), real(fd))[1])
            comp.query_remote("t", "Set(1, f=1)Set(2, f=1)Set(3, f=1)",
                              shards=[0])
            monkeypatch.setattr(os, "fsync", real)
            assert len(fsyncs) >= 3  # sync="always": one per append
            segs = sorted(os.listdir(os.path.join(root, "wl", "t")))
            assert len(segs) >= 2, segs  # 64-byte segments rotate
            snaps = m("dax.storage").Snapshotter(root)
            assert snaps.latest_version("t", 0) == 0
            comp.query_remote("t", "Set(4, f=1)", shards=[0])
            assert snaps.latest_version("t", 0) == 4  # snapshot-every = 4
            ctl = cl.controller
            assert (ctl.directive_retries, ctl.directive_backoff_s) == \
                (0, 0.007)
            sc = cl.autoscaler
            assert (sc.min_nodes, sc.max_nodes, sc.queue_high,
                    sc.p99_high_ms) == (1, 2, 1000, 5.0)
            # the p99 trigger alone scales up to the ceiling, then holds
            sc.probes_fn = lambda: {"queue_depth": 0, "leg_p99_ms": 6.0}
            decisions = [sc.tick(), sc.tick()]
            assert decisions == ["up", None]
            assert len(ctl.live_ids()) == 2
            # the checkin deadline: only the computer that checks in lives
            clock.advance(0.4)
            ctl.checkin(cl.computers[1].node.id)
            clock.advance(0.2)
            dead = ctl.poll()
            assert dead == [comp.node.id]
            seen.append((len(fsyncs), segs, decisions, dead,
                         comp.api.checksum(),
                         cl.computers[1].api.checksum()))
        finally:
            cl.close()
    assert seen[0] == seen[1]


class _Stub:
    """A bare object with the API's surface less every optional plane
    (no tenants, degrade, health, cache, stream or history)."""

    def __init__(self, api):
        self._api = api
        self.holder = api.holder
        self.transactions = api.transactions
        self.idalloc = api.idalloc

    def query(self, index, pql, shards=None):
        return self._api.query(index, pql, shards=shards)

    def query_json(self, *a, **kw):
        return self._api.query_json(*a, **kw)

    def import_bits(self, *a, **kw):
        return self._api.import_bits(*a, **kw)

    def schema(self):
        return self._api.schema()


def _plane_less_routes(base):
    """Status and body of every route that reads an optional plane."""
    out = []
    for method, path, body in [
            ("POST", "/index/t/query", b"Set(3, f=1)"),
            ("POST", "/index/t/query", b"Count(Row(f=1))"),
            ("POST", "/index/t/import",
             json.dumps({"field": "f", "rows": [1, 2],
                         "cols": [5, 9]}).encode()),
            ("POST", "/index/t/query", b"Count(Row(f=1))"),
            ("GET", "/internal/tenants", b""),
            ("GET", "/internal/degrade", b""),
            ("GET", "/internal/stats/timeline", b""),
            ("GET", "/internal/slo", b""),
            ("GET", "/internal/debug/bundles", b""),
            ("GET", "/internal/cache/stats", b""),
            ("POST", "/internal/cache/flush", b""),
            ("GET", "/internal/stats/stream", b""),
            ("GET", "/queries", b""),
            ("GET", "/health", b"")]:
        ctype = "text/plain" if path.endswith("/query") \
            else "application/json"
        status, raw = _req(base, method, path, body, ctype=ctype)
        out.append((method, path, status, json.loads(raw or b"null")))
    return out


@pytest.mark.parametrize("kind", ["computer", "stub"])
def test_handler_serves_an_object_without_the_optional_planes(tmp_path,
                                                              kind):
    """A DAX ``Computer`` (and a bare stub) served through each package's
    ``serve()``: the routes that read the tenant, degradation, health,
    cache, stream and history planes answer alike in both packages (the
    port's handler read them directly and answered 500)."""
    answers = []
    for r in (J, T):
        P = _package(r)
        m = lambda name: importlib.import_module(f"{r}.{name}")  # noqa
        kw = {"device": "cpu"} if r == T else {}
        if kind == "computer":
            obj = m("dax.computer").Computer("c0", str(tmp_path / r), **kw)
            directive = {"version": 1, "method": "full",
                         "schema": [{"index": "t", "options": {},
                                     "fields": [{"name": "f",
                                                 "options": {}}]}],
                         "assigned": [["t", 0]], "hot": []}
        else:
            api = P.API()
            api.create_index("t", {})
            api.create_field("t", "f", {"type": "set"})
            obj = _Stub(api)
        srv, _ = P.serve(obj, port=0, background=True)
        try:
            base = "http://%s:%d" % srv.server_address[:2]
            got = []
            if kind == "computer":
                status, raw = _req(base, "POST", "/directive",
                                   json.dumps(directive).encode(),
                                   ctype="application/json")
                got.append(("POST", "/directive", status, json.loads(raw)))
            got += _plane_less_routes(base)
            answers.append(got)
        finally:
            srv.shutdown()
            srv.server_close()
    assert answers[0] == answers[1]
    queries = [(s, b) for _m, p, s, b in answers[1] if p == "/index/t/query"]
    if kind == "stub":
        assert [b["results"] for _s, b in queries] == [[True], [1], [2]]
    else:
        # a Computer has no ``query_json``: in both packages the PQL
        # route answers 500 with the same body (ROADMAP C)
        assert {(s, b["error"]) for s, b in queries} == {
            (500, "AttributeError: 'Computer' object has no attribute "
                  "'query_json'")}
    assert all(s == 200 for _m, p, s, _b in answers[1]
               if p != "/index/t/query"), answers[1]
