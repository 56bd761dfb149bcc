"""The front-end slice: both packages' HTTP servers side by side.

The JAX package's ``serve(API())`` and the port's ``serve(API(device=
"cpu"))`` take one battery of requests each: schema calls, the three
import routes, the dataframe routes, PQL reads and writes, SQL (with
``COPY ... WITH URL`` into a second server of the same package), framed
gRPC, transactions, idalloc, the cache admin routes, the observability
routes, the stream push route's 429, auth's 401 / 403, an unknown route
and the cluster-only routes. The status codes, the JSON bodies and the
``Retry-After``, ``grpc-status``, ``grpc-message``, ``Content-Type`` and
``Set-Cookie`` headers must be equal; only the fields named in
``_TIMING`` (clocks and durations), ``_HOST`` (what the host process
or its device reports: thread stacks, RSS, device names, metric texts)
and ``_RANDOM_IDS`` (random request and trace ids) are masked. Each
package's global tracer is a fresh one with a trace store for the
battery, so ``/internal/traces`` lists this battery's traces alone,
whatever earlier tests in the process left installed. The CLI's ``main([...])`` runs against each server with
equal outputs.

Then the port alone: ``python -m pilosa_tpu_torch server --device cpu``
as a subprocess, SIGKILLed and restarted on its data directory, with
every acknowledged write read back; 16 concurrent clients whose answers
equal the serial ones; and one TTL sweep over a resident time field,
after which ``BUDGET.used`` and the resident-bytes gauges have fallen.
"""

import base64
import contextlib
import datetime as dt
import importlib
import io
import json
import os
import select
import signal
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
J, T = "pilosa_tpu", "pilosa_tpu_torch"


def _load(root: str) -> types.SimpleNamespace:
    m = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    api_cls = m("api").API
    make_api = api_cls if root == J else (
        lambda *a, **kw: api_cls(*a, device="cpu", **kw))
    return types.SimpleNamespace(
        root=root, API=make_api, serve=m("server").serve,
        auth=m("server.auth"), proto=m("server.proto"),
        grpc=m("server.grpc"), maintenance=m("server.maintenance"),
        cli=m("ctl.cli"), Shell=m("ctl.fbsql").Shell,
        encode_positions=m("storage.roaring").encode_positions,
        M=m("obs.metrics"), tracing=m("obs.tracing"))


_PACKAGES = {}


def _package(root):
    if root not in _PACKAGES:
        _PACKAGES[root] = _load(root)
    return _PACKAGES[root]


@contextlib.contextmanager
def _served(P, api, **kw):
    srv, _ = P.serve(api, port=0, background=True, **kw)
    host, port = srv.server_address[:2]
    try:
        yield f"http://{host}:{port}"
    finally:
        srv.shutdown()
        srv.server_close()


#: clocks and durations: equal in kind, not in value
_TIMING = {"execution-time", "duration_ns", "duration_ms", "start_ns",
           "end_ns", "started", "finished", "deadline", "t", "ts",
           "uptime_s", "window_start", "window_end", "last_sample",
           "start", "end", "age_s", "seconds", "time", "startTime",
           "runtimeNs"}
#: what the host process or its device reports
_HOST = {"devices"}
#: identifiers drawn at random per request or per trace
_RANDOM_IDS = {"requestID", "request_id", "traceID"}

#: routes whose bodies follow the wall clock or the host process, with
#: the reason; only their status, headers and top-level keys compare
_SHAPE_ONLY = {
    "/internal/stats/timeline": "the sampler ticks on the wall clock",
    "/internal/stats/cluster": "the sampler ticks on the wall clock",
    "/internal/slo": "burn rates follow each request's wall-clock latency",
    "/internal/debug/bundles": "bundles fire on wall-clock SLO burns",
    "/metrics": "each package's registry holds its own series",
    "/metrics.json": "each package's registry holds its own series",
    "/debug/pprof": "thread stacks of the serving process",
    "/internal/mem-usage": "the process's RSS",
    "/cpu-profile/stop": "the profiled functions are each package's own",
}

_SENT_HEADERS = ("Retry-After", "grpc-status", "grpc-message",
                 "Content-Type", "Location")


def _mask(v, path=()):
    if isinstance(v, dict):
        return {k: ("<masked>" if k in _TIMING or k in _HOST
                    or k in _RANDOM_IDS
                    else _mask(x, path + (k,))) for k, x in v.items()}
    if isinstance(v, list):
        return [_mask(x, path) for x in v]
    return v


def _cookie_names(headers):
    """Set-Cookie headers with the random state value masked."""
    out = []
    for c in headers.get_all("Set-Cookie") or []:
        name, _, rest = c.partition("=")
        value, _, attrs = rest.partition(";")
        if name == "molecula-chip-state" and value:
            value = "<state>"
        out.append(f"{name}={value};{attrs}")
    return out


def _call(base, method, path, body=None, ctype="application/json",
          token=None, raw=False):
    data = body if body is None or isinstance(body, bytes) \
        else json.dumps(body).encode()
    r = urllib.request.Request(base + path, data=data, method=method)
    r.add_header("Content-Type", ctype)
    if token:
        r.add_header("Authorization", "Bearer " + token)
    try:
        resp = urllib.request.urlopen(r)
        code = resp.status
    except urllib.error.HTTPError as e:
        resp, code = e, e.code
    payload = resp.read()
    headers = {h: resp.headers.get(h) for h in _SENT_HEADERS}
    headers["Set-Cookie"] = _cookie_names(resp.headers)
    if raw:
        return code, payload, headers
    try:
        payload = json.loads(payload)
    except ValueError:
        payload = f"<{len(payload)} bytes>"
    return code, payload, headers


def _grpc_decoded(P, method, payload):
    """A framed gRPC answer's messages decoded, durations dropped."""
    msgs = P.grpc.unframe(payload)
    if method.endswith("Unary"):
        return [list(P.proto.decode_table_response(m)) for m in msgs]
    if method in ("QuerySQL", "QueryPQL", "Inspect"):
        return [list(P.proto.decode_row_response(m)) for m in msgs]
    return [base64.b64encode(m).decode() for m in msgs]


_GRPC = [
    ("QueryPQLUnary", lambda p: p._str_field(1, "b")
     + p._str_field(2, "Count(Row(f=1))")),
    ("QueryPQL", lambda p: p._str_field(1, "b")
     + p._str_field(2, "TopN(f, n=3)")),
    ("QuerySQLUnary", lambda p: p._str_field(
        1, "select _id, v from metros order by _id")),
    ("QuerySQL", lambda p: p._str_field(1, "select count(*) from metros")),
    ("GetIndexes", lambda p: b""),
    ("GetIndex", lambda p: p._str_field(1, "b")),
    ("GetIndex", lambda p: p._str_field(1, "nope")),
    ("Inspect", lambda p: p._str_field(1, "b") + p._str_field(3, "n")),
    ("CreateIndex", lambda p: p._str_field(1, "g1")),
    ("DeleteIndex", lambda p: p._str_field(1, "g1")),
    ("Nope", lambda p: b""),
]

#: the routes a single node answers with the JAX package's 404
_CLUSTER_ONLY = [
    ("POST", "/internal/index/b/query", {"query": "Count(All())"}),
    ("POST", "/internal/query-batch", {"queries": []}),
    ("POST", "/internal/cluster/message", {}),
    ("POST", "/internal/sql/subtree", {"spec": {}}),
    ("POST", "/internal/translate/replicate", {"index": "b"}),
    ("GET", "/internal/partition/nodes?partition=3", None),
    ("POST", "/internal/gossip/exchange", {}),
    ("GET", "/internal/gossip/state", None),
    ("POST", "/internal/membership/ping", {}),
    ("GET", "/internal/membership", None),
    ("GET", "/internal/recovery/snapshot?index=b&shard=0", None),
    ("GET", "/internal/recovery/wal?index=b&since=0", None),
    ("POST", "/directive", {}),
]


def _battery(P, base, copy_to):
    """One package's answers to the whole battery, in order."""
    out = []

    def rec(method, path, body=None, ctype="application/json", **kw):
        code, payload, headers = _call(base, method, path, body, ctype, **kw)
        shown = _mask(payload)
        if path == "/internal/traces" and code == 200:
            # departure C.10: the port's failed request's root span
            # keeps its error as an ``error`` tag
            for t in shown["traces"]:
                t["tags"].pop("error", None)
        if path.split("?")[0] in _SHAPE_ONLY and code == 200:
            shown = sorted(payload) if isinstance(payload, dict) \
                else type(payload).__name__
        out.append((method, path, code, shown, headers))
        return payload

    sw = 1 << 20
    # schema
    rec("POST", "/index/b", {"options": {}})
    rec("POST", "/index/b/field/f")
    rec("POST", "/index/b/field/m", {"options": {"type": "mutex"}})
    rec("POST", "/index/b/field/n", {"options": {"type": "int"}})
    rec("POST", "/index/b/field/t", {"options": {"type": "time",
                                                "timeQuantum": "YMD"}})
    rec("POST", "/index/k", {"options": {"keys": True}})
    rec("POST", "/index/k/field/g", {"options": {"keys": True}})
    rec("POST", "/index/b", {"options": {}})  # exists
    rec("POST", "/index/nope/field/x")
    # the three import routes
    rec("POST", "/index/b/import", {"field": "f", "rows": [1, 1, 2, 3],
                                    "cols": [1, sw + 2, 5, 9]})
    rec("POST", "/index/b/import", {"field": "m", "rows": [3, 5],
                                    "cols": [10, 10]})
    rec("POST", "/index/b/import", {"field": "n", "rows": [0],
                                    "cols": [1]})
    rec("POST", "/index/b/import", {})
    rec("POST", "/index/b/import-values", {"field": "n", "cols": [1, 5, 9],
                                           "values": [100, -3, 7]})
    rec("POST", "/index/b/import-values", {"field": "n", "cols": [1],
                                           "values": [1, 2]})
    blob = base64.b64encode(P.encode_positions(np.array(
        [4 * sw + 11, 4 * sw + 12, 6 * sw + 13], dtype=np.uint64))).decode()
    rec("POST", "/index/b/shard/0/import-roaring",
        {"field": "f", "views": {"standard": blob}})
    rec("POST", "/index/b/shard/0/import-roaring",
        {"field": "f", "views": {"standard": "AAAA"}})
    rec("POST", "/index/k/import", {"field": "g", "rowKeys": ["x", "y"],
                                    "colKeys": ["a", "b"]})
    # PQL reads and writes
    for q in ["Set(2, f=1)Set(20, t=4, 2020-01-02T03:04)Clear(9, f=3)",
              "Count(Row(f=1))", "Row(f=1)", "TopN(f, n=5)",
              "GroupBy(Rows(f), Rows(m))", "Sum(field=n)", "Min(field=n)",
              "Max(field=n)", "Rows(f)", "Count(Row(n > 0))",
              "Row(t=4, from='2020-01-01T00:00', to='2020-02-01T00:00')",
              "Count(Union(Row(f=1), Row(f=4)))", "Row(f=", "Nope(f=1)"]:
        rec("POST", "/index/b/query", q.encode(), ctype="text/plain")
    rec("POST", "/index/b/query", {"query": "Count(All())"})
    rec("POST", "/index/k/query", {"query": 'Row(g="x")'})
    rec("POST", "/index/nope/query", {"query": "Count(All())"})
    rec("POST", "/index/b/query?priority=batch&timeout_ms=10000",
        b"Count(Row(f=1))", ctype="text/plain")
    rec("GET", "/index/b/mutex-check")
    # dataframe
    rec("POST", "/index/b/dataframe/0", {"shard_ids": [1, 5],
                                         "columns": {"fare": [1.5, 2.5]}})
    rec("GET", "/index/b/dataframe/0")
    rec("GET", "/index/b/dataframe")
    rec("POST", "/index/b/query", b'Apply("sum(fare)")', ctype="text/plain")
    rec("POST", "/index/b/dataframe/0", {"shard_ids": [1]})
    # SQL
    for q in ["CREATE TABLE metros (_id ID, name STRING, v INT)",
              "INSERT INTO metros (_id, name, v) VALUES (1, 'nyc', 8), "
              "(2, 'sf', 3)",
              "SELECT _id, name, v FROM metros WHERE v > 4",
              "SELECT COUNT(*) FROM metros", "SHOW TABLES",
              "SHOW COLUMNS FROM metros", "SELEC nonsense",
              "SELECT nosuch FROM metros",
              f"COPY metros TO metros2 WITH URL '{copy_to}'"]:
        rec("POST", "/sql", q.encode(), ctype="text/plain")
    # framed gRPC
    for method, msg in _GRPC:
        code, payload, headers = _call(
            base, "POST", f"/grpc/pilosa.Pilosa/{method}",
            P.grpc.frame(msg(P.proto)), ctype="application/grpc", raw=True)
        out.append(("POST", f"grpc {method}", code,
                    _grpc_decoded(P, method, payload) if code == 200
                    else None, headers))
    # transactions, idalloc
    rec("POST", "/transaction", {"id": "tx1", "timeout": 30})
    rec("POST", "/transaction", {"id": "tx1"})
    rec("GET", "/transaction/tx1")
    rec("GET", "/transactions")
    rec("POST", "/transaction/tx1/finish")
    rec("GET", "/transaction/nope")
    rec("POST", "/internal/idalloc/reserve", {"session": "s", "count": 10})
    rec("POST", "/internal/idalloc/commit", {"session": "s", "count": 4})
    rec("POST", "/internal/idalloc/reserve", {"session": "s2", "count": 5})
    rec("POST", "/internal/idalloc/reserve", {"count": 5})
    # translate
    rec("POST", "/internal/translate/index/k/keys/find", {"keys": ["a"]})
    rec("POST", "/internal/translate/index/k/keys/create",
        {"keys": ["c"]})
    rec("POST", "/internal/translate/index/k/ids", {"ids": [1, 2, 3]})
    rec("POST", "/internal/translate/field/k/g/keys/find", {"keys": ["y"]})
    rec("POST", "/internal/translate/field/k/g/ids", {"ids": [1]})
    rec("POST", "/internal/translate/field/k/g/keys/like", {"like": "%"})
    rec("POST", "/internal/translate/index/b/keys/find", {"keys": ["a"]})
    # the cache admin routes
    rec("POST", "/index/b/query", b"Count(Row(f=1))", ctype="text/plain")
    rec("GET", "/internal/cache/stats")
    rec("POST", "/internal/cache/flush")
    # observability
    for path in ["/internal/stats/timeline", "/internal/stats/timeline?"
                 "window=x", "/internal/stats/cluster",
                 "/internal/slo", "/internal/debug/bundles",
                 "/internal/debug/bundles/nope", "/internal/stats/kernels",
                 "/internal/analysis/locks", "/internal/traces",
                 "/internal/traces/nope", "/internal/tenants",
                 "/internal/degrade", "/internal/stats/stream",
                 "/query-history?n=x", "/queries", "/metrics",
                 "/metrics.json", "/debug/pprof", "/internal/mem-usage",
                 "/disk-usage", "/disk-usage/b", "/disk-usage/nope"]:
        rec("GET", path)
    hist = rec("GET", "/query-history?n=3")
    out.append(("history", [(h["query"], h.get("status")) for h in hist]))
    # the stream push route: accepted, then 429 past its backlog
    rec("POST", "/index/st/stream/push", {"records": [{"id": 1}]})
    rec("POST", "/index/st/stream/push",
        {"records": [{"id": i} for i in range(2, 6)]})
    rec("POST", "/index/st/stream/push", {"records": [{"id": 9}]})
    rec("POST", "/index/b/stream/push", {"records": []})
    # the rest of the single-node surface
    for path in ["/schema", "/status", "/version", "/health", "/info",
                 "/schema/details", "/internal/nodes", "/internal/shards/max",
                 "/internal/index/b/shards", "/ui/shard-distribution",
                 "/internal/chksum", "/internal/oauth-config", "/userinfo",
                 "/login", "/internal/index/b/shard/0/snapshot",
                 "/internal/index/b/shard/7/snapshot"]:
        rec("GET", path)
    rec("POST", "/recalculate-caches")
    rec("POST", "/cpu-profile/stop")
    rec("POST", "/cpu-profile/start")
    rec("POST", "/cpu-profile/start")
    rec("POST", "/cpu-profile/stop")
    rec("GET", "/not-a-route")
    rec("DELETE", "/no/such/route")
    for method, path, body in _CLUSTER_ONLY:
        rec(method, path, body)
    # backup, restore, deletes
    code, tar, headers = _call(base, "GET", "/internal/backup.tar", raw=True)
    out.append(("GET", "/internal/backup.tar", code, headers))
    rec("DELETE", "/index/b/dataframe")
    rec("DELETE", "/index/b/field/t")
    rec("DELETE", "/index/b/field/t")
    rec("POST", "/internal/restore", tar, ctype="application/x-gtar")
    rec("GET", "/internal/chksum")
    rec("DELETE", "/index/k")
    rec("GET", "/schema")
    return out


def _api(P, copy_target):
    api = P.API()
    api.enable_cache()
    api.enable_health()
    api.enable_stream("st", batch_rows=2, max_backlog_rows=4)
    return api


def test_request_battery_equal_across_packages():
    answers, copied = {}, {}
    for root in (J, T):
        P = _package(root)
        target = P.API()
        before = P.tracing.get_tracer()
        P.tracing.set_tracer(P.tracing.Tracer.from_config(None, enabled=True))
        try:
            with _served(P, target) as copy_to, \
                    _served(P, _api(P, copy_to)) as base:
                answers[root] = _battery(P, base, copy_to)
        finally:
            P.tracing.set_tracer(before)
        copied[root] = target.sql("select _id, name, v from metros2 "
                                  "order by _id").data
    assert copied[J] == copied[T] == [[1, "nyc", 8], [2, "sf", 3]]
    assert len(answers[J]) == len(answers[T])
    for a, b in zip(answers[J], answers[T]):
        assert a == b, f"\njax:   {a}\ntorch: {b}"


def test_auth_codes_equal_across_packages():
    secret = "s3"
    codes = {}
    for root in (J, T):
        P = _package(root)
        api = P.API()
        api.create_index("t")
        api.create_field("t", "f")
        perms = P.auth.parse_permissions(
            'user-groups:\n  "r":\n    "t": "read"\n  "w":\n    "t": "write"\n'
            'admin: "a"\n')
        tok = {g: P.auth.issue_token(secret, [g]) for g in ("r", "w", "a")}
        tok["expired"] = P.auth.issue_token(secret, ["a"], ttl_s=-5)
        tok["forged"] = P.auth.issue_token("other", ["a"])
        got = []
        with _served(P, api, auth=P.auth.Auth(secret, perms)) as base:
            for who in (None, "r", "w", "a", "expired", "forged"):
                t = tok.get(who)
                for method, path, body in [
                        ("POST", "/index/t/query", b"Count(Row(f=1))"),
                        ("POST", "/index/t/query", b"Set(1, f=1)"),
                        ("POST", "/index/t/import", json.dumps(
                            {"field": "f", "rows": [1], "cols": [3]}).encode()),
                        ("POST", "/index/u", b"{}"),
                        ("GET", "/schema", None), ("GET", "/version", None),
                        ("GET", "/internal/chksum", None),
                        ("POST", "/internal/index/t/query", b"{}"),
                        ("POST", "/sql", b"select count(*) from t"),
                        ("POST", "/sql", b"drop table u"),
                        ("POST", "/grpc/pilosa.Pilosa/QueryPQLUnary",
                         P.grpc.frame(P.proto._str_field(1, "t")
                                      + P.proto._str_field(2, "Set(2, f=1)")))]:
                    ctype = ("text/plain" if path in ("/index/t/query",
                                                      "/sql")
                             else "application/json")
                    code, payload, headers = _call(base, method, path, body,
                                                   ctype, token=t)
                    got.append((who, method, path, code, _mask(payload),
                                headers["grpc-status"]))
        codes[root] = got
    assert codes[J] == codes[T]
    seen = {(who, path, code) for who, _, path, code, _, _ in codes[T]}
    assert {(None, "/index/t/query", 401), ("r", "/index/t/query", 403),
            ("a", "/index/t/query", 200), ("expired", "/schema", 401),
            ("w", "/index/u", 403), ("a", "/internal/index/t/query", 404),
            (None, "/version", 200)} <= seen


def _strip_time(text):
    return "\n".join(line for line in text.splitlines()
                     if not line.startswith("Time:"))


def test_cli_outputs_equal_across_packages(tmp_path, capsys):
    outs = {}
    for root in (J, T):
        P = _package(root)
        api = P.API()
        api.create_index("ie")
        api.create_field("ie", "f")
        api.create_field("ie", "v", {"type": "int"})
        d = tmp_path / root
        d.mkdir()
        (d / "in.csv").write_text("1,10\n1,11\n2,10\n7,1048577\n")
        (d / "vals.csv").write_text("10,50\n11,-3\n")
        got = []
        with _served(P, api) as host:
            for argv in (
                    ["import", "--host", host, "--index", "ie", "--field",
                     "f", str(d / "in.csv")],
                    ["import", "--host", host, "--index", "ie", "--field",
                     "v", "--field-type", "int", str(d / "vals.csv")],
                    ["export", "--host", host, "--index", "ie",
                     "--field", "f"],
                    ["chksum", "--host", host],
                    ["backup", "--host", host, "--output",
                     str(d / "b.tar")]):
                rc = P.cli.main(argv)
                cap = capsys.readouterr()
                got.append((argv[0], rc, cap.out,
                            cap.err.replace(str(d), "<dir>")
                            .replace(host, "<host>")))
            stdin = io.StringIO("select count(*) from ie\n\\dt\n"
                                "\\d ie\n\\timing\nselect _id from ie\n"
                                "\\!pql ie Count(Row(f=1))\nbogus\n\\q\n")
            sh = io.StringIO()
            assert P.Shell(host=host, stdin=stdin, stdout=sh).run() == 0
            got.append(("fbsql", _strip_time(sh.getvalue())))
        outs[root] = got
    assert outs[J] == outs[T]
    assert sorted(outs[T][2][2].splitlines()) == ["1,10", "1,11", "2,10",
                                                  "7,1048577"]
    # a backup of either package restores into the other's server
    for src, dst in ((J, T), (T, J)):
        P = _package(dst)
        api = P.API()
        with _served(P, api) as host:
            assert P.cli.main(["restore", "--host", host, "--source",
                               str(tmp_path / src / "b.tar")]) == 0
            capsys.readouterr()
            assert P.cli.main(["chksum", "--host", host]) == 0
        assert capsys.readouterr().out == outs[src][3][2]


# ---------------------------------------------------------------------------
# The port alone
# ---------------------------------------------------------------------------


class _ServerProcess:
    """``python -m pilosa_tpu_torch server --device cpu`` on a port of
    its own choosing, read from its first line."""

    def __init__(self, data_dir):
        env = dict(os.environ, PYTHONPATH=ROOT)
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "pilosa_tpu_torch", "server",
             "--device", "cpu", "--port", "0", "--data-dir", str(data_dir)],
            cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True)
        deadline = time.monotonic() + 120
        line = ""
        while "serving on" not in line:
            left = deadline - time.monotonic()
            ready, _, _ = select.select([self.proc.stderr], [], [],
                                        max(left, 0))
            if not ready or self.proc.poll() is not None:
                self.kill()
                raise AssertionError(f"server did not start: {line!r}")
            line = self.proc.stderr.readline()
        addr = line.split("serving on ")[1].split(" ")[0]
        self.base = f"http://{addr}"

    def kill(self):
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGKILL)
        self.proc.wait(timeout=30)
        self.proc.stderr.close()


def test_server_process_survives_sigkill(tmp_path):
    data = tmp_path / "data"
    s = _ServerProcess(data)
    try:
        info = _call(s.base, "GET", "/info")[1]
        assert info["devices"] == ["cpu"]
        _call(s.base, "POST", "/index/i")
        _call(s.base, "POST", "/index/i/field/f")
        _call(s.base, "POST", "/index/i/field/v", {"options": {"type": "int"}})
        acked = []
        for k in range(20):
            code, out, _ = _call(s.base, "POST", "/index/i/query",
                                 f"Set({k * 50_000}, f={k % 3})".encode(),
                                 ctype="text/plain")
            assert code == 200 and out == {"results": [True]}
            acked.append((k * 50_000, k % 3))
        code, out, _ = _call(s.base, "POST", "/index/i/import-values",
                             {"field": "v", "cols": [1, 2, 3],
                              "values": [5, -6, 7]})
        assert code == 200
        want = {r: _call(s.base, "POST", "/index/i/query",
                         f"Row(f={r})".encode(), ctype="text/plain")[1]
                for r in range(3)}
        want_sum = _call(s.base, "GET", "/internal/chksum")[1]
    finally:
        s.kill()
    assert s.proc.returncode == -signal.SIGKILL
    s = _ServerProcess(data)
    try:
        for r in range(3):
            got = _call(s.base, "POST", "/index/i/query",
                        f"Row(f={r})".encode(), ctype="text/plain")[1]
            assert got == want[r]
            assert got["results"][0]["columns"] == sorted(
                c for c, row in acked if row == r)
        assert _call(s.base, "POST", "/index/i/query", b"Sum(field=v)",
                     ctype="text/plain")[1] == \
            {"results": [{"value": 6, "count": 3}]}
        assert _call(s.base, "GET", "/internal/chksum")[1] == want_sum
    finally:
        s.kill()


def test_concurrent_clients_get_the_serial_answers():
    P = _package(T)
    api = P.API()
    api.create_index("c")
    api.create_field("c", "f")
    api.create_field("c", "g")
    api.create_field("c", "n", {"type": "int"})
    rng = np.random.default_rng(16)
    cols = rng.choice(3 << 20, 20_000, replace=False)
    api.import_bits("c", "f", rows=rng.integers(0, 20, cols.size), cols=cols)
    api.import_bits("c", "g", rows=rng.integers(0, 5, cols.size), cols=cols)
    api.import_values("c", "n", cols=cols,
                      values=rng.integers(-1000, 1000, cols.size))
    queries = ([f"Count(Intersect(Row(f={i}), Row(g={i % 5})))"
                for i in range(20)]
               + ["TopN(f, n=5)", "GroupBy(Rows(f), Rows(g), limit=30)",
                  "Sum(Row(n > 100), field=n)", "Count(Row(n < -500))",
                  "Min(field=n)", "Max(field=n)"])
    with _served(P, api) as base:
        serial = {q: _call(base, "POST", "/index/c/query", q.encode(),
                           ctype="text/plain")[1] for q in queries}
        got, errors = [], []

        def client(k):
            try:
                order = np.random.default_rng(k).permutation(len(queries))
                for i in order:
                    q = queries[int(i)]
                    got.append((q, _call(base, "POST", "/index/c/query",
                                         q.encode(), ctype="text/plain")[1]))
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(e)

        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            threads = [threading.Thread(target=client, args=(k,))
                       for k in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
        finally:
            sys.setswitchinterval(old)
        assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(got) == 16 * len(queries)
    for q, answer in got:
        assert answer == serial[q], q


def test_ttl_sweep_releases_the_stacks(monkeypatch):
    """One sweep over a resident time field with a TTL: the same views
    go in both packages, and the port's stacks leave the card's budget
    (``BUDGET.used`` and the resident-bytes gauges fall)."""
    from pilosa_tpu_torch.core import stacked as STK

    now = dt.datetime(2024, 6, 1)
    removed = {}
    for root in (J, T):
        P = _package(root)
        api = P.API()
        api.create_index("tt")
        api.create_field("tt", "ev", {"type": "time", "timeQuantum": "YMD",
                                      "ttl": 30 * 86400})
        api.query("tt", "Set(1, ev=1, 2024-01-05T00:00)"
                        "Set(2, ev=1, 2024-05-30T00:00)"
                        "Set(3, ev=2, 2023-12-31T00:00)")
        q = ("Count(Row(ev=1, from='2024-01-01T00:00', "
             "to='2024-06-01T00:00'))")
        assert api.query("tt", q) == [2]
        if root == T:
            used0 = STK.BUDGET.used
            api.query("tt", "TopN(ev, n=2, from='2023-12-01T00:00', "
                            "to='2024-06-01T00:00')")
            used1 = STK.BUDGET.used
            assert used1 > used0
            gauge1 = _resident_gauge(P)
        removed[root] = P.maintenance.remove_expired_views(
            api.holder, now=now)
        assert api.query("tt", q) == [1]
        if root == T:
            assert STK.BUDGET.used < used1
            assert _resident_gauge(P) < gauge1
            assert _resident_gauge(P) == STK.BUDGET.used
    assert removed[J] == removed[T] and removed[T]


def _resident_gauge(P):
    gauges = P.M.REGISTRY.snapshot()["gauges"]
    hbm = gauges[P.M.METRIC_DEVICE_HBM_RESIDENT_BYTES]
    assert gauges[P.M.METRIC_DEVICE_BUDGET_RESIDENT_BYTES] == hbm
    return hbm
