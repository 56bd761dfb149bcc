"""The port stands alone: it never imports JAX or the JAX package.

Checked two ways: a subprocess with a clean environment imports
``pilosa_tpu_torch``, answers a query and a write on the CPU, serves
reads through the result cache, the scheduler and ``execute_many``,
writes to a data directory, recovers it and backs it up, loads a CSV
through the ``Ingester``, drains a broker through the
``PipelinedIngester`` and a pushed stream through ``enable_stream``
(importing every ingest and stream module), loads SSB through
``API.sql`` under a query log and answers a star join and the history
table (importing every SQL module), profiles a query under the device
profiler and the health plane (importing every observability module),
serves the API over HTTP and drives it through the client, framed gRPC,
the CLI and fbsql (importing every front-end module), runs a keyed
two-node ``LocalCluster`` on the CPU (importing every cluster module)
and a SQL aggregate over a host filter through it (the SQL fan-out),
a two-node cluster with a seeded ``FaultPlan``, leg batching and
hedged legs (fan-out resilience), a two-node cluster with gossip,
membership and a replica's catch-up (importing every gossip module),
a tenant's query and an open-loop virtual run under the tenant plane and
the degradation ladder (importing the tenant, ladder and load generator
modules), a two-computer DAX fleet with a kill, a replay into a fresh
computer and an autoscaler tick (importing every DAX module), then
reports
what ``sys.modules`` holds (this test process cannot tell:
tests/conftest.py loads JAX in every worker); and an AST scan of every
module of the port and of ``chip_smoke.py``. The port also refuses to
fall back to the CPU by itself: ``python -m pilosa_tpu_torch server``
without a card and without ``--device cpu`` exits non-zero and serves
nothing.
"""

import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_FORBIDDEN = ("jax", "pilosa_tpu")

_PROBE = r"""
import json, sys
import numpy as np
import pilosa_tpu_torch
from pilosa_tpu_torch.api import API

api = API(device="cpu")
api.create_index("i")
api.create_field("i", "f", {"type": "mutex", "keys": True})
api.import_bits("i", "f", cols=np.arange(600), row_keys=["a", "b"] * 300)
got = api.query("i", 'Count(Intersect(Row(f="a"), All()))TopN(f, n=1)')
wrote = api.query("i", 'Set(600, f="c")Clear(1, f="b")Count(Row(f="c"))')
import pilosa_tpu_torch.analysis.locktrace, pilosa_tpu_torch.config
import pilosa_tpu_torch.obs.tenants
from pilosa_tpu_torch.obs import devprof
devprof.enable()
hp = api.enable_health(interval_ms=1.0)
profiled = [api.query("i", 'Count(Row(f="a"))')[0],
            len(devprof.stats_json()["kernels"]), len(hp.timeline)]
api.disable_health()
devprof.disable()
api.enable_cache()
api.enable_scheduler(window_ms=0.0)
served = api.query("i", 'Count(Row(f="a"))') + api.query("i", 'Count(Row(f="a"))')
fused = api.executor.execute_many("i", ['Count(Row(f="a"))', "Row(f=1)"],
                                  per_query_shards=[[0], [0]])
api.disable_scheduler()
import io, tempfile
d = tempfile.mkdtemp()
dur = API(d, device="cpu")
dur.create_index("i")
dur.create_field("i", "f")
dur.query("i", "Set(3, f=1)")
dur.save()
dur.import_bits("i", "f", rows=[1], cols=[4])
want = dur.checksum()
dur.backup_tar(io.BytesIO())
import pilosa_tpu_torch.transaction
import pilosa_tpu_torch.storage.roaring
del dur
recovered = API(d, device="cpu").checksum() == want
from pilosa_tpu_torch.ingest import CSVSource, Ingester
from pilosa_tpu_torch.ingest.datagen import scenario
from pilosa_tpu_torch.ingest.kafka import KafkaSource
from pilosa_tpu_torch.ingest.sources_ext import AvroSource, SQLSource
from pilosa_tpu_torch.stream import PipelinedIngester, StreamBroker, make_chunk
ing = API(device="cpu")
loaded = Ingester(ing, "c", CSVSource("id,city__IS\n1,7\n2,7\n",
                                      inline=True)).run()
broker = StreamBroker()
broker.produce("t", make_chunk({"id": [3, 4, 5], "city": [7, 8, 7]}))
src = scenario("bank", rows=4)
piped = PipelinedIngester(ing, "c", broker.consumer("g", ["t"])).run()
sd = tempfile.mkdtemp()
sapi = API(sd, device="cpu")
svc = sapi.enable_stream("s", batch_rows=2)
svc.push([{"id": i} for i in range(5)])
streamed = svc.step()
sapi.disable_stream()
import os
from pilosa_tpu_torch.loadgen import ssb
sq = API(device="cpu")
sq.set_query_logger(os.path.join(tempfile.mkdtemp(), "q.log"))
data = ssb.generate("tiny", seed=7)
ssb.load(sq.sql, data)
star = ssb.verify(data, "Q2.1", sq.sql(ssb.QUERIES["Q2.1"]).data)
hist = sq.sql("select language, status from fb_exec_requests limit 1").data
logged = len(sq.query_logger.tail(1000))
import contextlib
from pilosa_tpu_torch.client import Client
from pilosa_tpu_torch.ctl import main as ctl_main
from pilosa_tpu_torch.ctl.fbsql import Shell
from pilosa_tpu_torch.server import serve
from pilosa_tpu_torch.server import grpc as G, proto as PR
from pilosa_tpu_torch.server.maintenance import remove_expired_views
import pilosa_tpu_torch.server.oidc, pilosa_tpu_torch.__main__
srv, _ = serve(sq, port=0, background=True)
base = "http://127.0.0.1:%d" % srv.server_address[1]
front = [Client(base).query("Count(All())", index="lineorder")[0],
         len(remove_expired_views(sq.holder))]
with contextlib.redirect_stdout(io.StringIO()) as out:
    ctl_main(["chksum", "--host", base])
    Shell(host=base, stdin=io.StringIO("select count(*) from ssb_date\n"),
          stdout=sys.stdout).run()
front.append(out.getvalue().split()[0] == sq.checksum())
framed = Client(base)._request(
    "POST", "/grpc/pilosa.Pilosa/QuerySQLUnary",
    G.frame(PR._str_field(1, "select count(*) from ssb_date")),
    "application/grpc")
front.append(PR.decode_table_response(G.unframe(framed)[0])[1]
             == sq.sql("select count(*) from ssb_date").data)
srv.shutdown()
srv.server_close()
from pilosa_tpu_torch.cluster import LocalCluster
import pilosa_tpu_torch.hashing
with LocalCluster(2, device="cpu") as lc:
    lc.coordinator.create_index("k", {"keys": True})
    lc.coordinator.create_field("k", "f", {"keys": True})
    lc[1].import_bits("k", "f", row_keys=["a", "b", "a"],
                      col_keys=["x", "y", "z"])
    clustered = [lc[0].query("k", 'Count(Row(f="a"))')[0],
                 lc[1].query("k", "TopN(f, n=1)")[0].pairs[0].key]
    lc[1].sql("create table ft (_id id, v int)")
    lc[1].sql("insert into ft values (1, 5), (2097153, 6), (3, 7)")
    clustered.append(lc[0].sql(
        "select sum(v) from ft where v % 2 = 1").data)
from pilosa_tpu_torch.cluster import FaultPlan
plan = FaultPlan(seed=1)
with LocalCluster(2, device="cpu", fault_plan=plan,
                  cluster_batch={}) as lc:
    lc[0].create_index("rs")
    lc[0].create_field("rs", "f")
    lc[0].import_bits("rs", "f", rows=[1, 1, 2], cols=[1, 2097153, 3])
    lc[0].enable_resilience()
    plan.delay("node1", 0.0)
    resilient = [lc[0].query("rs", "Count(Row(f=1))")[0],
                 lc[0].client.op_counts.get("query_batch", 0) > 0,
                 plan.seen("node1") > 0]
with LocalCluster(2, replica_n=2, base_path=tempfile.mkdtemp(),
                  device="cpu") as lc:
    lc[0].create_index("g")
    lc[0].create_field("g", "f")
    lc[0].import_bits("g", "f", rows=[1, 1], cols=[1, 2])
    lc.enable_gossip()
    lc.enable_membership()
    rm = lc[1].enable_recovery()
    lc[0].api.import_bits("g", "f", rows=[1], cols=[3])
    lc[0]._announce_shards("g")
    lc.run_gossip_rounds(2)
    caught = rm.catch_up()
    gossiped = [caught["shards"], lc[1].query("g", "Count(Row(f=1))")[0],
                sorted(lc[1].membership_json()["members"]),
                sorted(lc[0].gossip.state.digest())]
from pilosa_tpu_torch.loadgen import OpenLoopDriver, SyntheticTenants
from pilosa_tpu_torch.obs.tenants import tenant_scope
from pilosa_tpu_torch.sched import ManualClock
ten = API(device="cpu")
ten.create_index("t")
ten.create_field("t", "f")
ten.import_bits("t", "f", rows=[1, 1], cols=[1, 2])
reg = ten.enable_tenants()
deg = ten.enable_degrade()
rep = OpenLoopDriver(lambda op: None if ten.query("t", "Count(Row(f=1))")
                     else "error", rate_per_s=10.0, duration_s=1.0,
                     tenants=SyntheticTenants(100, seed=1),
                     seed=1).run_virtual(ManualClock())
with tenant_scope("acme"):
    ten.query("t", "Count(Row(f=1))")
row = reg.stats_json()["tenants"]["acme"]
tenanted = [rep.ok, row["queries"], row["device_seconds"] > 0,
            deg.probe()["state"]]
ten.disable_tenants()
import shutil
import tempfile
from pilosa_tpu_torch.dax import Computer, Directive
from pilosa_tpu_torch.dax.autoscale import Autoscaler
from pilosa_tpu_torch.dax.harness import DaxCluster
ddir = tempfile.mkdtemp()
fleet = DaxCluster(2, shared_dir=ddir, snapshot_every=4, serving=True,
                   device="cpu")
fleet.controller.create_table("d", {}, [{"name": "f", "options": {}}])
fleet.queryer.import_bits("d", "f", rows=[1] * 6,
                          cols=[1, 2, 3, 4, 1 << 20, (1 << 20) + 1])
fleet.kill(0)
replayed = Computer("check", ddir, device="cpu")
replayed.apply_directive(Directive(
    version=1, schema=fleet.controller.schema,
    assigned=[("d", 0), ("d", 1)]).to_json())
daxed = [fleet.queryer.query("d", "Count(Row(f=1))")[0],
         replayed.api.query("d", "Count(Row(f=1))")[0],
         Autoscaler(probes_fn=fleet.queryer.probe, scale_up=lambda: 2,
                    scale_down=lambda: 1, pool_size=lambda: 1).tick()]
fleet.close()
shutil.rmtree(ddir)
import torch
from pilosa_tpu_torch.parallel import ShardPlacement, analytics_mesh
import pilosa_tpu_torch.analysis.lint, pilosa_tpu_torch.cluster.hash
pl = ShardPlacement(analytics_mesh([torch.device("cpu")] * 4, col_parallel=2))
meshed = [pl.count(pl.place(np.ones((4, 64), np.uint32))),
          pl.row_counts(pl.place(np.ones((4, 3, 64), np.uint32))).tolist()]
print(json.dumps({"meshed": meshed, "star": star, "tenanted": tenanted, "resilient": resilient, "front": front, "hist": hist,
                  "daxed": daxed,
                  "clustered": clustered, "gossiped": gossiped,
                  "logged": logged,
                  "count": got[0], "top": got[1].pairs[0].count,
                  "profiled": profiled,
                  "wrote": wrote, "served": served, "fused": fused[0],
                  "recovered": recovered, "loaded": loaded,
                  "piped": piped, "streamed": streamed,
                  "city7": ing.query("c", "Count(Row(city=7))")[0],
                  "modules": sorted(sys.modules)}))
"""

#: the port's subpackages and modules the serving slice added; each must
#: be in the AST scan and loaded by the subprocess probe
_SERVING = ("analysis", "obs", "cache", "sched", "config.py")
#: and the durability slice's
_DURABILITY = ("storage", "storage/wal.py", "storage/store.py",
               "storage/recovery.py", "storage/roaring.py", "storage/txn.py",
               "transaction.py", "ingest", "ingest/idalloc.py", "config.py")
#: and the ingest and streaming slice's
_INGEST = ("ingest/source.py", "ingest/batch.py", "ingest/ingest.py",
           "ingest/datagen.py", "ingest/sources_ext.py", "ingest/kafka.py",
           "stream", "stream/broker.py", "stream/pipeline.py")
#: and the SQL slice's
_SQL = ("sql", "sql/lexer.py", "sql/ast.py", "sql/parser.py", "sql/types.py",
        "sql/plan.py", "sql/planner.py", "sql/joins.py", "sql/engine.py",
        "obs/history.py", "obs/logger.py", "loadgen", "loadgen/ssb.py")
#: and the observability slice's
_OBS = ("obs/timeline.py", "obs/slo.py", "obs/flight.py", "obs/devprof.py",
        "obs/health.py")
#: and the front ends'
_FRONTEND = ("server", "server/http.py", "server/auth.py", "server/oidc.py",
             "server/proto.py", "server/grpc.py", "server/maintenance.py",
             "client", "client/client.py", "client/orm.py", "ctl",
             "ctl/cli.py", "ctl/fbsql.py", "__main__.py")
#: and the cluster core's
_CLUSTER = ("hashing.py", "cluster", "cluster/topology.py", "cluster/disco.py",
            "cluster/broadcast.py", "cluster/client.py",
            "cluster/translator.py", "cluster/executor.py", "cluster/node.py",
            "cluster/harness.py")
#: and the SQL fan-out's
_SQL_FANOUT = ("sql/fanout.py",)
#: and fan-out resilience and leg batching's
_RESILIENCE = ("cluster/resilience.py", "cluster/batch.py")
#: and gossip, membership and replica catch-up's
_GOSSIP = ("gossip", "gossip/state.py", "gossip/agent.py",
           "gossip/membership.py", "storage/recovery.py")
#: and tenants and degradation's
_TENANTS = ("obs/tenants.py", "sched/degrade.py", "loadgen/driver.py",
            "loadgen/chaos.py", "loadgen/scenarios.py", "loadgen/tenants.py")

#: and the last slice's: the mesh reduces, the linter, the hash re-export
_MESH = ("parallel/mesh.py", "analysis/lint.py", "cluster/hash.py")

#: and the DAX plane's
_DAX = ("dax", "dax/directive.py", "dax/storage.py",
        "dax/computer.py", "dax/controller.py", "dax/queryer.py",
        "dax/autoscale.py", "dax/harness.py")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in _FORBIDDEN)


def test_import_and_query_load_neither_jax_nor_the_jax_package():
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "PYTHONPATH": ROOT, "HOME": os.environ.get("HOME", ROOT)}
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    import json

    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["count"] == 300 and out["top"] == 300
    assert out["wrote"] == [True, True, 1]
    assert out["served"] == [300, 300] and out["fused"] == [300]
    assert out["recovered"] is True
    assert (out["loaded"], out["piped"], out["streamed"]) == (2, 3, 5)
    assert out["city7"] == 4
    assert out["star"] is None and out["hist"] == [["sql", "running"]]
    assert out["logged"] == 5 + 6 + 2  # DDL, INSERT batches, SELECTs
    assert out["profiled"] == [300, 1, 1]
    assert out["front"][1:] == [0, True, True] and out["front"][0] > 0
    assert out["clustered"] == [2, "a", [[12]]]
    assert out["resilient"] == [2, True, True]
    assert out["gossiped"] == [1, 3, ["node0", "node1"],
                               ["node0", "node1"]]
    assert out["tenanted"] == [10, 1, True, "normal"]
    assert out["daxed"] == [6, 6, None]
    assert out["meshed"] == [4 * 64, [4 * 64] * 3]  # one bit a word
    for part in (_SERVING + _DURABILITY + _INGEST + _SQL + _OBS + _FRONTEND
                 + _CLUSTER + _SQL_FANOUT + _RESILIENCE + _GOSSIP
                 + _TENANTS + _DAX + _MESH):
        mod = "pilosa_tpu_torch." + part.removesuffix(".py").replace("/", ".")
        assert mod in out["modules"], f"the probe did not load {mod}"
    bad = [m for m in out["modules"] if _forbidden(m)]
    assert not bad, f"port loaded {bad}"


def _sources():
    for dirpath, _, files in os.walk(os.path.join(ROOT, "pilosa_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_module_imports_jax_or_the_jax_package(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    assert not [n for n in names if _forbidden(n)]


def test_scan_covers_the_serving_modules():
    scanned = {os.path.relpath(p, os.path.join(ROOT, "pilosa_tpu_torch"))
               for p in _sources()}
    for part in _SERVING:
        hits = [p for p in scanned if p == part or p.startswith(part + "/")]
        assert hits, f"the AST scan misses pilosa_tpu_torch/{part}"


def test_scan_covers_the_durability_modules():
    scanned = {os.path.relpath(p, os.path.join(ROOT, "pilosa_tpu_torch"))
               for p in _sources()}
    for part in _DURABILITY:
        hits = [p for p in scanned if p == part or p.startswith(part + "/")]
        assert hits, f"the AST scan misses pilosa_tpu_torch/{part}"


def test_scan_covers_the_ingest_modules():
    scanned = {os.path.relpath(p, os.path.join(ROOT, "pilosa_tpu_torch"))
               for p in _sources()}
    for part in _INGEST:
        hits = [p for p in scanned if p == part or p.startswith(part + "/")]
        assert hits, f"the AST scan misses pilosa_tpu_torch/{part}"


def test_scan_covers_the_sql_modules():
    scanned = {os.path.relpath(p, os.path.join(ROOT, "pilosa_tpu_torch"))
               for p in _sources()}
    for part in _SQL:
        hits = [p for p in scanned if p == part or p.startswith(part + "/")]
        assert hits, f"the AST scan misses pilosa_tpu_torch/{part}"


def test_scan_covers_the_observability_modules():
    scanned = {os.path.relpath(p, os.path.join(ROOT, "pilosa_tpu_torch"))
               for p in _sources()}
    for part in _OBS:
        assert part in scanned, f"the AST scan misses pilosa_tpu_torch/{part}"


def test_scan_covers_the_front_end_modules():
    scanned = {os.path.relpath(p, os.path.join(ROOT, "pilosa_tpu_torch"))
               for p in _sources()}
    for part in _FRONTEND:
        hits = [p for p in scanned if p == part or p.startswith(part + "/")]
        assert hits, f"the AST scan misses pilosa_tpu_torch/{part}"


def test_scan_covers_the_gossip_modules():
    scanned = {os.path.relpath(p, os.path.join(ROOT, "pilosa_tpu_torch"))
               for p in _sources()}
    for part in _GOSSIP:
        hits = [p for p in scanned if p == part or p.startswith(part + "/")]
        assert hits, f"the AST scan misses pilosa_tpu_torch/{part}"


def test_scan_covers_the_tenant_and_degrade_modules():
    scanned = {os.path.relpath(p, os.path.join(ROOT, "pilosa_tpu_torch"))
               for p in _sources()}
    for part in _TENANTS:
        assert part in scanned, f"the AST scan misses pilosa_tpu_torch/{part}"


def test_scan_covers_the_mesh_lint_and_hash_modules():
    scanned = {os.path.relpath(p, os.path.join(ROOT, "pilosa_tpu_torch"))
               for p in _sources()}
    for part in _MESH:
        assert part in scanned, f"the AST scan misses pilosa_tpu_torch/{part}"


def test_every_jax_module_has_a_counterpart():
    """Every module of pilosa_tpu has one in the port, but
    ops/pallas_util.py, whose job ops/kernel_util.py does."""
    missing = []
    jax_root = os.path.join(ROOT, "pilosa_tpu")
    for dirpath, _, files in os.walk(jax_root):
        for f in files:
            if f.endswith(".py") or f.endswith(".json"):
                rel = os.path.relpath(os.path.join(dirpath, f), jax_root)
                if not os.path.exists(os.path.join(ROOT, "pilosa_tpu_torch",
                                                   rel)):
                    missing.append(rel)
    assert missing == [os.path.join("ops", "pallas_util.py")]


def test_server_without_a_card_exits_and_serves_nothing(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the server would serve from it")
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "PYTHONPATH": ROOT, "HOME": str(tmp_path)}
    r = subprocess.run([sys.executable, "-m", "pilosa_tpu_torch", "server",
                        "--port", "0", "--data-dir", str(tmp_path / "d")],
                       cwd=tmp_path, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert "no CUDA device is available" in r.stderr
    assert "serving on" not in r.stderr
    assert not (tmp_path / "d").exists()


def test_api_without_a_device_needs_a_card(monkeypatch):
    from pilosa_tpu_torch.api import API

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        API()
    with pytest.raises(RuntimeError):
        API(device="cuda")
    assert API(device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        API(str(ROOT))  # a data directory does not pick the device


def test_chip_smoke_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_scan_covers_the_cluster_modules():
    scanned = {os.path.relpath(p, os.path.join(ROOT, "pilosa_tpu_torch"))
               for p in _sources()}
    for part in _CLUSTER:
        hits = [p for p in scanned if p == part or p.startswith(part + "/")]
        assert hits, f"the AST scan misses pilosa_tpu_torch/{part}"


def test_scan_covers_the_sql_fanout_module():
    scanned = {os.path.relpath(p, os.path.join(ROOT, "pilosa_tpu_torch"))
               for p in _sources()}
    for part in _SQL_FANOUT:
        assert part in scanned, f"the AST scan misses pilosa_tpu_torch/{part}"


def test_scan_covers_the_resilience_modules():
    scanned = {os.path.relpath(p, os.path.join(ROOT, "pilosa_tpu_torch"))
               for p in _sources()}
    for part in _RESILIENCE:
        assert part in scanned, f"the AST scan misses pilosa_tpu_torch/{part}"


def test_scan_covers_the_dax_modules():
    scanned = {os.path.relpath(p, os.path.join(ROOT, "pilosa_tpu_torch"))
               for p in _sources()}
    for part in _DAX:
        hits = [p for p in scanned if p == part or p.startswith(part + "/")]
        assert hits, f"the AST scan misses pilosa_tpu_torch/{part}"
