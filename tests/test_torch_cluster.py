"""The cluster core's cases, run once per package.

The ``P`` fixture yields the modules of ``pilosa_tpu`` or of their
``pilosa_tpu_torch`` counterparts, and each test body is the same:
``P.API()`` is the JAX package's ``API()`` or the port's
``API(device="cpu")``, and ``P.LocalCluster`` / ``P.ClusterNode`` build
the port's nodes with ``device="cpu"``. Every node of a cluster is served
by its package's ``serve`` on port 0, and the nodes talk over loopback
HTTP. Covered:

* ``tests/test_cluster.py``: ``TestPlacement``, ``TestDistributedQueries``
  (every query from every node against a single-node oracle),
  ``TestKeyedCluster``, ``TestTranslateStoreConcurrency``,
  ``TestFailover``, ``TestClusterTransactions``, ``TestLeaseDisCo``,
  ``TestTranslateReplication`` and ``test_mem_and_disk_usage_routes``;
* ``tests/test_cache.py::TestClusterCache``;
* ``tests/test_tracing.py::TestClusterEndToEnd``;
* ``tests/test_devprof.py::TestServing::test_stats_kernels_on_warmed_cluster``.

``TestSQLFanout`` runs once per package in
``tests/test_torch_sql_fanout.py``. Left to ``tests/test_cluster.py``
alone: ``TestClusterTimesMesh``, which waits for the mesh reduces. Each
module-scoped cluster is closed at module teardown; every other cluster
is closed by its test.
"""

import importlib
import json
import threading
import time
import types
import urllib.error
import urllib.request

import pytest

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
        ClusterNode=lambda *a, **k: m("cluster.node").ClusterNode(
            *a, **{**kw, **k}),
        C=cluster,
        LeaseDisCo=m("cluster.disco").LeaseDisCo,
        Node=m("cluster.topology").Node,
        PartitionedTranslateStore=m("core.translate")
        .PartitionedTranslateStore,
        TransactionError=m("transaction").TransactionError,
        SHARD_WIDTH=m("shardwidth").SHARD_WIDTH,
        serve=m("server.http").serve,
        MetricsRegistry=m("obs.metrics").MetricsRegistry,
        T=m("obs.tracing"),
        devprof=m("obs.devprof"),
    )


_PACKAGES = {}


def _pkg(root):
    if root not in _PACKAGES:
        _PACKAGES[root] = _load(root)
    return _PACKAGES[root]


@pytest.fixture(params=[JAX, TORCH], ids=["jax", "torch"])
def P(request):
    return _pkg(request.param)


def make_nodes(P, n):
    return [P.Node(id=f"node{i}", uri=f"http://host{i}") for i in range(n)]


# ---------------------------------------------------------------------------
# tests/test_cluster.py
# ---------------------------------------------------------------------------


class TestPlacement:
    def test_jump_hash_range_and_stability(self, P):
        for key in (0, 1, 7, 12345, 2**63):
            b = P.C.jump_hash(key, 7)
            assert 0 <= b < 7
            assert P.C.jump_hash(key, 7) == b

    def test_jump_hash_monotone_growth(self, P):
        # Adding a bucket only moves keys INTO the new bucket.
        for key in range(200):
            before = P.C.jump_hash(key, 9)
            after = P.C.jump_hash(key, 10)
            assert after == before or after == 9

    def test_partitions_in_range(self, P):
        seen = set()
        for shard in range(512):
            p = P.C.shard_to_partition("i", shard)
            assert 0 <= p < 256
            seen.add(p)
        assert len(seen) > 200  # spread over most partitions

    def test_key_partition_differs_from_shard_partition_namespace(self, P):
        k2p = P.C.key_to_partition
        assert k2p("i", "alice") == k2p("i", "alice")
        assert k2p("i", "alice") != k2p("j", "alice") \
            or k2p("i", "bob") != k2p("j", "bob")

    def test_snapshot_replicas(self, P):
        snap = P.C.ClusterSnapshot(make_nodes(P, 5), replica_n=3)
        owners = snap.shard_nodes("i", 42)
        assert len(owners) == 3
        assert len({n.id for n in owners}) == 3
        # consecutive around the sorted ring
        ids = [n.id for n in snap.nodes]
        i = ids.index(owners[0].id)
        assert [n.id for n in owners] == [ids[(i + r) % 5] for r in range(3)]

    def test_cluster_state_derivation(self, P):
        snap = P.C.ClusterSnapshot(make_nodes(P, 3), replica_n=2)
        ids = [n.id for n in snap.nodes]
        assert snap.cluster_state(ids) == P.C.STATE_NORMAL
        assert snap.cluster_state(ids[:2]) == P.C.STATE_DEGRADED
        assert snap.cluster_state(ids[:1]) == P.C.STATE_DOWN
        assert snap.cluster_state([]) == P.C.STATE_DOWN


_CLUSTERS = {}


@pytest.fixture(scope="module")
def _clusters():
    """One 3-node cluster per package (and its single-node oracle once
    filled), shared by the module's tests as the JAX file shares one;
    closed at module teardown."""
    yield _CLUSTERS
    for c, _ in _CLUSTERS.values():
        c.close()
    _CLUSTERS.clear()


@pytest.fixture
def cluster(P, _clusters):
    if P.root not in _clusters:
        _clusters[P.root] = [P.LocalCluster(3), None]
    return _clusters[P.root][0]


def _fill(P, target, index="ci"):
    """Same data through any node/API surface."""
    SW = P.SHARD_WIDTH
    target.create_index(index)
    target.create_field(index, "f")
    target.create_field(index, "n", {"type": "int"})
    rows, cols = [], []
    for c in range(0, 5 * SW, SW // 4):
        rows.append((c // 100) % 3)
        cols.append(c)
    target.import_bits(index, "f", rows=rows, cols=cols)
    vals_cols = list(range(0, 3 * SW, SW // 8))
    target.import_values(index, "n", cols=vals_cols,
                         values=[(i % 7) - 3 for i in range(len(vals_cols))])
    return index


@pytest.fixture
def filled(P, cluster, _clusters):
    ent = _clusters[P.root]
    if ent[1] is None:
        oracle = P.API()
        _fill(P, oracle)
        _fill(P, cluster.coordinator)
        ent[1] = oracle
    return ent[1]


class TestDistributedQueries:
    @pytest.mark.parametrize("pql", [
        "Count(Row(f=0))",
        "Count(Union(Row(f=0), Row(f=1)))",
        "Count(Intersect(Row(f=0), Row(f=1)))",
        "Row(f=2)",
        "Sum(field=n)",
        "Min(field=n)",
        "Max(field=n)",
        "Sum(Row(f=0), field=n)",
        "TopN(f, n=2)",
        "Rows(f)",
        "GroupBy(Rows(f), limit=10)",
        "Count(Distinct(field=n))",
        "Percentile(field=n, nth=50)",
    ])
    def test_matches_single_node_oracle(self, P, cluster, filled, pql):
        want = filled.query("ci", pql)
        for node in cluster.nodes:  # any node can coordinate
            got = node.query("ci", pql)
            assert got == want, f"{pql} on {node.node.id}"

    def test_schema_visible_everywhere(self, P, cluster, filled):
        for node in cluster.nodes:
            assert "ci" in node.holder.indexes
            assert "f" in node.holder.index("ci").fields

    def test_data_is_actually_distributed(self, P, cluster, filled):
        # At least two nodes hold fragments (5 shards over 3 nodes).
        holders = sum(
            1 for node in cluster.nodes
            if node.holder.index("ci").shards())
        assert holders >= 2

    def test_writes_route_and_read_back(self, P, cluster, filled):
        SW = P.SHARD_WIDTH
        cluster[1].query("ci", f"Set({7 * SW + 11}, f=9)")
        got = cluster[2].query("ci", "Row(f=9)")
        assert got[0].columns == [7 * SW + 11]
        assert filled.query("ci", "Count(Row(f=0))") == \
            cluster[0].query("ci", "Count(Row(f=0))")


class TestKeyedCluster:
    def test_keyed_set_and_query_across_nodes(self, P, cluster):
        co = cluster.coordinator
        co.create_index("ki", {"keys": True})
        co.create_field("ki", "color", {"keys": True})
        for person, color in [("alice", "red"), ("bob", "red"),
                              ("carol", "blue")]:
            co.query("ki", f'Set("{person}", color="{color}")')
        # Query from a different node: keys translate back.
        got = cluster[2].query("ki", 'Row(color="red")')
        assert sorted(got[0].keys) == ["alice", "bob"]
        top = cluster[1].query("ki", "TopN(color)")
        assert [(p.key, p.count) for p in top[0].pairs] == \
            [("red", 2), ("blue", 1)]
        # Unknown key reads empty, doesn't create.
        assert cluster[1].query("ki", 'Row(color="nope")')[0].columns == []

    def test_distinct_on_keyed_set_field(self, P, cluster):
        # Distinct over a set field returns ROW keys (field translator),
        # not record keys.
        got = cluster[1].query("ki", "Distinct(field=color)")
        assert sorted(got[0].keys) == ["blue", "red"]


class TestTranslateStoreConcurrency:
    def test_parallel_create_keys_unique_ids(self, P):
        from concurrent.futures import ThreadPoolExecutor

        store = P.PartitionedTranslateStore("i")

        def mk(t):
            return store.create_keys([f"k{t}-{j}" for j in range(500)])

        with ThreadPoolExecutor(max_workers=8) as pool:
            maps = list(pool.map(mk, range(8)))
        ids = [i for m in maps for i in m.values()]
        assert len(ids) == len(set(ids)) == 4000

    def test_load_over_foreign_journal_never_reuses_ids(self, P, tmp_path):
        # A journal with IDs dense in shard 0 (any older allocation
        # scheme) must not cause new allocations to collide.
        path = str(tmp_path / "keys.jsonl")
        with open(path, "w") as f:
            for i in range(50):
                f.write(json.dumps([f"old{i}", i]) + "\n")
        store = P.PartitionedTranslateStore("i", path)
        fresh = store.create_keys([f"new{i}" for i in range(50)])
        all_ids = set(range(50)) | set(fresh.values())
        assert len(all_ids) == 100  # no reuse
        assert store.translate_ids([3]) == {3: "old3"}


class TestFailover:
    def test_replica_failover_and_state_gating(self, P):
        c = P.LocalCluster(3, replica_n=2)
        try:
            co = c.coordinator
            _fill(P, co, index="fi")
            want = co.query("fi", "Count(Row(f=0))")[0]
            c.pause(1)
            assert co.state() in (P.C.STATE_DEGRADED,)
            # Reads still served via replicas.
            got = co.query("fi", "Count(Row(f=0))")[0]
            assert got == want
            # Writes refused while DEGRADED.
            with pytest.raises(P.C.ClusterStateError):
                co.query("fi", "Set(1, f=1)")
            with pytest.raises(P.C.ClusterStateError):
                co.create_index("nope")
            # Recovery restores NORMAL and writes.
            c.unpause(1)
            assert co.state() == P.C.STATE_NORMAL
            co.query("fi", "Set(1, f=1)")
        finally:
            c.close()

    def test_single_replica_down_is_down_for_missing_shards(self, P):
        c = P.LocalCluster(2, replica_n=1)
        try:
            co = c.coordinator
            _fill(P, co, index="si")
            c.pause(1)
            assert co.state() == P.C.STATE_DOWN
            with pytest.raises(P.C.ClusterStateError):
                co.query("si", "Count(Row(f=0))")
        finally:
            c.close()


class TestClusterTransactions:
    def test_exclusive_transaction_blocks_peer_writes(self, P):
        """Reference: server.go:1082 — transaction changes broadcast to
        peers so an exclusive transaction on node A blocks writes on node
        B."""
        c = P.LocalCluster(3)
        try:
            co = c.coordinator
            _fill(P, co, index="ti")
            tx = c[1].transactions.start(exclusive=True)
            assert tx.active  # alone -> immediately active
            # mirrored on every peer
            assert c[0].transactions.exclusive_active()
            assert c[2].transactions.exclusive_active()
            with pytest.raises(P.TransactionError):
                co.query("ti", "Set(99, f=1)")
            with pytest.raises(P.TransactionError):
                c[2].import_bits("ti", "f", rows=[1], cols=[99])
            # a peer can't start another transaction meanwhile
            with pytest.raises(P.TransactionError):
                c[0].transactions.start()
            # reads still work
            assert co.query("ti", "Count(Row(f=0))")[0] >= 0
            c[1].transactions.finish(tx.id)
            assert not c[0].transactions.exclusive_active()
            assert co.query("ti", "Set(99, f=1)") == [True]
        finally:
            c.close()


class TestLeaseDisCo:
    """Membership over a shared directory of TTL leases: join and leave
    change the cluster state without any node restarting."""

    def _mk(self, P, tmp_path, ttl=0.6):
        root = str(tmp_path / "disco")
        return lambda: P.LeaseDisCo(root, ttl=ttl, heartbeat_interval=0.1)

    def test_dynamic_join_visible_to_peers(self, P, tmp_path):
        factory = self._mk(P, tmp_path)
        c = P.LocalCluster(2, disco_factory=factory)
        try:
            c.coordinator.create_index("dj")
            c.coordinator.create_field("dj", "f")
            assert {n.id for n in c[0].disco.nodes()} == {"node0", "node1"}
            assert c[0].state() == "NORMAL"
            # a NEW node joins the running cluster — no restarts
            joiner = P.ClusterNode("node2", "", factory())
            srv, _ = P.serve(joiner, port=0, background=True)
            host, port = srv.server_address[:2]
            joiner.node.uri = f"http://{host}:{port}"
            joiner.disco.register(joiner.node)
            try:
                deadline = time.time() + 3
                while time.time() < deadline and \
                        len(c[0].disco.nodes()) != 3:
                    time.sleep(0.05)
                assert {n.id for n in c[0].disco.nodes()} == \
                    {"node0", "node1", "node2"}
                assert sorted(c[0].disco.live_ids()) == \
                    ["node0", "node1", "node2"]
                # writes now route to the joiner for shards it owns
                snap = c[0].snapshot()
                owners = {snap.shard_nodes("dj", s)[0].id
                          for s in range(12)}
                assert "node2" in owners
                # graceful leave: gone from membership, state stays NORMAL
                joiner.disco.leave()
                assert {n.id for n in c[0].disco.nodes()} == \
                    {"node0", "node1"}
                assert c[0].state() == "NORMAL"
            finally:
                srv.shutdown()
                srv.server_close()
        finally:
            c.close()

    def test_lease_expiry_degrades_then_recovers(self, P, tmp_path):
        factory = self._mk(P, tmp_path, ttl=0.5)
        c = P.LocalCluster(3, replica_n=2, disco_factory=factory)
        try:
            assert c[0].state() == "NORMAL"
            # crash node2 (no graceful leave): stop its heartbeat only
            c[2].disco._hb_stop.set()
            deadline = time.time() + 3
            while time.time() < deadline and \
                    "node2" in c[0].disco.live_ids():
                time.sleep(0.05)
            assert "node2" not in c[0].disco.live_ids()
            # still a member (lease expired, not removed) -> DEGRADED
            assert {n.id for n in c[0].disco.nodes()} == \
                {"node0", "node1", "node2"}
            assert c[0].state() == "DEGRADED"
            # heartbeat resumes -> NORMAL again, no restarts anywhere
            c[2].disco._hb_stop.clear()
            t = threading.Thread(target=c[2].disco._keepalive, daemon=True)
            c[2].disco._hb_thread = t
            t.start()
            deadline = time.time() + 3
            while time.time() < deadline and c[0].state() != "NORMAL":
                time.sleep(0.05)
            assert c[0].state() == "NORMAL"
        finally:
            c.close()

    def test_mark_down_needs_fresh_heartbeat(self, P, tmp_path):
        root = str(tmp_path / "d2")
        a = P.LeaseDisCo(root, ttl=5.0, heartbeat_interval=0.1)
        b = P.LeaseDisCo(root, ttl=5.0, heartbeat_interval=0.1)
        a.register(P.Node(id="a", uri=""))
        b.register(P.Node(id="b", uri=""))
        try:
            assert sorted(a.live_ids()) == ["a", "b"]
            # transport failure: disbelieve b's current lease
            a.mark_down("b")
            assert a.live_ids() == ["a"]
            # a FRESH heartbeat from b restores it
            time.sleep(0.25)
            assert sorted(a.live_ids()) == ["a", "b"]
        finally:
            a.leave()
            b.leave()


class TestTranslateReplication:
    """Owner-side creates push new (key, id) entries to the partition's
    replicas, and a promoted replica serves and extends the namespace
    after the primary dies."""

    def test_replica_promoted_serves_keys(self, P):
        c = P.LocalCluster(3, replica_n=2)
        try:
            co = c.coordinator
            co.create_index("tk", {"keys": True})
            co.create_field("tk", "color", {"keys": True})
            co.import_bits("tk", "color",
                           row_keys=[f"c{i % 5}" for i in range(60)],
                           col_keys=[f"rec{i}" for i in range(60)])
            want = co.query("tk", "Count(Row(color=c1))")[0]
            assert want > 0
            # field-key primary is partition-0's primary; kill it
            snap = co.snapshot()
            primary = snap.partition_nodes(0)[0].id
            victim = int(primary.replace("node", ""))
            survivor = c[(victim + 1) % 3]
            c.pause(victim)
            got = survivor.query("tk", "Count(Row(color=c1))")[0]
            assert got == want
            # a promoted replica allocates NON-conflicting ids
            fstore = survivor.holder.index("tk").field("color").translate
            known = set(fstore.key_to_id.values())
            _, new = fstore.create_entries(["cNEW"])
            assert new and new[0][1] not in known
            c.unpause(victim)
            survivor.query("tk", 'Set("recNEW", color="cNEW2")')
            assert survivor.query("tk", "Count(Row(color=cNEW2))")[0] == 1
            assert survivor.query("tk", "Count(Row(color=c1))")[0] == want
        finally:
            c.close()

    def test_entries_identical_on_replicas(self, P):
        c = P.LocalCluster(3, replica_n=3)  # every node replicates all
        try:
            co = c.coordinator
            co.create_index("tr", {"keys": True})
            co.create_field("tr", "tag", {"keys": True})
            co.import_bits("tr", "tag",
                           row_keys=["a", "b", "a"],
                           col_keys=["x", "y", "z"])
            stores = [n.holder.index("tr").translate for n in c.nodes]
            maps = [dict(s.key_to_id) for s in stores]
            assert maps[0] and maps[0] == maps[1] == maps[2]
            fstores = [n.holder.index("tr").field("tag").translate
                       for n in c.nodes]
            fmaps = [dict(s.key_to_id) for s in fstores]
            assert fmaps[0] and fmaps[0] == fmaps[1] == fmaps[2]
        finally:
            c.close()


def test_mem_and_disk_usage_routes(P, tmp_path):
    api = P.API(str(tmp_path))
    api.create_index("u")
    api.create_field("u", "f")
    api.query("u", "Set(1, f=1)")
    api.save()
    srv, _ = P.serve(api, port=0, background=True)
    host, port = srv.server_address[:2]
    base = f"http://{host}:{port}"
    try:
        mem = json.load(urllib.request.urlopen(base + "/internal/mem-usage"))
        assert mem["maxRSSBytes"] > 0 and mem["holderPlaneBytes"] > 0
        du = json.load(urllib.request.urlopen(base + "/disk-usage"))
        assert du["usage"] > 0
        dui = json.load(urllib.request.urlopen(base + "/disk-usage/u"))
        assert 0 < dui["usage"] <= du["usage"]
    finally:
        srv.shutdown()
        srv.server_close()


# ---------------------------------------------------------------------------
# tests/test_cache.py::TestClusterCache
# ---------------------------------------------------------------------------


class TestClusterCache:
    """The local fan-out leg keys on fragment versions; the remote legs
    key on (pql, shard set, write epoch) and need ttl_ms > 0."""

    @pytest.fixture()
    def node(self, P):
        SW = P.SHARD_WIDTH
        c = P.LocalCluster(3)
        n0 = c.nodes[0]
        n0.create_index("cc")
        n0.create_field("cc", "f")
        cols = list(range(0, 4 * SW, SW // 4))
        n0.import_bits("cc", "f", rows=[0] * len(cols), cols=cols)
        yield n0
        c.close()

    def test_repeat_query_hits_and_write_invalidates(self, P, node):
        cache = node.enable_cache(ttl_ms=60_000,
                                  registry=P.MetricsRegistry())
        assert node.cache is cache
        r1 = node.query("cc", "Count(Row(f=0))")
        hits0 = dict(cache.stats())["hits"]
        assert node.query("cc", "Count(Row(f=0))") == r1
        assert dict(cache.stats())["hits"] > hits0
        node.import_bits("cc", "f", rows=[0], cols=[3])
        assert node.query("cc", "Count(Row(f=0))") == [r1[0] + 1]

    def test_remote_legs_not_cached_without_ttl(self, P, node):
        cache = node.enable_cache(ttl_ms=0, registry=P.MetricsRegistry())
        node.query("cc", "Count(Row(f=0))")
        with cache._lock:
            assert not any(k[0] == "rleg" for k in cache._entries)
        node.disable_cache()
        assert node.cache is None and node.executor.cache is None


# ---------------------------------------------------------------------------
# tests/test_tracing.py::TestClusterEndToEnd
# ---------------------------------------------------------------------------


def _names(span_json, acc=None):
    """All span names in a to_json tree (local and remote alike)."""
    acc = acc if acc is not None else []
    acc.append(span_json.get("name", ""))
    for c in span_json.get("children", ()):
        _names(c, acc)
    return acc


def _find(span_json, name):
    """All subtree dicts with the given span name."""
    out = []
    if span_json.get("name") == name:
        out.append(span_json)
    for c in span_json.get("children", ()):
        out.extend(_find(c, name))
    return out


@pytest.fixture
def nop_global(P):
    prev = P.T.get_tracer()
    P.T.set_tracer(P.T.NopTracer())
    yield
    P.T.set_tracer(prev)


class TestClusterEndToEnd:
    def test_three_node_profile_collects_remote_stages(self, P, nop_global):
        # profile=true on a 3-node cluster returns ONE span tree whose
        # remote legs carry the serving nodes' rpc spans, with tracing
        # globally OFF everywhere
        SW = P.SHARD_WIDTH
        with P.LocalCluster(3) as c:
            co = c.coordinator
            # shards 0/1/2 of index "prof" hash to node1/node2/node0
            co.create_index("prof")
            co.create_field("prof", "f")
            for shard in range(3):
                co.import_bits("prof", "f", rows=[1, 1],
                               cols=[shard * SW, shard * SW + 5])
            co.enable_scheduler(window_ms=0.2)
            co.enable_cache()
            try:
                out = co.query_json("prof", "Count(Row(f=1))", profile=True)
            finally:
                co.disable_scheduler()
                co.disable_cache()
            assert out["results"] == [6]
            prof = out["profile"]
            names = _names(prof)
            assert "query.pql" in names
            assert "sched.queue_wait" in names  # scheduler admission
            assert "cache.lookup" in names  # cold read: counted miss
            legs = _find(prof, "cluster.leg")
            assert legs, f"no cluster.leg spans in {names}"
            rpc = _find(prof, "rpc.post_internal_query")
            assert rpc, f"no remote rpc spans shipped back in {names}"
            # remote spans are tagged with the serving node's id
            assert all(r["tags"].get("node", "").startswith("node")
                       for r in rpc)
            total = prof["duration_ns"]
            staged = sum(c["duration_ns"] for c in prof["children"])
            assert staged > 0 and total > 0

    def test_internal_traces_endpoints(self, P):
        SW = P.SHARD_WIDTH
        prev = P.T.get_tracer()
        reg = P.MetricsRegistry()
        P.T.set_tracer(P.T.Tracer(enabled=True,
                                  store=P.T.TraceStore(32, registry=reg),
                                  registry=reg))
        try:
            with P.LocalCluster(3) as c:
                co = c.coordinator
                co.create_index("prof")  # shards 0-2 span all three nodes
                co.create_field("prof", "f")
                for shard in range(3):
                    co.import_bits("prof", "f", rows=[1], cols=[shard * SW])
                assert co.query("prof", "Count(Row(f=1))") == [3]
                base = co.node.uri
                with urllib.request.urlopen(base + "/internal/traces") as r:
                    listing = json.loads(r.read())
                assert listing["enabled"]
                assert listing["traces"], "no finished traces listed"
                tid = listing["traces"][0]["traceID"]
                with urllib.request.urlopen(
                        base + f"/internal/traces/{tid}") as r:
                    doc = json.loads(r.read())
                assert doc["traceID"] == tid
                assert doc["spans"]["name"]
                with pytest.raises(urllib.error.HTTPError) as ei:
                    urllib.request.urlopen(
                        base + "/internal/traces/deadbeef")
                assert ei.value.code == 404
                # the coordinator assembled remote spans into its tree
                q = [d for d in (P.T.get_tracer().store.get(s["traceID"])
                                 for s in listing["traces"])
                     if d["root"] == "query.pql"]
                assert any(_find(d["spans"], "rpc.post_internal_query")
                           for d in q)
        finally:
            P.T.set_tracer(prev)


# ---------------------------------------------------------------------------
# tests/test_devprof.py::TestServing::test_stats_kernels_on_warmed_cluster
# ---------------------------------------------------------------------------

DEVPROF_QUERIES = [
    "Count(Row(f=1))",
    "Count(Intersect(Row(f=1), Row(g=1)))",
    "Intersect(Row(f=2), Row(g=2))",
]


def _fill_dk(P, target, index="dk"):
    SW = P.SHARD_WIDTH
    target.create_index(index)
    target.create_field(index, "f")
    target.create_field(index, "g")
    rows, cols = [], []
    for c in range(0, 2 * SW, SW // 16):
        rows.append((c // 64) % 5)
        cols.append(c)
    target.import_bits(index, "f", rows=rows, cols=cols)
    target.import_bits(index, "g", rows=[r % 3 for r in rows], cols=cols)
    return index


@pytest.fixture
def profiled(P):
    dp = P.devprof
    was = dp.ENABLED
    dp.enable()
    dp.reset()
    yield dp
    dp.reset()
    dp.enable() if was else dp.disable()


class TestServing:
    def test_stats_kernels_on_warmed_cluster(self, P, profiled):
        with P.LocalCluster(3) as c:
            _fill_dk(P, c.coordinator)
            for _ in range(2):  # warm: second pass hits compiled programs
                for q in DEVPROF_QUERIES:
                    c.coordinator.query("dk", q)
            uri = c.coordinator.node.uri
            with urllib.request.urlopen(
                    uri + "/internal/stats/kernels") as r:
                payload = json.loads(r.read())
        assert payload["enabled"] is True
        assert payload["ridge_flops_per_byte"] > 0
        fams = {k["family"] for k in payload["kernels"]}
        assert len(fams) >= len(DEVPROF_QUERIES)
        for k in payload["kernels"]:
            assert k["mfu_pct"] > 0
            assert k["achieved_gbps"] > 0
            assert k["roofline_bound"] in ("memory", "compute")
