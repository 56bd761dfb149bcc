"""Fan-out leg batching, run once per package, and the two packages'
batch serving held against each other.

The ``P`` fixture yields the modules of ``pilosa_tpu`` or of their
``pilosa_tpu_torch`` counterparts; ``P.API()`` and ``P.LocalCluster``
build the port's with ``device="cpu"``. Covered:

* every case of ``tests/test_cluster_batch.py`` (the shared arrival
  window, ``_BatchToken``, ``NodeBatcher`` over a fake client, the
  serving side ``ClusterNode.query_remote_batch``, batched clusters
  against the unbatched oracle with the RPC cut, the env switch and the
  config section, the remote-leg cache, ``FaultPlan`` chaos scoped
  ``op="query_batch"``, span tags, keep-alive pooling and the batch
  metrics), once per package;
* across the packages, equal: the wire JSON of ``query_remote_batch``
  for the same batches (mixed indexes, bad entries, every result kind
  of a Count, a Row, a TopN and a Sum) on the same data, and the JSON
  bodies ``POST /internal/query-batch`` returns on a node (its 404 on a
  plain API in both).
"""

import importlib
import json
import threading
import time
import types
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

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
        C=cluster,
        R=m("cluster.resilience"),
        _BatchToken=m("cluster.batch")._BatchToken,
        Node=m("cluster.topology").Node,
        Config=m("config").Config,
        M=m("obs.metrics"),
        T=m("obs.tracing"),
        MetricsRegistry=m("obs.metrics").MetricsRegistry,
        ArrivalWindow=m("sched.window").ArrivalWindow,
        QueryScheduler=m("sched").QueryScheduler,
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


def _fill(P, target, index="cb"):
    """Identical dataset on any API/ClusterNode: 5 shards, 3 rows."""
    SW = P.SHARD_WIDTH
    target.create_index(index)
    target.create_field(index, "f")
    rows, cols = [], []
    for c in range(0, 5 * SW, SW // 4):
        rows.append((c // 100) % 3)
        cols.append(c)
    target.import_bits(index, "f", rows=rows, cols=cols)
    return index


def _remote_primary(co, index):
    ex = co.executor
    snap = ex._snapshot_fn()
    by_node = ex._assign(snap, index, sorted(ex._shards_fn(index)), set())
    return next(nid for nid in by_node if nid != ex.node_id)


class FakeClient:
    """query_node_batch stand-in: records calls, demuxes via handler."""

    def __init__(self, handler=None, block=None):
        self.calls = []
        self.lock = threading.Lock()
        self.block = block  # optional event the send waits on
        self.handler = handler or (lambda entries: [
            {"results": [["slot", e["index"], e["query"],
                          tuple(e["shards"])]]} for e in entries])

    def query_node_batch(self, node, entries, token=None):
        with self.lock:
            self.calls.append((node.id, [dict(e) for e in entries], token))
        if self.block is not None:
            self.block.wait(5.0)
        return self.handler(entries)


def _node(P, i=0):
    return P.Node(id=f"peer{i}", uri=f"http://peer{i}")


class TestArrivalWindow:
    def test_non_adaptive_returns_fixed_window(self, P):
        w = P.ArrivalWindow(0.25, adaptive=False)
        assert w.window_s() == 0.25
        w.observe(1.0)
        w.observe(1.001)
        assert w.window_s() == 0.25

    def test_idle_collapses_to_min_and_bursts_earn_max(self, P):
        w = P.ArrivalWindow(0.0, adaptive=True, window_min_s=0.001,
                            window_max_s=0.01, max_batch=10)
        assert w.window_s() == 0.001  # no gap observed yet
        t = 0.0
        for _ in range(50):  # 1 kHz arrivals: gap far under max/max_batch
            w.observe(t)
            t += 0.001
        assert w.window_s() == pytest.approx(0.01)
        for _ in range(50):  # 1 Hz arrivals: collapse back toward min
            w.observe(t)
            t += 1.0
        assert w.window_s() == pytest.approx(0.001)

    def test_scheduler_delegates_to_shared_policy(self, P):
        sched = P.QueryScheduler(None, adaptive_window=True,
                                 window_min_ms=0.2, window_max_ms=5.0)
        try:
            assert isinstance(sched._arrival, P.ArrivalWindow)
            assert sched.current_window_ms() == pytest.approx(0.2)
        finally:
            sched.close()


class TestBatchToken:
    def test_cancelled_only_when_every_member_is(self, P):
        a, b = P.C.CancellationToken(), P.C.CancellationToken()
        bt = P._BatchToken([a, b])
        assert not bt.cancelled
        a.cancel()
        assert not bt.cancelled  # b keeps the shared wire call alive
        b.cancel()
        assert bt.cancelled
        assert bt.wait(10.0) is True  # returns promptly once cancelled

    def test_member_without_token_pins_uncancellable(self, P):
        a = P.C.CancellationToken()
        a.cancel()
        bt = P._BatchToken([a, None])
        assert not bt.cancelled
        assert bt.wait(0.01) is False

    def test_timeout_is_laxest_member(self, P):
        CT = P.C.CancellationToken
        bt = P._BatchToken([CT(timeout_s=0.5), CT(timeout_s=2.0)])
        assert bt.timeout_s == 2.0
        # any member without a timeout pins the batch untimed
        bt = P._BatchToken([CT(timeout_s=0.5), CT()])
        assert bt.timeout_s is None


#: the window of a case whose legs must all land in one RPC: a cohort
#: ships as soon as it is full (max_batch), so a long window costs
#: nothing, and a loaded test worker cannot split the cohort (the JAX
#: package's cases give 250 ms)
_FULL_COHORT_MS = 5000.0


class TestNodeBatcher:
    def _batcher(self, P, client, reg=None, **kw):
        kw.setdefault("window_ms", 20.0)
        kw.setdefault("adaptive_window", False)
        return P.C.NodeBatcher(client, registry=reg or P.MetricsRegistry(),
                               **kw)

    def test_solo_leg_ships_as_batch_of_one(self, P):
        fc = FakeClient()
        b = self._batcher(P, fc, window_ms=0.0)
        out = b.run(_node(P), "i", "Count(Row(f=0))", [1, 2])
        assert out == [["slot", "i", "Count(Row(f=0))", (1, 2)]]
        assert len(fc.calls) == 1
        assert fc.calls[0][1] == [
            {"index": "i", "query": "Count(Row(f=0))", "shards": [1, 2]}]
        # a single-leg batch carries the leg's own token, not a wrapper
        assert fc.calls[0][2] is None

    def test_concurrent_legs_coalesce_into_one_rpc(self, P):
        fc = FakeClient()
        reg = P.MetricsRegistry()
        b = self._batcher(P, fc, reg, max_batch=8, window_ms=_FULL_COHORT_MS)
        node = _node(P)
        with ThreadPoolExecutor(8) as pool:
            outs = list(pool.map(
                lambda i: b.run(node, "i", f"q{i}", [i]), range(8)))
        # max_batch reached => the window never has to expire
        assert len(fc.calls) == 1
        assert len(fc.calls[0][1]) == 8
        for i, out in enumerate(outs):  # demux preserves per-leg identity
            assert out == [["slot", "i", f"q{i}", (i,)]]
        h = reg.histogram(P.M.METRIC_CLUSTER_BATCH_SIZE)
        assert h["count"] == 1 and h["sum"] == 8.0
        assert reg.value(P.M.METRIC_CLUSTER_BATCHED_RPCS,
                         node="peer0") == 1.0

    def test_queue_beyond_max_batch_ships_in_waves(self, P):
        fc = FakeClient()
        b = self._batcher(P, fc, max_batch=4, window_ms=40.0)
        node = _node(P)
        with ThreadPoolExecutor(10) as pool:
            outs = list(pool.map(
                lambda i: b.run(node, "i", f"q{i}", [i]), range(10)))
        assert all(outs[i] == [["slot", "i", f"q{i}", (i,)]]
                   for i in range(10))
        assert 3 <= len(fc.calls) <= 10
        assert all(len(c[1]) <= 4 for c in fc.calls)

    def test_per_entry_error_hits_only_its_leg(self, P):
        def handler(entries):
            out = []
            for e in entries:
                if e["query"] == "bad":
                    out.append({"error": "no such field", "status": 404})
                else:
                    out.append({"results": [["ok", e["query"]]]})
            return out

        fc = FakeClient(handler)
        reg = P.MetricsRegistry()
        b = self._batcher(P, fc, reg, max_batch=3, window_ms=_FULL_COHORT_MS)
        with ThreadPoolExecutor(3) as pool:
            futs = [pool.submit(b.run, _node(P), "i", q, [0])
                    for q in ("good1", "bad", "good2")]
            results, errors = [], []
            for f in futs:
                try:
                    results.append(f.result(timeout=5.0))
                except P.C.RemoteError as e:
                    errors.append(e)
        assert len(fc.calls) == 1  # one RPC carried all three
        assert sorted(r[0][1] for r in results) == ["good1", "good2"]
        assert len(errors) == 1 and errors[0].status == 404
        assert reg.value(P.M.METRIC_CLUSTER_BATCH_DEMUX_FAILURES,
                         node="peer0", why="query") == 1.0

    def test_transport_failure_fails_every_member(self, P):
        class DownClient:
            def query_node_batch(self, node, entries, token=None):
                raise P.C.NodeDownError("peer gone")

        reg = P.MetricsRegistry()
        b = self._batcher(P, DownClient(), reg, max_batch=2,
                          window_ms=_FULL_COHORT_MS)
        with ThreadPoolExecutor(2) as pool:
            futs = [pool.submit(b.run, _node(P), "i", f"q{i}", [i])
                    for i in range(2)]
            for f in futs:
                with pytest.raises(P.C.NodeDownError):
                    f.result(timeout=5.0)
        assert reg.value(P.M.METRIC_CLUSTER_BATCH_DEMUX_FAILURES,
                         node="peer0", why="transport") == 2.0

    def test_slot_count_mismatch_is_a_demux_error(self, P):
        fc = FakeClient(handler=lambda entries: [])
        b = self._batcher(P, fc, window_ms=0.0)
        with pytest.raises(P.C.RemoteError, match="batch demux"):
            b.run(_node(P), "i", "q", [0])

    def test_cancelled_pending_leg_withdraws(self, P):
        tok = P.C.CancellationToken()
        tok.cancel()
        fc = FakeClient()
        b = self._batcher(P, fc)
        with pytest.raises(P.C.LegCancelled):
            b.run(_node(P), "i", "q", [0], token=tok)
        assert fc.calls == []  # withdrawn before any wire send
        with b._lock:
            assert b._slots["peer0"].pending == []

    def test_distinct_nodes_never_share_a_batch(self, P):
        fc = FakeClient()
        b = self._batcher(P, fc, max_batch=4, window_ms=30.0)
        node, other = _node(P, 0), _node(P, 1)
        with ThreadPoolExecutor(4) as pool:
            futs = [pool.submit(b.run, n, "i", f"q{i}", [i])
                    for i, n in enumerate([node, other, node, other])]
            for f in futs:
                f.result(timeout=5.0)
        assert {c[0] for c in fc.calls} == {"peer0", "peer1"}
        for nid, entries, _tok in fc.calls:
            assert all(q["query"] in
                       (("q0", "q2") if nid == "peer0" else ("q1", "q3"))
                       for q in entries)


_MIXED = [
    {"index": "qa", "query": "Count(Row(f=0))", "shards": [0]},
    {"index": "qb", "query": "Count(Row(f=1))", "shards": [1]},
    {"index": "qa", "query": "Count(Row(f=2))", "shards": [2]},
]


class TestQueryRemoteBatch:
    """The serving side: ClusterNode.query_remote_batch demuxes into the
    remote executor's execute_many superset-merge."""

    def test_mixed_indexes_preserve_slot_order(self, P):
        c = P.LocalCluster(1)
        try:
            n = c.coordinator
            _fill(P, n, "qa")
            _fill(P, n, "qb")
            out = n.query_remote_batch(_MIXED)
            assert len(out) == 3
            solo = [n.query_remote(e["index"], e["query"], e["shards"])
                    for e in _MIXED]
            assert [o["results"] for o in out] == solo
        finally:
            c.close()

    def test_bad_entry_gets_error_slot_not_batch_failure(self, P):
        c = P.LocalCluster(1)
        try:
            n = c.coordinator
            _fill(P, n, "qe")
            out = n.query_remote_batch([
                {"index": "qe", "query": "Count(Row(f=0))", "shards": [0]},
                {"index": "nope", "query": "Count(Row(f=0))",
                 "shards": [0]},
            ])
            assert "results" in out[0]
            assert out[1]["status"] == 404 and "error" in out[1]
        finally:
            c.close()


class TestBatchedClusterEndToEnd:
    def test_bit_identical_to_unbatched_oracle_with_rpc_reduction(self, P):
        oracle = P.API()
        _fill(P, oracle, "e2")
        c = P.LocalCluster(3, replica_n=2, cluster_batch={})
        try:
            co = c.coordinator
            _fill(P, co, "e2")
            queries = [f"Count(Row(f={i % 3}))" for i in range(24)]
            want = [oracle.query("e2", q) for q in queries]
            with ThreadPoolExecutor(12) as pool:
                got = list(pool.map(lambda q: co.query("e2", q), queries))
            assert got == want
            ops = co.client.op_counts
            assert ops.get("query", 0) == 0  # every read leg batched
            # 24 queries x 2 remote nodes = 48 unbatched legs; batching
            # must beat that by a wide margin
            assert 0 < ops["query_batch"] <= 24
        finally:
            c.close()

    def test_env_flag_attaches_batcher_at_construction(self, P,
                                                       monkeypatch):
        monkeypatch.setenv("PILOSA_TPU_CLUSTER_BATCH", "1")
        c = P.LocalCluster(1)
        try:
            assert isinstance(c.coordinator.batcher, P.C.NodeBatcher)
        finally:
            c.close()
        monkeypatch.delenv("PILOSA_TPU_CLUSTER_BATCH")
        c = P.LocalCluster(1)
        try:
            assert c.coordinator.batcher is None
        finally:
            c.close()

    def test_config_section_round_trips(self, P, tmp_path):
        p = tmp_path / "c.toml"
        p.write_text("[cluster.batch]\nenabled = true\nmax-batch = 7\n"
                     "window-ms = 1.5\nadaptive-window = false\n")
        cfg = P.Config.from_sources(toml_path=str(p), env={})
        assert cfg.cluster_batch_enabled is True
        assert cfg.cluster_batch_max_batch == 7
        assert cfg.cluster_batch_window_ms == 1.5
        assert cfg.cluster_batch_adaptive_window is False
        b = P.C.NodeBatcher.from_config(None, cfg)
        assert b.max_batch == 7
        assert b._arrival.adaptive is False
        assert b._arrival.fixed_window_s == pytest.approx(0.0015)

    def test_remote_leg_cache_fills_from_batch_partials(self, P):
        c = P.LocalCluster(3, cluster_batch={})
        try:
            co = c.coordinator
            _fill(P, co, "cc")
            co.enable_cache(ttl_ms=60000.0)
            q = "Count(Row(f=0))"
            want = co.query("cc", q)
            sent = co.client.op_counts.get("query_batch", 0)
            assert co.query("cc", q) == want
            # the repeat run's remote legs hit the per-leg cache entries
            # the batch RPC filled — no new wire sends
            assert co.client.op_counts.get("query_batch", 0) == sent
        finally:
            c.close()


class TestBatchedChaos:
    """FaultPlan chaos scoped op="query_batch" over batched fan-outs."""

    def _fixture(self, P, plan, **harness_kw):
        return P.LocalCluster(
            3, replica_n=2,
            client_factory=lambda i: P.C.InternalClient(retries=0,
                                                        fault_plan=plan),
            cluster_batch={}, **harness_kw)

    def test_partial_batch_failover_to_replica_rank_1(self, P):
        plan = P.C.FaultPlan()
        c = self._fixture(P, plan)
        try:
            oracle = P.API()
            _fill(P, oracle, "pf")
            co = c.coordinator
            _fill(P, co, "pf")
            q = "Count(Row(f=0))"
            want = oracle.query("pf", q)
            assert co.query("pf", q) == want  # warm, fault-free
            victim = _remote_primary(co, "pf")
            downs = []
            orig = co.executor._on_node_down
            co.executor._on_node_down = lambda nid: (downs.append(nid),
                                                     orig(nid))
            try:
                # drop exactly the next BATCH RPC to the victim: its legs
                # re-target rank 1; the other node's batch is untouched
                plan.drop(victim, first=plan.seen(victim), count=1,
                          op="query_batch")
                assert co.query("pf", q) == want
                assert downs == [victim]
            finally:
                co.executor._on_node_down = orig
                plan.clear()
            assert co.query("pf", q) == want  # healthy again
        finally:
            c.close()

    def test_breaker_veto_reroutes_whole_node_batch(self, P):
        plan = P.C.FaultPlan()
        c = self._fixture(P, plan)
        try:
            oracle = P.API()
            _fill(P, oracle, "bv")
            co = c.coordinator
            _fill(P, co, "bv")
            q = "Count(Row(f=1))"
            want = oracle.query("bv", q)
            res = co.enable_resilience(hedge=False, breaker_threshold=1,
                                       breaker_open_ms=60000.0)
            try:
                assert co.query("bv", q) == want  # warm, fault-free
                victim = _remote_primary(co, "bv")
                # park an idle pooled socket so the breaker's open
                # transition has something to evict
                assert co.client.pool._idle.get(victim)
                plan.drop(victim, first=plan.seen(victim), count=1,
                          op="query_batch")
                assert co.query("bv", q) == want  # failover opens breaker
                plan.clear()
                assert res.breaker.state(victim) == P.R.BREAKER_OPEN
                # breaker-aware eviction dropped the victim's keep-alives
                assert not co.client.pool._idle.get(victim)
                # veto at assign time: the whole node batch reroutes to
                # replicas without a single RPC reaching the victim
                before = plan.seen(victim)
                plan.delay(victim, 0.0, first=10**9)  # arm counting only
                assert co.query("bv", q) == want
                assert plan.seen(victim) == before
            finally:
                plan.clear()
                co.disable_resilience()
        finally:
            c.close()

    def test_hedged_batch_straggler_matches_oracle(self, P):
        plan = P.C.FaultPlan()
        c = P.LocalCluster(3, replica_n=2, fault_plan=plan,
                           cluster_batch={})
        try:
            oracle = P.API()
            _fill(P, oracle, "hx")
            co = c.coordinator
            _fill(P, co, "hx")
            q = "Count(Row(f=0))"
            want = oracle.query("hx", q)
            reg = P.MetricsRegistry()
            co.enable_resilience(registry=reg, hedge_min_ms=1.0,
                                 breaker_threshold=1 << 30)
            try:
                for _ in range(3):  # warm latency windows, fault-free
                    assert co.query("hx", q) == want
                victim = _remote_primary(co, "hx")
                plan.delay(victim, 2.0, op="query_batch")
                t0 = time.monotonic()
                got = co.query("hx", q)
                elapsed = time.monotonic() - t0
                plan.clear()
                assert got == want  # bit-identical despite the straggler
                assert elapsed < 1.6  # the hedged batch beat the delay
                assert reg.value(P.M.METRIC_CLUSTER_HEDGES) >= 1.0
            finally:
                plan.clear()
                co.disable_resilience()
        finally:
            c.close()


class TestCancelledLoserSpans:
    def test_hedge_loser_span_is_tagged_cancelled(self, P):
        T = P.T
        prev = T.get_tracer()
        T.set_tracer(T.Tracer(enabled=True, registry=P.MetricsRegistry()))
        try:
            res = P.C.Resilience(registry=P.MetricsRegistry(),
                                 hedge_min_ms=1.0, hedge_max_ms=1.0)
            # the hedge answers only once the primary's leg has started
            # (its span open): a primary whose worker starts after the
            # race is decided is test_late_hedge_loser_span_keeps_its_tags
            started = threading.Event()

            def run_remote(node, shards, token):
                if node == "A":  # parked primary loses to the hedge
                    started.set()
                    if token.wait(10.0):
                        raise P.C.LegCancelled("parked leg cancelled")
                assert started.wait(5.0)
                return ("part", node)

            with T.get_tracer().start_trace("q") as root:
                parts, failed = res.run_legs(
                    {"a": [1]}, {"a": "A", "b": "B"}, run_remote,
                    lambda s, r: {"b": list(s)})
            assert parts == [("part", "B")] and failed == []
            legs = {s.tags.get("node"): s for s in root.children
                    if s.name == "cluster.leg"}
            assert legs["b"].tags.get("hedge_won") is True
            loser = legs["a"]
            assert loser.tags.get("hedge_won") is False
            assert loser.tags.get("cancelled") is True  # terminal tag
        finally:
            T.set_tracer(prev)

    def test_late_hedge_loser_span_keeps_its_tags(self):
        """The port only: a primary whose worker opens its span after the
        hedge has won still gets ``hedge_won=False`` and ``cancelled``
        (the JAX package tags only spans already open)."""
        P = _pkg(TORCH)
        T = P.T
        gate = threading.Event()

        class LateTracer(T.Tracer):
            def start_span(self, name, **tags):
                if name == "cluster.leg" and tags.get("node") == "a":
                    gate.wait(5.0)  # the primary's worker starts late
                return super().start_span(name, **tags)

        prev = T.get_tracer()
        T.set_tracer(LateTracer(enabled=True, registry=P.MetricsRegistry()))
        try:
            res = P.C.Resilience(registry=P.MetricsRegistry(),
                                 hedge_min_ms=1.0, hedge_max_ms=1.0)

            def run_remote(node, shards, token):
                if node == "A" and token.wait(10.0):
                    raise P.C.LegCancelled("parked leg cancelled")
                return ("part", node)

            with T.get_tracer().start_trace("q") as root:
                parts, failed = res.run_legs(
                    {"a": [1]}, {"a": "A", "b": "B"}, run_remote,
                    lambda s, r: {"b": list(s)})
                assert parts == [("part", "B")] and failed == []
                assert not [s for s in root.children
                            if s.tags.get("node") == "a"]
                gate.set()
                deadline = time.monotonic() + 5.0
                while time.monotonic() < deadline:
                    loser = [s for s in root.children
                             if s.tags.get("node") == "a"
                             and s.duration_s is not None]
                    if loser:
                        break
                    time.sleep(0.01)
            assert loser, "the late primary never opened its span"
            assert loser[0].tags.get("hedge_won") is False
            assert loser[0].tags.get("cancelled") is True
        finally:
            gate.set()
            T.set_tracer(prev)

    def test_batched_leg_span_carries_batch_tags(self, P):
        T = P.T
        prev = T.get_tracer()
        T.set_tracer(T.Tracer(enabled=True, registry=P.MetricsRegistry()))
        try:
            fc = FakeClient()
            b = P.C.NodeBatcher(fc, registry=P.MetricsRegistry(),
                                window_ms=0.0, adaptive_window=False)
            with T.get_tracer().start_trace("q"):
                with T.get_tracer().start_span("cluster.leg",
                                               node="peer0") as leg:
                    b.run(_node(P), "i", "q0", [0])
            assert leg.tags.get("batched") is True
            assert leg.tags.get("batch_queries") == 1
            batch_spans = [s for s in leg.children
                           if s.name == "cluster.batch"]
            assert len(batch_spans) == 1
            assert batch_spans[0].tags == {"node": "peer0", "queries": 1}
        finally:
            T.set_tracer(prev)


class TestConnPool:
    def test_keepalive_reuse_across_requests(self, P):
        c = P.LocalCluster(2)
        try:
            co = c.coordinator
            _fill(P, co, "ka")
            q = "Count(Row(f=0))"
            first = co.query("ka", q)
            for _ in range(3):
                assert co.query("ka", q) == first
            pool = co.client.pool
            assert pool.hits > 0  # later legs rode pooled sockets
            # the peer's idle sockets are bounded by per_key
            assert all(len(v) <= pool.per_key
                       for v in pool._idle.values())
        finally:
            c.close()

    def test_evict_closes_idle_sockets(self, P):
        c = P.LocalCluster(2)
        try:
            co = c.coordinator
            _fill(P, co, "ev")
            co.query("ev", "Count(Row(f=0))")
            victim = next(iter(co.client.pool._idle))
            n = co.client.evict_node(victim)
            assert n >= 1
            assert not co.client.pool._idle.get(victim)
        finally:
            c.close()

    def test_stale_pooled_socket_gets_free_fresh_retry(self, P):
        c = P.LocalCluster(2)
        try:
            co = c.coordinator
            _fill(P, co, "st")
            q = "Count(Row(f=0))"
            want = co.query("st", q)
            # sabotage every idle socket: close the server side's view by
            # shutting the sockets down locally — the next use fails at
            # send/status-line and must transparently retry fresh
            for conns in co.client.pool._idle.values():
                for conn in conns:
                    if conn.sock is not None:
                        conn.sock.close()
            assert co.query("st", q) == want
        finally:
            c.close()


class TestBatchMetricsExposition:
    def test_prometheus_text_exposes_batch_series(self, P):
        M = P.M
        reg = P.MetricsRegistry()
        reg.observe_bucketed(M.METRIC_CLUSTER_BATCH_SIZE, 6.0,
                             M.CLUSTER_BATCH_SIZE_BUCKETS)
        reg.count(M.METRIC_CLUSTER_BATCHED_RPCS, node="n1")
        reg.count(M.METRIC_CLUSTER_BATCH_DEMUX_FAILURES, node="n1",
                  why="transport")
        text = reg.prometheus_text()
        assert "cluster_batch_size_bucket" in text
        assert 'cluster_batched_rpcs_total{node="n1"} 1' in text
        assert ('cluster_batch_demux_failures_total'
                '{node="n1",why="transport"} 1') in text

    def test_end_to_end_batch_rpcs_are_counted(self, P):
        M = P.M
        c = P.LocalCluster(3, cluster_batch={})
        try:
            co = c.coordinator
            _fill(P, co, "mx")
            base = M.REGISTRY.value(M.METRIC_CLUSTER_BATCHED_RPCS,
                                    node="node1") or 0.0
            co.query("mx", "Count(Row(f=0))")
            after = M.REGISTRY.value(M.METRIC_CLUSTER_BATCHED_RPCS,
                                     node="node1") or 0.0
            assert after >= base + 1.0
        finally:
            c.close()


# ---------------------------------------------------------------------------
# the two packages against each other
# ---------------------------------------------------------------------------

_WIRE_BATCHES = [
    _MIXED,
    [{"index": "qa", "query": "Row(f=1)", "shards": [0, 2, 4]},
     {"index": "qa", "query": "TopN(f, n=2)", "shards": [1, 3]},
     {"index": "qb", "query": "Count(Union(Row(f=0), Row(f=2)))",
      "shards": [0, 1, 2, 3, 4]},
     {"index": "qa", "query": "Count(Row(f=9))", "shards": []}],
    [{"index": "qa", "query": "Count(Row(f=0))", "shards": [0]},
     {"index": "nope", "query": "Count(Row(f=0))", "shards": [0]},
     {"index": "qb", "query": "Count(Row(nosuch=0))", "shards": [1]},
     {"index": "qb", "query": "Sum(field=v)", "shards": [0, 1, 2]}],
]


def _batch_node(P):
    c = P.LocalCluster(1)
    n = c.coordinator
    _fill(P, n, "qa")
    _fill(P, n, "qb")
    n.create_field("qb", "v", {"type": "int", "min": -50, "max": 5000})
    SW = P.SHARD_WIDTH
    cols = [s * SW + i for s in range(3) for i in range(0, 90, 7)]
    n.import_values("qb", "v", cols=cols,
                    values=[(c * 37) % 4000 - 40 for c in cols])
    return c


@pytest.fixture(scope="module")
def batch_nodes():
    cs = {root: _batch_node(_pkg(root)) for root in (JAX, TORCH)}
    yield cs
    for c in cs.values():
        c.close()


@pytest.mark.parametrize("which", range(len(_WIRE_BATCHES)))
def test_query_remote_batch_wire_json_equal_across_packages(batch_nodes,
                                                            which):
    batch = _WIRE_BATCHES[which]
    got = [json.dumps(batch_nodes[r].coordinator.query_remote_batch(batch),
                      sort_keys=True) for r in (JAX, TORCH)]
    assert got[0] == got[1]


def _post(uri, path, body):
    req = urllib.request.Request(
        uri + path, data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_query_batch_route_equal_across_packages(batch_nodes):
    bodies = [_post(batch_nodes[r].coordinator.node.uri,
                    "/internal/query-batch",
                    {"queries": _WIRE_BATCHES[1] + _WIRE_BATCHES[2],
                     "remote": True}) for r in (JAX, TORCH)]
    assert bodies[0][0] == 200
    assert bodies[0] == bodies[1]


def test_query_batch_route_404s_on_a_plain_api():
    outs = []
    for root in (JAX, TORCH):
        P = _pkg(root)
        srv, _ = P.serve(P.API(), port=0, background=True)
        try:
            host, port = srv.server_address[:2]
            outs.append(_post(f"http://{host}:{port}",
                              "/internal/query-batch",
                              {"queries": _MIXED}))
        finally:
            srv.shutdown()
            srv.server_close()
    assert outs[0][0] == 404
    assert outs[0] == outs[1]
