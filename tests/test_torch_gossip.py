"""Cluster metadata gossip, run once per package, and the two packages'
gossip planes held against each other.

The ``P`` fixture yields the modules of ``pilosa_tpu`` or of their
``pilosa_tpu_torch`` counterparts; ``P.API()`` and ``P.LocalCluster``
build the port's with ``device="cpu"``. Covered:

* every case of ``tests/test_gossip.py`` (the ``GossipState`` table, the
  agent's seeded rounds, op-scoped fault rules, breaker sharing, a
  cluster's convergence, exact remote-leg cache invalidation with the
  TTL at 0, piggybacked envelopes, the HTTP routes and the metrics),
  once per package;
* across the packages, equal: a ``GossipState``'s digests,
  ``deltas_since`` windows, ``apply`` counts, fingerprints and tables
  over seeded random sequences of bumps, applies and clock steps; and
  the envelopes of three agents under a ``ManualClock`` and one seed,
  byte for byte, round after round.

Every case holds for any ``PILOSA_TPU_GOSSIP_SEED``: the seed only
steers which peer a round contacts, and the cases that pin exchange
sequences build their agents with explicit seeds.
"""

import importlib
import json
import random
import types
import urllib.request

import pytest

JAX, TORCH = "pilosa_tpu", "pilosa_tpu_torch"


def _load(root: str) -> types.SimpleNamespace:
    m = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    kw = {"device": "cpu"} if root == TORCH else {}
    api_cls = m("api").API
    cluster = m("cluster")
    res = m("cluster.resilience")
    return types.SimpleNamespace(
        root=root,
        API=lambda *a, **k: api_cls(*a, **{**kw, **k}),
        LocalCluster=lambda *a, **k: cluster.LocalCluster(*a, **{**kw, **k}),
        CircuitBreaker=cluster.CircuitBreaker,
        FaultPlan=cluster.FaultPlan,
        GossipAgent=cluster.GossipAgent,
        GossipState=cluster.GossipState,
        InjectedFault=cluster.InjectedFault,
        NodeDownError=cluster.NodeDownError,
        BREAKER_CLOSED=res.BREAKER_CLOSED,
        BREAKER_HALF_OPEN=res.BREAKER_HALF_OPEN,
        BREAKER_OPEN=res.BREAKER_OPEN,
        Node=m("cluster.topology").Node,
        Config=m("config").Config,
        _reset_ttl_warning=m("gossip")._reset_ttl_warning,
        M=m("obs.metrics"),
        MetricsRegistry=m("obs.metrics").MetricsRegistry,
        ManualClock=m("sched").ManualClock,
        SHARD_WIDTH=m("shardwidth").SHARD_WIDTH,
    )


_PACKAGES = {}


def _pkg(root):
    if root not in _PACKAGES:
        _PACKAGES[root] = _load(root)
    return _PACKAGES[root]


@pytest.fixture(params=[JAX, TORCH], ids=["jax", "torch"])
def P(request):
    return _pkg(request.param)


# -- the cases of tests/test_gossip.py, once per package ----------------------


def _state(P, node_id="A", **kw):
    kw.setdefault("clock", P.ManualClock())
    kw.setdefault("registry", P.MetricsRegistry())
    return P.GossipState(node_id, **kw)


class TestGossipState:
    def test_bump_assigns_monotone_seqs_and_dedups_unchanged(self, P):
        st = _state(P)
        assert st.bump_local(("f", "i", "f1", 0), [1, 5]) is True
        assert st.bump_local(("f", "i", "f1", 0), [1, 5]) is False  # same
        assert st.bump_local(("f", "i", "f1", 0), [1, 6]) is True
        assert st.digest() == {"A": 2}
        assert len(st) == 1  # re-bump replaces, never accumulates

    def test_deltas_since_windows_and_digest(self, P):
        st = _state(P)
        for i in range(4):
            st.bump_local(("f", "i", "f1", i), [1, 1])
        assert [d["s"] for d in st.deltas_since({})] == [1, 2, 3, 4]
        assert [d["s"] for d in st.deltas_since({"A": 2})] == [3, 4]
        assert st.deltas_since({"A": 4}) == []

    def test_cap_truncation_keeps_lowest_seqs(self, P):
        # complete-window invariant: a truncated batch must be the LOW
        # end of the window, so the receiver's digest never advances
        # past an entry it missed
        st = _state(P)
        for i in range(10):
            st.bump_local(("f", "i", "f1", i), [1, 1])
        got = st.deltas_since({}, cap=3)
        assert [d["s"] for d in got] == [1, 2, 3]

    def test_apply_is_idempotent_and_newest_wins(self, P):
        a, b = _state(P, "A"), _state(P, "B")
        a.bump_local(("h", "A"), "up")
        deltas = a.deltas_since({})
        assert b.apply(deltas) == 1
        assert b.apply(deltas) == 0  # replay: no-op
        a.bump_local(("h", "A"), "down")
        newer = a.deltas_since({})
        assert b.apply(newer + deltas) == 1  # stale entry loses
        (ent,) = b.entries_json()["A"].values()
        assert ent["v"] == "down"

    def test_apply_skips_own_origin(self, P):
        a = _state(P, "A")
        echoed = [{"o": "A", "k": ["h", "A"], "v": "up", "s": 9, "t": 0.0}]
        assert a.apply(echoed) == 0
        assert a.digest() == {}

    def test_remote_fingerprint_filters_and_tracks_seqs(self, P):
        a, b = _state(P, "A"), _state(P, "B")
        a.bump_local(("f", "i", "f1", 0), [1, 5])
        a.bump_local(("f", "i", "f1", 3), [1, 5])  # shard outside set
        a.bump_local(("f", "other", "f1", 0), [1, 5])  # other index
        b.apply(a.deltas_since({}))
        b.bump_local(("f", "i", "f1", 0), [1, 7])
        fp = b.remote_fingerprint("i", [0, 1])
        assert fp == (("A", "f1", 0, 1), ("B", "f1", 0, 1))
        before = fp
        b.apply([{"o": "A", "k": ["f", "i", "f1", 0], "v": [1, 9],
                  "s": 4, "t": 0.0}])
        assert b.remote_fingerprint("i", [0, 1]) != before

    def test_refresh_index_tracks_real_writes(self, P):
        api = P.API()
        api.create_index("ri")
        api.create_field("ri", "f")
        st = _state(P, "A")
        idx = api.holder.indexes["ri"]
        assert st.refresh_index(idx) == 0  # no fragments yet
        api.import_bits("ri", "f", rows=[1], cols=[5])
        assert st.refresh_index(idx) >= 1
        fp1 = st.remote_fingerprint("ri", [0])
        assert st.refresh_index(idx) == 0  # no change, no bump
        api.import_bits("ri", "f", rows=[1], cols=[6])
        assert st.refresh_index(idx) >= 1
        assert st.remote_fingerprint("ri", [0]) != fp1


def _mknodes(P, n):
    return [P.Node(id=f"node{i}", uri="") for i in range(n)]


class _LoopNet:
    """In-process transport: routes gossip exchanges straight between
    agents (no HTTP), recording the exchange trace."""

    def __init__(self):
        self.agents = {}
        self.trace = []

    def gossip_exchange(self, node, payload):
        env = payload["gossip"]
        self.trace.append((env["from"], node.id))
        peer = self.agents[node.id]
        peer.receive(env)
        return {"gossip": peer.envelope(env["from"])}


def _mkagents(P, n, seed=11, clock=None, net=None):
    net = net or _LoopNet()
    clock = clock or P.ManualClock()
    nodes = _mknodes(P, n)
    agents = []
    for node in nodes:
        holder = types.SimpleNamespace(indexes={})
        ag = P.GossipAgent(
            node.id, net, lambda nid=node.id: [x for x in nodes
                                               if x.id != nid],
            holder, seed=seed, clock=clock, registry=P.MetricsRegistry())
        net.agents[node.id] = ag
        agents.append(ag)
    return agents, net


class TestGossipAgent:
    def test_roundtrip_then_silent(self, P):
        agents, net = _mkagents(P, 2)
        a, b = agents
        a.state.bump_local(("h", "node0"), "up")
        assert a.run_round() == 0  # pushes; B had nothing for us
        assert b.state.digest() == {"node0": 1}
        # B now holds and advertises node0@1; next round ships nothing
        env = a.envelope("node1")
        assert env["deltas"] == []

    def test_transitive_relay(self, P):
        # A -> B -> C without A ever talking to C
        agents, net = _mkagents(P, 3)
        a, b, c = agents
        a.state.bump_local(("h", "node0"), "up")
        net.trace.clear()
        b.receive(a.envelope(None))
        c.receive(b.envelope(None))
        assert c.state.digest().get("node0") == 1

    def test_seeded_peer_choice_is_deterministic(self, P):
        traces = []
        for _ in range(2):
            agents, net = _mkagents(P, 4, seed=5)
            for _ in range(6):
                for ag in agents:
                    ag.run_round()
            traces.append(list(net.trace))
        assert traces[0] == traces[1]
        # a different seed picks a different exchange sequence
        agents, net2 = _mkagents(P, 4, seed=6)
        for _ in range(6):
            for ag in agents:
                ag.run_round()
        assert net2.trace != traces[0]

    def test_rounds_deterministic_under_manual_clock(self, P):
        # full determinism: same seed + ManualClock => byte-identical
        # final state tables (stamps included)
        finals = []
        for _ in range(2):
            agents, _ = _mkagents(P, 3, seed=9, clock=P.ManualClock())
            agents[0].state.bump_local(("f", "i", "f1", 0), [1, 2])
            agents[1].state.bump_local(("f", "i", "f1", 1), [1, 4])
            for ag in agents:
                ag.run_round()
            finals.append([json.dumps(ag.state_json(), sort_keys=True)
                           for ag in agents])
        assert finals[0] == finals[1]

    def test_env_seed_default(self, P, monkeypatch):
        monkeypatch.setenv("PILOSA_TPU_GOSSIP_SEED", "42")
        ag = P.GossipAgent("x", None, lambda: [],
                           types.SimpleNamespace(indexes={}),
                           registry=P.MetricsRegistry())
        assert ag.seed == 42

    def test_idle_round_without_peers(self, P):
        reg = P.MetricsRegistry()
        ag = P.GossipAgent("x", None, lambda: [],
                           types.SimpleNamespace(indexes={}),
                           clock=P.ManualClock(), registry=reg)
        assert ag.run_round() == 0
        assert reg.value(P.M.METRIC_GOSSIP_ROUNDS, outcome="idle") == 1.0

    def test_round_survives_down_peer(self, P):
        class _DeadNet:
            def gossip_exchange(self, node, payload):
                raise P.NodeDownError("down")

        reg = P.MetricsRegistry()
        ag = P.GossipAgent("x", _DeadNet(), lambda: _mknodes(P, 2)[1:],
                           types.SimpleNamespace(indexes={}),
                           clock=P.ManualClock(), registry=reg)
        assert ag.run_round() == 0
        assert reg.value(P.M.METRIC_GOSSIP_ROUNDS, outcome="err") == 1.0

    def test_from_config_maps_fields(self, P):
        cfg = P.Config(gossip_interval_ms=7.0, gossip_fanout=2,
                       gossip_seed=13, gossip_max_deltas=99,
                       gossip_piggyback=False)
        ag = P.GossipAgent.from_config(
            "x", None, lambda: [], types.SimpleNamespace(indexes={}),
            cfg, registry=P.MetricsRegistry())
        assert (ag.interval_ms, ag.fanout, ag.seed, ag.max_deltas,
                ag.piggyback) == (7.0, 2, 13, 99, False)


class TestFaultPlanOps:
    def test_op_scoped_rule_only_matches_its_op(self, P):
        plan = P.FaultPlan(seed=1)
        plan.drop("n1", op="gossip")
        with pytest.raises(P.InjectedFault):
            plan.on_request("n1", op="gossip")
        plan.on_request("n1", op="query")  # unscoped op passes
        plan.on_request("n1")  # untagged request passes

    def test_unscoped_rule_still_matches_everything(self, P):
        # backward compatibility: pre-op rules and positional calls
        plan = P.FaultPlan(seed=1)
        plan.drop("n1")
        with pytest.raises(P.InjectedFault):
            plan.on_request("n1")
        with pytest.raises(P.InjectedFault):
            plan.on_request("n1", op="gossip")

    def test_op_scoping_at_the_client_boundary(self, P):
        # drop gossip exchanges only: queries keep working while the
        # anti-entropy channel is down
        plan = P.FaultPlan(seed=1).drop("node1", op="gossip")
        c = P.LocalCluster(2, fault_plan=plan)
        try:
            co = c.coordinator
            co.create_index("fo")
            co.create_field("fo", "f")
            cols = list(range(0, 4 * P.SHARD_WIDTH, P.SHARD_WIDTH // 2))
            co.import_bits("fo", "f", rows=[1] * len(cols), cols=cols)
            c.enable_gossip(registry=P.MetricsRegistry())
            n = co.query("fo", "Count(Row(f=1))")[0]
            assert n == len(cols)
            ag = co.gossip
            peer = c[1].node
            with pytest.raises(P.NodeDownError):
                ag.client.gossip_exchange(peer, {"gossip": ag.envelope(None)})
        finally:
            c.close()


class TestBreakerSharing:
    def _mk(self, P):
        clk = P.ManualClock()
        events = []
        br = P.CircuitBreaker(threshold=3, open_s=2.0, clock=clk,
                              registry=P.MetricsRegistry())
        br.add_listener(lambda nid, frm, to: events.append((nid, frm, to)))
        return br, clk, events

    def test_apply_remote_open_prewarm_and_countdown(self, P):
        br, clk, events = self._mk(P)
        assert br.apply_remote("n2", P.BREAKER_OPEN) is True
        assert br.state("n2") == P.BREAKER_OPEN
        assert events == []  # remote applies never notify listeners
        assert br.allow("n2") is False
        clk.advance(2.5)  # OUR open_s countdown gates OUR probe
        assert br.allow("n2") is True
        assert br.state("n2") == P.BREAKER_HALF_OPEN

    def test_half_open_gossip_adopted_as_open(self, P):
        br, clk, _ = self._mk(P)
        assert br.apply_remote("n2", P.BREAKER_HALF_OPEN) is True
        assert br.state("n2") == P.BREAKER_OPEN

    def test_remote_close_only_reverts_remote_state(self, P):
        br, clk, _ = self._mk(P)
        # locally earned open: a peer's recovery claim must not close it
        for _ in range(3):
            br.record_failure("n2")
        assert br.state("n2") == P.BREAKER_OPEN
        assert br.apply_remote("n2", P.BREAKER_CLOSED) is False
        assert br.state("n2") == P.BREAKER_OPEN
        # remote-warmed open: the same peer's close reverts it
        br.apply_remote("n3", P.BREAKER_OPEN)
        assert br.apply_remote("n3", P.BREAKER_CLOSED) is True
        assert br.state("n3") == P.BREAKER_CLOSED

    def test_local_evidence_overrides_remote_warm(self, P):
        br, clk, _ = self._mk(P)
        br.apply_remote("n2", P.BREAKER_OPEN)
        clk.advance(2.5)
        assert br.allow("n2")  # half-open probe
        br.record_success("n2")  # our own probe succeeded
        assert br.state("n2") == P.BREAKER_CLOSED
        # now a stale remote close is a no-op (slot is locally owned)
        assert br.apply_remote("n2", P.BREAKER_CLOSED) is False

    def test_local_transitions_notify_listeners(self, P):
        br, clk, events = self._mk(P)
        for _ in range(3):
            br.record_failure("n2")
        assert events == [("n2", P.BREAKER_CLOSED, P.BREAKER_OPEN)]

    def test_remote_open_when_already_open_is_noop(self, P):
        br, clk, _ = self._mk(P)
        br.apply_remote("n2", P.BREAKER_OPEN)
        t0 = clk.now()
        clk.advance(1.0)
        assert br.apply_remote("n2", P.BREAKER_OPEN) is False  # keep countdown


def _fill(P, cluster, index, n_shards=4, row=3):
    co = cluster.coordinator
    co.create_index(index)
    co.create_field(index, "f")
    cols = list(range(0, n_shards * P.SHARD_WIDTH, P.SHARD_WIDTH // 4))
    co.import_bits(index, "f", rows=[row] * len(cols), cols=cols)
    return len(cols)


def _owner_with_shards(P, cluster, index):
    for node in cluster.nodes[1:]:
        idx = node.api.holder.indexes.get(index)
        if idx is not None and idx.shards():
            return node
    pytest.skip("placement put no shards on a non-coordinator")


class TestClusterGossip:
    def test_convergence_to_identical_state(self, P):
        c = P.LocalCluster(3)
        try:
            _fill(P, c, "cv")
            c.enable_gossip(registry=P.MetricsRegistry())
            # fanout=1: N-1 sequential full sweeps bound convergence
            c.run_gossip_rounds(len(c) + 1)
            digests = [n.gossip.state.digest() for n in c.nodes]
            assert digests[0] == digests[1] == digests[2]
            tables = [json.dumps(
                {o: {k: {kk: vv for kk, vv in e.items() if kk != "t"}
                     for k, e in tab.items()}
                 for o, tab in n.gossip.state.entries_json().items()},
                sort_keys=True) for n in c.nodes]
            assert tables[0] == tables[1] == tables[2]
        finally:
            c.close()

    def test_convergence_under_drops_delays_flaps(self, P):
        plan = (P.FaultPlan(seed=2)
                .drop("node1", count=6, op="gossip")
                .delay("node2", 0.005, count=4, op="gossip")
                .flap("node0", period=3, op="gossip"))
        c = P.LocalCluster(3, fault_plan=plan)
        try:
            _fill(P, c, "cf")
            c.enable_gossip(registry=P.MetricsRegistry())
            # drops cost whole exchanges; give the sweep extra rounds
            c.run_gossip_rounds(3 * len(c))
            digests = [n.gossip.state.digest() for n in c.nodes]
            assert digests[0] == digests[1] == digests[2]
        finally:
            c.close()

    def test_exact_invalidation_zero_ttl(self, P):
        # the acceptance scenario: write on node B (never through the
        # coordinator), coordinator's cached remote leg invalidates
        # after convergence, with the TTL knob at 0 the whole time
        c = P.LocalCluster(2)
        try:
            n = _fill(P, c, "xi")
            c.enable_gossip(registry=P.MetricsRegistry())
            c.run_gossip_rounds(3)
            co = c.coordinator
            cache = co.enable_cache(ttl_ms=0, registry=P.MetricsRegistry())
            assert cache.ttl_ms == 0
            assert co.query("xi", "Count(Row(f=3))")[0] == n
            assert co.query("xi", "Count(Row(f=3))")[0] == n
            assert any(k[0] == "rlegg" for k in cache._entries)
            assert not any(k[0] == "rleg" for k in cache._entries)
            hits = cache.stats()["hits"]
            assert hits >= 1  # remote leg served from cache
            owner = _owner_with_shards(P, c, "xi")
            shard = sorted(owner.api.holder.indexes["xi"].shards())[0]
            owner.api.import_bits("xi", "f", rows=[3],
                                  cols=[shard * P.SHARD_WIDTH + 999])
            owner._announce_shards("xi")
            c.run_gossip_rounds(3)
            assert co.query("xi", "Count(Row(f=3))")[0] == n + 1
        finally:
            c.close()

    def test_write_through_invalidates_immediately(self, P):
        # a coordinator-forwarded write's response envelope carries the
        # owner's new versions, so the next read is fresh with ZERO
        # anti-entropy rounds
        c = P.LocalCluster(2)
        try:
            n = _fill(P, c, "wt")
            c.enable_gossip(registry=P.MetricsRegistry())
            c.run_gossip_rounds(3)
            co = c.coordinator
            co.enable_cache(ttl_ms=0, registry=P.MetricsRegistry())
            assert co.query("wt", "Count(Row(f=3))")[0] == n
            owner = _owner_with_shards(P, c, "wt")
            shard = sorted(owner.api.holder.indexes["wt"].shards())[0]
            co.import_bits("wt", "f", rows=[3],
                           cols=[shard * P.SHARD_WIDTH + 999])
            # no run_gossip_rounds on purpose
            assert co.query("wt", "Count(Row(f=3))")[0] == n + 1
        finally:
            c.close()

    def test_piggyback_spreads_without_rounds(self, P):
        c = P.LocalCluster(2)
        try:
            _fill(P, c, "pb")
            c.enable_gossip(registry=P.MetricsRegistry())
            co = c.coordinator
            # a single fan-out query piggybacks envelopes both ways
            co.query("pb", "Count(Row(f=3))")
            other = c[1]
            assert co.node.id in other.gossip.state.digest() or \
                other.node.id in co.gossip.state.digest()
        finally:
            c.close()

    def test_breaker_prewarm_across_cluster(self, P):
        # node1 ends up open for a target it never failed against
        c = P.LocalCluster(2)
        try:
            _fill(P, c, "bp")
            c.enable_gossip(registry=P.MetricsRegistry())
            reg0, reg1 = P.MetricsRegistry(), P.MetricsRegistry()
            res0 = c[0].enable_resilience(registry=reg0)
            res1 = c[1].enable_resilience(registry=reg1)
            for _ in range(3):
                res0.breaker.record_failure("nodeX")
            assert res0.breaker.state("nodeX") == P.BREAKER_OPEN
            c.run_gossip_rounds(3)
            assert res1.breaker.state("nodeX") == P.BREAKER_OPEN
            assert reg1.value(P.M.METRIC_GOSSIP_BREAKER_PREWARMS,
                              node="nodeX") >= 1.0
        finally:
            c.close()

    def test_prewarm_never_applies_to_self(self, P):
        c = P.LocalCluster(2)
        try:
            _fill(P, c, "ps")
            c.enable_gossip(registry=P.MetricsRegistry())
            res0 = c[0].enable_resilience(registry=P.MetricsRegistry())
            res1 = c[1].enable_resilience(registry=P.MetricsRegistry())
            # node0 thinks node1 is down; node1 must not open a breaker
            # for ITSELF off that gossip
            for _ in range(3):
                res0.breaker.record_failure("node1")
            c.run_gossip_rounds(3)
            assert res1.breaker.state("node1") == P.BREAKER_CLOSED
        finally:
            c.close()

    def test_ttl_deprecation_warns_once(self, P):
        P._reset_ttl_warning()
        c = P.LocalCluster(2)
        try:
            c.enable_gossip(registry=P.MetricsRegistry())
            with pytest.warns(DeprecationWarning, match="ttl-ms"):
                c[0].enable_cache(ttl_ms=500, registry=P.MetricsRegistry())
            # second enable: warning already spent
            import warnings as _w

            with _w.catch_warnings():
                _w.simplefilter("error")
                c[1].enable_cache(ttl_ms=500, registry=P.MetricsRegistry())
        finally:
            P._reset_ttl_warning()
            c.close()

    def test_state_endpoint_over_http(self, P):
        c = P.LocalCluster(2)
        try:
            _fill(P, c, "se")
            c.enable_gossip(registry=P.MetricsRegistry())
            c.run_gossip_rounds(2)
            uri = c[0].node.uri + "/internal/gossip/state"
            with urllib.request.urlopen(uri, timeout=10) as resp:
                out = json.loads(resp.read())
            assert out["enabled"] is True
            assert out["node"] == "node0"
            assert "node0" in out["entries"]
            assert out["digest"]
        finally:
            c.close()

    def test_state_endpoint_reports_disabled(self, P):
        c = P.LocalCluster(1)
        try:
            uri = c[0].node.uri + "/internal/gossip/state"
            with urllib.request.urlopen(uri, timeout=10) as resp:
                assert json.loads(resp.read()) == {"enabled": False}
        finally:
            c.close()

    def test_exchange_endpoint_round_trips(self, P):
        c = P.LocalCluster(2)
        try:
            _fill(P, c, "xe")
            c.enable_gossip(registry=P.MetricsRegistry())
            ag0 = c[0].gossip
            req = urllib.request.Request(
                c[1].node.uri + "/internal/gossip/exchange",
                data=json.dumps({"gossip": ag0.envelope(None)}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=10) as resp:
                out = json.loads(resp.read())
            assert out["enabled"] is True
            assert out["gossip"]["from"] == "node1"
            # the peer now holds our digest
            assert "node0" in c[1].gossip.state.digest()
        finally:
            c.close()

    def test_disable_gossip_detaches_everything(self, P):
        c = P.LocalCluster(2)
        try:
            _fill(P, c, "dg")
            c.enable_gossip(registry=P.MetricsRegistry())
            co = c.coordinator
            assert co.gossip is not None
            assert co.client.gossip is not None
            co.disable_gossip()
            assert co.gossip is None
            assert co.client.gossip is None
            # gossip-off keeps the pre-gossip cache behavior intact
            cache = co.enable_cache(ttl_ms=0, registry=P.MetricsRegistry())
            co.query("dg", "Count(Row(f=3))")
            assert not any(k[0] in ("rleg", "rlegg")
                           for k in cache._entries)
        finally:
            c.close()


class TestGossipMetrics:
    def test_exposition_contains_gossip_series(self, P):
        agents, _ = _mkagents(P, 2, seed=3)
        a, b = agents
        a.state.bump_local(("h", "node0"), "up")
        a.run_round()
        b.run_round()
        text = a.registry.prometheus_text()
        for name in (P.M.METRIC_GOSSIP_ROUNDS, P.M.METRIC_GOSSIP_DELTAS_SENT,
                     P.M.METRIC_GOSSIP_ENTRIES, P.M.METRIC_GOSSIP_ROUND_MS):
            assert name in text, name

    def test_staleness_histogram_observes_applies(self, P):
        clk = P.ManualClock()
        reg = P.MetricsRegistry()
        a = P.GossipState("A", clock=clk, registry=reg)
        b = P.GossipState("B", clock=clk, registry=reg)
        a.bump_local(("h", "A"), "up")
        deltas = a.deltas_since({})
        clk.advance(0.5)  # the delta is 500ms old when it lands
        b.apply(deltas)
        h = reg.histogram(P.M.METRIC_GOSSIP_STALENESS_MS)
        assert h["count"] == 1
        assert h["sum"] == pytest.approx(500.0, rel=0.01)


# -- the two packages against each other --------------------------------------


_KINDS = ("f", "b", "h", "m", "c", "t")


def _random_key(rng):
    kind = rng.choice(_KINDS)
    if kind == "f":
        return ("f", rng.choice(["i", "j"]), rng.choice(["f1", "f2"]),
                rng.randrange(4))
    if kind in ("b", "h", "m"):
        return (kind, f"node{rng.randrange(3)}")
    return (kind, rng.randrange(3))


def _random_value(rng, key):
    if key[0] == "f":
        return [rng.randrange(1, 3), rng.randrange(6)]
    if key[0] == "m":
        return [rng.choice(["alive", "suspect", "down"]), rng.randrange(3)]
    if key[0] == "b":
        return rng.choice(["open", "closed", "half-open"])
    return rng.choice(["up", "x", "y"])


def _state_view(st, now):
    return json.dumps({
        "digest": st.digest(),
        "entries": st.entries_json(),
        "len": len(st),
        "ages": st.origin_ages(now),
        "kinds": [st.entries_of_kind(k) for k in _KINDS],
        "fp": [st.remote_fingerprint(i, s) for i in ("i", "j")
               for s in ([0], [1, 2], range(4))],
        "frag": [{o: sorted(v.items()) for o, v in
                  st.fragment_entries(i).items()} for i in ("i", "j")],
    }, sort_keys=True, default=str)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_state_tables_equal_across_packages(seed):
    """Three states per package (origins A, B, C) under one seeded
    sequence of bumps, truncated delta transfers and clock steps: every
    digest, window, apply count and table is the JAX package's."""
    Js, Ts = _pkg(JAX), _pkg(TORCH)
    rng = random.Random(f"gossip-parity:{seed}")
    sides = []
    for pk in (Js, Ts):
        clock = pk.ManualClock()
        reg = pk.MetricsRegistry()
        sides.append((clock, {o: pk.GossipState(o, clock=clock, registry=reg)
                              for o in ("A", "B", "C")}, reg))
    for step in range(160):
        op = rng.random()
        if op < 0.45:
            origin = rng.choice("ABC")
            key = _random_key(rng)
            value = _random_value(rng, key)
            got = [s[origin].bump_local(key, value) for _, s, _ in sides]
        elif op < 0.85:
            src, dst = rng.sample("ABC", 2)
            cap = rng.choice([1, 3, 512])
            watermark = {o: rng.randrange(0, 4) for o in "ABC"
                         if rng.random() < 0.3}
            got = []
            for _, s, _ in sides:
                seen = dict(s[dst].digest(), **watermark)
                window = s[src].deltas_since(seen, cap)
                got.append((json.dumps(window, sort_keys=True),
                            s[dst].apply(window)))
        else:
            dt = rng.choice([0.001, 0.25, 1.5])
            for clock, _, _ in sides:
                clock.advance(dt)
            got = [clock.now() for clock, _, _ in sides]
        assert got[0] == got[1], (seed, step)
        now = sides[0][0].now()
        views = [{o: _state_view(s[o], now) for o in "ABC"}
                 for _, s, _ in sides]
        assert views[0] == views[1], (seed, step)
    regs = [reg.prometheus_text() for _, _, reg in sides]
    assert regs[0] == regs[1]


class _Net:
    """In-process transport between one package's agents, recording
    every envelope it carries as JSON."""

    def __init__(self):
        self.agents = {}
        self.wire = []

    def gossip_exchange(self, node, payload):
        env = payload["gossip"]
        self.wire.append(json.dumps(payload, sort_keys=True))
        peer = self.agents[node.id]
        peer.receive(env)
        out = {"gossip": peer.envelope(env["from"])}
        self.wire.append(json.dumps(out, sort_keys=True))
        return out


@pytest.mark.parametrize("seed", [3, 11])
def test_envelopes_equal_byte_for_byte(seed):
    """Three agents per package, one seed, one ``ManualClock`` each:
    the same local bumps between rounds, and every envelope on the wire,
    every state_json and every metric equal across the packages."""
    runs = []
    for pk in (_pkg(JAX), _pkg(TORCH)):
        net, clock, reg = _Net(), pk.ManualClock(), pk.MetricsRegistry()
        nodes = [pk.Node(id=f"node{i}", uri="") for i in range(3)]
        agents = []
        for node in nodes:
            ag = pk.GossipAgent(
                node.id, net,
                lambda nid=node.id: [x for x in nodes if x.id != nid],
                types.SimpleNamespace(indexes={}), seed=seed, clock=clock,
                registry=reg, max_deltas=4)
            net.agents[node.id] = ag
            agents.append(ag)
        rng = random.Random(f"envelopes:{seed}")
        states = []
        for rnd in range(12):
            for i, ag in enumerate(agents):
                key = _random_key(rng)
                ag.state.bump_local(key, _random_value(rng, key))
                if rng.random() < 0.3:
                    ag.record_breaker(f"node{(i + 1) % 3}",
                                      rng.choice(["open", "closed"]))
                ag.run_round()
            clock.advance(0.1)
            states.append([json.dumps(ag.state_json(), sort_keys=True)
                           for ag in agents])
        runs.append((net.wire, states, reg.prometheus_text()))
    assert runs[0][0] == runs[1][0]
    assert runs[0][1] == runs[1][1]
    assert runs[0][2] == runs[1][2]


@pytest.mark.parametrize("section,keys", [
    ("gossip", {"interval_ms": 7.0, "fanout": 2, "seed": 13,
                "max_deltas": 99, "piggyback": False}),
    ("membership", {"interval_ms": 250.0, "ping_timeout_ms": 50.0,
                    "indirect_k": 3, "suspect_mult": 4.0,
                    "flap_window_s": 9.0})])
def test_enabled_key_waits_for_a_server_that_reads_it(tmp_path, section,
                                                        keys):
    """Nothing reads ``gossip-enabled`` or ``membership-enabled`` yet
    (ROADMAP C.16), so the port's ``Config`` has no field for them; a
    file and an environment that set one load the section's other keys
    as the JAX package's do."""
    import dataclasses

    jcfg = importlib.import_module(f"{JAX}.config").Config
    tcfg = importlib.import_module(f"{TORCH}.config").Config
    enabled = f"{section}_enabled"
    assert enabled in {f.name for f in dataclasses.fields(jcfg)}
    assert enabled not in {f.name for f in dataclasses.fields(tcfg)}
    toml = tmp_path / "c.toml"
    toml.write_text(f"[{section}]\nenabled = true\n" + "".join(
        f"{k.replace('_', '-')} = {json.dumps(v)}\n" for k, v in keys.items()))
    env = {f"PILOSA_TPU_{section.upper()}_ENABLED": "true",
           "PILOSA_TPU_WAL_SYNC": "always"}
    t = tcfg.from_sources(toml_path=str(toml), env=env)
    j = jcfg.from_sources(toml_path=str(toml), env=env)
    got = {k: getattr(t, f"{section}_{k}") for k in keys}
    assert got == {k: getattr(j, f"{section}_{k}") for k in keys} == keys
    assert t.wal_sync == j.wal_sync == "always"
