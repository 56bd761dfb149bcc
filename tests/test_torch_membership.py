"""SWIM membership, run once per package, and the two packages'
membership held against each other.

The ``P`` fixture yields the modules of ``pilosa_tpu`` or of their
``pilosa_tpu_torch`` counterparts; ``P.API()`` and ``P.LocalCluster``
build the port's with ``device="cpu"``. Covered:

* every case of ``tests/test_membership.py`` (the merged view's
  precedence, refutation, direct and indirect probes, the suspect
  timeout, ``GossipDisCo``, ``FaultPlan`` partitions, the translate
  outbox, and 3-node clusters through a clean split, an asymmetric
  ping cut, a coordinator cut off and a paused node), once per package;
* across the packages, equal: under a ``ManualClock`` and one seed, a
  3-node cluster of each package through rounds, a pause of node 2, its
  refutations while it still sends, its confirmation once silent, its
  unpause and rejoin, with every node's ``members_json`` and
  incarnation equal after every node's round.

Every case holds for any ``PILOSA_TPU_FAULT_SEED``: partition rules are
deterministic cuts, and the cases that pin probe sequences build their
plans and agents with explicit seeds.
"""

import importlib
import json
import threading
import types
import urllib.request

import pytest

JAX, TORCH = "pilosa_tpu", "pilosa_tpu_torch"


def _load(root: str) -> types.SimpleNamespace:
    m = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    kw = {"device": "cpu"} if root == TORCH else {}
    api_cls = m("api").API
    cluster = m("cluster")
    gossip = m("gossip")
    return types.SimpleNamespace(
        root=root,
        API=lambda *a, **k: api_cls(*a, **{**kw, **k}),
        LocalCluster=lambda *a, **k: cluster.LocalCluster(*a, **{**kw, **k}),
        FaultPlan=cluster.FaultPlan,
        GossipDisCo=cluster.GossipDisCo,
        GossipState=cluster.GossipState,
        InjectedFault=cluster.InjectedFault,
        InMemDisCo=cluster.InMemDisCo,
        Node=cluster.Node,
        NodeDownError=cluster.NodeDownError,
        InternalClient=m("cluster.client").InternalClient,
        ClusterSnapshot=m("cluster.topology").ClusterSnapshot,
        ClusterTranslator=m("cluster.translator").ClusterTranslator,
        KIND_CONTROL=gossip.KIND_CONTROL,
        KIND_MEMBER=gossip.KIND_MEMBER,
        KIND_TRANSLATE=gossip.KIND_TRANSLATE,
        MEMBER_ALIVE=gossip.MEMBER_ALIVE,
        MEMBER_DOWN=gossip.MEMBER_DOWN,
        MEMBER_SUSPECT=gossip.MEMBER_SUSPECT,
        Membership=gossip.Membership,
        PingToken=m("gossip.membership").PingToken,
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


# -- the cases of tests/test_membership.py, once per package ------------------




def _mknodes(P, n):
    return [P.Node(id=f"node{i}", uri="") for i in range(n)]


class _ScriptClient:
    """Scripted membership_ping transport for protocol unit tests.

    ``ok[target_id]`` scripts the direct ping to that node;
    ``ok[("via", relay_id, target_id)]`` scripts a relay's onward probe
    (falls back to ``ok[target_id]``). Unlisted targets answer ok."""

    def __init__(self, P, ok=None):
        self.P = P
        self.ok = dict(ok or {})
        self.calls = []

    def membership_ping(self, node, payload, token=None):
        target = payload.get("target")
        if target is not None:  # ping-req relay
            tid = target["id"]
            self.calls.append(("relay", node.id, tid))
            good = self.ok.get(("via", node.id, tid), self.ok.get(tid, True))
            return {"ok": bool(good), "relay": node.id}
        self.calls.append(("ping", node.id))
        if self.ok.get(node.id, True):
            return {"ok": True, "node": node.id}
        raise self.P.NodeDownError(f"scripted down: {node.id}")


def _mkmember(P, node_id="node0", n=3, ok=None, clock=None, seed=7, **kw):
    clock = clock or P.ManualClock()
    nodes = _mknodes(P, n)
    reg = P.MetricsRegistry()
    agent = types.SimpleNamespace(
        state=P.GossipState(node_id, clock=clock, registry=reg),
        seed=seed, clock=clock, registry=reg)
    client = _ScriptClient(P, ok)
    peers = [x for x in nodes if x.id != node_id]
    m = P.Membership(node_id, agent, client, lambda: peers, **kw)
    return m, agent, client, clock


def _remote(P, node_id, clock=None):
    """A peer's GossipState to author remote member records with."""
    return P.GossipState(node_id, clock=clock or P.ManualClock(),
                         registry=P.MetricsRegistry())


class TestPingToken:
    def test_never_cancels(self, P):
        tok = P.PingToken(0.05)
        assert tok.cancelled is False
        assert tok.timeout_s == 0.05
        assert tok.wait(0.0) is False


class TestMergedView:
    def test_bootstrap_defaults_alive(self, P):
        m, *_ = _mkmember(P)
        view = m.view()
        assert set(view) == {"node0", "node1", "node2"}
        assert all(r["status"] == P.MEMBER_ALIVE for r in view.values())
        assert view["node0"]["incarnation"] == 1  # self at own inc

    def test_suspect_outranks_alive_at_same_incarnation(self, P):
        m, agent, *_ = _mkmember(P, "node0")
        other = _remote(P, "node1")
        other.bump_local((P.KIND_MEMBER, "node2"), [P.MEMBER_SUSPECT, 1])
        agent.state.apply(other.deltas_since({}))
        # our own alive@1 assertion cannot clear node1's suspicion
        m.evidence_alive("node2")
        assert m.status_of("node2") == P.MEMBER_SUSPECT

    def test_alive_at_higher_incarnation_refutes(self, P):
        m, agent, *_ = _mkmember(P, "node0")
        a, b = _remote(P, "node1"), _remote(P, "node2")
        a.bump_local((P.KIND_MEMBER, "node2"), [P.MEMBER_DOWN, 1])
        b.bump_local((P.KIND_MEMBER, "node2"), [P.MEMBER_ALIVE, 2])
        agent.state.apply(a.deltas_since({}) + b.deltas_since({}))
        assert m.status_of("node2") == P.MEMBER_ALIVE
        assert m.view()["node2"]["incarnation"] == 2

    def test_down_outranks_suspect(self, P):
        m, agent, *_ = _mkmember(P, "node0")
        a, b = _remote(P, "node1"), _remote(P, "node2")
        a.bump_local((P.KIND_MEMBER, "node1"), [P.MEMBER_SUSPECT, 3])
        b.bump_local((P.KIND_MEMBER, "node1"), [P.MEMBER_DOWN, 3])
        agent.state.apply(a.deltas_since({}) + b.deltas_since({}))
        assert m.status_of("node1") == P.MEMBER_DOWN

    def test_malformed_records_ignored(self, P):
        m, agent, *_ = _mkmember(P, "node0")
        other = _remote(P, "node1")
        other.bump_local((P.KIND_MEMBER, "node2"), ["zombie", 1])
        other.bump_local((P.KIND_MEMBER, "node1"), "not-a-record")
        agent.state.apply(other.deltas_since({}))
        assert m.status_of("node2") == P.MEMBER_ALIVE
        assert m.status_of("node1") == P.MEMBER_ALIVE

    def test_live_ids_excludes_only_confirmed_down(self, P):
        m, agent, *_ = _mkmember(P, "node0")
        other = _remote(P, "node1")
        other.bump_local((P.KIND_MEMBER, "node1"), [P.MEMBER_SUSPECT, 1])
        other.bump_local((P.KIND_MEMBER, "node2"), [P.MEMBER_DOWN, 1])
        agent.state.apply(other.deltas_since({}))
        ids = ["node0", "node1", "node2"]
        assert m.live_ids(ids) == ["node0", "node1"]  # suspects routed


class TestRefutation:
    def test_gossiped_suspicion_triggers_incarnation_bump(self, P):
        m, agent, *_ = _mkmember(P, "node0")
        other = _remote(P, "node1")
        other.bump_local((P.KIND_MEMBER, "node0"), [P.MEMBER_SUSPECT, 1])
        agent.state.apply(other.deltas_since({}))
        assert m.incarnation == 2
        view = m.view()
        assert view["node0"] == {"status": P.MEMBER_ALIVE, "incarnation": 2}
        assert m.registry.value(P.M.METRIC_MEMBERSHIP_REFUTATIONS,
                                node="node0") == 1.0

    def test_confirmed_down_refuted_the_same_way(self, P):
        m, agent, *_ = _mkmember(P, "node0")
        other = _remote(P, "node1")
        other.bump_local((P.KIND_MEMBER, "node0"), [P.MEMBER_DOWN, 4])
        agent.state.apply(other.deltas_since({}))
        assert m.incarnation == 5
        assert m.status_of("node0") == P.MEMBER_ALIVE

    def test_stale_suspicion_is_ignored(self, P):
        m, agent, *_ = _mkmember(P, "node0")
        m.refute(3)  # incarnation -> 4
        other = _remote(P, "node1")
        other.bump_local((P.KIND_MEMBER, "node0"), [P.MEMBER_SUSPECT, 2])
        agent.state.apply(other.deltas_since({}))
        assert m.incarnation == 4  # alive@4 already outranks suspect@2
        assert m.status_of("node0") == P.MEMBER_ALIVE

    def test_tick_self_refutes_without_the_listener(self, P):
        # the apply-path listener normally refutes instantly; the tick
        # must also catch it (e.g. records merged while disabled)
        m, agent, *_ = _mkmember(P, "node0")
        agent.state.remove_kind_listener(P.KIND_MEMBER, m._on_member_entry)
        other = _remote(P, "node1")
        other.bump_local((P.KIND_MEMBER, "node0"), [P.MEMBER_SUSPECT, 1])
        agent.state.apply(other.deltas_since({}))
        assert m.incarnation == 1
        m.tick()
        assert m.incarnation == 2
        assert m.status_of("node0") == P.MEMBER_ALIVE


class TestProtocolTick:
    def _suspect(self, P, m, target, rounds=10):
        for _ in range(rounds):
            m.tick()
            if m.status_of(target) == P.MEMBER_SUSPECT:
                return
        raise AssertionError(f"{target} never became suspect")

    def test_failed_probe_and_relays_mark_suspect(self, P):
        m, agent, client, clock = _mkmember(P, 
            ok={"node2": False}, seed=7)
        self._suspect(P, m, "node2")
        # the direct ping failed, so a relay was consulted before the
        # suspicion was published (SWIM indirect probing)
        assert ("relay", "node1", "node2") in client.calls
        assert "node2" in m.live_ids(["node0", "node1", "node2"])

    def test_indirect_ack_keeps_target_alive(self, P):
        m, agent, client, clock = _mkmember(P, 
            ok={"node2": False, ("via", "node1", "node2"): True}, seed=7)
        for _ in range(10):
            m.tick()
        assert m.status_of("node2") == P.MEMBER_ALIVE
        assert ("relay", "node1", "node2") in client.calls

    def test_suspect_expires_to_down_after_scaled_timeout(self, P):
        m, agent, client, clock = _mkmember(P, ok={"node2": False}, seed=7)
        self._suspect(P, m, "node2")
        m.tick()  # the expiry scan AFTER publication seeds the timer
        timeout = m.suspect_timeout_s(3)
        clock.advance(timeout / 2)
        m.tick()
        assert m.status_of("node2") == P.MEMBER_SUSPECT  # not yet
        clock.advance(timeout / 2 + 0.01)
        out = m.tick()
        assert "node2" in out["confirmed"]
        assert m.status_of("node2") == P.MEMBER_DOWN
        assert m.live_ids(["node0", "node1", "node2"]) == ["node0", "node1"]
        # confirmed-down targets stop being probe candidates
        calls_before = len(client.calls)
        m.tick()
        assert all(c != ("ping", "node2")
                   for c in client.calls[calls_before:])

    def test_recovered_probe_withdraws_suspicion(self, P):
        m, agent, client, clock = _mkmember(P, ok={"node2": False}, seed=7)
        self._suspect(P, m, "node2")
        client.ok["node2"] = True  # link back
        for _ in range(10):
            m.tick()
        # our own suspicion is the only record, so our alive re-assert
        # at the same incarnation cannot clear it (rank) — but positive
        # evidence does, because WE published the suspicion and bump to
        # alive replaces our own record
        m.evidence_alive("node2")
        # merged view: our origin now says alive; no other suspicion
        assert m.status_of("node2") in (P.MEMBER_ALIVE, P.MEMBER_SUSPECT)

    def test_suspect_timeout_scales_with_cluster_size(self, P):
        m, *_ = _mkmember(P, interval_ms=1000.0, suspect_mult=3.0)
        assert m.suspect_timeout_s(2) == pytest.approx(3.0)
        assert m.suspect_timeout_s(4) == pytest.approx(6.0)
        assert m.suspect_timeout_s(16) == pytest.approx(12.0)
        # tiny clusters clamp at the n=2 bound
        assert m.suspect_timeout_s(1) == pytest.approx(3.0)

    def test_probe_sequence_is_seeded_deterministic(self, P):
        seqs = []
        for _ in range(2):
            m, agent, client, clock = _mkmember(P, n=4, seed=11)
            for _ in range(8):
                m.tick()
            seqs.append([c for c in client.calls if c[0] == "ping"])
        assert seqs[0] == seqs[1]
        m, agent, client, clock = _mkmember(P, n=4, seed=12)
        for _ in range(8):
            m.tick()
        assert [c for c in client.calls if c[0] == "ping"] != seqs[0]

    def test_probe_payload_and_members_json(self, P):
        m, agent, client, clock = _mkmember(P, ok={"node1": False}, seed=7)
        self._suspect(P, m, "node1")
        m.tick()  # seeds the suspect timer (expiry scan precedes probe)
        p = m.probe()
        assert p["enabled"] is True
        assert p["suspect"] == 1 and p["down"] == 0
        assert p["recent_transitions"] >= 1
        j = m.members_json()
        assert j["node"] == "node0"
        assert j["members"]["node1"]["status"] == P.MEMBER_SUSPECT
        assert j["members"]["node1"]["suspect_for_s"] >= 0.0
        assert j["suspect_timeout_s"] == m.suspect_timeout_s(3)


class TestGossipDisCo:
    def test_liveness_comes_from_membership_not_seed(self, P):
        seed = P.InMemDisCo()
        for n in _mknodes(P, 2):
            seed.register(n)
        stub = types.SimpleNamespace(evidence=[])
        stub.live_ids = lambda ids: [i for i in ids if i != "node1"]
        stub.evidence_down = lambda t: stub.evidence.append(("down", t))
        stub.evidence_alive = lambda t: stub.evidence.append(("up", t))
        d = P.GossipDisCo(seed, stub)
        assert [n.id for n in d.nodes()] == ["node0", "node1"]
        seed.down("node0")  # seed liveness is ignored...
        assert d.live_ids() == ["node0"]  # ...membership rules
        assert d.is_live("node0") and not d.is_live("node1")
        # mark_down/up (and the down/up aliases the harness uses) become
        # refutable evidence instead of authoritative state flips
        d.mark_down("node1")
        d.up("node1")
        assert stub.evidence == [("down", "node1"), ("up", "node1")]

    def test_register_delegates_to_seed(self, P):
        seed = P.InMemDisCo()
        d = P.GossipDisCo(seed, types.SimpleNamespace(
            live_ids=lambda ids: ids))
        d.register(P.Node(id="nX", uri=""))
        assert [n.id for n in seed.nodes()] == ["nX"]


class TestFaultPartition:
    def test_symmetric_cut_blocks_both_directions(self, P):
        plan = P.FaultPlan(seed=1).partition(["a", "b"], ["c"])
        with pytest.raises(P.InjectedFault):
            plan.on_request("c", source="a")
        with pytest.raises(P.InjectedFault):
            plan.on_request("b", source="c")
        # same side passes, and an anonymous client sees no links
        plan.on_request("b", source="a")
        plan.on_request("c")

    def test_asymmetric_cut_drops_one_direction(self, P):
        plan = P.FaultPlan(seed=1).partition(["a"], ["b"], symmetric=False)
        with pytest.raises(P.InjectedFault):
            plan.on_request("b", source="a")
        plan.on_request("a", source="b")  # reverse path delivers

    def test_op_scoped_cut_severs_only_that_rpc(self, P):
        plan = P.FaultPlan(seed=1).partition(["a"], ["b"], op="ping")
        with pytest.raises(P.InjectedFault):
            plan.on_request("b", source="a", op="ping")
        plan.on_request("b", source="a", op="gossip")
        plan.on_request("b", source="a", op="query")

    def test_heal_clears_links_but_keeps_node_rules(self, P):
        plan = P.FaultPlan(seed=1).partition(["a"], ["b"]).drop("z")
        with pytest.raises(P.InjectedFault):
            plan.on_request("b", source="a")
        plan.heal()
        plan.on_request("b", source="a")
        with pytest.raises(P.InjectedFault):
            plan.on_request("z", source="a")

    def test_partition_hits_are_recorded_events(self, P):
        plan = P.FaultPlan(seed=1).partition(["a"], ["b"])
        with pytest.raises(P.InjectedFault):
            plan.on_request("b", source="a")
        assert ("b", 0, "partition") in plan.events

    def test_count_window_arms_then_disarms(self, P):
        plan = P.FaultPlan(seed=1).partition(["a"], ["b"], count=2)
        for _ in range(2):
            with pytest.raises(P.InjectedFault):
                plan.on_request("b", source="a")
        plan.on_request("b", source="a")  # window exhausted


class _FlakyReplicator:
    """replicate_translate double: barrier-synchronized failure for the
    outbox race, then flippable to success for drain tests."""

    def __init__(self, P):
        self.P = P
        self.fail = True
        self.barrier = None
        self.sent = []

    def replicate_translate(self, node, index, field, entries):
        if self.barrier is not None:
            self.barrier.wait(timeout=5.0)
        if self.fail:
            raise self.P.NodeDownError(f"replica {node.id} down")
        self.sent.append((node.id, index, field, list(entries)))


def _mktranslator(P, live=None):
    client = _FlakyReplicator(P)
    nodes = _mknodes(P, 2)
    snap = P.ClusterSnapshot(nodes, replica_n=2)
    live = live if live is not None else {"node0", "node1"}
    tr = P.ClusterTranslator("node0", None, client, lambda: snap,
                             live_fn=lambda: set(live))
    return tr, client, nodes


class TestOutboxRace:
    def test_concurrent_failed_sends_lose_no_entries(self, P):
        # regression: pop/send/requeue used to race — two creates whose
        # pushes both failed could overwrite each other's requeue, and a
        # promoted replica then re-allocated the lost ids to other keys
        tr, client, nodes = _mktranslator(P)
        client.barrier = threading.Barrier(2)
        n1 = nodes[1]
        t1 = threading.Thread(
            target=tr._send_with_outbox, args=(n1, "i", None, [["a", 1]]))
        t2 = threading.Thread(
            target=tr._send_with_outbox, args=(n1, "i", None, [["b", 2]]))
        t1.start(); t2.start()
        t1.join(timeout=5.0); t2.join(timeout=5.0)
        assert tr.outbox_depth() == 2
        queued = sorted(tr._outbox[("node1", "i", None)])
        assert queued == [["a", 1], ["b", 2]]

    def test_failed_send_prepends_backlog_before_newer_entries(self, P):
        tr, client, nodes = _mktranslator(P)
        n1 = nodes[1]
        tr._send_with_outbox(n1, "i", None, [["a", 1]])
        tr._send_with_outbox(n1, "i", None, [["b", 2]])
        assert tr._outbox[("node1", "i", None)] == [["a", 1], ["b", 2]]

    def test_flush_drains_after_recovery(self, P):
        tr, client, nodes = _mktranslator(P)
        tr._send_with_outbox(nodes[1], "i", None, [["a", 1]])
        tr._send_with_outbox(nodes[1], "i", "f", [["r", 7]])
        assert tr.outbox_depth() == 2
        client.fail = False
        assert tr.flush_outbox() == 2
        assert tr.outbox_depth() == 0
        assert ("node1", "i", None, [["a", 1]]) in client.sent
        assert ("node1", "i", "f", [["r", 7]]) in client.sent
        assert tr.flush_outbox() == 0  # idempotent when empty

    def test_flush_keeps_entries_for_dead_replicas(self, P):
        live = {"node0"}
        tr, client, nodes = _mktranslator(P, live=live)
        tr._send_with_outbox(nodes[1], "i", None, [["a", 1]])
        client.fail = False
        assert tr.flush_outbox() == 0  # node1 not live: stays queued
        assert tr.outbox_depth() == 1
        live.add("node1")
        assert tr.flush_outbox() == 1
        assert tr.outbox_depth() == 0

    def test_gossip_publish_rides_every_push(self, P):
        tr, client, nodes = _mktranslator(P)
        published = []
        tr.gossip_publish = lambda *a: published.append(a)
        tr._push_entries("i", None, [("k1", 1)])
        tr._push_entries("i", "f", [("r1", 2)])
        assert published[0] == ("i", None, [["k1", 1]], 1)
        assert published[1] == ("i", "f", [["r1", 2]], 2)  # batch_no grows


# -- real 3-node clusters under partition plans ------------------------------


def _mkcluster(P, plan, n=3, replica_n=2, seed=9, **member_kw):
    clock = P.ManualClock()
    reg = P.MetricsRegistry()
    c = P.LocalCluster(
        n, replica_n=replica_n, fault_plan=plan,
        client_factory=lambda i: P.InternalClient(
            retries=0, backoff=0.001, fault_plan=plan))
    c.enable_gossip(seed=seed, clock=clock, registry=reg)
    c.enable_membership(seed=seed, clock=clock)
    return c, clock, reg


def _rounds(P, c, clock, n, only=None, advance=0.5):
    """n anti-entropy rounds (membership tick + outbox flush ride the
    round hooks), advancing the shared manual clock per round. ``only``
    restricts which nodes run (a truly dead node runs nothing)."""
    for _ in range(n):
        for i, node in enumerate(c.nodes):
            if only is not None and i not in only:
                continue
            node.gossip.run_round()
        clock.advance(advance)


def _statuses(P, c, i):
    return {nid: rec["status"]
            for nid, rec in c[i].membership.view().items()}


class TestClusterMembership:
    def test_all_alive_endpoint_and_wire_pings(self, P):
        c, clock, reg = _mkcluster(P, None, n=2)
        try:
            _rounds(P, c, clock, 2)
            with urllib.request.urlopen(
                    c[0].node.uri + "/internal/membership") as r:
                body = json.loads(r.read())
            assert body["enabled"] is True
            assert set(body["members"]) == {"node0", "node1"}
            assert all(v["status"] == P.MEMBER_ALIVE
                       for v in body["members"].values())
            # direct probe over the wire
            out = c[0].client.membership_ping(c[1].node, {"from": "node0"})
            assert out["ok"] is True and out["node"] == "node1"
            # ping-req relay: node1 probes node0 over ITS link and reports
            out = c[0].client.membership_ping(
                c[1].node, {"from": "node0",
                            "target": c[0].node.to_json()})
            assert out["ok"] is True and out["relay"] == "node1"
        finally:
            c.close()

    def test_membership_endpoint_reports_disabled_without_protocol(self, P):
        c = P.LocalCluster(1)
        try:
            with urllib.request.urlopen(
                    c[0].node.uri + "/internal/membership") as r:
                body = json.loads(r.read())
            assert body["enabled"] is False
            assert body["live"] == ["node0"]
        finally:
            c.close()

    def test_disable_membership_restores_seed_plumbing(self, P):
        c, clock, reg = _mkcluster(P, None, n=2)
        try:
            node = c[0]
            assert isinstance(node.disco, P.GossipDisCo)
            seed_disco = node.disco.seed
            agent = node.gossip
            node.disable_membership()
            assert node.membership is None
            assert node.disco is seed_disco
            assert not isinstance(node.disco, P.GossipDisCo)
            assert agent.round_hooks == []
            assert node.executor.translator.gossip_publish is None
            # gossip itself survives (membership rode it, not vice versa)
            assert node.gossip is agent
        finally:
            c.close()


class TestPartitionChaos:
    def _fill(self, P, target, index="mi"):
        target.create_index(index)
        target.create_field(index, "f")
        for s in range(4):
            for bit in (1, 2):
                target.query(index, f"Set({s * P.SHARD_WIDTH + bit}, f={s})")

    CHECKS = ["Count(Row(f=0))", "Row(f=1)", "Row(f=3)",
              "Count(Union(Row(f=0), Row(f=2)))"]

    def test_clean_split_confirm_heal_rejoin_bit_identical(self, P):
        plan = P.FaultPlan(seed=3)
        c, clock, reg = _mkcluster(P, plan)
        oracle = P.API()
        try:
            co = c.coordinator
            self._fill(P, co)
            self._fill(P, oracle)
            want = [oracle.query("mi", q) for q in self.CHECKS]
            _rounds(P, c, clock, 3)
            assert all(s == P.MEMBER_ALIVE
                       for s in _statuses(P, c, 0).values())

            plan.partition(["node0", "node1"], ["node2"])
            # node2 is fully cut: its own rounds fail outward, the
            # majority's probes fail toward it. Run well past the
            # suspect timeout (0.5s x 3.0 x log2(3) ~ 2.4s at 0.5s/round).
            _rounds(P, c, clock, 14, only=(0, 1))
            assert _statuses(P, c, 0)["node2"] == P.MEMBER_DOWN
            assert _statuses(P, c, 1)["node2"] == P.MEMBER_DOWN
            assert set(c[0].disco.live_ids()) == {"node0", "node1"}
            # majority keeps serving: every shard has a replica on the
            # majority side (replica_n=2), reads fail over off node2
            for q, w in zip(self.CHECKS, want):
                assert co.query("mi", q) == w

            plan.heal()
            _rounds(P, c, clock, 12)
            # node2 saw its own confirmation, refuted with an
            # incarnation bump, and rejoined; the majority's down
            # records are outranked by alive@inc+1
            assert c[2].membership.incarnation > 1
            for i in range(3):
                assert all(s == P.MEMBER_ALIVE
                           for s in _statuses(P, c, i).values()), i
            assert set(c[0].disco.live_ids()) == \
                {"node0", "node1", "node2"}

            # post-heal writes land everywhere; results bit-identical
            # to the no-fault oracle from every coordinator
            co.query("mi", f"Set({2 * P.SHARD_WIDTH + 9}, f=7)")
            oracle.query("mi", f"Set({2 * P.SHARD_WIDTH + 9}, f=7)")
            checks = self.CHECKS + ["Row(f=7)"]
            want = [oracle.query("mi", q) for q in checks]
            for node in c.nodes:
                for q, w in zip(checks, want):
                    assert node.query("mi", q) == w, (node.node.id, q)
        finally:
            c.close()

    def test_asymmetric_ping_cut_refutes_and_flaps(self, P):
        # only PROBES toward node2 drop; gossip and queries deliver, so
        # every suspicion reaches node2, which refutes with an
        # incarnation bump — the cluster flaps instead of wrongly
        # confirming a live node down
        plan = P.FaultPlan(seed=3)
        c, clock, reg = _mkcluster(P, plan)
        try:
            _rounds(P, c, clock, 2)
            inc0 = c[2].membership.incarnation
            plan.partition(["node0", "node1"], ["node2"],
                           symmetric=False, op="ping")
            # short rounds: suspicions never live long enough to confirm
            _rounds(P, c, clock, 10, advance=0.2)
            assert c[2].membership.incarnation > inc0
            assert _statuses(P, c, 0)["node2"] != P.MEMBER_DOWN
            assert _statuses(P, c, 1)["node2"] != P.MEMBER_DOWN
            # node2 stays in everyone's routing set throughout
            assert "node2" in c[0].disco.live_ids()
            # the oscillation is visible to the flap accounting
            flaps = sum(node.membership.recent_transitions()
                        for node in c.nodes)
            assert flaps >= 2
        finally:
            c.close()

    def test_coordinator_drop_broadcast_and_translate_converge(self, P):
        plan = P.FaultPlan(seed=5)
        c, clock, reg = _mkcluster(P, plan)
        try:
            _rounds(P, c, clock, 2)
            plan.partition(["node0"], ["node1", "node2"])

            # schema created while the coordinator is unreachable: the
            # direct push to node0 fails, GossipBroadcaster tolerates it
            # and records an idempotent control entry
            c[1].create_index("pk", {"keys": True})
            c[1].create_field("pk", "color")
            assert "pk" in c[2].holder.indexes  # direct push delivered
            assert "pk" not in c[0].holder.indexes  # cut off

            # keyed translation while node0 is cut: pick keys whose
            # partition primary is reachable and whose replica set
            # includes node0, so the replica push queues in the outbox
            # and the entries also ride the gossip plane
            snap = P.ClusterSnapshot(c[1].disco.nodes(), replica_n=2)
            keys = []
            for i in range(64):
                owners = [n.id for n in snap.key_nodes("pk", f"k{i}")]
                if owners[0] != "node0" and "node0" in owners[1:]:
                    keys.append(f"k{i}")
                if len(keys) == 3:
                    break
            assert len(keys) == 3
            ids = c[1].executor.translator.index_keys("pk", keys, True)
            assert sorted(ids) == sorted(keys)

            plan.heal()
            _rounds(P, c, clock, 8)
            # node0 converged on the schema via the gossiped control
            # entries — nobody re-broadcast anything
            assert "pk" in c[0].holder.indexes
            # and holds the same key->id map, via outbox drain + the
            # gossiped translate batches
            local = c[0].holder.index("pk").translate.find_keys(keys)
            assert local == ids
            for node in c.nodes:
                assert node.executor.translator.outbox_depth() == 0
        finally:
            c.close()

    def test_paused_node_is_suspected_but_refutes_while_sending(self, P):
        # harness pause kills only the listener: the paused node still
        # gossips OUTBOUND, hears the suspicion in reply envelopes, and
        # keeps refuting — SWIM never confirms a node that can prove
        # liveness. Only a truly silent node (no rounds at all) confirms.
        c, clock, reg = _mkcluster(P, None)
        try:
            _rounds(P, c, clock, 2)
            c.pause(2)
            _rounds(P, c, clock, 10)
            assert c[2].membership.incarnation > 1  # kept refuting
            assert _statuses(P, c, 0)["node2"] != P.MEMBER_DOWN
            # now truly silent: only the majority runs rounds
            _rounds(P, c, clock, 14, only=(0, 1))
            assert _statuses(P, c, 0)["node2"] == P.MEMBER_DOWN
            assert set(c[0].disco.live_ids()) == {"node0", "node1"}
            c.unpause(2)
            _rounds(P, c, clock, 10)
            assert all(s == P.MEMBER_ALIVE
                       for s in _statuses(P, c, 0).values())
        finally:
            c.close()


# -- the two packages against each other --------------------------------------


def test_members_json_equal_tick_for_tick():
    """One 3-node cluster per package, one seed, a ``ManualClock`` each:
    rounds, node 2 paused (it still sends and refutes), then silent
    until confirmed down, then unpaused until it rejoins. After every
    node's round every node's ``members_json``, incarnation and
    transition count are the JAX package's."""
    pair = [_mkcluster(_pkg(r), None) for r in (JAX, TORCH)]
    seen = []

    def compare(tag):
        views = [[json.dumps({"json": c[i].membership_json(),
                              "inc": c[i].membership.incarnation,
                              "flaps": c[i].membership.recent_transitions()},
                             sort_keys=True) for i in range(3)]
                 for c, _, _ in pair]
        assert views[0] == views[1], tag
        seen.append(views[0])

    def rounds(n, only=None):
        for r in range(n):
            for i in range(3):
                if only is not None and i not in only:
                    continue
                for c, _, _ in pair:
                    c[i].gossip.run_round()
                compare((r, i))
            for _, clock, _ in pair:
                clock.advance(0.5)

    try:
        rounds(2)
        for c, _, _ in pair:
            c.pause(2)
        rounds(6)
        rounds(14, only=(0, 1))
        for c, _, _ in pair:
            assert _statuses(_pkg(JAX), c, 0)["node2"] == "down"
        for c, _, _ in pair:
            c.unpause(2)
        rounds(8)
        for c, _, _ in pair:
            assert c[2].membership.incarnation > 1
            assert set(c[0].disco.live_ids()) == {"node0", "node1", "node2"}
    finally:
        for c, _, _ in pair:
            c.close()
    # the sequence went through suspicion, confirmation and rejoin
    assert any('"suspect"' in v for vs in seen for v in vs)
    assert any('"down"' in v for vs in seen for v in vs)
