"""Fan-out resilience, run once per package, and the two packages'
resilience pieces held against each other.

The ``P`` fixture yields the modules of ``pilosa_tpu`` or of their
``pilosa_tpu_torch`` counterparts; ``P.API()`` and ``P.LocalCluster``
build the port's with ``device="cpu"``. Covered:

* every case of ``tests/test_resilience.py`` (cancellation tokens, the
  latency tracker, the breaker's state machine, ``FaultPlan``, the
  client's jittered retries, placement, the hedged-leg race, the
  adaptive policies, the config section, and a 3-node ``LocalCluster``
  under a ``FaultPlan``: a hedged straggler, writes off the hedged path,
  a flap inside the client's retries, failover and breaker recovery),
  once per package;
* across the packages, equal: the ``FaultPlan`` decisions (events and
  faults) of the same seed, rules and request sequence; the
  ``LatencyTracker`` percentiles of the same samples; the
  ``CircuitBreaker`` state sequence (with its gossiped applies) under
  one script; ``Resilience.hedge_delay_s`` / ``leg_timeout_s`` on the
  same samples and deadline budgets.

Every case holds for any ``PILOSA_TPU_FAULT_SEED``: seeds only steer
``prob`` rules, and the cases that pin fault sequences seed their plans.
"""

import importlib
import random
import threading
import time
import types

import pytest

JAX, TORCH = "pilosa_tpu", "pilosa_tpu_torch"


def _load(root: str) -> types.SimpleNamespace:
    m = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    kw = {"device": "cpu"} if root == TORCH else {}
    api_cls = m("api").API
    cluster = m("cluster")
    sched = m("sched")
    return types.SimpleNamespace(
        root=root,
        API=lambda *a, **k: api_cls(*a, **{**kw, **k}),
        LocalCluster=lambda *a, **k: cluster.LocalCluster(*a, **{**kw, **k}),
        C=cluster,
        R=m("cluster.resilience"),
        InternalClient=m("cluster.client").InternalClient,
        ClusterExecutor=m("cluster.executor").ClusterExecutor,
        ClusterSnapshot=m("cluster.topology").ClusterSnapshot,
        Node=m("cluster.topology").Node,
        Config=m("config").Config,
        M=m("obs.metrics"),
        MetricsRegistry=m("obs.metrics").MetricsRegistry,
        ManualClock=sched.ManualClock,
        Deadline=sched.Deadline,
        deadline_scope=sched.deadline_scope,
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


def make_nodes(P, n):
    return [P.Node(id=f"node{i}", uri=f"http://host{i}") for i in range(n)]


class TestCancellationToken:
    def test_starts_clear_and_cancels(self, P):
        tok = P.C.CancellationToken(timeout_s=1.5)
        assert not tok.cancelled
        assert tok.timeout_s == 1.5
        assert tok.wait(0.0) is False
        tok.cancel()
        assert tok.cancelled
        # wait returns immediately once cancelled, whatever the timeout
        assert tok.wait(60.0) is True

    def test_cancel_wakes_a_waiter(self, P):
        tok = P.C.CancellationToken()
        woke = []
        t = threading.Thread(target=lambda: woke.append(tok.wait(5.0)))
        t.start()
        tok.cancel()
        t.join(timeout=2.0)
        assert woke == [True]


class TestLatencyTracker:
    def test_empty_returns_none(self, P):
        tr = P.C.LatencyTracker()
        assert tr.percentile("a", 99.0) is None

    def test_exact_percentiles_per_node(self, P):
        tr = P.C.LatencyTracker(window=32)
        for v in [3, 1, 2, 5, 4, 7, 6, 9, 8, 10]:
            tr.observe("a", float(v))
        assert tr.percentile("a", 0.0) == 1.0
        assert tr.percentile("a", 50.0) == 6.0  # idx int(0.5*10)=5
        assert tr.percentile("a", 100.0) == 10.0

    def test_unknown_node_falls_back_to_global_window(self, P):
        tr = P.C.LatencyTracker()
        tr.observe("a", 2.0)
        tr.observe("b", 4.0)
        assert tr.percentile("never-seen", 100.0) == 4.0

    def test_window_bounds_samples(self, P):
        tr = P.C.LatencyTracker(window=4)
        for v in range(1, 11):
            tr.observe("a", float(v))
        # only the last 4 samples (7..10) survive
        assert tr.percentile("a", 0.0) == 7.0
        assert tr.percentile("a", 100.0) == 10.0


class TestCircuitBreaker:
    def _mk(self, P, threshold=2, open_s=5.0):
        clk = P.ManualClock()
        reg = P.MetricsRegistry()
        transitions = []
        br = P.C.CircuitBreaker(
            threshold=threshold, open_s=open_s, clock=clk, registry=reg,
            on_transition=lambda n, frm, to: transitions.append((frm, to)))
        return br, clk, reg, transitions

    def test_full_state_machine(self, P):
        R = P.R
        br, clk, reg, transitions = self._mk(P)
        assert br.state("x") == R.BREAKER_CLOSED
        assert br.allow("x") is True
        br.record_failure("x")
        assert br.state("x") == R.BREAKER_CLOSED  # below threshold
        br.record_failure("x")
        assert br.state("x") == R.BREAKER_OPEN
        assert br.allow("x") is False  # open and not yet expired
        clk.advance(5.0)
        assert br.allow("x") is True  # the half-open probe grant
        assert br.state("x") == R.BREAKER_HALF_OPEN
        br.record_failure("x")  # probe failed: straight back to open
        assert br.state("x") == R.BREAKER_OPEN
        clk.advance(5.0)
        assert br.allow("x") is True
        br.record_success("x")
        assert br.state("x") == R.BREAKER_CLOSED
        assert transitions == [
            (R.BREAKER_CLOSED, R.BREAKER_OPEN),
            (R.BREAKER_OPEN, R.BREAKER_HALF_OPEN),
            (R.BREAKER_HALF_OPEN, R.BREAKER_OPEN),
            (R.BREAKER_OPEN, R.BREAKER_HALF_OPEN),
            (R.BREAKER_HALF_OPEN, R.BREAKER_CLOSED),
        ]
        # observable via metrics: gauge back at closed=0, counters per state
        M = P.M
        assert reg.value(M.METRIC_CLUSTER_BREAKER_STATE, node="x") == 0.0
        assert reg.value(M.METRIC_CLUSTER_BREAKER_TRANSITIONS,
                         node="x", to=R.BREAKER_OPEN) == 2.0
        assert reg.value(M.METRIC_CLUSTER_BREAKER_TRANSITIONS,
                         node="x", to=R.BREAKER_CLOSED) == 1.0

    def test_single_probe_with_expiring_grant(self, P):
        br, clk, _, _ = self._mk(P, threshold=1, open_s=2.0)
        br.record_failure("x")
        clk.advance(2.0)
        assert br.allow("x") is True  # probe granted
        assert br.allow("x") is False  # second leg vetoed while probing
        # the probing query died without reporting; grant expires
        clk.advance(2.0)
        assert br.allow("x") is True

    def test_success_resets_failure_streak(self, P):
        br, _, _, _ = self._mk(P, threshold=2)
        br.record_failure("x")
        br.record_success("x")
        br.record_failure("x")
        # streak broken, not 2-in-a-row
        assert br.state("x") == P.R.BREAKER_CLOSED

    def test_nodes_are_independent(self, P):
        br, _, _, _ = self._mk(P, threshold=1)
        br.record_failure("x")
        assert br.state("x") == P.R.BREAKER_OPEN
        assert br.state("y") == P.R.BREAKER_CLOSED
        assert br.allow("y") is True


class TestFaultPlan:
    def test_drop_is_a_transport_error(self, P):
        plan = P.C.FaultPlan(seed=1).drop("a")
        with pytest.raises(P.C.InjectedFault) as ei:
            plan.on_request("a")
        assert isinstance(ei.value, OSError)
        assert plan.events == [("a", 0, "drop")]

    def test_untargeted_nodes_pass_and_do_not_count(self, P):
        plan = P.C.FaultPlan(seed=1).drop("a")
        for _ in range(3):
            plan.on_request("b")  # no rules for b: no fault, no count
        assert plan.seen("b") == 0
        assert plan.events == []

    def test_first_and_count_window(self, P):
        plan = P.C.FaultPlan(seed=1).drop("a", first=2, count=2)
        hit = []
        for k in range(6):
            try:
                plan.on_request("a")
                hit.append(False)
            except P.C.InjectedFault:
                hit.append(True)
        assert hit == [False, False, True, True, False, False]

    def test_flap_period(self, P):
        plan = P.C.FaultPlan(seed=1).flap("a", period=3)
        hit = []
        for _ in range(7):
            try:
                plan.on_request("a")
                hit.append(False)
            except P.C.InjectedFault:
                hit.append(True)
        assert hit == [True, False, False, True, False, False, True]
        assert [e[2] for e in plan.events] == ["flap"] * 3

    def test_prob_rules_are_seed_deterministic(self, P):
        def run(seed):
            plan = P.C.FaultPlan(seed=seed).drop("a", prob=0.5)
            out = []
            for _ in range(32):
                try:
                    plan.on_request("a")
                    out.append(0)
                except P.C.InjectedFault:
                    out.append(1)
            return out

        a, b = run(3), run(3)
        assert a == b  # same seed, same request order -> same faults
        assert 0 < sum(a) < 32  # prob actually gates (not all/none)
        # and the per-request decision stream is a pure function of
        # (seed, node, k) — independent of PYTHONHASHSEED / process
        assert P.C.FaultPlan(seed=3)._hit_rng("a", 0)() == \
            P.C.FaultPlan(seed=3)._hit_rng("a", 0)()

    def test_seed_defaults_from_env(self, P, monkeypatch):
        monkeypatch.setenv("PILOSA_TPU_FAULT_SEED", "41")
        assert P.C.FaultPlan().seed == 41
        monkeypatch.delenv("PILOSA_TPU_FAULT_SEED")
        assert P.C.FaultPlan().seed == 0

    def test_delay_uses_injectable_sleep(self, P):
        slept = []
        plan = P.C.FaultPlan(seed=1, sleep=slept.append).delay("a", 0.25)
        plan.on_request("a")
        assert slept == [0.25]
        assert plan.events == [("a", 0, "delay")]

    def test_delay_with_cancelled_token_raises_leg_cancelled(self, P):
        plan = P.C.FaultPlan(seed=1).delay("a", 30.0)
        tok = P.C.CancellationToken()
        tok.cancel()
        with pytest.raises(P.C.LegCancelled):
            plan.on_request("a", token=tok)  # returns immediately, no sleep

    def test_clear_disarms(self, P):
        plan = P.C.FaultPlan(seed=1).drop("a").drop("b")
        plan.clear("a")
        plan.on_request("a")  # no longer armed
        with pytest.raises(P.C.InjectedFault):
            plan.on_request("b")
        plan.clear()
        plan.on_request("b")

    def test_seen_tracks_armed_requests(self, P):
        plan = P.C.FaultPlan(seed=1).delay("a", 0.0)
        assert plan.seen("a") == 0
        plan.on_request("a")
        plan.on_request("a")
        assert plan.seen("a") == 2


class TestClientRetry:
    # nothing listens on port 1: instant connection-refused
    DEAD_URL = "http://127.0.0.1:1/x"

    def test_jittered_backoff_between_retries(self, P):
        slept = []
        c = P.InternalClient(timeout=0.2, retries=2, backoff=0.05,
                             sleep=slept.append, rng=random.Random(0))
        with pytest.raises(P.C.NodeDownError):
            c._request("GET", self.DEAD_URL)
        # full-jitter over [0.5x, 1.5x) of backoff * 2^attempt
        assert len(slept) == 2
        assert 0.025 <= slept[0] < 0.075
        assert 0.05 <= slept[1] < 0.15

    def test_jitter_draws_come_from_injected_rng(self, P):
        r = random.Random(7)
        want = [0.05 * (0.5 + r.random()), 0.1 * (0.5 + r.random())]
        slept = []
        c = P.InternalClient(timeout=0.2, retries=2, backoff=0.05,
                             sleep=slept.append, rng=random.Random(7))
        with pytest.raises(P.C.NodeDownError):
            c._request("GET", self.DEAD_URL)
        assert slept == pytest.approx(want)

    def test_cancelled_token_aborts_before_any_attempt(self, P):
        slept = []
        c = P.InternalClient(retries=2, sleep=slept.append)
        tok = P.C.CancellationToken()
        tok.cancel()
        with pytest.raises(P.C.LegCancelled):
            c._request("GET", self.DEAD_URL, token=tok)
        assert slept == []

    def test_fault_plan_drop_surfaces_as_node_down(self, P):
        plan = P.C.FaultPlan(seed=1).drop("nodeX")
        slept = []
        c = P.InternalClient(retries=1, backoff=0.0, sleep=slept.append,
                             fault_plan=plan)
        with pytest.raises(P.C.NodeDownError):
            c._request("GET", self.DEAD_URL, node_id="nodeX")
        # both attempts consulted the plan (drop, retry, drop again)
        assert [e[2] for e in plan.events] == ["drop", "drop"]
        assert len(slept) == 1


class TestAssign:
    def _ex(self, P):
        # _assign is pure placement math over its arguments
        return P.ClusterExecutor.__new__(P.ClusterExecutor)

    def test_rank_beyond_owners_raises_not_clamps(self, P):
        ex = self._ex(P)
        snap = P.ClusterSnapshot(make_nodes(P, 3), replica_n=2)
        by0 = ex._assign(snap, "i", [0, 1, 2], set(), replica_rank=0)
        by1 = ex._assign(snap, "i", [0, 1, 2], set(), replica_rank=1)
        for s in (0, 1, 2):
            r0 = next(n for n, ss in by0.items() if s in ss)
            r1 = next(n for n, ss in by1.items() if s in ss)
            assert r0 != r1  # ranks are distinct owners, never clamped
        with pytest.raises(P.C.NodeDownError, match="no live replica"):
            ex._assign(snap, "i", [0], set(), replica_rank=2)

    def test_dead_filter_never_falls_back_to_racing_owner(self, P):
        ex = self._ex(P)
        snap = P.ClusterSnapshot(make_nodes(P, 3), replica_n=2)
        owners = [n.id for n in snap.shard_nodes("i", 0)]
        # rank 1 with the rank-1 owner dead: the old clamp would hand the
        # shard back to owners[0] — the node a hedge would be racing
        with pytest.raises(P.C.NodeDownError):
            ex._assign(snap, "i", [0], {owners[1]}, replica_rank=1)

    def test_on_exhausted_skip_drops_the_shard(self, P):
        ex = self._ex(P)
        snap = P.ClusterSnapshot(make_nodes(P, 3), replica_n=2)
        assert ex._assign(snap, "i", [0], set(), replica_rank=2,
                          on_exhausted="skip") == {}

    def test_all_owners_dead_raises(self, P):
        ex = self._ex(P)
        snap = P.ClusterSnapshot(make_nodes(P, 3), replica_n=2)
        owners = {n.id for n in snap.shard_nodes("i", 0)}
        with pytest.raises(P.C.NodeDownError):
            ex._assign(snap, "i", [0], owners)


def _park(P, token):
    """A remote leg that blocks until cancelled (a straggler)."""
    if token.wait(10.0):
        raise P.C.LegCancelled("parked leg cancelled")
    raise AssertionError("parked leg was never cancelled")


class TestRunLegs:
    def _res(self, P, reg, **kw):
        kw.setdefault("hedge_min_ms", 1.0)
        kw.setdefault("hedge_max_ms", 1.0)
        return P.C.Resilience(registry=reg, **kw)

    def test_hedge_wins_over_parked_primary(self, P):
        reg = P.MetricsRegistry()
        res = self._res(P, reg)
        racing = []

        def run_remote(node, shards, token):
            if node == "A":
                _park(P, token)
            return ("part", node, tuple(shards))

        def next_owners(shards, racing_node):
            racing.append(racing_node)
            return {"b": list(shards)}

        parts, failed = res.run_legs(
            {"a": [1, 2]}, {"a": "A", "b": "B"}, run_remote, next_owners)
        assert parts == [("part", "B", (1, 2))]
        assert failed == []
        assert racing == ["a"]
        assert reg.value(P.M.METRIC_CLUSTER_HEDGES) == 1.0
        assert reg.value(P.M.METRIC_CLUSTER_HEDGE_WINS) == 1.0

    def test_primary_wins_after_hedge_wave_breaks(self, P):
        reg = P.MetricsRegistry()
        res = self._res(P, reg)
        marks = []

        def run_remote(node, shards, token):
            if node == "B":
                raise P.C.NodeDownError("replica down")
            token.wait(0.03)  # slow but healthy primary
            return "pa"

        parts, failed = res.run_legs(
            {"a": [1]}, {"a": "A", "b": "B"}, run_remote,
            lambda s, r: {"b": list(s)},
            mark_failed=lambda n, t: marks.append((n, t)))
        assert parts == ["pa"]
        assert failed == []
        assert reg.value(P.M.METRIC_CLUSTER_HEDGES) == 1.0
        assert reg.value(P.M.METRIC_CLUSTER_HEDGE_WINS) == 0.0
        assert ("b", True) in marks

    def test_hedge_onto_racing_node_is_a_bug_not_a_retry(self, P):
        reg = P.MetricsRegistry()
        res = self._res(P, reg)
        with pytest.raises(AssertionError, match="racing node"):
            res.run_legs({"a": [1]}, {"a": "A"},
                         lambda n, s, t: _park(P, t),
                         lambda s, r: {"a": list(s)})

    def test_no_replica_to_hedge_onto_is_quietly_skipped(self, P):
        reg = P.MetricsRegistry()
        res = self._res(P, reg)

        def run_remote(node, shards, token):
            token.wait(0.03)
            return "pa"

        def next_owners(shards, racing):
            raise P.C.NodeDownError("no live replica")

        parts, failed = res.run_legs({"a": [1]}, {"a": "A"}, run_remote,
                                     next_owners)
        assert parts == ["pa"] and failed == []
        assert reg.value(P.M.METRIC_CLUSTER_HEDGES) == 0.0

    def test_timeout_reaps_stuck_leg(self, P):
        reg = P.MetricsRegistry()
        res = P.C.Resilience(registry=reg, hedge=False,
                             timeout_min_ms=20.0, timeout_max_ms=20.0)
        marks = []
        parts, failed = res.run_legs(
            {"a": [3]}, {"a": "A"}, lambda n, s, t: _park(P, t),
            lambda s, r: {}, mark_failed=lambda n, t: marks.append((n, t)))
        assert parts == []
        assert failed == [3]  # shard re-enters the executor failover loop
        assert marks == [("a", False)]  # timeout is not a transport error
        assert reg.value(P.M.METRIC_CLUSTER_LEG_TIMEOUTS, node="a") == 1.0

    def test_primary_failure_without_hedge_fails_the_group(self, P):
        reg = P.MetricsRegistry()
        res = P.C.Resilience(registry=reg, hedge=False)
        marks = []

        def run_remote(node, shards, token):
            raise P.C.NodeDownError("down")

        parts, failed = res.run_legs(
            {"a": [4, 5]}, {"a": "A"}, run_remote, lambda s, r: {},
            mark_failed=lambda n, t: marks.append((n, t)))
        assert parts == [] and sorted(failed) == [4, 5]
        assert marks == [("a", True)]
        # 1 < threshold 3
        assert res.breaker.state("a") == P.R.BREAKER_CLOSED

    def test_local_leg_runs_first_and_merges(self, P):
        reg = P.MetricsRegistry()
        res = P.C.Resilience(registry=reg, hedge=False)
        parts, failed = res.run_legs(
            {"a": [1]}, {"a": "A"}, lambda n, s, t: "ra", lambda s, r: {},
            local_fn=lambda: "local")
        assert parts == ["local", "ra"] and failed == []

    def test_success_feeds_latency_tracker_and_breaker(self, P):
        reg = P.MetricsRegistry()
        res = P.C.Resilience(registry=reg, hedge=False)
        res.run_legs({"a": [1]}, {"a": "A"}, lambda n, s, t: "ra",
                     lambda s, r: {})
        assert res.tracker.percentile("a", 99.0) is not None
        assert res.breaker.state("a") == P.R.BREAKER_CLOSED
        # leg latency histogram observed under outcome=ok kind=primary
        h = reg.histogram(P.M.METRIC_CLUSTER_LEG_LATENCY,
                          outcome="ok", kind="primary")
        assert h is not None and h["count"] == 1


class TestAdaptivePolicies:
    def test_leg_timeout_tracks_p99_with_clamps(self, P):
        res = P.C.Resilience(timeout_factor=4.0, timeout_min_ms=50.0,
                             timeout_max_ms=30000.0)
        assert res.leg_timeout_s("a") == 30.0  # no samples: max
        for _ in range(10):
            res.tracker.observe("a", 0.001)
        assert res.leg_timeout_s("a") == 0.05  # 4 x 1ms clamps up to min
        for _ in range(64):
            res.tracker.observe("a", 100.0)
        assert res.leg_timeout_s("a") == 30.0  # 400s clamps down to max

    def test_leg_timeout_respects_deadline_budget(self, P):
        clk = P.ManualClock()
        res = P.C.Resilience()
        with P.deadline_scope(P.Deadline(clk.now() + 2.0, now=clk.now)):
            assert res.leg_timeout_s("a") == 2.0
            clk.advance(1.5)
            assert res.leg_timeout_s("a") == pytest.approx(0.5)
            clk.advance(1.0)
            assert res.leg_timeout_s("a") == 0.0  # budget exhausted
        assert res.leg_timeout_s("a") == 30.0  # scope cleared

    def test_hedge_delay_clamps_to_bounds(self, P):
        res = P.C.Resilience(hedge_min_ms=10.0, hedge_max_ms=100.0)
        assert res.hedge_delay_s("a") == 0.01  # no samples: min
        for _ in range(10):
            res.tracker.observe("a", 50.0)
        assert res.hedge_delay_s("a") == 0.1  # p95 clamps down to max

    def test_vetoed_routes_open_breakers_to_replicas(self, P):
        res = P.C.Resilience(breaker_threshold=1)
        res.breaker.record_failure("b")
        assert res.vetoed(["a", "b", "c"]) == {"b"}


class TestConfig:
    def test_toml_section_round_trips(self, P, tmp_path):
        p = tmp_path / "pilosa.toml"
        p.write_text(
            "[cluster.resilience]\n"
            "enabled = true\n"
            "hedge-percentile = 90.0\n"
            "breaker-threshold = 5\n"
            "timeout-min-ms = 10.0\n")
        cfg = P.Config.from_sources(toml_path=str(p), env={})
        assert cfg.cluster_resilience_enabled is True
        assert cfg.cluster_resilience_hedge_percentile == 90.0
        assert cfg.cluster_resilience_breaker_threshold == 5
        assert cfg.cluster_resilience_timeout_min_ms == 10.0
        res = P.C.Resilience.from_config(cfg)
        assert res.hedge_percentile == 90.0
        assert res.breaker.threshold == 5
        assert res.timeout_min_s == 0.01

    def test_env_override(self, P):
        cfg = P.Config.from_sources(
            env={"PILOSA_TPU_CLUSTER_RESILIENCE_HEDGE_MIN_MS": "7.5",
                 "PILOSA_TPU_CLUSTER_RESILIENCE_HEDGE": "false"})
        assert cfg.cluster_resilience_hedge_min_ms == 7.5
        res = P.C.Resilience.from_config(cfg)
        assert res.hedge_min_s == pytest.approx(0.0075)
        assert res.hedge is False

    def test_overrides_beat_config(self, P):
        res = P.C.Resilience.from_config(P.Config(), breaker_threshold=1)
        assert res.breaker.threshold == 1


def _fill(P, target, index):
    """Same dataset through any node/API surface (mirrors test_cluster)."""
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
    """A non-coordinator node owning rank-0 shards of `index` from the
    coordinator's current assignment."""
    ex = co.executor
    snap = ex._snapshot_fn()
    by_node = ex._assign(snap, index, sorted(ex._shards_fn(index)), set())
    return next(nid for nid in by_node if nid != ex.node_id)


class TestClusterFaultInjection:
    """End-to-end over LocalCluster + FaultPlan: real HTTP legs, seeded
    faults at the client boundary, results checked against a no-fault
    single-node oracle."""

    def test_all_local_fanout_uses_no_thread_pool(self, P, monkeypatch):
        c = P.LocalCluster(1)
        try:
            _fill(P, c.coordinator, "rl")
            want = c.coordinator.query("rl", "Count(Row(f=0))")

            def boom(*a, **kw):
                raise AssertionError("pool created for all-local fan-out")

            monkeypatch.setattr(
                f"{P.root}.cluster.executor.ThreadPoolExecutor", boom)
            assert c.coordinator.query("rl", "Count(Row(f=0))") == want
            c.coordinator.query("rl", f"Set({7 * P.SHARD_WIDTH}, f=1)")
            assert c.coordinator.query("rl", "Count(Row(f=1))") != want
        finally:
            c.close()

    @pytest.fixture()
    def faulty_cluster(self, P):
        plan = P.C.FaultPlan()  # seed from PILOSA_TPU_FAULT_SEED
        c = P.LocalCluster(3, replica_n=2, fault_plan=plan)
        try:
            yield c, plan
        finally:
            c.close()

    def test_hedged_straggler_matches_no_fault_oracle(self, P,
                                                      faulty_cluster):
        M = P.M
        c, plan = faulty_cluster
        oracle = P.API()
        _fill(P, oracle, "hs")
        _fill(P, c.coordinator, "hs")
        q = "Count(Row(f=0))"
        want = oracle.query("hs", q)

        co = c.coordinator
        reg = P.MetricsRegistry()
        # huge breaker threshold isolates hedging from breaker routing
        co.enable_resilience(registry=reg, hedge_min_ms=1.0,
                             breaker_threshold=1 << 30)
        try:
            for _ in range(3):  # warm the latency windows, fault-free
                assert co.query("hs", q) == want
            victim = _remote_primary(co, "hs")
            plan.delay(victim, 2.0)
            t0 = time.monotonic()
            got = co.query("hs", q)
            elapsed = time.monotonic() - t0
            plan.clear()
            assert got == want  # bit-identical despite the straggler
            assert elapsed < 1.6  # hedge beat the 2s injected delay
            assert sum(v for k, v in reg.as_json()["counters"].items()
                       if M.METRIC_CLUSTER_HEDGES in str(k)) >= 1 \
                or reg.value(M.METRIC_CLUSTER_HEDGES) >= 1.0
            assert reg.value(M.METRIC_CLUSTER_HEDGE_WINS) >= 1.0
            text = reg.prometheus_text()
            assert "cluster_hedges_total" in text
            assert "cluster_leg_latency_ms_bucket" in text
        finally:
            plan.clear()
            co.disable_resilience()

    def test_writes_never_enter_the_hedged_path(self, P, faulty_cluster):
        c, plan = faulty_cluster
        co = c.coordinator
        _fill(P, co, "wh")
        res = co.enable_resilience(hedge_min_ms=1.0)
        calls = []
        orig = res.run_legs

        def spy(remote, nodes, run_remote, next_owners, **kw):
            calls.append(kw.get("hedgeable"))
            return orig(remote, nodes, run_remote, next_owners, **kw)

        res.run_legs = spy
        try:
            co.query("wh", f"Set({9 * P.SHARD_WIDTH + 5}, f=2)")
            assert calls == []  # the write mirror path bypasses run_legs
            co.query("wh", "Count(Row(f=2))")
            assert calls and all(h is True for h in calls)
        finally:
            co.disable_resilience()

    def test_flap_recovers_within_client_retries(self, P, faulty_cluster):
        # the flapping node fails attempt 1 and recovers before attempt 2:
        # the client's jittered retry absorbs it — no failover, no
        # membership change, answer identical to the no-fault oracle
        c, plan = faulty_cluster
        oracle = P.API()
        _fill(P, oracle, "fr")
        _fill(P, c.coordinator, "fr")
        q = "Count(Row(f=0))"
        want = oracle.query("fr", q)
        co = c.coordinator
        assert co.query("fr", q) == want  # warm, fault-free
        victim = _remote_primary(co, "fr")
        downs = []
        orig_down = co.executor._on_node_down
        co.executor._on_node_down = lambda nid: (downs.append(nid),
                                                 orig_down(nid))
        try:
            plan.drop(victim, first=plan.seen(victim), count=1)
            assert co.query("fr", q) == want
            assert downs == []  # absorbed inside the client retry loop
        finally:
            co.executor._on_node_down = orig_down
            plan.clear()

    def test_failover_then_breaker_recovery(self, P):
        # retries=0 clients: a drop surfaces immediately as NodeDownError,
        # the leg fails over to the replica (answer still matches the
        # oracle), the breaker opens, and after open_ms a half-open probe
        # closes it again — firing on_node_up back into membership
        R = P.R
        plan = P.C.FaultPlan()
        c = P.LocalCluster(
            3, replica_n=2,
            client_factory=lambda i: P.InternalClient(retries=0,
                                                      fault_plan=plan))
        try:
            oracle = P.API()
            _fill(P, oracle, "fo")
            _fill(P, c.coordinator, "fo")
            q = "Count(Row(f=0))"
            want = oracle.query("fo", q)
            co = c.coordinator
            transitions = []
            reg = P.MetricsRegistry()
            # an explicit leg-timeout floor: the adaptive timeout is 4x
            # one warm leg's p99 (~13 ms on the port, ~0.5 s in the JAX
            # package, whose first leg compiles), so without it a probe
            # leg slowed past ~50 ms by a loaded host times out and
            # re-opens the breaker (threshold 1)
            res = co.enable_resilience(
                registry=reg, hedge=False, breaker_threshold=1,
                breaker_open_ms=100.0, timeout_min_ms=5000.0,
                on_breaker_transition=lambda n, f, t: transitions.append(
                    (n, f, t)))
            try:
                assert co.query("fo", q) == want  # warm, fault-free
                victim = _remote_primary(co, "fo")
                downs = []
                orig_down = co.executor._on_node_down
                co.executor._on_node_down = lambda nid: (
                    downs.append(nid), orig_down(nid))
                plan.drop(victim, first=plan.seen(victim), count=1)
                assert co.query("fo", q) == want  # replica failover
                co.executor._on_node_down = orig_down
                assert downs == [victim]
                assert res.breaker.state(victim) == R.BREAKER_OPEN
                assert reg.value(P.M.METRIC_CLUSTER_BREAKER_STATE,
                                 node=victim) == 2.0
                # heartbeat sees the node again (the drop was injected;
                # the server never actually died)
                c.disco.up(victim)
                time.sleep(0.15)  # breaker_open_ms elapses
                assert co.query("fo", q) == want  # the half-open probe
                assert res.breaker.state(victim) == R.BREAKER_CLOSED
                assert [(f, t) for n, f, t in transitions
                        if n == victim] == [
                    (R.BREAKER_CLOSED, R.BREAKER_OPEN),
                    (R.BREAKER_OPEN, R.BREAKER_HALF_OPEN),
                    (R.BREAKER_HALF_OPEN, R.BREAKER_CLOSED),
                ]
                assert c.disco.is_live(victim)  # on_node_up rejoined it
            finally:
                co.disable_resilience()
        finally:
            plan.clear()
            c.close()


# ---------------------------------------------------------------------------
# the two packages against each other
# ---------------------------------------------------------------------------

def _both():
    return _pkg(JAX), _pkg(TORCH)


def _fault_trace(P, seed):
    """Every decision of one plan over a fixed request sequence: the
    outcome of each request and the plan's event log and counts."""
    slept = []
    plan = (P.C.FaultPlan(seed=seed, sleep=slept.append)
            .drop("a", prob=0.3, op="query")
            .delay("a", 0.125, first=3, count=5)
            .flap("b", period=3, first=1)
            .drop("c", first=4, count=2, prob=0.5)
            .partition(["s1"], ["c"], symmetric=False, op="query_batch",
                       prob=0.7))
    ops = ("query", "query_batch", "import", "stats")
    out = []
    for k in range(96):
        node = "abc"[k % 3]
        op = ops[(k // 3) % len(ops)]
        src = "s1" if k % 2 else None
        try:
            plan.on_request(node, op=op, source=src)
            out.append((node, op, src, "ok"))
        except P.C.InjectedFault as e:
            out.append((node, op, src, str(e)))
        if k == 60:
            plan.heal()
    return out, plan.events, [plan.seen(n) for n in "abc"], slept


@pytest.mark.parametrize("seed", [0, 3, 23, 41])
def test_fault_plan_decisions_equal_across_packages(seed):
    J, T = _both()
    assert _fault_trace(J, seed) == _fault_trace(T, seed)


def test_latency_tracker_percentiles_equal_across_packages():
    rng = random.Random(5)
    samples = [(rng.choice("xyz"), rng.expovariate(50.0))
               for _ in range(300)]
    reads = []
    for P in _both():
        tr = P.C.LatencyTracker(window=48)
        got = []
        for i, (nid, v) in enumerate(samples):
            tr.observe(nid, v)
            if i % 7 == 0:
                got.append([tr.percentile(n, q) for n in ("x", "y", "w")
                            for q in (0.0, 50.0, 95.0, 99.0, 100.0)])
        reads.append(got)
    assert reads[0] == reads[1]


def _breaker_script(P):
    clk = P.ManualClock()
    reg = P.MetricsRegistry()
    seen = []
    br = P.C.CircuitBreaker(threshold=2, open_s=1.5, clock=clk, registry=reg,
                            on_transition=lambda *e: seen.append(("t",) + e))
    br.add_listener(lambda *e: seen.append(("l",) + e))
    rng = random.Random(11)
    steps = []
    for _ in range(200):
        nid = rng.choice("pq")
        act = rng.choice(("fail", "fail", "ok", "allow", "allow", "tick",
                          "remote_open", "remote_closed"))
        if act == "fail":
            br.record_failure(nid)
            r = None
        elif act == "ok":
            br.record_success(nid)
            r = None
        elif act == "allow":
            r = br.allow(nid)
        elif act == "tick":
            clk.advance(0.6)
            r = None
        elif act == "remote_open":
            r = br.apply_remote(nid, P.R.BREAKER_OPEN)
        else:
            r = br.apply_remote(nid, P.R.BREAKER_CLOSED)
        steps.append((nid, act, r, br.state(nid)))
    gauges = [reg.value(P.M.METRIC_CLUSTER_BREAKER_STATE, node=n)
              for n in "pq"]
    return steps, seen, br.states(), gauges


def test_breaker_state_sequence_equal_across_packages():
    J, T = _both()
    assert _breaker_script(J) == _breaker_script(T)


def _policy_reads(P):
    clk = P.ManualClock()
    res = P.C.Resilience(hedge_percentile=90.0, hedge_min_ms=3.0,
                         hedge_max_ms=400.0, timeout_factor=3.0,
                         timeout_min_ms=20.0, timeout_max_ms=5000.0,
                         latency_window=32)
    rng = random.Random(17)
    out = []
    for i in range(120):
        res.tracker.observe(rng.choice("uv"), rng.lognormvariate(-4.0, 1.2))
        row = [res.hedge_delay_s(n) for n in "uvw"]
        row += [res.leg_timeout_s(n) for n in "uvw"]
        if i % 10 == 0:
            with P.deadline_scope(P.Deadline(clk.now() + 0.05 * (i % 40),
                                             now=clk.now)):
                clk.advance(0.01)
                row += [res.leg_timeout_s(n) for n in "uvw"]
        out.append(row)
    return out


def test_hedge_delay_and_leg_timeout_equal_across_packages():
    J, T = _both()
    assert _policy_reads(J) == _policy_reads(T)
