"""Graceful-degradation (brownout) control plane (``sched/degrade.py``),
run once per package, and the two packages' ladders held against each
other.

The ``P`` fixture yields the modules of ``pilosa_tpu`` or of their
``pilosa_tpu_torch`` counterparts; ``P.API()`` builds the port's with
``device="cpu"``. Covered: every case of ``tests/test_degrade.py`` (the
hysteresis ladder, shed ordering, honest Retry-After, deadline
tightening, scheduler admission sheds, brownout stale serving with the
``stale=true`` tag, the bulk-import ingress shed and the zero-cost-off
contract), once per package; and, across the packages, equal levels,
probes and shed verdicts over one seeded stream of samples.
"""

import importlib
import random
import types

import pytest

JAX, TORCH = "pilosa_tpu", "pilosa_tpu_torch"


def _load(root: str) -> types.SimpleNamespace:
    m = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    kw = {"device": "cpu"} if root == TORCH else {}
    api_cls = m("api").API
    deg = m("sched.degrade")
    metrics = m("obs.metrics")
    return types.SimpleNamespace(
        root=root,
        API=lambda *a, **k: api_cls(*a, **{**kw, **k}),
        AdmissionError=m("errors").AdmissionError,
        METRIC_DEGRADE_STATE=metrics.METRIC_DEGRADE_STATE,
        METRIC_DEGRADE_TRANSITIONS=metrics.METRIC_DEGRADE_TRANSITIONS,
        MetricsRegistry=metrics.MetricsRegistry,
        BROWNOUT=deg.BROWNOUT, NORMAL=deg.NORMAL, SATURATED=deg.SATURATED,
        SHED_BATCH=deg.SHED_BATCH,
        DegradeController=m("sched").DegradeController,
        ResultCache=m("cache.result_cache").ResultCache,
    )


_PACKAGES = {}


def _pkg(root):
    if root not in _PACKAGES:
        _PACKAGES[root] = _load(root)
    return _PACKAGES[root]


@pytest.fixture(params=[JAX, TORCH], ids=["jax", "torch"])
def P(request):
    return _pkg(request.param)


# -- the cases of tests/test_degrade.py, once per package ---------------------


def sample(t, queue_frac=0.0, burn=0.0, rates=None):
    """One synthetic timeline sample shaped like HealthPlane's."""
    mq = 100.0
    return {
        "t": t,
        "probes": {
            "scheduler": {"max_queue": mq,
                          "queue_depth": queue_frac * mq,
                          "inflight_admits": 0},
            "slo": {"max_fast_burn": burn},
        },
        "rates": dict(rates or {}),
    }


def controller(P, **kw):
    kw.setdefault("registry", P.MetricsRegistry())
    kw.setdefault("min_dwell_s", 0.0)
    kw.setdefault("up_hold", 1)
    kw.setdefault("down_hold", 1)
    return P.DegradeController(**kw)


class TestLadderHysteresis:
    def test_escalation_jumps_recovery_steps(self, P):
        deg = controller(P)
        deg.observe(sample(0.0, queue_frac=0.99))
        assert deg.level == P.SATURATED  # escalation may jump rungs
        levels = []
        for i in range(1, 5):
            deg.observe(sample(float(i), queue_frac=0.0))
            levels.append(deg.level)
        # recovery is deliberate: one rung per qualifying sample
        assert levels == [P.BROWNOUT, P.SHED_BATCH, P.NORMAL, P.NORMAL]

    def test_up_hold_requires_consecutive_samples(self, P):
        deg = controller(P, up_hold=2)
        deg.observe(sample(0.0, queue_frac=0.99))
        assert deg.level == P.NORMAL  # one hot sample is not enough
        deg.observe(sample(0.1, queue_frac=0.0))  # streak broken
        deg.observe(sample(0.2, queue_frac=0.99))
        assert deg.level == P.NORMAL
        deg.observe(sample(0.3, queue_frac=0.99))  # second consecutive
        assert deg.level == P.SATURATED

    def test_down_hold_and_exit_band(self, P):
        deg = controller(P, queue_shed=0.5, exit_ratio=0.7, down_hold=2)
        deg.observe(sample(0.0, queue_frac=0.6))
        assert deg.level == P.SHED_BATCH
        # inside the hysteresis band (exit edge 0.35 <= q < 0.5):
        # neither escalation nor recovery, and streaks reset
        for i in range(1, 6):
            deg.observe(sample(float(i), queue_frac=0.4))
            assert deg.level == P.SHED_BATCH
        deg.observe(sample(6.0, queue_frac=0.1))
        assert deg.level == P.SHED_BATCH  # down_hold=2: first sample holds
        deg.observe(sample(7.0, queue_frac=0.1))
        assert deg.level == P.NORMAL

    def test_min_dwell_blocks_flapping(self, P):
        deg = controller(P, min_dwell_s=1.0, down_hold=1)
        deg.observe(sample(0.0, queue_frac=0.99))
        assert deg.level == P.SATURATED
        deg.observe(sample(0.5, queue_frac=0.0))  # too soon to move
        assert deg.level == P.SATURATED
        deg.observe(sample(1.5, queue_frac=0.0))
        assert deg.level == P.BROWNOUT

    def test_burn_and_aux_signals_drive_ladder(self, P):
        deg = controller(P, burn_shed=2.0, burn_brownout=6.0,
                         burn_saturate=14.0)
        deg.observe(sample(0.0, burn=7.0))
        assert deg.level == P.BROWNOUT
        deg.reset()
        # deadline-miss rate is a BROWNOUT signal, evictions a
        # SHED_BATCH signal; both arrive via the counter-delta map
        deg2 = controller(P, miss_rate_brownout=1.0)
        deg2.observe(
            sample(0.0, rates={"sched_deadline_missed_total": 2.0}))
        assert deg2.level == P.BROWNOUT
        deg3 = controller(P, eviction_rate_shed=5.0)
        deg3.observe(
            sample(0.0, rates={"device_budget_evictions_total": 9.0}))
        assert deg3.level == P.SHED_BATCH

    def test_transitions_are_metered_and_recorded(self, P):
        reg = P.MetricsRegistry()
        deg = controller(P, registry=reg)

        class FakeFlight:
            def __init__(self):
                self.events = []
                self.triggers = []

            def record_event(self, kind, **info):
                self.events.append((kind, info))

            def trigger(self, name, reason, sample=None):
                self.triggers.append((name, reason))

        deg.flight = fl = FakeFlight()
        deg.observe(sample(0.0, queue_frac=0.99))
        deg.observe(sample(1.0))
        assert deg.probe()["transitions"] == 2
        assert [k for k, _ in fl.events] == ["degrade_transition"] * 2
        assert fl.triggers and fl.triggers[0][0] == "degrade_escalation"
        text = reg.prometheus_text()
        assert P.METRIC_DEGRADE_STATE in text
        assert P.METRIC_DEGRADE_TRANSITIONS in text


class TestShedContract:
    def test_shed_order_batch_before_interactive(self, P):
        deg = controller(P)
        assert deg.shed_reason("batch") is None
        deg._level = P.SHED_BATCH
        assert deg.shed_reason("batch") == "degrade_shed_batch"
        assert deg.shed_reason("interactive") is None
        deg._level = P.BROWNOUT
        assert deg.shed_reason("interactive") is None
        deg._level = P.SATURATED
        assert deg.shed_reason("batch") == "degrade_shed_batch"
        assert deg.shed_reason("interactive") == "degrade_saturated"

    def test_shed_carries_live_retry_after(self, P):
        deg = controller(P, retry_after_s=2.5)
        deg._level = P.SATURATED
        err = deg.shed("interactive")
        assert isinstance(err, P.AdmissionError)
        assert err.retry_after_s == 2.5  # static default until wired
        deg.retry_after_fn = lambda: 0.75
        assert deg.shed("batch").retry_after_s == 0.75
        assert deg.shed("batch", retry_after_s=0.2).retry_after_s == 0.2

    def test_tighten_deadline_only_at_brownout(self, P):
        deg = controller(P, deadline_factor=0.5, brownout_deadline_ms=250.0)
        assert deg.tighten_deadline(1.0) == 1.0
        deg._level = P.BROWNOUT
        assert deg.tighten_deadline(1.0) == 0.5
        assert deg.tighten_deadline(0.0) == 0.25  # imposed default


class TestSchedulerIntegration:
    @pytest.fixture
    def api(self, P):
        a = P.API()
        a.create_index("i")
        a.create_field("i", "f")
        a.import_bits("i", "f", rows=[1, 1, 2], cols=[1, 2, 3])
        a.enable_scheduler()
        yield a
        a.disable_scheduler()

    def test_admission_sheds_in_ladder_order(self, P, api):
        deg = api.enable_degrade(min_dwell_s=0.0)
        deg._level = P.SHED_BATCH
        with pytest.raises(P.AdmissionError) as ei:
            with api.scheduler.admit(priority="batch"):
                pass
        assert ei.value.retry_after_s > 0
        assert "batch" in str(ei.value)
        # interactive flows at SHED_BATCH, sheds only at SATURATED
        assert api.query_json("i", "Count(Row(f=1))")["results"] == [2]
        deg._level = P.SATURATED
        with pytest.raises(P.AdmissionError):
            api.query_json("i", "Count(Row(f=1))")

    def test_import_ingress_shed_helper(self, P, api):
        deg = api.enable_degrade()
        api._degrade_shed_batch()  # NORMAL: no-op
        deg._level = P.SHED_BATCH
        with pytest.raises(P.AdmissionError):
            api._degrade_shed_batch()
        # direct import_bits is NOT shed: SQL DML, WAL replay, and
        # fan-out legs must never be torn mid-statement
        assert api.import_bits("i", "f", rows=[3], cols=[9]) == 1

    def test_zero_cost_off(self, P, api):
        api.disable_degrade()  # under the PILOSA_TPU_DEGRADE=1 lane
        assert api.degrade is None
        reg = api.scheduler.registry

        def degrade_lines():
            # the registry is process-global: other tests may have moved
            # degrade metrics, so zero-cost means NO MOVEMENT, not absence
            return [line for line in reg.prometheus_text().splitlines()
                    if "degrade_" in line]

        before = degrade_lines()
        with api.scheduler.admit(priority="batch"):
            pass
        assert api.query_json("i", "Count(Row(f=2))")["results"] == [1]
        assert degrade_lines() == before

    def test_env_auto_enable(self, P, monkeypatch):
        monkeypatch.setenv("PILOSA_TPU_DEGRADE", "1")
        a = P.API()
        try:
            assert a.degrade is not None
            assert a.degrade.level == P.NORMAL
        finally:
            a.disable_scheduler()


class TestBrownoutStaleServing:
    def test_stale_serve_is_tagged_and_recovers(self, P):
        api = P.API()
        try:
            api.create_index("i")
            api.create_field("i", "f")
            api.import_bits("i", "f", rows=[1, 1], cols=[1, 2])
            api.enable_cache()
            deg = api.enable_degrade()
            q = "Count(Row(f=1))"
            assert api.query_json("i", q) == {"results": [2]}
            # the write moves the version fingerprint: the cached entry
            # is now stale-by-version, not expired
            api.import_bits("i", "f", rows=[1], cols=[3])
            fresh = api.query_json("i", q)
            assert fresh == {"results": [3]}
            api.import_bits("i", "f", rows=[1], cols=[4])
            deg._level = P.BROWNOUT
            browned = api.query_json("i", q)
            assert browned["results"] == [3]  # previous answer
            assert browned["stale"] is True
            assert api.cache.stats()["stale_serves"] == 1
            # recovery: fresh execution again, no stale tag
            deg.reset()
            recovered = api.query_json("i", q)
            assert recovered == {"results": [4]}
        finally:
            api.disable_cache()

    def test_stale_disabled_for_remote_legs(self, P):
        cache = P.ResultCache(registry=P.MetricsRegistry())
        deg = controller(P)
        deg._level = P.BROWNOUT
        cache.degrade = deg
        key = ("q", "i", "fp1")
        cache.run(key, lambda: [1])
        moved = ("q", "i", "fp2")
        # client-facing leg: stale predecessor served and flagged
        hit, value = cache.lookup(moved)
        assert (hit, value) == (True, [1])
        assert cache.take_stale_flag() is True
        # remote-serving leg: allow_stale=False never serves stale
        hit, _ = cache.lookup(moved, allow_stale=False)
        assert hit is False
        assert cache.take_stale_flag() is False


# -- across the packages -------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ladders_agree_over_a_seeded_sample_stream(seed):
    """Both controllers, fed the same samples, walk the same rungs and
    report the same probe and shed verdicts after every sample."""
    rng = random.Random(seed)
    ctls = [controller(_pkg(r), up_hold=2, down_hold=2, min_dwell_s=0.5)
            for r in (JAX, TORCH)]
    for i in range(300):
        s = sample(i * 0.25, queue_frac=rng.random() ** 2,
                   burn=rng.choice([0.0, 1.0, 3.0, 8.0, 20.0]),
                   rates={"sched_deadline_missed_total":
                          rng.choice([0.0, 0.5, 2.0])})
        for c in ctls:
            c.observe(s)
        probes = [c.probe() for c in ctls]
        assert probes[0] == probes[1]
        for prio in ("batch", "interactive"):
            assert ctls[0].shed_reason(prio) == ctls[1].shed_reason(prio)
        assert ctls[0].tighten_deadline(1.0) == ctls[1].tighten_deadline(1.0)
    assert ctls[0].probe()["transitions"] > 4
