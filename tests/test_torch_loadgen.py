"""Open-loop load driver (``loadgen/``), run once per package, and the
two packages' schedules held against each other.

The ``P`` fixture yields the modules of ``pilosa_tpu`` or of their
``pilosa_tpu_torch`` counterparts. Covered: every case of
``tests/test_loadgen.py`` (schedule determinism, arrival processes,
scenario mixes, synthetic tenant populations, outcome classification,
the ManualClock virtual twin, intended-send-time latency, good-put
bucketing and the ChaosSchedule fire-once contract), once per package;
and, across the packages, the same seed gives the same schedule, tenant
picks and virtual-run report.
"""

import importlib
import time
import types

import pytest

JAX, TORCH = "pilosa_tpu", "pilosa_tpu_torch"


def _load(root: str) -> types.SimpleNamespace:
    m = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    lg = m("loadgen")
    sc = m("loadgen.scenarios")
    return types.SimpleNamespace(
        root=root,
        AdmissionError=m("errors").AdmissionError,
        QuotaExceededError=m("errors").QuotaExceededError,
        ChaosSchedule=lg.ChaosSchedule,
        OpenLoopDriver=lg.OpenLoopDriver,
        ScenarioMix=lg.ScenarioMix,
        SyntheticTenants=lg.SyntheticTenants,
        DEFAULT_MIX=sc.DEFAULT_MIX,
        KIND_BULK_IMPORT=lg.KIND_BULK_IMPORT,
        KIND_INTERACTIVE=lg.KIND_INTERACTIVE,
        KIND_SQL=lg.KIND_SQL,
        ManualClock=m("sched").ManualClock,
    )


_PACKAGES = {}


def _pkg(root):
    if root not in _PACKAGES:
        _PACKAGES[root] = _load(root)
    return _PACKAGES[root]


@pytest.fixture(params=[JAX, TORCH], ids=["jax", "torch"])
def P(request):
    return _pkg(request.param)


# -- the cases of tests/test_loadgen.py, once per package ---------------------


def driver(P, execute=lambda op: "ok", **kw):
    kw.setdefault("rate_per_s", 100.0)
    kw.setdefault("duration_s", 1.0)
    kw.setdefault("seed", 7)
    return P.OpenLoopDriver(execute, **kw)


class TestSchedule:
    def test_same_seed_same_schedule(self, P):
        a = driver(P, arrivals="poisson").schedule
        b = driver(P, arrivals="poisson").schedule
        assert [(o.op_id, o.kind, o.tenant, o.intended_t) for o in a] \
            == [(o.op_id, o.kind, o.tenant, o.intended_t) for o in b]
        c = driver(P, arrivals="poisson", seed=8).schedule
        assert [(o.kind, o.tenant, o.intended_t) for o in a] \
            != [(o.kind, o.tenant, o.intended_t) for o in c]

    def test_uniform_arrivals_are_evenly_spaced(self, P):
        sched = driver(P, rate_per_s=100.0, duration_s=0.5).schedule
        assert len(sched) == 50
        for i, op in enumerate(sched):
            assert op.intended_t == pytest.approx(i * 0.01)

    def test_poisson_arrivals_monotone_within_duration(self, P):
        sched = driver(P, rate_per_s=200.0, duration_s=1.0,
                       arrivals="poisson").schedule
        assert 100 < len(sched) < 320  # ~200 +- slack
        ts = [op.intended_t for op in sched]
        assert ts == sorted(ts)
        assert all(0.0 <= t < 1.0 for t in ts)

    def test_invalid_parameters_rejected(self, P):
        with pytest.raises(ValueError):
            driver(P, rate_per_s=0.0)
        with pytest.raises(ValueError):
            driver(P, duration_s=0.0)
        with pytest.raises(ValueError):
            driver(P, arrivals="bursty")


class TestScenarioMix:
    def test_weights_govern_pick_frequency(self, P):
        mix = P.ScenarioMix({P.KIND_INTERACTIVE: 0.9, P.KIND_SQL: 0.1})
        sched = driver(P, mix=mix, rate_per_s=1000.0).schedule
        kinds = [op.kind for op in sched]
        assert set(kinds) == {P.KIND_INTERACTIVE, P.KIND_SQL}
        frac = kinds.count(P.KIND_INTERACTIVE) / len(kinds)
        assert 0.85 < frac < 0.95

    def test_default_mix_covers_all_kinds(self, P):
        sched = driver(P, rate_per_s=2000.0, duration_s=2.0).schedule
        assert {op.kind for op in sched} == set(P.DEFAULT_MIX)

    def test_bad_mixes_rejected(self, P):
        with pytest.raises(ValueError):
            P.ScenarioMix({})
        with pytest.raises(ValueError):
            P.ScenarioMix({P.KIND_SQL: -1.0})
        with pytest.raises(ValueError):
            P.ScenarioMix({P.KIND_SQL: 0.0})


class TestSyntheticTenants:
    def test_skewed_head_and_reachable_tail(self, P):
        pop = P.SyntheticTenants(100_000, seed=3)
        picks = [pop.pick() for _ in range(5_000)]
        counts = {}
        for p in picks:
            counts[p] = counts.get(p, 0) + 1
        # rank 0 dominates any deep rank
        assert counts[pop.name(0)] > 50
        # the uniform 5% tail draw reaches past the ranked head
        assert any(int(p[1:]) >= 4096 for p in picks)

    def test_deterministic_and_bounded_names(self, P):
        a = P.SyntheticTenants(1000, seed=5)
        b = P.SyntheticTenants(1000, seed=5)
        assert [a.pick() for _ in range(100)] \
            == [b.pick() for _ in range(100)]
        assert a.name(7) == "t0000007"
        assert sum(1 for _ in P.SyntheticTenants(500).all_ids()) == 500


class TestClassification:
    def outcomes(self, P, execute):
        clock = P.ManualClock()
        rep = driver(P, execute, rate_per_s=10.0).run_virtual(clock)
        return rep

    def test_raw_outcome_forms(self, P):
        rep = self.outcomes(P, lambda op: None)
        assert rep.ok == rep.total == 10
        rep = self.outcomes(P, lambda op: "shed")
        assert rep.shed == 10
        rep = self.outcomes(P, 
            lambda op: {"outcome": "ok", "stale": op.op_id % 2 == 0})
        assert rep.ok == 10 and rep.stale == 5

    def test_admission_error_counts_as_shed_not_error(self, P):
        def execute(op):
            if op.op_id % 2:
                raise P.AdmissionError("full", retry_after_s=1.0)
            raise P.QuotaExceededError("quota", retry_after_s=1.0)

        rep = self.outcomes(P, execute)
        assert rep.shed == 10 and rep.errors == 0

    def test_unexpected_exception_counts_as_error(self, P):
        rep = self.outcomes(P, lambda op: 1 / 0)
        assert rep.errors == 10
        assert rep.latency_quantile(0.99) == 0.0  # ok-only quantile


class TestVirtualRun:
    def test_clock_advances_to_duration_and_replays(self, P):
        clock = P.ManualClock()
        seen = []
        d = driver(P, lambda op: seen.append((op.op_id, clock.now())),
                   rate_per_s=10.0, duration_s=1.0)
        rep = d.run_virtual(clock)
        assert clock.now() == pytest.approx(1.0)
        assert rep.total == 10
        # each op ran exactly at its intended tick
        assert [t for _, t in seen] == pytest.approx(
            [i * 0.1 for i in range(10)])

    def test_goodput_buckets_by_intended_time(self, P):
        clock = P.ManualClock()
        d = driver(P, lambda op: "ok" if op.intended_t < 1.0 else "shed",
                   rate_per_s=10.0, duration_s=2.0)
        rep = d.run_virtual(clock)
        assert rep.goodput_per_s(bucket_s=1.0) == [10.0, 0.0]
        with pytest.raises(ValueError):
            rep.goodput_per_s(bucket_s=0.0)

    def test_chaos_fires_at_offsets_exactly_once(self, P):
        clock = P.ManualClock()
        fired_at = []
        chaos = (P.ChaosSchedule()
                 .at(0.25, lambda: fired_at.append(clock.now()), "a")
                 .at(0.75, lambda: fired_at.append(clock.now()), "b")
                 .at(0.50, lambda: 1 / 0, "boom"))
        d = driver(P, rate_per_s=20.0, duration_s=1.0, chaos=chaos)
        d.run_virtual(clock)
        assert chaos.pending() == 0
        # in-order, once each; the raising event is marked fired with !
        assert chaos.fired() == ["a", "boom!", "b"]
        assert fired_at[0] >= 0.25 and fired_at[1] >= 0.75

    def test_chaos_needs_plan_or_cluster(self, P):
        with pytest.raises(ValueError):
            P.ChaosSchedule().drop(0.0, "node1")
        with pytest.raises(ValueError):
            P.ChaosSchedule().pause(0.0, 1)


class TestOpenLoopLatency:
    def test_backlog_shows_as_latency_not_omission(self, P):
        # one worker, 20ms service, ops every 10ms: a closed-loop
        # generator would halve the measured rate and hide the queueing;
        # the open loop records EVERY op, with latency from the
        # intended send time growing as the backlog builds
        def execute(op):
            time.sleep(0.02)
            return "ok"

        d = driver(P, execute, rate_per_s=100.0, duration_s=0.3,
                   max_workers=1)
        rep = d.run()
        assert rep.total == len(d.schedule)  # nothing omitted
        p50 = rep.latency_quantile(0.50)
        p99 = rep.latency_quantile(0.99)
        assert p99 > p50 >= 0.02
        assert p99 > 0.1  # tail saw the accumulated backlog


# -- across the packages -------------------------------------------------------


@pytest.mark.parametrize("arrivals", ["uniform", "poisson"])
def test_same_seed_same_schedule_and_report_in_both_packages(arrivals):
    reports = []
    for r in (JAX, TORCH):
        P = _pkg(r)
        d = driver(P, lambda op: ("shed" if op.op_id % 7 == 0 else
                                  {"outcome": "ok",
                                   "stale": op.op_id % 5 == 0}),
                   rate_per_s=400.0, duration_s=2.0, arrivals=arrivals,
                   tenants=P.SyntheticTenants(100_000, seed=22), seed=22)
        sched = [(o.op_id, o.kind, o.tenant, o.intended_t)
                 for o in d.schedule]
        rep = d.run_virtual(P.ManualClock())
        reports.append((sched, rep.ok, rep.shed, rep.errors, rep.stale,
                        rep.total, rep.goodput_per_s(bucket_s=0.5)))
    assert reports[0] == reports[1]
    assert reports[0][5] > 500
