"""The observability slice's modules, held against the JAX package's.

Every test runs once per package: the ``P`` fixture yields the modules of
``pilosa_tpu`` or of their ``pilosa_tpu_torch`` counterparts, and the
test body is the same (the port's API runs with ``device="cpu"``).
Covered, as the JAX package's own tests drive them:

* the health plane (``tests/test_health.py``): ``TestTimelineSampler``,
  ``TestSLOTracker``, ``TestExemplars``, ``TestFlightRecorder`` and
  ``TestAPIHealth``;
* the device profiler (``tests/test_devprof.py``): ``TestCostModel``,
  ``TestKernelProfileRegistry``, ``TestGating``, ``TestHooks``,
  ``TestIngestStages`` and the two timeline-probe cases;
* the ``ingest_stall`` trigger (``tests/test_stream.py``
  ``TestIngestStallTrigger``);
* the two metric families the port now keeps: the resident-bytes gauges
  of ``DeviceBudget`` and the ``METRIC_COMPRESS_*`` series, whose values
  after the same build, evict, release, compress and count sequence equal
  the JAX package's.

The profiler's query families are read after a ``reset()`` that follows
the data load: the port's import launches ``scatter_merge`` (a
``pallas/…/scatter`` family), which the JAX package's CPU import does
not. No test waits on the wall clock: samplers and SLOs run on
``ManualClock``.
"""

import importlib
import json
import threading
import types

import numpy as np
import pytest

JAX, TORCH = "pilosa_tpu", "pilosa_tpu_torch"


def _load(root: str) -> types.SimpleNamespace:
    m = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    api_cls = m("api").API
    kw = {"device": "cpu"} if root == TORCH else {}
    return types.SimpleNamespace(
        root=root,
        M=m("obs.metrics"),
        T=m("obs.tracing"),
        timeline=m("obs.timeline"),
        slo=m("obs.slo"),
        flight=m("obs.flight"),
        health=m("obs.health"),
        devprof=m("obs.devprof"),
        platform=m("platform"),
        stacked=m("core.stacked"),
        ctiles=m("ops.ctiles"),
        ManualClock=m("sched.clock").ManualClock,
        Config=m("config").Config,
        SHARD_WIDTH=m("shardwidth").SHARD_WIDTH,
        API=lambda *a, **k: api_cls(*a, **{**kw, **k}),
        Ingester=m("ingest.ingest").Ingester,
        CSVSource=m("ingest.source").CSVSource,
        scenario=m("ingest.datagen").scenario,
    )


_PACKAGES = {}


def _pkg(root):
    if root not in _PACKAGES:
        _PACKAGES[root] = _load(root)
    return _PACKAGES[root]


@pytest.fixture(params=[JAX, TORCH], ids=["jax", "torch"])
def P(request):
    return _pkg(request.param)


# ---------------------------------------------------------------------------
# timeline sampler (tests/test_health.py TestTimelineSampler)
# ---------------------------------------------------------------------------


class TestTimelineSampler:
    def test_counter_deltas_become_rates(self, P):
        reg = P.M.MetricsRegistry()
        clock = P.ManualClock()
        tl = P.timeline.TimelineSampler(interval_ms=100, capacity=10,
                                        registry=reg, clock=clock)
        reg.count("reqs_total", 5)
        first = tl.sample()
        assert first["rates"] == {}
        clock.advance(2.0)
        reg.count("reqs_total", 10)
        assert tl.sample()["rates"]["reqs_total"] == pytest.approx(5.0)

    def test_histogram_quantiles_over_interval_deltas(self, P):
        reg = P.M.MetricsRegistry()
        clock = P.ManualClock()
        tl = P.timeline.TimelineSampler(registry=reg, clock=clock)
        for v in (3.0, 3.0, 3.0, 3.0):
            reg.observe_bucketed("lat_ms", v, (2.0, 4.0, 8.0))
        q = tl.sample()["quantiles"]["lat_ms"]
        assert q["count"] == 4
        assert 2.0 <= q["p50"] <= 4.0
        clock.advance(1.0)
        assert "lat_ms" not in tl.sample()["quantiles"]

    def test_estimate_quantile_interpolates(self, P):
        eq = P.timeline.estimate_quantile
        assert eq([10.0, 20.0, 30.0], [0, 4, 0, 0], 0.5) \
            == pytest.approx(15.0)
        assert eq([10.0, 20.0], [0, 0, 3], 0.99) == 20.0
        assert eq([10.0], [0, 0], 0.5) == 0.0

    def test_estimate_quantile_empty_delta_window(self, P):
        eq = P.timeline.estimate_quantile
        for q in (0.0, 0.5, 0.99, 1.0):
            assert eq([10.0, 20.0], [0, 0, 0], q) == 0.0
        assert eq([], [], 0.5) == 0.0
        assert eq([10.0], [-2, 0], 0.5) == 0.0

    def test_estimate_quantile_single_populated_bucket(self, P):
        eq = P.timeline.estimate_quantile
        bounds = [10.0, 20.0, 30.0]
        assert eq(bounds, [0, 10, 0, 0], 0.1) == pytest.approx(11.0)
        assert eq(bounds, [0, 10, 0, 0], 1.0) == pytest.approx(20.0)
        assert eq(bounds, [4, 0, 0, 0], 0.5) == pytest.approx(5.0)

    def test_estimate_quantile_all_counts_in_overflow(self, P):
        eq = P.timeline.estimate_quantile
        for q in (0.01, 0.5, 1.0):
            assert eq([10.0, 20.0, 30.0], [0, 0, 0, 7], q) == 30.0
        assert eq([], [5], 0.5) == 0.0

    def test_estimate_quantile_exact_bucket_boundary(self, P):
        eq = P.timeline.estimate_quantile
        bounds, counts = [10.0, 20.0], [2, 2, 0]
        assert eq(bounds, counts, 0.5) == pytest.approx(10.0)
        assert eq(bounds, counts, 1.0) == pytest.approx(20.0)
        assert eq(bounds, counts, 0.0) == pytest.approx(0.0)

    def test_window_filters_by_clock(self, P):
        clock = P.ManualClock()
        tl = P.timeline.TimelineSampler(registry=P.M.MetricsRegistry(),
                                        clock=clock)
        for _ in range(3):
            tl.sample()
            clock.advance(2.0)
        assert len(tl.window(2.5)) == 1
        assert len(tl.window(5.0)) == 2
        assert len(tl.window(None)) == 3

    def test_sick_probe_degrades_not_fatal(self, P):
        tl = P.timeline.TimelineSampler(registry=P.M.MetricsRegistry(),
                                        clock=P.ManualClock())
        tl.add_probe("bad", lambda: 1 / 0)
        tl.add_probe("good", lambda: {"v": 1})
        s = tl.sample()
        assert "error" in s["probes"]["bad"]
        assert s["probes"]["good"] == {"v": 1}

    def test_maybe_sample_respects_cadence(self, P):
        clock = P.ManualClock()
        tl = P.timeline.TimelineSampler(
            interval_ms=1000, registry=P.M.MetricsRegistry(), clock=clock)
        assert tl.maybe_sample() is not None
        assert tl.maybe_sample() is None
        clock.advance(1.5)
        assert tl.maybe_sample() is not None

    def test_ring_bounded(self, P):
        clock = P.ManualClock()
        tl = P.timeline.TimelineSampler(
            capacity=4, registry=P.M.MetricsRegistry(), clock=clock)
        for _ in range(9):
            tl.sample()
            clock.advance(1.0)
        assert len(tl) == 4


# ---------------------------------------------------------------------------
# SLO burn rates (tests/test_health.py TestSLOTracker)
# ---------------------------------------------------------------------------


def _latency_slo(P, threshold_ms=100.0, target=0.9):
    return P.slo.Objective("q-lat", "query", "latency", target,
                           threshold_ms=threshold_ms)


class TestSLOTracker:
    def test_burn_rate_is_bad_fraction_over_budget(self, P):
        slo = P.slo.SLOTracker(objectives=[_latency_slo(P)],
                               registry=P.M.MetricsRegistry(),
                               clock=P.ManualClock(), fast_burn_alert=4.0)
        for i in range(10):
            slo.record("query", 500.0 if i < 5 else 10.0)
        row = slo.burn_rates()[0]
        assert row["fast_burn"] == pytest.approx(5.0)
        assert row["alerting"] is True
        assert slo.status()["alerting"] == ["q-lat"]

    def test_min_events_guards_single_sample_spikes(self, P):
        slo = P.slo.SLOTracker(objectives=[_latency_slo(P)],
                               registry=P.M.MetricsRegistry(),
                               clock=P.ManualClock(), fast_burn_alert=1.0,
                               min_events=5)
        slo.record("query", 9999.0)
        row = slo.burn_rates()[0]
        assert row["fast_burn"] > 1.0 and row["alerting"] is False

    def test_error_objective(self, P):
        obj = P.slo.Objective("q-err", "query", "errors", 0.99)
        slo = P.slo.SLOTracker(objectives=[obj],
                               registry=P.M.MetricsRegistry(),
                               clock=P.ManualClock())
        for i in range(10):
            slo.record("query", 1.0, error=(i == 0))
        assert slo.burn_rates()[0]["fast_burn"] == pytest.approx(10.0)

    def test_events_age_out_of_fast_window(self, P):
        clock = P.ManualClock()
        slo = P.slo.SLOTracker(objectives=[_latency_slo(P)],
                               registry=P.M.MetricsRegistry(), clock=clock,
                               fast_window_s=60.0, slow_window_s=600.0)
        for _ in range(6):
            slo.record("query", 500.0)
        assert slo.burn_rates()[0]["fast_burn"] > 0
        clock.advance(120.0)
        row = slo.burn_rates()[0]
        assert row["fast_burn"] == 0.0
        assert row["slow_burn"] > 0.0

    def test_publishes_gauges(self, P):
        reg = P.M.MetricsRegistry()
        slo = P.slo.SLOTracker(objectives=[_latency_slo(P)], registry=reg,
                               clock=P.ManualClock())
        slo.record("query", 500.0)
        slo.burn_rates()
        assert reg.value(P.M.METRIC_SLO_BURN_RATE, slo="q-lat",
                         window="fast") > 0

    def test_tenant_burn_rates(self, P):
        reg = P.M.MetricsRegistry()
        slo = P.slo.SLOTracker(objectives=[_latency_slo(P)], registry=reg,
                               clock=P.ManualClock(), fast_burn_alert=4.0)
        assert slo.tenant_burn_rates() == []
        for i in range(10):
            slo.record("query", 500.0 if i % 2 else 10.0, tenant="acme")
            slo.record("query", 10.0, tenant="zed")
        rows = {r["tenant"]: r for r in slo.tenant_burn_rates()}
        assert rows["acme"]["fast_burn"] == pytest.approx(5.0)
        assert rows["zed"]["fast_burn"] == 0.0
        assert [r["tenant"] for r in slo.tenant_alerting()] == ["acme"]
        assert reg.value(P.M.METRIC_SLO_BURN_RATE, slo="q-lat",
                         tenant="acme", window="fast") == pytest.approx(5.0)


# ---------------------------------------------------------------------------
# trace exemplars (tests/test_health.py TestExemplars)
# ---------------------------------------------------------------------------


class TestExemplars:
    def test_bucket_links_to_active_trace(self, P):
        T = P.T
        prev = T.get_tracer()
        tracer = T.set_tracer(T.Tracer(enabled=True, sample_rate=1.0,
                                       store=T.TraceStore(8)))
        reg = P.M.MetricsRegistry(exemplars=True)
        try:
            span = tracer.start_trace("x")
            reg.observe_bucketed("lat_ms", 3.0, (1.0, 5.0, 10.0))
            span.finish()
        finally:
            T.set_tracer(prev)
        line = next(ln for ln in reg.prometheus_text().splitlines()
                    if ln.startswith('pilosa_lat_ms_bucket{le="5"'))
        assert f'# {{trace_id="{span.trace_id}"}} 3' in line

    def test_disabled_by_default(self, P):
        T = P.T
        prev = T.get_tracer()
        tracer = T.set_tracer(T.Tracer(enabled=True, sample_rate=1.0))
        reg = P.M.MetricsRegistry()
        try:
            span = tracer.start_trace("x")
            reg.observe_bucketed("lat_ms", 3.0, (1.0, 5.0))
            span.finish()
        finally:
            T.set_tracer(prev)
        assert "trace_id=" not in reg.prometheus_text()

    def test_no_exemplar_outside_trace(self, P):
        reg = P.M.MetricsRegistry(exemplars=True)
        reg.observe_bucketed("lat_ms", 3.0, (1.0, 5.0))
        assert "trace_id=" not in reg.prometheus_text()

    def test_trace_histograms_carry_exemplars_at_finish(self, P):
        T = P.T
        prev = T.get_tracer()
        reg = P.M.MetricsRegistry(exemplars=True)
        tracer = T.set_tracer(T.Tracer(enabled=True, sample_rate=1.0,
                                       registry=reg))
        try:
            span = tracer.start_trace("q")
            with tracer.start_span("stage.one"):
                pass
            span.finish()
        finally:
            T.set_tracer(prev)
        text = reg.prometheus_text()
        for series in ("trace_duration_ms_bucket",
                       "trace_stage_latency_ms_bucket"):
            line = next(ln for ln in text.splitlines()
                        if ln.startswith(f"pilosa_{series}")
                        and "trace_id=" in ln)
            assert f'trace_id="{span.trace_id}"' in line

    def test_disable_health_clears_exemplar_flag(self, P):
        api = P.API()
        assert P.M.REGISTRY.exemplars is False
        api.enable_health(config=P.Config(obs_timeline_exemplars=True))
        assert P.M.REGISTRY.exemplars is True
        api.disable_health()
        assert P.M.REGISTRY.exemplars is False


# ---------------------------------------------------------------------------
# flight recorder (tests/test_health.py TestFlightRecorder)
# ---------------------------------------------------------------------------


def _plane(P, clock, reg, **kw):
    kw.setdefault("interval_ms", 100.0)
    kw.setdefault("min_events", 1)
    return P.health.HealthPlane(registry=reg, clock=clock, **kw)


class TestFlightRecorder:
    def test_wal_stall_trigger(self, P):
        hp = _plane(P, P.ManualClock(), P.M.MetricsRegistry(),
                    wal_stall_s=5.0)
        hp.timeline.add_probe("wal", lambda: {"flush_lag_s": 9.0})
        hp.timeline.sample()
        bundles = hp.flight.bundles()
        assert [b["trigger"] for b in bundles] == ["wal_stall"]
        assert "9.0s" in bundles[0]["reason"]

    def test_breaker_open_trigger_from_probe(self, P):
        hp = _plane(P, P.ManualClock(), P.M.MetricsRegistry())
        hp.timeline.add_probe(
            "breakers", lambda: {"enabled": True,
                                 "states": {"n2": "open", "n3": "closed"}})
        hp.timeline.sample()
        b = hp.flight.bundles()[0]
        assert b["trigger"] == "breaker_open" and "n2" in b["reason"]

    def test_eviction_storm_trigger(self, P):
        clock, reg = P.ManualClock(), P.M.MetricsRegistry()
        hp = _plane(P, clock, reg, eviction_rate=10.0)
        hp.timeline.sample()
        clock.advance(1.0)
        reg.count(P.M.METRIC_DEVICE_STACK_EVICTIONS, 50)
        hp.timeline.sample()
        assert [b["trigger"] for b in hp.flight.bundles()] \
            == ["eviction_storm"]

    def test_slow_query_burst_trigger(self, P):
        clock, reg = P.ManualClock(), P.M.MetricsRegistry()
        hp = _plane(P, clock, reg, slow_burst_per_s=5.0)
        hp.timeline.sample()
        clock.advance(1.0)
        reg.count(P.M.METRIC_TRACE_SLOW_QUERIES, 10, kind="pql")
        hp.timeline.sample()
        assert [b["trigger"] for b in hp.flight.bundles()] \
            == ["slow_query_burst"]

    def test_membership_flap_trigger(self, P):
        clock = P.ManualClock()
        hp = _plane(P, clock, P.M.MetricsRegistry(),
                    membership_flap_transitions=6.0)
        flaps = {"n": 2}
        hp.timeline.add_probe(
            "membership",
            lambda: {"enabled": True, "alive": 3, "suspect": 0, "down": 0,
                     "recent_transitions": flaps["n"]})
        hp.timeline.sample()
        assert hp.flight.bundles() == []
        clock.advance(1.0)
        flaps["n"] = 7
        hp.timeline.sample()
        bundles = hp.flight.bundles()
        assert [b["trigger"] for b in bundles] == ["membership_flap"]
        assert "7 membership transitions" in bundles[0]["reason"]

    def test_membership_probe_absent_never_fires(self, P):
        hp = _plane(P, P.ManualClock(), P.M.MetricsRegistry(),
                    membership_flap_transitions=1.0)
        hp.timeline.sample()
        assert hp.flight.bundles() == []

    def test_directive_churn_trigger(self, P):
        hp = _plane(P, P.ManualClock(), P.M.MetricsRegistry(),
                    directive_churn_bumps=8.0)
        hp.timeline.add_probe("dax", lambda: {
            "enabled": True, "recent_directive_bumps": 9})
        hp.timeline.sample()
        bundles = hp.flight.bundles()
        assert [b["trigger"] for b in bundles] == ["directive_churn"]
        assert "9 directive bumps" in bundles[0]["reason"]

    def test_lock_violation_fires_on_growth_only(self, P):
        clock = P.ManualClock()
        hp = _plane(P, clock, P.M.MetricsRegistry(), flight_cooldown_s=0.0)
        seen = {"v": 2}
        hp.timeline.add_probe("locks", lambda: {
            "enabled": True, "violations": seen["v"], "cycles": 1})
        hp.timeline.sample()
        clock.advance(1.0)
        hp.timeline.sample()  # same count: no new bundle
        seen["v"] = 3
        clock.advance(1.0)
        hp.timeline.sample()
        assert [b["trigger"] for b in hp.flight.bundles()] \
            == ["lock_violation", "lock_violation"]

    def test_slo_fast_burn_trigger(self, P):
        clock = P.ManualClock()
        hp = _plane(P, clock, P.M.MetricsRegistry(),
                    objectives=[_latency_slo(P)], fast_burn_alert=4.0)
        for _ in range(6):
            hp.slo.record("query", 500.0)
        hp.timeline.sample()
        b = hp.flight.bundles()[0]
        assert b["trigger"] == "slo_fast_burn" and "q-lat" in b["reason"]

    def test_cooldown_bounds_refires(self, P):
        clock = P.ManualClock()
        hp = _plane(P, clock, P.M.MetricsRegistry(), wal_stall_s=1.0,
                    flight_cooldown_s=30.0)
        hp.timeline.add_probe("wal", lambda: {"flush_lag_s": 5.0})
        hp.timeline.sample()
        clock.advance(5.0)
        hp.timeline.sample()
        assert len(hp.flight.bundles()) == 1
        clock.advance(31.0)
        hp.timeline.sample()
        assert len(hp.flight.bundles()) == 2

    def test_bundle_contents_and_lookup(self, P):
        hp = _plane(P, P.ManualClock(), P.M.MetricsRegistry(),
                    wal_stall_s=1.0)
        hp.flight.record_event("note", detail="before")
        hp.timeline.add_probe("wal", lambda: {"flush_lag_s": 5.0})
        hp.timeline.sample()
        b = hp.flight.bundles()[0]
        assert b["events"][0]["kind"] == "note"
        assert len(b["timeline"]) >= 1
        assert "objectives" in b["slo"]
        assert hp.flight.get(b["id"])["id"] == b["id"]
        with pytest.raises(KeyError):
            hp.flight.get("fb-nope")

    def test_disk_dump(self, P, tmp_path):
        hp = _plane(P, P.ManualClock(), P.M.MetricsRegistry(),
                    wal_stall_s=1.0, dump_dir=str(tmp_path / "dumps"))
        hp.timeline.add_probe("wal", lambda: {"flush_lag_s": 5.0})
        hp.timeline.sample()
        b = hp.flight.bundles()[0]
        path = tmp_path / "dumps" / f"{b['id']}.json"
        assert json.loads(path.read_text())["trigger"] == "wal_stall"

    def test_counts_bundles_metric(self, P):
        reg = P.M.MetricsRegistry()
        hp = _plane(P, P.ManualClock(), reg, wal_stall_s=1.0)
        hp.timeline.add_probe("wal", lambda: {"flush_lag_s": 5.0})
        hp.timeline.sample()
        assert reg.value(P.M.METRIC_FLIGHT_BUNDLES,
                         trigger="wal_stall") == 1


# ---------------------------------------------------------------------------
# API integration + env bootstrap (tests/test_health.py TestAPIHealth)
# ---------------------------------------------------------------------------


class TestAPIHealth:
    def test_query_paths_feed_slo(self, P):
        api = P.API()
        clock = P.ManualClock()
        hp = api.enable_health(clock=clock, interval_ms=100.0)
        try:
            api.create_index("i")
            api.create_field("i", "f")
            api.import_bits("i", "f", rows=[0], cols=[0])
            clock.advance(1.0)
            api.query("i", "Count(Row(f=0))")
            rows = {r["name"]: r for r in hp.slo.burn_rates()}
            assert rows["query-latency"]["events_fast"] == 1
            assert rows["ingest-latency"]["events_fast"] == 1
            assert hp.timeline.latest() is not None
        finally:
            api.disable_health()
        assert api.health is None

    def test_failed_query_is_an_error_event(self, P):
        api = P.API()
        hp = api.enable_health(clock=P.ManualClock())
        try:
            api.create_index("i")
            with pytest.raises(Exception):
                api.query("i", "Count(Row(nofield=0))")
            rows = {r["name"]: r for r in hp.slo.burn_rates()}
            assert rows["query-errors"]["fast_burn"] > 0
        finally:
            api.disable_health()

    def test_env_bootstrap_zero_threads(self, P, monkeypatch):
        monkeypatch.setenv("PILOSA_TPU_OBS_TIMELINE", "1")
        before = threading.active_count()
        api = P.API()
        try:
            assert api.health is not None
            assert api.health.timeline.running is False
            assert threading.active_count() == before
            api.create_index("i")
            api.create_field("i", "f")
            api.query("i", "Count(Row(f=0))")
        finally:
            api.disable_health()

    def test_start_runs_and_stop_joins_the_sampler(self, P):
        api = P.API()
        hp = api.enable_health(interval_ms=1.0, start=True)
        assert hp.timeline.running
        api.disable_health()
        assert not hp.timeline.running

    def test_from_config(self, P):
        cfg = P.Config(obs_timeline_interval_ms=50.0,
                       obs_timeline_capacity=7,
                       obs_timeline_slo_fast_burn_alert=2.5,
                       stream_ingest_stall_s=3.0)
        hp = P.health.HealthPlane.from_config(
            cfg, registry=P.M.MetricsRegistry())
        assert hp.timeline.interval_s == pytest.approx(0.05)
        assert hp.timeline._ring.maxlen == 7
        assert hp.slo.fast_burn_alert == 2.5
        assert hp.flight.ingest_stall_s == 3.0

    def test_timeline_json_and_probe_names(self, P):
        api = P.API()
        hp = api.enable_health(clock=P.ManualClock())
        try:
            samp = hp.timeline.sample()
            assert set(samp["probes"]) == {
                "slo", "locks", "scheduler", "cache", "wal", "residency",
                "stream", "kernels", "tenants", "degrade"}
            for name in ("scheduler", "cache", "stream", "tenants",
                         "degrade"):
                assert samp["probes"][name] == {"enabled": False}, name
            doc = hp.timeline_json()
            assert doc["enabled"] and doc["node"] == "local"
            assert len(doc["samples"]) == 1
        finally:
            api.disable_health()


# ---------------------------------------------------------------------------
# ingest_stall (tests/test_stream.py TestIngestStallTrigger)
# ---------------------------------------------------------------------------


class TestIngestStallTrigger:
    def make_plane(self, P):
        return P.health.HealthPlane(interval_ms=10.0, clock=P.ManualClock(),
                                    ingest_stall_s=5.0)

    def test_fires_on_saturation(self, P):
        fired = self.make_plane(P).flight.observe({"probes": {"stream": {
            "enabled": True, "saturated": True, "paused_s": 0.0}},
            "rates": {}})
        assert [b["trigger"] for b in fired] == ["ingest_stall"]
        assert "saturated" in fired[0]["reason"]

    def test_fires_on_sustained_pause(self, P):
        fired = self.make_plane(P).flight.observe({"probes": {"stream": {
            "enabled": True, "saturated": False, "paused_s": 9.5}},
            "rates": {}})
        assert [b["trigger"] for b in fired] == ["ingest_stall"]
        assert "paused" in fired[0]["reason"]

    def test_quiet_pipeline_does_not_fire(self, P):
        hp = self.make_plane(P)
        for probe in ({"enabled": False},
                      {"enabled": True, "saturated": False,
                       "paused_s": 0.1}):
            assert hp.flight.observe(
                {"probes": {"stream": probe}, "rates": {}}) == []

    def test_stream_probe_rides_api_samples(self, P, tmp_path):
        api = P.API(path=str(tmp_path))
        api.enable_stream("idx", batch_rows=10)
        try:
            hp = api.enable_health(clock=P.ManualClock())
            hp.clock.advance(1.0)
            hp.timeline.maybe_sample()
            sample = hp.timeline.window(None)[-1]
            assert sample["probes"]["stream"]["enabled"]
            assert sample["probes"]["stream"]["topic"] == "ingest"
        finally:
            api.disable_health()
            api.disable_stream()

    def test_probe_disabled_without_service(self, P):
        api = P.API()
        try:
            hp = api.enable_health(clock=P.ManualClock())
            hp.clock.advance(1.0)
            hp.timeline.maybe_sample()
            sample = hp.timeline.window(None)[-1]
            assert sample["probes"]["stream"] == {"enabled": False}
        finally:
            api.disable_health()


# ---------------------------------------------------------------------------
# the device profiler (tests/test_devprof.py)
# ---------------------------------------------------------------------------

SHARDS = 2

QUERIES = [
    "Count(Row(f=1))",
    "Count(Intersect(Row(f=1), Row(g=1)))",
    "Intersect(Row(f=2), Row(g=2))",
]


def _fill(P, target, index="dk"):
    target.create_index(index)
    target.create_field(index, "f")
    target.create_field(index, "g")
    rows, cols = [], []
    for c in range(0, SHARDS * P.SHARD_WIDTH, P.SHARD_WIDTH // 16):
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


@pytest.fixture
def unprofiled(P):
    dp = P.devprof
    was = dp.ENABLED
    dp.disable()
    dp.reset()
    yield dp
    dp.enable() if was else dp.disable()


class TestCostModel:
    def test_count_tape_cost(self, P):
        assert P.devprof.tape_cost("count", (("and", 0, 1),), 2, False,
                                   1024) == (65536.0, 8200.0)

    def test_plane_tape_cost_counts_scratch_write(self, P):
        flops, hbm = P.devprof.tape_cost(
            "plane", (("or", 0, 1), ("and", 2, 3)), 3, False, 512)
        assert flops == 32.0 * 2 * 512
        assert hbm == 4.0 * (3 + 1) * 512

    def test_mask_adds_one_pass_and_one_plane(self, P):
        flops, hbm = P.devprof.tape_cost("count", (("and", 0, 1),), 2,
                                         True, 1024)
        assert flops == 32.0 * 3 * 1024
        assert hbm == 4.0 * 3 * 1024 + 8.0

    def test_cost_evals_counter_increments(self, P):
        before = P.devprof.cost_evals()
        P.devprof.tape_cost("count", (("or", 0, 1),), 2, False, 64)
        assert P.devprof.cost_evals() == before + 1

    def test_family_name_structure(self, P):
        fn = P.devprof.family_name
        fam = fn("count", (("and", 0, 1),), 2, False)
        assert fam.startswith("count/2l/and1#") and len(fam) > 14
        fam2 = fn("plane", (("or", 0, 1), ("and", 2, 3), ("or", 4, 5)), 3,
                  True)
        assert fam2.startswith("plane/3l/and1+or2/m#")
        assert fn("count", (("and", 0, 1),), 2, False) \
            != fn("count", (("and", 1, 0),), 2, False)

    def test_shape_bucket_next_pow2(self, P):
        sb = P.devprof.shape_bucket
        assert (sb(1), sb(3), sb(1024), sb(1025)) == (1, 4, 1024, 2048)

    def test_pallas_mm_cost(self, P):
        flops, hbm = P.devprof.tape_cost(
            "pallas", (("mm", 2, 14),), 16, False, 4096)
        assert flops == 2.0 * 2 * 14 * 32 * 4096
        assert hbm == 4.0 * 16 * 4096 + 4.0 * 2 * 14

    def test_pallas_cmp_cost(self, P):
        flops, hbm = P.devprof.tape_cost(
            "pallas", (("cmp", 13, 1),), 15, False, 512)
        assert flops == 32.0 * (6 * 13 + 8) * 512
        assert hbm == 4.0 * (3 + 13) * 512

    def test_pallas_scatter_cost(self, P):
        flops, hbm = P.devprof.tape_cost(
            "pallas", (("scatter", 300, 8),), 2, False, 8192)
        assert flops == 32.0 * 2 * 8192
        assert hbm == 4.0 * 3 * 8192

    def test_pallas_pop_cost(self, P):
        flops, hbm = P.devprof.tape_cost(
            "pallas", (("pop", 40, 1),), 1, False, 512)
        assert flops == 32.0 * 2 * 40 * 512
        assert hbm == 4.0 * 40 * 512 + 4.0 * 40

    def test_pallas_unknown_family_raises(self, P):
        with pytest.raises(ValueError):
            P.devprof.tape_cost("pallas", (("bogus", 1, 1),), 1, False, 64)

    def test_pallas_family_name(self, P):
        fam = P.devprof.family_name("pallas", (("mm", 2, 14),), 16, False)
        assert fam.startswith("pallas/16l/mm1#")

    @pytest.mark.parametrize("args", [
        ("count", (("or", 0, 0),), 1, False, 65536),
        ("count", (("and", 0, 1), ("andnot", 2, 0)), 2, True, 32768),
        ("plane", (("xor", 0, 1),), 2, True, 98304),
        ("pallas", (("mm", 1, 7),), 2, False, 65536),
        ("pallas", (("cmp", 20, 2),), 22, False, 327680),
        ("pallas", (("scatter", 128994, 1),), 2, False, 924472),
        ("pallas", (("pop", 512, 1),), 1, False, 512),
    ])
    def test_same_cost_and_name_in_both_packages(self, P, args):
        jax = _pkg(JAX).devprof
        assert P.devprof.tape_cost(*args) == jax.tape_cost(*args)
        assert P.devprof.family_name(*args[:4]) \
            == jax.family_name(*args[:4])


class TestKernelProfileRegistry:
    def test_accumulate_and_roofline_snapshot(self, P):
        reg = P.devprof.KernelProfileRegistry()
        ent = reg.entry_for("count", (("and", 0, 1),), 2, False, 1024, 0)
        reg.record(ent, 0.001, 0.002)
        reg.record(ent, 0.001, 0.002)
        (row,) = reg.snapshot()
        assert row["dispatches"] == 2
        assert row["device_seconds"] == pytest.approx(0.006)
        assert row["flops"] == pytest.approx(2 * 65536.0)
        assert row["hbm_bytes"] == pytest.approx(2 * 8200.0)
        assert row["mfu_pct"] > 0 and row["achieved_gbps"] > 0
        assert row["us_per_dispatch"] == pytest.approx(3000.0)
        assert row["intensity_flops_per_byte"] == pytest.approx(
            65536.0 / 8200.0, rel=1e-3)
        assert row["roofline_bound"] == "memory"

    def test_same_family_different_bucket_split(self, P):
        reg = P.devprof.KernelProfileRegistry()
        reg.record(reg.entry_for("count", (("and", 0, 1),), 2, False,
                                 1024, 0), 0.001, 0.0)
        reg.record(reg.entry_for("count", (("and", 0, 1),), 2, False,
                                 4096, 0), 0.002, 0.0)
        rows = reg.snapshot()
        assert {r["shape_bucket"] for r in rows} == {1024, 4096}
        assert rows[0]["device_seconds"] >= rows[1]["device_seconds"]

    def test_mesh_epoch_keys_profiles_apart(self, P):
        reg = P.devprof.KernelProfileRegistry()
        for epoch in (0, 1):
            reg.record(reg.entry_for("count", (("and", 0, 1),), 2, False,
                                     1024, epoch), 0.001, 0.0)
        assert reg.profile_count() == 2

    def test_kernel_scope_keys_by_the_engine_mesh_epoch(self, P):
        # kernel_scope reads the package's own mesh_epoch: a mesh switch
        # profiles the same tape apart, as the stacks rebuild
        mesh = importlib.import_module(f"{P.root}.parallel.mesh")
        profs = []
        for _ in range(2):
            mesh.set_engine_mesh(None)
            with P.devprof.kernel_scope("count", (("and", 0, 1),), 2,
                                        False, 1024):
                profs.append(P.devprof._TLS.kernel[0])
            assert profs[-1].mesh_epoch == mesh.mesh_epoch()
        mesh.set_engine_mesh(None)
        assert profs[0] is not profs[1]
        assert profs[1].mesh_epoch == profs[0].mesh_epoch + 1

    def test_call_cache_reuses_allocations(self, P):
        reg = P.devprof.KernelProfileRegistry()
        args = ("count", (("and", 0, 1),), 2, False, 1024, 0)
        e1 = reg.entry_for(*args)
        assert reg.allocations == 2
        assert reg.entry_for(*args) is e1
        assert reg.allocations == 2

    def test_unattributed_dispatch_lands_in_other(self, P):
        reg = P.devprof.KernelProfileRegistry()
        reg.record(None, 0.001, 0.002)
        assert reg.other_dispatches == 1
        assert reg.other_device_s == pytest.approx(0.003)
        assert reg.snapshot() == []

    def test_h2d_accounting(self, P):
        reg = P.devprof.KernelProfileRegistry()
        reg.record_h2d(1 << 20, 0.001)
        h = reg.h2d_json()
        assert h["copies"] == 1 and h["bytes"] == 1 << 20
        assert h["achieved_gbps"] == pytest.approx(
            (1 << 20) / 0.001 / 1e9, rel=1e-3)

    def test_snapshot_limit(self, P):
        reg = P.devprof.KernelProfileRegistry()
        for i in range(5):
            reg.record(reg.entry_for("count", (("and", 0, 1),), 2, False,
                                     1 << (6 + i), 0), 0.001 * (i + 1), 0.0)
        assert len(reg.snapshot(limit=3)) == 3

    def test_ingest_accounting_rates(self, P):
        acc = P.devprof.IngestAccounting()
        acc.record("parse", 0.5, rows=1000)
        acc.record("parse", 0.5, rows=1000)
        acc.record("wal_commit", 0.25, nbytes=1 << 20)
        snap = acc.snapshot()
        assert snap["parse"]["rows"] == 2000
        assert snap["parse"]["batches"] == 2
        assert snap["parse"]["rows_per_s"] == pytest.approx(2000.0)
        assert snap["wal_commit"]["bytes_per_s"] == pytest.approx(
            (1 << 20) / 0.25)


class TestGating:
    def test_disabled_means_zero_cost_model_work(self, P, unprofiled):
        dp = unprofiled
        api = P.API()
        _fill(P, api)
        evals, allocs = dp.cost_evals(), dp.KERNELS.allocations
        for q in QUERIES + ["TopN(f, n=2)"]:
            api.query("dk", q)
        assert dp.cost_evals() == evals
        assert dp.KERNELS.allocations == allocs
        assert dp.KERNELS.profile_count() == 0
        assert getattr(P.platform, "_DISPATCH_HOOK", None) is None
        assert P.platform._H2D_HOOK is None
        assert dp.stats_json() == {"enabled": False}

    def test_enabled_attributes_every_compiled_family(self, P, profiled):
        dp = profiled
        api = P.API()
        _fill(P, api)
        dp.reset()
        for q in QUERIES:
            api.query("dk", q)
        rows = dp.KERNELS.snapshot()
        assert len(rows) >= 3
        assert {r["family"].split("/")[0] for r in rows} \
            == {"count", "plane"}
        for r in rows:
            assert r["dispatches"] > 0
            assert r["device_seconds"] > 0
            assert r["mfu_pct"] > 0
            assert r["achieved_gbps"] > 0
        s = dp.stats_json()
        assert s["enabled"] and s["backend"]
        assert s["peak_tflops"] > 0 and s["peak_gbps"] > 0
        assert s["cost_evals"] >= 3

    def test_results_bit_identical_on_vs_off(self, P, unprofiled):
        dp = unprofiled
        api = P.API()
        _fill(P, api)
        qs = QUERIES + ["TopN(f, n=3)", "GroupBy(Rows(f), Rows(g))"]
        off = [api.query_json("dk", q) for q in qs]
        dp.enable()
        try:
            on = [api.query_json("dk", q) for q in qs]
        finally:
            dp.disable()
        assert json.dumps(on, sort_keys=True) \
            == json.dumps(off, sort_keys=True)

    def test_peak_override_env(self, P, profiled, monkeypatch):
        monkeypatch.setenv("PILOSA_TPU_DEVPROF_PEAK_TFLOPS", "2.0")
        monkeypatch.setenv("PILOSA_TPU_DEVPROF_PEAK_GBPS", "50.0")
        assert profiled.peaks() == (2.0, 50.0)


class TestHooks:
    def test_h2d_attributed_to_ingest_only_in_scope(self, P, profiled):
        dp = profiled
        host = np.zeros(1024, dtype=np.uint32)
        h2d = (P.platform.h2d_copy if P.root == JAX else
               (lambda h: P.platform.h2d_copy(h, P.platform.resolve_device(
                   "cpu"))))
        h2d(host)
        assert dp.KERNELS.h2d_copies == 1
        assert "h2d_copy" not in dp.INGEST.snapshot()
        with dp.ingest_scope():
            h2d(host)
        assert dp.KERNELS.h2d_copies == 2
        assert dp.INGEST.snapshot()["h2d_copy"]["bytes"] == host.nbytes

    def test_kernel_scope_nests_and_restores(self, P, profiled):
        dp = profiled
        outer = ("count", (("and", 0, 1),), 2, False, 64)
        inner = ("plane", (("or", 0, 1),), 2, False, 64)
        with dp.kernel_scope(*outer):
            ent_outer = dp._TLS.kernel
            with dp.kernel_scope(*inner):
                assert dp._TLS.kernel is not ent_outer
            assert dp._TLS.kernel is ent_outer
        assert getattr(dp._TLS, "kernel", None) is None


class TestIngestStages:
    CSV = "id,city__S,pop__I\n" + "\n".join(
        f"{i},c{i % 7},{1000 + i}" for i in range(300))

    def test_columnar_ingest_populates_stages(self, P, profiled, tmp_path):
        api = P.API(str(tmp_path))
        n = P.Ingester(api, "cities", P.CSVSource(self.CSV, inline=True)
                       ).run()
        assert n == 300
        snap = profiled.INGEST.snapshot()
        assert snap["parse"]["rows"] == 300
        assert snap["parse"]["rows_per_s"] > 0
        assert snap["key_translate"]["rows"] > 0
        assert snap["fragment_advance"]["rows"] > 0
        assert snap["wal_commit"]["bytes"] > 0
        assert snap["wal_commit"]["bytes_per_s"] > 0

    def test_batch_path_records_stages_too(self, P, profiled):
        api = P.API()
        P.Ingester(api, "cust", P.scenario("customer", rows=100)).run()
        assert profiled.INGEST.snapshot()["fragment_advance"]["rows"] > 0

    def test_disabled_ingest_records_nothing(self, P, unprofiled,
                                             tmp_path):
        api = P.API(str(tmp_path))
        P.Ingester(api, "cities", P.CSVSource(self.CSV, inline=True)).run()
        assert unprofiled.INGEST.snapshot() == {}


class TestTimelineProbe:
    def test_timeline_probe_rides_health_samples(self, P, profiled):
        api = P.API()
        _fill(P, api)
        api.enable_health(config=P.Config())
        try:
            for q in QUERIES:
                api.query("dk", q)
            probe = api.health.timeline.sample()["probes"]["kernels"]
            assert probe["enabled"] is True
            assert probe["kernels"], probe
            assert len(probe["kernels"]) <= 8
        finally:
            api.disable_health()

    def test_timeline_probe_disabled(self, P, unprofiled):
        assert unprofiled.timeline_probe() == {"enabled": False}


# ---------------------------------------------------------------------------
# the two repaired metric families, against the JAX package's values
# ---------------------------------------------------------------------------

_RESIDENT = ("device_hbm_resident_bytes", "device_budget_resident_bytes")


def _gauges(P):
    return tuple(P.M.REGISTRY.value(g) for g in _RESIDENT)


class TestResidentGauges:
    """The same build / evict / release sequence through both packages'
    ``DeviceBudget`` leaves the same resident-bytes gauges after every
    step. Plain dense stacks only: a compressed block of the port also
    charges 12 B for each non-zero constant (ROADMAP C, departure 2), so
    its gauge reads that much above the JAX package's."""

    def test_gauges_follow_charge_evict_release(self):
        seen = {}
        for root in (JAX, TORCH):
            P = _pkg(root)
            budget = P.stacked.DeviceBudget(1000)
            steps = []
            evicted = []
            for k, nbytes in enumerate((400, 300, 200, 500, 100)):
                budget.charge(("k", k), nbytes,
                              lambda k=k: evicted.append(k))
                steps.append(_gauges(P) + (budget.used,))
            budget.touch(("k", 3))
            budget.release(("k", 3))
            steps.append(_gauges(P) + (budget.used,))
            budget.release(("k", 4))
            steps.append(_gauges(P) + (budget.used,))
            for g0, g1, used in steps:
                assert g0 == g1 == used
            seen[root] = (steps, evicted)
        assert seen[JAX] == seen[TORCH]

    def test_query_path_sets_the_gauges(self, P):
        api = P.API()
        _fill(P, api)
        api.query("dk", "Count(Intersect(Row(f=1), Row(g=1)))")
        assert _gauges(P) == (P.stacked.BUDGET.used,) * 2


def _compress_counters(P) -> dict:
    return {series: v for series, v in
            P.M.REGISTRY.snapshot()["counters"].items()
            if series.startswith("device_compress_")}


def _delta(before: dict, after: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


class TestCompressMetrics:
    """``maybe_compress`` and a filtered compressed count on the same
    planes move every ``METRIC_COMPRESS_*`` series by the same amount in
    both packages. The planes' run tiles are all-zero or all-one words:
    under a filter the JAX package falls back to a decode for any other
    constant (``fallback{why=const}``), where the port's kernel counts
    them (ROADMAP C)."""

    def _planes(self):
        rng = np.random.default_rng(21)
        host = np.zeros((6, 4096), dtype=np.uint32)
        host[0, :512] = rng.integers(0, 1 << 32, 512, dtype=np.uint32)
        host[1, 1024:2048] = 0xFFFFFFFF
        host[2, 100:140] = rng.integers(0, 1 << 32, 40, dtype=np.uint32)
        host[4, 4000:] = 0xFFFFFFFF
        filt = rng.integers(0, 1 << 32, 4096, dtype=np.uint32)
        return host, filt

    def _run(self, root, monkeypatch):
        P = _pkg(root)
        monkeypatch.setenv("PILOSA_TPU_COMPRESS", "1")
        host, filt = self._planes()
        before = _compress_counters(P)
        if root == JAX:
            import jax.numpy as jnp

            cb = P.ctiles.maybe_compress(host, kind="set")
            counts = np.asarray(cb.row_counts(
                jnp.asarray(filt.view(np.int32))))
        else:
            import torch

            cb = P.ctiles.maybe_compress(host, torch.device("cpu"), "set")
            counts = cb.row_counts(
                torch.from_numpy(filt.view(np.int32))).numpy()
        out = _delta(before, _compress_counters(P))
        out["ratio"] = P.M.REGISTRY.value(P.M.METRIC_COMPRESS_RATIO)
        return out, counts

    def test_same_deltas(self, monkeypatch):
        jax_d, jax_counts = self._run(JAX, monkeypatch)
        torch_d, torch_counts = self._run(TORCH, monkeypatch)
        assert set(jax_d) == {
            'device_compress_blocks_total{kind="set"}',
            "device_compress_dense_bytes_total",
            "device_compress_stored_bytes_total",
            "device_compress_tiles_skipped_total", "ratio"}, jax_d
        assert torch_d == jax_d
        assert np.array_equal(torch_counts, jax_counts)

    def test_policy_fallbacks_counted_alike(self, monkeypatch):
        seen = {}
        for root in (JAX, TORCH):
            P = _pkg(root)
            monkeypatch.setenv("PILOSA_TPU_COMPRESS", "auto")
            small = np.zeros((2, 64), dtype=np.uint32)
            before = _compress_counters(P)
            if root == JAX:
                assert P.ctiles.maybe_compress(small, kind="bsi") is None
            else:
                import torch

                assert P.ctiles.maybe_compress(
                    small, torch.device("cpu"), "bsi") is None
            seen[root] = _delta(before, _compress_counters(P))
        assert seen[TORCH] == seen[JAX] == {
            'device_compress_fallback_total{kind="bsi",why="small"}': 1}
