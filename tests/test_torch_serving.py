"""The serving layer's pure modules, held against the JAX package's.

Every test runs once per package: the ``P`` fixture yields the modules of
``pilosa_tpu`` or of their ``pilosa_tpu_torch`` counterparts, and the
test body is the same. Covered:

* the scheduler (``sched/``) over stub executors, as
  ``tests/test_sched.py`` drives it: group keys, batching, admission,
  read protection, deadlines, error isolation, superset fusion, the
  adaptive window and family classification, all on ``ManualClock``;
* the cache keys and ``ResultCache`` (``cache/``), as
  ``tests/test_cache.py`` drives them without an index;
* spans, traceparents, the trace store and the trace metrics
  (``obs/tracing.py``), and the lock tracer (``analysis/locktrace.py``)
  on private registries, as ``tests/test_tracing.py`` and
  ``tests/test_locktrace.py`` do where no server is needed;
* the ``[scheduler]`` and ``[cache]`` config fields, their env variables
  and TOML round trips;
* ``shard_mask_plane`` and ``mask_filter`` bit for bit (tolerance 0).

No test waits on the wall clock: windows and deadlines move on
``ManualClock``, threads hand over through events, and every ``join``
has a timeout.
"""

import importlib
import random
import threading
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch


def _load(root: str) -> types.SimpleNamespace:
    m = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    return types.SimpleNamespace(
        root=root,
        sched=m("sched"),
        batch=m("sched.batch"),
        window=m("sched.window"),
        errors=m("errors"),
        M=m("obs.metrics"),
        T=m("obs.tracing"),
        tenants=m("obs.tenants"),
        locktrace=m("analysis.locktrace"),
        parse=m("pql.parser").parse,
        ast=m("pql.ast"),
        Config=m("config").Config,
        query_maskable=m("pql.executor").query_maskable,
        keys=m("cache.keys"),
        ResultCache=m("cache.result_cache").ResultCache,
        estimate_cost=m("cache.result_cache").estimate_cost,
        bitmap=m("ops.bitmap"),
        bsi=m("ops.bsi"),
    )


_PACKAGES = {}


@pytest.fixture(params=["pilosa_tpu", "pilosa_tpu_torch"],
                ids=["jax", "torch"])
def P(request):
    if request.param not in _PACKAGES:
        _PACKAGES[request.param] = _load(request.param)
    return _PACKAGES[request.param]


class StubExecutor:
    """Records every execute(); each call's 'result' is its own PQL text,
    so scatter bugs (wrong offsets, swapped entries) surface as wrong
    strings."""

    def __init__(self, fail_when=None):
        self.calls = []
        self.fail_when = fail_when or (lambda q: False)
        self._lock = threading.Lock()

    def execute(self, index, query, shards=None):
        with self._lock:
            self.calls.append((index, [c.name for c in query.calls], shards))
        if self.fail_when(query):
            raise RuntimeError("stub failure")
        return [c.to_pql() for c in query.calls]


class StubFusionExecutor(StubExecutor):
    """StubExecutor advertising masked superset execution; records the
    per_query_shards each fused dispatch received."""

    supports_shard_masks = True

    def execute_many(self, index, queries, shards=None,
                     per_query_shards=None):
        with self._lock:
            self.calls.append((
                index, [[c.name for c in q.calls] for q in queries],
                shards if per_query_shards is None
                else list(per_query_shards)))
        if any(self.fail_when(q) for q in queries):
            raise RuntimeError("stub failure")
        return [[c.to_pql() for c in q.calls] for q in queries]


@pytest.fixture
def make_sched(P):
    created = []

    def make(executor, **kw):
        kw.setdefault("registry", P.M.MetricsRegistry())
        s = P.sched.QueryScheduler(executor, **kw)
        created.append(s)
        return s

    yield make
    for s in created:
        s.close()


# -- scheduler (tests/test_sched.py over stub executors) --------------------


class TestGroupKey:
    def test_families(self, P):
        fam = P.batch.family_of
        assert fam(P.parse("Count(Row(f=1))")) == "count"
        assert fam(P.parse("Intersect(Row(f=1), Row(g=2))")) == "bitmap"
        assert fam(P.parse("Sum(field=v)")) == "agg"
        assert fam(P.parse("TopN(f)")) == "rank"
        assert fam(P.parse("Extract(All(), Rows(f))")) == "scan"
        assert fam(P.parse("Count(Row(f=1))Row(g=2)")) == "bitmap+count"

    def test_key_compatibility(self, P):
        q = P.parse("Count(Row(f=1))")
        gk = P.sched.group_key
        assert gk("i", q, [2, 1]) == gk("i", q, [1, 2])
        assert gk("i", q) != gk("j", q)
        assert gk("i", q) != gk("i", P.parse("Row(f=1)"))


class TestBatching:
    def test_staged_queries_fuse_into_one_dispatch(self, make_sched):
        stub = StubExecutor()
        s = make_sched(stub, window_ms=0, max_batch=64)
        s.pause()
        handles = [s.submit("i", f"Count(Row(f={k}))") for k in range(8)]
        assert s.wait_queued(8) == 8
        s.resume()
        results = [h.result(timeout=5) for h in handles]
        assert results == [[f"Count(Row(f={k}))"] for k in range(8)]
        assert len(stub.calls) == 1
        assert stub.calls[0][1] == ["Count"] * 8

    def test_incompatible_shapes_split(self, make_sched):
        stub = StubExecutor()
        s = make_sched(stub, window_ms=0, max_batch=64)
        s.pause()
        hs = [s.submit("i", "Count(Row(f=1))"), s.submit("i", "Row(f=1)"),
              s.submit("j", "Count(Row(f=1))")]
        assert s.wait_queued(3) == 3
        s.resume()
        for h in hs:
            h.result(timeout=5)
        assert len(stub.calls) == 3

    def test_max_batch_cap(self, make_sched):
        stub = StubExecutor()
        s = make_sched(stub, window_ms=0, max_batch=3)
        s.pause()
        handles = [s.submit("i", f"Count(Row(f={k}))") for k in range(7)]
        assert s.wait_queued(7) == 7
        s.resume()
        for h in handles:
            h.result(timeout=5)
        assert sorted(len(names) for _, names, _ in stub.calls) == [1, 3, 3]

    def test_window_fires_via_manual_clock(self, P, make_sched):
        stub = StubExecutor()
        clock = P.sched.ManualClock()
        s = make_sched(stub, window_ms=5, max_batch=64, clock=clock)
        h = s.submit("i", "Count(Row(f=1))")
        assert s.wait_queued(1) == 1
        assert not h.done()
        clock.advance(0.006)
        assert h.result(timeout=5) == ["Count(Row(f=1))"]

    def test_batch_size_cap_flushes_without_clock(self, P, make_sched):
        clock = P.sched.ManualClock()  # time never advances
        s = make_sched(StubExecutor(), window_ms=1000, max_batch=2,
                       clock=clock)
        a = s.submit("i", "Count(Row(f=1))")
        b = s.submit("i", "Count(Row(f=2))")
        assert a.result(timeout=5) and b.result(timeout=5)


class TestAdmission:
    def test_queue_full_rejects_with_admission_error(self, P, make_sched):
        reg = P.M.MetricsRegistry()
        s = make_sched(StubExecutor(), window_ms=0, max_queue=2,
                       registry=reg)
        s.pause()
        s.submit("i", "Count(Row(f=1))")
        s.submit("i", "Count(Row(f=2))")
        with pytest.raises(P.errors.AdmissionError):
            s.submit("i", "Count(Row(f=3))")
        assert reg.value(P.M.METRIC_SCHED_REJECTED, priority="interactive",
                         reason="queue_full") == 1
        s.resume()

    def test_batch_priority_has_tighter_limit(self, P, make_sched):
        s = make_sched(StubExecutor(), window_ms=0, max_queue=4)
        s.pause()
        s.submit("i", "Count(Row(f=1))", priority=P.sched.PRIORITY_BATCH)
        s.submit("i", "Count(Row(f=2))", priority=P.sched.PRIORITY_BATCH)
        with pytest.raises(P.errors.AdmissionError):
            s.submit("i", "Count(Row(f=3))", priority=P.sched.PRIORITY_BATCH)
        s.submit("i", "Count(Row(f=4))")
        s.resume()

    def test_interactive_dispatches_before_batch(self, P, make_sched):
        stub = StubExecutor()
        s = make_sched(stub, window_ms=0, max_batch=64)
        s.pause()
        b = s.submit("bulk", "Count(Row(f=1))",
                     priority=P.sched.PRIORITY_BATCH)
        a = s.submit("live", "Count(Row(f=1))")
        assert s.wait_queued(2) == 2
        s.resume()
        a.result(timeout=5)
        b.result(timeout=5)
        assert [c[0] for c in stub.calls] == ["live", "bulk"]

    def test_writes_refused(self, make_sched):
        s = make_sched(StubExecutor(), window_ms=0)
        with pytest.raises(ValueError):
            s.submit("i", "Set(1, f=2)")

    def test_execute_bypasses_queue_for_writes(self, make_sched):
        s = make_sched(StubExecutor(), window_ms=0)
        s.pause()
        assert s.execute("i", "Set(1, f=2)") == ["Set(1, f=2)"]
        s.resume()

    def test_closed_scheduler_rejects(self, P, make_sched):
        s = make_sched(StubExecutor(), window_ms=0)
        s.close()
        with pytest.raises(P.errors.AdmissionError):
            s.submit("i", "Count(Row(f=1))")

    def test_admit_ticket_bounds_inflight(self, P, make_sched):
        s = make_sched(StubExecutor(), window_ms=0, max_queue=1)
        with s.admit():
            with pytest.raises(P.errors.AdmissionError):
                with s.admit():
                    pass
        with s.admit():
            pass


class TestReadProtection:
    def test_batch_admit_yields_to_interactive_ticket(self, P, make_sched):
        clock = P.sched.ManualClock()
        s = make_sched(StubExecutor(), window_ms=0, clock=clock)
        batch = P.sched.PRIORITY_BATCH
        with s.admit():
            with pytest.raises(P.errors.AdmissionError):
                with s.admit(priority=batch):
                    pass
        with pytest.raises(P.errors.AdmissionError):
            with s.admit(priority=batch):
                pass
        clock.advance(1.0)
        with s.admit(priority=batch):
            pass

    def test_batch_admit_yields_to_queued_reads(self, P, make_sched):
        s = make_sched(StubExecutor(), window_ms=0)
        s.pause()
        s.submit("i", "Count(Row(f=1))")
        with pytest.raises(P.errors.AdmissionError):
            with s.admit(priority=P.sched.PRIORITY_BATCH):
                pass
        s.resume()

    def test_yield_rejections_are_counted(self, P, make_sched):
        reg = P.M.MetricsRegistry()
        s = make_sched(StubExecutor(), window_ms=0,
                       clock=P.sched.ManualClock(), registry=reg)
        with s.admit():
            with pytest.raises(P.errors.AdmissionError):
                with s.admit(priority=P.sched.PRIORITY_BATCH):
                    pass
        assert reg.value(P.M.METRIC_SCHED_REJECTED, priority="batch",
                         reason="interactive_busy") == 1


class TestDeadlines:
    def test_expired_deadline_fails_without_poisoning_batch(self, P,
                                                            make_sched):
        stub = StubExecutor()
        reg = P.M.MetricsRegistry()
        clock = P.sched.ManualClock()
        s = make_sched(stub, window_ms=0, clock=clock, registry=reg)
        s.pause()
        doomed = s.submit("i", "Count(Row(f=1))", deadline_ms=10)
        healthy = s.submit("i", "Count(Row(f=2))")
        assert s.wait_queued(2) == 2
        clock.advance(0.05)
        s.resume()
        assert healthy.result(timeout=5) == ["Count(Row(f=2))"]
        with pytest.raises(P.errors.QueryDeadlineError):
            doomed.result(timeout=5)
        assert stub.calls == [("i", ["Count"], None)]
        assert reg.value(P.M.METRIC_SCHED_DEADLINE_MISS,
                         priority="interactive") == 1

    def test_cancel_while_queued(self, P, make_sched):
        stub = StubExecutor()
        s = make_sched(stub, window_ms=0)
        s.pause()
        victim = s.submit("i", "Count(Row(f=1))")
        other = s.submit("i", "Count(Row(f=2))")
        assert victim.cancel()
        s.resume()
        assert other.result(timeout=5) == ["Count(Row(f=2))"]
        with pytest.raises(P.errors.QueryDeadlineError):
            victim.result(timeout=5)
        assert stub.calls == [("i", ["Count"], None)]

    def test_deadline_scope_is_visible_to_the_executor(self, P, make_sched):
        seen = []

        class Probe(StubExecutor):
            def execute(self, index, query, shards=None):
                seen.append(P.sched.remaining_budget_s())
                return super().execute(index, query, shards)

        clock = P.sched.ManualClock()
        s = make_sched(Probe(), window_ms=0, clock=clock)
        assert s.submit("i", "Count(Row(f=1))",
                        deadline_ms=500).result(timeout=5)
        assert len(seen) == 1 and 0 < seen[0] <= 0.5


class TestErrorIsolation:
    def test_failing_batch_falls_back_to_solo_runs(self, make_sched):
        stub = StubExecutor(fail_when=lambda q: len(q.calls) > 1)
        s = make_sched(stub, window_ms=0, max_batch=64)
        s.pause()
        handles = [s.submit("i", f"Count(Row(f={k}))") for k in range(3)]
        assert s.wait_queued(3) == 3
        s.resume()
        assert [h.result(timeout=5) for h in handles] == [
            [f"Count(Row(f={k}))"] for k in range(3)]
        assert len(stub.calls) == 4  # 1 failed fused + 3 solo

    def test_poison_query_fails_alone(self, make_sched):
        stub = StubExecutor(
            fail_when=lambda q: any("poison" in c.to_pql() for c in q.calls))
        s = make_sched(stub, window_ms=0, max_batch=64)
        s.pause()
        good = s.submit("i", "Count(Row(f=1))")
        bad = s.submit("i", "Count(Row(poison=1))")
        assert s.wait_queued(2) == 2
        s.resume()
        assert good.result(timeout=5) == ["Count(Row(f=1))"]
        with pytest.raises(RuntimeError):
            bad.result(timeout=5)


class TestSupersetFusion:
    def test_overlapping_shard_sets_merge_into_one_dispatch(self, P,
                                                            make_sched):
        stub = StubFusionExecutor()
        reg = P.M.MetricsRegistry()
        s = make_sched(stub, window_ms=0, max_batch=64,
                       fuse_waste_ratio=2.0, registry=reg)
        s.pause()
        handles = [
            s.submit("i", "Count(Row(f=1))", shards=[0, 1, 2, 3]),
            s.submit("i", "Count(Row(f=2))", shards=[2, 3, 4, 5]),
            s.submit("i", "Count(Row(f=3))", shards=[4, 5, 6, 7]),
        ]
        assert s.wait_queued(3) == 3
        s.resume()
        assert [h.result(timeout=5) for h in handles] == [
            [f"Count(Row(f={k}))"] for k in (1, 2, 3)]
        assert len(stub.calls) == 1
        assert stub.calls[0][2] == [(0, 1, 2, 3), (2, 3, 4, 5), (4, 5, 6, 7)]
        M = P.M
        assert reg.value(M.METRIC_SCHED_SUPERSET_MERGES, family="count") == 2
        assert reg.value(M.METRIC_SCHED_FUSED_QUERIES, family="count") == 3
        assert reg.value(M.METRIC_SCHED_BATCHES, family="count") == 1
        counters = reg.as_json()["counters"]
        assert any(k.startswith("sched_batches_total") for k in counters)
        assert any(k.startswith("sched_superset_merges_total")
                   for k in counters)

    @pytest.mark.parametrize("ratio, shard_sets, dispatches", [
        (1.5, ([0, 1], [2, 3]), 2),      # union 4 > 1.5 x 2: refused
        (0, ([0, 1], [0, 1, 2]), 2),     # 0 disables merging
        (8.0, ([0, 1], [1, 2]), 1),
    ])
    def test_waste_ratio_gates_merging(self, make_sched, ratio, shard_sets,
                                       dispatches):
        stub = StubFusionExecutor()
        s = make_sched(stub, window_ms=0, max_batch=64,
                       fuse_waste_ratio=ratio)
        s.pause()
        hs = [s.submit("i", f"Count(Row(f={k}))", shards=sh)
              for k, sh in enumerate(shard_sets)]
        assert s.wait_queued(2) == 2
        s.resume()
        for h in hs:
            h.result(timeout=5)
        assert len(stub.calls) == dispatches

    def test_executor_without_masks_never_merges(self, make_sched):
        stub = StubExecutor()
        s = make_sched(stub, window_ms=0, max_batch=64, fuse_waste_ratio=8.0)
        s.pause()
        a = s.submit("i", "Count(Row(f=1))", shards=[0, 1])
        b = s.submit("i", "Count(Row(f=2))", shards=[1, 2])
        assert s.wait_queued(2) == 2
        s.resume()
        a.result(timeout=5), b.result(timeout=5)
        assert len(stub.calls) == 2

    def test_scan_family_and_none_shards_excluded(self, make_sched):
        stub = StubFusionExecutor()
        s = make_sched(stub, window_ms=0, max_batch=64, fuse_waste_ratio=8.0)
        s.pause()
        hs = [s.submit("i", "Extract(All(), Rows(f))", shards=[0, 1]),
              s.submit("i", "Extract(All(), Rows(f))", shards=[1, 2]),
              s.submit("i", "Count(Row(f=1))"),
              s.submit("i", "Count(Row(f=2))", shards=[0, 1])]
        assert s.wait_queued(4) == 4
        s.resume()
        for h in hs:
            h.result(timeout=5)
        assert len(stub.calls) == 4

    def test_options_shards_override_not_fused(self, make_sched):
        stub = StubFusionExecutor()
        s = make_sched(stub, window_ms=0, max_batch=64, fuse_waste_ratio=8.0)
        s.pause()
        a = s.submit("i", "Count(Row(f=1))", shards=[0, 1])
        b = s.submit("i", "Options(Count(Row(f=2)), shards=[9])",
                     shards=[1, 2])
        assert s.wait_queued(2) == 2
        s.resume()
        a.result(timeout=5), b.result(timeout=5)
        assert len(stub.calls) == 2

    def test_merge_respects_max_batch(self, make_sched):
        stub = StubFusionExecutor()
        s = make_sched(stub, window_ms=0, max_batch=2, fuse_waste_ratio=8.0)
        s.pause()
        handles = [s.submit("i", f"Count(Row(f={k}))", shards=[k, k + 1])
                   for k in range(3)]
        assert s.wait_queued(3) == 3
        s.resume()
        for h in handles:
            h.result(timeout=5)
        assert sorted(len(qs) for _, qs, _ in stub.calls) == [1, 2]

    def test_merged_candidate_cancel_and_deadline_honored(self, P,
                                                          make_sched):
        stub = StubFusionExecutor()
        clock = P.sched.ManualClock()
        s = make_sched(stub, window_ms=0, max_batch=64,
                       fuse_waste_ratio=8.0, clock=clock)
        s.pause()
        lead = s.submit("i", "Count(Row(f=1))", shards=[0, 1])
        doomed = s.submit("i", "Count(Row(f=2))", shards=[1, 2],
                          deadline_ms=10)
        gone = s.submit("i", "Count(Row(f=3))", shards=[2, 3])
        ok = s.submit("i", "Count(Row(f=4))", shards=[3, 4])
        assert s.wait_queued(4) == 4
        assert gone.cancel()
        clock.advance(0.05)
        s.resume()
        assert lead.result(timeout=5) == ["Count(Row(f=1))"]
        assert ok.result(timeout=5) == ["Count(Row(f=4))"]
        for h in (doomed, gone):
            with pytest.raises(P.errors.QueryDeadlineError):
                h.result(timeout=5)
        assert len(stub.calls) == 1
        assert stub.calls[0][2] == [(0, 1), (3, 4)]

    def test_padding_waste_histogram(self, P, make_sched):
        reg = P.M.MetricsRegistry()
        s = make_sched(StubFusionExecutor(), window_ms=0, max_batch=64,
                       fuse_waste_ratio=8.0, registry=reg)
        s.pause()
        hs = [s.submit("i", "Count(Row(f=1))", shards=[0, 1]),
              s.submit("i", "Count(Row(f=2))", shards=[2, 3])]
        assert s.wait_queued(2) == 2
        s.resume()
        for h in hs:
            h.result(timeout=5)
        text = reg.prometheus_text()
        for name in ("sched_superset_merges_total",
                     "sched_fused_queries_total",
                     "sched_padding_waste_ratio"):
            assert name in text
        assert any(k.startswith(P.M.METRIC_SCHED_PADDING_WASTE)
                   for k in reg.as_json()["histograms"])


class TestAdaptiveWindow:
    def test_disabled_by_default(self, make_sched):
        s = make_sched(StubExecutor(), window_ms=3)
        assert s.adaptive_window is False
        assert s.current_window_ms() == 3.0

    @pytest.mark.parametrize("gap_s, want_ms", [(10.0, 1.0), (0.001, 100.0)])
    def test_window_follows_arrival_gaps(self, P, make_sched, gap_s,
                                         want_ms):
        clock = P.sched.ManualClock()
        s = make_sched(StubExecutor(), adaptive_window=True,
                       window_min_ms=1, window_max_ms=100, max_batch=10,
                       clock=clock)
        s.pause()
        for k in range(8):
            s.submit("i", f"Count(Row(f={k}))")
            clock.advance(gap_s)
        assert s.current_window_ms() == want_ms
        s.resume()

    def test_window_tracks_load_shift(self, P, make_sched):
        clock = P.sched.ManualClock()
        reg = P.M.MetricsRegistry()
        s = make_sched(StubExecutor(), adaptive_window=True,
                       window_min_ms=1, window_max_ms=100, max_batch=10,
                       clock=clock, registry=reg)
        s.pause()
        for k in range(8):
            s.submit("i", f"Count(Row(f={k}))")
            clock.advance(0.001)
        busy = s.current_window_ms()
        for k in range(20):
            s.submit("i", f"Count(Row(g={k}))")
            clock.advance(5.0)
        idle = s.current_window_ms()
        assert busy > idle
        assert reg.value(P.M.METRIC_SCHED_WINDOW_MS) == idle
        s.resume()

    def test_arrival_window_math(self, P):
        w = P.window.ArrivalWindow(0.002, adaptive=True, window_min_s=0.001,
                                   window_max_s=0.01, max_batch=8)
        assert w.window_s() == 0.001 and w.drain_s(3) is None
        for t in (0.0, 0.002, 0.004):
            w.observe(t)
        assert w.window_s() == pytest.approx(0.01 ** 2 / (0.002 * 8))
        assert w.drain_s(5) == pytest.approx(0.01)


class TestFamilyClassification:
    def test_family_unwraps_nested_options(self, P):
        inner = P.parse("Count(Row(f=1))").calls[0]
        wrapped = P.ast.Query([P.ast.Call("Options", {"shards": [0]}, [
            P.ast.Call("Options", {}, [inner])])])
        assert P.batch.family_of(wrapped) == "count"

    def test_fusible_families(self, P):
        ff = P.batch.fusible_family
        assert ff("count") and ff("agg+bitmap")
        assert not ff("scan") and not ff("count+scan")

    def test_options_shards_blocks_maskability_not_family(self, P):
        plain = P.parse("Options(Count(Row(f=1)), exclude=true)")
        scoped = P.parse("Options(Count(Row(f=1)), shards=[0])")
        assert P.batch.family_of(plain) == P.batch.family_of(scoped) == "count"
        assert P.query_maskable(plain)
        assert not P.query_maskable(scoped)

    @pytest.mark.parametrize("pql, maskable", [
        ("Count(Row(f=1))", True), ("TopN(f, n=2)", True),
        ("GroupBy(Rows(f))", True), ("Percentile(field=v, nth=50)", True),
        ("Limit(Row(f=1), limit=2)", True), ("Extract(All(), Rows(f))", False),
        ("Sort(field=v)", False), ("IncludesColumn(Row(f=1), column=3)",
                                   False),
        ("Count(Row(f=1))Extract(All(), Rows(f))", False),
    ])
    def test_query_maskable_agrees(self, P, pql, maskable):
        assert P.query_maskable(P.parse(pql)) is maskable


# -- cache keys and ResultCache (tests/test_cache.py without an index) ------


class TestCacheKeys:
    def test_shard_key(self, P):
        sk = P.keys.shard_key
        assert sk([2, 1, 3]) == (1, 2, 3) and sk((3, 1)) == sk([1, 3])
        assert sk(None) is None
        assert sk(None, all_shards={4, 0, 2}) == (0, 2, 4)
        q = P.parse("Count(Row(f=1))")
        assert P.sched.group_key("i", q, [2, 1]).shards == sk([1, 2])
        assert P.sched.group_key("i", q).shards == sk(None)

    def test_union_shards(self, P):
        assert P.keys.union_shards([[3, 1], (2,), []]) == (1, 2, 3)
        assert P.keys.union_shards([[1], None]) is None

    @pytest.mark.parametrize("pql, cacheable", [
        ("Count(Row(f=1))", True), ("Count(Row(f=1))Set(1, f=2)", False),
        ("ExternalLookup(query='x')", False),
        ("Options(Row(f=1), shards=[0])", False), ("Options(Row(f=1))", True),
    ])
    def test_is_cacheable(self, P, pql, cacheable):
        assert P.keys.is_cacheable(P.parse(pql)) is cacheable


class TestResultCacheUnit:
    def test_roundtrip_and_copy_isolation(self, P):
        c = P.ResultCache(registry=P.M.MetricsRegistry())
        c.insert(("k",), [1, [2, 3]])
        hit, v = c.lookup(("k",))
        assert hit and v == [1, [2, 3]]
        v[1].append(99)
        assert c.lookup(("k",))[1] == [1, [2, 3]]

    def test_entry_bound_evicts_lru(self, P):
        r = P.M.MetricsRegistry()
        c = P.ResultCache(max_entries=2, registry=r)
        c.insert(("a",), 1)
        c.insert(("b",), 2)
        assert c.lookup(("a",))[0]
        c.insert(("c",), 3)
        assert not c.lookup(("b",))[0]
        assert c.lookup(("a",))[0] and c.lookup(("c",))[0]
        assert r.value(P.M.METRIC_CACHE_EVICTIONS, reason="entries") == 1

    def test_byte_bound_evicts_and_rejects_oversize(self, P):
        r = P.M.MetricsRegistry()
        cost = P.estimate_cost("x" * 100)
        c = P.ResultCache(max_bytes=int(cost * 2.5), registry=r)
        for k in ("a", "b", "c"):
            c.insert((k,), "x" * 100)
        assert not c.lookup(("a",))[0]
        assert c.stats()["bytes"] <= int(cost * 2.5)
        assert r.value(P.M.METRIC_CACHE_EVICTIONS, reason="bytes") >= 1
        c.insert(("huge",), "x" * 1000)
        assert not c.lookup(("huge",))[0]

    def test_estimate_cost_agrees(self, P):
        v = {"a": [1, 2.5, "xyz"], "b": np.zeros(8, np.uint32), "c": None}
        jax_cost = _load_cached("pilosa_tpu").estimate_cost(v)
        assert P.estimate_cost(v) == jax_cost

    def test_ttl_with_injected_clock(self, P):
        now = [0.0]
        c = P.ResultCache(ttl_ms=100, clock=lambda: now[0],
                          registry=P.M.MetricsRegistry())
        c.insert(("k",), 1)
        assert c.lookup(("k",))[0]
        now[0] = 0.099
        assert c.lookup(("k",))[0]
        now[0] = 0.101
        assert not c.lookup(("k",))[0]
        assert c.stats()["entries"] == 0

    def test_flush_and_stats(self, P):
        r = P.M.MetricsRegistry()
        c = P.ResultCache(registry=r)
        c.insert(("a",), 1)
        c.insert(("b",), 2)
        assert c.flush() == 2
        s = c.stats()
        assert s["entries"] == 0 and s["bytes"] == 0 and s["evictions"] == 2
        assert r.value(P.M.METRIC_CACHE_EVICTIONS, reason="flush") == 2
        assert r.value(P.M.METRIC_CACHE_ENTRIES) == 0

    def test_run_single_flight_one_compute(self, P):
        c = P.ResultCache(registry=P.M.MetricsRegistry())
        computes = []
        entered = threading.Event()
        release = threading.Event()

        def compute():
            computes.append(1)
            entered.set()
            release.wait(5)
            return {"v": 42}

        with ThreadPoolExecutor(max_workers=8) as pool:
            futs = [pool.submit(c.run, ("k",), compute) for _ in range(8)]
            entered.wait(5)
            release.set()
            out = [f.result(timeout=10) for f in futs]
        assert len(computes) == 1
        assert all(o == {"v": 42} for o in out)
        assert len({id(o) for o in out}) == len(out)

    def test_fetch_leader_follower_protocol(self, P):
        r = P.M.MetricsRegistry()
        c = P.ResultCache(registry=r)
        assert c.fetch(("k",)) == ("leader", None)
        state, fut = c.fetch(("k",))
        assert state == "follower" and not fut.done()
        c.complete(("k",), [5])
        assert fut.result(timeout=1) == [5]
        assert c.fetch(("k",)) == ("hit", [5])
        assert r.value(P.M.METRIC_CACHE_SINGLEFLIGHT) == 1
        c.observe_dispatch(0.001)
        c.bypass()
        assert r.value(P.M.METRIC_CACHE_BYPASS) == 1

    def test_run_failure_propagates_and_caches_nothing(self, P):
        c = P.ResultCache(registry=P.M.MetricsRegistry())

        def boom():
            raise RuntimeError("dispatch failed")

        with pytest.raises(RuntimeError):
            c.run(("k",), boom)
        assert c.stats()["inflight"] == 0
        assert c.run(("k",), lambda: 7) == 7

    def test_tenant_quota_hooks(self, P):
        r = P.M.MetricsRegistry()
        c = P.ResultCache(registry=r)
        seen = []
        c.tenant_hook = lambda kind, n: seen.append(kind)
        c.tenant_of = lambda: "t1"
        c.tenant_quota_bytes = P.estimate_cost([1]) + 1
        c.insert(("a",), [1])
        c.insert(("b",), [1])  # over the tenant's quota: not cached
        assert c.lookup(("a",))[0] and not c.lookup(("b",))[0]
        assert seen == ["bytes", "hit"]
        # a per-tenant override wins over the shared quota
        c.tenant_quota_of = lambda t: 4 * P.estimate_cost([1])
        c.insert(("b",), [1])
        assert c.lookup(("b",))[0]

    def test_brownout_serves_the_previous_version_once_flagged(self, P):
        """The stale path under a stub brownout controller: a miss on a
        newer version fingerprint serves the newest resident entry of the
        same query and flags the thread; remote legs
        (``allow_stale=False``) never serve stale; an entry older than
        ``stale_ttl_s`` is not served."""
        now = [0.0]

        class Brownout:
            stale_ttl_s = 5.0

            def brownout_active(self):
                return True

        r = P.M.MetricsRegistry()
        c = P.ResultCache(registry=r, clock=lambda: now[0])
        assert c.lookup(("q", "i", "fp2"))[0] is False  # degrade unset
        c.degrade = Brownout()
        c.run(("q", "i", "fp1"), lambda: [1])
        assert c.lookup(("q", "i", "fp2")) == (True, [1])
        assert c.take_stale_flag() is True
        assert c.take_stale_flag() is False
        c.mark_stale()  # a fan-out leg's flag forwarded to this thread
        assert c.take_stale_flag() is True
        assert c.lookup(("q", "i", "fp2"), allow_stale=False)[0] is False
        assert c.run(("q", "i", "fp3"), lambda: [9]) == [1]  # no compute
        assert c.stats()["stale_serves"] == 2
        assert r.value(P.M.METRIC_CACHE_STALE_SERVES) == 2
        now[0] = 6.0  # past stale_ttl_s: the run computes afresh
        assert c.run(("q", "i", "fp4"), lambda: [4]) == [4]
        c.flush()
        assert c.lookup(("q", "i", "fp5"))[0] is False

    def test_stub_scheduler_unaffected_by_cache(self, P):
        class Stub:
            def execute(self, index, query, shards=None):
                return [c.to_pql() for c in query.calls]

        s = P.sched.QueryScheduler(Stub(), window_ms=0,
                                   registry=P.M.MetricsRegistry())
        try:
            assert s.execute("i", "Count(Row(f=1))") == ["Count(Row(f=1))"]
        finally:
            s.close()


# -- weighted-fair ordering (tests/test_tenants.py's TestFairShare) --------


class TestFairShare:
    def test_higher_weight_tenant_dispatches_first(self, P, make_sched):
        stub = StubExecutor()
        s = make_sched(stub, window_ms=0, fair_share=True)
        s.set_fair_share(True, lambda t: 4.0 if t == "light" else 1.0)
        s.pause()
        handles = []
        # one group key per submit (distinct index), so dispatch order is
        # the (rank, vtime, seq) head pick alone
        with P.tenants.tenant_scope("heavy"):
            for i in range(4):
                handles.append(s.submit(f"h{i}", "Count(Row(f=1))"))
        with P.tenants.tenant_scope("light"):
            for i in range(4):
                handles.append(s.submit(f"l{i}", "Count(Row(f=1))"))
        assert s.wait_queued(8) == 8
        s.resume()
        for h in handles:
            h.result(timeout=5)
        # heavy strides 1 -> vtimes 1, 2, 3, 4; light strides 1/4 ->
        # .25, .5, .75, 1.0; the tie at 1.0 breaks on seq
        assert [c[0] for c in stub.calls] == ["l0", "l1", "l2", "h0", "l3",
                                              "h1", "h2", "h3"]

    def test_fair_off_is_strict_fifo(self, P, make_sched):
        stub = StubExecutor()
        s = make_sched(stub, window_ms=0)
        s.pause()
        handles = []
        for i, t in enumerate(["a", "b", "a", "b"]):
            with P.tenants.tenant_scope(t):
                handles.append(s.submit(f"q{i}", "Count(Row(f=1))"))
        assert s.wait_queued(4) == 4
        s.resume()
        for h in handles:
            h.result(timeout=5)
        assert [c[0] for c in stub.calls] == ["q0", "q1", "q2", "q3"]

    def test_toggle_clears_vtime_state_and_shows_in_stats(self, P,
                                                          make_sched):
        s = make_sched(StubExecutor(), window_ms=0, fair_share=True)
        assert s.stats()["fair_share"] is True
        s.pause()
        with P.tenants.tenant_scope("t"):
            h = s.submit("i", "Count(Row(f=1))")
        s.resume()
        h.result(timeout=5)
        assert set(s._tenant_vtime) == {"t"}
        s.set_fair_share(False)
        assert s.stats()["fair_share"] is False
        assert s._tenant_vtime == {}

    def test_from_config_needs_both_tenant_flags(self, P, make_sched):
        cfg = P.Config(tenants_enabled=True)
        assert not make_sched(StubExecutor()).fair_share
        s = P.sched.QueryScheduler.from_config(
            StubExecutor(), cfg, registry=P.M.MetricsRegistry())
        try:
            assert s.fair_share is cfg.tenants_fair_share
        finally:
            s.close()

    def test_vtime_table_is_bounded(self, P, make_sched):
        s = make_sched(StubExecutor(), window_ms=0, fair_share=True)
        q = P.parse("Count(Row(f=1))")
        for i in range(600):
            p = P.sched.scheduler._Pending("i", q, None, "interactive",
                                           None, 0.0, i)
            p.tenant = f"t{i}"
            s._assign_vtime_locked(p)
            assert len(s._tenant_vtime) <= 256
            assert p.vtime >= s._vclock


def _load_cached(root):
    if root not in _PACKAGES:
        _PACKAGES[root] = _load(root)
    return _PACKAGES[root]


# -- config ---------------------------------------------------------------


_SERVING_FIELDS = [
    ("scheduler_enabled", "true", True),
    ("scheduler_window_ms", "2.5", 2.5),
    ("scheduler_max_batch", "16", 16),
    ("scheduler_max_queue", "99", 99),
    ("scheduler_default_deadline_ms", "40", 40.0),
    ("scheduler_fuse_waste_ratio", "3.5", 3.5),
    ("scheduler_adaptive_window", "true", True),
    ("scheduler_window_min_ms", "0.5", 0.5),
    ("scheduler_window_max_ms", "9", 9.0),
    ("scheduler_batch_holdoff_ms", "7", 7.0),
    ("cache_enabled", "1", True),
    ("cache_max_bytes", "1048576", 1 << 20),
    ("cache_max_entries", "77", 77),
    ("cache_ttl_ms", "250", 250.0),
    ("tenants_enabled", "yes", True),
    ("tenants_fair_share", "false", False),
]


class TestConfig:
    def test_defaults_agree(self, P):
        jax_cfg = _load_cached("pilosa_tpu").Config()
        cfg = P.Config()
        for name, _, _ in _SERVING_FIELDS:
            assert getattr(cfg, name) == getattr(jax_cfg, name), name

    def test_env_overrides(self, P):
        env = {"PILOSA_TPU_" + n.upper(): raw for n, raw, _ in _SERVING_FIELDS}
        cfg = P.Config.from_sources(env=env)
        for name, _, want in _SERVING_FIELDS:
            assert getattr(cfg, name) == want, name

    def test_toml_sections_and_round_trip(self, P, tmp_path):
        path = tmp_path / "c.toml"
        path.write_text("[scheduler]\nwindow-ms = 2.0\nmax-batch = 32\n"
                        "fuse-waste-ratio = 0.0\n[cache]\nenabled = true\n"
                        "max-entries = 11\n")
        cfg = P.Config.from_sources(toml_path=str(path), env={})
        assert (cfg.scheduler_window_ms, cfg.scheduler_max_batch,
                cfg.scheduler_fuse_waste_ratio) == (2.0, 32, 0.0)
        assert cfg.cache_enabled is True and cfg.cache_max_entries == 11
        again = tmp_path / "again.toml"
        again.write_text(cfg.to_toml())
        back = P.Config.from_sources(toml_path=str(again), env={})
        for name, _, _ in _SERVING_FIELDS:
            assert getattr(back, name) == getattr(cfg, name), name

    def test_flags_win_over_env(self, P):
        cfg = P.Config.from_sources(
            env={"PILOSA_TPU_SCHEDULER_MAX_BATCH": "8"},
            flags={"scheduler_max_batch": 4, "cache_ttl_ms": None})
        assert cfg.scheduler_max_batch == 4 and cfg.cache_ttl_ms == 0.0

    def test_scheduler_and_cache_from_config(self, P):
        cfg = P.Config()
        cfg.scheduler_window_ms = 3.0
        cfg.scheduler_max_batch = 7
        cfg.scheduler_adaptive_window = True
        cfg.scheduler_window_min_ms = 0.5
        cfg.scheduler_window_max_ms = 9.0
        cfg.scheduler_fuse_waste_ratio = 3.5
        s = P.sched.QueryScheduler.from_config(
            StubFusionExecutor(), cfg, registry=P.M.MetricsRegistry())
        try:
            assert s.window_s == 0.003 and s.max_batch == 7
            assert s.fuse_waste_ratio == 3.5 and s.adaptive_window is True
            assert s.window_min_s == 0.0005 and s.window_max_s == 0.009
        finally:
            s.close()
        cfg.cache_max_entries = 9
        c = P.ResultCache.from_config(cfg, registry=P.M.MetricsRegistry())
        assert c.max_entries == 9 and c.max_bytes == cfg.cache_max_bytes
        c2 = P.ResultCache.from_config(cfg, max_entries=3,
                                       registry=P.M.MetricsRegistry())
        assert c2.max_entries == 3


# -- tracing (tests/test_tracing.py without a server) ----------------------


@pytest.fixture
def tracer(P):
    prev = P.T.get_tracer()
    reg = P.M.MetricsRegistry()
    t = P.T.Tracer(enabled=True, sample_rate=1.0,
                   store=P.T.TraceStore(64, registry=reg), registry=reg)
    P.T.set_tracer(t)
    yield t
    P.T.set_tracer(prev)


class TestTracing:
    def test_span_tree_and_parentage(self, P, tracer):
        cur = P.T.current_span
        with tracer.start_trace("root", index="i") as root:
            assert cur() is root
            with tracer.start_span("child") as child:
                assert cur() is child
                with tracer.start_span("grand") as grand:
                    pass
            assert cur() is root
        assert cur() is None
        assert child.trace_id == root.trace_id
        assert child.parent_id == root.span_id
        assert grand.parent_id == child.span_id
        doc = root.to_json()
        assert doc["name"] == "root" and doc["tags"] == {"index": "i"}
        assert [c["name"] for c in doc["children"]] == ["child"]
        assert tracer.registry.value(P.M.METRIC_TRACE_STARTED) == 1.0
        assert tracer.registry.value(P.M.METRIC_TRACE_FINISHED) == 1.0

    def test_record_and_error_and_nop(self, P, tracer):
        with tracer.start_trace("root") as root:
            root.record("sched.queue_wait", 0.005, priority="interactive")
        (wait,) = root.to_json()["children"]
        assert wait["duration_ns"] == 5_000_000
        with pytest.raises(RuntimeError):
            with tracer.start_trace("root") as r2:
                raise RuntimeError("boom")
        assert r2.tags["error"] == "boom" and P.T.current_span() is None
        assert tracer.start_span("orphan") is P.T.NOP_SPAN

    def test_nested_start_trace_joins_as_child(self, tracer):
        with tracer.profile("query.profile") as outer:
            with tracer.start_trace("query.pql") as inner:
                pass
        assert inner.trace_id == outer.trace_id
        assert inner.parent_id == outer.span_id

    def test_disabled_tracer_returns_the_one_shared_span(self, P):
        t = P.T.NopTracer()
        nop = P.T.NOP_SPAN
        assert {id(t.start_trace("a")), id(t.start_span("b"))} == {id(nop)}
        assert nop.set_tag("k", "v") is nop and nop.record("x", 1.0) is nop
        with t.profile("query.profile") as root:
            with t.start_span("stage"):
                pass
        assert [c["name"] for c in root.to_json()["children"]] == ["stage"]

    def test_unsampled_root_counts(self, P):
        reg = P.M.MetricsRegistry()
        t = P.T.Tracer(enabled=True, sample_rate=0.5, registry=reg,
                       rng=random.Random(7))
        real = 0
        for _ in range(40):
            s = t.start_trace("q")
            real += s is not P.T.NOP_SPAN
            s.finish()
        assert 0 < real < 40
        assert reg.value(P.M.METRIC_TRACE_STARTED) == float(real)
        assert reg.value(P.M.METRIC_TRACE_UNSAMPLED) == float(40 - real)

    @pytest.mark.parametrize("bad", [
        None, 42, "", "00-abc", "00-" + "g" * 32 + "-" + "cd" * 8 + "-01",
        "00-" + "ab" * 16 + "-" + "cd" * 8 + "-zz",
    ])
    def test_malformed_traceparent_is_rejected(self, P, bad):
        assert P.T.parse_traceparent(bad) is None

    def test_traceparent_round_trip_and_scope(self, P, tracer):
        tid, sid = "ab" * 16, "cd" * 8
        fmt, parse_tp = P.T.format_traceparent, P.T.parse_traceparent
        assert parse_tp(fmt(tid, sid, True)) == (tid, sid, True)
        assert parse_tp(fmt(tid, sid, False)) == (tid, sid, False)
        assert P.T.current_traceparent() is None
        with tracer.start_trace("root") as root:
            assert P.T.current_traceparent() == fmt(root.trace_id,
                                                    root.span_id)
        span = P.T.NopTracer().start_remote("rpc.query", fmt(tid, sid, True))
        assert span.trace_id == tid and span.parent_id == sid
        span.finish()

    def test_span_scope_restores_parentage_on_a_worker(self, P, tracer):
        got = {}
        with tracer.start_trace("root") as root:
            def worker():
                assert P.T.current_span() is None
                with P.T.span_scope(root):
                    with tracer.start_span("stage") as s:
                        got["span"] = s

            th = threading.Thread(target=worker)
            th.start()
            th.join(timeout=10)
        assert got["span"].parent_id == root.span_id

    def test_trace_store_capacity(self, P):
        reg = P.M.MetricsRegistry()
        store = P.T.TraceStore(capacity=3, registry=reg)
        t = P.T.Tracer(enabled=True, store=store, registry=reg)
        ids = []
        for i in range(5):
            with t.start_trace(f"q{i}") as root:
                ids.append(root.trace_id)
        assert len(store) == 3
        assert reg.value(P.M.METRIC_TRACE_STORE_DROPPED) == 2.0
        assert [s["root"] for s in store.list()] == ["q4", "q3", "q2"]
        with pytest.raises(KeyError):
            store.get(ids[0])

    def test_trace_metrics_exposition(self, P):
        reg = P.M.MetricsRegistry()
        t = P.T.Tracer(enabled=True, store=P.T.TraceStore(8, registry=reg),
                       registry=reg)
        with t.start_trace("q") as root:
            with t.start_span("stage"):
                pass
            root.record("sched.queue_wait", 0.001)
        text = reg.prometheus_text()
        assert "trace_started_total 1" in text
        assert 'trace_duration_ms_bucket{le="+Inf"} 1' in text
        assert 'stage="sched.queue_wait"' in text
        assert reg.as_json()["counters"]["trace_started_total"] == 1.0

    def test_scheduler_records_queue_wait(self, P, tracer, make_sched):
        s = make_sched(StubExecutor(), window_ms=0)
        with tracer.start_trace("query.pql") as root:
            assert s.execute("i", "Count(Row(f=1))") == ["Count(Row(f=1))"]
        names = [c["name"] for c in root.to_json()["children"]]
        assert "sched.queue_wait" in names


def test_metric_names_equal(P):
    jax_m = _load_cached("pilosa_tpu").M
    names = {k: v for k, v in vars(jax_m).items() if k.startswith("METRIC_")}
    assert {k: v for k, v in vars(P.M).items()
            if k.startswith("METRIC_")} == names
    buckets = {k: v for k, v in vars(jax_m).items() if k.endswith("BUCKETS")}
    assert {k: v for k, v in vars(P.M).items()
            if k.endswith("BUCKETS")} == buckets


def test_tenant_scope(P):
    assert P.tenants.current_tenant_id() is None
    with P.tenants.tenant_scope("acme"):
        assert P.tenants.current_tenant_id() == "acme"
        token = P.tenants.set_current_tenant("b")
        assert P.tenants.current_tenant_id() == "b"
        P.tenants.reset_current_tenant(token)
        assert P.tenants.current_tenant_id() == "acme"
    assert P.tenants.current_tenant_id() is None
    assert P.tenants.DEFAULT_TENANT == "default"


# -- lock tracer (tests/test_locktrace.py on private registries) -----------


def _tracked(P, name, reg, **kw):
    return P.locktrace._TrackedLock(name, reg, **kw)


class TestLockTrace:
    def test_disabled_path_allocates_no_wrappers(self, P):
        lt = P.locktrace
        if lt.ACTIVE is not None:
            pytest.skip("the lock tracer is enabled in this process")
        before = lt.WRAPPER_COUNT
        lk = lt.tracked_lock("t.disabled")
        lt.tracked_lock("t.disabled.r", rlock=True)
        assert lt.WRAPPER_COUNT == before
        assert type(lk) is type(threading.Lock())
        assert lt.held_locks() == [] and lt.report()["enabled"] is False

    def test_nested_acquire_records_edge_and_held_stack(self, P):
        reg = P.locktrace.LockTraceRegistry()
        a, b = _tracked(P, "A", reg), _tracked(P, "B", reg)
        with a:
            assert reg.held_locks() == ["A"]
            with b:
                assert reg.held_locks() == ["A", "B"]
        assert reg.held_locks() == []
        assert reg.report()["edges"] == {"A": ["B"]}
        assert reg.violations() == []

    def test_ab_ba_cycle_detected_without_deadlocking(self, P):
        reg = P.locktrace.LockTraceRegistry()
        a, b = _tracked(P, "A", reg), _tracked(P, "B", reg)
        with a:
            with b:
                pass

        def reversed_order():
            with b:
                with a:
                    pass

        t = threading.Thread(target=reversed_order)
        t.start()
        t.join(timeout=10)
        vs = reg.violations(kind=P.locktrace.KIND_CYCLE)
        assert len(vs) == 1 and set(vs[0]["cycle"]) == {"A", "B"}

    def test_three_lock_cycle_reports_full_path(self, P):
        reg = P.locktrace.LockTraceRegistry()
        a, b, c = (_tracked(P, n, reg) for n in "ABC")
        for outer, inner in ((a, b), (b, c), (c, a)):
            with outer:
                with inner:
                    pass
        vs = reg.violations(kind=P.locktrace.KIND_CYCLE)
        assert len(vs) == 1 and set(vs[0]["cycle"]) == {"A", "B", "C"}

    def test_rlock_and_condition_bookkeeping(self, P):
        reg = P.locktrace.LockTraceRegistry()
        r = _tracked(P, "R", reg, rlock=True)
        with r:
            with r:
                assert reg.held_locks() == ["R"]
        assert reg.held_locks() == []
        cv = threading.Condition(_tracked(P, "CV", reg))
        waiting = threading.Event()
        held_after_wait = []

        def waiter():
            with cv:
                waiting.set()
                cv.wait(timeout=10)
                held_after_wait.append(reg.held_locks())

        t = threading.Thread(target=waiter)
        t.start()
        waiting.wait(10)
        with cv:  # acquirable only once the waiter is inside wait()
            cv.notify_all()
        t.join(timeout=10)
        assert held_after_wait == [["CV"]] and reg.violations() == []

    def test_dispatch_and_io_checks(self, P):
        lt = P.locktrace
        reg = lt.LockTraceRegistry()
        lk = _tracked(P, "holder", reg)
        guard = _tracked(P, "guard", reg, dispatch_ok=True, io_ok=True)
        with guard:
            reg.note_dispatch("site")
            reg.note_io("wire")
        assert reg.violations() == []
        with lk:
            reg.note_dispatch("site")
            reg.note_dispatch("site")  # dedups
            reg.note_io("wire")
        assert [v["kind"] for v in reg.violations()] == [lt.KIND_DISPATCH,
                                                         lt.KIND_IO]

    def test_violation_counts_metric_and_ring_is_bounded(self, P):
        lt = P.locktrace
        reg = lt.LockTraceRegistry()
        lk = _tracked(P, "cap", reg)
        before = P.M.REGISTRY.value(P.M.METRIC_LOCK_VIOLATIONS,
                                    kind=lt.KIND_DISPATCH)
        with lk:
            for i in range(lt.VIOLATION_CAP + 50):
                reg.note_dispatch(f"site-{i}")
        assert len(reg.violations()) == lt.VIOLATION_CAP
        assert P.M.REGISTRY.value(P.M.METRIC_LOCK_VIOLATIONS,
                                  kind=lt.KIND_DISPATCH) \
            == before + lt.VIOLATION_CAP

    def test_report_and_probe_shapes(self, P):
        reg = P.locktrace.LockTraceRegistry()
        a, b = _tracked(P, "A", reg), _tracked(P, "B", reg)
        with a:
            with b:
                pass
        rep = reg.report()
        assert rep["locks"] == {"A": 1, "B": 1}
        assert rep["edges"] == {"A": ["B"]}
        assert reg.timeline_probe() == {"enabled": True, "violations": 0,
                                        "cycles": 0, "edges": 1}


# -- shard masks on the device --------------------------------------------


_MASK_CASES = [
    ([0, 1, 2, 3], {1, 3}), ([0, 1, 2, 3], set()), ([5, 9], {5, 9}),
    ([2], {2}), (list(range(8)), {0, 7}),
]


@pytest.mark.parametrize("shards, subset", _MASK_CASES)
def test_shard_mask_plane_bit_for_bit(shards, subset):
    from pilosa_tpu.ops import bitmap as JB
    from pilosa_tpu_torch import platform
    from pilosa_tpu_torch.ops import bitmap as TB

    want = JB.shard_mask_plane(shards, subset, words=64)
    got = TB.shard_mask_plane(shards, subset, words=64)
    assert got.dtype == want.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    dev = platform.h2d_copy(got, torch.device("cpu"))
    assert dev.dtype == torch.int32
    on = np.repeat([s in subset for s in shards], 64)
    assert bool((dev[torch.from_numpy(on)] == -1).all())
    assert bool((dev[torch.from_numpy(~on)] == 0).all())


@pytest.mark.parametrize("with_filter", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
def test_mask_filter_bit_for_bit(with_filter, with_mask):
    import jax.numpy as jnp

    from pilosa_tpu.ops import bitmap as JB
    from pilosa_tpu.ops import bsi as JS
    from pilosa_tpu_torch.ops import bsi as TS

    rng = np.random.default_rng(7)
    filt = rng.integers(0, 1 << 32, 4 * 64, dtype=np.uint32) \
        if with_filter else None
    mask = JB.shard_mask_plane([0, 1, 2, 3], {0, 2}, words=64) \
        if with_mask else None
    want = JS.mask_filter(None if filt is None else jnp.asarray(filt),
                          None if mask is None else jnp.asarray(mask))
    t = lambda a: None if a is None else torch.from_numpy(  # noqa: E731
        a.view(np.int32))
    got = TS.mask_filter(t(filt), t(mask))
    if want is None:
        assert got is None
        return
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))


def test_plane_intersection_count_routes_and_agrees():
    from pilosa_tpu.ops import bitmap as JB
    from pilosa_tpu_torch.ops import bitmap as TB

    rng = np.random.default_rng(3)
    a = rng.integers(0, 1 << 32, 3 * 64, dtype=np.uint32)
    mask = JB.shard_mask_plane([0, 1, 2], {1}, words=64)
    want = int(JB.plane_intersection_count(a, mask))
    t = lambda x: torch.from_numpy(x.view(np.int32))  # noqa: E731
    assert int(TB.plane_intersection_count(t(a), t(mask))) == want
    assert int(TB.plane_intersection_count_plain(t(a), t(mask))) == want
