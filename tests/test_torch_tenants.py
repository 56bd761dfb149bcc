"""Tenant attribution plane (``obs/tenants.py`` and its wiring), run
once per package, and the port's device-seconds charge at the fold.

The ``P`` fixture yields the modules of ``pilosa_tpu`` or of their
``pilosa_tpu_torch`` counterparts; ``P.API()`` and ``P.LocalCluster``
build the port's with ``device="cpu"``. Covered: every case of
``tests/test_tenants.py`` but ``TestFairShare`` (which
``tests/test_torch_serving.py`` runs): untrusted-ID clamping, the bounded
accounting registry and its top-K publication guard, token-bucket quotas
(429 + Retry-After at the HTTP edge), the per-tenant SLO burn dimension
and its alert edge cases, tenant-scoped cache namespaces and quotas, the
WAL attribution hook, and a 3-node LocalCluster acceptance pass ending
in a tenant_burn flight bundle, once per package.

Port only: a tenant's ``device_seconds`` is the clock of its own kernel
launches, charged when a launch folds (``obs/devprof.py``). Two tenants'
queries run on two threads with their launches left pending, and a third
thread folds them: each tenant is charged exactly its own launches (on
the CPU a launch's clock is the wall time of its plain version).
"""

import importlib
import json
import os
import threading
import types
import urllib.error
import urllib.request

import pytest

from pilosa_tpu.obs.tenants import MAX_TENANT_LEN

JAX, TORCH = "pilosa_tpu", "pilosa_tpu_torch"


def _load(root: str) -> types.SimpleNamespace:
    m = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    kw = {"device": "cpu"} if root == TORCH else {}
    api_cls = m("api").API
    harness = m("cluster.harness")
    T = m("obs.tenants")
    return types.SimpleNamespace(
        root=root,
        API=lambda *a, **k: api_cls(*a, **{**kw, **k}),
        LocalCluster=lambda *a, **k: harness.LocalCluster(*a, **{**kw, **k}),
        QuotaExceededError=m("errors").QuotaExceededError,
        M=m("obs.metrics"),
        T=T,
        MetricsRegistry=m("obs.metrics").MetricsRegistry,
        Objective=m("obs.slo").Objective,
        SLOTracker=m("obs.slo").SLOTracker,
        DEFAULT_TENANT=T.DEFAULT_TENANT,
        OVERFLOW_TENANT=T.OVERFLOW_TENANT,
        TenantRegistry=T.TenantRegistry,
        TokenBucket=T.TokenBucket,
        current_tenant_id=T.current_tenant_id,
        normalize_tenant=T.normalize_tenant,
        tenant_scope=T.tenant_scope,
        ManualClock=m("sched").ManualClock,
        QueryScheduler=m("sched").QueryScheduler,
        serve=m("server.http").serve,
        ResultCache=m("cache.result_cache").ResultCache,
        wal_mod=m("storage.wal"),
    )


_PACKAGES = {}


def _pkg(root):
    if root not in _PACKAGES:
        _PACKAGES[root] = _load(root)
    return _PACKAGES[root]


@pytest.fixture(params=[JAX, TORCH], ids=["jax", "torch"])
def P(request):
    return _pkg(request.param)


# -- the cases of tests/test_tenants.py, once per package ---------------------


class FakeClock:
    """Callable monotonic stand-in for TenantRegistry's ``clock()``."""

    def __init__(self, start: float = 0.0):
        self.t = float(start)

    def __call__(self) -> float:
        return self.t

    def advance(self, s: float) -> None:
        self.t += s


def make_registry(P, **kw):
    kw.setdefault("registry", P.MetricsRegistry())
    kw.setdefault("clock", FakeClock())
    return P.TenantRegistry(**kw)


# -- clamping (satellite 3) ------------------------------------------------


class TestNormalize:
    def test_valid_ids_pass_through(self, P):
        assert P.normalize_tenant("acme") == ("acme", True)
        assert P.normalize_tenant("  t-1.2_x  ") == ("t-1.2_x", True)
        assert P.normalize_tenant("A" * P.T.MAX_TENANT_LEN) == \
            ("A" * P.T.MAX_TENANT_LEN, True)

    @pytest.mark.parametrize("raw", [
        None, "", "   ", "x" * (MAX_TENANT_LEN + 1),  # absent/empty/big
        "café", "tenant name", "a/b", "x\x00y",    # non-slug bytes
    ])
    def test_garbage_clamps_to_default(self, P, raw):
        assert P.normalize_tenant(raw) == (P.DEFAULT_TENANT, False)

    def test_non_str_coerces(self, P):
        # header values are str in practice, but resolve() must never
        # raise on anything a caller hands it
        assert P.normalize_tenant(123) == ("123", True)

    def test_resolve_counts_unattributed(self, P):
        reg = make_registry(P)
        assert reg.resolve("ok-tenant") == "ok-tenant"
        assert reg.registry.value(P.M.METRIC_TENANT_UNATTRIBUTED) == 0
        assert reg.resolve("") == P.DEFAULT_TENANT
        assert reg.resolve("bad tenant!") == P.DEFAULT_TENANT
        assert reg.registry.value(P.M.METRIC_TENANT_UNATTRIBUTED) == 2


# -- scope ------------------------------------------------------------------


class TestScope:
    def test_scope_sets_and_restores(self, P):
        assert P.current_tenant_id() is None
        with P.tenant_scope("a"):
            assert P.current_tenant_id() == "a"
            with P.tenant_scope("b"):
                assert P.current_tenant_id() == "b"
            assert P.current_tenant_id() == "a"
        assert P.current_tenant_id() is None

    def test_scope_count_moves_only_inside_scopes(self, P):
        before = P.T.SCOPE_COUNT
        P.current_tenant_id()
        assert P.T.SCOPE_COUNT == before  # reads are free
        with P.tenant_scope("a"):
            pass
        assert P.T.SCOPE_COUNT == before + 1


# -- accounting registry ----------------------------------------------------


class TestRegistryAccounting:
    def test_note_accumulates_every_dimension(self, P):
        reg = make_registry(P)
        reg.note("a", queries=2, errors=1, rows=10, device_seconds=0.5,
                 cache_hits=3, cache_bytes=100, wal_bytes=7)
        reg.note("a", queries=1, wal_bytes=3)
        row = reg.stats_json()["tenants"]["a"]
        assert row["queries"] == 3
        assert row["errors"] == 1
        assert row["rows_ingested"] == 10
        assert row["device_seconds"] == 0.5
        assert row["cache_hits"] == 3
        assert row["cache_bytes"] == 100
        assert row["wal_bytes"] == 10

    def test_none_tenant_lands_on_default(self, P):
        reg = make_registry(P)
        reg.note_query(None)
        reg.note_query(None, error=True)
        row = reg.stats_json()["tenants"][P.DEFAULT_TENANT]
        assert row["queries"] == 2 and row["errors"] == 1

    def test_max_tracked_folds_into_overflow_cell(self, P):
        reg = make_registry(P, max_tracked=3)
        for i in range(5):
            reg.note_query(f"t{i}")
        st = reg.stats_json()
        # t0..t2 tracked individually; t3/t4 share the overflow cell
        assert set(st["tenants"]) == {"t0", "t1", "t2", P.OVERFLOW_TENANT}
        assert st["dropped"] == 2
        assert st["tenants"][P.OVERFLOW_TENANT]["queries"] == 2
        assert st["max_tracked"] == 3

    def test_publish_guards_label_space_to_top_k(self, P):
        reg = make_registry(P, top_k=2)
        for i, n in enumerate([10, 5, 1, 1]):
            reg.note("t%d" % i, queries=n)
        reg.publish()
        mreg = reg.registry
        assert mreg.value(P.M.METRIC_TENANT_TRACKED) == 4
        assert mreg.value(P.M.METRIC_TENANT_QUERIES, tenant="t0") == 10
        assert mreg.value(P.M.METRIC_TENANT_QUERIES, tenant="t1") == 5
        # below the K cut: no gauge series exists for t2/t3
        assert mreg.value(P.M.METRIC_TENANT_QUERIES, tenant="t2") == 0.0
        assert reg.stats_json()["top_k"] == ["t0", "t1"]
        # ...but the raw endpoint payload still carries every tenant
        assert set(reg.stats_json()["tenants"]) == {"t0", "t1", "t2", "t3"}

    def test_timeline_probe_reports_rates_between_calls(self, P):
        clock = FakeClock()
        reg = make_registry(P, clock=clock)
        reg.note("a", queries=4, rows=8)
        first = reg.timeline_probe()
        assert first["enabled"] is True and first["rates"] == {}
        reg.note("a", queries=10, rows=20)
        clock.advance(2.0)
        probe = reg.timeline_probe()
        assert probe["rates"]["a"]["qps"] == pytest.approx(5.0)
        assert probe["rates"]["a"]["rows_per_s"] == pytest.approx(10.0)


# -- quotas -----------------------------------------------------------------


class TestQuotas:
    def test_token_bucket_refills_and_reports_retry(self, P):
        b = P.TokenBucket(rate=2.0, burst=2.0, now=0.0)
        assert b.take(2.0, now=0.0) is None
        retry = b.take(1.0, now=0.0)
        assert retry == pytest.approx(0.5)
        assert b.take(1.0, now=0.5) is None  # refilled exactly enough

    def test_rate_zero_is_unlimited(self, P):
        b = P.TokenBucket(rate=0.0, burst=1.0, now=0.0)
        for _ in range(100):
            assert b.take(1.0, now=0.0) is None
        reg = make_registry(P)  # default quotas are 0 = attribution only
        for _ in range(100):
            reg.charge_query("free")
        assert reg.registry.value(P.M.METRIC_TENANT_REJECTED,
                                  tenant="free", kind="qps") == 0

    def test_qps_quota_rejects_with_retry_after(self, P):
        clock = FakeClock()
        reg = make_registry(P, clock=clock)
        reg.set_quota("spam", qps=2.0)  # burst = 2.0 * qps_burst_s(2) = 4
        for _ in range(4):
            reg.charge_query("spam")
        with pytest.raises(P.QuotaExceededError) as ei:
            reg.charge_query("spam")
        assert ei.value.retry_after_s == pytest.approx(0.5)
        assert reg.registry.value(P.M.METRIC_TENANT_REJECTED,
                                  tenant="spam", kind="qps") == 1
        assert reg.stats_json()["tenants"]["spam"]["rejected"] == 1
        clock.advance(0.5)  # one token refilled
        reg.charge_query("spam")

    def test_ingest_quota_charges_rows(self, P):
        clock = FakeClock()
        reg = make_registry(P, clock=clock)
        reg.set_quota("bulk", ingest_rows_s=10.0)  # burst 20
        reg.charge_ingest("bulk", 20)
        with pytest.raises(P.QuotaExceededError) as ei:
            reg.charge_ingest("bulk", 1)
        assert ei.value.retry_after_s == pytest.approx(0.1)
        assert reg.registry.value(P.M.METRIC_TENANT_REJECTED,
                                  tenant="bulk", kind="ingest") == 1
        reg.charge_ingest("bulk", 0)  # zero rows never charges

    def test_set_quota_rerate_drops_old_bucket(self, P):
        reg = make_registry(P)
        reg.set_quota("t", qps=1.0)  # burst 2
        reg.charge_query("t")
        reg.charge_query("t")
        with pytest.raises(P.QuotaExceededError):
            reg.charge_query("t")
        reg.set_quota("t", qps=100.0)  # fresh bucket at full burst
        reg.charge_query("t")

    def test_weights_default_and_floor(self, P):
        reg = make_registry(P)
        assert reg.weight("anyone") == 1.0
        reg.set_weight("vip", 4.0)
        assert reg.weight("vip") == 4.0
        reg.set_weight("zero", 0.0)  # clamped, never divides by zero
        assert reg.weight("zero") > 0


# -- SLO tenant dimension + edge cases (satellite 2) ------------------------


class TestSLOTenants:
    def make(self, P, **kw):
        kw.setdefault("registry", P.MetricsRegistry())
        kw.setdefault("clock", P.ManualClock())
        return P.SLOTracker(**kw)

    def test_no_tenant_events_is_free(self, P):
        slo = self.make(P)
        slo.record("query", 1.0)  # untagged traffic only
        assert slo.tenant_burn_rates() == []
        assert slo.tenant_alerting() == []

    def test_per_tenant_burn_and_gauges(self, P):
        slo = self.make(P)
        for _ in range(10):
            slo.record("query", 1.0, error=True, tenant="mallory")
            slo.record("query", 1.0, tenant="alice")
        rows = {(r["tenant"], r["name"]): r for r in slo.tenant_burn_rates()}
        bad = rows[("mallory", "query-errors")]
        good = rows[("alice", "query-errors")]
        assert bad["alerting"] and bad["fast_burn"] >= 10.0
        assert not good["alerting"] and good["fast_burn"] == 0.0
        v = slo.registry.value(P.M.METRIC_SLO_BURN_RATE, slo="query-errors",
                               tenant="mallory", window="fast")
        assert v == pytest.approx(bad["fast_burn"])
        assert slo.status()["tenants"]  # status carries the rows too
        assert [r["tenant"] for r in slo.tenant_alerting()] == ["mallory"]

    def test_tenant_cap_folds_hostile_ids(self, P):
        slo = self.make(P)
        slo.tenant_cap = 3
        for i in range(6):
            slo.record("query", 1.0, tenant=f"t{i}")
        tenants = {r["tenant"] for r in slo.tenant_burn_rates()}
        assert tenants == {"t0", "t1", "t2", "__other__"}

    def test_window_boundary_at_exactly_slow_window(self, P):
        clock = P.ManualClock()
        slo = self.make(P, clock=clock, bucket_s=5.0, slow_window_s=3600.0)
        slo.record("query", 1.0, error=True, tenant="a")  # bucket t=0
        clock.advance(3600.0)
        row = slo.tenant_burn_rates()[0]
        # cutoff == bucket start: the bucket's span (0, 5] still
        # overlaps the window, so the event counts...
        assert row["events_slow"] == 1
        clock.advance(5.0)
        # ...and ages out exactly one bucket width later
        assert slo.tenant_burn_rates() == [] or \
            slo.tenant_burn_rates()[0]["events_slow"] == 0

    def test_min_events_boundary(self, P):
        slo = self.make(P, min_events=5)
        for _ in range(4):
            slo.record("query", 1.0, error=True, tenant="m")
        rows = {r["name"]: r for r in slo.tenant_burn_rates()}
        # burn is sky-high but 4 < min_events: a blip must not page
        assert rows["query-errors"]["fast_burn"] > 100
        assert not rows["query-errors"]["alerting"]
        slo.record("query", 1.0, error=True, tenant="m")
        rows = {r["name"]: r for r in slo.tenant_burn_rates()}
        assert rows["query-errors"]["alerting"]

    def test_target_one_has_zero_budget_but_never_divides_by_zero(self, P):
        objs = [P.Objective("strict", "query", "errors", 1.0)]
        slo = self.make(P, objectives=objs)
        slo.record("query", 1.0, tenant="a")
        rows = slo.tenant_burn_rates()
        assert rows[0]["fast_burn"] == 0.0  # no bad events: zero burn
        slo.record("query", 1.0, error=True, tenant="a")
        rows = slo.tenant_burn_rates()
        assert rows[0]["fast_burn"] > 1e6  # one bad event: burn explodes
        # overall evaluation path hits the same budget clamp
        assert slo.burn_rates()[0]["fast_burn"] > 1e6


# -- cache: tenant namespaces + resident quota ------------------------------


class TestCacheTenancy:
    def test_executor_namespace_splits_per_tenant(self, P):
        api = P.API()
        api.create_index("i")
        api.create_field("i", "f")
        ex = api.executor
        base = ex.cache_key("i", "Count(Row(f=1))")
        ex.tenant_namespaces = True
        try:
            with P.tenant_scope("a"):
                ka = ex.cache_key("i", "Count(Row(f=1))")
                assert ka == ex.cache_key("i", "Count(Row(f=1))")
            with P.tenant_scope("b"):
                kb = ex.cache_key("i", "Count(Row(f=1))")
            # out of scope: back to the shared namespace
            assert ex.cache_key("i", "Count(Row(f=1))") == base
            assert len({ka, kb, base}) == 3
        finally:
            ex.tenant_namespaces = False

    def test_cache_hook_attributes_hits_and_bytes(self, P):
        reg = make_registry(P)
        cache = P.ResultCache(registry=P.MetricsRegistry())
        cache.tenant_hook = reg.cache_hook
        cache.tenant_of = P.current_tenant_id
        with P.tenant_scope("a"):
            cache.insert(("k1",), [1, 2, 3])
            hit, _ = cache.lookup(("k1",))
            assert hit
        row = reg.stats_json()["tenants"]["a"]
        assert row["cache_hits"] == 1
        assert row["cache_bytes"] > 0
        # un-scoped traffic: the hook is a no-op, not a crash
        cache.insert(("k2",), [1])
        cache.lookup(("k2",))
        assert "default" not in reg.stats_json()["tenants"]

    def test_resident_quota_skips_insert_and_credits_on_evict(self, P):
        mreg = P.MetricsRegistry()
        cache = P.ResultCache(registry=mreg)
        cache.tenant_of = P.current_tenant_id
        with P.tenant_scope("a"):
            cache.insert(("k1",), [0] * 100)
            cost = cache._entries[("k1",)].cost
            cache.tenant_quota_bytes = cost + 1
            # second entry would push 'a' past its resident quota:
            # skipped (recompute beats displacing other tenants)
            cache.insert(("k2",), [0] * 100)
            assert cache.lookup(("k2",))[0] is False
            assert mreg.value(P.M.METRIC_TENANT_REJECTED,
                              tenant="a", kind="cache") == 1
            # eviction credits the tenant's resident bytes back
            cache.flush()
            cache.insert(("k2",), [0] * 100)
            assert cache.lookup(("k2",))[0] is True
            assert cache._tenant_bytes["a"] == cost


# -- WAL + device hooks -----------------------------------------------------


class TestConsumptionHooks:
    def test_wal_hook_chains_and_uninstalls(self, P):
        seen = []
        prev = P.wal_mod._APPEND_HOOK
        P.wal_mod.set_append_hook(seen.append)
        reg = make_registry(P)
        try:
            reg.install_hooks()
            reg.install_hooks()  # re-entrant: second call is a no-op
            with P.tenant_scope("w"):
                P.wal_mod._APPEND_HOOK(64)
            P.wal_mod._APPEND_HOOK(32)  # un-scoped: attributed nowhere
            assert seen == [64, 32]  # the prior hook still fires
            assert reg.stats_json()["tenants"]["w"]["wal_bytes"] == 64
            assert "default" not in reg.stats_json()["tenants"]
            reg.uninstall_hooks()
            assert P.wal_mod._APPEND_HOOK == seen.append
        finally:
            reg.uninstall_hooks()
            P.wal_mod.set_append_hook(prev)

    def test_wal_append_attributes_real_bytes(self, P, tmp_path):
        api = P.API(path=str(tmp_path))
        api.create_index("i")
        api.create_field("i", "f")
        reg = api.enable_tenants(registry=P.MetricsRegistry())
        try:
            with P.tenant_scope("ing"):
                api.query("i", "Set(1, f=1)")
            assert reg.stats_json()["tenants"]["ing"]["wal_bytes"] > 0
        finally:
            api.disable_tenants()


# -- HTTP edge: attribution, 429 + Retry-After, /internal/tenants -----------


def _req(base, path, method="GET", body=None, tenant=None,
         ctype="text/plain"):
    req = urllib.request.Request(
        base + path, method=method,
        data=body.encode() if isinstance(body, str) else body)
    if body is not None:
        req.add_header("Content-Type", ctype)
    if tenant is not None:
        req.add_header("X-Tenant", tenant)
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, json.loads(resp.read() or b"{}"), \
                dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}"), dict(e.headers)


@pytest.fixture
def http_api(P):
    api = P.API()
    api.create_index("i")
    api.create_field("i", "f")
    api.query("i", "Set(1, f=1)")
    srv, _ = P.serve(api, port=0, background=True)
    host, port = srv.server_address[:2]
    try:
        yield api, f"http://{host}:{port}"
    finally:
        srv.shutdown()
        srv.server_close()
        if api.tenants is not None:
            api.disable_tenants()


class TestHTTPTenancy:
    def test_disabled_plane_reports_disabled(self, P, http_api):
        api, base = http_api
        if api.tenants is not None:  # PILOSA_TPU_TENANTS=1 bootstrap
            api.disable_tenants()
        status, body, _ = _req(base, "/internal/tenants")
        assert status == 200 and body == {"enabled": False}
        # and request handling does zero tenant work
        scope0 = P.T.SCOPE_COUNT
        status, _, _ = _req(base, "/index/i/query", "POST",
                            "Count(Row(f=1))", tenant="ghost")
        assert status == 200
        assert P.T.SCOPE_COUNT == scope0

    def test_header_attribution_and_stats_endpoint(self, P, http_api):
        api, base = http_api
        api.enable_tenants(registry=P.MetricsRegistry())
        for _ in range(3):
            status, _, _ = _req(base, "/index/i/query", "POST",
                                "Count(Row(f=1))", tenant="acme")
            assert status == 200
        status, body, _ = _req(base, "/internal/tenants")
        assert status == 200 and body["enabled"] is True
        assert body["tenants"]["acme"]["queries"] == 3

    def test_query_param_attribution(self, P, http_api):
        api, base = http_api
        reg = api.enable_tenants(registry=P.MetricsRegistry())
        status, _, _ = _req(base, "/index/i/query?tenant=qp-co", "POST",
                            "Count(Row(f=1))")
        assert status == 200
        assert reg.stats_json()["tenants"]["qp-co"]["queries"] == 1

    def test_garbage_tenant_never_400s(self, P, http_api):
        api, base = http_api
        reg = api.enable_tenants(registry=P.MetricsRegistry())
        for bad in ["", "x" * 200, "sp ace", "a/b"]:
            status, _, _ = _req(base, "/index/i/query", "POST",
                                "Count(Row(f=1))", tenant=bad)
            assert status == 200
        assert reg.registry.value(P.M.METRIC_TENANT_UNATTRIBUTED) == 4
        assert reg.stats_json()["tenants"][P.DEFAULT_TENANT]["queries"] == 4

    def test_quota_exhaustion_is_429_with_retry_after(self, P, http_api):
        api, base = http_api
        clock = FakeClock()
        reg = api.enable_tenants(registry=P.MetricsRegistry(), clock=clock)
        reg.set_quota("spam", qps=1.0)  # burst 2
        codes = []
        for _ in range(3):
            status, body, headers = _req(base, "/index/i/query", "POST",
                                         "Count(Row(f=1))", tenant="spam")
            codes.append(status)
        assert codes == [200, 200, 429]
        assert "quota" in body["error"]
        assert int(headers["Retry-After"]) >= 1
        # rejected requests never reach the executor or SLO surface
        assert reg.stats_json()["tenants"]["spam"]["queries"] == 2
        assert reg.stats_json()["tenants"]["spam"]["rejected"] == 1

    def test_ingest_quota_on_import(self, P, http_api):
        api, base = http_api
        reg = api.enable_tenants(registry=P.MetricsRegistry(),
                                 clock=FakeClock())
        reg.set_quota("bulk", ingest_rows_s=2.0)  # burst 4
        body = json.dumps({"field": "f", "rows": [1, 1, 1],
                           "cols": [10, 11, 12]})
        status, _, _ = _req(base, "/index/i/import", "POST", body,
                            tenant="bulk", ctype="application/json")
        assert status == 200
        status, _, headers = _req(base, "/index/i/import", "POST", body,
                                  tenant="bulk", ctype="application/json")
        assert status == 429 and "Retry-After" in headers
        row = reg.stats_json()["tenants"]["bulk"]
        assert row["rows_ingested"] == 3 and row["rejected"] == 1


# -- cluster acceptance: attribution + tenant SLO + flight bundle -----------


class TestClusterAcceptance:
    def test_three_nodes_attribute_burn_and_capture_flight(self, P, tmp_path):
        with P.LocalCluster(3, replica_n=2,
                          base_path=str(tmp_path)) as cluster:
            coord = cluster.coordinator
            coord.create_index("ti")
            coord.create_field("ti", "f")
            coord.import_bits("ti", "f", rows=[1] * 64,
                              cols=list(range(64)))
            cluster.enable_tenants()
            cluster.enable_health()
            base = coord.node.uri

            for t in ("alpha", "bravo", "charlie"):
                for _ in range(3):
                    status, body, _ = _req(base, "/index/ti/query", "POST",
                                           "Count(Row(f=1))", tenant=t)
                    assert status == 200
                    assert body["results"] == [64]
            # mallory's traffic is all errors: fast burn 1000x budget
            for _ in range(6):
                status, _, _ = _req(base, "/index/ti/query", "POST",
                                    "Row(nosuch=1)", tenant="mallory")
                assert status >= 400
            # force a timeline sample while the burn is hot so the
            # flight recorder evaluates its triggers deterministically
            coord.health.timeline.sample()

            status, body, _ = _req(base, "/internal/tenants")
            assert status == 200
            assert {"alpha", "bravo", "charlie", "mallory"} <= \
                set(body["tenants"])
            assert body["tenants"]["mallory"]["errors"] == 6

            rows = coord.health.slo.tenant_burn_rates()
            assert {r["tenant"] for r in rows} >= \
                {"alpha", "bravo", "charlie", "mallory"}
            assert [r["tenant"] for r in
                    coord.health.slo.tenant_alerting()] == ["mallory"]

            # burn gauges land in /metrics with tenant labels
            req = urllib.request.Request(base + "/metrics")
            with urllib.request.urlopen(req, timeout=10) as resp:
                text = resp.read().decode()
            assert "slo_burn_rate{" in text
            assert 'tenant="mallory"' in text

            # the timeline probe carries per-tenant rates (satellite 1)
            sample = coord.health.timeline.window(None)[-1]
            probe = sample["probes"]["tenants"]
            assert probe["enabled"] is True and probe["tracked"] >= 4

            triggers = [s["trigger"]
                        for s in coord.health.flight.summaries()]
            assert "tenant_burn" in triggers


# -- port only: device seconds charged at the fold ----------------------------


def _count_api():
    P = _pkg(TORCH)
    api = P.API()
    api.create_index("i")
    api.create_field("i", "f")
    api.import_bits("i", "f", rows=[1] * 64, cols=list(range(0, 128, 2)))
    return P, api


def test_device_seconds_follow_the_launching_tenant_to_the_fold(
        monkeypatch):
    from pilosa_tpu_torch.obs import devprof

    P, api = _count_api()
    reg = api.enable_tenants(registry=P.MetricsRegistry())
    folds = []  # (tenant, seconds, folding thread) as the hook sees them
    chained = devprof.fold_hook()

    def spy(tenant, seconds):
        folds.append((tenant, seconds, threading.current_thread().name))
        chained(tenant, seconds)

    devprof.set_fold_hook(spy)
    real_drain = devprof.drain
    try:
        assert devprof.TIMED and not devprof.ENABLED
        # the launching threads fold nothing: their launches stay pending
        monkeypatch.setattr(devprof, "drain", lambda block=False: None)

        def run(tenant, n):
            with P.tenant_scope(tenant):
                for _ in range(n):
                    assert api.query("i", "Count(Row(f=1))") == [64]

        threads = [threading.Thread(target=run, args=a, name=f"q-{a[0]}")
                   for a in (("alpha", 3), ("bravo", 5))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not folds
        pending = [e[3] for e in devprof._PENDING]
        assert pending.count("alpha") >= 3 and pending.count("bravo") >= 5
        monkeypatch.setattr(devprof, "drain", real_drain)
        folder = threading.Thread(target=real_drain, kwargs={"block": True},
                                  name="folder")
        folder.start()
        folder.join()
        assert not devprof._PENDING
        assert {f[2] for f in folds} == {"folder"}
        assert sorted(f[0] for f in folds) == sorted(pending)
        rows = reg.stats_json()["tenants"]
        for t in ("alpha", "bravo"):
            want = sum(s for tn, s, _ in folds if tn == t)
            assert want > 0
            assert rows[t]["device_seconds"] == round(want, 6)
        # the profiler's tables stayed off: nothing was profiled
        assert devprof.stats_json() == {"enabled": False}
    finally:
        monkeypatch.setattr(devprof, "drain", real_drain)
        devprof.set_fold_hook(chained)
        api.disable_tenants()
    # with the plane off no launch is timed
    assert devprof.fold_hook() is None and not devprof.TIMED


def test_device_seconds_under_many_threads():
    """More querying threads than cores, each its own tenant, with a
    short switch interval: every launch folds exactly once, onto the
    tenant that made it, whichever thread folds it."""
    import sys

    from pilosa_tpu_torch.obs import devprof

    P, api = _count_api()
    reg = api.enable_tenants(registry=P.MetricsRegistry())
    lock = threading.Lock()
    charged = {}
    chained = devprof.fold_hook()

    def spy(tenant, seconds):
        with lock:
            n, s = charged.get(tenant, (0, 0.0))
            charged[tenant] = (n + 1, s + seconds)
        chained(tenant, seconds)

    devprof.set_fold_hook(spy)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def run(tenant):
            with P.tenant_scope(tenant):
                for _ in range(6):
                    assert api.query("i", "Count(Row(f=1))") == [64]

        # more threads than cores, fewer tenants than the table tracks
        n = max(8, min(24, 3 * (os.cpu_count() or 2)))
        names = [f"t{i}" for i in range(n)]
        threads = [threading.Thread(target=run, args=(t,)) for t in names]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        devprof.drain(block=True)
        assert not devprof._PENDING
        rows = reg.stats_json()["tenants"]
        for t in names:
            n, secs = charged[t]
            assert n >= 6, (t, n)
            assert rows[t]["device_seconds"] == round(secs, 6)
    finally:
        sys.setswitchinterval(interval)
        devprof.set_fold_hook(chained)
        api.disable_tenants()


def test_device_seconds_beside_the_profilers_device_time():
    """With the profiler on too, the tenants' device seconds sum to the
    profiler's device time of the launches made under a tenant."""
    from pilosa_tpu_torch.obs import devprof

    P, api = _count_api()
    was = devprof.ENABLED
    devprof.enable()
    devprof.reset()
    reg = api.enable_tenants(registry=P.MetricsRegistry())
    try:
        for t in ("alpha", "bravo"):
            with P.tenant_scope(t):
                api.query("i", "Count(Row(f=1))")
                api.query("i", "TopN(f, n=2)")
        stats = devprof.stats_json()
        prof_s = sum(k["device_seconds"] for k in stats["kernels"]) + \
            stats["other"]["device_seconds"]
        rows = reg.stats_json()["tenants"]
        ten_s = rows["alpha"]["device_seconds"] + \
            rows["bravo"]["device_seconds"]
        assert ten_s > 0
        assert ten_s == pytest.approx(prof_s, rel=1e-3, abs=1e-5)
    finally:
        api.disable_tenants()
        if not was:
            devprof.disable()
        devprof.reset()
