"""The tenants-and-degradation slice end to end, through both packages.

Each test builds a 3-node, 2-replica ``LocalCluster`` of each package
(the port's on the CPU), drives it over real HTTP with ``X-Tenant``, and
holds the answers, the status codes, the ``Retry-After`` hints and the
``/internal/tenants`` and ``/internal/degrade`` payloads of the two
packages equal. A tenant's ``device_seconds`` is each package's own
clock, so it is compared only as present, and so is ``dropped``, the
charges that landed in the overflow cell: the JAX package charges a
device dispatch, the port a kernel launch, and the two counts differ.

* ``bench.py`` config 18 small (``bench.py:1539-1745``): 3,000 records of
  ``city`` (50 rows) and ``device`` (8 rows) from seed 18 under
  ``FaultPlan(seed=18)``'s 2 ms query delays on node1 / node2; the
  three-query suite with the plane off (the oracle, numpy's counts, and
  no tenant scope entered), with the plane on for ``alpha`` / ``bravo``
  / ``charlie``, and again after ``mallory`` (capped at 5 qps and 400
  rows/s, on a clock that does not move, so every 429 is the same in
  both packages) has spent its quotas on imports, erroring queries and
  reads. ``mallory`` alone burns its SLO error budget (the health
  plane holds error objectives only, so the burn does not depend on
  either package's speed), and the coordinator's flight recorder holds
  a ``tenant_burn`` bundle.
* ``bench.py`` config 22's ladder on a virtual clock
  (``bench.py:2353-2830``): 2,000 records of ``f`` (40 rows) and ``g``
  (200 rows) over columns below 2^22 from seed 22; schedulers
  (``max_queue=32``), caches, tenants and the health plane (100 ms
  samples, a 5 s fast window, error objectives only, so the burn does
  not depend on either package's speed) on one ``ManualClock``, the
  ladder at ``bench.py``'s thresholds. ``OpenLoopDriver.run_virtual``
  sends a seeded mix of reads, SQL counts and imports from 100,000
  ``SyntheticTenants``; an error storm in the middle drives the fast
  burn up, the ladder sheds batch work strictly before interactive work,
  passes an intermediate level before SATURATED, serves a stale-tagged
  read in brownout, and, once the storm ages out of the window, steps
  back to NORMAL. Every outcome, level and stale flag is the JAX
  package's, and every acknowledged write reads back.
"""

import importlib
import json
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

JAX, TORCH = "pilosa_tpu", "pilosa_tpu_torch"


def _load(root: str) -> types.SimpleNamespace:
    m = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    kw = {"device": "cpu"} if root == TORCH else {}
    harness = m("cluster.harness")
    lg = m("loadgen")
    return types.SimpleNamespace(
        root=root,
        LocalCluster=lambda *a, **k: harness.LocalCluster(*a, **{**kw, **k}),
        FaultPlan=m("cluster.resilience").FaultPlan,
        T=m("obs.tenants"),
        Objective=m("obs.slo").Objective,
        ManualClock=m("sched").ManualClock,
        OpenLoopDriver=lg.OpenLoopDriver,
        ScenarioMix=lg.ScenarioMix,
        SyntheticTenants=lg.SyntheticTenants,
        KIND_INTERACTIVE=lg.KIND_INTERACTIVE,
        KIND_SQL=lg.KIND_SQL,
        KIND_BULK_IMPORT=lg.KIND_BULK_IMPORT,
    )


_PACKAGES = {}


def _pkg(root):
    if root not in _PACKAGES:
        _PACKAGES[root] = _load(root)
    return _PACKAGES[root]


def _req(uri, path, data=None, tenant=None, ctype=None):
    r = urllib.request.Request(uri + path, data=data)
    if tenant is not None:
        r.add_header("X-Tenant", tenant)
    if ctype is not None:
        r.add_header("Content-Type", ctype)
    try:
        with urllib.request.urlopen(r, timeout=60) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}"), dict(e.headers)


def _error_objectives(P) -> list:
    return [P.Objective("query-errors", "query", "errors", 0.999),
            P.Objective("sql-errors", "sql", "errors", 0.999)]


def _masked_tenants(body: dict) -> dict:
    """``/internal/tenants`` with each tenant's device seconds reduced to
    whether the package charged any, and the overflow charges to whether
    there were any."""
    out = json.loads(json.dumps(body))
    if "dropped" in out:
        out["dropped"] = out["dropped"] > 0
    for row in out.get("tenants", {}).values():
        row["device_seconds"] = row["device_seconds"] >= 0.0
    return out


# -- bench.py config 18, small ------------------------------------------------


C18_N = 3000
C18_SUITE = ("GroupBy(Rows(city), Rows(device), limit=100)",
             "Count(Intersect(Row(city=7), Row(device=3)))",
             "TopN(city, n=5)")
C18_WB = ("alpha", "bravo", "charlie")


def _numpy_c18(city, dev) -> list:
    pairs = np.zeros((50, 8), dtype=np.int64)
    np.add.at(pairs, (city, dev), 1)
    groups = [{"group": [{"field": "city", "rowID": int(a)},
                         {"field": "device", "rowID": int(b)}],
               "count": int(pairs[a, b])}
              for a in range(50) for b in range(8) if pairs[a, b]][:100]
    counts = np.bincount(city, minlength=50)
    top = sorted(range(50), key=lambda r: (-counts[r], r))[:5]
    return [groups, int(((city == 7) & (dev == 3)).sum()),
            [(r, int(counts[r])) for r in top]]


def _shape_c18(results) -> list:
    gb, cnt, top = results
    groups = [{"group": [{"field": g["field"], "rowID": g["rowID"]}
                         for g in e["group"]], "count": e["count"]}
              for e in gb[0]]
    return [groups, cnt[0], [(p["id"], p["count"]) for p in top[0]["rows"]]]


def _config18(P, tmp_path) -> dict:
    rng = np.random.default_rng(18)
    city = rng.integers(0, 50, C18_N)
    dev = rng.integers(0, 8, C18_N)
    plan = (P.FaultPlan(seed=18)
            .delay("node1", 0.002, prob=0.2, op="query")
            .delay("node2", 0.002, prob=0.2, op="query"))
    out = {}
    with P.LocalCluster(3, replica_n=2, base_path=str(tmp_path / P.root),
                        fault_plan=plan) as c:
        co = c.coordinator
        uri = co.node.uri

        def suite(tenant):
            res = []
            for q in C18_SUITE:
                for _ in range(2):
                    st, body, _ = _req(uri, "/index/mt/query", q.encode(),
                                       tenant)
                    assert st == 200, body
                res.append(body["results"])
            return res

        co.create_index("mt")
        co.create_field("mt", "city", {"type": "set"})
        co.create_field("mt", "device", {"type": "set"})
        cols = list(range(C18_N))
        co.import_bits("mt", "city", rows=city.tolist(), cols=cols)
        co.import_bits("mt", "device", rows=dev.tolist(), cols=cols)

        scope0 = P.T.SCOPE_COUNT
        assert co.tenants is None
        oracle = suite(None)
        assert P.T.SCOPE_COUNT == scope0
        assert _shape_c18(oracle) == _numpy_c18(city, dev)
        st, body, _ = _req(uri, "/internal/tenants")
        assert (st, body) == (200, {"enabled": False})

        clock = P.ManualClock()
        regs = c.enable_tenants(clock=lambda: 0.0)
        # error objectives only: a loaded CPU host would burn the latency
        # budgets of every tenant alike
        c.enable_health(clock=clock, objectives=_error_objectives(P))
        for node in c.nodes:
            node.enable_scheduler()
        regs[0].set_quota("mallory", qps=5.0, ingest_rows_s=400.0)
        for t in C18_WB:
            assert suite(t) == oracle, t

        co.create_index("abuse")
        co.create_field("abuse", "f", {"type": "set"})
        imp = json.dumps({"field": "f", "rows": [1] * 200,
                          "cols": list(range(200))}).encode()
        codes = []
        for k in range(1, 25):
            if k % 4 == 0:
                st, body, h = _req(uri, "/index/abuse/import", imp,
                                   "mallory", "application/json")
            elif k % 3 == 0:
                st, body, h = _req(uri, "/index/abuse/query",
                                   b"Row(missing=1)", "mallory")
            else:
                st, body, h = _req(uri, "/index/abuse/query", b"Row(f=1)",
                                   "mallory")
            codes.append((st, h.get("Retry-After")))
        for t in C18_WB:
            assert suite(t) == oracle, t
        co.health.timeline.sample()

        st, tj, _ = _req(uri, "/internal/tenants")
        assert st == 200 and tj["enabled"]
        assert set(C18_WB) | {"mallory"} <= set(tj["tenants"])
        for t in C18_WB:
            assert tj["tenants"][t]["device_seconds"] > 0, t
        assert tj["tenants"]["mallory"]["rejected"] > 0
        burn = co.health.slo.tenant_burn_rates()
        alerting = {r["tenant"] for r in burn if r["alerting"]}
        assert alerting == {"mallory"}, burn
        with urllib.request.urlopen(uri + "/metrics", timeout=30) as resp:
            prom = resp.read().decode()
        assert "slo_burn_rate{" in prom and 'tenant="mallory"' in prom
        triggers = [b["trigger"] for b in co.health.flight.summaries()]
        assert "tenant_burn" in triggers
        st, dj, _ = _req(uri, "/internal/degrade")
        out.update(oracle=oracle, codes=codes,
                   tenants=_masked_tenants(tj), degrade=(st, dj),
                   alerting=sorted(alerting))
    return out


def test_config18_battery_equal_across_packages(tmp_path):
    jax, torch = (_config18(_pkg(r), tmp_path) for r in (JAX, TORCH))
    assert [c for c, _ in torch["codes"]].count(429) > 0
    assert all(ra is not None for c, ra in torch["codes"] if c == 429)
    for key in ("oracle", "codes", "tenants", "degrade", "alerting"):
        assert torch[key] == jax[key], key


# -- bench.py config 22's ladder on a virtual clock ---------------------------


C22_N = 2000
C22_RATE = 20.0
C22_SECONDS = 12.0
#: the error storm: intended times in [STORM_T0, STORM_T1) read a field
#: that does not exist, one read in ``_storm_every(t)``
STORM_T0, STORM_T1 = 3.0, 7.0


def _storm_every(t: float) -> int:
    """Every how many interactive reads one errs: rising through the
    storm, so the burn climbs through the ladder's edges."""
    return 1 + max(0, int((STORM_T1 - t) * 2))


def _config22(P) -> dict:
    rng = np.random.default_rng(22)
    rows = rng.integers(0, 40, C22_N)
    cols = rng.integers(0, 1 << 22, C22_N)
    g_rows = rng.integers(0, 200, C22_N)
    clock = P.ManualClock()
    objectives = _error_objectives(P)
    out = {"ops": []}
    with P.LocalCluster(3, replica_n=2) as c:
        co = c.coordinator
        uri = co.node.uri
        co.create_index("soak")
        co.create_field("soak", "f", {"type": "set"})
        co.create_field("soak", "g", {"type": "set"})
        co.import_bits("soak", "f", rows=rows.tolist(), cols=cols.tolist())
        co.import_bits("soak", "g", rows=g_rows.tolist(),
                       cols=cols.tolist())
        oracle = {r: set() for r in range(40)}
        for r, cc in zip(rows.tolist(), cols.tolist()):
            oracle[r].add(cc)
        c.enable_tenants(clock=clock.now)
        for node in c.nodes:
            node.enable_scheduler(max_queue=32, adaptive_window=True)
            node.enable_cache()
        c.enable_health(interval_ms=100, slo_fast_window_s=5.0,
                        clock=clock, objectives=objectives)
        st, body, _ = _req(uri, "/internal/degrade")
        assert (st, body) == (200, {"enabled": False})
        c.enable_degrade(
            queue_shed=0.30, queue_brownout=0.55, queue_saturate=0.80,
            burn_shed=60.0, burn_brownout=90.0, burn_saturate=130.0,
            miss_rate_brownout=1e9, eviction_rate_shed=1e9,
            exit_ratio=0.6, up_hold=1, down_hold=2, min_dwell_s=0.25)
        deg = co.degrade

        def execute(op):
            i = op.op_id
            if op.kind == P.KIND_BULK_IMPORT:
                row, col = i % 40, 4_200_000 + i
                st, body, h = _req(
                    uri, "/index/soak/import",
                    json.dumps({"field": "f", "rows": [row],
                                "cols": [col]}).encode(), op.tenant)
                if st == 200:
                    oracle[row].add(col)
            elif op.kind == P.KIND_SQL:
                st, body, h = _req(uri, "/sql", b"SELECT COUNT(*) FROM soak",
                                   op.tenant)
            else:
                storm = STORM_T0 <= op.intended_t < STORM_T1 \
                    and i % _storm_every(op.intended_t) == 0
                q = "Count(Row(nosuch=1))" if storm else \
                    f"Count(Row(f={i % 40}))"
                st, body, h = _req(uri, "/index/soak/query", q.encode(),
                                   op.tenant)
            stale = bool(body.get("stale")) if st == 200 else False
            out["ops"].append((i, op.kind, op.tenant, st,
                               h.get("Retry-After") if st == 429 else None,
                               str(body.get("error", ""))[:40], stale,
                               deg.level))
            if st == 200:
                return {"outcome": "ok", "stale": stale}
            return "shed" if st == 429 else "error"

        mix = P.ScenarioMix({P.KIND_INTERACTIVE: 0.6, P.KIND_SQL: 0.2,
                             P.KIND_BULK_IMPORT: 0.2})
        d = P.OpenLoopDriver(execute, rate_per_s=C22_RATE,
                             duration_s=C22_SECONDS, mix=mix,
                             tenants=P.SyntheticTenants(100_000, seed=22),
                             seed=22, arrivals="poisson")
        rep = d.run_virtual(clock)
        # the load has stopped: the storm ages out of the fast window and
        # the ladder steps down a rung at a time
        levels = []
        for _ in range(60):
            clock.advance(0.25)
            co.health.timeline.sample()
            levels.append(deg.level)
        for row in range(40):
            st, body, _ = _req(uri, "/index/soak/query",
                               f"Row(f={row})".encode())
            assert st == 200 and not body.get("stale"), body
            assert set(body["results"][0]["columns"]) == oracle[row], row
        st, tj, _ = _req(uri, "/internal/tenants")
        st2, dj, _ = _req(uri, "/internal/degrade")
        assert st == st2 == 200
        out.update(report=(rep.ok, rep.shed, rep.errors, rep.stale,
                           rep.total), recovery=levels,
                   tenants=_masked_tenants(tj), degrade=dj)
    return out


def test_config22_ladder_equal_across_packages():
    jax, torch = (_config22(_pkg(r)) for r in (JAX, TORCH))
    ops = torch["ops"]
    lv = [o[-1] for o in ops]
    assert max(lv) == 3, lv
    t_sat = lv.index(3)
    assert any(v in (1, 2) for v in lv[:t_sat]), lv
    shed = [(n, o[5]) for n, o in enumerate(ops) if o[3] == 429]
    assert all(o[4] is not None for o in ops if o[3] == 429)
    first = {}
    for n, err in shed:
        if "degrade" in err:
            first.setdefault("batch" if "batch" in err else "interactive", n)
    assert first["batch"] < first["interactive"], first
    assert any(o[6] for o in ops), "no stale-tagged read in brownout"
    assert torch["recovery"][-1] == 0 and torch["degrade"]["level"] == 0
    assert torch["degrade"]["transitions"] >= 2
    for key in ("ops", "report", "recovery", "tenants", "degrade"):
        assert torch[key] == jax[key], key
