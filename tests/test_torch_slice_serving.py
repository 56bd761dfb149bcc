"""The serving layer end to end against the JAX package, on the CPU.

Through ``pilosa_tpu.api.API`` and ``pilosa_tpu_torch.api.API(device=
"cpu")`` on the same seeded data (a few shards, narrow row counts):

* the ``tests/test_fusion.py`` battery: every family under per-query
  shard masks (``execute_many(per_query_shards=...)``) equal to the same
  query run alone on its own shards and to the JAX package's fused
  answer; empty subsets, unmaskable queries keeping their own shards, the
  length-mismatch error, exact per-query cache entries from a superset
  run, and a cached superset round as one dispatch;
* ``execute_many`` against ``execute`` for each query, and the
  scheduler's batched and concurrent answers against sequential ones
  (``TestParityWithSequential`` of ``tests/test_sched.py``), over both
  APIs;
* configs 6, 7 and 8 of ``bench.py`` at a small size with the scheduler
  and the cache on, every answer equal to numpy and to the JAX API;
* ``Executor(remote=True)`` on every call that reads it, equal to the
  JAX package's;
* writes between cached reads: no stale hit;
* a threaded wave of reads and writes under ``locktrace.enable()``: the
  scheduler, cache, holder and stack locks are taken in one order.

Tolerance 0: every answer is a bitmap, a count or a host-decoded value.
Threads hand over through futures with timeouts; no test reads a clock.
"""

import dataclasses
import random
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from pilosa_tpu.api import API as JaxAPI
from pilosa_tpu.pql import executor as jexec
from pilosa_tpu_torch.api import API as TorchAPI
from pilosa_tpu_torch.obs.metrics import MetricsRegistry
from pilosa_tpu_torch.pql import executor as texec
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

SW = SHARD_WIDTH
N_SHARDS = 4
TIMEOUT = 60


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The plain versions' small ops on one thread: under a parallel test
    run every worker's intra-op pool contends for the same cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def plain(r):
    if dataclasses.is_dataclass(r):
        return dataclasses.asdict(r)
    if isinstance(r, list):
        return [plain(x) for x in r]
    return r


def _both(build):
    return build(JaxAPI()), build(TorchAPI(device="cpu"))


# -- the fusion battery (tests/test_fusion.py) ------------------------------


def _fusion_data(api):
    """4 shards of set + BSI data (negatives included), as
    tests/test_fusion.py builds it at 8."""
    api.create_index("fz")
    api.create_field("fz", "city")
    api.create_field("fz", "device")
    api.create_field("fz", "amt", {"type": "int", "min": -100, "max": 200})
    rng = random.Random(1234)
    cols, cities, devices, vals = [], [], [], []
    for shard in range(N_SHARDS):
        for i in rng.sample(range(600), 80):
            cols.append(shard * SW + i)
            cities.append((i + shard) % 5)
            devices.append(i % 3)
            vals.append(rng.randrange(-60, 120))
    api.import_bits("fz", "city", rows=cities, cols=cols)
    api.import_bits("fz", "device", rows=devices, cols=cols)
    api.import_values("fz", "amt", cols=cols, values=vals)
    return api


@pytest.fixture(scope="module")
def fusion_apis():
    return _both(_fusion_data)


FAMILY_QUERIES = [
    "Count(Row(city=1))",
    "Count(Intersect(Row(city=0), Row(device=1)))",
    "Count(Row(amt > 10))",
    "Row(city=2)",
    "Union(Row(city=0), Row(city=3))",
    "Difference(Row(city=1), Row(device=0))",
    "Xor(Row(city=1), Row(city=2))",
    "Not(Row(city=1))",
    "Shift(Row(city=4), n=2)",
    "UnionRows(Rows(city, limit=3))",
    "Limit(Row(city=0), limit=7, offset=2)",
    "Sum(Row(city=1), field=amt)",
    "Sum(field=amt)",
    "Min(field=amt)",
    "Max(Row(device=2), field=amt)",
    "Percentile(field=amt, nth=50)",
    "TopN(city, n=3)",
    "TopK(device, k=2)",
    "Rows(city)",
    "Rows(city, limit=2)",
    "Rows(city, column=5)",
    "GroupBy(Rows(city))",
    "GroupBy(Rows(city), Rows(device), aggregate=Sum(field=amt))",
    "GroupBy(Rows(city), Rows(device), filter=Row(amt > 0), limit=4)",
    "Distinct(field=city)",
    "Count(Distinct(field=amt))",
    "Distinct(Row(city=1), field=amt)",
]

# a pair, one shard, interleaved, all
SUBSETS = [[0, 1], [2], [1, 3], list(range(N_SHARDS))]


def _solo(api, query, shards):
    return plain(api.executor.execute("fz", query, shards=shards))


class TestMaskedSupersetParity:
    @pytest.mark.parametrize("query", FAMILY_QUERIES)
    def test_each_family_equal_to_solo_and_to_jax(self, fusion_apis, query):
        japi, tapi = fusion_apis
        queries = [query] * len(SUBSETS)
        got = tapi.executor.execute_many("fz", queries,
                                         per_query_shards=SUBSETS)
        want = japi.executor.execute_many("fz", queries,
                                          per_query_shards=SUBSETS)
        assert plain(got) == plain(want)
        for shards, res in zip(SUBSETS, got):
            assert plain(res) == _solo(tapi, query, shards), shards

    def test_mixed_families_one_fused_round(self, fusion_apis):
        japi, tapi = fusion_apis
        rng = random.Random(99)
        queries, subsets = [], []
        for _ in range(16):
            queries.append(rng.choice(FAMILY_QUERIES))
            subsets.append(sorted(rng.sample(range(N_SHARDS), 2)))
        got = tapi.executor.execute_many("fz", queries,
                                         per_query_shards=subsets)
        assert plain(got) == plain(japi.executor.execute_many(
            "fz", queries, per_query_shards=subsets))
        for q, s, res in zip(queries, subsets, got):
            assert plain(res) == _solo(tapi, q, s)

    def test_empty_subset_matches_solo(self, fusion_apis):
        _, tapi = fusion_apis
        q = "Count(Row(city=1))"
        fused = tapi.executor.execute_many("fz", [q, q],
                                           per_query_shards=[[], [0, 1]])
        assert fused == [_solo(tapi, q, []), _solo(tapi, q, [0, 1])]

    def test_unmaskable_query_keeps_own_shards(self, fusion_apis):
        japi, tapi = fusion_apis
        q_scan = "Extract(Row(city=1), Rows(device))"
        q_count = "Count(Row(city=1))"
        args = ("fz", [q_scan, q_count])
        kw = {"per_query_shards": [[2, 3], [0, 1]]}
        fused = tapi.executor.execute_many(*args, **kw)
        assert plain(fused[0]) == _solo(tapi, q_scan, [2, 3])
        assert fused[1] == _solo(tapi, q_count, [0, 1])
        assert plain(fused) == plain(japi.executor.execute_many(*args, **kw))

    def test_masked_call_outside_the_plan_is_refused(self, fusion_apis):
        _, tapi = fusion_apis
        ex = tapi.executor
        idx = tapi.holder.index("fz")
        mask = texec.ShardMask([0, 1], {0}, idx.device)
        for pql in ("Options(Count(Row(city=1)), shards=[0])",
                    "Extract(Row(city=1), Rows(device))"):
            call = texec.parse(pql).calls[0]
            with pytest.raises(texec.PQLError, match="shard mask"):
                ex._execute_call(idx, call, [0, 1], mask)

    def test_per_query_shards_length_mismatch_rejected(self, fusion_apis):
        for api in fusion_apis:
            with pytest.raises(ValueError):
                api.executor.execute_many("fz", ["Count(Row(city=1))"],
                                          per_query_shards=[[0], [1]])

    def test_mask_planes_are_shared_and_cached(self, fusion_apis):
        _, tapi = fusion_apis
        idx = tapi.holder.index("fz")
        a = texec.ShardMask([0, 1, 2], {0, 2}, idx.device)
        b = texec.ShardMask([0, 1, 2], {2, 0}, idx.device)
        assert a.plane is b.plane
        assert texec.mask_plane_bytes() >= 3 * SW // 8


class TestFusedCacheFill:
    @pytest.mark.parametrize("which", [0, 1], ids=["jax", "torch"])
    def test_superset_run_fills_exact_per_query_entries(self, fusion_apis,
                                                        which):
        api = fusion_apis[which]
        api.enable_cache()
        try:
            cache = api.cache
            q = "Count(Row(city=3))"
            fused = api.executor.execute_many(
                "fz", [q, q], per_query_shards=[[0, 1], [2, 3]])
            h0 = cache.stats()["hits"]
            assert api.executor.execute("fz", q, shards=[0, 1]) == fused[0]
            assert api.executor.execute("fz", q, shards=[2, 3]) == fused[1]
            assert cache.stats()["hits"] == h0 + 2
            api.executor.execute("fz", q, shards=[0, 1, 2, 3])
            assert cache.stats()["hits"] == h0 + 2
        finally:
            api.disable_cache()

    @pytest.mark.parametrize("which", [0, 1], ids=["jax", "torch"])
    def test_cached_superset_round_is_one_dispatch(self, fusion_apis, which):
        api = fusion_apis[which]
        sets = ([0, 1], [1, 2], [2, 3], [0, 3])
        api.enable_cache()
        try:
            reg = type(api.executor.cache.registry)()
            sched = api.enable_scheduler(window_ms=0, max_batch=64,
                                         fuse_waste_ratio=8.0, registry=reg)
            sched.pause()
            handles = [sched.submit("fz", f"Count(Row(city={k}))", shards=s)
                       for k, s in enumerate(sets)]
            assert sched.wait_queued(4) == 4
            sched.resume()
            got = [h.result(timeout=TIMEOUT)[0] for h in handles]
            want = [api.executor.execute(
                "fz", f"Count(Row(city={k}))", shards=s)[0]
                for k, s in enumerate(sets)]
            assert got == want
            counters = reg.as_json()["counters"]
            assert sum(v for k, v in counters.items()
                       if k.startswith("sched_batches_total")) == 1
            assert sum(v for k, v in counters.items()
                       if k.startswith("sched_superset_merges_total")) == 3
        finally:
            api.disable_scheduler()
            api.disable_cache()


# -- parity with sequential execution (tests/test_sched.py) -----------------


def _mixed_queries():
    return (["Count(Intersect(Row(city=%d), Row(device=%d)))" % (k % 5, k % 3)
             for k in range(8)]
            + ["Row(city=%d)" % (k % 5) for k in range(4)]
            + ["Intersect(Row(city=1), Row(device=2))",
               "Union(Row(city=0), Row(city=3))",
               "Count(Row(device=1))", "TopN(city, n=2)"])


def _parity_data(api):
    api.create_index("p")
    api.create_field("p", "city")
    api.create_field("p", "device")
    cols = list(range(300))
    api.import_bits("p", "city", rows=[c % 5 for c in cols], cols=cols)
    api.import_bits("p", "device", rows=[c % 3 for c in cols], cols=cols)
    return api


@pytest.fixture(scope="module")
def parity_apis():
    return _both(_parity_data)


@pytest.fixture(params=[0, 1], ids=["jax", "torch"])
def parity_api(request, parity_apis):
    return parity_apis[request.param]


class TestParityWithSequential:
    def test_batched_results_identical(self, parity_api, parity_apis):
        api = parity_api
        queries = _mixed_queries()
        want = [plain(parity_apis[0].query("p", q)[0]) for q in queries]
        sched = api.enable_scheduler(window_ms=0, max_batch=64)
        try:
            sched.pause()
            handles = [sched.submit("p", q) for q in queries]
            assert sched.wait_queued(len(queries)) == len(queries)
            sched.resume()
            got = [plain(h.result(timeout=TIMEOUT)[0]) for h in handles]
        finally:
            api.disable_scheduler()
        assert got == want

    def test_concurrent_api_query_parity(self, parity_api, parity_apis):
        api = parity_api
        queries = _mixed_queries()
        want = [plain(parity_apis[0].query("p", q)[0]) for q in queries]
        api.enable_scheduler(window_ms=1.0, max_batch=64)
        try:
            with ThreadPoolExecutor(len(queries)) as pool:
                futs = [pool.submit(api.query, "p", q) for q in queries]
                got = [plain(f.result(timeout=TIMEOUT)[0]) for f in futs]
        finally:
            api.disable_scheduler()
        assert got == want

    def test_execute_many_matches_execute(self, parity_api):
        api = parity_api
        queries = _mixed_queries()
        want = [plain(api.executor.execute("p", q)) for q in queries]
        many = api.executor.execute_many("p", queries)
        assert [plain(rq) for rq in many] == want
        with pytest.raises(ValueError):
            api.executor.execute_many("p", ["Set(1, city=1)"])

    def test_scheduled_options_and_priorities(self, parity_api):
        api = parity_api
        want = api.query("p", "Count(Row(city=1))")
        api.enable_scheduler(window_ms=0)
        try:
            assert api.query("p", "Count(Row(city=1))", priority="batch",
                             deadline_ms=60_000) == want
            assert type(api.read_executor()).__name__ == "SchedulingExecutor"
        finally:
            api.disable_scheduler()
        assert api.read_executor() is api.executor and api.scheduler is None


def test_query_counts_and_traces(parity_apis):
    from pilosa_tpu_torch.obs import metrics as M
    from pilosa_tpu_torch.obs import tracing as T

    _, tapi = parity_apis
    prev = T.get_tracer()
    reg = MetricsRegistry()
    T.set_tracer(T.Tracer(enabled=True, store=T.TraceStore(8, registry=reg),
                          registry=reg))
    try:
        before = M.REGISTRY.value(M.METRIC_PQL_QUERIES)
        tapi.enable_scheduler(window_ms=0)
        try:
            tapi.query("p", "Count(Row(city=2))")
        finally:
            tapi.disable_scheduler()
        assert M.REGISTRY.value(M.METRIC_PQL_QUERIES) == before + 1
        (summary,) = T.get_tracer().store.list()
        assert summary["root"] == "query.pql"
        spans = T.get_tracer().store.get(summary["traceID"])["spans"]
        names = [c["name"] for c in spans["children"]]
        assert "sched.queue_wait" in names
    finally:
        T.set_tracer(prev)


# -- bench.py configs 6, 7 and 8 at a small size ----------------------------


def _config67(seed, n):
    rng = np.random.default_rng(seed)
    city = rng.integers(0, 50, n)
    dev = rng.integers(0, 10, n)

    def build(api):
        api.create_index("c")
        api.create_field("c", "city")
        api.create_field("c", "device")
        cols = np.arange(n)
        api.import_bits("c", "city", rows=city, cols=cols)
        api.import_bits("c", "device", rows=dev, cols=cols)
        return api

    return _both(build), city, dev


def test_config6_scheduler_on_equals_off_and_numpy():
    (japi, tapi), city, dev = _config67(6, 20_000)
    queries = [f"Count(Intersect(Row(city={i % 50}), Row(device={i % 10})))"
               for i in range(64)]
    want = [int(np.sum((city == i % 50) & (dev == i % 10)))
            for i in range(64)]
    assert [tapi.query("c", q)[0] for q in queries] == want
    assert [japi.query("c", q)[0] for q in queries] == want
    reg = MetricsRegistry()
    tapi.enable_scheduler(window_ms=2.0, max_batch=64, registry=reg)
    tapi.enable_cache(registry=MetricsRegistry())
    try:
        with ThreadPoolExecutor(64) as pool:
            futs = [pool.submit(tapi.query, "c", q) for q in queries]
            assert [f.result(timeout=TIMEOUT)[0] for f in futs] == want
    finally:
        tapi.disable_scheduler()
        tapi.disable_cache()
    batches = sum(v for k, v in reg.as_json()["counters"].items()
                  if k.startswith("sched_batches_total"))
    assert 1 <= batches <= 64


def test_config7_cache_phases_equal_numpy():
    (japi, tapi), city, dev = _config67(7, 20_000)
    n = city.size
    q = "Count(Intersect(Row(city=3), Row(device=7)))"
    want = int(np.sum((city == 3) & (dev == 7)))
    for api in (japi, tapi):
        assert api.query("c", q) == [want]
    reg = MetricsRegistry()
    cache = tapi.enable_cache(registry=reg)
    jcache = japi.enable_cache()
    try:
        for _ in range(3):  # cold
            cache.flush()
            assert tapi.query("c", q) == [want]
        misses = cache.stats()["misses"]
        for _ in range(5):  # warm
            assert tapi.query("c", q) == [want]
        assert cache.stats()["misses"] == misses
        assert cache.stats()["hits"] >= 5
        exp = want
        for i in range(5):  # write-invalidated
            for api in (japi, tapi):
                api.query("c", f"Set({n + i}, city=3)Set({n + i}, device=7)")
            exp += 1
            before = cache.stats()["misses"]
            assert tapi.query("c", q) == [exp]
            assert japi.query("c", q) == [exp]
            assert cache.stats()["misses"] == before + 1
        assert jcache.stats()["hits"] >= 0
    finally:
        tapi.disable_cache()
        japi.disable_cache()


def test_config8_fused_waves_equal_numpy_and_jax():
    rng = np.random.default_rng(8)
    n_shards, per_shard = 8, 2_000
    city_by, dev_by = [], []
    for _ in range(n_shards):
        city_by.append(rng.integers(0, 50, per_shard))
        dev_by.append(rng.integers(0, 10, per_shard))

    def build(api):
        api.create_index("c8")
        api.create_field("c8", "city")
        api.create_field("c8", "device")
        for shard in range(n_shards):
            cols = shard * SW + np.arange(per_shard)
            api.import_bits("c8", "city", rows=city_by[shard], cols=cols)
            api.import_bits("c8", "device", rows=dev_by[shard], cols=cols)
        return api

    japi, tapi = _both(build)
    nq = 32
    subsets = [sorted(rng.choice(n_shards, size=4, replace=False).tolist())
               for _ in range(nq)]
    queries = [f"Count(Intersect(Row(city={i % 50}), Row(device={i % 10})))"
               for i in range(nq)]
    want = [int(sum(np.sum((city_by[s] == i % 50) & (dev_by[s] == i % 10))
                    for s in subsets[i])) for i in range(nq)]
    assert [r[0] for r in japi.executor.execute_many(
        "c8", queries, per_query_shards=subsets)] == want
    dispatches = {}
    for ratio in (0.0, 2.0):
        reg = MetricsRegistry()
        sched = tapi.enable_scheduler(window_ms=0, max_batch=nq,
                                      fuse_waste_ratio=ratio, registry=reg)
        try:
            sched.pause()
            handles = [sched.submit("c8", q, shards=s)
                       for q, s in zip(queries, subsets)]
            assert sched.wait_queued(nq) == nq
            sched.resume()
            assert [h.result(timeout=TIMEOUT)[0] for h in handles] == want
        finally:
            tapi.disable_scheduler()
        dispatches[ratio] = sum(
            v for k, v in reg.as_json()["counters"].items()
            if k.startswith("sched_batches_total"))
    assert dispatches[2.0] < dispatches[0.0]
    assert dispatches[2.0] <= 2


# -- remote=True -------------------------------------------------------------


def _remote_data(api):
    api.create_index("k", {"keys": True})
    api.create_field("k", "city", {"keys": True})
    api.create_field("k", "n")
    api.create_field("k", "v", {"type": "int", "min": -50, "max": 50})
    rng = np.random.default_rng(11)
    keys = [f"r{i}" for i in range(40)]
    cols = [keys[i % 40] for i in range(120)]
    api.import_bits("k", "city", col_keys=cols,
                    row_keys=[f"c{int(x)}" for x in rng.integers(0, 6, 120)])
    api.import_bits("k", "n", col_keys=cols,
                    rows=[int(x) for x in rng.integers(0, 4, 120)])
    api.import_values("k", "v", col_keys=keys,
                      values=[int(x) for x in rng.integers(-50, 50, 40)])
    return api


REMOTE_QUERIES = [
    'Row(city="c1")',
    'Limit(Row(city="c2"), limit=3, offset=1)',
    "TopN(city, n=2)",
    'TopN(n, Row(city="c3"), n=1)',
    "Rows(city, limit=2)",
    "Rows(n, limit=1)",
    "Distinct(field=city)",
    "Distinct(field=v)",
    "GroupBy(Rows(city), Rows(n), limit=3)",
    "GroupBy(Rows(city), limit=2)",
    'Extract(Row(city="c1"), Rows(city), Rows(v))',
    "Sort(field=v, limit=3)",
    'Count(Row(city="c4"))',
]


@pytest.fixture(scope="module")
def remote_apis():
    return _both(_remote_data)


@pytest.mark.parametrize("remote", [False, True])
@pytest.mark.parametrize("pql", REMOTE_QUERIES)
def test_remote_mode_equals_jax(remote_apis, pql, remote):
    japi, tapi = remote_apis
    jex = jexec.Executor(japi.holder, remote=remote)
    tex = texec.Executor(tapi.holder, remote=remote)
    assert plain(tex.execute("k", pql)) == plain(jex.execute("k", pql))


def test_remote_results_use_their_own_cache_namespace(remote_apis):
    _, tapi = remote_apis
    tex = texec.Executor(tapi.holder, remote=True)
    assert tex.cache_key("k", "TopN(city, n=1)")[0] == "remote"
    assert tapi.executor.cache_key("k", "TopN(city, n=1)")[0] == "local"
    assert tex.cache_key("k", 'Set("r1", city="c1")') is None


@pytest.mark.parametrize("which", [0, 1], ids=["jax", "torch"])
def test_tenant_namespaces_split_cache_entries(remote_apis, which):
    """``tenant_namespaces`` on: each tenant's reads key under its own
    namespace and miss each other's entries; out of a tenant scope the
    shared namespace comes back. Both packages name the namespaces
    alike."""
    import importlib

    api = remote_apis[which]
    root = ("pilosa_tpu", "pilosa_tpu_torch")[which]
    tenants = importlib.import_module(root + ".obs.tenants")
    metrics = importlib.import_module(root + ".obs.metrics")
    ex, q = api.executor, "Count(Row(city=1))"
    shared = ex.cache_key("k", q)
    api.enable_cache(registry=metrics.MetricsRegistry())
    ex.tenant_namespaces = True
    try:
        with tenants.tenant_scope("a"):
            ka = ex.cache_key("k", q)
            want = api.query("k", q)
            assert api.query("k", q) == want
        with tenants.tenant_scope("b"):
            kb = ex.cache_key("k", q)
            assert api.query("k", q) == want
        assert ex.cache_key("k", q) == shared
        assert (ka[0], kb[0], shared[0]) == ("local|a", "local|b", "local")
        assert ka[1:] == kb[1:] == shared[1:]
        stats = api.cache.stats()
        assert (stats["hits"], stats["misses"]) == (1, 2)
    finally:
        ex.tenant_namespaces = False
        api.disable_cache()


# -- writes between cached reads --------------------------------------------


def test_write_then_read_battery_has_no_stale_hit():
    """Random Set / Clear / value writes over two shards, each followed
    by every read twice (the second a hit): every answer equals the
    oracle of the writes so far."""
    rng = np.random.default_rng(21)
    api = TorchAPI(device="cpu")
    api.create_index("w")
    api.create_field("w", "f")
    api.create_field("w", "v", {"type": "int", "min": -1000, "max": 1000})
    cache = api.enable_cache(registry=MetricsRegistry())
    bits, vals = set(), {}

    def oracle():
        rows = [{c for r, c in bits if r == k} for k in range(4)]
        top = sorted(((k, len(rows[k])) for k in range(4) if rows[k]),
                     key=lambda kc: (-kc[1], kc[0]))[:3]
        return {
            "Count(Row(f=1))": len(rows[1]),
            "Count(Intersect(Row(f=1), Row(f=2)))": len(rows[1] & rows[2]),
            "TopN(f, n=3)": top,
            "Sum(field=v)": (sum(vals.values()), len(vals)),
            "Row(f=2)": sorted(rows[2]),
            "Count(Row(v > 10))": sum(1 for x in vals.values() if x > 10),
        }

    def answer(res):
        if hasattr(res, "pairs"):
            return [(p.id, p.count) for p in res.pairs]
        if hasattr(res, "columns"):
            return res.columns
        if hasattr(res, "val"):
            return (res.val, res.count)
        return res

    for step in range(24):
        kind = int(rng.integers(0, 3))
        col = int(rng.integers(0, 2 * SW))
        row = int(rng.integers(0, 4))
        if kind == 1 and bits:
            row, col = sorted(bits)[int(rng.integers(0, len(bits)))]
            api.query("w", f"Clear({col}, f={row})")
            bits.discard((row, col))
        elif kind == 2:
            x = int(rng.integers(-1000, 1000))
            api.query("w", f"Set({col}, v={x})")
            vals[col] = x
        else:
            api.query("w", f"Set({col}, f={row})")
            bits.add((row, col))
        for q, want in oracle().items():
            for _ in range(2):  # the second read of each is a hit
                assert answer(api.query("w", q)[0]) == want, (step, q)
    stats = cache.stats()
    assert stats["hits"] >= 24 * 6 and stats["misses"] <= 24 * 6


# -- lock order under a threaded wave ---------------------------------------


_LOCK_ORDER = ["sched.scheduler", "cache.result_cache", "core.holder.write",
               "core.stacked.stack"]


def test_threaded_wave_and_writes_keep_one_lock_order(monkeypatch):
    from pilosa_tpu_torch.analysis import locktrace
    from pilosa_tpu_torch.core import stacked

    # 24 rows page into blocks of 8, which build lazily under the
    # holder's write lock and their own lock
    monkeypatch.setattr(stacked, "_BLOCK_BYTES", 8 * 3 * SW // 8)
    reg = locktrace.enable()
    try:
        api = TorchAPI(device="cpu")
        api.create_index("l")
        api.create_field("l", "f")
        api.import_bits("l", "f", rows=[k % 24 for k in range(400)],
                        cols=[k * 7 + (k % 3) * SW for k in range(400)])
        api.enable_cache()
        api.enable_scheduler(window_ms=0.5, max_batch=16,
                             fuse_waste_ratio=2.0)

        def read(i):
            shards = [[0, 1], [1, 2], [0, 2], None][i % 4]
            return api.query("l", f"Count(Row(f={i % 24}))", shards=shards)

        def write(i):
            return api.query("l",
                             f"Set({SW * (i % 3) + 5000 + i}, f={i % 24})")

        with ThreadPoolExecutor(16) as pool:
            futs = [pool.submit(read if i % 3 else write, i)
                    for i in range(96)]
            for f in futs:
                f.result(timeout=TIMEOUT)
        api.disable_scheduler()
        want = api.executor.execute("l", "Count(Row(f=1))")
        api.disable_cache()
        assert api.query("l", "Count(Row(f=1))") == want
        assert reg.violations() == []
        edges = reg.report()["edges"]
        rank = {name: i for i, name in enumerate(_LOCK_ORDER)}
        for a, bs in edges.items():
            for b in bs:
                if a in rank and b in rank:
                    assert rank[a] < rank[b], f"{a} -> {b} inverts the order"
        assert "core.stacked.stack" in edges.get("core.holder.write", [])
    finally:
        locktrace.disable()
