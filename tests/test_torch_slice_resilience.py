"""The resilience slice end to end: ``bench.py`` configs 9 and 14 at a
small size through both packages' ``LocalCluster``.

Config 9 (``bench.py:614``): a 3-node, 2-replica cluster over 6 shards
of 8 rows, ``Count(Row(f=3))`` healthy, then under a ``FaultPlan`` delay
of one owner unhedged, then hedged (``hedge_min_ms=1``, breakers held
shut). Config 14 (``bench.py:1085``): the same cluster shape, 64
mixed-shard Counts released through a barrier in waves, unbatched and
then batched (``enable_cluster_batch``), then a chaos wave with every
batch RPC to one owner delayed and hedging on. Every answer equals
numpy's ``bincount`` and the other package's; the batched pass sends at
least 8x fewer node RPCs than the unbatched one and none on
``/internal/query``; a hedge wins under config 9's straggler. The port
runs with ``device="cpu"``.
"""

import importlib
import statistics
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

JAX, TORCH = "pilosa_tpu", "pilosa_tpu_torch"

#: records per shard (bench.py: 50,000 for config 9, 40,000 for 14)
C9_PER_SHARD = 2_000
C14_PER_SHARD = 2_000
ITERS = 5  # bench.py's max(QUERY_ITERS, 5) at its CPU scale
WAVES = 2  # bench.py runs 3; the RPC cut is a ratio per wave


def _mods(root):
    m = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    kw = {"device": "cpu"} if root == TORCH else {}
    cluster = m("cluster")
    return (lambda *a, **k: cluster.LocalCluster(*a, **{**kw, **k}),
            cluster.FaultPlan, m("obs.metrics").MetricsRegistry,
            m("shardwidth").SHARD_WIDTH)


def _counter(reg, prefix):
    return sum(v for k, v in reg.as_json()["counters"].items()
               if k.startswith(prefix))


def _config9(root):
    LocalCluster, FaultPlan, MetricsRegistry, SW = _mods(root)
    rng = np.random.default_rng(9)
    plan = FaultPlan(seed=9)
    out = {"answers": []}
    c = LocalCluster(3, replica_n=2, fault_plan=plan)
    try:
        co = c.coordinator
        co.create_index("c9")
        co.create_field("c9", "f")
        f_all = []
        for shard in range(6):
            rows = rng.integers(0, 8, C9_PER_SHARD)
            cols = shard * SW + np.arange(C9_PER_SHARD)
            co.import_bits("c9", "f", rows=rows.tolist(), cols=cols.tolist())
            f_all.append(rows)
        out["want"] = [int(np.bincount(np.concatenate(f_all),
                                       minlength=8)[3])]
        q = "Count(Row(f=3))"
        victim = next(n.node.id for n in c.nodes[1:]
                      if n.holder.index("c9").shards())

        def timed(phase):
            t0 = time.perf_counter()
            r = co.query("c9", q)
            out["answers"].append((phase, r))
            return time.perf_counter() - t0

        healthy = [timed("healthy") for _ in range(ITERS)]
        delay_s = min(max(10 * statistics.median(healthy), 0.25), 2.0)
        plan.delay(victim, delay_s)
        unhedged = [timed("unhedged") for _ in range(ITERS)]
        plan.clear()
        reg = MetricsRegistry()
        co.enable_resilience(registry=reg, hedge_min_ms=1.0,
                             breaker_threshold=1 << 30)
        for _ in range(ITERS):
            timed("warm")
        plan.delay(victim, delay_s)
        hedged = [timed("hedged") for _ in range(ITERS)]
        plan.clear()
        co.disable_resilience()
        out.update(delay_s=delay_s, unhedged=unhedged, hedged=hedged,
                   hedges=_counter(reg, "cluster_hedges_total"),
                   wins=_counter(reg, "cluster_hedge_wins_total"))
    finally:
        c.close()
    return out


def _config14(root):
    LocalCluster, FaultPlan, MetricsRegistry, SW = _mods(root)
    rng = np.random.default_rng(14)
    plan = FaultPlan(seed=14)  # unarmed until the chaos wave
    out = {"answers": []}
    c = LocalCluster(3, replica_n=2, fault_plan=plan)
    try:
        co = c.coordinator
        co.create_index("c14")
        co.create_field("c14", "f")
        row_counts = []
        for shard in range(6):
            rows = rng.integers(0, 8, C14_PER_SHARD)
            cols = shard * SW + np.arange(C14_PER_SHARD)
            co.import_bits("c14", "f", rows=rows.tolist(), cols=cols.tolist())
            row_counts.append(np.bincount(rows, minlength=8))
        queries = []
        for i in range(64):
            row = i % 8
            subset = sorted(int(s) for s in rng.choice(
                6, size=int(rng.integers(2, 6)), replace=False))
            want = int(sum(row_counts[s][row] for s in subset))
            queries.append((f"Count(Row(f={row}))", subset, want))
        out["queries"] = queries

        def run_wave(phase, batch):
            barrier = threading.Barrier(len(batch))

            def one(entry):
                pql, subset, _ = entry
                barrier.wait()
                return co.query("c14", pql, shards=subset)

            with ThreadPoolExecutor(max_workers=len(batch)) as pool:
                out["answers"].append((phase, list(pool.map(one, batch))))

        co.query("c14", queries[0][0], shards=queries[0][1])
        sent0 = dict(co.client.op_counts)
        for _ in range(WAVES):
            run_wave("unbatched", queries)
        out["solo_rpcs"] = co.client.op_counts.get("query", 0) - \
            sent0.get("query", 0)
        co.enable_cluster_batch()
        sent0 = dict(co.client.op_counts)
        for _ in range(WAVES):
            run_wave("batched", queries)
        out["batch_rpcs"] = co.client.op_counts.get("query_batch", 0) - \
            sent0.get("query_batch", 0)
        out["solo_leak"] = co.client.op_counts.get("query", 0) - \
            sent0.get("query", 0)
        reg = MetricsRegistry()
        co.enable_resilience(registry=reg, hedge_min_ms=30.0,
                             timeout_min_ms=5000.0,
                             breaker_threshold=1 << 30)
        for _ in range(2):
            run_wave("chaos-warm", queries[:16])
        victim = next(n.node.id for n in c.nodes[1:]
                      if n.holder.index("c14").shards())
        plan.delay(victim, 0.3, op="query_batch")
        run_wave("chaos", queries[:16])
        plan.clear()
        co.disable_resilience()
        co.disable_cluster_batch()
        out["hedges"] = _counter(reg, "cluster_hedges_total")
    finally:
        c.close()
    return out


_RUNS = {}


def _run(name, root):
    key = (name, root)
    if key not in _RUNS:
        _RUNS[key] = {"9": _config9, "14": _config14}[name](root)
    return _RUNS[key]


@pytest.fixture(params=[JAX, TORCH], ids=["jax", "torch"])
def root(request):
    return request.param


def test_config9_every_answer_equals_numpy(root):
    r = _run("9", root)
    assert len(r["answers"]) == 4 * ITERS
    assert all(got == r["want"] for _, got in r["answers"]), r["answers"]


def test_config9_unhedged_pays_the_straggle(root):
    r = _run("9", root)
    assert min(r["unhedged"]) >= r["delay_s"]


def test_config9_a_hedge_wins_under_the_straggler(root):
    r = _run("9", root)
    assert r["hedges"] >= 1 and r["wins"] >= 1, r


def test_config9_answers_equal_across_packages():
    assert _run("9", JAX)["answers"] == _run("9", TORCH)["answers"]


def test_config14_every_answer_equals_numpy(root):
    r = _run("14", root)
    want = [w for _, _, w in r["queries"]]
    assert [p for p, _ in r["answers"]] == (
        ["unbatched"] * WAVES + ["batched"] * WAVES + ["chaos-warm"] * 2
        + ["chaos"])
    for phase, got in r["answers"]:
        assert got == [[w] for w in want[:len(got)]], phase


def test_config14_batching_cuts_node_rpcs_8x(root):
    r = _run("14", root)
    assert r["solo_leak"] == 0, "a batched leg used /internal/query"
    assert r["batch_rpcs"] > 0
    assert r["solo_rpcs"] / r["batch_rpcs"] >= 8.0, \
        (r["solo_rpcs"], r["batch_rpcs"])


def test_config14_answers_equal_across_packages():
    j, t = _run("14", JAX), _run("14", TORCH)
    assert j["queries"] == t["queries"]
    assert j["answers"] == t["answers"]
