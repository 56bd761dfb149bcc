"""The observability slice end to end against the JAX package, on the CPU.

``bench.py`` configs 15 (the health plane on the query path) and 16 (the
device profiler on the warm resident query path), cut to a few thousand
columns a shard, through ``pilosa_tpu.api.API`` and
``pilosa_tpu_torch.api.API(device="cpu")`` on the same seeded data:

* the results, bit for bit, with the plane or the profiler off and on;
* the profiler: zero cost evaluations, profiles and events while off;
  the tape families, each family's FLOPs, HBM bytes, shape bucket and
  dispatches while on, equal to the JAX package's. One departure
  (ROADMAP C): a bare-leaf root, ``Count(Row(f=3))``, is pinned with
  ``("or", 0, 0)`` in the port, so its family is ``count/1l/or1`` where
  the JAX package's is ``count/1l/leaf``, with one more word op; the
  test derives the port's family and cost from the JAX package's tape
  with that op added. ``TopN`` is a ``pallas`` family in the port (its
  ``ctile_count`` or ``pair_counts`` launch) and runs outside any scope
  in the JAX package on the CPU, so only the tape families are compared;
* the SLO tracker's event counts per surface;
* the timeline samples' keys, probe names and each probe's keys;
* the flight recorder's bundles (triggers and keys) under ``ManualClock``;
* the ingest stages (names, row and batch counts) of a CSV ``Ingester``
  load.

Tolerances are exact apart from times.
"""

import numpy as np
import pytest

from pilosa_tpu.api import API as JaxAPI
from pilosa_tpu.obs import devprof as jdev
from pilosa_tpu.obs.slo import Objective as JaxObjective
from pilosa_tpu.sched.clock import ManualClock as JaxClock
from pilosa_tpu.shardwidth import SHARD_WIDTH
from pilosa_tpu_torch.api import API as TorchAPI
from pilosa_tpu_torch.ingest.ingest import Ingester as TorchIngester
from pilosa_tpu_torch.ingest.source import CSVSource as TorchCSV
from pilosa_tpu_torch.obs import devprof as tdev
from pilosa_tpu_torch.obs.slo import Objective as TorchObjective
from pilosa_tpu_torch.sched.clock import ManualClock as TorchClock

C15_QUERIES = ["Count(Row(f=3))", "Intersect(Row(f=1), Row(f=2))",
               "TopN(f, n=4)"]
C16_QUERIES = [
    "Count(Row(f=3))",
    "Count(Intersect(Row(f=1), Row(g=1)))",
    "Count(Union(Row(f=2), Row(g=3), Row(f=5)))",
    "Intersect(Row(f=1), Row(g=2))",
]


def _apis():
    return JaxAPI(), TorchAPI(device="cpu")


def _config15(api, per_shard=2000):
    """bench.py bench_config15's data, ``per_shard`` columns a shard."""
    rng = np.random.default_rng(15)
    api.create_index("c15")
    api.create_field("c15", "f")
    for shard in range(2):
        rows = rng.integers(0, 8, per_shard)
        cols = shard * SHARD_WIDTH + np.arange(per_shard)
        api.import_bits("c15", "f", rows=rows.tolist(), cols=cols.tolist())


def _config16(api, per_shard=3000):
    """bench.py bench_config16's data, ``per_shard`` columns a shard."""
    rng = np.random.default_rng(16)
    api.create_index("c16")
    api.create_field("c16", "f")
    api.create_field("c16", "g")
    for shard in range(2):
        cols = shard * SHARD_WIDTH + np.arange(per_shard)
        api.import_bits("c16", "f",
                        rows=rng.integers(0, 32, per_shard).tolist(),
                        cols=cols.tolist())
        api.import_bits("c16", "g",
                        rows=rng.integers(0, 16, per_shard).tolist(),
                        cols=cols.tolist())
    api.holder.prewarm("c16")


@pytest.fixture
def devprof_off():
    was = (jdev.ENABLED, tdev.ENABLED)
    for d in (jdev, tdev):
        d.disable()
        d.reset()
    yield
    for d, on in zip((jdev, tdev), was):
        d.reset()
        d.enable() if on else d.disable()


# ---------------------------------------------------------------------------
# config 16: the device profiler
# ---------------------------------------------------------------------------


def _tape_families(dev) -> dict:
    return {p["family"]: (p["shape_bucket"], p["dispatches"], p["flops"],
                          p["hbm_bytes"])
            for p in dev.KERNELS.snapshot()
            if p["family"].split("/")[0] in ("count", "plane")}


def _expected_port_families(jax_rows: dict, calls: dict) -> dict:
    """The JAX package's tape families as the port names and costs them:
    a bare-leaf root gets the port's pinning op."""
    out = {}
    for fam, (bucket, n, flops, nbytes) in jax_rows.items():
        kind, tape, n_leaves, masked, words = calls[fam]
        if not tape:
            tape = (("or", 0, 0),)
            fam = tdev.family_name(kind, tape, n_leaves, masked)
            f1, b1 = tdev.tape_cost(kind, tape, n_leaves, masked, words)
            flops, nbytes = f1 * n, b1 * n
        out[fam] = (bucket, n, flops, nbytes)
    return out


class TestConfig16:
    def test_profiles_match_the_jax_package(self, devprof_off, monkeypatch):
        japi, tapi = _apis()
        results, families = {}, {}
        jax_calls = {}
        real_scope = jdev.kernel_scope

        def spy(kind, tape, n_leaves, masked, total_words):
            jax_calls[jdev.family_name(kind, tape, n_leaves, masked)] = (
                kind, tape, n_leaves, masked, total_words)
            return real_scope(kind, tape, n_leaves, masked, total_words)

        monkeypatch.setattr(jdev, "kernel_scope", spy)
        for name, api, dev in (("jax", japi, jdev), ("torch", tapi, tdev)):
            _config16(api)
            evals, allocs = dev.cost_evals(), dev.KERNELS.allocations
            created = getattr(dev, "EVENTS_CREATED", 0)
            off = [api.query_json("c16", q) for q in C16_QUERIES]
            assert dev.cost_evals() == evals
            assert dev.KERNELS.allocations == allocs
            assert getattr(dev, "EVENTS_CREATED", 0) == created
            assert dev.KERNELS.profile_count() == 0
            dev.enable()
            dev.reset()
            try:
                on = [api.query_json("c16", q) for q in C16_QUERIES]
                on += [api.query_json("c16", q) for q in C16_QUERIES]
                profiles = dev.KERNELS.snapshot()
                families[name] = _tape_families(dev)
            finally:
                dev.disable()
            assert on == off + off
            results[name] = off
            assert len(profiles) >= len(C16_QUERIES)
            for p in profiles:
                assert p["dispatches"] > 0, p
                assert p["mfu_pct"] > 0 and p["achieved_gbps"] > 0, p
        assert results["torch"] == results["jax"]
        assert len(families["jax"]) == len(C16_QUERIES)
        want = _expected_port_families(families["jax"], jax_calls)
        assert families["torch"] == want
        leaf = [f for f in families["jax"] if "/leaf" in f]
        assert len(leaf) == 1 and leaf[0].startswith("count/1l/leaf#")
        assert any(f.startswith("count/1l/or1#") for f in families["torch"])

    def test_port_kernel_families_on_the_cpu(self, devprof_off):
        """The port's launch sites record under their ``pallas`` cost
        families on the CPU too (the plain versions' wall time)."""
        api = TorchAPI(device="cpu")
        _config16(api)
        tdev.enable()
        tdev.reset()
        try:
            api.query("c16", "TopN(f, n=4)")
            api.query("c16", "GroupBy(Rows(f), Rows(g), limit=5)")
            fams = {p["family"].split("#")[0]: p
                    for p in tdev.KERNELS.snapshot()}
        finally:
            tdev.disable()
        kinds = {f.split("/")[-1] for f in fams if f.startswith("pallas/")}
        assert kinds & {"mm1", "pop1"}, fams
        for p in fams.values():
            assert p["dispatches"] > 0 and p["device_seconds"] > 0


# ---------------------------------------------------------------------------
# config 15: the health plane
# ---------------------------------------------------------------------------


def _keys(sample: dict) -> dict:
    return {"top": sorted(sample),
            "probes": {name: sorted(v) if isinstance(v, dict) else type(v)
                       for name, v in sample["probes"].items()}}


def _bundle_keys(b: dict) -> tuple:
    return (b["trigger"], sorted(b), sorted(b["slo"]),
            sorted(b["sample"]["probes"]))


class TestConfig15:
    def _run(self, api, clock, objective):
        _config15(api)
        assert api.health is None
        disabled = [api.query_json("c15", q) for q in C15_QUERIES]
        hp = api.enable_health(clock=clock, interval_ms=10.0,
                               objectives=[objective], min_events=1,
                               fast_burn_alert=1.0, flight_cooldown_s=5.0)
        try:
            always = []
            for _ in range(3):
                for q in C15_QUERIES:
                    clock.advance(0.02)
                    always.append(api.query_json("c15", q))
            api.import_bits("c15", "f", rows=[1, 2], cols=[5, 6])
            clock.advance(0.02)
            api.query_json("c15", C15_QUERIES[0])
            events = {r["surface"]: r["events_fast"]
                      for r in hp.slo.burn_rates()}
            samples = hp.timeline.window(None)
            bundles = hp.flight.bundles()
        finally:
            api.disable_health()
        return disabled, always, events, samples, bundles

    def test_plane_matches_the_jax_package(self):
        japi, tapi = _apis()
        # every request is slower than 0 ms: the fast burn alerts at once
        jo = JaxObjective("query-latency", "query", "latency", 0.99,
                          threshold_ms=0.0)
        to = TorchObjective("query-latency", "query", "latency", 0.99,
                            threshold_ms=0.0)
        jd, ja, je, js, jb = self._run(japi, JaxClock(), jo)
        td, ta, te, ts, tb = self._run(tapi, TorchClock(), to)
        assert td == jd and ta == ja
        assert ja == jd * 3
        assert te == je and te["query"] == 10
        assert len(ts) == len(js) == 10  # the import is not due
        assert [_keys(s) for s in ts] == [_keys(s) for s in js]
        assert [_bundle_keys(b) for b in tb] == [_bundle_keys(b) for b in jb]
        assert [b["trigger"] for b in tb] == ["slo_fast_burn"]

    def test_disabled_plane_takes_no_samples(self):
        from pilosa_tpu_torch.obs import metrics as M

        api = TorchAPI(device="cpu")
        _config15(api)
        before = M.REGISTRY.value(M.METRIC_TIMELINE_SAMPLES)
        for q in C15_QUERIES:
            api.query_json("c15", q)
        assert M.REGISTRY.value(M.METRIC_TIMELINE_SAMPLES) == before


# ---------------------------------------------------------------------------
# ingest stages of a CSV load
# ---------------------------------------------------------------------------


class TestIngestStages:
    CSV = "id,city__S,kind__S,pop__I\n" + "\n".join(
        f"{i},c{i % 11},k{i % 3},{1000 + 7 * i}" for i in range(2000))

    def test_stage_names_and_rows_match(self, devprof_off, tmp_path):
        from pilosa_tpu.ingest.ingest import Ingester as JaxIngester
        from pilosa_tpu.ingest.source import CSVSource as JaxCSV

        seen = {}
        for name, api, dev, ing, src in (
                ("jax", JaxAPI(str(tmp_path / "j")), jdev, JaxIngester,
                 JaxCSV),
                ("torch", TorchAPI(str(tmp_path / "t"), device="cpu"), tdev,
                 TorchIngester, TorchCSV)):
            dev.enable()
            dev.reset()
            try:
                n = ing(api, "cities", src(self.CSV, inline=True)).run()
                snap = dev.INGEST.snapshot()
            finally:
                dev.disable()
            assert n == 2000
            seen[name] = {stage: (d["rows"], d["batches"], d["bytes"] > 0)
                          for stage, d in snap.items()}
        assert seen["torch"] == seen["jax"]
        assert set(seen["jax"]) >= {"parse", "key_translate",
                                    "fragment_advance", "wal_commit"}
