"""The DAX slice end to end: ``bench.py`` config 19 at a small scale
through both packages' ``DaxCluster``, from the same seed.

Config 19 (``bench_config19``) runs a 3-computer fleet behind the
serving queryer (scheduler admission and the directive-versioned result
cache) under mixed writes and reads while computer 0 is killed at 30%
of the batches, computer 1 is silenced at 50% (the checkin poller must
bury it) and the fleet scales up at 70%. Every write batch is retried
until acked and then mirrored to a plain ``API``, the oracle. Then a
computer is RESET behind the controller's back (the next DIFF must be
answered with a resync and rebuilt by a FULL directive), the fleet
scales up again (the new owner prewarms before it acks), and a fresh
computer directed over every shard of the shared writelog must replay
to the oracle's checksum.

Here at 600 sets (bench's CPU scale). Held: every read equals the
oracle; both fleets' replayed checksums equal each other and the
oracles'; the resync, prewarm and replay counters move in both; both
controllers assign every shard to the same computer. The port runs
with ``device="cpu"``.
"""

import copy
import importlib
import time
import types

import numpy as np
import pytest

JAX, TORCH = "pilosa_tpu", "pilosa_tpu_torch"

N_SETS = 600
BATCH = 8
SHARDS = 12
ROWS = 16


def _load(root: str) -> types.SimpleNamespace:
    m = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    kw = {"device": "cpu"} if root == TORCH else {}
    api_cls = m("api").API
    comp_cls = m("dax.computer").Computer
    cluster_cls = m("dax.harness").DaxCluster
    directive = m("dax.directive")
    return types.SimpleNamespace(
        root=root,
        API=lambda *a, **k: api_cls(*a, **{**kw, **k}),
        Computer=lambda *a, **k: comp_cls(*a, **{**kw, **k}),
        DaxCluster=lambda *a, **k: cluster_cls(*a, **{**kw, **k}),
        Directive=directive.Directive,
        METHOD_FULL=directive.METHOD_FULL,
        METHOD_RESET=directive.METHOD_RESET,
        M=m("obs.metrics"),
        SHARD_WIDTH=m("shardwidth").SHARD_WIDTH,
    )


def _config19(P, shared_dir: str) -> dict:
    """``bench_config19``'s phases at ``N_SETS``; returns what the
    comparison across packages needs."""
    M = P.M
    reg = M.REGISTRY
    W = P.SHARD_WIDTH
    rng = np.random.default_rng(19)
    cluster = P.DaxCluster(3, shared_dir=shared_dir, dead_after_s=1.0,
                           snapshot_every=64, serving=True)
    out = {"reads": 0}
    try:
        fields = [{"name": "f", "options": {"type": "set"}},
                  {"name": "v", "options": {"type": "int"}}]
        cluster.controller.create_table("e", {}, fields=fields)
        oracle = P.API()
        oracle.create_index("e", {})
        oracle.create_field("e", "f", {"type": "set"})
        oracle.create_field("e", "v", {"type": "int"})
        alive = {0, 1, 2}

        def beat():
            for i in alive:
                cluster.controller.checkin(cluster.computers[i].node.id)

        def retry(fn, what, tries=300):
            last = None
            for _ in range(tries):
                try:
                    return fn()
                except Exception as exc:  # noqa: BLE001 — the chaos window
                    last = exc
                    beat()
                    cluster.step()
                    time.sleep(0.02)
            raise AssertionError(f"{what} never recovered: {last!r}")

        cols = rng.integers(0, 4096, N_SETS)
        rowv = rng.integers(0, ROWS, N_SETS)
        shardv = rng.integers(0, SHARDS, N_SETS)
        n_batches = N_SETS // BATCH
        kill_at, silence_at, grow_at = (int(n_batches * f)
                                        for f in (0.3, 0.5, 0.7))
        for bi in range(n_batches):
            if bi == kill_at:
                cluster.kill(0)
                alive.discard(0)
            if bi == silence_at:
                cluster.silence(1)
                alive.discard(1)
            if bi == grow_at:
                cluster.scale_up()
                alive.add(len(cluster.computers) - 1)
            lo = bi * BATCH
            pql = "".join(
                f"Set({int(shardv[i]) * W + int(cols[i])},"
                f" f={int(rowv[i])})" for i in range(lo, lo + BATCH))
            retry(lambda: cluster.queryer.query("e", pql), "write batch")
            oracle.query("e", pql)
            if bi % 12 == 5:
                vc = [int(shardv[lo]) * W + k for k in range(12)]
                vv = [int(x) for x in rng.integers(-50, 50, 12)]
                retry(lambda: cluster.queryer.import_values("e", "v", vc, vv),
                      "value import")
                oracle.import_values("e", "v", cols=vc, values=vv)
            if bi % 10 == 7:
                q = f"Count(Row(f={bi % ROWS}))"
                got = retry(lambda: cluster.queryer.query("e", q), "read")[0]
                assert got == oracle.query("e", q)[0], (P.root, bi, got)
                out["reads"] += 1
            beat()
            if bi % 10 == 0:
                cluster.step()
        dead = {cluster.computers[0].node.id, cluster.computers[1].node.id}
        assert dead <= cluster.controller.dead, "the poller missed a death"

        # RESET behind the controller's back: the next push resyncs
        live = cluster.controller.live_ids()
        victim = next(c for c in cluster.computers if c.node.id in live)
        r0 = reg.value(M.METRIC_DAX_FULL_RESYNCS)
        victim.apply_directive(P.Directive(
            version=0, method=P.METHOD_RESET, schema=[],
            assigned=[]).to_json())
        cluster.controller.create_field("e", "aux", {"type": "set"})
        oracle.create_field("e", "aux", {"type": "set"})
        out["resyncs"] = reg.value(M.METRIC_DAX_FULL_RESYNCS) - r0
        assert out["resyncs"] > 0, "the RESET node was not resynced"
        for q in ("Count(Row(f=3))", "Sum(field=v)", "TopN(f, n=4)"):
            got = retry(lambda: cluster.queryer.query("e", q),
                        "post-resync read")[0]
            want = oracle.query("e", q)[0]
            if q.startswith("Sum"):
                got, want = (got.val, got.count), (want.val, want.count)
            elif q.startswith("TopN"):
                got = [(p.id, p.count) for p in got.pairs]
                want = [(p.id, p.count) for p in want.pairs]
            assert got == want, (P.root, q, got, want)
            out["reads"] += 1

        # warm handoff: a scale-up whose new owner prewarms before it acks
        w0 = reg.value(M.METRIC_DAX_PREWARM_STACKS)
        new_shards = []
        for _ in range(3):
            cluster.scale_up()
            alive.add(len(cluster.computers) - 1)
            new_id = cluster.computers[-1].node.id
            new_shards = sorted(
                s for (_, s), nid in cluster.controller.assignment().items()
                if nid == new_id)
            if new_shards:
                break
        assert new_shards, "scale-up moved no shards after 3 attempts"
        out["prewarm"] = reg.value(M.METRIC_DAX_PREWARM_STACKS) - w0
        assert out["prewarm"] > 0, "the new owner acked without a prewarm"
        for s in new_shards:
            for r in (0, 5):
                q = f"Count(Row(f={r}))"
                got = retry(lambda: cluster.queryer.query("e", q,
                                                          shards=[s]),
                            "fresh read")[0]
                assert got == oracle.query("e", q, shards=[s])[0]
                out["reads"] += 1

        # zero loss: a fresh computer replays every shard of the log
        shards_all = sorted(cluster.controller.shards_of("e"))
        assert len(shards_all) == SHARDS, shards_all
        ops0 = reg.value(M.METRIC_DAX_REPLAY_OPS)
        check = P.Computer("c19-check", cluster.dir)
        res = check.apply_directive(P.Directive(
            version=1, method=P.METHOD_FULL,
            schema=copy.deepcopy(cluster.controller.schema),
            assigned=[("e", s) for s in shards_all]).to_json())
        assert res["applied"], res
        out["replay_ops"] = reg.value(M.METRIC_DAX_REPLAY_OPS) - ops0
        assert out["replay_ops"] > 0
        out["checksum"] = check.api.checksum()
        out["oracle"] = oracle.checksum()
        assert out["checksum"] == out["oracle"], \
            f"{P.root}: acked writes were lost"
        out["assignment"] = {f"{t}/{s}": nid for (t, s), nid in
                             cluster.controller.assignment().items()}
        out["computers"] = [c.node.id for c in cluster.computers]
        check.close()
    finally:
        cluster.close()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each package's run, made on first use (once per module)."""
    cache = {}

    def get(root):
        if root not in cache:
            cache[root] = _config19(
                _load(root), str(tmp_path_factory.mktemp(f"dax_{root}")))
        return cache[root]
    return get


@pytest.mark.parametrize("root", [JAX, TORCH], ids=["jax", "torch"])
def test_config19_small_holds_every_gate(root, runs):
    assert runs(root)["reads"] >= N_SETS // BATCH // 10


def test_config19_small_agrees_across_packages(runs):
    j, t = runs(JAX), runs(TORCH)
    assert j["checksum"] == t["checksum"] == j["oracle"] == t["oracle"]
    assert j["computers"] == t["computers"]
    assert j["assignment"] == t["assignment"]
    assert j["reads"] == t["reads"]
