"""The gossip slice end to end, through both packages.

* ``bench.py`` config 10 at 2,000 records a shard: a 2-node cluster, a
  remote shard's ``Count`` cached on the coordinator, the owner written
  directly; 4 trials with a TTL-only leg cache (300 ms), then 4 with
  gossip-keyed caching at ``ttl_ms=0`` (10 ms rounds on their threads).
  Every read of a trial sees at least the count written before it, the
  gossip window's p50 is below the TTL window's (bench.py's own
  comparison), and the counts read are the JAX package's.
* A lagging replica at small width (chip_smoke.py's path 18b): a 3-node,
  2-replica cluster with a data directory per node, an index ``rc`` with
  a 7-row mutex field over shards 2 and 3 (node 2 is shard 2's primary,
  node 0 its replica), gossip, membership, resilience and the health
  plane on every node under one ``ManualClock`` a package. Node 2 is
  paused and falls silent; the coordinator's reads stay right and its
  breaker for node 2, once open, reaches node 1 as a prewarm; node 2 is
  confirmed down; writes land on node 0 alone; node 2 comes back and
  rejoins; ``enable_recovery`` finds shard 2 behind node 0, and
  ``catch_up`` ships its snapshot and, for writes that land after the
  snapshot, the WAL tail. The answers, membership views, ``lagging``
  sets, summaries (all but ``lag_ms``) and planes are the JAX
  package's, and the planes equal the peer's.
"""

import importlib
import json
import time
import types

import numpy as np

JAX, TORCH = "pilosa_tpu", "pilosa_tpu_torch"


def _load(root: str) -> types.SimpleNamespace:
    m = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    kw = {"device": "cpu"} if root == TORCH else {}
    cluster = m("cluster")
    return types.SimpleNamespace(
        root=root,
        LocalCluster=lambda *a, **k: cluster.LocalCluster(*a, **{**kw, **k}),
        InternalClient=m("cluster.client").InternalClient,
        M=m("obs.metrics"),
        MetricsRegistry=m("obs.metrics").MetricsRegistry,
        ManualClock=m("sched").ManualClock,
        SHARD_WIDTH=m("shardwidth").SHARD_WIDTH,
        export_shard_arrays=m("storage.store").export_shard_arrays,
    )


_PACKAGES = {}


def _pkg(root):
    if root not in _PACKAGES:
        _PACKAGES[root] = _load(root)
    return _PACKAGES[root]


# -- bench.py config 10 -------------------------------------------------------


def _pct(lat, p):
    lat = sorted(lat)
    return lat[min(len(lat) - 1, int(p * len(lat)))]


def _config10(P, per_shard=2000, trials=4):
    """bench.py:712-786 at ``per_shard`` records a shard: the stale-read
    windows of each phase, the counts each trial waited for, the counts
    every read returned, and the gossip counters."""
    rng = np.random.default_rng(10)
    ttl_ms, interval_ms = 300.0, 10.0
    reg = P.MetricsRegistry()
    reads = []
    with P.LocalCluster(2) as c:
        co = c.coordinator
        co.create_index("c10")
        co.create_field("c10", "f")
        for shard in range(4):
            rows = rng.integers(0, 8, per_shard)
            cols = shard * P.SHARD_WIDTH + np.arange(per_shard)
            co.import_bits("c10", "f", rows=rows.tolist(),
                           cols=cols.tolist())
        owner = next(n for n in c.nodes[1:]
                     if n.holder.index("c10").shards())
        shard = sorted(owner.holder.index("c10").shards())[0]
        q = "Count(Row(f=3))"
        next_col = [shard * P.SHARD_WIDTH + per_shard]
        wants = []

        def stale_window():
            want = co.query("c10", q)[0] + 1
            wants.append(want)
            col, next_col[0] = next_col[0], next_col[0] + 1
            owner.api.import_bits("c10", "f", rows=[3], cols=[col])
            owner._announce_shards("c10")
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < 5.0:
                got = co.query("c10", q)[0]
                reads.append((want, got))
                if got >= want:
                    return time.perf_counter() - t0
                time.sleep(0.002)
            return 5.0

        co.enable_cache(ttl_ms=ttl_ms, registry=P.MetricsRegistry())
        ttl = [stale_window() for _ in range(trials)]
        co.disable_cache()
        c.enable_gossip(interval_ms=interval_ms, start=True, registry=reg)
        c.run_gossip_rounds(3)
        co.enable_cache(ttl_ms=0, registry=P.MetricsRegistry())
        gossip = [stale_window() for _ in range(trials)]
    counters = {name: sum(v for k, v in reg.snapshot()["counters"].items()
                          if k.startswith(name))
                for name in (P.M.METRIC_GOSSIP_ROUNDS,
                             P.M.METRIC_GOSSIP_DELTAS_SENT,
                             P.M.METRIC_GOSSIP_DELTAS_APPLIED,
                             P.M.METRIC_GOSSIP_PIGGYBACKS)}
    return {"ttl": ttl, "gossip": gossip, "wants": wants, "reads": reads,
            "counters": counters}


def test_config10_gossip_window_beats_ttl():
    out = {r: _config10(_pkg(r)) for r in (JAX, TORCH)}
    for root, o in out.items():
        # a read never goes back past a write that completed before it
        # started (stale reads are the previous count, never less)
        assert all(got >= want - 1 for want, got in o["reads"]), root
        assert max(o["gossip"]) < 5.0, root  # no window hit the bail
        assert _pct(o["gossip"], 0.5) < _pct(o["ttl"], 0.5), root
        c = o["counters"]
        assert c[_pkg(root).M.METRIC_GOSSIP_ROUNDS] > 0, root
        assert c[_pkg(root).M.METRIC_GOSSIP_DELTAS_APPLIED] > 0, root
    assert out[JAX]["wants"] == out[TORCH]["wants"]


# -- a lagging replica (path 18b at small width) ------------------------------


RC_SHARDS = (2, 3)  # by placement: shard 2 on node2 (primary) and node0
RC_WIDTH = 3000
RC_ROWS = 7
RC_LAG = 1500


def _rounds(c, clock, n, only=None):
    for _ in range(n):
        for i, node in enumerate(c.nodes):
            if only is None or i in only:
                node.gossip.run_round()
        clock.advance(0.5)


def _status(node, target):
    return node.membership.view()[target]["status"]


def _reads(node, want):
    """Every row's Count and ``TopN(f)`` against the bincount ``want``."""
    counts = [node.query("rc", f"Count(Row(f={r}))")[0]
              for r in range(RC_ROWS)]
    assert counts == [int(v) for v in want], node.node.id
    top = node.query("rc", "TopN(f)")[0]
    pairs = sorted((-int(v), r) for r, v in enumerate(want) if v)
    assert [(p.id, p.count) for p in top.pairs] == \
        [(r, -v) for v, r in pairs], node.node.id
    return counts


def _shard_arrays(P, node, shard):
    return P.export_shard_arrays(node.api.holder.index("rc"), shard)


def _lagging_replica(P, base):
    rng = np.random.default_rng(18)
    sw = P.SHARD_WIDTH
    cols = np.concatenate([s * sw + np.arange(RC_WIDTH) for s in RC_SHARDS])
    f_of = rng.integers(0, RC_ROWS, cols.size)
    clock = P.ManualClock()
    regs = [P.MetricsRegistry() for _ in range(3)]
    out = {"views": []}
    with P.LocalCluster(
            3, replica_n=2, base_path=base,
            client_factory=lambda i: P.InternalClient(
                retries=0, backoff=0.001)) as c:
        co = c.coordinator
        co.create_index("rc")
        co.create_field("rc", "f", {"type": "mutex"})
        co.import_bits("rc", "f", rows=f_of.tolist(), cols=cols.tolist())
        c.enable_gossip(seed=18, clock=clock, registry=P.MetricsRegistry())
        c.enable_membership(seed=18, clock=clock)
        for i, node in enumerate(c.nodes):
            node.enable_resilience(registry=regs[i], timeout_min_ms=5000.0)
            node.enable_health(clock=clock)
        assert [n.id for n in co.snapshot().shard_nodes("rc", 2)] == \
            ["node2", "node0"]
        _rounds(c, clock, 3)
        want = np.bincount(f_of, minlength=RC_ROWS)
        out["reads"] = [_reads(co, want)]

        c.pause(2)
        c[2].gossip.stop()  # silent, as a stopped process is
        # the coordinator's legs to node 2 fail over to node 0; its
        # breaker opens on the third failure and gossips to node 1
        for _ in range(3):
            out["reads"].append(_reads(co, want))
        assert co.resilience.breaker.state("node2") == "open"
        _rounds(c, clock, 14, only=(0, 1))
        assert _status(co, "node2") == "down"
        assert set(co.disco.live_ids()) == {"node0", "node1"}
        out["prewarms"] = regs[1].value(P.M.METRIC_GOSSIP_BREAKER_PREWARMS,
                                       node="node2")
        assert out["prewarms"] >= 1
        out["views"].append(co.membership_json())

        # node 2's shard changes on its other owner while it is away
        lag = rng.choice(RC_WIDTH, RC_LAG, replace=False) + 2 * sw
        rows = rng.integers(0, RC_ROWS, RC_LAG)
        c[0].api.import_bits("rc", "f", rows=rows.tolist(),
                             cols=lag.tolist())
        c[0]._announce_shards("rc")
        f_of[np.searchsorted(cols, lag)] = rows
        want = np.bincount(f_of, minlength=RC_ROWS)
        out["reads"].append(_reads(co, want))

        c.unpause(2)
        for _ in range(10):
            _rounds(c, clock, 1)
            if _status(co, "node2") == "alive":
                break
        assert _status(co, "node2") == "alive"
        assert "node2" in co.disco.live_ids()
        out["views"].append(co.membership_json())
        out["probe"] = co.health.timeline.sample()["probes"]["membership"]

        rm = c[2].enable_recovery()
        out["lagging"] = {o: sorted(s)
                          for o, s in rm.lagging("rc").items()}
        assert out["lagging"] == {"node0": [2]}
        states = []
        record = c[2].gossip.record_breaker
        c[2].gossip.record_breaker = \
            lambda t, s: (states.append((t, s)), record(t, s))[1]
        snapshot = c[2].client.recovery_snapshot
        late = rng.choice(RC_WIDTH, 64, replace=False) + 2 * sw
        late_rows = rng.integers(0, RC_ROWS, late.size)

        def snapshot_then_write(node, index, shard, token=None):
            # a write that lands at the peer after its snapshot: it
            # reaches node 2 through the shipped tail
            got = snapshot(node, index, shard, token=token)
            c[0].api.import_bits("rc", "f", rows=late_rows.tolist(),
                                 cols=late.tolist())
            return got

        c[2].client.recovery_snapshot = snapshot_then_write
        summary = rm.catch_up()
        c[2].client.recovery_snapshot = snapshot
        summary.pop("lag_ms")
        out["summary"] = summary
        assert summary["shards"] == 1 and summary["records"] > 0
        assert states == [("node2", "open"), ("node2", "closed")]
        f_of[np.searchsorted(cols, late)] = late_rows
        want = np.bincount(f_of, minlength=RC_ROWS)
        mine, peer = (_shard_arrays(P, n, 2) for n in (c[2], c[0]))
        assert sorted(mine) == sorted(peer)
        for key in mine:
            np.testing.assert_array_equal(mine[key], peer[key], key)
        out["planes"] = mine
        out["reads"] += [_reads(c[2], want), _reads(co, want)]
        again = rm.catch_up()
        assert again["shards"] == 0
        _rounds(c, clock, 3)
        out["views"].append(co.membership_json())
    return out


def test_lagging_replica_catches_up_alike(tmp_path):
    out = {r: _lagging_replica(_pkg(r), str(tmp_path / r))
           for r in (JAX, TORCH)}
    jx, tc = out[JAX], out[TORCH]
    assert jx["reads"] == tc["reads"]
    assert jx["lagging"] == tc["lagging"]
    assert jx["summary"] == tc["summary"]
    assert json.dumps(jx["views"], sort_keys=True) == \
        json.dumps(tc["views"], sort_keys=True)
    assert jx["probe"] == tc["probe"]
    assert sorted(jx["planes"]) == sorted(tc["planes"])
    for key in jx["planes"]:
        np.testing.assert_array_equal(jx["planes"][key], tc["planes"][key])
