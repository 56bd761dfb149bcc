"""Replica catch-up by WAL log shipping, run once per package, and the
two packages' catch-up held against each other.

The ``P`` fixture yields the modules of ``pilosa_tpu`` or of their
``pilosa_tpu_torch`` counterparts; ``P.API()`` and ``P.LocalCluster``
build the port's with ``device="cpu"``. Covered:

* ``tests/test_recovery.py``'s ``TestReplicaCatchUp`` (lag detection,
  bit-identical convergence, catch-up under injected faults, writes
  queued mid-catch-up, the gossiped breaker, per-index drains, a failed
  run that keeps the breaker open, the snapshot and WAL routes),
  ``TestRecoveryMetrics`` and ``TestRecoveryConfig::
  test_manager_from_config``, once per package;
* across the packages, equal: after the same lag, the ``lagging`` sets,
  the catch-up summaries (all but ``lag_ms``, a wall time), the snapshot
  and tail a peer ships, and the caught-up node's
  ``export_shard_arrays`` of every shard, array for array.
"""

import base64
import importlib
import io
import types

import numpy as np
import pytest

JAX, TORCH = "pilosa_tpu", "pilosa_tpu_torch"


def _load(root: str) -> types.SimpleNamespace:
    m = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    kw = {"device": "cpu"} if root == TORCH else {}
    api_cls = m("api").API
    cluster = m("cluster")
    rec = m("storage.recovery")
    return types.SimpleNamespace(
        root=root,
        API=lambda *a, **k: api_cls(*a, **{**kw, **k}),
        LocalCluster=lambda *a, **k: cluster.LocalCluster(*a, **{**kw, **k}),
        FaultPlan=cluster.FaultPlan,
        Config=m("config").Config,
        M=m("obs.metrics"),
        SHARD_WIDTH=m("shardwidth").SHARD_WIDTH,
        RecoveryManager=rec.RecoveryManager,
        iter_frames=m("storage.wal").iter_frames,
        export_shard_arrays=m("storage.store").export_shard_arrays,
    )


_PACKAGES = {}


def _pkg(root):
    if root not in _PACKAGES:
        _PACKAGES[root] = _load(root)
    return _PACKAGES[root]


@pytest.fixture(params=[JAX, TORCH], ids=["jax", "torch"])
def P(request):
    return _pkg(request.param)


# -- the cases of tests/test_recovery.py, once per package --------------------


class TestRecoveryConfig:
    def test_manager_from_config(self, P, tmp_path):
        with P.LocalCluster(1, base_path=str(tmp_path)) as c:
            cfg = P.Config.from_sources(
                env={"PILOSA_TPU_STORAGE_RECOVERY_CATCHUP_BATCH_BYTES":
                     "4096"})
            rm = P.RecoveryManager.from_config(c.nodes[0], cfg)
            assert rm.batch_bytes == 4096
            rm2 = P.RecoveryManager.from_config(c.nodes[0], cfg,
                                                batch_bytes=99)
            assert rm2.batch_bytes == 99  # explicit override wins


# -- replica catch-up ---------------------------------------------------------


def _lag_node2(P, c):
    """Schema + an initial replicated write, then writes that land only
    on node0/node1 (node2 'was down' for them)."""
    c.coordinator.create_index("i")
    c.coordinator.create_field("i", "f")
    c.coordinator.import_bits("i", "f", rows=[0, 1, 2, 0],
                              cols=[1, 5, P.SHARD_WIDTH + 1,
                                    2 * P.SHARD_WIDTH + 1])
    c.run_gossip_rounds(2)
    for n in c.nodes[:2]:
        n.api.import_bits("i", "f", rows=[3, 3, 1],
                          cols=[7, P.SHARD_WIDTH + 2, 9])
        n._announce_shards("i")
    c.run_gossip_rounds(3)


class TestReplicaCatchUp:
    def test_lagging_detects_strictly_ahead_peers(self, P, tmp_path):
        with P.LocalCluster(3, replica_n=3, base_path=str(tmp_path)) as c:
            c.enable_gossip()
            rm = c.nodes[2].enable_recovery()
            _lag_node2(P, c)
            lag = rm.lagging("i")
            assert set(lag) == {"node0", "node1"}
            assert all(shards for shards in lag.values())
            # up-to-date nodes see no lag anywhere
            rm0 = c.nodes[0].enable_recovery()
            assert rm0.lagging("i") == {}

    def test_catch_up_converges_bit_identically(self, P, tmp_path):
        with P.LocalCluster(3, replica_n=3, base_path=str(tmp_path)) as c:
            c.enable_gossip()
            rm = c.nodes[2].enable_recovery()
            _lag_node2(P, c)
            assert c.nodes[2].api.checksum() != c.nodes[0].api.checksum()
            summary = rm.catch_up()
            assert summary["shards"] > 0
            sums = [n.api.checksum() for n in c.nodes]
            assert sums[0] == sums[1] == sums[2]
            assert c.nodes[2].query("i", "Row(f=3)")[0].columns == \
                [7, P.SHARD_WIDTH + 2]
            # second run: nothing left to repair
            again = rm.catch_up()
            assert again["shards"] == 0 and again["indexes"] == []

    def test_catch_up_under_injected_faults(self, P, tmp_path):
        """Dropped + delayed recovery RPCs are absorbed by the client's
        retry/backoff; catch-up still converges."""
        plan = (P.FaultPlan(seed=3)
                .drop("node0", first=0, count=1, op="recovery")
                .delay("node0", 0.01, first=1, count=2, op="recovery")
                .drop("node1", first=0, count=1, op="recovery"))
        with P.LocalCluster(3, replica_n=3, base_path=str(tmp_path),
                            fault_plan=plan) as c:
            c.enable_gossip()
            rm = c.nodes[2].enable_recovery()
            _lag_node2(P, c)
            summary = rm.catch_up()
            assert summary["shards"] > 0
            sums = [n.api.checksum() for n in c.nodes]
            assert sums[0] == sums[1] == sums[2]

    def test_writes_queue_during_catch_up_and_drain_after(self, P, tmp_path):
        with P.LocalCluster(3, replica_n=3, base_path=str(tmp_path)) as c:
            c.enable_gossip()
            c.coordinator.create_index("i")
            c.coordinator.create_field("i", "f")
            rm = c.nodes[2].enable_recovery()
            rm.begin("i")
            # a forwarded write arriving mid-catch-up must queue, not apply
            n = c.nodes[2].import_bits("i", "f", rows=[5], cols=[6],
                                       remote=True)
            assert n == 0
            assert c.nodes[2].api.query("i", "Row(f=5)")[0].columns == []
            assert rm.drain() == 1
            assert c.nodes[2].api.query("i", "Row(f=5)")[0].columns == [6]
            # drained: the next remote write applies immediately
            c.nodes[2].import_bits("i", "f", rows=[5], cols=[8],
                                   remote=True)
            assert c.nodes[2].api.query("i", "Row(f=5)")[0].columns == [6, 8]

    def test_catch_up_gossips_breaker_open_then_closed(self, P, tmp_path):
        with P.LocalCluster(3, replica_n=3, base_path=str(tmp_path)) as c:
            c.enable_gossip()
            rm = c.nodes[2].enable_recovery()
            _lag_node2(P, c)
            states = []
            orig = c.nodes[2].gossip.record_breaker

            def spy(node_id, state, **kw):
                states.append((node_id, state))
                return orig(node_id, state, **kw)

            c.nodes[2].gossip.record_breaker = spy
            rm.catch_up()
            assert ("node2", "open") in states
            assert ("node2", "closed") in states
            assert states.index(("node2", "open")) < \
                states.index(("node2", "closed"))

    def test_drain_is_per_index(self, P, tmp_path):
        """Regression: drain() used to clear the WHOLE active set and a
        single shared queue, so overlapping catch-up runs on different
        indexes released each other's deferred writes mid-replay."""
        with P.LocalCluster(3, replica_n=3, base_path=str(tmp_path)) as c:
            c.enable_gossip()
            for name in ("i", "j"):
                c.coordinator.create_index(name)
                c.coordinator.create_field(name, "f")
            rm = c.nodes[2].enable_recovery()
            rm.begin("i")
            rm.begin("j")
            assert c.nodes[2].import_bits("i", "f", rows=[1], cols=[2],
                                          remote=True) == 0
            assert c.nodes[2].import_bits("j", "f", rows=[3], cols=[4],
                                          remote=True) == 0
            assert rm.drain(["i"]) == 1  # only i's queue applies
            assert not rm.active("i") and rm.active("j")
            assert c.nodes[2].api.query("i", "Row(f=1)")[0].columns == [2]
            assert c.nodes[2].api.query("j", "Row(f=3)")[0].columns == []
            assert rm.drain() == 1  # bare drain still releases the rest
            assert c.nodes[2].api.query("j", "Row(f=3)")[0].columns == [4]

    def test_failed_catch_up_keeps_breaker_open(self, P, tmp_path):
        """Regression: catch_up's finally used to gossip 'closed' even
        when repair raised, so a still-lagging node advertised itself
        caught up and peers routed reads back to stale data. Failure
        must propagate and leave the breaker open; a retry that
        completes closes it."""
        with P.LocalCluster(3, replica_n=3, base_path=str(tmp_path)) as c:
            c.enable_gossip()
            rm = c.nodes[2].enable_recovery()
            _lag_node2(P, c)
            states = []
            orig = c.nodes[2].gossip.record_breaker

            def spy(node_id, state, **kw):
                states.append((node_id, state))
                return orig(node_id, state, **kw)

            c.nodes[2].gossip.record_breaker = spy

            def unreachable(index, origin, shards):
                raise OSError("peer unreachable")

            rm._repair_from = unreachable
            with pytest.raises(OSError):
                rm.catch_up()
            assert ("node2", "open") in states
            assert ("node2", "closed") not in states
            del rm._repair_from  # retry with the real repair path
            summary = rm.catch_up()
            assert summary["shards"] > 0
            assert ("node2", "closed") in states
            sums = [n.api.checksum() for n in c.nodes]
            assert sums[0] == sums[1] == sums[2]

    def test_recovery_endpoints_ship_snapshot_and_tail(self, P, tmp_path):
        """The transport itself: /internal/recovery/snapshot returns an
        installable npz + LSN; /internal/recovery/wal ships CRC-framed
        records above a cursor."""
        import base64

        with P.LocalCluster(2, replica_n=2, base_path=str(tmp_path)) as c:
            c.coordinator.create_index("i")
            c.coordinator.create_field("i", "f")
            c.coordinator.import_bits("i", "f", rows=[0, 1], cols=[3, 9])
            peer = c.nodes[0].node
            client = c.nodes[1].client
            snap = client.recovery_snapshot(peer, "i", 0)
            assert snap["lsn"] > 0 and snap["npz"]
            tail = client.recovery_wal(peer, "i", 0, 1 << 20)
            frames = base64.b64decode(tail["frames"])
            recs = [r for _lsn, r in P.iter_frames(frames)]
            assert any(r[0] == "import_bits" for r in recs)
            assert tail["last_lsn"] == snap["lsn"] and not tail["more"]
            # a cursor at the tip ships nothing
            empty = client.recovery_wal(peer, "i", tail["last_lsn"], 1 << 20)
            assert base64.b64decode(empty["frames"]) == b""


# -- metrics ------------------------------------------------------------------


class TestRecoveryMetrics:
    def test_checkpoint_and_catchup_metrics_exposed(self, P, tmp_path):
        api = P.API(str(tmp_path / "a"))
        api.create_index("i")
        api.create_field("i", "f")
        api.import_bits("i", "f", rows=[0], cols=[1])
        base = P.M.REGISTRY.summary(P.M.METRIC_RECOVERY_CHECKPOINT_SECONDS)[0]
        api.save()
        assert P.M.REGISTRY.summary(
            P.M.METRIC_RECOVERY_CHECKPOINT_SECONDS)[0] == base + 1
        text = P.M.REGISTRY.prometheus_text()
        assert "recovery_checkpoint_seconds" in text

    def test_catch_up_counts_shards_and_lag(self, P, tmp_path):
        reg = P.M.MetricsRegistry()
        with P.LocalCluster(3, replica_n=3, base_path=str(tmp_path)) as c:
            c.enable_gossip()
            rm = c.nodes[2].enable_recovery(registry=reg)
            _lag_node2(P, c)
            rm.catch_up()
            assert reg.value(P.M.METRIC_RECOVERY_CATCHUP_SHARDS) > 0
            h = reg.histogram(P.M.METRIC_RECOVERY_CATCHUP_LAG_MS)
            assert h is not None and h["count"] == 1


# -- the two packages against each other --------------------------------------


def _arrays(P, node, index):
    idx = node.api.holder.index(index)
    return {s: P.export_shard_arrays(idx, s) for s in sorted(idx.shards())}


def _same_arrays(a, b):
    assert sorted(a) == sorted(b)
    for shard in a:
        assert sorted(a[shard]) == sorted(b[shard]), shard
        for key in a[shard]:
            np.testing.assert_array_equal(a[shard][key], b[shard][key],
                                          err_msg=f"{shard} {key}")


def _npz(resp):
    raw = base64.b64decode(resp["npz"])
    with np.load(io.BytesIO(raw)) as z:
        return {k: z[k] for k in z.files}


def test_catch_up_equal_across_packages(tmp_path):
    """The same lag in a 3-node, 3-replica cluster of each package: node
    2's ``lagging`` sets, its catch-up summaries, what a peer ships
    (snapshot arrays, LSN, the tail's records) and its planes after the
    catch-up are the JAX package's; they also equal its peers'."""
    out = []
    for root in (JAX, TORCH):
        P = _pkg(root)
        with P.LocalCluster(3, replica_n=3,
                            base_path=str(tmp_path / root)) as c:
            c.enable_gossip()
            rm = c.nodes[2].enable_recovery()
            _lag_node2(P, c)
            lag = {o: sorted(s) for o, s in sorted(rm.lagging("i").items())}
            before = _arrays(P, c.nodes[2], "i")
            peer, client = c.nodes[0].node, c.nodes[2].client
            snaps = [client.recovery_snapshot(peer, "i", s) for s in (0, 1)]
            tail = client.recovery_wal(peer, "i", 0, 1 << 20)
            records = [r for _lsn, r in P.iter_frames(
                base64.b64decode(tail["frames"]))]
            first = rm.catch_up()
            second = rm.catch_up()
            after = _arrays(P, c.nodes[2], "i")
            _same_arrays(after, _arrays(P, c.nodes[0], "i"))
            _same_arrays(after, _arrays(P, c.nodes[1], "i"))
            answers = [c.nodes[2].query("i", f"Row(f={r})")[0].columns
                       for r in range(4)]
        for s in (first, second):
            s.pop("lag_ms", None)
        out.append({"lag": lag, "before": before, "after": after,
                    "snaps": [(s["lsn"], _npz(s)) for s in snaps],
                    "tail": (tail["last_lsn"], tail["more"],
                             tail["floor_lsn"], repr(records)),
                    "summaries": (first, second), "answers": answers})
    jx, tc = out
    assert jx["lag"] == tc["lag"] and jx["lag"]
    assert jx["summaries"] == tc["summaries"]
    assert jx["summaries"][0]["shards"] > 0
    assert jx["summaries"][1]["shards"] == 0
    assert jx["tail"] == tc["tail"]
    assert jx["answers"] == tc["answers"]
    _same_arrays(jx["before"], tc["before"])
    _same_arrays(jx["after"], tc["after"])
    for (lj, aj), (lt, at) in zip(jx["snaps"], tc["snaps"]):
        assert lj == lt
        _same_arrays({0: aj}, {0: at})


def test_tail_replay_equal_across_packages(tmp_path):
    """Writes that land at the peer between the snapshots of two shards
    ship in the tail: node 2 replays them (through ``scatter_merge`` in
    the port), and its summary and planes are the JAX package's."""
    out = []
    for root in (JAX, TORCH):
        P = _pkg(root)
        with P.LocalCluster(3, replica_n=3,
                            base_path=str(tmp_path / root)) as c:
            c.enable_gossip()
            rm = c.nodes[2].enable_recovery()
            _lag_node2(P, c)
            client = c.nodes[2].client
            snap = client.recovery_snapshot
            calls = []

            def late_writes(node, index, shard, token=None):
                got = snap(node, index, shard, token=token)
                if not calls:
                    for n in c.nodes[:2]:
                        n.api.import_bits(
                            "i", "f", rows=[2, 6, 6],
                            cols=[11, P.SHARD_WIDTH + 12, 13])
                calls.append(shard)
                return got

            client.recovery_snapshot = late_writes
            summary = rm.catch_up()
            summary.pop("lag_ms")
            after = _arrays(P, c.nodes[2], "i")
            _same_arrays(after, _arrays(P, c.nodes[0], "i"))
        out.append((summary, after, calls))
    assert out[0][0] == out[1][0]
    assert out[0][0]["records"] > 0 and out[0][0]["bytes"] > 0
    assert out[0][2] == out[1][2]
    _same_arrays(out[0][1], out[1][1])
