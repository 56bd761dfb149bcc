"""The DAX serverless plane, run once per package, and the two packages'
DAX pieces held against each other.

The ``P`` fixture yields the modules of ``pilosa_tpu`` or of their
``pilosa_tpu_torch`` counterparts; ``P.API``, ``P.Computer`` and
``P.DaxCluster`` build the port's with ``device="cpu"``. Covered:

* every case of ``tests/test_dax.py`` (placement, logging before apply,
  directive regressions, failover from the shared writelog, the poller,
  snapshot compaction and resume, RESET, cold start) and of
  ``tests/test_dax_elastic.py`` (the directive protocol, the
  controller's DIFF / FULL delivery, drop-table resurrection, group
  commit, torn tails, JSONL adoption, the snapshotter, the crash matrix
  over ``DAX_CRASH_SITES``, SWIM liveness, warm handoff, the
  autoscaler, the serving plane, zero cost when off, the
  ``directive_churn`` trigger), once per package;
* across the packages: a writelog and snapshots written by either
  package's ``Computer`` replay in the other's to the same
  ``checksum()``; ``Directive`` wire forms, the ``dax_seeded`` plans and
  the controller's placement are equal.
"""

import copy
import importlib
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

JAX, TORCH = "pilosa_tpu", "pilosa_tpu_torch"


def _load(root: str) -> types.SimpleNamespace:
    m = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    kw = {"device": "cpu"} if root == TORCH else {}
    api_cls = m("api").API
    comp_cls = m("dax.computer").Computer
    cluster_cls = m("dax.harness").DaxCluster
    directive = m("dax.directive")
    recovery = m("storage.recovery")
    return types.SimpleNamespace(
        root=root,
        API=lambda *a, **k: api_cls(*a, **{**kw, **k}),
        Computer=lambda *a, **k: comp_cls(*a, **{**kw, **k}),
        DaxCluster=lambda *a, **k: cluster_cls(*a, **{**kw, **k}),
        Autoscaler=m("dax.autoscale").Autoscaler,
        Controller=m("dax.controller").Controller,
        Directive=directive.Directive,
        METHOD_FULL=directive.METHOD_FULL,
        METHOD_DIFF=directive.METHOD_DIFF,
        METHOD_RESET=directive.METHOD_RESET,
        Snapshotter=m("dax.storage").Snapshotter,
        WriteLogger=m("dax.storage").WriteLogger,
        NodeDownError=m("cluster.client").NodeDownError,
        Node=m("cluster.topology").Node,
        M=m("obs.metrics"),
        MetricsRegistry=m("obs.metrics").MetricsRegistry,
        HealthPlane=m("obs.health").HealthPlane,
        ManualClock=m("sched.clock").ManualClock,
        SHARD_WIDTH=m("shardwidth").SHARD_WIDTH,
        CrashPlan=recovery.CrashPlan,
        SimulatedCrash=recovery.SimulatedCrash,
        CRASH_SITES=recovery.CRASH_SITES,
        STREAM_CRASH_SITES=recovery.STREAM_CRASH_SITES,
        DAX_CRASH_SITES=recovery.DAX_CRASH_SITES,
    )


_PACKAGES = {}


def _pkg(root):
    if root not in _PACKAGES:
        _PACKAGES[root] = _load(root)
    return _PACKAGES[root]


@pytest.fixture(params=[JAX, TORCH], ids=["jax", "torch"])
def P(request):
    return _pkg(request.param)


def _both():
    return _pkg(JAX), _pkg(TORCH)


# the crash sites are the same tuple in both packages
DAX_CRASH_SITES = _pkg(JAX).DAX_CRASH_SITES

SCHEMA = [{"index": "t", "options": {}, "fields": [
    {"name": "f", "options": {"type": "set"}},
    {"name": "n", "options": {"type": "int"}}]}]


# ---------------------------------------------------------------------------
# tests/test_dax.py
# ---------------------------------------------------------------------------

@pytest.fixture
def dax(P, tmp_path):
    c = P.DaxCluster(3, shared_dir=str(tmp_path), snapshot_every=8)
    yield c
    c.close()


def _fill(P, dax, index="t", rows=3, per_shard=40, shards=4):
    W = P.SHARD_WIDTH
    dax.controller.create_table(index, {}, [
        {"name": "f", "options": {"type": "set"}},
        {"name": "n", "options": {"type": "int"}},
    ])
    rng = np.random.default_rng(5)
    oracle = {r: set() for r in range(rows)}
    vals = {}
    for s in range(shards):
        rs, cs = [], []
        for _ in range(per_shard):
            r = int(rng.integers(0, rows))
            c = s * W + int(rng.integers(0, W))
            rs.append(r)
            cs.append(c)
            oracle[r].add(c)
        dax.queryer.import_bits(index, "f", rows=rs, cols=cs)
        vcols = [s * W + i for i in range(10)]
        vvals = [int(rng.integers(-50, 50)) for _ in vcols]
        dax.queryer.import_values(index, "n", cols=vcols, values=vvals)
        for c, v in zip(vcols, vvals):
            vals[c] = v
    return oracle, vals


class TestDaxBasics:
    def test_queries_match_oracle(self, P, dax):
        oracle, vals = _fill(P, dax)
        for r, cols in oracle.items():
            assert dax.queryer.query("t", f"Count(Row(f={r}))")[0] == len(cols)
        assert dax.queryer.query("t", "Sum(field=n)")[0].val == \
            sum(vals.values())

    def test_shards_spread_across_computers(self, P, dax):
        _fill(P, dax)
        owners = {nid for (t, s), nid in dax.controller.assignment().items()}
        assert len(owners) >= 2, "balancer left everything on one node"
        for comp in dax.computers:
            local = comp.api.holder.indexes["t"].shards()
            assigned = {s for (t, s) in comp.assigned if t == "t"}
            assert local <= assigned | {0}

    def test_writes_are_logged_before_apply(self, P, dax, tmp_path):
        _fill(P, dax)
        wl = P.WriteLogger(str(tmp_path))
        assert wl.shards("t"), "writelog is empty"
        total_ops = sum(wl.length("t", s) for s in wl.shards("t"))
        assert total_ops > 0

    def test_directive_version_regression_rejected(self, P, dax):
        _fill(P, dax)
        comp = dax.computers[0]
        v = comp.directive_version
        stale = P.Directive(version=v - 1, schema=[], assigned=[])
        out = comp.apply_directive(stale.to_json())
        assert not out["applied"]
        assert comp.directive_version == v


class TestDaxFailover:
    def test_kill_computer_reassigns_and_data_survives(self, P, dax):
        oracle, vals = _fill(P, dax)
        before = {r: dax.queryer.query("t", f"Count(Row(f={r}))")[0]
                  for r in oracle}
        counts = {}
        for (t, s), nid in dax.controller.assignment().items():
            counts[nid] = counts.get(nid, 0) + 1
        victim = max(counts, key=counts.get)
        vi = next(i for i, c in enumerate(dax.computers)
                  if c.node.id == victim)
        dax.kill(vi)
        for key, nid in dax.controller.assignment().items():
            assert nid != victim
        after = {r: dax.queryer.query("t", f"Count(Row(f={r}))")[0]
                 for r in oracle}
        assert after == before, "data lost in failover"
        assert dax.queryer.query("t", "Sum(field=n)")[0].val == \
            sum(vals.values())
        newcol = 7 * P.SHARD_WIDTH + 1
        dax.queryer.query("t", f"Set({newcol}, f=0)")
        assert dax.queryer.query("t", "Count(Row(f=0))")[0] == \
            before[0] + 1

    def test_poller_detects_silent_death(self, P, dax):
        oracle, _ = _fill(P, dax)
        victim = dax.computers[1].node.id
        dax.silence(1)
        assert victim in dax.controller.live_ids()
        dax.controller.last_seen[victim] -= 3600
        for comp in dax.computers:
            if comp.node.id != victim:
                dax.controller.checkin(comp.node.id)
        newly = dax.controller.poll()
        assert victim in newly
        assert victim not in dax.controller.live_ids()
        for r, cols in oracle.items():
            assert dax.queryer.query("t", f"Count(Row(f={r}))")[0] == len(cols)

    def test_snapshot_compaction_and_resume(self, P, dax, tmp_path):
        dax.controller.create_table("s", {}, [
            {"name": "f", "options": {"type": "set"}}])
        for k in range(20):  # snapshot_every=8 -> snapshots exist
            dax.queryer.query("s", f"Set({k}, f=1)")
        snap = P.Snapshotter(str(tmp_path))
        assert snap.latest("s", 0) is not None, "no snapshot written"
        version, arrays = snap.latest("s", 0)
        assert version >= 8
        owner = dax.controller.assignment()[("s", 0)]
        oi = next(i for i, c in enumerate(dax.computers)
                  if c.node.id == owner)
        dax.kill(oi)
        assert dax.queryer.query("s", "Count(Row(f=1))")[0] == 20

    def test_reset_directive_rebuilds_node(self, P, dax):
        oracle, _ = _fill(P, dax)
        comp = next(c for c in dax.computers
                    if any(t == "t" for t, s in c.assigned))
        d = P.Directive(version=comp.directive_version, method="reset",
                        schema=[dict(t) for t in dax.controller.schema],
                        assigned=sorted(comp.assigned))
        comp.apply_directive(d.to_json())
        for r, cols in oracle.items():
            assert dax.queryer.query("t", f"Count(Row(f={r}))")[0] == len(cols)


class TestDaxColdStart:
    def test_controller_recovers_shards_from_logs(self, P, tmp_path):
        c1 = P.DaxCluster(2, shared_dir=str(tmp_path))
        try:
            oracle, _ = _fill(P, c1)
        finally:
            c1.close()
        c2 = P.DaxCluster(2, shared_dir=str(tmp_path))
        try:
            c2.controller.schema = copy.deepcopy(SCHEMA)
            c2.controller.recover_from_logs()
            for r, cols in oracle.items():
                assert c2.queryer.query("t", f"Count(Row(f={r}))")[0] == \
                    len(cols)
        finally:
            c2.close()


# ---------------------------------------------------------------------------
# tests/test_dax_elastic.py
# ---------------------------------------------------------------------------

def _full(P, version, shards, hot=()):
    return P.Directive(
        version=version, method=P.METHOD_FULL,
        schema=[dict(t) for t in SCHEMA],
        assigned=[("t", s) for s in shards],
        hot=list(hot)).to_json()


def _ops(W, k=90, seed=3):
    """Deterministic idempotent workload: set bits + int values over two
    shards of width ``W``."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(k):
        shard = int(rng.integers(0, 2))
        col = shard * W + int(rng.integers(0, 500))
        if i % 4 == 3:
            out.append(("vals", [col], [int(rng.integers(-40, 40))]))
        else:
            out.append(("bits", [int(rng.integers(0, 6))], [col]))
    return out


def _apply_ops(P, target, ops, start=0):
    """Apply ops[start:]; returns the index of the first op that crashed
    (None = all applied)."""
    for i in range(start, len(ops)):
        kind, a, b = ops[i]
        try:
            if kind == "bits":
                target.import_bits("t", "f", rows=a, cols=b)
            else:
                target.import_values("t", "n", cols=a, values=b)
        except P.SimulatedCrash:
            return i
    return None


def _oracle(P, ops):
    api = P.API()
    api.create_index("t", {})
    api.create_field("t", "f", {"type": "set"})
    api.create_field("t", "n", {"type": "int"})
    _apply_ops(P, api, ops)
    return api.checksum()


class TestDirectiveProtocol:
    def test_reset_wipes_local_state(self, P, tmp_path):
        comp = P.Computer("c0", str(tmp_path))
        comp.apply_directive(_full(P, 1, [0]))
        comp.import_bits("t", "f", rows=[1], cols=[2])
        assert comp.api.holder.indexes
        out = comp.apply_directive(
            P.Directive(version=2, method=P.METHOD_RESET,
                        schema=[], assigned=[]).to_json())
        assert out["applied"]
        assert not comp.api.holder.indexes
        assert comp.assigned == set()

    def test_diff_applies_delta_without_schema(self, P, tmp_path):
        comp = P.Computer("c0", str(tmp_path))
        comp.apply_directive(_full(P, 1, [0]))
        out = comp.apply_directive(P.Directive(
            version=2, method=P.METHOD_DIFF, base_version=1,
            add=[("t", 1)], remove=[("t", 0)],
            assigned=[("t", 1)], schema_changed=False).to_json())
        assert out["applied"]
        assert comp.assigned == {("t", 1)}
        assert "t" in comp.api.holder.indexes

    def test_diff_after_missed_version_asks_resync(self, P, tmp_path):
        comp = P.Computer("c0", str(tmp_path))
        comp.apply_directive(_full(P, 1, [0]))
        out = comp.apply_directive(P.Directive(
            version=3, method=P.METHOD_DIFF, base_version=2,
            add=[("t", 1)], assigned=[("t", 0), ("t", 1)],
            schema_changed=False).to_json())
        assert out == {"version": 1, "applied": False, "resync": True}
        out = comp.apply_directive(_full(P, 3, [0, 1]))
        assert out["applied"]
        assert comp.assigned == {("t", 0), ("t", 1)}

    def test_stale_version_rejected(self, P, tmp_path):
        comp = P.Computer("c0", str(tmp_path))
        comp.apply_directive(_full(P, 5, [0]))
        out = comp.apply_directive(_full(P, 4, [0, 1]))
        assert not out["applied"]
        assert comp.assigned == {("t", 0)}


class _FakeComp:
    """Directive sink with scriptable failure for controller tests."""

    def __init__(self, P):
        self.P = P
        self.directives = []
        self.fail = False
        self.resync_once = False

    def apply_directive(self, d):
        if self.fail:
            raise self.P.NodeDownError("down")
        if self.resync_once and d["method"] == self.P.METHOD_DIFF:
            self.resync_once = False
            return {"version": d["version"], "applied": False,
                    "resync": True}
        self.directives.append(d)
        return {"version": d["version"], "applied": True}


class TestControllerDelivery:
    def _controller(self, P, tmp_path, registry=None):
        return P.Controller(str(tmp_path), sleep=lambda s: None,
                            directive_backoff_s=0.0,
                            registry=registry or P.MetricsRegistry())

    def test_second_push_is_diff(self, P, tmp_path):
        ctl = self._controller(P, tmp_path)
        a = _FakeComp(P)
        ctl.register(P.Node(id="a", uri=""), computer=a)
        ctl.create_table("t", {}, SCHEMA[0]["fields"])
        ctl.ensure_shard("t", 0)
        methods = [d["method"] for d in a.directives]
        assert methods[0] == P.METHOD_FULL
        assert P.METHOD_DIFF in methods[1:]
        last = a.directives[-1]
        assert last["method"] == P.METHOD_DIFF
        assert last["add"] == [["t", 0]]
        assert last["schemaChanged"] is False
        assert last["schema"] == []

    def test_resync_falls_back_to_full(self, P, tmp_path):
        reg = P.MetricsRegistry()
        ctl = self._controller(P, tmp_path, registry=reg)
        a = _FakeComp(P)
        ctl.register(P.Node(id="a", uri=""), computer=a)
        ctl.create_table("t", {}, SCHEMA[0]["fields"])
        a.resync_once = True
        ctl.ensure_shard("t", 0)
        assert a.directives[-1]["method"] == P.METHOD_FULL
        assert a.directives[-1]["assigned"] == [["t", 0]]
        assert reg.value(P.M.METRIC_DAX_FULL_RESYNCS) == 1

    def test_mid_batch_failure_converges_no_double_delivery(self, P,
                                                             tmp_path):
        ctl = self._controller(P, tmp_path)
        a, b = _FakeComp(P), _FakeComp(P)
        ctl.register(P.Node(id="a", uri=""), computer=a)
        ctl.register(P.Node(id="b", uri=""), computer=b)
        ctl.create_table("t", {}, SCHEMA[0]["fields"])
        for s in range(8):
            ctl.ensure_shard("t", s)
        assert {nid for nid in ctl.assignment().values()} == {"a", "b"}
        b.fail = True
        ctl.create_field("t", "extra", {"type": "set"})
        assert "b" in ctl.dead
        assert set(ctl.assignment().values()) == {"a"}
        owned = {tuple(x) for x in a.directives[-1]["assigned"]}
        assert owned == {("t", s) for s in range(8)}
        versions = [d["version"] for d in a.directives]
        assert len(versions) == len(set(versions)), \
            "a directive version was delivered twice to the same node"

    def test_rebalance_moves_shards_to_new_node(self, P, tmp_path):
        ctl = self._controller(P, tmp_path)
        a = _FakeComp(P)
        ctl.register(P.Node(id="a", uri=""), computer=a)
        ctl.create_table("t", {}, SCHEMA[0]["fields"])
        for s in range(12):
            ctl.ensure_shard("t", s)
        b = _FakeComp(P)
        ctl.register(P.Node(id="b", uri=""), computer=b)
        moved = ctl.rebalance()
        assert moved > 0
        owners = set(ctl.assignment().values())
        assert owners == {"a", "b"}
        removed = {tuple(x) for d in a.directives
                   if d["method"] == P.METHOD_DIFF
                   for x in d.get("remove", [])}
        b_owned = {k for k, v in ctl.assignment().items() if v == "b"}
        assert b_owned <= removed | set()


class TestDropTableResurrection:
    def test_recreate_after_drop_is_empty(self, P, tmp_path):
        c = P.DaxCluster(2, shared_dir=str(tmp_path))
        try:
            c.controller.create_table("t", {}, SCHEMA[0]["fields"])
            c.queryer.import_bits("t", "f", rows=[1, 1, 1],
                                  cols=[5, 10, P.SHARD_WIDTH + 3])
            assert c.queryer.query("t", "Count(Row(f=1))")[0] == 3
            c.controller.drop_table("t")
            assert c.controller.wl.tables() == []
            c.controller.create_table("t", {}, SCHEMA[0]["fields"])
            assert c.queryer.query("t", "Count(Row(f=1))")[0] == 0
            assert c.controller.wl.shards("t") == []
        finally:
            c.close()


class TestGroupCommit:
    def test_one_fsync_per_shard_not_per_op(self, P, tmp_path, monkeypatch):
        calls = {"n": 0}
        real = os.fsync

        def counting(fd):
            calls["n"] += 1
            return real(fd)

        pql = "".join(f"Set({i}, f=1)" for i in range(60))
        comp = P.Computer("c0", str(tmp_path / "batch"),
                          snapshot_every=10_000)
        comp.apply_directive(_full(P, 1, [0]))
        monkeypatch.setattr(os, "fsync", counting)
        comp.query_remote("t", pql, shards=[0])
        batch_fsyncs = calls["n"]
        assert batch_fsyncs <= 2, \
            f"group commit issued {batch_fsyncs} fsyncs for one request"
        monkeypatch.setattr(os, "fsync", real)
        comp2 = P.Computer("c1", str(tmp_path / "always"), sync="always",
                           snapshot_every=10_000)
        comp2.apply_directive(_full(P, 1, [0]))
        monkeypatch.setattr(os, "fsync", counting)
        calls["n"] = 0
        comp2.query_remote("t", pql, shards=[0])
        assert calls["n"] >= 60
        assert batch_fsyncs * 10 < calls["n"]
        assert len(list(comp.wl.replay("t", 0, 0))) == \
            len(list(comp2.wl.replay("t", 0, 0))) == 60

    def test_torn_tail_stops_replay(self, P, tmp_path):
        wl = P.WriteLogger(str(tmp_path))
        for i in range(10):
            wl.append("t", 0, {"k": "bits", "f": "f", "r": [i], "c": [i]})
        wl.commit("t", 0)
        wl.close()
        d = tmp_path / "wl" / "t"
        seg = sorted(p for p in os.listdir(d) if p.startswith("0."))[-1]
        path = d / seg
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) - 3)
        wl2 = P.WriteLogger(str(tmp_path))
        ops = list(wl2.replay("t", 0, 0))
        assert len(ops) == 9
        assert [op["r"][0] for op in ops] == list(range(9))

    def test_adopts_seed_era_jsonl(self, P, tmp_path):
        d = tmp_path / "wl" / "t"
        os.makedirs(d)
        with open(d / "0.jsonl", "w") as f:
            for i in range(3):
                f.write(json.dumps({"k": "bits", "f": "f",
                                    "r": [i], "c": [i]}) + "\n")
        wl = P.WriteLogger(str(tmp_path))
        assert wl.shards("t") == [0]
        ops = list(wl.replay("t", 0, 0))
        assert len(ops) == 3
        assert wl.length("t", 0) == 3
        assert not os.path.exists(d / "0.jsonl")
        wl.append("t", 0, {"k": "bits", "f": "f", "r": [9], "c": [9]})
        wl.commit("t", 0)
        assert wl.length("t", 0) == 4


class TestSnapshotter:
    def test_prune_skips_newer_versions(self, P, tmp_path):
        s = P.Snapshotter(str(tmp_path))
        s.write("t", 0, 5, {"a": np.array([1, 2, 3])})
        s.write("t", 0, 3, {"a": np.array([9])})
        assert s.latest_version("t", 0) == 5
        v, arrays = s.latest("t", 0)
        assert v == 5 and list(arrays["a"]) == [1, 2, 3]
        s.write("t", 0, 6, {"a": np.array([4])})
        assert s._versions("t", 0) == [6]


class TestCrashMatrix:
    """Every dax.* kill point: the next owner resumes bit-identical to
    an uncrashed oracle once the unacked suffix is retried."""

    def _run(self, P, dirpath, plan, ops):
        comp = P.Computer("c0", dirpath, snapshot_every=8, crash_plan=plan)
        start = 0
        try:
            comp.apply_directive(_full(P, 1, [0, 1]))
        except P.SimulatedCrash:
            start = 0
        else:
            start = _apply_ops(P, comp, ops)
        comp2 = P.Computer("c1", dirpath, snapshot_every=8)
        comp2.apply_directive(_full(P, 2, [0, 1]))
        if start is not None:
            assert _apply_ops(P, comp2, ops, start) is None
        return comp2.api.checksum()

    @pytest.mark.parametrize("site", DAX_CRASH_SITES)
    @pytest.mark.parametrize("at", [1, 2])
    def test_kill_point_resumes_bit_identical(self, P, tmp_path, site, at):
        ops = _ops(P.SHARD_WIDTH)
        golden = _oracle(P, ops)
        plan = P.CrashPlan().kill(site, at=at)
        got = self._run(P, str(tmp_path), plan, ops)
        assert got == golden

    def test_env_seeded_plan(self, P, tmp_path):
        seed = os.environ.get("PILOSA_TPU_CRASH_SEED", "lane-default")
        plan = P.CrashPlan.dax_seeded(seed)
        assert plan._arms == P.CrashPlan.dax_seeded(seed)._arms
        assert all(s in P.DAX_CRASH_SITES for s in plan._arms)
        ops = _ops(P.SHARD_WIDTH)
        golden = _oracle(P, ops)
        assert self._run(P, str(tmp_path), plan, ops) == golden

    def test_sites_disjoint_from_other_lanes(self, P):
        assert not set(P.DAX_CRASH_SITES) & set(P.CRASH_SITES)
        assert not set(P.DAX_CRASH_SITES) & set(P.STREAM_CRASH_SITES)


class TestMembershipLiveness:
    def test_silence_detected_via_membership(self, P, tmp_path):
        clock = P.ManualClock()
        c = P.DaxCluster(3, shared_dir=str(tmp_path), membership=True,
                         clock=clock)
        try:
            c.controller.create_table("t", {}, SCHEMA[0]["fields"])
            cols = [s * P.SHARD_WIDTH + i for s in range(4)
                    for i in range(20)]
            c.queryer.import_bits("t", "f", rows=[1] * len(cols), cols=cols)
            victim = 1
            vid = c.computers[victim].node.id
            c.silence(victim)
            for _ in range(150):
                c.step()
                clock.advance(0.4)
                if vid in c.controller.dead:
                    break
            assert vid in c.controller.dead, \
                "membership never confirmed the silenced node down"
            assert all(v != vid for v in c.controller.assignment().values())
            assert c.queryer.query("t", "Count(Row(f=1))")[0] == len(cols)
        finally:
            c.close()


class TestWarmHandoff:
    def test_prewarm_builds_stacks_before_ack(self, P, tmp_path):
        seeder = P.Computer("c0", str(tmp_path))
        seeder.apply_directive(_full(P, 1, [0, 1]))
        _apply_ops(P, seeder, _ops(P.SHARD_WIDTH))
        reg = P.MetricsRegistry()
        warm = P.Computer("c1", str(tmp_path), registry=reg)
        out = warm.apply_directive(_full(P, 2, [0, 1],
                                         hot=[("t", "f"), ("t", "n")]))
        assert out["applied"]
        assert reg.value(P.M.METRIC_DAX_PREWARM_STACKS) > 0
        assert reg.value(P.M.METRIC_DAX_REPLAY_OPS) > 0

    def test_handoff_off_skips_prewarm(self, P, tmp_path):
        seeder = P.Computer("c0", str(tmp_path))
        seeder.apply_directive(_full(P, 1, [0, 1]))
        _apply_ops(P, seeder, _ops(P.SHARD_WIDTH))
        reg = P.MetricsRegistry()
        cold = P.Computer("c1", str(tmp_path), warm_handoff=False,
                          registry=reg)
        assert cold.apply_directive(
            _full(P, 2, [0, 1], hot=[("t", "f")]))["applied"]
        assert reg.value(P.M.METRIC_DAX_PREWARM_STACKS) == 0


class TestAutoscaler:
    def _scaler(self, P, probes, clock, **kw):
        state = {"pool": 2}

        def up():
            state["pool"] += 1
            return state["pool"]

        def down():
            state["pool"] -= 1
            return state["pool"]

        scaler = P.Autoscaler(
            probes_fn=lambda: probes, scale_up=up, scale_down=down,
            pool_size=lambda: state["pool"], min_nodes=1, max_nodes=4,
            cooldown_s=10.0, queue_high=16, p99_high_ms=250.0,
            settle_ticks=3, clock=clock, registry=P.MetricsRegistry(), **kw)
        return scaler, state

    def test_scales_up_on_pressure_with_cooldown(self, P):
        clock = P.ManualClock()
        probes = {"queue_depth": 99, "leg_p99_ms": 10.0}
        scaler, state = self._scaler(P, probes, clock)
        assert scaler.tick() == "up"
        assert state["pool"] == 3
        assert scaler.tick() is None
        clock.advance(11.0)
        assert scaler.tick() == "up"
        assert state["pool"] == 4
        clock.advance(11.0)
        assert scaler.tick() is None

    def test_scales_down_only_after_settle(self, P):
        clock = P.ManualClock()
        probes = {"queue_depth": 0, "leg_p99_ms": 1.0}
        scaler, state = self._scaler(P, probes, clock)
        assert scaler.tick() is None
        assert scaler.tick() is None
        assert scaler.tick() == "down"
        assert state["pool"] == 1
        clock.advance(11.0)
        for _ in range(5):
            scaler.tick()
        assert state["pool"] == 1

    def test_p99_alone_triggers(self, P):
        clock = P.ManualClock()
        probes = {"queue_depth": 0, "leg_p99_ms": 900.0}
        scaler, state = self._scaler(P, probes, clock)
        assert scaler.tick() == "up"


class TestServingPlane:
    def test_cached_reads_and_write_invalidation(self, P, tmp_path):
        c = P.DaxCluster(2, shared_dir=str(tmp_path), serving=True)
        try:
            c.controller.create_table("t", {}, SCHEMA[0]["fields"])
            c.queryer.query("t", "Set(5, f=1)")
            assert c.queryer.query("t", "Count(Row(f=1))")[0] == 1
            hits0 = c.queryer.cache.stats()["hits"]
            assert c.queryer.query("t", "Count(Row(f=1))")[0] == 1
            assert c.queryer.cache.stats()["hits"] == hits0 + 1
            c.queryer.query("t", "Set(9, f=1)")
            assert c.queryer.query("t", "Count(Row(f=1))")[0] == 2
            assert "f" in c.controller._hot.get("t", [])
        finally:
            c.close()

    def test_probe_reports_serving_pressure(self, P, tmp_path):
        c = P.DaxCluster(2, shared_dir=str(tmp_path), serving=True)
        try:
            c.controller.create_table("t", {}, SCHEMA[0]["fields"])
            c.queryer.query("t", "Set(5, f=1)")
            c.queryer.query("t", "Count(Row(f=1))")
            p = c.queryer.probe()
            assert p["serving"] is True
            assert p["leg_p99_ms"] > 0.0
            cp = c.controller.probe()
            assert cp["version"] >= 1
            assert cp["directive_age_s"] >= 0.0
        finally:
            c.close()

    def test_scale_up_mid_flight_keeps_results(self, P, tmp_path):
        c = P.DaxCluster(2, shared_dir=str(tmp_path), serving=True,
                         snapshot_every=8)
        try:
            c.controller.create_table("t", {}, SCHEMA[0]["fields"])
            cols = [s * P.SHARD_WIDTH + i for s in range(4)
                    for i in range(25)]
            c.queryer.import_bits("t", "f", rows=[2] * len(cols), cols=cols)
            assert c.queryer.query("t", "Count(Row(f=2))")[0] == len(cols)
            before = len(c.controller.live_ids())
            c.scale_up()
            assert len(c.controller.live_ids()) == before + 1
            new_id = c.computers[-1].node.id
            assert new_id in set(c.controller.assignment().values()), \
                "rebalance moved nothing to the new node"
            assert c.queryer.query("t", "Count(Row(f=2))")[0] == len(cols)
        finally:
            c.close()


class TestZeroCostOff:
    def test_dax_not_imported_by_classic_paths(self, P):
        code = (f"import {P.root}.api, {P.root}.cluster.node, "
                f"{P.root}.server.http, sys; "
                f"print(any(m.startswith('{P.root}.dax') "
                "for m in sys.modules))")
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        out = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip() == "False"

    def test_no_dax_metrics_without_plane(self, P):
        reg = P.MetricsRegistry()
        assert all(not name.startswith("dax_")
                   for (name, _labels) in list(reg._counters)
                   + list(reg._gauges))


class TestObsWiring:
    def test_directive_churn_flight_trigger(self, P, tmp_path):
        clock = P.ManualClock()
        reg = P.MetricsRegistry()
        hp = P.HealthPlane(registry=reg, clock=clock, interval_ms=100.0,
                           directive_churn_bumps=4.0)
        c = P.DaxCluster(2, shared_dir=str(tmp_path), http=False,
                         clock=clock)
        try:
            hp.attach_dax(queryer=c.queryer, controller=c.controller)
            probe = c.controller.probe()
            assert probe["enabled"] and "recent_directive_bumps" in probe
            hp.timeline.sample()
            assert hp.flight.bundles() == []
            clock.advance(1.0)
            c.controller.create_table("t", {}, SCHEMA[0]["fields"])
            c.controller.create_field("t", "g", {"type": "set"})
            c.controller.create_field("t", "h", {"type": "set"})
            hp.timeline.sample()
            bundles = hp.flight.bundles()
            assert [b["trigger"] for b in bundles] == ["directive_churn"]
            assert "directive bumps" in bundles[0]["reason"]
        finally:
            c.close()


# ---------------------------------------------------------------------------
# the two packages against each other
# ---------------------------------------------------------------------------

def _pairs():
    j, t = _both()
    return [(j, t), (t, j)]


@pytest.mark.parametrize("order", ["jax_to_torch", "torch_to_jax"])
def test_writelog_and_snapshots_replay_across_packages(tmp_path, order):
    """A computer of one package writes the shared dir (snapshots every 8
    ops, so the resume is snapshot + tail); a computer of the other
    package resumes every shard from it to the oracle's checksum."""
    src, dst = _pairs()[0 if order == "jax_to_torch" else 1]
    assert src.SHARD_WIDTH == dst.SHARD_WIDTH
    ops = _ops(src.SHARD_WIDTH)
    writer = src.Computer("w", str(tmp_path), snapshot_every=8)
    writer.apply_directive(_full(src, 1, [0, 1]))
    assert _apply_ops(src, writer, ops) is None
    writer.query_remote("t", "Set(7, f=5)Clear(7, f=5)Set(9, f=4)",
                        shards=[0])
    writer.close()
    snaps = src.Snapshotter(str(tmp_path))
    assert snaps.latest_version("t", 0) > 0 and \
        snaps.latest_version("t", 1) > 0
    reader = dst.Computer("r", str(tmp_path), snapshot_every=8)
    assert reader.apply_directive(_full(dst, 1, [0, 1]))["applied"]
    want = writer.api.checksum()
    assert reader.api.checksum() == want
    oracle = dst.API()
    oracle.create_index("t", {})
    oracle.create_field("t", "f", {"type": "set"})
    oracle.create_field("t", "n", {"type": "int"})
    _apply_ops(dst, oracle, ops)
    oracle.query("t", "Set(7, f=5)Clear(7, f=5)Set(9, f=4)")
    assert oracle.checksum() == want
    reader.close()


def test_writelog_bytes_equal_across_packages(tmp_path):
    """The same ops through each package's WriteLogger leave the same
    segment bytes on disk."""
    j, t = _both()
    blobs = []
    for P in (j, t):
        root = tmp_path / P.root
        wl = P.WriteLogger(str(root), segment_bytes=256)
        for op in [{"k": "bits", "f": "f", "r": [i], "c": [i * 3]}
                   for i in range(12)] + [{"k": "pql", "q": "Set(1, f=2)"}]:
            wl.append("t", 3, op)
        wl.commit("t", 3)
        wl.prune("t", 3, 5)
        wl.close()
        d = root / "wl" / "t"
        blobs.append({p: (d / p).read_bytes() for p in sorted(os.listdir(d))})
    assert blobs[0] == blobs[1]
    assert len(blobs[0]) > 1


def test_directive_wire_form_equal_across_packages():
    j, t = _both()
    cases = [
        dict(version=3, method="full", schema=copy.deepcopy(SCHEMA),
             assigned=[("t", 0), ("t", 5)], hot=[("t", "f")]),
        dict(version=9, method="diff", base_version=7,
             add=[("t", 2)], remove=[("t", 0)], assigned=[("t", 2)],
             schema_changed=False, hot=[]),
        dict(version=0, method="reset", schema=[], assigned=[]),
    ]
    for kw in cases:
        dj, dt = j.Directive(**kw).to_json(), t.Directive(**kw).to_json()
        assert dj == dt
        assert json.dumps(dj, sort_keys=True) == \
            json.dumps(dt, sort_keys=True)
        rj = j.Directive.from_json(dt).to_json()
        rt = t.Directive.from_json(dj).to_json()
        assert rj == rt == dj
        assert t.Directive.from_json(dj).assigned_by_table() == \
            j.Directive.from_json(dt).assigned_by_table()


def test_dax_seeded_plans_and_placement_equal_across_packages(tmp_path):
    j, t = _both()
    for seed in (0, 1, 7, "lane-default", "x"):
        assert j.CrashPlan.dax_seeded(seed)._arms == \
            t.CrashPlan.dax_seeded(seed)._arms
    assigns = []
    for P in (j, t):
        ctl = P.Controller(str(tmp_path / P.root), sleep=lambda s: None,
                           registry=P.MetricsRegistry())
        for nid in ("compute0", "compute1", "compute2"):
            ctl.register(P.Node(id=nid, uri=""), computer=_FakeComp(P))
        ctl.create_table("t", {}, SCHEMA[0]["fields"])
        for s in range(24):
            ctl.ensure_shard("t", s)
        ctl.mark_dead("compute1")
        ctl.register(P.Node(id="compute3", uri=""), computer=_FakeComp(P))
        ctl.rebalance()
        assigns.append((ctl.assignment(), ctl.version))
    assert assigns[0] == assigns[1]


def test_computer_device_reaches_every_layer(tmp_path):
    """The port's fleet carries ``device`` to the queryer's holder, every
    computer (spawned, scaled up and RESET) and their APIs."""
    t = _pkg(TORCH)
    c = t.DaxCluster(2, shared_dir=str(tmp_path))
    try:
        c.controller.create_table("t", {}, SCHEMA[0]["fields"])
        c.queryer.import_bits("t", "f", rows=[1, 2],
                              cols=[3, t.SHARD_WIDTH + 4])
        c.scale_up()
        comp = c.computers[0]
        comp.apply_directive(t.Directive(
            version=comp.directive_version + 1, method=t.METHOD_RESET,
            schema=[dict(x) for x in c.controller.schema],
            assigned=sorted(comp.assigned)).to_json())
        devs = {str(c.device), str(c.queryer.device),
                str(c.queryer.holder.device)}
        for comp in c.computers:
            devs |= {str(comp.device), str(comp.api.device),
                     str(comp.api.holder.device)}
        assert devs == {"cpu"}
        assert c.queryer.query("t", "Count(Row(f=1))")[0] == 1
    finally:
        c.close()


@pytest.mark.parametrize("root", [JAX, TORCH])
def test_replay_skips_an_op_that_failed_its_client(tmp_path, root):
    """A logged op that fails application (a field the schema lacks)
    is skipped on replay in both packages, and the ops after it apply."""
    P = _pkg(root)
    wl = P.WriteLogger(str(tmp_path))
    for q in ("Set(1, f=1)", "Set(2, nope=1)", "Set(3, f=1)"):
        wl.append("t", 0, {"k": "pql", "q": q})
    wl.commit("t", 0)
    wl.close()
    comp = P.Computer("c0", str(tmp_path))
    try:
        assert comp.apply_directive(_full(P, 1, [0]))["applied"]
        assert comp.api.query("t", "Count(Row(f=1))") == [2]
    finally:
        comp.close()


def test_replay_device_error_fails_the_directive(tmp_path, monkeypatch):
    """In the port only an application error is skipped on replay: an
    error of the card (here a stand-in ``RuntimeError`` from the import)
    fails the directive unacked, and the next push replays every op."""
    t = _pkg(TORCH)
    wl = t.WriteLogger(str(tmp_path))
    wl.append("t", 0, {"k": "bits", "f": "f", "r": [1, 1], "c": [5, 6],
                       "x": 0})
    wl.commit("t", 0)
    wl.close()
    comp = t.Computer("c0", str(tmp_path))
    try:
        real = comp.api.import_bits

        def fail(*a, **k):
            raise RuntimeError("CUDA error: an illegal memory access")

        monkeypatch.setattr(comp.api, "import_bits", fail)
        with pytest.raises(RuntimeError, match="CUDA error"):
            comp.apply_directive(_full(t, 1, [0]))
        assert comp.directive_version == -1
        monkeypatch.setattr(comp.api, "import_bits", real)
        assert comp.apply_directive(_full(t, 1, [0]))["applied"]
        assert comp.api.query("t", "Count(Row(f=1))") == [2]
    finally:
        comp.close()


def test_holder_resident_bytes_counts_one_holders_stacks(tmp_path):
    """``stacked.holder_resident_bytes`` is the budget's bytes of one
    holder's stacks: another holder's do not count, and a holder whose
    stacks are released holds none."""
    from pilosa_tpu_torch.core import stacked as STK
    from pilosa_tpu_torch.storage.recovery import abandon_holder

    t = _pkg(TORCH)
    apis = [t.API(), t.API()]
    for i, api in enumerate(apis):
        api.create_index("t")
        api.create_field("t", "f")
        api.import_bits("t", "f", rows=[1, 2, 3][:i + 1],
                        cols=[4, 5, t.SHARD_WIDTH + 6][:i + 1])
        assert api.query("t", "Count(Row(f=1))") == [1]
    got = [STK.holder_resident_bytes(a.holder) for a in apis]
    assert all(b > 0 for b in got)
    abandon_holder(apis[1].holder)
    assert STK.holder_resident_bytes(apis[1].holder) == 0
    assert STK.holder_resident_bytes(apis[0].holder) == got[0]
    abandon_holder(apis[0].holder)
