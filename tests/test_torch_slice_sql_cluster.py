"""The SQL fan-out slice as a whole on the CPU: the Star Schema Benchmark
over a 3-node cluster of each package (``bench.py`` config 23's
cluster phase, cut to 3,000 lineorder rows).

* ``ssb.generate(3_000, seed=7)`` loads through ``ssb.load`` on the
  coordinator's ``sql`` of ``pilosa_tpu_torch.cluster.LocalCluster(3,
  replica_n=2, device="cpu")`` and of ``pilosa_tpu.cluster.LocalCluster(3,
  replica_n=2)``; every table's shards sit on their owners and their
  replicas, and nowhere else, in both.
* All 13 queries, from the coordinator and from a node that is not the
  coordinator, equal the oracle under ``ssb.verify`` and equal the JAX
  cluster's rows (values and cell types), with the same plan operators
  and the same ``sql_fanout_rows_total`` and
  ``sql_join_broadcast_bytes_total`` deltas; at least one query plans a
  ``FanoutAggOp``.
* INSERT and DELETE through a node that is not the coordinator route to
  the shard owners and replicas, and every node reads the result back.

Tolerance: exact. SSB's answers are integer sums; no float is compared.
"""

import numpy as np
import pytest

from pilosa_tpu.cluster import LocalCluster as JaxCluster
from pilosa_tpu.loadgen import ssb as jssb
from pilosa_tpu.obs import metrics as JaxM
from pilosa_tpu.sql import SQLEngine as JaxEngine
from pilosa_tpu_torch.cluster import LocalCluster as TorchCluster
from pilosa_tpu_torch.loadgen import ssb as tssb
from pilosa_tpu_torch.obs import metrics as TorchM
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH
from pilosa_tpu_torch.sql import SQLEngine as TorchEngine

ROWS, SEED = 3_000, 7
QIDS = list(tssb.QUERIES)
_COUNTERS = ("sql_fanout_rows_total", "sql_join_broadcast_bytes_total")
_TABLES = ("ssb_date", "customer", "supplier", "part", "lineorder")


def _typed(v):
    if isinstance(v, list):
        return [_typed(x) for x in v]
    return (type(v).__name__, v)


def _counts(M):
    c = M.REGISTRY.snapshot()["counters"]
    return [c.get(k, 0) for k in _COUNTERS]


def _ops(op):
    d = []

    def walk(n):
        d.append(n["op"])
        for ch in n.get("children", []):
            walk(ch)
    walk(op.plan_json())
    return d


@pytest.fixture(scope="module")
def data():
    return tssb.generate(ROWS, seed=SEED)


@pytest.fixture(scope="module")
def clusters(data):
    jc = JaxCluster(3, replica_n=2)
    tc = TorchCluster(3, replica_n=2, device="cpu")
    try:
        jssb.load(jc.coordinator.sql, jssb.generate(ROWS, seed=SEED))
        tssb.load(tc.coordinator.sql, data)
        yield {"jax": jc, "torch": tc}
    finally:
        jc.close()
        tc.close()


@pytest.fixture(scope="module")
def oracles(data):
    return {qid: tssb.oracle(data, qid) for qid in QIDS}


def test_generate_equals_the_jax_package(data):
    j = jssb.generate(ROWS, seed=SEED)
    for t in ("date", "customer", "supplier", "part", "lineorder"):
        ours, theirs = getattr(data, t), getattr(j, t)
        assert list(ours) == list(theirs)
        for col in ours:
            assert np.array_equal(np.asarray(ours[col]),
                                  np.asarray(theirs[col])), (t, col)


def _holding(c, table, shard):
    """The nodes whose own engine holds records of ``shard``."""
    return sorted(n.node.id for n in c.nodes if n.api.query(
        table, "Count(All())", shards=[shard])[0])


@pytest.mark.parametrize("table", _TABLES)
def test_shards_sit_on_their_owners(clusters, table):
    """Each shard of each table is held by its owner and its replica
    (replica_n=2) and by no other node, in both packages alike."""
    held = {}
    for name, c in clusters.items():
        snap = c.coordinator.snapshot()
        shards = set()
        for n in c.nodes:
            shards |= n.holder.index(table).shards()
        got = {}
        for s in sorted(shards):
            owners = sorted(n.id for n in snap.shard_nodes(table, s))
            got[s] = (owners, _holding(c, table, s))
            assert got[s][1] == owners and len(owners) == 2, (name, s)
        held[name] = got
    assert held["jax"] == held["torch"]
    if table == "lineorder":
        assert list(held["torch"]) == [0]  # every id lies in shard 0


@pytest.mark.parametrize("node", [0, 1], ids=["coordinator", "node1"])
@pytest.mark.parametrize("qid", QIDS)
def test_query_equals_oracle_and_jax(clusters, data, oracles, qid, node):
    q = tssb.QUERIES[qid]
    jc, tc = clusters["jax"], clusters["torch"]
    assert _ops(TorchEngine(tc[node]).compile_plan(q)) == \
        _ops(JaxEngine(jc[node]).compile_plan(q))
    j0, t0 = _counts(JaxM), _counts(TorchM)
    jr, tr = dict(jc[node].client.op_counts), dict(tc[node].client.op_counts)
    want = jc[node].sql(q)
    got = tc[node].sql(q)
    dj = [b - a for a, b in zip(j0, _counts(JaxM))]
    dt = [b - a for a, b in zip(t0, _counts(TorchM))]
    err = tssb.verify(data, qid, got.data, expected=oracles[qid])
    assert err is None, err
    assert _typed(got.data) == _typed(want.data)
    assert got.schema == want.schema
    assert dt == dj
    # the fact side and the dimension legs fan out over the cluster
    # executor alike: the same RPCs by op from the asking node, and
    # node0, which holds no lineorder shard, asks its owners
    rpc_j = {k: v - jr.get(k, 0) for k, v in jc[node].client.op_counts.items()
             if v != jr.get(k, 0)}
    rpc_t = {k: v - tr.get(k, 0) for k, v in tc[node].client.op_counts.items()
             if v != tr.get(k, 0)}
    assert rpc_t == rpc_j
    if node == 0:
        assert rpc_t.get("query", 0) + rpc_t.get("sql", 0) > 0, rpc_t


def test_some_query_plans_a_partial_aggregate(clusters):
    plans = {qid: _ops(TorchEngine(clusters["torch"][1]).compile_plan(q))
             for qid, q in tssb.QUERIES.items()}
    assert any("FanoutAggOp" in p for p in plans.values()), plans


def _dml(c):
    """INSERT into three shards and a DELETE, each through a node that is
    not the coordinator; what each node holds and reads afterwards."""
    sw = SHARD_WIDTH
    c[2].sql("create table dml (_id id, g id, v int)")
    c[2].sql("insert into dml values " + ", ".join(
        f"({s * sw + i}, {i % 3}, {10 * s + i})"
        for s in range(3) for i in range(5)))
    snap = c.coordinator.snapshot()
    placed = {s: (sorted(n.id for n in snap.shard_nodes("dml", s)),
                  _holding(c, "dml", s)) for s in range(3)}
    before = [n.sql("select count(*), sum(v) from dml").data for n in c.nodes]
    c[1].sql("delete from dml where v >= 20")
    after = [n.sql("select g, count(*) from dml group by g order by g").data
             for n in c.nodes]
    return placed, before, after


def test_dml_through_a_node_routes_to_the_owners(clusters):
    out = {name: _dml(c) for name, c in clusters.items()}
    placed, before, after = out["torch"]
    for owners, hold in placed.values():
        assert hold == owners and len(owners) == 2
    assert before == [[[15, sum(10 * s + i for s in range(3)
                                for i in range(5))]]] * 3
    assert after == [[[0, 4], [1, 4], [2, 2]]] * 3
    assert out["torch"] == out["jax"]


def test_delete_from_a_shard_owner_with_replicas():
    """A DELETE from the coordinator, which owns a replica of one of the
    table's shards, while the write's legs reach two nodes. The SQL write
    holds the coordinator's write lock, so the coordinator's own leg runs
    on its thread (the JAX package's leg waits on a pool thread for that
    lock and never returns: ROADMAP C, departure 24)."""
    import threading

    c = TorchCluster(3, replica_n=2, device="cpu")
    try:
        co = c.coordinator
        co.sql("create table cdel (_id id, v int)")
        co.sql("insert into cdel values (5,1),(1048581,2),(2097157,3)")
        snap = co.snapshot()
        assert any(n.id == "node0" for s in range(3)
                   for n in snap.shard_nodes("cdel", s))
        done = []
        t = threading.Thread(target=lambda: done.append(
            co.sql("delete from cdel where v >= 2").changed), daemon=True)
        t.start()
        t.join(60)
        assert done == [2]
        assert [n.sql("select count(*) from cdel").data
                for n in c.nodes] == [[[1]]] * 3
    finally:
        c.close()
