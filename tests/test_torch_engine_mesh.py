"""The engine over several devices (``parallel/mesh.py``'s engine mesh and
``parallel/split.py``), on the CPU, held against the JAX package.

* ``tests/test_executor.py``'s PQL spec, every case, runs over the port
  (``Holder(cpu)`` / ``Executor``) under a fixture with params ``1dev``
  and ``all`` (``[cpu]`` and ``[cpu] * 8``), as the JAX file runs it at
  its ``:19-29``, each case with the spec's own expected answers; under
  ``all`` every stack the case cached must span the 8 positions and no
  call may gather.
* ``engine_put``'s blocks equal the JAX ``engine_put``'s
  ``addressable_shards`` under its 8-device mesh, bit for bit.
* The loud fallback (``tests/test_mesh.py``), the ``mesh`` compression
  rule (``tests/test_compress.py:181-210``), a 3-node ``LocalCluster``
  on the 8-position mesh against a one-node API
  (``tests/test_cluster.py:275-314``).
* A seeded battery of Sets, Clears and imports at the blocks' edges
  through both APIs, each on its 8-device mesh: every read, the stacks'
  snapshot versions and the uploads per step equal, and the port's
  stacks advance (no rebuild) on the writes.
* Shift across a block edge that cuts a shard, a mesh switch
  between queries, and the main path's calls never gathering.

Tolerance 0 throughout: bitmaps and integers.
"""

import ast
import logging
import os

import jax
import numpy as np
import pytest
import torch

from pilosa_tpu.api import API as JaxAPI
from pilosa_tpu.core import stacked as jstacked
from pilosa_tpu.parallel import mesh as JM
from pilosa_tpu_torch.api import API as TorchAPI
from pilosa_tpu_torch.cluster import LocalCluster
from pilosa_tpu_torch.core import stacked as tstacked
from pilosa_tpu_torch.core.holder import Holder
from pilosa_tpu_torch.core.schema import FieldOptions, FieldType, IndexOptions
from pilosa_tpu_torch.errors import PQLError
from pilosa_tpu_torch.obs import metrics as TMetrics
from pilosa_tpu_torch.ops import ctiles as TC
from pilosa_tpu_torch.parallel import mesh as TM
from pilosa_tpu_torch.parallel import split as SP
from pilosa_tpu_torch.pql import executor as texec
from pilosa_tpu_torch.pql.executor import Executor
from pilosa_tpu_torch.pql.parser import parse
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, WORDS_PER_SHARD

CPU = torch.device("cpu")
N = 8


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: under ``-n 6`` every worker's pool would
    contend for the same cores."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _mesh(n=N, col_parallel=1):
    return TM.analytics_mesh([CPU] * n, col_parallel=col_parallel)


@pytest.fixture
def on_mesh():
    TM.set_engine_mesh(_mesh())
    yield
    TM.set_engine_mesh(None)


def _cached_stacks(holder):
    for idx in holder.indexes.values():
        fields = list(idx.fields.values())
        if idx.existence is not None:
            fields.append(idx.existence)
        for f in fields:
            for inner in getattr(f, "_stacked_cache", {}).values():
                for _, st in inner.values():
                    yield st


def _entries(st):
    if isinstance(st, tstacked.StackedBSI):
        return [st._planes] if st._planes is not None else []
    return [b for b in st._blocks if b is not None]


# ---------------------------------------------------------------------------
# tests/test_executor.py over the port, on 1 and 8 positions
# ---------------------------------------------------------------------------


@pytest.fixture(params=["1dev", "all"])
def spec_mesh(request):
    TM.set_engine_mesh(_mesh(1 if request.param == "1dev" else N))
    yield request.param
    TM.set_engine_mesh(None)


@pytest.fixture
def env(spec_mesh):
    h = Holder(CPU)
    gathers = SP.GATHER_STATS["calls"]
    yield h, Executor(h)
    if spec_mesh == "all":
        spans = {len(e.blocks) if isinstance(e, SP.Split) else 1
                 for st in _cached_stacks(h) for e in _entries(st)}
        assert spans <= {N}, f"stacks spanned {spans} positions"
        assert SP.GATHER_STATS["calls"] == gathers


def _port_spec():
    """The JAX spec's classes and helpers, with its names bound to the
    port (its own fixtures and imports dropped)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "test_executor.py")
    with open(path) as fh:
        tree = ast.parse(fh.read())
    tree.body = [n for n in tree.body
                 if not isinstance(n, (ast.Import, ast.ImportFrom))
                 and not (isinstance(n, ast.FunctionDef)
                          and n.name in ("engine_mesh", "env"))]
    ns = {"pytest": pytest, "FieldOptions": FieldOptions,
          "FieldType": FieldType, "Holder": lambda: Holder(CPU),
          "IndexOptions": IndexOptions, "Executor": Executor,
          "parse": parse, "PQLError": PQLError, "SHARD_WIDTH": SHARD_WIDTH,
          "__name__": __name__}
    exec(compile(tree, path, "exec"), ns)
    return {k: pytest.mark.usefixtures("spec_mesh")(v)
            for k, v in ns.items() if k.startswith("Test")}


globals().update(_port_spec())


# ---------------------------------------------------------------------------
# engine_put against the JAX placement
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,col_parallel", [
    ((2, WORDS_PER_SHARD), 1),
    ((3, WORDS_PER_SHARD), 2),
    ((5, 2 * WORDS_PER_SHARD), 1),
    ((4, 3 * WORDS_PER_SHARD), 4),
])
def test_engine_put_blocks_equal_jax_addressable_shards(shape, col_parallel):
    rng = np.random.default_rng(sum(shape) + col_parallel)
    host = rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)
    JM.set_engine_mesh(JM.analytics_mesh(jax.devices(),
                                         col_parallel=col_parallel))
    TM.set_engine_mesh(_mesh(len(jax.devices()), col_parallel))
    try:
        ja = JM.engine_put(host)
        got = TM.engine_put(host, CPU)
    finally:
        JM.set_engine_mesh(None)
        TM.set_engine_mesh(None)
    shards = sorted(ja.addressable_shards, key=lambda s: s.index[-1].start)
    assert isinstance(got, SP.Split) and got.n == len(shards) == N
    assert tuple(got.shape) == host.shape
    for blk, sh in zip(got.blocks, shards):
        assert np.array_equal(blk.numpy().view(np.uint32),
                              np.asarray(sh.data))
    assert np.array_equal(SP.d2h(got), host)
    assert np.array_equal(got.cpu().numpy().view(np.uint32), host)


def test_engine_sharding_fallback_is_visible(on_mesh):
    before = TMetrics.REGISTRY.value(TMetrics.METRIC_MESH_FALLBACK) or 0
    logger = logging.getLogger("pilosa_tpu_torch.mesh")
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger.addHandler(handler)
    try:
        assert TM.engine_sharding(2, 1234567) is None  # prime
        assert TM.engine_sharding(2, 1234567) is None
    finally:
        logger.removeHandler(handler)
    after = TMetrics.REGISTRY.value(TMetrics.METRIC_MESH_FALLBACK)
    assert after == before + 2  # every call counts
    assert sum("SINGLE-DEVICE" in r.getMessage() for r in records) == 1
    # a stack that does not divide lands whole on its device
    assert isinstance(TM.engine_put(np.zeros((2, 1234567), np.uint32), CPU),
                      torch.Tensor)
    # a divisible one splits; another device is not the mesh's
    assert TM.engine_sharding(2, 8 * 4096).width == 4096
    assert TM.engine_sharding(2, 8 * 4096, torch.device("meta")) is None


def test_default_mesh_is_every_card_or_the_cpu():
    TM.set_engine_mesh(None)
    m = TM.engine_mesh()
    if torch.cuda.is_available():
        assert m.devices.size == torch.cuda.device_count()
    else:
        assert list(m.devices.flat) == [CPU]
        assert TM.engine_sharding(1, 8 * 4096, CPU) is None


def test_mesh_rule_keeps_blocks_dense(on_mesh, monkeypatch):
    monkeypatch.delenv("PILOSA_TPU_COMPRESS", raising=False)
    host = np.zeros((16, 65536), dtype=np.uint32)
    f0 = TMetrics.REGISTRY.value(TMetrics.METRIC_COMPRESS_FALLBACK,
                                 why="mesh", kind="set") or 0.0
    assert TC.why_not_compress(host.nbytes) == "mesh"
    assert TC.maybe_compress(host, CPU, kind="set") is None
    assert TMetrics.REGISTRY.value(TMetrics.METRIC_COMPRESS_FALLBACK,
                                   why="mesh", kind="set") == f0 + 1
    # forced compression yields the mesh rule, as in the JAX package
    monkeypatch.setenv("PILOSA_TPU_COMPRESS", "1")
    assert TC.why_not_compress(host.nbytes) is None
    # ... but a split stack stays dense and split (ROADMAP C)
    api = TorchAPI(device="cpu")
    api.create_index("c")
    api.create_field("c", "f")
    api.import_bits("c", "f", rows=[1, 1], cols=[3, SHARD_WIDTH + 5])
    assert api.query("c", "Count(Row(f=1))") == [2]
    ents = [e for st in _cached_stacks(api.holder) for e in _entries(st)]
    assert ents and all(isinstance(e, SP.Split) for e in ents)
    TM.set_engine_mesh(_mesh(1))
    assert TC.why_not_compress(host.nbytes) is None
    monkeypatch.delenv("PILOSA_TPU_COMPRESS")
    assert TC.why_not_compress(host.nbytes) is None


# ---------------------------------------------------------------------------
# A cluster whose nodes run on the engine mesh
# ---------------------------------------------------------------------------


def _fill(target, index="cm"):
    target.create_index(index)
    target.create_field(index, "f")
    target.create_field(index, "n", {"type": "int"})
    cols = list(range(0, 5 * SHARD_WIDTH, SHARD_WIDTH // 4))
    target.import_bits(index, "f", rows=[(c // 100) % 3 for c in cols],
                       cols=cols)
    vcols = list(range(0, 3 * SHARD_WIDTH, SHARD_WIDTH // 8))
    target.import_values(index, "n", cols=vcols,
                         values=[(i % 7) - 3 for i in range(len(vcols))])


def test_multinode_queries_run_on_the_engine_mesh(on_mesh):
    oracle = TorchAPI(device="cpu")
    TM.set_engine_mesh(_mesh(1))
    _fill(oracle)
    want = {q: repr(oracle.query("cm", q)) for q in (
        "Count(Row(f=0))", "TopN(f, n=3)", "Sum(field=n)",
        "GroupBy(Rows(f), limit=10)", "Count(Row(n > 0))")}
    TM.set_engine_mesh(_mesh())
    with LocalCluster(3, device="cpu") as c:
        _fill(c.coordinator)
        for q, w in want.items():
            assert repr(c.coordinator.query("cm", q)) == w, q
        spans = set()
        for node in c.nodes:
            for st in _cached_stacks(node.api.holder):
                spans.update(len(e.blocks) if isinstance(e, SP.Split)
                             else 1 for e in _entries(st))
        assert spans == {N}


# ---------------------------------------------------------------------------
# Writes at the blocks' edges through both packages
# ---------------------------------------------------------------------------

_SHARDS = 3
_L = _SHARDS * WORDS_PER_SHARD // N  # words per block: 12,288
#: the words on either side of every block edge (two cut a shard)
_EDGE_WORDS = sorted({w for k in range(1, N) for w in (k * _L - 1, k * _L)})


def _edge_cols(rng, n):
    words = rng.choice(_EDGE_WORDS, n)
    return [int(w) * 32 + int(b) for w, b in zip(words, rng.integers(0, 32, n))]


def _battery(seed=23):
    """(kind, payload) steps: writes at the edges, imports, reads."""
    rng = np.random.default_rng(seed)
    reads = ["Count(Row(f=1))", "Count(Intersect(Row(f=1), Row(g=2)))",
             "TopN(f, n=5)", "GroupBy(Rows(f), Rows(g))", "Row(f=2)",
             "Count(Row(v > 3))", "Sum(Row(f=1), field=v)",
             "Min(field=v)", "Max(field=v)",
             "Percentile(field=v, nth=50)", "Count(Shift(Row(f=1), n=1))",
             "Count(Not(Row(f=1)))"]
    steps = [("import", (rng.integers(0, 4, 600).tolist(),
                         _edge_cols(rng, 600), "f")),
             ("import", (rng.integers(0, 3, 300).tolist(),
                         _edge_cols(rng, 300), "g")),
             ("values", (_edge_cols(rng, 200),
                         rng.integers(-20, 40, 200).tolist()))]
    steps += [("read", q) for q in reads]
    for rnd in range(4):
        ops = []
        for c in _edge_cols(rng, 16):
            ops.append(f"Set({c}, f={int(rng.integers(0, 4))})")
        for c in _edge_cols(rng, 8):
            ops.append(f"Clear({c}, f={int(rng.integers(0, 4))})")
        for c in _edge_cols(rng, 6):
            ops.append(f"Set({c}, v={int(rng.integers(-20, 40))})")
        steps.append(("write", "".join(ops)))
        steps += [("read", q) for q in reads]
        if rnd == 1:
            steps.append(("import", (rng.integers(0, 4, 100).tolist(),
                                     _edge_cols(rng, 100), "f")))
            steps += [("read", q) for q in reads[:4]]
    return steps


def _run_battery(api, mod):
    api.create_index("w")
    api.create_field("w", "f")
    api.create_field("w", "g")
    api.create_field("w", "v", {"type": "int"})
    # every shard present from the start, so the stacks span 3 shards
    api.query("w", "".join(f"Set({s * SHARD_WIDTH + 1}, f=0)"
                           for s in range(_SHARDS)))
    out = []
    for kind, payload in _battery():
        u0 = mod.UPLOAD_STATS["count"]
        if kind == "import":
            rows, cols, field = payload
            api.import_bits("w", field, rows=rows, cols=cols)
            res = None
        elif kind == "values":
            api.import_values("w", "v", cols=payload[0], values=payload[1])
            res = None
        else:
            res = repr(api.query("w", payload))
        out.append((kind, res, mod.UPLOAD_STATS["count"] - u0))
    return out


def _snapshots(holder):
    snaps = {}
    for f in holder.index("w").fields.values():
        for group, inner in getattr(f, "_stacked_cache", {}).items():
            for subset, (_, st) in inner.items():
                snaps[(f.name, group, subset)] = tuple(st._built_vers)
    return snaps


def test_write_battery_at_block_edges_matches_jax():
    JM.set_engine_mesh(JM.analytics_mesh(jax.devices()))
    TM.set_engine_mesh(_mesh())
    try:
        japi, tapi = JaxAPI(), TorchAPI(device="cpu")
        a0 = dict(tstacked.ADVANCE_STATS)
        got = _run_battery(tapi, tstacked)
        adv = {k: tstacked.ADVANCE_STATS[k] - a0[k] for k in a0}
        want = _run_battery(japi, jstacked)
        assert [g[:2] for g in got] == [w[:2] for w in want]
        assert [g[2] for g in got] == [w[2] for w in want]
        assert _snapshots(tapi.holder) == _snapshots(japi.holder)
        # the writes advanced the stacks: the reads after a write round
        # uploaded nothing, and every advance scattered into blocks
        write_reads = [ups for i, (kind, _, ups) in enumerate(got)
                       if kind == "read" and got[i - 1][0] == "write"]
        assert write_reads and all(u == 0 for u in write_reads)
        assert adv["advanced"] > 0 and adv["scatters"] > 0
        assert any(r is not None and r != "[0]" for _, r, _ in got)
        for st in _cached_stacks(tapi.holder):
            for e in _entries(st):
                assert isinstance(e, SP.Split) and e.n == N
    finally:
        JM.set_engine_mesh(None)
        TM.set_engine_mesh(None)


def test_advance_copies_only_the_touched_blocks(on_mesh):
    api = TorchAPI(device="cpu")
    api.create_index("a")
    api.create_field("a", "f")
    api.query("a", f"Set(1, f=1)Set({SHARD_WIDTH + 1}, f=1)")
    assert api.query("a", "Count(Row(f=1))") == [2]
    st0 = next(st for st in _cached_stacks(api.holder)
               if st.row_ids == [1])
    before = st0._blocks[0].blocks
    col = 2 * (2 * WORDS_PER_SHARD // N) * 32 + 5  # block 2's first word
    s0 = tstacked.ADVANCE_STATS["scatters"]
    api.query("a", f"Set({col}, f=1)")
    assert api.query("a", "Count(Row(f=1))") == [3]
    st1 = next(st for st in _cached_stacks(api.holder)
               if st.row_ids == [1])
    after = st1._blocks[0].blocks
    assert tstacked.ADVANCE_STATS["scatters"] == s0 + 1
    assert [a is b for a, b in zip(after, before)] == [
        k != 2 for k in range(N)]


# ---------------------------------------------------------------------------
# Shift across a block edge, a mesh switch, no gather on the main path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_pos", [2, 4, 8])
def test_shift_carries_across_a_block_edge_inside_a_shard(n_pos):
    # 3 shards: block 0 ends inside a shard (mid shard 1 on 2 positions)
    edge = 3 * WORDS_PER_SHARD // n_pos
    assert edge % WORDS_PER_SHARD
    cols = [edge * 32 - 1,             # the top bit of a block's last word
            SHARD_WIDTH - 1,           # the top of shard 0: dropped
            SHARD_WIDTH + 31, 2 * SHARD_WIDTH + 5, 77]
    pql = "".join(f"Set({c}, f=1)" for c in cols)
    jx = JaxAPI()
    jx.create_index("s")
    jx.create_field("s", "f")
    jx.query("s", pql)
    want = jx.query("s", "Shift(Row(f=1), n=1)Count(Shift(Row(f=1), n=2))")
    assert want[0].columns == sorted([edge * 32, SHARD_WIDTH + 32,
                                      2 * SHARD_WIDTH + 6, 78])
    TM.set_engine_mesh(_mesh(n_pos))
    try:
        api = TorchAPI(device="cpu")
        api.create_index("s")
        api.create_field("s", "f")
        api.query("s", pql)
        got = api.query("s", "Shift(Row(f=1), n=1)"
                             "Count(Shift(Row(f=1), n=2))")
    finally:
        TM.set_engine_mesh(None)
    assert got[0].columns == want[0].columns and got[1] == want[1]


def test_mesh_switch_between_queries_leaves_nothing_stale():
    api = TorchAPI(device="cpu")
    TM.set_engine_mesh(_mesh(1))
    try:
        _fill(api, "m")
        qs = ["Count(Row(f=1))", "TopN(f, n=2)", "Sum(field=n)",
              "Count(Row(n > 0))"]
        want = [api.query("m", q) for q in qs]
        fused = [qs[0], qs[0]]
        subsets = [[0, 1], [2]]
        masked = api.executor.execute_many(
            "m", fused, per_query_shards=subsets)
        for n_pos, col in ((N, 1), (4, 2), (1, 1)):
            TM.set_engine_mesh(_mesh(n_pos, col))
            epoch = TM.mesh_epoch()
            assert [api.query("m", q) for q in qs] == want
            assert api.executor.execute_many(
                "m", fused, per_query_shards=subsets) == masked
            spans = {len(e.blocks) if isinstance(e, SP.Split) else 1
                     for st in _cached_stacks(api.holder)
                     for e in _entries(st)}
            assert spans == {n_pos}
            from pilosa_tpu_torch.pql import programs

            assert all(k[5] == epoch for k in list(programs._PROGRAMS)[-2:])
            fresh = [p for k, p in texec._MASK_PLANES.items()
                     if k[0] == epoch]
            assert fresh and all(
                (p.n if isinstance(p, SP.Split) else 1) == n_pos
                for p in fresh)
    finally:
        TM.set_engine_mesh(None)


def test_main_path_calls_never_gather(on_mesh):
    api = TorchAPI(device="cpu")
    _fill(api, "g")
    api.create_field("g", "t")
    api.import_bits("g", "t", rows=[0, 1, 1, 2], cols=[5, 6, SHARD_WIDTH,
                                                       3 * SHARD_WIDTH])
    g0 = dict(SP.GATHER_STATS)
    main = ["Count(Row(f=1))", "Count(Intersect(Row(f=1), Row(t=1)))",
            "TopN(f, n=2)", "TopN(f, Row(t=1), n=2)",
            "GroupBy(Rows(f), Rows(t))", "GroupBy(Rows(f), Rows(t), "
            "aggregate=Sum(field=n))", "GroupBy(Rows(f), Rows(t), Rows(f))",
            "Count(Row(n > 0))", "Count(Row(-1 < n < 2))",
            "Sum(Row(f=1), field=n)", "Min(field=n)", "Max(field=n)",
            "Percentile(field=n, nth=90)", "Row(f=1)", "Count(Not(Row(f=0)))",
            "Count(Shift(Row(f=1), n=3))", "Rows(f)", "Count(UnionRows("
            "Rows(f)))", "Count(ConstRow(columns=[1, 5]))",
            "Extract(Row(t=1), Rows(f))", "Distinct(Row(t=1), field=n)"]
    for q in main:
        api.query("g", q)
    api.executor.execute_many("g", main[:6],
                              per_query_shards=[[0, 1]] * 3 + [[2]] * 3)
    assert SP.GATHER_STATS == g0
    for st in _cached_stacks(api.holder):
        for e in _entries(st):
            assert isinstance(e, SP.Split) and e.n == N
    # Apply's filter reaches the dataframe's one device: a named gather
    api.import_dataframe("g", 0, list(range(8)),
                         {"x": [float(i) for i in range(8)]})
    api.query("g", 'Apply(Row(t=1), "sum(x)")')
    assert SP.GATHER_STATS["calls"] == g0["calls"] + 1


def test_split_refuses_to_mix_placements(on_mesh):
    s = TM.engine_put(np.ones((2, 8 * 64), np.uint32), CPU)
    with pytest.raises(TypeError):
        s & torch.zeros(8 * 64, dtype=torch.int32)
    with pytest.raises(TypeError):
        s[:, :5]
    with pytest.raises(TypeError):
        s.reshape(16, 64)
    with pytest.raises(TypeError):
        torch.sum(s)
    assert isinstance(s[0] & s[1], SP.Split)
    assert int((s[0] != 0).any()) == 1
