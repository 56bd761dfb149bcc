"""The port's compressed residency end to end against the JAX package, on
the CPU.

SSB's lineorder loaded in order-date order (as public SSB setups sort it,
e.g. ``ORDER BY (LO_ORDERDATE, LO_ORDERKEY)``), cut to two shards and 120
consecutive order dates across a year boundary, so each date is still a
clustered run of ~17,000 columns: a mutex ``orderdate`` (row id = the SSB
``d_datekey`` integer YYYYMMDD), a mutex ``year`` taken from the date and
a keyed mutex ``brand`` of 40 keys drawn independently of the date,
existence tracking on. The same seeded data goes through
``pilosa_tpu.api.API`` and ``pilosa_tpu_torch.api.API(device="cpu")``
with compression forced (``PILOSA_TPU_COMPRESS=1``) and under the auto
rule (the JAX package on a one-device mesh, where its auto rule applies);
every answer must be identical (results compared on their dataclasses'
dict form; tolerance 0). A one-shard index with an ``int`` field set only
on a clustered column range holds the compressed BSI stack.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from pilosa_tpu.api import API as JaxAPI
from pilosa_tpu_torch.api import API as TorchAPI
from pilosa_tpu_torch.core import stacked as tstacked
from pilosa_tpu_torch.ops import ctiles as C
from pilosa_tpu_torch.ops import topk as T
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

SHARDS, DAYS, BRANDS = 2, 120, 40
START = np.datetime64("1995-11-01")

QUERIES = [
    "TopN(orderdate, n=10)",
    'TopN(orderdate, Row(brand="MFGR#1003"), n=10)',
    "TopN(orderdate, Row(year=1995), n=5)",
    "TopN(year)",
    'TopN(year, Row(brand="MFGR#1015"), n=7)',
    "GroupBy(Rows(year), Rows(brand), limit=100)",
    "GroupBy(Rows(orderdate), filter=Row(year=1996), limit=50)",
    "GroupBy(Rows(orderdate), Rows(year), limit=30)",
    'Count(Intersect(Row(year=1995), Row(brand="MFGR#1007")))',
    "Count(Row(orderdate=19951225))",
    "Count(Not(Row(year=1995)))",
    "Count(All())",
    "Row(orderdate=19960201)",
    'TopN(brand, Row(orderdate=19960110), n=5)',
]

BSI_QUERIES = [
    "Count(Row(delay > 100))",
    "Count(Row(50 <= delay <= 60))",
    "Sum(Row(delay < 7), field=delay)",
    "Min(field=delay)",
    "Max(field=delay)",
    "Percentile(field=delay, nth=50)",
    "Count(Not(Row(delay == 3)))",
]


def plain(r):
    if dataclasses.is_dataclass(r):
        return dataclasses.asdict(r)
    if isinstance(r, list):
        return [plain(x) for x in r]
    return r


def datekeys(days: np.ndarray) -> np.ndarray:
    """SSB d_datekey (YYYYMMDD) of day offsets from START."""
    d = START + days
    y = d.astype("datetime64[Y]").astype(np.int64) + 1970
    m = d.astype("datetime64[M]").astype(np.int64) % 12 + 1
    dd = (d - d.astype("datetime64[M]")).astype(np.int64) + 1
    return y * 10000 + m * 100 + dd


def load(api, seed=3):
    rng = np.random.default_rng(seed)
    n = SHARDS * SHARD_WIDTH
    keys = datekeys(np.arange(DAYS))
    date = keys[np.sort(rng.integers(0, DAYS, n))]  # load order = date order
    brand = rng.integers(0, BRANDS, n)
    names = np.array([f"MFGR#{1000 + b}" for b in range(BRANDS)])
    cols = np.arange(n, dtype=np.int64)
    api.create_index("d")
    api.create_field("d", "orderdate", {"type": "mutex"})
    api.create_field("d", "year", {"type": "mutex"})
    api.create_field("d", "brand", {"type": "mutex", "keys": True})
    api.import_bits("d", "orderdate", rows=date, cols=cols)
    api.import_bits("d", "year", rows=date // 10000, cols=cols)
    api.import_bits("d", "brand", cols=cols, row_keys=names[brand])
    api.create_index("b")
    api.create_field("b", "delay", {"type": "int"})
    api.import_values("b", "delay", cols=np.arange(65536),
                      values=rng.integers(0, 1000, 65536))
    return api


def port_stack(tapi, fname):
    field = tapi.holder.index("d").field(fname)
    return tstacked.stacked_set(field, list(range(SHARDS)), "standard")


def _run(mode: str):
    """Both packages' answers to the battery under one compression
    policy, with the port's resident block kinds per stack."""
    from pilosa_tpu.parallel import mesh as PM

    saved = os.environ.get("PILOSA_TPU_COMPRESS")
    if mode:
        os.environ["PILOSA_TPU_COMPRESS"] = mode
    else:
        os.environ.pop("PILOSA_TPU_COMPRESS", None)
        import jax

        PM.set_engine_mesh(PM.analytics_mesh(jax.devices()[:1]))
    try:
        japi, tapi = load(JaxAPI()), load(TorchAPI(device="cpu"))
        out = {q: (plain(japi.query("d", q)), plain(tapi.query("d", q)))
               for q in QUERIES}
        out.update({q: (plain(japi.query("b", q)), plain(tapi.query("b", q)))
                    for q in BSI_QUERIES})
        kinds = {f: [type(b).__name__ for b in port_stack(tapi, f)._blocks]
                 for f in ("orderdate", "year", "brand", "_exists")}
        bsi = tstacked.stacked_bsi(tapi.holder.index("b").field("delay"), [0])
        kinds["delay"] = [type(bsi._entry()).__name__]
        tstacked.BUDGET.audit()
        return out, kinds, tapi
    finally:
        if saved is None:
            os.environ.pop("PILOSA_TPU_COMPRESS", None)
        else:
            os.environ["PILOSA_TPU_COMPRESS"] = saved
        if not mode:
            PM.set_engine_mesh(None)


@pytest.fixture(scope="module")
def forced_run():
    return _run("1")


@pytest.fixture(scope="module")
def auto_run():
    return _run("")


@pytest.mark.parametrize("q", QUERIES + BSI_QUERIES)
def test_same_answers_compression_forced(forced_run, q):
    want, got = forced_run[0][q]
    assert got == want


@pytest.mark.parametrize("q", QUERIES + BSI_QUERIES)
def test_same_answers_auto_rule(auto_run, q):
    want, got = auto_run[0][q]
    assert got == want


def test_answers_equal_the_numpy_oracle(auto_run):
    rng = np.random.default_rng(3)
    n = SHARDS * SHARD_WIDTH
    keys = datekeys(np.arange(DAYS))
    date = keys[np.sort(rng.integers(0, DAYS, n))]
    brand = rng.integers(0, BRANDS, n)
    out = auto_run[0]
    assert out["Count(All())"][1] == [n]
    assert out["Count(Not(Row(year=1995)))"][1] == [int((date >= 19960000)
                                                        .sum())]
    assert out["Count(Row(orderdate=19951225))"][1] == [
        int((date == 19951225).sum())]
    assert out['Count(Intersect(Row(year=1995), Row(brand="MFGR#1007")))'][
        1] == [int(((date < 19960000) & (brand == 7)).sum())]
    top = out["TopN(orderdate, n=10)"][1][0]["pairs"]
    ids, counts = np.unique(date, return_counts=True)
    order = sorted(zip(-counts, ids))[:10]
    assert [(p["id"], p["count"]) for p in top] == [
        (int(i), int(-c)) for c, i in order]


def test_auto_rule_compresses_the_clustered_stacks_only(auto_run):
    kinds = auto_run[1]
    for f in ("orderdate", "year", "_exists", "delay"):
        assert set(kinds[f]) == {"CompressedBlock"}, (f, kinds[f])
    assert set(kinds["brand"]) == {"Tensor"}, kinds["brand"]
    tapi = auto_run[2]
    for f in ("orderdate", "year", "_exists"):
        for blk in port_stack(tapi, f)._blocks:
            assert blk.nbytes <= C.MAX_RATIO * blk.dense_nbytes


def test_forced_compresses_every_stack(forced_run):
    for f, kinds in forced_run[1].items():
        assert set(kinds) == {"CompressedBlock"}, (f, kinds)


def test_compressed_counts_equal_dense_counts_of_the_decoded_block(auto_run):
    tapi = auto_run[2]
    st = port_stack(tapi, "orderdate")
    filt = port_stack(tapi, "brand").row_plane(
        tapi.holder.index("d").field("brand").translate.find_keys(
            ["MFGR#1003"])["MFGR#1003"])
    for f in (None, filt):
        dense = torch.cat([T.row_counts(blk, f)
                           for _, blk in st.iter_blocks()])
        assert torch.equal(st.row_counts(f), dense)


def test_budget_charges_stored_bytes_and_eviction_rebuilds(auto_run):
    tapi = auto_run[2]
    st = port_stack(tapi, "orderdate")
    cb = st._blocks[0]
    assert isinstance(cb, C.CompressedBlock)
    # stored bytes (the JAX package's formula) plus the kernel's list of
    # non-zero constants, 12 bytes each
    assert tstacked.BUDGET._lru[(st.serial, 0)][0] == \
        cb.nbytes + 12 * cb.n_nz
    before = st.row_counts()
    st._drop_block(0)  # what a budget eviction does
    assert torch.equal(st.row_counts(), before)  # rebuilt, compressed
    again = st._blocks[0]
    assert isinstance(again, C.CompressedBlock) and again is not cb
    assert tstacked.BUDGET._lru[(st.serial, 0)][0] == \
        again.nbytes + 12 * again.n_nz
    tstacked.BUDGET.audit()


def test_write_after_eviction_goes_stale_then_rebuilds():
    tapi = load(TorchAPI(device="cpu"), seed=5)
    q = "TopN(orderdate, n=3)Count(Row(year=1996))"
    first = plain(tapi.query("d", q))
    st = port_stack(tapi, "orderdate")
    assert isinstance(st._blocks[0], C.CompressedBlock)
    tapi.import_bits("d", "orderdate", rows=[19951101] * 3000,
                     cols=np.arange(SHARD_WIDTH, SHARD_WIDTH + 3000))
    st._drop_block(0)
    with pytest.raises(tstacked.StackStale):
        st.row_counts()
    japi = load(JaxAPI(), seed=5)
    japi.import_bits("d", "orderdate", rows=[19951101] * 3000,
                     cols=np.arange(SHARD_WIDTH, SHARD_WIDTH + 3000))
    second = plain(tapi.query("d", q))
    assert second == plain(japi.query("d", q)) and second != first
    assert port_stack(tapi, "orderdate") is not st
    tstacked.BUDGET.audit()


def test_small_budget_evicts_compressed_blocks(monkeypatch):
    monkeypatch.setenv("PILOSA_TPU_COMPRESS", "1")
    monkeypatch.setattr(tstacked, "BUDGET", tstacked.DeviceBudget(1 << 20))
    tapi = TorchAPI(device="cpu")
    tapi.create_index("s")
    cols = np.arange(SHARD_WIDTH, dtype=np.int64)
    for fname in ("f", "g"):  # 256 runs of 4096 columns: ~0.66 MB stored
        tapi.create_field("s", fname, {"type": "mutex"})
        tapi.import_bits("s", fname, rows=cols // 4096, cols=cols)
    want = [{"field": "f", "pairs": [{"id": r, "key": None, "count": 4096}
                                     for r in range(3)]}]
    assert plain(tapi.query("s", "TopN(f, n=3)")) == want
    st_f = tstacked.stacked_set(tapi.holder.index("s").field("f"), [0],
                                "standard")
    assert isinstance(st_f._blocks[0], C.CompressedBlock)
    tapi.query("s", "TopN(g, n=3)")  # charges g's block: f's is evicted
    assert st_f._blocks[0] is None
    assert tstacked.BUDGET.used <= 1 << 20
    assert plain(tapi.query("s", "TopN(f, n=3)")) == want  # rebuilt
    assert isinstance(st_f._blocks[0], C.CompressedBlock)
    tstacked.BUDGET.audit()


def _paged_runs_stack(monkeypatch, budget_bytes, n_rows=64):
    """A one-shard field of ``n_rows`` rows, each a run of 512 columns,
    paged into compressed blocks of 4 rows under a budget of
    ``budget_bytes``; the counts of ``row_counts`` are recorded one list
    of blocks per ``ctile_count_blocks`` call."""
    monkeypatch.setenv("PILOSA_TPU_COMPRESS", "1")
    monkeypatch.setattr(tstacked, "_BLOCK_BYTES", 1 << 20)
    monkeypatch.setattr(tstacked, "BUDGET",
                        tstacked.DeviceBudget(budget_bytes))
    calls = []
    real = C.ctile_count_blocks

    def recording(blocks, *args, **kw):
        calls.append(list(blocks))
        return real(blocks, *args, **kw)

    monkeypatch.setattr(C, "ctile_count_blocks", recording)
    tapi = TorchAPI(device="cpu")
    tapi.create_index("p")
    tapi.create_field("p", "f", {"type": "mutex"})
    cols = np.arange(n_rows * 512, dtype=np.int64)
    tapi.import_bits("p", "f", rows=cols // 512, cols=cols)
    field = tapi.holder.index("p").field("f")
    st = tstacked.stacked_set(field, [0], "standard")
    assert st.paged and (st.n_blocks, st.block_rows) == (n_rows // 4, 4)
    return st, calls


@pytest.mark.parametrize("tight", [False, True])
def test_row_counts_gathering_stops_at_an_eviction(monkeypatch, tight):
    """With room for every block, one call counts the stack's 16
    compressed blocks (one launch on the card). Under a budget that holds
    one block, building the next block evicts the gathered one: the
    group is counted before the gathering goes on, so no evicted block is
    held past it, and the counts are the same."""
    st, calls = _paged_runs_stack(monkeypatch, 25_000 if tight else 1 << 30)
    got = st.row_counts()
    assert got.tolist() == [512] * 64
    if tight:
        assert [len(c) for c in calls] == [1] * 16
        assert tstacked.BUDGET.used <= 25_000
    else:
        assert [len(c) for c in calls] == [16]
    tstacked.BUDGET.audit()
    filt = torch.from_numpy(np.tile(np.array([0xFF], dtype=np.uint32),
                                    st.total_words).view(np.int32))
    calls.clear()
    assert st.row_counts(filt).tolist() == [8 * 16] * 64
    assert [len(c) for c in calls] == ([1] * 16 if tight else [16])


def test_row_counts_gathers_past_one_launch(monkeypatch):
    """The stack gathers every compressed block it holds into one
    ``ctile_count_blocks`` call, more than one launch takes; splitting
    them into launches is that function's concern."""
    st, calls = _paged_runs_stack(monkeypatch, 1 << 30, n_rows=96)
    assert st.n_blocks > C.MAX_BLOCKS
    assert st.row_counts().tolist() == [512] * 96
    assert [len(c) for c in calls] == [st.n_blocks]
