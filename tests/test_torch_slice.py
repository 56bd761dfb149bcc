"""The port's slice end to end against the JAX package, on the CPU.

The same seeded SSB-shaped data (two full-width shards, a 7-row mutex
``year``, a keyed mutex ``brand`` of 40 rows, existence tracking on) goes
through ``pilosa_tpu.api.API`` and ``pilosa_tpu_torch.api.API(device=
"cpu")``; both must answer every query identically (results compared on
their dataclasses' dict form; tolerance 0). Further cases force row-block
paging in both packages, write between two queries, and carry a JAX
holder over with ``convert.load_state``.
"""

import dataclasses

import numpy as np
import pytest

from pilosa_tpu.api import API as JaxAPI
from pilosa_tpu.core import stacked as jstacked
from pilosa_tpu_torch import convert
from pilosa_tpu_torch.api import API as TorchAPI
from pilosa_tpu_torch.core import stacked as tstacked
from pilosa_tpu_torch.errors import PQLError
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

SHARDS, YEARS, BRANDS = 2, 7, 40

# Trees over the tape_count kernel's limits (32 leaves, 64 ops)
UNION_40 = "Union(" + ", ".join(
    f'Row(brand="MFGR#{1000 + b}")' for b in range(40)) + ")"
OPS_81 = "Union(" + ", ".join(
    f'Intersect(Row(brand="MFGR#{1000 + b}"), Row(year={b % YEARS}))'
    for b in range(41)) + ")"

QUERIES = [
    "GroupBy(Rows(year), Rows(brand), limit=100)",
    "GroupBy(Rows(brand), filter=Row(year=2))",
    "GroupBy(Rows(year))",
    "GroupBy(Rows(year), Rows(brand), filter=Row(brand=\"MFGR#1005\"))",
    "TopN(brand, n=10)",
    "TopN(brand, Row(year=3), n=5)",
    "TopN(year)",
    'Count(Intersect(Row(year=1), Row(brand="MFGR#1003")))',
    'Count(Union(Row(year=2), Row(brand="MFGR#1011"), Row(year=6)))',
    'Count(Difference(Row(year=3), Row(brand="MFGR#1007")))',
    "Count(Xor(Row(year=4), Row(year=5)))",
    "Count(Not(Row(year=0)))",
    "Count(All())",
    'Count(Row(brand="no-such-brand"))',
    "Count(Union())",
    "Row(year=4)",
    'Intersect(Row(year=4), Not(Row(brand="MFGR#1002")))',
    "Options(Count(Row(year=1)), shards=[1])",
    "GroupBy(Rows(year), Rows(brand), limit=100)TopN(brand, n=10)",
    f"Count({UNION_40})",
    f"Count({OPS_81})",
    f"Options(Count(Difference(Row(year=1), {UNION_40})), shards=[1])",
]


def plain(r):
    if dataclasses.is_dataclass(r):
        return dataclasses.asdict(r)
    if isinstance(r, list):
        return [plain(x) for x in r]
    return r


def load(api, seed=3, shards=SHARDS, brands=BRANDS):
    rng = np.random.default_rng(seed)
    n = shards * SHARD_WIDTH
    year_of = rng.integers(0, YEARS, n)
    brand_of = rng.integers(0, brands, n)
    names = np.array([f"MFGR#{1000 + b}" for b in range(brands)])
    api.create_index("ssb")
    api.create_field("ssb", "year", {"type": "mutex"})
    api.create_field("ssb", "brand", {"type": "mutex", "keys": True})
    cols = np.arange(n, dtype=np.int64)
    api.import_bits("ssb", "year", rows=year_of, cols=cols)
    api.import_bits("ssb", "brand", cols=cols, row_keys=names[brand_of])
    return api


@pytest.fixture(scope="module")
def pair():
    return load(JaxAPI()), load(TorchAPI(device="cpu"))


@pytest.mark.parametrize("q", QUERIES)
def test_same_answers(pair, q):
    japi, tapi = pair
    assert plain(tapi.query("ssb", q)) == plain(japi.query("ssb", q))


def test_main_path_stacks_live_on_the_api_device(pair):
    _, tapi = pair
    field = tapi.holder.index("ssb").field("brand")
    st = tstacked.stacked_set(field, list(range(SHARDS)), "standard")
    assert st.device.type == "cpu" and not st.paged
    assert all(b.device.type == "cpu" for _, b in st.iter_blocks())
    tstacked.BUDGET.audit()


def test_not_ported_calls_raise(pair):
    """The calls this test once saw refused now answer (or refuse) as
    the JAX package does."""
    japi, tapi = pair
    for q in ("Extract(Row(year=1), Rows(brand))",
              "GroupBy(Rows(year), Rows(brand), Rows(year))"):
        assert plain(tapi.query("ssb", q)) == plain(japi.query("ssb", q))
    # neither sorts by nor reads a value of a mutex field
    for q in ("Sort(Row(year=1), field=brand)",
              "FieldValue(field=year, column=1)"):
        with pytest.raises(ValueError) as want:
            japi.query("ssb", q)
        with pytest.raises(PQLError) as got:
            tapi.query("ssb", q)
        assert str(got.value) == str(want.value)
    with pytest.raises(PQLError, match="unknown call"):
        tapi.query("ssb", "Bogus()")
    # calls ported since the first slice answer as the JAX package does
    for q in ("Rows(year)", "Distinct(field=year)",
              "Count(Shift(Row(year=1)))"):
        assert plain(tapi.query("ssb", q)) == plain(japi.query("ssb", q))
    # a timestamp on a field that is not a time field raises in both,
    # before anything is written
    for api in (japi, tapi):
        with pytest.raises(ValueError, match="does not support timestamps"):
            api.query("ssb", "Set(1, year=2, 2010-01-02T03:04)")


def test_paging_forced_in_both(monkeypatch):
    row_bytes = SHARDS * SHARD_WIDTH // 8  # one stacked row, in bytes
    monkeypatch.setattr(jstacked, "_BLOCK_BYTES", 16 * row_bytes)
    monkeypatch.setattr(tstacked, "_BLOCK_BYTES", 16 * row_bytes)
    japi, tapi = load(JaxAPI(), seed=5), load(TorchAPI(device="cpu"), seed=5)
    for q in ("GroupBy(Rows(year), Rows(brand), limit=100)TopN(brand, n=10)",
              "GroupBy(Rows(brand), filter=Row(year=2))",
              'Count(Intersect(Row(year=1), Row(brand="MFGR#1033")))'):
        assert plain(tapi.query("ssb", q)) == plain(japi.query("ssb", q))
    field = tapi.holder.index("ssb").field("brand")
    st = tstacked.stacked_set(field, list(range(SHARDS)), "standard")
    assert st.paged and st.n_blocks > 1
    tstacked.BUDGET.audit()


def test_write_between_queries_rebuilds_the_stack():
    japi = load(JaxAPI(), seed=9, shards=1, brands=12)
    tapi = load(TorchAPI(device="cpu"), seed=9, shards=1, brands=12)
    q = "TopN(brand, n=5)Count(Row(year=2))GroupBy(Rows(year), Rows(brand))"
    assert plain(tapi.query("ssb", q)) == plain(japi.query("ssb", q))
    field = tapi.holder.index("ssb").field("brand")
    before = tstacked.stacked_set(field, [0], "standard")
    cols = np.arange(100, 400, 3, dtype=np.int64)
    keys = ["MFGR#1001"] * cols.size
    for api in (japi, tapi):
        api.import_bits("ssb", "brand", cols=cols, row_keys=keys)
        api.import_bits("ssb", "year", rows=[2] * 40, cols=cols[:40])
    after = tstacked.stacked_set(field, [0], "standard")
    assert after is not before
    assert plain(tapi.query("ssb", q)) == plain(japi.query("ssb", q))
    tstacked.BUDGET.audit()


def test_keyed_index_and_bool_field():
    apis = (JaxAPI(), TorchAPI(device="cpu"))
    for api in apis:
        api.create_index("people", {"keys": True})
        api.create_field("people", "likes", {"type": "set"})
        api.create_field("people", "member", {"type": "bool"})
        api.import_bits("people", "likes", rows=[1, 1, 2, 3, 2],
                        col_keys=["ann", "bob", "bob", "cy", "dee"])
        api.import_bits("people", "member", rows=[1, 0, 1],
                        col_keys=["ann", "bob", "cy"])
    for q in ("Row(likes=1)", "Union(Row(likes=2), Row(member=true))",
              "Count(Not(Row(likes=2)))", "TopN(likes)",
              "GroupBy(Rows(likes), Rows(member))", "Row(member=false)"):
        assert plain(apis[1].query("people", q)) == plain(
            apis[0].query("people", q))


def jax_state(japi) -> dict:
    """Plain-Python state of a JAX holder, in convert.load_state's form."""
    out = {"indexes": []}
    for name, idx in japi.holder.indexes.items():
        d = {"name": name, "options": idx.options.to_json(),
             "column_keys": (dict(idx.translate.key_to_id)
                             if idx.translate is not None else {}),
             "fields": []}
        for fname, f in idx.fields.items():
            fd = {"name": fname, "options": f.options.to_json(),
                  "row_keys": (dict(f.translate.key_to_id)
                               if f.translate is not None else {}),
                  "shards": {}}
            for shard, frag in f.views.get("standard", {}).items():
                n = len(frag.row_ids)
                fd["shards"][shard] = {"row_ids": list(frag.row_ids),
                                       "planes": frag.planes[:n].copy()}
            d["fields"].append(fd)
        out["indexes"].append(d)
    return out


def test_load_state_answers_like_the_source(pair):
    japi, _ = pair
    tapi = TorchAPI(device="cpu")
    convert.load_state(tapi, jax_state(japi))
    for q in QUERIES[:8] + ["Row(year=4)", "Count(All())"]:
        assert plain(tapi.query("ssb", q)) == plain(japi.query("ssb", q))
    tstacked.BUDGET.audit()
