"""The port's BSI slice end to end against the JAX package, on the CPU.

The same seeded data (two full-width shards; a set field ``f``, a mutex
``g``, an int field ``v`` with negative values, ``min``/``max`` and a
base, a decimal ``d`` of scale 2 and a timestamp ``ts``; existence
tracking on) goes through ``pilosa_tpu.api.API`` and
``pilosa_tpu_torch.api.API(device="cpu")``; both must answer every query
identically (results compared on their dataclasses' dict form; tolerance
0). ``convert.load_state`` of the JAX holder must answer the same too.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pilosa_tpu.api import API as JaxAPI
from pilosa_tpu.pql.executor import PQLError as JaxPQLError
from pilosa_tpu_torch import convert
from pilosa_tpu_torch.api import API as TorchAPI
from pilosa_tpu_torch.core import stacked as tstacked
from pilosa_tpu_torch.errors import PQLError
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

SHARDS = 2
T0 = 1_600_000_000  # 2020-09-13, epoch seconds

# the battery of tests/test_compress.py
COMPRESS_QUERIES = [
    "Count(Row(f=3))",
    "TopN(f, n=10)",
    "Count(Row(v > 5))",
    "Count(Row(v < -20))",
    "Count(Row(v == 7))",
    "Count(Row(v != 7))",
    "Count(Row(v >= -100))",
    "Count(Row(-10 < v < 20))",
    "Count(Intersect(Row(f=1), Row(v >= 0)))",
    "GroupBy(Rows(f))",
    "Min(field=v)",
    "Max(field=v)",
    "Sum(field=v)",
]

QUERIES = COMPRESS_QUERIES + [
    "Sum(Row(f=2), field=v)",
    "Sum(Row(v > 100), field=v)",
    "Min(Row(f=4), field=v)",
    "Max(Intersect(Row(g=1), Row(v < 0)), field=v)",
    "Max(Row(v < -2000), field=v)",
    "Sum(field=d)",
    "Min(field=d)",
    "Max(Row(d > 1.5), field=d)",
    "Count(Row(d <= -12.25))",
    "Percentile(field=v, nth=0)",
    "Percentile(field=v, nth=50)",
    "Percentile(field=v, nth=99.5)",
    "Percentile(field=d, nth=25, filter=Row(f=1))",
    "Percentile(field=ts, nth=90)",
    "Min(field=ts)",
    'Count(Row(ts > "2020-09-14T00:00:00"))',
    "Row(v != null)",
    "Count(Row(v != null))",
    "Row(v=5)",
    "Count(Row(v=-5))",
    "Row(-3 <= v <= 3)",
    "Count(Not(Row(v > 0)))",
    "Count(Union(Row(v > 900), Row(v < -900), Row(f=9)))",
    "GroupBy(Rows(f), aggregate=Sum(field=v))",
    "GroupBy(Rows(f), aggregate=Sum(field=d), filter=Row(v > 0))",
    "GroupBy(Rows(f), Rows(g), aggregate=Sum(field=v))",
    "GroupBy(Rows(f), Rows(g), aggregate=Sum(field=v), limit=7)",
    "GroupBy(Rows(g), aggregate=Count())",
    "TopN(f, Row(v > 0), n=5)",
    "Options(Sum(field=v), shards=[1])",
    "Sum(field=v)Min(field=v)Count(Row(v > 5))Percentile(field=v, nth=75)",
]


def plain(r):
    if dataclasses.is_dataclass(r):
        return dataclasses.asdict(r)
    if isinstance(r, list):
        return [plain(x) for x in r]
    return r


def load(api, seed=3):
    rng = np.random.default_rng(seed)
    n = SHARDS * SHARD_WIDTH
    cols = np.arange(n, dtype=np.int64)
    api.create_index("i")
    api.create_field("i", "f", {"type": "set"})
    api.create_field("i", "g", {"type": "mutex"})
    api.create_field("i", "v", {"type": "int", "min": -5000, "max": 5000,
                                "base": 10})
    api.create_field("i", "d", {"type": "decimal", "scale": 2})
    api.create_field("i", "ts", {"type": "timestamp"})
    api.import_bits("i", "f", rows=rng.integers(0, 10, n), cols=cols)
    api.import_bits("i", "g", rows=rng.integers(0, 4, n // 2),
                    cols=cols[::2])
    sel = rng.random(n) < 0.7  # a sparse int field
    api.import_values("i", "v", cols=cols[sel],
                      values=rng.integers(-5000, 5001, int(sel.sum())))
    some = rng.choice(n, 50_000, replace=False)
    api.import_values("i", "d", cols=some,
                      values=rng.integers(-100_000, 100_000, some.size) / 100)
    api.import_values("i", "ts", cols=cols[:4000],
                      values=T0 + rng.integers(0, 3 * 86400, 4000))
    # a later write to a column wins
    api.import_values("i", "v", cols=[0, 1, 0], values=[5, -5, -4999])
    return api


@pytest.fixture(scope="module")
def pair():
    return load(JaxAPI()), load(TorchAPI(device="cpu"))


@pytest.mark.parametrize("q", QUERIES)
def test_same_answers(pair, q):
    japi, tapi = pair
    assert plain(tapi.query("i", q)) == plain(japi.query("i", q))


def test_equals_null_raises_in_both(pair):
    japi, tapi = pair
    with pytest.raises(JaxPQLError, match="== null"):
        japi.query("i", "Row(v == null)")
    with pytest.raises(PQLError, match="== null"):
        tapi.query("i", "Row(v == null)")


@pytest.mark.parametrize("q", ["Sum(field=f)", "Count(Row(f > 1))",
                               "Min(field=g)"])
def test_int_calls_on_a_set_field_raise_in_both(pair, q):
    japi, tapi = pair
    with pytest.raises(JaxPQLError, match="not an int-like field"):
        japi.query("i", q)
    with pytest.raises(PQLError, match="not an int-like field"):
        tapi.query("i", q)


def test_stack_depth_and_values(pair):
    japi, tapi = pair
    idx = tapi.holder.index("i")
    st = tstacked.stacked_bsi(idx.field("v"), list(range(SHARDS)))
    assert st.depth == 13 and st.planes.shape == (15, SHARDS * SHARD_WIDTH
                                                  // 32)
    jidx = japi.holder.index("i")
    for col in (0, 1, 2, 3, SHARD_WIDTH + 17):
        assert idx.field("v").value(col) == jidx.field("v").value(col)
    assert idx.field("v").value(0) == -4999
    assert idx.shards() == {0, 1}
    tstacked.BUDGET.audit()


def test_import_rejects_out_of_range_values_in_both(pair):
    japi, tapi = pair
    for api in (japi, tapi):
        with pytest.raises(ValueError, match="field max"):
            api.import_values("i", "v", cols=[5], values=[5001])
        with pytest.raises(ValueError, match="not an int-like field"):
            api.import_values("i", "f", cols=[5], values=[1])
    assert plain(tapi.query("i", "Count(Row(v != null))")) == plain(
        japi.query("i", "Count(Row(v != null))"))


def test_write_between_queries_rebuilds_the_bsi_stack():
    apis = (JaxAPI(), TorchAPI(device="cpu"))
    q = "Sum(field=n)Max(field=n)Count(Row(n > 3))Percentile(field=n, nth=50)"
    out = []
    for api in apis:
        api.create_index("w")
        api.create_field("w", "n", {"type": "int"})
        api.import_values("w", "n", cols=range(100), values=range(100))
        first = plain(api.query("w", q))
        # depth grows from 7 to 11 bits and column 5 is overwritten
        api.import_values("w", "n", cols=[5, 200], values=[-1500, 1025])
        out.append((first, plain(api.query("w", q))))
    assert out[0] == out[1]
    assert out[1][0] != out[1][1]


def test_keyed_index_import_values():
    apis = (JaxAPI(), TorchAPI(device="cpu"))
    for api in apis:
        api.create_index("k", {"keys": True})
        api.create_field("k", "age", {"type": "int"})
        api.import_values("k", "age", col_keys=["ann", "bob", "cy"],
                          values=[31, 45, 27])
    for q in ("Row(age > 30)", "Sum(field=age)", "Min(field=age)",
              "Count(All())"):
        assert plain(apis[1].query("k", q)) == plain(apis[0].query("k", q))


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
                  "shards": {},
                  "bsi": {s: frag.planes.copy() for s, frag in f.bsi.items()}}
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
    for q in COMPRESS_QUERIES + ["Sum(field=d)", "Percentile(field=ts, nth=5)",
                                 "GroupBy(Rows(f), Rows(g), "
                                 "aggregate=Sum(field=v))"]:
        assert plain(tapi.query("i", q)) == plain(japi.query("i", q))
    tstacked.BUDGET.audit()


def test_evicted_bsi_stack_rebuilds_or_goes_stale():
    api = TorchAPI(device="cpu")
    api.create_index("e")
    api.create_field("e", "n", {"type": "int"})
    api.import_values("e", "n", cols=range(0, 3000, 3), values=range(1000))
    field = api.holder.index("e").field("n")
    st = tstacked.stacked_bsi(field, [0])
    before = st.planes.clone()
    st._drop()  # what a budget eviction does
    assert torch.equal(st.planes, before)  # rebuilt from the host planes
    api.import_values("e", "n", cols=[1], values=[7])
    st._drop()
    with pytest.raises(tstacked.StackStale):
        st.planes
    fresh = tstacked.stacked_bsi(field, [0])
    assert fresh is not st and fresh.planes.shape == before.shape
    assert plain(api.query("e", "Sum(field=n)")) == [
        {"val": sum(range(1000)) + 7, "count": 1001}]
    tstacked.BUDGET.audit()
