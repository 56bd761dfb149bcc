"""The dataframe slice against the JAX package, on the CPU.

* ``compile_expr``: the same seeded float32 columns and masks go through
  ``pilosa_tpu.dataframe.expr.compile_expr`` (jitted, on the CPU) and the
  port's; every reducer, every function, unary minus, division,
  constant-only expressions, and every ``ExprError``. Tolerance: exact
  for ``count``, ``min`` and ``max``; rel 1e-5 for ``sum`` and ``mean``
  (XLA and torch add float32 in different orders); elementwise for
  vectors, with NaN where the other has NaN, at most 1 ulp for each
  division or function on the way to an element (each may round 1 ulp
  apart in the two libraries), and so for the ``min`` / ``max`` of such
  a body.
* ``ShardFrame`` / ``DataframeStore`` against the JAX classes: growth,
  int -> float promotion, ``schema``, ``device_columns`` caps, validity
  and the versioned cache.
* The API cases of ``tests/test_dataframe.py``, over both packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilosa_tpu.api import API as JaxAPI
from pilosa_tpu.dataframe import expr as jexpr
from pilosa_tpu.dataframe import store as jstore
from pilosa_tpu_torch.api import API as TorchAPI
from pilosa_tpu_torch.dataframe import expr as texpr
from pilosa_tpu_torch.dataframe import store as tstore
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

S, N = 3, 257


def _columns(seed=0):
    rng = np.random.default_rng(seed)
    fare = (rng.random((S, N), dtype=np.float32) * 100).astype(np.float32)
    dist = (rng.random((S, N), dtype=np.float32) * 30).astype(np.float32)
    dist[0, :5] = 0  # division by zero: inf and nan
    mask = rng.random((S, N)) < 0.7
    return {"fare": fare, "dist": dist}, mask


REDUCTIONS = [
    "sum(fare)", "mean(fare + dist * 2)", "min(fare - dist)", "max(-fare)",
    "count(fare)", "sum(abs(fare - 50))", "mean(sqrt(fare))",
    "sum(log(fare + 1))", "max(exp(dist / 30))", "min(fare / dist)",
    "mean(-(fare - dist) / 4)", "sum(2 + 3)", "mean(sqrt(4) * 2)",
    "min(3)", "max(.5 - 2.)", "count(7)", "sum(exp(1) + fare * 0)",
    "max(log(fare - 50))", "sum(fare / (dist - dist))",
]
VECTORS = [
    "fare / dist", "-fare * 2", "sqrt(fare) + abs(dist)", "7",
    "exp(1) - 1", "log(fare - 50)", "fare - -dist", "(fare + 1) * (dist - 1)",
    "exp(dist) / 3.5", "abs(-2) * fare",
]
ERRORS = ["", "   ", "sum(", "bogusfn(x)", "fare +", "(fare", "fare )",
          "sum(fare) + 1", "count()", "3 4", "fare @ 2", "sum(fare))",
          "sqrt()", "abs fare"]


def _rounding_ops(src: str) -> int:
    """Divisions and functions in ``src``: XLA and torch may round each
    of them 1 ulp apart (``exp``, or ``x / 30`` taken as ``x * (1 /
    30)``), and the differences add up along a chain."""
    return src.count("/") + sum(src.count(f + "(")
                                for f in ("sqrt", "log", "exp"))


def _both(src):
    cols, mask = _columns()
    jfn, jcols, jred = jexpr.compile_expr(src)
    tfn, tcols, tred = texpr.compile_expr(src)
    assert (tcols, tred) == (jcols, jred)
    want = np.asarray(jax.jit(jfn)({k: jnp.asarray(v) for k, v in cols.items()},
                                   jnp.asarray(mask)))
    got = tfn({k: torch.from_numpy(v) for k, v in cols.items()},
              torch.from_numpy(mask)).numpy()
    return src, got, want


@pytest.mark.parametrize("src", REDUCTIONS)
def test_reductions_match_jax(src):
    src, got, want = _both(src)
    assert got.shape == () and got.dtype == want.dtype
    if src.startswith(("min", "max")) and _rounding_ops(src):
        np.testing.assert_array_max_ulp(got, want,
                                        maxulp=_rounding_ops(src))
    elif src.startswith(("count", "min", "max")) or not np.isfinite(want):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("src", VECTORS)
def test_vectors_match_jax(src):
    src, got, want = _both(src)
    assert got.shape == want.shape == (S, N) and got.dtype == np.float32
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_array_max_ulp(got[ok], want[ok],
                                    maxulp=max(1, _rounding_ops(src)))


@pytest.mark.parametrize("src", ERRORS)
def test_errors_match_jax(src):
    with pytest.raises(jexpr.ExprError) as je:
        jexpr.compile_expr(src)
    with pytest.raises(texpr.ExprError) as te:
        texpr.compile_expr(src)
    assert str(te.value) == str(je.value)


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------


def _frame_state(frame):
    return ({k: (v.dtype.str, v.tolist()) for k, v in frame.columns.items()},
            {k: v.tolist() for k, v in frame.valid.items()}, frame.version,
            frame.length())


CHANGESETS = [
    (0, [3, 7], {"fare": [1.5, 2.5], "dist": [10, 20]}),
    (1, [0], {"fare": [9.0]}),
    (0, [5000], {"dist": [4.25]}),  # grows dist to 8192, promotes it
    (2, [1, 2, 3], {"n": np.array([1, 2, 3], dtype=np.int32)}),
    (2, [2], {"n": [True]}),
    (1, [2047, 2048], {"fare": np.array([1.0, 2.0], dtype=np.float32)}),
]


def test_store_matches_jax():
    j = jstore.DataframeStore("t")
    t = tstore.DataframeStore("t", torch.device("cpu"))
    for shard, ids, cols in CHANGESETS:
        j.apply_changeset(shard, ids, cols)
        t.apply_changeset(shard, ids, cols)
        assert t.schema() == j.schema() and t.shards() == j.shards()
        for s in j.frames:
            assert _frame_state(t.frames[s]) == _frame_state(j.frames[s])
    for names in ([], ["fare"], ["dist", "fare"], ["n"], ["fare", "n"]):
        for shards in ([0], [0, 1, 2], [2, 1], [1, 5]):
            jc, jv, jcap = j.device_columns(names, shards)
            tc, tv, tcap = t.device_columns(names, shards)
            assert tcap == jcap and sorted(tc) == sorted(jc)
            assert tv.dtype == torch.bool
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
            for name in jc:
                assert tc[name].dtype == torch.float32
                np.testing.assert_array_equal(tc[name].numpy(),
                                              np.asarray(jc[name]))
    with pytest.raises(ValueError):
        t.apply_changeset(0, [1, 2], {"fare": [1.0]})
    with pytest.raises(ValueError):
        t.apply_changeset(0, [SHARD_WIDTH], {"fare": [1.0]})


def test_device_cache_hits_by_version():
    t = tstore.DataframeStore("t", torch.device("cpu"))
    t.apply_changeset(0, [1], {"fare": [1.0]})
    first = t.device_columns(["fare"], [0])
    assert t.device_columns(["fare"], [0])[1] is first[1]
    t.apply_changeset(0, [2], {"fare": [2.0]})
    again = t.device_columns(["fare"], [0])
    assert again[1] is not first[1]
    assert again[0]["fare"][0, :3].tolist() == [0.0, 1.0, 2.0]
    for s in range(10):  # the cache keeps 8 entries, oldest out first
        t.device_columns(["fare"], [0] + list(range(1, s + 1)))
    assert len(t._device_cache) == 8
    assert (("fare",), (0,)) not in t._device_cache
    t.delete()
    assert not t.frames and not t._device_cache


# ---------------------------------------------------------------------------
# tests/test_dataframe.py's API cases, over both packages
# ---------------------------------------------------------------------------


@pytest.fixture(params=["jax", "torch"])
def api(request):
    a = JaxAPI() if request.param == "jax" else TorchAPI(device="cpu")
    a.create_index("t")
    a.create_field("t", "seg")
    return a


def fill(api, n=1000, shards=2):
    rng = np.random.default_rng(42)
    fares, dists = {}, {}
    for s in range(shards):
        ids = rng.choice(SHARD_WIDTH, size=n, replace=False)
        f = rng.uniform(1, 100, size=n).round(2)
        d = rng.integers(0, 50, size=n)
        api.import_dataframe("t", s, [int(i) for i in ids],
                             {"fare": [float(x) for x in f],
                              "dist": [int(x) for x in d]})
        for i, fa, di in zip(ids, f, d):
            g = s * SHARD_WIDTH + int(i)
            fares[g] = float(fa)
            dists[g] = int(di)
    return fares, dists


def test_apply_sum_matches_numpy(api):
    fares, _ = fill(api)
    got = api.query("t", 'Apply("sum(fare)")')[0]
    assert got.value == pytest.approx(sum(fares.values()), rel=1e-5)


def test_apply_filtered_aggregation(api):
    fares, _ = fill(api)
    chosen = sorted(fares)[:50]
    for c in chosen:
        api.query("t", f"Set({c}, seg=1)")
    got = api.query("t", 'Apply(Row(seg=1), "mean(fare)")')[0]
    assert got.value == pytest.approx(np.mean([fares[c] for c in chosen]),
                                      rel=1e-5)


def test_apply_compound_expression(api):
    fares, dists = fill(api)
    got = api.query("t", 'Apply("sum(fare + dist * 2)")')[0]
    want = sum(fares[c] + dists[c] * 2 for c in fares if c in dists)
    assert got.value == pytest.approx(want, rel=1e-5)


def test_apply_vector_result(api):
    api.import_dataframe("t", 0, [5, 9], {"fare": [10.0, 20.0]})
    assert api.query("t", 'Apply("fare * 3")')[0].value == [30.0, 60.0]


def test_apply_count(api):
    fill(api, n=123, shards=1)
    assert api.query("t", 'Apply("count(fare)")')[0].value == 123


def test_apply_empty(api):
    assert api.query("t", 'Apply("sum(fare)")')[0].value == 0
    assert api.query("t", 'Apply("fare")')[0].value == []


def test_arrow_extract_with_header(api):
    api.import_dataframe("t", 0, [3, 7], {"fare": [1.5, 2.5],
                                          "dist": [10, 20]})
    api.import_dataframe("t", 1, [0], {"fare": [9.0]})
    got = api.query("t", 'Arrow(header=["fare"])')[0]
    assert [f.name for f in got.fields] == ["fare"]
    assert got.ids == [3, 7, SHARD_WIDTH]
    assert got.columns == [[1.5, 2.5, 9.0]]


def test_arrow_filtered_all_columns(api):
    api.import_dataframe("t", 0, [3, 7], {"fare": [1.5, 2.5],
                                          "dist": [10, 20]})
    api.query("t", "Set(7, seg=1)")
    got = api.query("t", "Arrow(Row(seg=1))")[0]
    assert got.ids == [7]
    by_name = dict(zip([f.name for f in got.fields], got.columns))
    assert by_name == {"fare": [2.5], "dist": [20]}


def test_schema_shard_and_delete(api):
    api.import_dataframe("t", 3, [1, 4], {"fare": [1.0, 2.0], "n": [7, 8]})
    api.import_dataframe("t", 3, [2], {"n": [0.5]})
    assert api.dataframe_schema("t") == [{"name": "fare", "type": "float64"},
                                         {"name": "n", "type": "float64"}]
    assert api.dataframe_shard("t", 3) == {"shard": 3, "columns": {
        "fare": {"positions": [1, 4], "values": [1.0, 2.0]},
        "n": {"positions": [1, 2, 4], "values": [7.0, 0.5, 8.0]}}}
    assert api.dataframe_shard("t", 0) == {"shard": 0, "columns": {}}
    # a dataframe-only shard is one of the index's shards
    assert sorted(api.holder.index("t").shards()) == [3]
    assert api.query("t", 'Apply("sum(n)")')[0].value == 15.5
    api.delete_dataframe("t")
    assert api.dataframe_schema("t") == []
    assert api.query("t", 'Apply("sum(n)")')[0].value == 0


def test_answers_equal_across_packages():
    apis = []
    for a in (JaxAPI(), TorchAPI(device="cpu")):
        a.create_index("t")
        a.create_field("t", "seg")
        fill(a, n=500, shards=3)
        a.query("t", "Set(5, seg=1)Set(1048600, seg=1)Set(2097200, seg=2)")
        apis.append(a)
    for q in ('Apply("sum(fare + dist * 2)")', 'Apply("mean(fare / dist)")',
              'Apply(Row(seg=1), "max(fare)")', 'Apply("count(dist)")',
              'Apply(Union(Row(seg=1), Row(seg=2)), "fare - dist")',
              'Apply(Not(Row(seg=1)), "min(dist)")',
              'Arrow(Row(seg=2))', 'Arrow(header=["dist"])'):
        j, t = (dataclasses.asdict(a.query("t", q)[0]) for a in apis)
        if isinstance(j.get("value"), float):
            assert t["value"] == pytest.approx(j["value"], rel=1e-5), q
        else:
            assert t == j, q
