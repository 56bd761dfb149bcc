"""The remaining read calls end to end against the JAX package, on the CPU.

Through ``pilosa_tpu.api.API`` and ``pilosa_tpu_torch.api.API(device=
"cpu")``:

* the Extract / Sort / FieldValue / ExternalLookup cases of
  ``tests/test_executor.py``, parametrised over both packages, each with
  the JAX spec's own expected answers;
* the GroupBy fold, forced in both packages through
  ``Executor._groupby_dense_ok`` as ``tests/test_executor.py`` forces the
  JAX one, at 3 and 4 fields, with and without ``aggregate=Sum``,
  ``filter=`` and ``limit=``; the forced fold of 1 and 2 fields must
  also equal the dense answer;
* a seeded battery on an index of three full-width shards (keyed and
  plain set fields, a mutex, a bool, an int field with negatives and a
  decimal field, a dataframe) and on a small keyed index: Extract,
  Sort, FieldValue, GroupBy over 3 fields (dense and fold), Apply and
  Arrow with filters, every answer equal to the JAX package's;
* ``convert.load_state`` of a JAX holder with a dataframe.

Tolerance 0 (bitmaps, integers, host-decoded values), except Apply's
float reductions: rel 1e-5, since XLA and torch add float32 in
different orders.
"""

import dataclasses

import numpy as np
import pytest

from pilosa_tpu.api import API as JaxAPI
from pilosa_tpu.pql import executor as jexec
from pilosa_tpu.pql.parser import parse as jparse
from pilosa_tpu_torch import convert
from pilosa_tpu_torch.api import API as TorchAPI
from pilosa_tpu_torch.errors import PQLError
from pilosa_tpu_torch.pql import executor as texec
from pilosa_tpu_torch.pql.parser import parse as tparse
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

SW = SHARD_WIDTH


def plain(r):
    if dataclasses.is_dataclass(r):
        return dataclasses.asdict(r)
    if isinstance(r, list):
        return [plain(x) for x in r]
    return r


@pytest.fixture(params=["jax", "torch"])
def api(request):
    return JaxAPI() if request.param == "jax" else TorchAPI(device="cpu")


def q(api, src, index="s"):
    return api.query(index, src)


def _dense_off(monkeypatch):
    for ex in (jexec.Executor, texec.Executor):
        monkeypatch.setattr(ex, "_groupby_dense_ok",
                            staticmethod(lambda sts, agg_st: False))


# ---------------------------------------------------------------------------
# tests/test_executor.py's cases, over both packages
# ---------------------------------------------------------------------------


def test_extract(api):
    api.create_index("i")
    api.create_field("i", "s")
    api.create_field("i", "n", {"type": "int"})
    q(api, "Set(1, s=10)Set(1, s=20)Set(2, s=10)", "i")
    q(api, "Set(1, n=-5)", "i")
    t = q(api, "Extract(All(), Rows(s), Rows(n))", "i")[0]
    assert [f.name for f in t.fields] == ["s", "n"]
    assert {c.column: c.rows for c in t.columns} == {1: [[10, 20], -5],
                                                     2: [[10], None]}


def _sort_data(api):
    api.create_index("s")
    api.create_field("s", "v", {"type": "int"})
    api.create_field("s", "b", {"type": "bool"})
    api.create_field("s", "f")
    q(api, "Set(1, v=30)Set(2, v=10)Set(3, v=20)Set(1, f=1)Set(3, f=1)")
    q(api, "Set(1, b=true)Set(2, b=false)")


def test_sort_asc_desc(api):
    _sort_data(api)
    r = q(api, "Sort(field=v)")[0]
    assert r.columns == [2, 3, 1] and r.values == [10, 20, 30]
    assert q(api, "Sort(field=v, sort-desc=true)")[0].columns == [1, 3, 2]


def test_sort_filtered_limit(api):
    _sort_data(api)
    r = q(api, "Sort(Row(f=1), field=v, limit=1)")[0]
    assert r.columns == [3] and r.values == [20]


def test_sort_bool(api):
    _sort_data(api)
    r = q(api, "Sort(field=b)")[0]
    assert r.columns == [2, 1] and r.values == [False, True]


def test_sort_cross_shard(api):
    _sort_data(api)
    big = SW + 9
    q(api, f"Set({big}, v=15)")
    assert q(api, "Sort(field=v)")[0].columns == [2, big, 3, 1]


def test_field_value(api):
    _sort_data(api)
    assert q(api, "FieldValue(field=v, column=3)")[0].val == 20
    assert q(api, "FieldValue(field=v, column=99)")[0].count == 0
    assert q(api, "FieldValue(field=b, column=1)")[0].val is True
    assert q(api, "FieldValue(field=b, column=2)")[0].val is False
    assert q(api, "FieldValue(field=b, column=3)")[0].count == 0
    assert q(api, f"FieldValue(field=b, column={5 * SW})")[0].count == 0


def test_external_lookup(api):
    api.create_index("s")
    api.create_field("s", "f")
    with pytest.raises(ValueError, match="external lookup backend"):
        q(api, 'ExternalLookup(query="select 1")')
    api.executor.external_lookup = lambda query, write: {"echo": query,
                                                         "write": write}
    assert q(api, 'ExternalLookup(query="x")')[0] == {"echo": "x",
                                                      "write": False}
    # a write-mode lookup runs as a write request
    assert q(api, 'ExternalLookup(query="y", write=true)')[0] == {
        "echo": "y", "write": True}


@pytest.mark.parametrize("src,writes", [
    ('ExternalLookup(query="x")', False),
    ('ExternalLookup(query="x", write=true)', True),
    ('Count(Row(f=1))ExternalLookup(query="x", write=true)', True),
    ("Set(1, f=1)", True), ("Extract(All(), Rows(f))", False),
    ('Apply("sum(x)")', False)])
def test_has_write_calls_matches_jax(src, writes):
    assert texec.has_write_calls(tparse(src)) is writes
    assert jexec.has_write_calls(jparse(src)) is writes


def test_call_errors_match(api):
    _sort_data(api)
    for src, msg in (("Extract()", "bitmap child"),
                     ("Sort(field=f)", "bool and int-like"),
                     ("FieldValue(column=1)", "requires field"),
                     ("FieldValue(field=v)", "requires column"),
                     ("FieldValue(field=f, column=1)", "int-like or bool"),
                     ("Apply()", "expression string"),
                     ('Apply(Row(f=1), Row(f=1), "sum(x)")', "single bitmap"),
                     ("Bogus()", "unknown call")):
        with pytest.raises(ValueError, match=msg):
            q(api, src)


def test_groupby_sum_fold_matches_dense(api, monkeypatch):
    api.create_index("g")
    api.create_field("g", "a")
    api.create_field("g", "b")
    api.create_field("g", "v", {"type": "int"})
    q(api, "Set(1, a=1)Set(2, a=1)Set(3, a=2)Set(1, b=10)Set(3, b=10)"
           "Set(2, b=20)Set(1, v=7)Set(2, v=-3)Set(3, v=100)", "g")
    query = "GroupBy(Rows(a), Rows(b), aggregate=Sum(field=v))"
    dense = q(api, query, "g")[0]
    _dense_off(monkeypatch)
    fold = q(api, query, "g")[0]
    assert dense == fold
    assert {tuple((g.field, g.row_id) for g in gc.group): (gc.count, gc.agg)
            for gc in dense} == {(("a", 1), ("b", 10)): (1, 7),
                                 (("a", 1), ("b", 20)): (1, -3),
                                 (("a", 2), ("b", 10)): (1, 100)}


# ---------------------------------------------------------------------------
# the seeded battery
# ---------------------------------------------------------------------------

SHARDS, PER_SHARD = 3, 3000


def _load(api, seed=11):
    rng = np.random.default_rng(seed)
    cols = np.concatenate([s * SW + np.sort(rng.choice(SW, PER_SHARD, False))
                           for s in range(SHARDS)])
    n = cols.size
    api.create_index("b")
    api.create_field("b", "s", {"keys": True})
    api.create_field("b", "t")
    api.create_field("b", "m", {"type": "mutex"})
    api.create_field("b", "f", {"type": "bool"})
    api.create_field("b", "v", {"type": "int"})
    api.create_field("b", "d", {"type": "decimal", "scale": 2})
    keys = np.array([f"k{i}" for i in range(6)])
    two = rng.random(n) < 0.3  # a second s row on some columns
    api.import_bits("b", "s", cols=np.r_[cols, cols[two]],
                    row_keys=np.r_[keys[rng.integers(0, 6, n)],
                                   keys[rng.integers(0, 6, int(two.sum()))]])
    tc = cols[rng.random(n) < 0.6]
    api.import_bits("b", "t", rows=rng.integers(0, 5, tc.size), cols=tc)
    api.import_bits("b", "m", rows=rng.integers(0, 4, n), cols=cols)
    has_v = cols[rng.random(n) < 0.8]
    api.import_values("b", "v", cols=has_v,
                      values=rng.integers(-500, 500, has_v.size))
    has_d = cols[rng.random(n) < 0.5]
    api.import_values("b", "d", cols=has_d,
                      values=rng.integers(-10 ** 5, 10 ** 5, has_d.size) / 100)
    for c in cols[rng.random(n) < 0.4][:200]:
        api.query("b", f"Set({int(c)}, f={'true' if c % 3 else 'false'})")
    for s in range(SHARDS):
        # most of a shard's records, and some positions of no record
        mine = cols[cols // SW == s] % SW
        pos = np.union1d(rng.choice(mine, 2000, False),
                         rng.choice(SW, 200, False))
        api.import_dataframe("b", s, pos, {
            "fare": np.round(rng.random(pos.size) * 100, 2),
            "n": rng.integers(-50, 50, pos.size)})
    return api


BATTERY = [
    "Extract(Row(m=1), Rows(s), Rows(t), Rows(m), Rows(f), Rows(v), Rows(d))",
    'Extract(Intersect(Row(s="k2"), Row(v > 100)), Rows(v), Rows(s))',
    "Extract(Row(v < -490), Rows(d), Rows(f))",
    "Extract(Row(f=true), Rows(t))",
    "Sort(field=v)",
    "Sort(Row(m=2), field=v, sort-desc=true)",
    "Sort(Row(t=3), field=d, limit=17)",
    'Sort(Row(s="k0"), field=f)',
    "Sort(field=f, sort-desc=true, limit=5)",
    "Sort(Row(v > 400), field=v, limit=10)",
    "FieldValue(field=d, column=1048577)",
    "GroupBy(Rows(m), Rows(s), Rows(t))",
    "GroupBy(Rows(s), Rows(m), Rows(t), Rows(f))",
    "GroupBy(Rows(t), Rows(m), Rows(s), aggregate=Sum(field=v))",
    "GroupBy(Rows(m), Rows(t), Rows(f), aggregate=Sum(field=d), limit=9)",
    'GroupBy(Rows(m), Rows(s), Rows(t), filter=Row(s="k1"), limit=20)',
    "GroupBy(Rows(m), Rows(t), filter=Row(v < 0), aggregate=Sum(field=v))",
    "GroupBy(Rows(s), aggregate=Sum(field=v), limit=3)",
    'Apply("sum(fare * n)")',
    'Apply(Row(m=1), "mean(fare + n)")',
    'Apply(Row(m=1), "max(n)")',
    'Apply(Union(Row(m=1), Row(t=2)), "count(fare)")',
    'Apply(Row(v > 0), "fare * 2")',
    'Apply(Not(Row(m=0)), "min(fare - n)")',
    'Arrow(Row(t=4), header=["n"])',
    "Arrow(Intersect(Row(m=3), Row(f=true)))",
    "Count(Row(m=1))",
]


@pytest.fixture(scope="module")
def battery():
    return _load(JaxAPI()), _load(TorchAPI(device="cpu"))


def _same(tres, jres, src):
    t, j = plain(tres), plain(jres)
    if isinstance(j, dict) and isinstance(j.get("value"), float):
        assert t["value"] == pytest.approx(j["value"], rel=1e-5), src
    else:
        assert t == j, src


@pytest.mark.parametrize("src", BATTERY)
def test_battery(battery, src):
    japi, tapi = battery
    _same(tapi.query("b", src)[0], japi.query("b", src)[0], src)


def test_battery_point_reads(battery):
    """FieldValue on every column of a sample, present and absent."""
    japi, tapi = battery
    rng = np.random.default_rng(5)
    for c in rng.integers(0, SHARDS * SW, 40):
        for f in ("v", "d", "f"):
            src = f"FieldValue(field={f}, column={int(c)})"
            assert plain(tapi.query("b", src)) == plain(japi.query("b", src))


@pytest.mark.parametrize("src", [s for s in BATTERY if s.startswith("GroupBy")])
def test_battery_fold_forced(battery, monkeypatch, src):
    japi, tapi = battery
    want = plain(japi.query("b", src)[0])  # dense or fold, as it chooses
    _dense_off(monkeypatch)
    assert plain(japi.query("b", src)[0]) == want
    assert plain(tapi.query("b", src)[0]) == want


def test_remote_executor_skips_limit_and_keys(battery):
    """A peer-serving executor returns untranslated, uncut partials from
    Extract and Sort, as the JAX package's does."""
    japi, tapi = battery
    jx = jexec.Executor(japi.holder, remote=True)
    tx = texec.Executor(tapi.holder, remote=True)
    for src in ('Extract(Row(m=1), Rows(s), Rows(v))',
                "Sort(Row(m=2), field=v, limit=5)"):
        assert plain(tx.execute("b", src)) == plain(jx.execute("b", src))
    got = tx.execute("b", "Sort(Row(m=2), field=v, limit=5)")[0]
    assert len(got.columns) > 5


def _keyed(api):
    api.create_index("k", {"keys": True})
    api.create_field("k", "g", {"keys": True})
    api.create_field("k", "h", {"type": "mutex"})
    api.create_field("k", "w", {"type": "int"})
    api.create_field("k", "x", {"type": "bool"})
    for i in range(12):
        api.query("k", f'Set("r{i}", g="{"abc"[i % 3]}")Set("r{i}", h={i % 4})'
                       f'Set("r{i}", w={(i * 37) % 23 - 11})'
                       f'Set("r{i}", x={"true" if i % 2 else "false"})')
    return api


def test_keyed_index():
    japi, tapi = _keyed(JaxAPI()), _keyed(TorchAPI(device="cpu"))
    for src in ("Extract(All(), Rows(g), Rows(h), Rows(w), Rows(x))",
                "Sort(field=w)", 'Sort(Row(g="a"), field=x, sort-desc=true)',
                'FieldValue(field=w, column="r5")',
                'FieldValue(field=x, column="nope")',
                "GroupBy(Rows(g), Rows(h), Rows(x), aggregate=Sum(field=w))"):
        assert plain(q(tapi, src, "k")) == plain(q(japi, src, "k")), src


def test_load_state_carries_the_dataframe(battery):
    japi, _ = battery
    idx = japi.holder.index("b")
    state = {"indexes": [{
        "name": "b", "options": idx.options.to_json(), "fields": [],
        "dataframe": {s: {"columns": dict(fr.columns),
                          "valid": dict(fr.valid)}
                      for s, fr in idx.dataframe.frames.items()}}]}
    tapi = TorchAPI(device="cpu")
    convert.load_state(tapi, state)
    assert tapi.dataframe_schema("b") == japi.dataframe_schema("b")
    for s in range(SHARDS):
        assert tapi.dataframe_shard("b", s) == japi.dataframe_shard("b", s)
    for src in ('Apply("sum(fare * n)")', 'Apply("count(n)")',
                'Arrow(header=["fare"])'):
        _same(tapi.query("b", src)[0], japi.query("b", src)[0], src)
    bad = {"indexes": [{"name": "c", "options": idx.options.to_json(),
                        "fields": [], "dataframe": {0: {
                            "columns": {"x": np.zeros(4)},
                            "valid": {"x": np.zeros(3, dtype=bool)}}}}]}
    with pytest.raises(ValueError, match="do not form a column"):
        convert.load_state(TorchAPI(device="cpu"), bad)


def test_port_errors_are_pql_errors(battery):
    _, tapi = battery
    with pytest.raises(PQLError, match="unknown call"):
        tapi.query("b", "Bogus()")
