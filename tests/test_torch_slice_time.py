"""The time slice end to end against the JAX package, on the CPU.

Two parts, both through ``pilosa_tpu.api.API`` and
``pilosa_tpu_torch.api.API(device="cpu")``:

* the row-set and time-range cases of ``tests/test_executor.py`` (Shift
  and ConstRow, IncludesColumn, Limit with offset, Distinct, Rows,
  UnionRows, and the Row / TopN / Rows time ranges), parametrised over
  both packages, each with the JAX spec's own expected answers;
* one interleaved battery on an index of three full-width shards with a
  ``time`` field of quantum YMD, a keyed ``time`` field of quantum YM, a
  set field and an int field: timestamped ``Set``s and ``Clear``s
  between ranged Row / TopN / Rows / UnionRows reads and the row-set
  calls (ConstRow, Shift, Limit, Distinct, Count(Distinct),
  IncludesColumn). After every step the results and the number of stack
  uploads it caused must be equal; at the end, every fragment's host
  planes per view.

Tolerance 0: bitmaps and integers.
"""

import dataclasses

import numpy as np
import pytest

from pilosa_tpu.api import API as JaxAPI
from pilosa_tpu.core import stacked as jstk
from pilosa_tpu_torch import convert
from pilosa_tpu_torch.api import API as TorchAPI
from pilosa_tpu_torch.core import stacked as tstk
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


def q(api, src, index="i"):
    return api.query(index, src)


# ---------------------------------------------------------------------------
# tests/test_executor.py's cases, over both packages
# ---------------------------------------------------------------------------


def test_shift_const_row(api):
    api.create_index("i")
    api.create_field("i", "f")
    q(api, "Set(1, f=1)Set(5, f=1)")
    assert q(api, "Shift(Row(f=1), n=2)")[0].columns == [3, 7]
    assert q(api, "ConstRow(columns=[2, 9])")[0].columns == [2, 9]
    assert q(api, "Intersect(Row(f=1), ConstRow(columns=[1]))"
             )[0].columns == [1]


def test_shift_stops_at_shard_boundaries(api):
    """Bit 2^20 - 1 of shard 0 and of shard 1 would carry into the next
    shard's bit 0 under a flat shift; the reference shifts per shard."""
    api.create_index("i")
    api.create_field("i", "f")
    q(api, f"Set({SW - 1}, f=1)Set({2 * SW - 1}, f=1)Set({SW - 2}, f=1)"
           f"Set({2 * SW + 4}, f=1)")
    assert q(api, "Shift(Row(f=1))")[0].columns == [SW - 1, 2 * SW + 5]
    assert q(api, "Count(Shift(Row(f=1), n=1))") == [2]
    assert q(api, "Count(Shift(Row(f=1), n=2))") == [1]
    assert q(api, "Shift(Row(f=1), n=0)")[0].columns == [
        SW - 2, SW - 1, 2 * SW - 1, 2 * SW + 4]


def test_includes_column(api):
    api.create_index("i")
    api.create_field("i", "f")
    q(api, "Set(10, f=1)")
    assert q(api, "IncludesColumn(Row(f=1), column=10)") == [True]
    assert q(api, "IncludesColumn(Row(f=1), column=11)") == [False]


def test_limit_offset(api):
    api.create_index("i")
    api.create_field("i", "f")
    for c in range(10):
        q(api, f"Set({c}, f=1)")
    assert q(api, "Limit(Row(f=1), limit=3)")[0].columns == [0, 1, 2]
    assert q(api, "Limit(Row(f=1), limit=3, offset=4)")[0].columns == [
        4, 5, 6]


def _bsi_data(api):
    api.create_index("i")
    api.create_field("i", "n", {"type": "int"})
    api.create_field("i", "f")
    data = {1: 3, 2: -7, 3: 100, SW + 1: 42, SW + 2: -7}
    for col, val in data.items():
        q(api, f"Set({col}, n={val})")
    q(api, "Set(1, f=1)Set(2, f=1)Set(3, f=1)")


def test_distinct(api):
    _bsi_data(api)
    assert q(api, "Distinct(field=n)") == [[-7, 3, 42, 100]]
    assert q(api, "Count(Distinct(field=n))") == [4]
    assert q(api, "Distinct(Row(f=1), field=n)") == [[-7, 3, 100]]
    assert q(api, "Distinct(field=f)")[0].columns == [1]
    assert q(api, "Count(Distinct(field=f))") == [1]


def _topn_data(api):
    api.create_index("i")
    api.create_field("i", "f")
    for c in (1, 2, 3, SW + 1):
        q(api, f"Set({c}, f=1)")
    for c in (1, SW + 2):
        q(api, f"Set({c}, f=2)")
    q(api, "Set(9, f=3)")


def test_rows(api):
    _topn_data(api)
    assert q(api, "Rows(f)") == [[1, 2, 3]]
    assert q(api, "Rows(f, limit=2)") == [[1, 2]]
    assert q(api, "Rows(f, previous=1)") == [[2, 3]]
    assert q(api, "Rows(f, column=9)") == [[3]]
    assert q(api, "Rows(f, column=1)") == [[1, 2]]
    assert q(api, f"Rows(f, column={5 * SW})") == [[]]  # not a shard
    assert q(api, "Rows(f, in=[3, 1, 7])") == [[1, 3]]


def test_union_rows(api):
    _topn_data(api)
    r = q(api, "UnionRows(Rows(f))")[0]
    assert r.columns == [1, 2, 3, 9, SW + 1, SW + 2]
    r = q(api, "UnionRows(Rows(f, in=[2, 3]))")[0]
    assert r.columns == [1, 9, SW + 2]
    r = q(api, f"UnionRows(Rows(f, previous=2), Rows(f, column={SW + 1}))")
    assert r[0].columns == [1, 2, 3, 9, SW + 1]
    assert q(api, "Count(UnionRows(Rows(f, limit=1)))") == [4]


def test_row_time_range(api):
    api.create_index("i")
    api.create_field("i", "t", {"type": "time", "timeQuantum": "YMDH"})
    q(api, "Set(1, t=1, 2010-01-01T00:00)")
    q(api, "Set(2, t=1, 2010-06-15T12:00)")
    q(api, "Set(3, t=1, 2011-01-01T00:00)")
    r = q(api, "Row(t=1, from='2010-01-01T00:00', to='2011-01-01T00:00')")
    assert r[0].columns == [1, 2]
    r = q(api, "Row(t=1, from='2010-06-01T00:00', to='2010-07-01T00:00')")
    assert r[0].columns == [2]
    assert q(api, "Row(t=1)")[0].columns == [1, 2, 3]


def test_topn_time_range(api):
    api.create_index("i")
    api.create_field("i", "t", {"type": "time", "timeQuantum": "YMDH"})
    q(api, "Set(1, t=1, 2010-02-01T00:00)")
    q(api, "Set(2, t=1, 2010-03-01T00:00)")
    q(api, f"Set({SW + 5}, t=1, 2010-04-01T00:00)")
    q(api, "Set(9, t=1, 2011-05-01T00:00)")
    q(api, "Set(3, t=2, 2010-02-01T00:00)")
    q(api, "Set(4, t=2, 2011-03-01T00:00)")
    q(api, "Set(5, t=2, 2011-04-01T00:00)")

    def top(pql):
        return [(p.id, p.count) for p in q(api, pql)[0].pairs]

    assert top("TopN(t, from='2010-01-01T00:00', to='2011-01-01T00:00')"
               ) == [(1, 3), (2, 1)]
    assert top("TopN(t, from='2011-01-01T00:00', to='2012-01-01T00:00')"
               ) == [(2, 2), (1, 1)]
    assert top("TopN(t)") == [(1, 4), (2, 3)]
    assert top("TopN(t, from='2010-02-01T00:00', to='2010-04-01T00:00')"
               ) == [(1, 2), (2, 1)]


def test_rows_time_range(api):
    api.create_index("i")
    api.create_field("i", "t", {"type": "time", "timeQuantum": "YMD"})
    q(api, "Set(1, t=1, 2010-02-01T00:00)")
    q(api, "Set(2, t=2, 2011-03-01T00:00)")
    assert q(api, "Rows(t, from='2010-01-01T00:00', to='2011-01-01T00:00')"
             )[0] == [1]
    assert q(api, "Rows(t)")[0] == [1, 2]


# ---------------------------------------------------------------------------
# the interleaved battery
# ---------------------------------------------------------------------------

SHARDS = 3
RANGE = "from='2010-03-01T00:00', to='2010-07-01T00:00'"


def _schema_and_data(api):
    rng = np.random.default_rng(31)
    api.create_index("i")
    api.create_field("i", "t", {"type": "time", "timeQuantum": "YMD"})
    api.create_field("i", "tk", {"type": "time", "timeQuantum": "YM",
                                 "keys": True})
    api.create_field("i", "f")
    api.create_field("i", "n", {"type": "int"})
    cols = rng.integers(0, SHARDS * SW, 400)
    for k, c in enumerate(cols):
        month = 1 + k % 12
        day = 1 + int(rng.integers(0, 28))
        api.query("i", f"Set({int(c)}, t={k % 5}, "
                       f"2010-{month:02d}-{day:02d}T{k % 24:02d}:00)")
    for k, c in enumerate(cols[:120]):
        api.query("i", f'Set({int(c)}, tk="k{k % 4}", '
                       f"2010-{1 + k % 6:02d}-03T00:00)")
    api.import_bits("i", "f", rows=rng.integers(0, 6, 2000),
                    cols=rng.integers(0, SHARDS * SW, 2000))
    api.import_values("i", "n", cols=cols[:200],
                      values=rng.integers(-50, 50, 200))
    # the last bit of every shard, so Shift has a carry to drop
    for s in range(SHARDS):
        api.query("i", f"Set({(s + 1) * SW - 1}, t=1, 2010-04-30T23:00)")


READS = [
    f"Count(Row(t=1, {RANGE}))",
    f"Row(t=2, {RANGE})",
    f"TopN(t, n=3, {RANGE})",
    f"TopN(t, Row(f=1), {RANGE})",
    "TopN(t, from='2010-01-01T00:00', to='2011-01-01T00:00')",
    "TopK(t, k=2, from='2010-03-15T00:00')",
    f"Rows(t, {RANGE})",
    "Rows(t, to='2010-02-10T00:00')",
    f"Rows(t, {RANGE}, limit=2, previous=0)",
    f"Rows(t, {RANGE}, in=[1, 3, 9])",
    f"Count(UnionRows(Rows(t, {RANGE})))",
    f"UnionRows(Rows(t, {RANGE}, in=[1, 2]), Rows(f, limit=2))",
    "Count(UnionRows(Rows(t, from='2010-01-01T00:00', "
    "to='2010-07-01T00:00'), Rows(t, from='2010-07-01T00:00', "
    "to='2011-01-01T00:00')))",
    f"Count(Shift(Row(t=1, {RANGE}), n=1))",
    f"Shift(Row(t=1, from='2010-04-30T00:00', to='2010-05-01T00:00'))",
    f"IncludesColumn(Row(t=1, {RANGE}), column={SW - 1})",
    f"IncludesColumn(Row(t=1, {RANGE}), column=5)",
    f"Count(Intersect(Row(t=0, {RANGE}), Row(f=2)))",
    f"Limit(Row(t=3, {RANGE}), limit=4, offset=2)",
    "Limit(Row(f=1), limit=5)",
    "ConstRow(columns=[5, 1048580, 2097200, 9999999])",
    f"Count(Intersect(Row(f=1), ConstRow(columns=[{SW + 4}, 7])))",
    "Distinct(field=t)",
    f"Distinct(Row(f=3), field=n)",
    "Count(Distinct(field=n))",
    "Count(Distinct(field=tk))",
    'Row(tk="k1", from=\'2010-02-01T00:00\', to=\'2010-05-01T00:00\')',
    "TopN(tk, from='2010-01-01T00:00', to='2010-04-01T00:00')",
    "Rows(tk, from='2010-03-01T00:00')",
    'Rows(tk, in=["k2", "nope", "k0"])',
    f"Rows(t, column=5)",
    "Row(t=1)",
]


def _steps():
    """Timestamped writes in March to June and elsewhere, and clears,
    each followed by reads, so view stacks advance, build or rebuild."""
    rng = np.random.default_rng(32)
    out = [r for r in READS]
    for k in range(40):
        c = int(rng.integers(0, SHARDS * SW))
        row = int(rng.integers(0, 6))
        month = int(rng.choice([3, 4, 5, 6, 9]))
        day = 1 + int(rng.integers(0, 28))
        stamp = f"2010-{month:02d}-{day:02d}T{int(rng.integers(0, 24)):02d}:30"
        if k % 5 == 4:
            out.append(f"Clear({c}, t={row})")
        else:
            out.append(f"Set({c}, t={row}, {stamp})")
        out.append(READS[int(rng.integers(0, len(READS)))])
        out.append(f"Count(Row(t={row}, {RANGE}))TopN(t, n=4, {RANGE})")
    out.append('Set(77, tk="k9", 2010-02-14T00:00)')
    out.append("TopN(tk, from='2010-01-01T00:00', to='2010-04-01T00:00')")
    out.append("Set(78, t=1, 2010-03-20T00:00)"
               f"Count(Row(t=1, from='2010-03-15T00:00', "
               "to='2010-07-01T00:00'))")
    out.append("Count(Row(t=1, from='2010-03-15T00:00', "
               "to='2010-07-01T00:00'))")
    out += READS
    return out


def _run(api, stk):
    results, uploads = [], []
    for pql in _steps():
        before = stk.UPLOAD_STATS["count"]
        results.append(plain(api.query("i", pql)))
        uploads.append(stk.UPLOAD_STATS["count"] - before)
    return results, uploads


@pytest.fixture(scope="module")
def ran():
    ours, theirs = TorchAPI(device="cpu"), JaxAPI()
    _schema_and_data(ours)
    _schema_and_data(theirs)
    return ours, theirs, _run(ours, tstk), _run(theirs, jstk)


def test_every_result_matches(ran):
    _, _, (got, _), (want, _) = ran
    steps = _steps()
    assert len(got) == len(want) == len(steps)
    for step, g, w in zip(steps, got, want):
        assert g == w, step


def test_results_are_not_trivial(ran):
    _, _, (got, _), _ = ran
    steps = _steps()
    first = dict(zip(steps, got))
    assert first[READS[0]][0] > 0
    assert len(first[READS[2]][0]["pairs"]) == 3
    assert first[f"IncludesColumn(Row(t=1, {RANGE}), column={SW - 1})"] \
        == [True]


def test_uploads_per_step_match(ran):
    """Each step uploads as many stacks in the port as in the JAX
    package: the same view stacks advance, build and rebuild."""
    _, _, (_, got), (_, want) = ran
    assert got == want
    assert 0 < sum(got) < len(got)


def _fragments(api):
    for fname, fld in sorted(api.holder.index("i").fields.items()):
        for view, frags in sorted(fld.views.items()):
            for shard, frag in sorted(frags.items()):
                yield (fname, view, shard), frag
        for shard, frag in sorted(fld.bsi.items()):
            yield (fname, "bsi", shard), frag


def test_host_planes_per_view_match(ran):
    ours, theirs, _, _ = ran
    a, b = dict(_fragments(ours)), dict(_fragments(theirs))
    assert a.keys() == b.keys()
    assert len({k[1] for k in a}) > 20  # standard, year, months, days
    for key, fa in a.items():
        fb = b[key]
        np.testing.assert_array_equal(fa.planes, fb.planes, err_msg=str(key))
        assert fa.version == fb.version, key
        if key[1] != "bsi":
            assert fa.row_index == fb.row_index, key


# ---------------------------------------------------------------------------
# convert.load_state with time views
# ---------------------------------------------------------------------------


def jax_state(japi) -> dict:
    """Plain-Python state of a JAX holder in convert.load_state's form,
    every view of every field."""
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
                  "shards": {}, "views": {},
                  "bsi": {s: fr.planes.copy() for s, fr in f.bsi.items()}}
            for view, frags in f.views.items():
                dst = (fd["shards"] if view == "standard"
                       else fd["views"].setdefault(view, {}))
                for shard, frag in frags.items():
                    n = len(frag.row_ids)
                    dst[shard] = {"row_ids": list(frag.row_ids),
                                  "planes": frag.planes[:n].copy()}
            d["fields"].append(fd)
        out["indexes"].append(d)
    return out


@pytest.mark.parametrize("pql", READS)
def test_load_state_answers_ranged_reads_like_the_source(ran, pql):
    _, theirs, _, _ = ran
    loaded = _loaded(theirs)
    assert plain(loaded.query("i", pql)) == plain(theirs.query("i", pql))


_LOADED = {}


def _loaded(theirs):
    if id(theirs) not in _LOADED:
        api = TorchAPI(device="cpu")
        convert.load_state(api, jax_state(theirs))
        _LOADED[id(theirs)] = api
    return _LOADED[id(theirs)]


def test_load_state_carries_every_view(ran):
    _, theirs, _, _ = ran
    loaded = _loaded(theirs)
    for fname in ("t", "tk", "f"):
        assert (loaded.holder.index("i").field(fname).view_names()
                == theirs.holder.index("i").field(fname).view_names())
