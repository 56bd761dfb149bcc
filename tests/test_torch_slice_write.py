"""The write slice end to end against the JAX package, on the CPU.

The same schema and seeded data go into ``pilosa_tpu.api.API`` and
``pilosa_tpu_torch.api.API(device="cpu")``: an index of two full-width
shards with set, keyed set, mutex, bool, int and decimal fields, and a
keyed index. Then the same sequence runs on both: ``chip_smoke.py`` path
6's write mix at small size. It interleaves ``Set`` / ``Clear`` /
``ClearRow`` / ``Store`` / ``Delete`` (keyed and unkeyed, some beside
reads in one request) with small and large imports and the reads they
must show up in. After every step the results, and the number of stack
uploads the step caused, must be equal. At the end every fragment's host
planes, version and write-delta log must be equal. Tolerance 0: bitmaps
and integers (decimals compare as the same floats).
"""

import dataclasses

import numpy as np
import pytest

from pilosa_tpu.api import API as JaxAPI
from pilosa_tpu.core import stacked as jstk
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


def _schema_and_data(api):
    rng = np.random.default_rng(21)
    api.create_index("w")
    api.create_field("w", "s")
    api.create_field("w", "sk", {"type": "set", "keys": True})
    api.create_field("w", "m", {"type": "mutex"})
    api.create_field("w", "b", {"type": "bool"})
    api.create_field("w", "n", {"type": "int"})
    api.create_field("w", "d", {"type": "decimal", "scale": 2})
    cols = rng.integers(0, 2 * SW, 6000)
    api.import_bits("w", "s", rows=rng.integers(0, 8, 6000), cols=cols)
    api.import_bits("w", "sk", cols=cols[:2000],
                    row_keys=[f"k{int(x)}" for x in
                              rng.integers(0, 5, 2000)])
    api.import_bits("w", "m", rows=rng.integers(0, 4, 3000), cols=cols[:3000])
    api.import_bits("w", "b", rows=rng.integers(0, 2, 500), cols=cols[:500])
    api.import_values("w", "n", cols=cols[:2000],
                      values=rng.integers(-500, 5000, 2000))
    api.import_values("w", "d", cols=cols[:500],
                      values=np.round(rng.random(500) * 10, 2))
    api.create_index("k", {"keys": True})
    api.create_field("k", "f")
    api.create_field("k", "v", {"type": "int"})
    names = [f"u{i}" for i in range(300)]
    api.import_bits("k", "f", rows=rng.integers(0, 3, 300), col_keys=names)
    api.import_values("k", "v", col_keys=names[:200],
                      values=rng.integers(0, 100, 200))


READS = ["Count(Row(s=1))", "TopN(s, n=5)", "Row(m=2)",
         "Count(Intersect(Row(s=1), Row(m=2)))", "Sum(field=n)",
         "Sum(Row(s=2), field=n)", "Count(Row(n > 100))", "Min(field=n)",
         "Max(field=d)", "GroupBy(Rows(m), Rows(s))", 'TopN(sk)',
         "Count(All())", "Count(Not(Row(b=true)))", "Count(Row(d > 5.5))"]


def _steps():
    """(kind, index, payload): PQL queries and imports, with a read after
    most writes so the stacks advance (or rebuild) between them."""
    rng = np.random.default_rng(22)
    out = []

    def q(pql, index="w"):
        out.append(("q", index, pql))

    for r in READS:
        q(r)
    for pql in ["Set(5, s=1)", "Set(%d, s=9)" % (SW + 9), "Clear(5, s=1)",
                "Set(7, m=3)", "Set(7, b=true)", "Set(7, b=false)",
                "Set(8, n=42)", "Set(9, n=-7)", "Clear(8, n=42)",
                "Set(11, d=3.25)", 'Set(12, sk="zz")', 'Clear(12, sk="zz")',
                'Set(13, sk="k1")']:
        q(pql)
        q("Count(Row(s=1))TopN(s, n=3)Row(m=3)Sum(field=n)Max(field=d)"
          'TopN(sk)Count(Row(b=true))')
    for _ in range(40):  # random single writes, each followed by reads
        col = int(rng.integers(0, 2 * SW))
        op = rng.choice(["Set", "Clear"])
        which = rng.choice(["s", "m", "n", "b"])
        if which == "n":
            q(f"{op}({col}, n={int(rng.integers(-900, 9000))})")
        elif which == "b":
            q(f"{op}({col}, b={'true' if rng.random() < 0.5 else 'false'})")
        else:
            q(f"{op}({col}, {which}={int(rng.integers(0, 6))})")
        q(READS[int(rng.integers(0, len(READS)))])
        q("GroupBy(Rows(m), Rows(s))Sum(Row(m=1), field=n)")
    q("Set(100, s=1)Set(100, m=2)Count(Row(s=1))Row(m=2)")
    q("Count(Intersect(Row(s=1), Row(m=2)))")
    out.append(("bits", "w", ("s", rng.integers(0, 10, 100),
                              rng.integers(0, 2 * SW, 100))))
    q("TopN(s, n=10)")
    out.append(("bits", "w", ("s", rng.integers(0, 10, 6000),
                              rng.integers(0, 2 * SW, 6000))))
    q("TopN(s, n=10)")
    out.append(("bits", "w", ("m", rng.integers(0, 5, 100),
                              rng.integers(0, 2 * SW, 100))))
    q("TopN(m)GroupBy(Rows(m), Rows(s))")
    out.append(("bits", "w", ("m", rng.integers(0, 5, 3000),
                              rng.integers(0, 2 * SW, 3000))))
    q("TopN(m)")
    out.append(("values", "w", ("n", rng.integers(0, 2 * SW, 50),
                                rng.integers(-100, 100, 50))))
    q("Sum(field=n)Count(Row(n < 0))")
    out.append(("values", "w", ("n", rng.integers(0, 2 * SW, 3000),
                                rng.integers(-100, 100, 3000))))
    q("Sum(field=n)Count(Row(n < 0))")
    q(f"Set({SW + 77}, n={1 << 21})")  # depth growth
    q("Sum(field=n)Max(field=n)Count(Row(n > 1000000))")
    q("Store(Intersect(Row(s=1), Row(m=0)), s=20)")
    q("Count(Row(s=20))TopN(s, n=20)")
    q("Store(Row(m=1), s=0)Count(Row(s=0))")
    q("ClearRow(s=2)")
    q("Count(Row(s=2))TopN(s, n=20)")
    q("Options(ClearRow(s=3), shards=[1])")
    q("Row(s=3)")
    q("Delete(Row(s=4))")
    for r in READS:
        q(r)
    q("Count(Row(s=1))Set(101, s=1)Count(Row(s=1))Delete(Row(s=1))"
      "Count(Row(s=1))")
    q("Count(Row(s=1))Count(All())")
    # the keyed index
    for pql in ['Set("alice", f=1)', 'Set("bob", v=5)', 'Clear("alice", f=1)',
                'Set("u3", f=2)', 'Clear("nobody", f=2)', 'Delete(Row(f=2))',
                'Set("carol", f=7)Store(Row(f=1), f=9)']:
        q(pql, "k")
        q("Count(Row(f=1))TopN(f)Sum(field=v)Count(All())Row(f=9)", "k")
    return out


def _run(api, stk):
    results, uploads = [], []
    for kind, index, payload in _steps():
        before = stk.UPLOAD_STATS["count"]
        if kind == "q":
            results.append(plain(api.query(index, payload)))
        elif kind == "bits":
            field, rows, cols = payload
            results.append(int(api.import_bits(index, field, rows=rows,
                                               cols=cols)))
        else:
            field, cols, values = payload
            results.append(int(api.import_values(index, field, cols=cols,
                                                 values=values)))
        uploads.append(stk.UPLOAD_STATS["count"] - before)
    return results, uploads


@pytest.fixture(scope="module")
def ran():
    ours, theirs = TorchAPI(device="cpu"), JaxAPI()
    _schema_and_data(ours)
    _schema_and_data(theirs)
    return (ours, theirs, _run(ours, tstk), _run(theirs, jstk))


def test_every_result_matches(ran):
    _, _, (got, _), (want, _) = ran
    steps = _steps()
    assert len(got) == len(want) == len(steps)
    for step, g, w in zip(steps, got, want):
        assert g == w, step


def test_uploads_per_step_match(ran):
    """Each step uploads as many stacks in the port as in the JAX
    package: the same writes advance, the same rebuild."""
    _, _, (_, got), (_, want) = ran
    assert got == want
    assert 0 < sum(got) < len(got)  # both advances and rebuilds ran


def _fragments(api):
    for iname, idx in sorted(api.holder.indexes.items()):
        for fname, fld in sorted(idx.fields.items()):
            for view, frags in sorted(fld.views.items()):
                for shard, frag in sorted(frags.items()):
                    yield (iname, fname, view, shard), frag
            for shard, frag in sorted(fld.bsi.items()):
                yield (iname, fname, "bsi", shard), frag


def test_host_planes_versions_and_logs_match(ran):
    ours, theirs, _, _ = ran
    a, b = dict(_fragments(ours)), dict(_fragments(theirs))
    assert a.keys() == b.keys()
    for key, fa in a.items():
        fb = b[key]
        np.testing.assert_array_equal(fa.planes, fb.planes, err_msg=str(key))
        assert fa.version == fb.version, key
        if key[2] != "bsi":
            assert fa.row_index == fb.row_index, key
        da, db = fa.deltas, fb.deltas
        assert (da.base, da.head, da.cost, list(da.ops)) == \
            (db.base, db.head, db.cost, list(db.ops)), key


def test_translate_stores_match(ran):
    ours, theirs, _, _ = ran
    for fname in ("sk",):
        fa = ours.holder.index("w").field(fname).translate
        fb = theirs.holder.index("w").field(fname).translate
        keys = [f"k{i}" for i in range(5)] + ["zz"]
        assert fa.find_keys(keys) == fb.find_keys(keys)
    names = ["alice", "bob", "carol", "nobody", "u3"]
    assert ours.holder.index("k").translate.find_keys(names) == \
        theirs.holder.index("k").translate.find_keys(names)
