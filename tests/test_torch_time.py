"""The time slice's modules against the JAX package, on the CPU.

The same seeded inputs go through ``pilosa_tpu`` and ``pilosa_tpu_torch``:
a ``time`` field's write views and range covers (``Field._write_views``,
``Field.range_views``) over the quantums Y, YM, YMD and YMDH, open and
closed ranges, naive and aware times; ``StackedSet.take_rows`` and
``rows_plane`` against the JAX stacks (one block and paged, absent rows
included); the per-shard ``Shift`` against ``jax.vmap(B.plane_shift)``;
and the lowering of a ranged ``Row`` (a zero leaf OR-chained with one
leaf per covering view), over more than 32 views too. Tolerance 0: view
names, bitmaps and counts.
"""

import datetime as dt

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pilosa_tpu.api import API as JaxAPI
from pilosa_tpu.core import fragment as jfrag
from pilosa_tpu.core import stacked as jstk
from pilosa_tpu.core.field import Field as JField
from pilosa_tpu.core.schema import FieldOptions as JFieldOptions
from pilosa_tpu.core.schema import FieldType as JFieldType
from pilosa_tpu.ops import bitmap as JB
from pilosa_tpu.pql import programs as jprog
from pilosa_tpu.pql.parser import parse as jparse
from pilosa_tpu_torch.api import API as TorchAPI
from pilosa_tpu_torch.core import fragment as tfrag
from pilosa_tpu_torch.core import stacked as tstk
from pilosa_tpu_torch.core.field import Field as TField
from pilosa_tpu_torch.core.schema import FieldOptions as TFieldOptions
from pilosa_tpu_torch.core.schema import FieldType as TFieldType
from pilosa_tpu_torch.ops import bitmap as B
from pilosa_tpu_torch.pql import programs as tprog
from pilosa_tpu_torch.pql.parser import parse as tparse
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, WORDS_PER_SHARD

CPU = torch.device("cpu")
UTC = dt.timezone.utc
W = 256  # words per shard of the stack-level cases


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.numpy().view(np.uint32)
    return np.asarray(x).view(np.uint32)


# ---------------------------------------------------------------------------
# write views and range covers
# ---------------------------------------------------------------------------

QUANTUMS = ["Y", "YM", "YMD", "YMDH"]


def _time_fields(quantum):
    ours = TField("t", TFieldOptions(type=TFieldType.TIME,
                                     time_quantum=quantum), CPU)
    theirs = JField("i", "t", JFieldOptions(type=JFieldType.TIME,
                                            time_quantum=quantum))
    return ours, theirs


def _stamps(aware: bool):
    rng = np.random.default_rng(8)
    base = dt.datetime(2009, 11, 20)
    out = [base + dt.timedelta(hours=int(h))
           for h in rng.integers(0, 24 * 800, 60)]
    out += [dt.datetime(2010, 1, 1), dt.datetime(2010, 12, 31, 23),
            dt.datetime(2011, 3, 1, 5)]
    return [s.replace(tzinfo=UTC) for s in out] if aware else out


@pytest.mark.parametrize("aware", [False, True])
@pytest.mark.parametrize("quantum", QUANTUMS)
def test_write_views_match(quantum, aware):
    ours, theirs = _time_fields(quantum)
    for ts in _stamps(aware) + [None]:
        assert ours._write_views(ts) == theirs._write_views(ts), ts


RANGES = [
    ("2010-01-01T00:00", "2011-01-01T00:00"),   # a whole year
    ("2010-03-01T00:00", "2010-07-01T00:00"),   # whole months
    ("2010-03-15T00:00", "2010-07-01T00:00"),   # days, then months
    ("2010-02-03T05:00", "2010-02-04T07:30"),   # hours at both ends
    ("2009-12-31T23:00", "2011-02-01T01:00"),   # every level
    ("2010-06-01T00:00", None),                  # open above
    (None, "2010-06-01T00:00"),                  # open below
    ("2010-05-05T00:00", "2010-05-05T00:00"),   # empty
]


def _ts(s, aware):
    if s is None:
        return None
    t = dt.datetime.fromisoformat(s)
    return t.replace(tzinfo=UTC) if aware else t


@pytest.mark.parametrize("aware", [False, True])
@pytest.mark.parametrize("rng_", RANGES, ids=[f"r{i}" for i in
                                              range(len(RANGES))])
@pytest.mark.parametrize("quantum", QUANTUMS)
def test_range_views_match(quantum, rng_, aware):
    """Both packages name the same covering views, only those holding
    data, with writes made from naive or aware times alike."""
    ours, theirs = _time_fields(quantum)
    for i, ts in enumerate(_stamps(aware)):
        assert ours.set_bit(1, i, ts) == theirs.set_bit(1, i, ts)
    assert ours.view_names() == theirs.view_names()
    lo, hi = (_ts(x, aware) for x in rng_)
    got, want = ours.range_views(lo, hi), theirs.range_views(lo, hi)
    assert got == want
    assert set(got) <= set(ours.views)


def test_range_views_of_non_time_field_raise():
    ours = TField("s", TFieldOptions(), CPU)
    theirs = JField("i", "s", JFieldOptions())
    assert ours.range_views(None, None) == theirs.range_views(None, None)
    for f in (ours, theirs):
        with pytest.raises(ValueError):
            f.range_views(dt.datetime(2010, 1, 1), None)
        with pytest.raises(ValueError):
            f.set_bit(1, 1, dt.datetime(2010, 1, 1))


def test_invalid_quantum_rejected():
    with pytest.raises(ValueError):
        TField("t", TFieldOptions(type=TFieldType.TIME, time_quantum="YD"),
               CPU)
    api = TorchAPI(device="cpu")
    api.create_index("i")
    with pytest.raises(ValueError):
        api.create_field("i", "t", {"type": "time", "timeQuantum": "HY"})
    api.create_field("i", "t", {"type": "time", "timeQuantum": "MDH"})
    assert api.holder.index("i").field("t").options.time_quantum == "MDH"


# ---------------------------------------------------------------------------
# take_rows and rows_plane
# ---------------------------------------------------------------------------


def _frags(seed, rows, shards=3):
    rng = np.random.default_rng(seed)
    ts, js = [], []
    for _ in range(shards):
        r = np.repeat(rows, 30)
        c = rng.integers(0, W * 32, r.size)
        a, b = tfrag.SetFragment(0, CPU, words=W), jfrag.SetFragment(0,
                                                                     words=W)
        a.set_many(r, c)
        b.set_many(r, c)
        ts.append(a)
        js.append(b)
    return ts, js


SELECTIONS = [[0], [3, 1], [2, 99, 0], [99], [], list(range(40)),
              [39, 0, 17, 8, 25]]


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("sel", SELECTIONS,
                         ids=[f"s{i}" for i in range(len(SELECTIONS))])
def test_take_rows_and_rows_plane_match(monkeypatch, paged, sel):
    if paged:  # blocks of 8 rows
        for m in (tstk, jstk):
            monkeypatch.setattr(m, "_BLOCK_BYTES", 16 * 3 * W * 4)
    rows = np.arange(0, 40, 1)[np.arange(40) % 3 != 2]  # some ids absent
    t_frags, j_frags = _frags(len(sel) + paged, rows)
    ts = tstk.StackedSet([0, 1, 2], t_frags, CPU, words=W)
    js = jstk.StackedSet([0, 1, 2], j_frags, words=W)
    assert ts.paged == js.paged == paged
    if sel:
        np.testing.assert_array_equal(_np(ts.take_rows(sel)),
                                      _np(js.take_rows(sel)))
    np.testing.assert_array_equal(_np(ts.rows_plane(sel)),
                                  _np(js.rows_plane(sel)))
    ts.release_device()


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 13])
def test_rows_or_matches_reduce(n):
    rng = np.random.default_rng(n)
    host = rng.integers(0, 1 << 32, (n, 64), dtype=np.uint32)
    want = np.bitwise_or.reduce(host, axis=0)
    got = B.rows_or(torch.from_numpy(host.view(np.int32).copy()))
    np.testing.assert_array_equal(_np(got), want)


# ---------------------------------------------------------------------------
# Shift, per shard
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 33])
@pytest.mark.parametrize("seed", [0, 1])
def test_per_shard_shift_matches_vmap(seed, n):
    """Three full shards, the top bit of each shard's last word set: the
    carry stops at every shard boundary, as in ``jax.vmap``."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << 32, (3, WORDS_PER_SHARD), dtype=np.uint32)
    a[:, -1] |= np.uint32(1 << 31)
    a[:, 0] |= np.uint32(1 << 31)
    ours = torch.from_numpy(a.view(np.int32).copy())
    theirs = jnp.asarray(a)
    for _ in range(n):
        ours = B.plane_shift(ours)
        theirs = jax.vmap(JB.plane_shift)(theirs)
    np.testing.assert_array_equal(_np(ours), np.asarray(theirs))
    # the flat shift would have carried into the next shard's bit 0
    flat = B.plane_shift(torch.from_numpy(a.view(np.int32).copy())
                         .reshape(-1)).reshape(3, -1)
    assert not torch.equal(flat, B.plane_shift(
        torch.from_numpy(a.view(np.int32).copy())))


# ---------------------------------------------------------------------------
# ranged lowering
# ---------------------------------------------------------------------------


def _day_index(api, days: int):
    api.create_index("i")
    api.create_field("i", "t", {"type": "time", "timeQuantum": "YMD"})
    rng = np.random.default_rng(days)
    start = dt.datetime(2010, 3, 1)
    for d in range(days):
        day = start + dt.timedelta(days=d)
        for col in rng.integers(0, 2 * SHARD_WIDTH, 3):
            api.query("i", f"Set({int(col)}, t={d % 3}, "
                           f"{day.strftime('%Y-%m-%dT%H:%M')})")


@pytest.fixture(scope="module")
def day_apis():
    ours, theirs = TorchAPI(device="cpu"), JaxAPI()
    _day_index(ours, 70)
    _day_index(theirs, 70)
    return ours, theirs


LOWERED = [
    "Row(t=1, from='2010-03-01T00:00', to='2010-05-01T00:00')",  # 2 months
    "Row(t=0, from='2010-03-03T00:00', to='2010-03-06T00:00')",  # 3 days
    "Row(t=2, from='2010-03-02T00:00', to='2010-04-20T00:00')",  # 49 views
    "Row(t=1, from='2010-03-02T00:00', to='2010-05-05T00:00')",  # 34 views
    "Intersect(Row(t=1, from='2010-03-02T00:00'), Row(t=0))",
    "Row(t=9, from='2010-03-01T00:00', to='2010-05-01T00:00')",
    "Row(t=1, from='2011-03-01T00:00', to='2011-05-01T00:00')",  # no views
]


@pytest.mark.parametrize("pql", LOWERED)
def test_ranged_lowering_matches(day_apis, pql):
    """The port lowers a ranged Row to the JAX package's tape (a zero leaf
    plus one leaf per covering view, OR-chained) over equal leaves, and
    counts it alike, through the two-operand reduction past 32 views."""
    ours, theirs = day_apis
    shards = [0, 1]
    tidx, jidx = ours.holder.index("i"), theirs.holder.index("i")
    ttape, tleaves = tprog._lower_root(ours.executor, tidx, tparse(pql)
                                       .calls[0], shards)
    jtape, jleaves = jprog._lower_root(theirs.executor, jidx, jparse(pql)
                                       .calls[0], shards)
    # a bare-leaf root: the port pins it with or(x, x), the one op the
    # kernel needs; the JAX package returns the leaf with no op
    assert ttape == (jtape or (("or", 0, 0),))
    assert len(tleaves) == len(jleaves)
    for a, b in zip(tleaves, jleaves):
        np.testing.assert_array_equal(_np(a), _np(b))
    count = f"Count({pql})"
    assert ours.query("i", count) == theirs.query("i", count)
    assert ours.query("i", pql)[0].columns == theirs.query("i", pql)[0].columns


def test_lowering_past_32_views_uses_the_reduction(day_apis):
    ours, _ = day_apis
    idx = ours.holder.index("i")
    tape, leaves = tprog._lower_root(
        ours.executor, idx, tparse(LOWERED[2]).calls[0], [0, 1])
    assert len(leaves) == 50 and len(tape) == 49
    assert not B.tape_fits(tape, len(leaves))
