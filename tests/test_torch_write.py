"""The write path and the stack advance of the port against the JAX package.

Every case runs on the CPU (``device="cpu"``), from numpy inputs made
from a seed, and compares with ``pilosa_tpu`` exactly (tolerance 0:
bitmaps, versions and integers):

- ``_DeltaLog`` and ``_MaskAccum`` against the JAX classes;
- each fragment write: equal planes, ``version`` and delta log
  (``ops`` / ``base`` / ``head`` / ``cost``);
- ``_advance_set`` (unpaged grow, paged append, a compressed block that
  decays and one that stays compressed) and ``_advance_bsi``: the
  advanced stack's dense planes equal the JAX package's advanced stack's
  and a fresh rebuild's, and no stack is uploaded;
- the cases of ``tests/test_stacked_merge.py`` and the advance and append
  cases of ``tests/test_paging.py``, each run on both packages, with each
  package's ``UPLOAD_STATS``.
"""

import numpy as np
import pytest
import torch

from pilosa_tpu.core import fragment as jfrag
from pilosa_tpu.core import stacked as jstk
from pilosa_tpu.core.holder import Holder as JHolder
from pilosa_tpu.core.schema import FieldOptions as JFieldOptions
from pilosa_tpu.core.schema import FieldType as JFieldType
from pilosa_tpu.pql.executor import Executor as JExecutor
from pilosa_tpu.shardwidth import SHARD_WIDTH
from pilosa_tpu.storage.txn import TxFactory
from pilosa_tpu_torch.core import fragment as tfrag
from pilosa_tpu_torch.core import stacked as tstk
from pilosa_tpu_torch.core.holder import Holder as THolder
from pilosa_tpu_torch.core.schema import FieldOptions as TFieldOptions
from pilosa_tpu_torch.core.schema import FieldType as TFieldType
from pilosa_tpu_torch.pql.executor import Executor as TExecutor
from pilosa_tpu_torch.storage.txn import in_write_qcx, write_qcx

CPU = torch.device("cpu")
W = 256  # words per shard of the fragment- and stack-level cases


def _dense_np(blk) -> np.ndarray:
    """A resident entry of either package as host uint32."""
    if isinstance(blk, torch.Tensor):
        return blk.numpy().view(np.uint32)
    return np.asarray(blk).view(np.uint32)


# ---------------------------------------------------------------------------
# _DeltaLog and _MaskAccum
# ---------------------------------------------------------------------------


def _log_state(log):
    return log.base, log.head, log.cost, list(log.ops)


@pytest.mark.parametrize("seed", range(8))
def test_delta_log_matches(seed):
    """Random records (continuations, next versions, gaps), costs up to
    the column cap and resets; every state and ``since`` answer equal."""
    rng = np.random.default_rng(seed)
    a, b = tfrag._DeltaLog(), jfrag._DeltaLog()
    version = 0
    for step in range(1500):
        kind = rng.random()
        if kind < 0.02:
            version += 1
            a.reset(version)
            b.reset(version)
        else:
            jump = int(rng.choice([0, 1, 1, 1, 2])) if step else 1
            version += jump
            cost = int(rng.integers(1, 40)) if rng.random() < 0.9 else \
                int(rng.integers(1, 4097))
            payload = (int(rng.integers(0, 9)), (step,), ())
            a.record(version, payload, cost=cost)
            b.record(version, payload, cost=cost)
        assert _log_state(a) == _log_state(b)
        for base in (a.base - 1, a.base, (a.base + a.head) // 2, a.head,
                     a.head + 1):
            for cur in (a.head, a.head + 1):
                assert a.since(base, cur) == b.since(base, cur)


@pytest.mark.parametrize("cap", ["ops", "cols"])
def test_delta_log_overflow(cap):
    """512 ops, or 4,096 columns of cost, fit; one more resets."""
    a, b = tfrag._DeltaLog(), jfrag._DeltaLog()
    assert tfrag._DELTA_MAX_OPS == jfrag._DELTA_MAX_OPS == 512
    assert tfrag._DELTA_MAX_COLS == jfrag._DELTA_MAX_COLS == 4096
    n, cost = (512, 1) if cap == "ops" else (4, 1024)
    for v in range(1, n + 1):
        a.record(v, ("p", v), cost=cost)
        b.record(v, ("p", v), cost=cost)
    assert len(a.ops) == n and a.cost == n * cost
    assert a.since(0, n) == b.since(0, n) and len(a.since(0, n)) == n
    a.record(n + 1, ("p", n + 1), cost=cost)
    b.record(n + 1, ("p", n + 1), cost=cost)
    assert _log_state(a) == _log_state(b) == (n + 1, n + 1, 0, [])
    assert a.since(0, n + 1) is None


@pytest.mark.parametrize("seed", range(4))
def test_mask_accum_matches(seed):
    rng = np.random.default_rng(seed)
    a, b = tstk._MaskAccum(), jstk._MaskAccum()
    for _ in range(3000):
        slot, word, bit = (int(x) for x in rng.integers(0, [6, 5, 32]))
        op = "set" if rng.random() < 0.5 else "clear"
        getattr(a, op)(slot, word, bit)
        getattr(b, op)(slot, word, bit)
    assert a.masks == b.masks


def test_mask_accum_resolves_in_order():
    a = tstk._MaskAccum()
    a.set(0, 0, 3)
    a.clear(0, 0, 3)
    a.clear(1, 0, 4)
    a.set(1, 0, 4)
    planes = torch.full((2, 2), -1, dtype=torch.int32)
    planes[1, 0] = 0
    out = a.apply(planes)
    assert out[0, 0].item() == -1 ^ (1 << 3)
    assert out[1, 0].item() == 1 << 4
    assert planes[0, 0].item() == -1 and planes[1, 0].item() == 0


# ---------------------------------------------------------------------------
# Fragment writes
# ---------------------------------------------------------------------------


def _set_pair(seed=5, rows=12):
    """Port and JAX set fragments with the same seeded bits, their logs
    reset by the bulk load."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, rows, 6000)
    c = rng.integers(0, W * 32, 6000)
    a, b = tfrag.SetFragment(0, CPU, words=W), jfrag.SetFragment(0, words=W)
    a.set_many(r, c)
    b.set_many(r, c)
    return a, b


def _bsi_pair(seed=6, depth_vals=1000):
    rng = np.random.default_rng(seed)
    cols = rng.choice(W * 32, 3000, replace=False)
    vals = rng.integers(-depth_vals, depth_vals, 3000)
    a, b = tfrag.BSIFragment(0, words=W), jfrag.BSIFragment(0, words=W)
    a.set_values(cols, vals)
    b.set_values(cols, vals)
    return a, b


def _same_fragment(a, b):
    np.testing.assert_array_equal(a.planes, b.planes)
    assert a.version == b.version
    assert _log_state(a.deltas) == _log_state(b.deltas)
    if hasattr(a, "row_ids"):
        assert a.row_ids == b.row_ids and a.row_index == b.row_index


def _plane(rng, density=0.3):
    bits = rng.random(W * 32) < density
    return np.packbits(bits, bitorder="little").view(np.uint32).copy()


def _ops_set(rng):
    """name -> f(frag): each a sequence of writes from the seeded rng,
    the same on both packages (a fresh rng per package)."""
    cols = rng.integers(0, W * 32, 5000)
    rows = rng.integers(0, 12, 5000)
    many_rows = np.arange(600) + 100
    ucols = np.unique(cols[:300])
    plane = _plane(rng)
    return {
        "set_bit": lambda f: [f.set_bit(int(r), int(c))
                              for r, c in zip(rows[:40], cols[:40])],
        "set_bit_new_rows": lambda f: [f.set_bit(50 + k, int(c))
                                       for k, c in enumerate(cols[:9])],
        "clear_bit": lambda f: [f.clear_bit(int(r), int(c))
                                for r, c in zip(rows[:300], cols[:300])],
        "clear_bit_absent_row": lambda f: f.clear_bit(99, 5),
        "set_then_clear": lambda f: (f.set_bit(3, 77), f.clear_bit(3, 77),
                                     f.set_bit(3, 77)),
        "set_many_small": lambda f: f.set_many(rows[:700], cols[:700]),
        "set_many_4096": lambda f: f.set_many(rows[:4096], cols[:4096]),
        "set_many_4097": lambda f: f.set_many(rows[:4097], cols[:4097]),
        "set_many_new_rows": lambda f: f.set_many(rows[:50] + 20, cols[:50]),
        "set_many_ops_overflow": lambda f: f.set_many(many_rows,
                                                      cols[:600]),
        "set_many_cost_overflow": lambda f: [
            f.set_many(rows[k:k + 1000], cols[k:k + 1000])
            for k in range(0, 5000, 1000)],
        # deduped per column, as Field.import_bits hands it over
        "set_mutex_many": lambda f: f.set_mutex_many(
            rows[:len(ucols)] % 5, ucols),
        "clear_column": lambda f: [f.clear_column(int(c))
                                   for c in cols[:30]],
        "clear_column_except": lambda f: [f.clear_column(int(c), except_row=3)
                                          for c in cols[:30]],
        "import_row_plane": lambda f: f.import_row_plane(4, plane),
        "import_row_plane_clear": lambda f: f.import_row_plane(5, plane,
                                                               clear=True),
        "import_row_plane_new": lambda f: f.import_row_plane(70, plane),
        "clear_row_plane_bits": lambda f: f.clear_row_plane_bits(2, plane),
        "clear_row_plane_bits_absent": lambda f: f.clear_row_plane_bits(
            77, plane),
        "clear_plane": lambda f: f.clear_plane(plane),
        "writes_after_reset": lambda f: (f.clear_plane(plane),
                                         f.set_bit(1, 9), f.clear_bit(1, 9),
                                         f.set_many([1, 2], [4, 5])),
    }


@pytest.mark.parametrize("name", sorted(_ops_set(np.random.default_rng(0))))
def test_set_fragment_write_matches(name):
    a, b = _set_pair()
    ra = _ops_set(np.random.default_rng(11))[name](a)
    rb = _ops_set(np.random.default_rng(11))[name](b)
    assert ra == rb
    _same_fragment(a, b)
    assert a.existing_rows() == b.existing_rows()
    for r in (0, 3, 50, 70, 99):
        assert a.has_row(r) == b.has_row(r)
        np.testing.assert_array_equal(a.row_plane(r), b.row_plane(r))


def _mutex_batch(rng, words, n, rows, lo_word=0):
    """``n`` columns deduped per column (as Field.import_bits hands them
    over) in words ``lo_word..words``, each with a row below ``rows``."""
    cols = np.unique(rng.integers(lo_word * 32, words * 32, n))
    return rng.integers(0, rows, cols.size), cols


def _mutex_batches(rng):
    """name -> (fragment seed rows, [(rows, cols), ...]): sequences of
    set_mutex_many batches, the same on both packages."""
    spread = _mutex_batch(rng, W, 400, 12)
    one_word = _mutex_batch(rng, 38, 20, 12, lo_word=37)
    run = np.arange(3000, 3500)  # 500 consecutive ids: one run of words
    return {
        "many_existing_rows": (300, [_mutex_batch(rng, W, 700, 300)]),
        "spread_over_words": (12, [spread]),
        "packed_in_one_word": (12, [one_word]),
        "consecutive_run": (40, [(rng.integers(0, 40, run.size), run),
                                 (rng.integers(0, 40, run.size), run + 500)]),
        "reassert_current_row": (12, [spread, spread]),
        "partly_reasserted": (12, [spread, (np.where(
            np.arange(spread[0].size) % 2 == 0, spread[0],
            (spread[0] + 1) % 12), spread[1])]),
        "new_rows_past_capacity": (6, [
            (np.arange(40) + 100, np.unique(rng.choice(W * 32, 40,
                                                       replace=False))),
            _mutex_batch(rng, W, 200, 160)]),
        "empty_batch": (12, [(np.zeros(0, np.int64), np.zeros(0, np.int64)),
                             spread, (np.zeros(0, np.int64),
                                      np.zeros(0, np.int64))]),
        "last_word": (12, [_mutex_batch(rng, W, 20, 12, lo_word=W - 1),
                           (np.array([3, 7]), np.array([W * 32 - 32,
                                                        W * 32 - 1]))]),
        "empty_fragment": (0, [_mutex_batch(rng, W, 300, 9)]),
        "after_set_bits": (12, [
            ("set", np.arange(5), np.arange(5) * 33), spread]),
    }


@pytest.mark.parametrize("name", sorted(_mutex_batches(
    np.random.default_rng(0))))
@pytest.mark.parametrize("paranoia", [False, True], ids=["", "paranoia"])
def test_set_mutex_many_matches(name, paranoia, monkeypatch):
    """The port's set_mutex_many (its work on the batch's words only)
    against the JAX package's (every row plane AND the whole touched
    plane): planes, slots, return values, versions and delta logs."""
    monkeypatch.setattr(tfrag, "PARANOIA", paranoia)
    monkeypatch.setattr(jfrag, "PARANOIA", paranoia)
    seed_rows, batches = _mutex_batches(np.random.default_rng(13))[name]
    if seed_rows:
        a, b = _set_pair(seed=7, rows=seed_rows)
    else:
        a, b = tfrag.SetFragment(0, CPU, words=W), jfrag.SetFragment(0, words=W)
    for batch in batches:
        if isinstance(batch[0], str):  # plain set_bit writes first
            for f in (a, b):
                for r, c in zip(batch[1], batch[2]):
                    f.set_bit(int(r), int(c))
            continue
        rows, cols = batch
        assert a.set_mutex_many(rows, cols) == b.set_mutex_many(rows, cols)
        _same_fragment(a, b)
    assert a.planes.shape == b.planes.shape


def test_set_many_stops_recording_after_midloop_reset(monkeypatch):
    """After an overflow resets the log inside a bulk import, the rest of
    the import is not recorded, and the next write gets a fresh log."""
    monkeypatch.setattr(tfrag, "_DELTA_MAX_OPS", 4)
    frag = tfrag.SetFragment(0, CPU, words=W)
    for r in range(8):
        frag.set_bit(r, 0)
    frag.deltas.reset(frag.version)
    frag.set_many(list(range(8)), [100 + r for r in range(8)])
    assert frag.deltas.base == frag.version
    assert len(frag.deltas.ops) == 0
    assert frag.set_bit(0, 200)
    assert len(frag.deltas.ops) == 1


def _ops_bsi(rng):
    cols = rng.choice(W * 32, 2000, replace=False)
    vals = rng.integers(-500, 500, 2000)
    plane = _plane(rng)
    return {
        "set_values_one": lambda f: f.set_values(cols[:1], vals[:1]),
        "set_values_small": lambda f: f.set_values(cols[:100], vals[:100]),
        "set_values_duplicates": lambda f: f.set_values(
            np.concatenate([cols[:50], cols[:50]]), np.arange(100) - 50),
        "set_values_growth": lambda f: f.set_values(cols[:3], [1 << 20, 4,
                                                              -(1 << 33)]),
        "set_values_cost_over": lambda f: f.set_values(cols[:400],
                                                       vals[:400]),
        "set_values_many_small": lambda f: [
            f.set_values(cols[k:k + 1], vals[k:k + 1]) for k in range(300)],
        "set_value": lambda f: f.set_value(int(cols[7]), -3),
        "clear_value": lambda f: [f.clear_value(int(c)) for c in cols[:50]],
        "clear_value_absent": lambda f: f.clear_value(W * 32 - 1)
        if not (f.planes[0, -1] >> 31) & 1 else None,
        "clear_plane": lambda f: f.clear_plane(plane),
    }


@pytest.mark.parametrize("name", sorted(_ops_bsi(np.random.default_rng(0))))
def test_bsi_fragment_write_matches(name):
    a, b = _bsi_pair()
    ra = _ops_bsi(np.random.default_rng(12))[name](a)
    rb = _ops_bsi(np.random.default_rng(12))[name](b)
    assert ra == rb
    _same_fragment(a, b)
    assert a.depth == b.depth
    for c in range(0, W * 32, 997):
        assert a.value(c) == b.value(c)


# ---------------------------------------------------------------------------
# Stack advance at the stack level
# ---------------------------------------------------------------------------


def _stacks(t_frags, j_frags):
    return (tstk.StackedSet(list(range(len(t_frags))), t_frags, CPU,
                            words=W),
            jstk.StackedSet(list(range(len(j_frags))), j_frags, words=W))


def _set_blocks(st):
    return [None if b is None else _dense_np(tstk._dense(b)
                                             if isinstance(st, tstk.StackedSet)
                                             else jstk._dense(b))
            for b in st._blocks]


def _fresh_equal(st):
    """Every resident block of a port stack equals what a rebuild from
    the host planes would upload, in the stack's slot order."""
    for bi, blk in enumerate(st._blocks):
        if blk is not None:
            np.testing.assert_array_equal(_dense_np(tstk._dense(blk)),
                                          st._assemble_host(bi))


def _two_shard_frags(seed, rows, per_row=40):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        r = np.repeat(np.arange(rows), per_row)
        c = rng.integers(0, W * 32, r.size)
        a, b = tfrag.SetFragment(0, CPU, words=W), jfrag.SetFragment(0,
                                                                     words=W)
        a.set_many(r, c)
        b.set_many(r, c)
        out.append((a, b))
    return [a for a, _ in out], [b for _, b in out]


def _write_both(t_frags, j_frags, rng, n, rows, new_rows=()):
    """The same seeded bit writes (sets, clears, new rows) on both."""
    for k in range(n):
        si = int(rng.integers(0, len(t_frags)))
        row = int(rng.choice(list(rows) + list(new_rows)))
        col = int(rng.integers(0, W * 32))
        op = "set_bit" if rng.random() < 0.6 else "clear_bit"
        assert getattr(t_frags[si], op)(row, col) == \
            getattr(j_frags[si], op)(row, col)


@pytest.mark.parametrize("case", ["flips", "new_rows_in_cap", "grow"])
def test_advance_set_unpaged(case):
    t_frags, j_frags = _two_shard_frags(1, rows=5)
    ts, js = _stacks(t_frags, j_frags)
    assert not ts.paged and ts.cap == js.cap == 8
    old = _set_blocks(ts)
    vt, vj = ts._built_vers, js._built_vers
    rng = np.random.default_rng(2)
    new_rows = {"flips": (), "new_rows_in_cap": (5, 6, 7),
                "grow": tuple(range(5, 14))}[case]
    _write_both(t_frags, j_frags, rng, 60, range(5), new_rows)
    for nr in new_rows:  # every new row gets a bit
        t_frags[0].set_bit(nr, 1)
        j_frags[0].set_bit(nr, 1)
    up = dict(tstk.UPLOAD_STATS)
    ta = tstk._advance_set(ts, t_frags, vt)
    ja = jstk._advance_set(js, j_frags, vj)
    assert tstk.UPLOAD_STATS == up, "the advance uploaded a stack"
    assert ta is not None and ja is not None
    assert ta.row_ids == ja.row_ids and ta.cap == ja.cap
    assert ta.cap == (16 if case == "grow" else 8)
    for x, y in zip(_set_blocks(ta), _set_blocks(ja)):
        np.testing.assert_array_equal(x, y)
    _fresh_equal(ta)
    # the stack held from before the writes still holds the old planes
    for x, y in zip(_set_blocks(ts), old):
        np.testing.assert_array_equal(x, y)
    ta.release_device()
    ts.release_device()


def test_advance_set_unpaged_outgrows_block(monkeypatch):
    """Outgrowing one block is a rebuild (None) in both packages."""
    monkeypatch.setattr(tstk, "_BLOCK_BYTES", 16 * 2 * W * 4)
    monkeypatch.setattr(jstk, "_BLOCK_BYTES", 16 * 2 * W * 4)
    t_frags, j_frags = _two_shard_frags(3, rows=8)
    ts, js = _stacks(t_frags, j_frags)
    assert not ts.paged and ts.cap == 8
    vt, vj = ts._built_vers, js._built_vers
    for row in range(8, 17):  # 17 rows: 32 slots do not fit the block
        t_frags[1].set_bit(row, 3)
        j_frags[1].set_bit(row, 3)
    assert tstk._advance_set(ts, t_frags, vt) is None
    assert jstk._advance_set(js, j_frags, vj) is None
    ts.release_device()


@pytest.mark.parametrize("compress", ["0", "1"])
def test_advance_set_paged(monkeypatch, compress):
    """A paged stack (blocks of 8 rows): appends extend the block list,
    only resident blocks take the masks, and under forced compression a
    touched block decays to dense while an untouched one stays
    compressed."""
    monkeypatch.setenv("PILOSA_TPU_COMPRESS", compress)
    for m in (tstk, jstk):
        monkeypatch.setattr(m, "_BLOCK_BYTES", 16 * 2 * W * 4)
    monkeypatch.setattr(tstk, "BUDGET", tstk.DeviceBudget(1 << 30))
    monkeypatch.setattr(jstk, "BUDGET", jstk.DeviceBudget(1 << 30))
    t_frags, j_frags = _two_shard_frags(4, rows=30, per_row=6)
    ts, js = _stacks(t_frags, j_frags)
    assert ts.paged and ts.block_rows == js.block_rows == 8
    assert ts.n_blocks == 4
    for st in (ts, js):
        for bi in (0, 1, 3):  # block 2 stays unbuilt
            st._ensure_block(bi)
    old = _set_blocks(ts)
    vt, vj = ts._built_vers, js._built_vers
    rng = np.random.default_rng(5)
    # writes into rows of block 0 (and one in block 2, unbuilt), and new
    # rows 30-40: slot 30-31 in block 3, then two more blocks
    _write_both(t_frags, j_frags, rng, 40, range(0, 8))
    for f in (t_frags[0], j_frags[0]):
        f.set_bit(17, 123)
    for nr in range(30, 41):
        t_frags[1].set_bit(nr, nr)
        j_frags[1].set_bit(nr, nr)
    up = dict(tstk.UPLOAD_STATS)
    ta = tstk._advance_set(ts, t_frags, vt)
    ja = jstk._advance_set(js, j_frags, vj)
    assert tstk.UPLOAD_STATS == up
    assert ta.row_ids == ja.row_ids and ta.cap == ja.cap == 48
    assert ta.n_blocks == 6
    kinds = ["none" if b is None else
             "compressed" if isinstance(b, tstk.ctiles.CompressedBlock)
             else "dense" for b in ta._blocks]
    if compress == "1":
        assert kinds == ["dense", "compressed", "none", "dense", "none",
                         "none"]
    else:
        assert kinds == ["dense", "dense", "none", "dense", "none", "none"]
    assert ta._blocks[1] is ts._blocks[1]  # untouched: shared, as it was
    for x, y in zip(_set_blocks(ta), _set_blocks(ja)):
        if x is None:
            assert y is None
        else:
            np.testing.assert_array_equal(x, y)
    _fresh_equal(ta)
    # lazily built blocks of the advanced stack read the new host state
    for bi in range(ta.n_blocks):
        np.testing.assert_array_equal(_dense_np(tstk._dense(
            ta._ensure_block(bi))), ta._assemble_host(bi))
    for x, y in zip(_set_blocks(ts), old):
        if x is not None:
            np.testing.assert_array_equal(x, y)
    tstk.BUDGET.audit()


def _bsi_frags(seed, n_shards=2):
    rng = np.random.default_rng(seed)
    t, j = [], []
    for _ in range(n_shards):
        cols = rng.choice(W * 32, 1500, replace=False)
        vals = rng.integers(-3000, 3000, 1500)
        a, b = tfrag.BSIFragment(0, words=W), jfrag.BSIFragment(0, words=W)
        a.set_values(cols, vals)
        b.set_values(cols, vals)
        t.append(a)
        j.append(b)
    return t, j


@pytest.mark.parametrize("compress", ["0", "1"])
def test_advance_bsi(monkeypatch, compress):
    monkeypatch.setenv("PILOSA_TPU_COMPRESS", compress)
    t_frags, j_frags = _bsi_frags(7)
    ts = tstk.StackedBSI([0, 1], t_frags, CPU, words=W)
    js = jstk.StackedBSI([0, 1], j_frags, words=W)
    assert isinstance(ts._planes, tstk.ctiles.CompressedBlock) == \
        (compress == "1")
    old = _dense_np(ts.planes).copy()
    rng = np.random.default_rng(8)
    for _ in range(30):
        si = int(rng.integers(0, 2))
        col = int(rng.integers(0, W * 32))
        if rng.random() < 0.7:
            v = int(rng.integers(-4000, 4000))
            t_frags[si].set_values([col], [v])
            j_frags[si].set_values([col], [v])
        else:
            assert t_frags[si].clear_value(col) == j_frags[si].clear_value(
                col)
    up = dict(tstk.UPLOAD_STATS)
    ta = tstk._advance_bsi(ts, t_frags, ts._built_vers)
    ja = jstk._advance_bsi(js, j_frags, js._built_vers)
    assert tstk.UPLOAD_STATS == up
    assert isinstance(ta._planes, torch.Tensor)  # decayed to dense
    np.testing.assert_array_equal(_dense_np(ta.planes), _dense_np(ja.planes))
    np.testing.assert_array_equal(_dense_np(ta.planes), ta._assemble_host())
    np.testing.assert_array_equal(_dense_np(ts.planes), old)
    ta.release_device()
    ts.release_device()


@pytest.mark.parametrize("why", ["depth", "evicted", "cost", "appeared"])
def test_advance_bsi_rebuilds(why):
    """Depth growth, an evicted base, an overflowed log and a fragment
    that appeared: None (rebuild) in both packages."""
    t_frags, j_frags = _bsi_frags(9)
    if why == "appeared":
        t_frags[1], j_frags[1] = None, None
    ts = tstk.StackedBSI([0, 1], t_frags, CPU, words=W)
    js = jstk.StackedBSI([0, 1], j_frags, words=W)
    vt, vj = ts._built_vers, js._built_vers
    if why == "depth":
        t_frags[0].set_values([3], [1 << 40])
        j_frags[0].set_values([3], [1 << 40])
    elif why == "evicted":
        t_frags[0].set_values([3], [5])
        j_frags[0].set_values([3], [5])
        ts._drop()
        js._drop()
    elif why == "cost":
        cols = list(range(400))  # 400 x (2 + depth) > 4096
        t_frags[0].set_values(cols, [1] * 400)
        j_frags[0].set_values(cols, [1] * 400)
    else:
        t_frags[1], j_frags[1] = (tfrag.BSIFragment(1, words=W),
                                  jfrag.BSIFragment(1, words=W))
        t_frags[1].set_values([1], [1])
        j_frags[1].set_values([1], [1])
    assert tstk._advance_bsi(ts, t_frags, vt) is None
    assert jstk._advance_bsi(js, j_frags, vj) is None
    ts.release_device()


def test_apply_bit_deltas_writes_a_copy():
    planes = torch.arange(24, dtype=torch.int32).reshape(3, 8)
    before = planes.clone()
    slots = torch.tensor([0, 2], dtype=torch.int32)
    words = torch.tensor([1, 7], dtype=torch.int32)
    orm = torch.tensor(np.array([0x80000000, 1], dtype=np.uint32)
                       .view(np.int32))
    anm = torch.tensor(np.array([1, 0xFFFFFFFF], dtype=np.uint32)
                       .view(np.int32))
    out = tstk._apply_bit_deltas(planes, slots, words, orm, anm)
    assert torch.equal(planes, before)
    want = before.clone()
    want[0, 1] = (1 & ~1) | np.int32(-2**31)
    want[2, 7] = 1
    assert torch.equal(out, want)
    fresh = before.clone()
    assert tstk._apply_bit_deltas(fresh, slots, words, orm, anm,
                                  fresh=True) is fresh


# ---------------------------------------------------------------------------
# tests/test_stacked_merge.py and the advance cases of tests/test_paging.py,
# run on both packages
# ---------------------------------------------------------------------------


class _Pkg:
    """One package's holder, executor, schema types and counters."""

    def __init__(self, name):
        self.name = name
        if name == "jax":
            self.holder = JHolder()
            self.ex = JExecutor(self.holder)
            self.FO, self.FT, self.stk = JFieldOptions, JFieldType, jstk
        else:
            self.holder = THolder(CPU)
            self.ex = TExecutor(self.holder)
            self.FO, self.FT, self.stk = TFieldOptions, TFieldType, tstk

    def q(self, pql):
        return self.ex.execute("i", pql)

    def uploads(self):
        return self.stk.UPLOAD_STATS["count"]

    def clear_caches(self):
        for fld in self.holder.index("i").fields.values():
            if hasattr(fld, "_stacked_cache"):
                fld._stacked_cache.clear()

    def write_request(self):
        if self.name == "jax":
            return TxFactory(self.holder).qcx()
        return write_qcx(self.holder)


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    return _Pkg(request.param)


def _fill(p, rows=4, shards=2, per_row=50, field="f"):
    rng = np.random.default_rng(9)
    oracle = {r: set() for r in range(rows)}
    for s in range(shards):
        for r in range(rows):
            for c in rng.integers(0, SHARD_WIDTH, per_row):
                col = s * SHARD_WIDTH + int(c)
                p.q(f"Set({col}, {field}={r})")
                oracle[r].add(col)
    return oracle


def test_merge_setbit_between_queries_no_reupload(pkg):
    pkg.holder.create_index("i").create_field("f")
    oracle = _fill(pkg)
    pkg.q("Count(Row(f=0))")
    base = pkg.uploads()
    newcol = SHARD_WIDTH + 777
    assert newcol not in oracle[0]
    pkg.q(f"Set({newcol}, f=0)")
    oracle[0].add(newcol)
    got = pkg.q("Count(Row(f=0))TopN(f, n=2)")
    assert got[0] == len(oracle[0])
    assert pkg.uploads() == base, "setbit caused a full stack re-upload"
    for k in range(5):
        pkg.q(f"Clear({sorted(oracle[0])[k]}, f=0)")
        oracle[0].discard(sorted(oracle[0])[k])
    assert pkg.q("Count(Row(f=0))")[0] == len(oracle[0])
    assert pkg.uploads() == base


def test_merge_set_then_clear_same_bit_resolves_in_order(pkg):
    pkg.holder.create_index("i").create_field("f")
    _fill(pkg)
    pkg.q("Count(Row(f=1))")
    c = SHARD_WIDTH + 4242
    pkg.q(f"Set({c}, f=1)")
    pkg.q(f"Clear({c}, f=1)")
    assert c not in pkg.q("Row(f=1)")[0].columns
    pkg.q(f"Clear({c}, f=1)")
    pkg.q(f"Set({c}, f=1)")
    assert c in pkg.q("Row(f=1)")[0].columns


def test_merge_new_row_appends_without_reupload(pkg):
    pkg.holder.create_index("i").create_field("f")
    oracle = _fill(pkg)
    pkg.q("Count(Row(f=0))")
    base = pkg.uploads()
    pkg.q("Set(5, f=99)")
    top = pkg.q("TopN(f, n=10)")[0]
    assert (99, 1) in [(p.id, p.count) for p in top.pairs]
    assert pkg.uploads() == base, "new-row append caused a re-upload"
    for r, cols in oracle.items():
        assert pkg.q(f"Count(Row(f={r}))")[0] == len(cols)
    for k in range(100, 110):
        pkg.q(f"Set({k}, f={k})")
        assert pkg.q(f"Count(Row(f={k}))")[0] == 1
    assert pkg.uploads() == base
    merged = {r: pkg.q(f"Row(f={r})")[0].columns for r in list(oracle) + [99]}
    pkg.clear_caches()
    for r, cols in merged.items():
        assert pkg.q(f"Row(f={r})")[0].columns == cols


def test_merge_matches_fresh_rebuild(pkg):
    pkg.holder.create_index("i").create_field("f")
    _fill(pkg, rows=3, shards=3)
    pkg.q("Count(Row(f=0))")
    rng = np.random.default_rng(3)
    for _ in range(40):
        r = int(rng.integers(0, 3))
        c = int(rng.integers(0, 3 * SHARD_WIDTH))
        pkg.q(f"{'Set' if rng.random() < 0.5 else 'Clear'}({c}, f={r})")
        pkg.q("Count(Row(f=0))")
    merged = [pkg.q(f"Row(f={r})")[0].columns for r in range(3)]
    pkg.clear_caches()
    assert [pkg.q(f"Row(f={r})")[0].columns for r in range(3)] == merged


def test_merge_mutex_write(pkg):
    idx = pkg.holder.create_index("i")
    idx.create_field("m", pkg.FO(type=pkg.FT.MUTEX))
    for col, row in [(1, 0), (2, 0), (3, 1)]:
        pkg.q(f"Set({col}, m={row})")
    pkg.q("Count(Row(m=0))")
    base = pkg.uploads()
    pkg.q("Set(2, m=1)")  # moves col 2: a clear of row 0, a set of row 1
    assert pkg.q("Row(m=0)")[0].columns == [1]
    assert sorted(pkg.q("Row(m=1)")[0].columns) == [2, 3]
    assert pkg.uploads() == base


def test_merge_bsi_value_update_no_reupload(pkg):
    idx = pkg.holder.create_index("i")
    idx.create_field("n", pkg.FO(type=pkg.FT.INT))
    cols = list(range(0, 2000, 7))
    vals = {c: (c % 97) - 48 for c in cols}
    f = idx.field("n")
    for fshard in (0, 1):
        f.set_values([c + fshard * SHARD_WIDTH for c in cols],
                     list(vals.values()))
    assert pkg.q("Sum(field=n)")[0].val == 2 * sum(vals.values())
    base = pkg.uploads()
    f.set_values([14], [40])
    want = 2 * sum(vals.values()) - vals[14] + 40
    assert pkg.q("Sum(field=n)")[0].val == want
    assert pkg.uploads() == base, "BSI value update caused re-upload"
    f.set_values([21], [-5])
    want += -5 - vals[21]
    assert pkg.q("Sum(field=n)")[0].val == want
    f.clear_value(28)
    want -= vals[28]
    assert pkg.q("Sum(field=n)")[0].val == want
    assert pkg.uploads() == base


def test_merge_bsi_depth_growth_rebuilds(pkg):
    idx = pkg.holder.create_index("i")
    idx.create_field("n", pkg.FO(type=pkg.FT.INT))
    f = idx.field("n")
    f.set_values([1, 2, 3], [5, 6, 7])
    assert pkg.q("Sum(field=n)")[0].val == 18
    base = pkg.uploads()
    f.set_values([4], [1 << 40])
    assert pkg.q("Sum(field=n)")[0].val == 18 + (1 << 40)
    assert pkg.uploads() == base + 1


def test_merge_bsi_range_after_merge(pkg):
    idx = pkg.holder.create_index("i")
    idx.create_field("n", pkg.FO(type=pkg.FT.INT))
    f = idx.field("n")
    f.set_values(list(range(10)), list(range(10)))
    assert pkg.q("Count(Row(n > 4))")[0] == 5
    f.set_values([2], [9])
    assert pkg.q("Count(Row(n > 4))")[0] == 6
    assert sorted(pkg.q("Row(n == 9)")[0].columns) == [2, 9]


def test_merge_delta_overflow_falls_back(pkg):
    pkg.holder.create_index("i").create_field("f")
    _fill(pkg, rows=2, shards=1, per_row=30)
    pkg.q("Count(Row(f=0))")
    base = pkg.uploads()
    frag = pkg.holder.index("i").field("f").fragment(0)
    for c in range(600):
        frag.set_bit(0, 10_000 + c)
    assert pkg.q("Count(Row(f=0))")[0] > 600
    assert pkg.uploads() == base + 1  # 600 ops > 512: a rebuild
    merged = pkg.q("Row(f=0)")[0].columns
    pkg.clear_caches()
    assert pkg.q("Row(f=0)")[0].columns == merged


def test_merge_unlogged_version_bump_forces_rebuild(pkg):
    idx = pkg.holder.create_index("i")
    idx.create_field("n", pkg.FO(type=pkg.FT.INT))
    f = idx.field("n")
    f.set_values([1, 2], [10, 20])
    assert pkg.q("Sum(field=n)")[0].val == 30
    b = f.bsi_fragment(0)
    b.planes = np.zeros_like(b.planes)
    b.version += 1
    f.set_values([3], [5])
    assert pkg.q("Sum(field=n)")[0].val == 5


def test_merge_wide_bsi_ops_capped_by_replay_cost(pkg):
    idx = pkg.holder.create_index("i")
    idx.create_field("n", pkg.FO(type=pkg.FT.INT))
    f = idx.field("n")
    f.set_values(list(range(100)), [1] * 100)
    assert pkg.q("Sum(field=n)")[0].val == 100
    for k in range(5):
        f.set_values(list(range(2000)), [k] * 2000)
    assert pkg.q("Sum(field=n)")[0].val == 4 * 2000


def test_write_request_stack_not_published(pkg):
    """A stack built inside a write request is not published; outside it
    the same build is, and is served back."""
    idx = pkg.holder.create_index("i")
    idx.create_field("f")
    f = idx.field("f")
    f.fragment(0, create=True).set_bit(1, 5)
    with pkg.write_request():
        st = pkg.stk.stacked_set(f, [0], "standard")
        assert st is not None and st.ephemeral
        assert not any(getattr(f, "_stacked_cache", {}).values())
    st2 = pkg.stk.stacked_set(f, [0], "standard")
    assert any(getattr(f, "_stacked_cache", {}).values())
    assert pkg.stk.stacked_set(f, [0], "standard") is st2


def test_write_request_depth():
    h = THolder(CPU)
    assert not in_write_qcx()
    with write_qcx(h):
        assert in_write_qcx()
        with write_qcx(h):
            assert in_write_qcx()
        assert in_write_qcx()
    assert not in_write_qcx()


def test_old_stack_still_answers_after_advance():
    """A stack held from before a write keeps its answer after the next
    read advances the cached one."""
    p = _Pkg("torch")
    p.holder.create_index("i").create_field("f")
    oracle = _fill(p, rows=2, shards=1, per_row=20)
    f = p.holder.index("i").field("f")
    old = tstk.stacked_set(f, [0], "standard")
    p.q(f"Set({SHARD_WIDTH - 3}, f=0)")
    new = tstk.stacked_set(f, [0], "standard")
    assert new is not old
    assert int(tstk.topkops.row_counts(old.planes)[0]) == len(oracle[0])
    assert int(tstk.topkops.row_counts(new.planes)[0]) == len(oracle[0]) + 1


# ---------------------------------------------------------------------------
# the advance cases of tests/test_paging.py
# ---------------------------------------------------------------------------

ROWS, SHARDS = 600, 2


@pytest.fixture
def paged(monkeypatch, pkg):
    monkeypatch.setattr(pkg.stk, "_BLOCK_BYTES", 4 << 20)
    monkeypatch.setattr(pkg.stk, "BUDGET", pkg.stk.DeviceBudget(20 << 20))
    pkg.holder.create_index("i").create_field("f")
    f = pkg.holder.index("i").field("f")
    rng = np.random.default_rng(7)
    oracle = {}
    for s in range(SHARDS):
        rows, cols = [], []
        for r in range(s, ROWS, SHARDS):
            for c in rng.integers(0, SHARD_WIDTH, int(rng.integers(1, 6))):
                rows.append(r)
                cols.append(s * SHARD_WIDTH + int(c))
                oracle.setdefault(r, set()).add(cols[-1])
        f.import_bits(rows, cols)
    return pkg, f, oracle


def test_paging_appends_on_paged_stack(paged):
    p, f, oracle = paged
    p.q(f"TopN(f, n={ROWS})")
    up0, bytes0 = p.uploads(), p.stk.UPLOAD_STATS["bytes"]
    for k in range(5):
        p.q(f"Set({k}, f={ROWS + 1000 + k})")
        assert p.q(f"Count(Row(f={ROWS + 1000 + k}))")[0] == 1
    stacks = [st for inner in f._stacked_cache.values()
              for (_, st) in inner.values()]
    block_bytes = max(st.block_rows * st.total_words * 4 for st in stacks)
    assert p.uploads() - up0 <= 6
    assert p.stk.UPLOAD_STATS["bytes"] - bytes0 <= 6 * block_bytes
    top = {q.id: q.count for q in p.q(f"TopN(f, n={ROWS + 10})")[0].pairs}
    want = {r: len(c) for r, c in oracle.items()}
    want.update({ROWS + 1000 + k: 1 for k in range(5)})
    assert top == want


def test_paging_write_request_stack_releases_budget(paged):
    p, f, oracle = paged
    p.q(f"TopN(f, n={ROWS})")
    used_before = p.stk.BUDGET.used
    with p.write_request():
        f.fragment(0).set_bit(0, 7)
        st = p.stk.stacked_set(f, [0, 1], "standard")
        for _ in st.iter_blocks():
            pass
        assert st.ephemeral
    assert p.stk.BUDGET.used <= used_before


def test_paging_advance_under_tiny_budget_no_crash(monkeypatch, pkg):
    """_advance_set assigns _blocks before charging: an eviction cascade
    may pop the new stack's own earlier entries."""
    monkeypatch.setattr(pkg.stk, "_BLOCK_BYTES", 4 << 20)
    monkeypatch.setattr(pkg.stk, "BUDGET", pkg.stk.DeviceBudget(3 << 20))
    pkg.holder.create_index("i").create_field("f")
    f = pkg.holder.index("i").field("f")
    rng = np.random.default_rng(3)
    f.import_bits(rng.integers(0, 100, 2000).tolist(),
                  rng.integers(0, SHARD_WIDTH, 2000).tolist())
    top = pkg.q("TopN(f, n=100)")[0]
    base_total = sum(q.count for q in top.pairs)
    changed = pkg.q(f"Set({SHARD_WIDTH - 1}, f=3)")[0]
    top2 = pkg.q("TopN(f, n=100)")[0]
    assert sum(q.count for q in top2.pairs) == base_total + int(changed)
    assert pkg.stk.BUDGET.used <= pkg.stk.BUDGET.cap + (4 << 20)
