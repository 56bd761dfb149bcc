"""The port's bulk import path (ops/scatter.py) against the JAX package, on
the CPU.

The same seeded (plane slot, column) updates go into copies of the same
host planes through ``pilosa_tpu_torch.ops.scatter.scatter_new_bits_bulk``
(CPU tensors: the touched tiles are staged, packed and merged by the
kernel's plain version), through ``pilosa_tpu.ops.scatter``'s (its Pallas
scatter-merge in interpret mode) and through the native per-row
``scatter_new_bits`` summed over rows. Counts and every plane word must
be identical (tolerance 0: bitmaps and integers), at tile sizes of 8, 32
and 512 words and over more than one chunk. tests/test_torch_cuda.py runs
the staged path with the CUDA kernel on a card.
"""

import numpy as np
import pytest
import torch

from pilosa_tpu import native as jnative
from pilosa_tpu.ops import scatter as JS
from pilosa_tpu_torch.ops import scatter as SC

CPU = torch.device("cpu")
WORDS = 1024
ROWS = 12


def _edges(rng, t):
    """Bits in the words on both sides of a tile edge (T - 1 and T), in
    the last tile of a row and in the last row."""
    words = [t - 1, t, 2 * t - 1, WORDS - t, WORDS - 1]
    cols = [w * 32 + b for w in words for b in (0, 31)]
    slots = [s for s in (0, 5, ROWS - 1) for _ in cols]
    return np.array(slots), np.array(cols * 3)


CASES = {
    "empty": lambda rng, t: (np.zeros(0, np.int64), np.zeros(0, np.int64)),
    "one": lambda rng, t: (np.array([3]), np.array([77])),
    # the same bit twice and several bits of one word, in one call
    "duplicates": lambda rng, t: (np.array([2] * 7),
                                  np.array([64, 65, 64, 95, 65, 70, 95])),
    "tile_edges": _edges,
    # slots given out of order, every row touched
    "out_of_order": lambda rng, t: (rng.permutation(np.repeat(
        np.arange(ROWS)[::-1], 40)), rng.integers(0, WORDS * 32, ROWS * 40)),
    "random": lambda rng, t: (rng.integers(0, ROWS, 3000),
                              rng.integers(0, WORDS * 32, 3000)),
}


def _base(rng):
    return rng.integers(0, 1 << 32, (ROWS, WORDS), dtype=np.uint32) \
        & rng.integers(0, 1 << 32, (ROWS, WORDS), dtype=np.uint32)


def _native(planes, slots, cols) -> int:
    return sum(jnative.scatter_new_bits(planes[s], cols[slots == s])
               for s in np.unique(slots))


def _check(planes, slots, cols):
    """Port, JAX and native on copies of ``planes``: equal counts and
    planes, then an idempotent re-apply that counts 0."""
    ours, theirs, ref = planes.copy(), planes.copy(), planes.copy()
    got = SC.scatter_new_bits_bulk(ours, slots, cols, CPU)
    assert got == JS.scatter_new_bits_bulk(theirs, slots, cols) \
        == _native(ref, slots, cols)
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(ours, ref)
    assert SC.scatter_new_bits_bulk(ours, slots, cols, CPU) == 0
    np.testing.assert_array_equal(ours, theirs)
    return got


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("t", [8, 32, 512])
def test_bulk_matches_jax_and_native(monkeypatch, t, case):
    monkeypatch.setattr(SC, "TILE_WORDS", t)
    rng = np.random.default_rng(t + len(case))
    slots, cols = CASES[case](rng, t)
    planes = _base(rng)
    # every other update's bit starts clear, so some bits are new
    s, c = slots[::2], cols[::2]
    planes[s, c >> 5] &= ~(np.uint32(1) << (c & 31).astype(np.uint32))
    got = _check(planes, slots, cols)
    assert (got > 0) == (slots.size > 0)


@pytest.mark.parametrize("cap", [256, 4096, 1 << 16])
@pytest.mark.parametrize("t", [8, 32, 512])
def test_bulk_in_many_chunks(monkeypatch, t, cap):
    """A byte cap far below the staged size splits the call into chunks
    of whole tiles (one tile each at the smallest cap); the planes are
    written only after the last chunk and equal JAX's."""
    monkeypatch.setattr(SC, "TILE_WORDS", t)
    monkeypatch.setattr(SC, "MAX_STAGED_BYTES", cap)
    rng = np.random.default_rng(cap + t)
    slots = rng.integers(0, ROWS, 2000)
    cols = rng.integers(0, WORDS * 32, 2000)
    calls = []
    merge = SC._merge_chunk
    monkeypatch.setattr(SC, "_merge_chunk",
                        lambda *a: calls.append(a[1].size) or merge(*a))
    _check(_base(rng), slots, cols)
    assert len(calls) > 1


def test_bulk_writes_back_only_after_every_chunk(monkeypatch):
    """A chunk that fails leaves the planes untouched."""
    monkeypatch.setattr(SC, "MAX_STAGED_BYTES", 4096)
    rng = np.random.default_rng(5)
    planes = _base(rng)
    before = planes.copy()
    merge, calls = SC._merge_chunk, []

    def fail_third(*a):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("lost the card")
        return merge(*a)

    monkeypatch.setattr(SC, "_merge_chunk", fail_third)
    with pytest.raises(RuntimeError):
        SC.scatter_new_bits_bulk(planes, rng.integers(0, ROWS, 2000),
                                 rng.integers(0, WORDS * 32, 2000), CPU)
    np.testing.assert_array_equal(planes, before)


@pytest.mark.parametrize("t", [8, 32, 512])
def test_pack_tiles(t):
    """Touched tiles in order, each address rebased to rank * T + word in
    its tile, and each tile's first address."""
    rng = np.random.default_rng(t)
    addr = np.unique(rng.integers(0, ROWS * WORDS, 500))
    which, packed, starts = SC.pack_tiles(addr, t)
    np.testing.assert_array_equal(which, np.unique(addr // t))
    rank = np.searchsorted(which, addr // t)
    np.testing.assert_array_equal(packed, rank * t + addr % t)
    np.testing.assert_array_equal(starts, np.searchsorted(addr // t, which))


def test_tile_words_divides_the_planes(monkeypatch):
    monkeypatch.setattr(SC, "TILE_WORDS", 512)
    assert SC._tile_words(12 * 1024) == 512
    assert SC._tile_words(3 * 40) == 8
    assert SC._tile_words(7) == 1


@pytest.mark.parametrize("bad", [([ROWS], [0]), ([-1], [0])])
def test_bulk_rejects_bad_slots(bad):
    planes = np.zeros((ROWS, WORDS), dtype=np.uint32)
    with pytest.raises(IndexError):
        SC.scatter_new_bits_bulk(planes, *bad, CPU)


def test_plain_drops_addresses_outside_the_flat():
    """The plain version drops what the kernel drops, as XLA's scatter
    does."""
    flat = torch.zeros(8, dtype=torch.int32)
    got = SC.scatter_merge_plain(flat, torch.tensor([1, 8, -1, 7],
                                                    dtype=torch.int32),
                                 torch.tensor([3, 1, 1, -1],
                                              dtype=torch.int32))
    assert int(got) == 34
    assert flat.tolist() == [0, 3, 0, 0, 0, 0, 0, -1]
