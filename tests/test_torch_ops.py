"""The port's kernel modules against the JAX package, on the CPU.

Every kernel module of ``pilosa_tpu_torch.ops`` takes its plain PyTorch
version for CPU tensors; these tests feed the same seeded numpy inputs to
that version and to the JAX package's Pallas kernel (interpret mode) and
classic XLA path, and require identical results (tolerance 0: every
output is an integer or a bitmap). tests/test_torch_cuda.py runs the
CUDA kernels themselves on a card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pilosa_tpu import native as jnative
from pilosa_tpu.ops import bitmap as JB
from pilosa_tpu.ops import groupby as JG
from pilosa_tpu.ops import scatter as JS
from pilosa_tpu_torch import native
from pilosa_tpu_torch.ops import bitmap as B
from pilosa_tpu_torch.ops import groupby as G
from pilosa_tpu_torch.ops import kernel_util as KU
from pilosa_tpu_torch.ops import scatter as SC
from pilosa_tpu_torch.ops import topk as T

WORDS = 512


def t(x: np.ndarray) -> torch.Tensor:
    """uint32 numpy -> int32 torch, same bits."""
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.uint32)
                            .view(np.int32).copy())


def u(x: torch.Tensor) -> np.ndarray:
    return x.numpy().view(np.uint32)


def rand_planes(rng, *shape):
    return rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)


# ---------------------------------------------------------------------------
# pair_counts
# ---------------------------------------------------------------------------

EDGE_SHAPES = [(1, 1, 1), (3, 5, 7), (37, 37, 512), (8, 256, 512)]


@pytest.mark.parametrize("r1,r2,w", EDGE_SHAPES)
def test_pair_counts_vs_pallas_and_xla(rng, r1, r2, w):
    a, b = rand_planes(rng, r1, w), rand_planes(rng, r2, w)
    got = G.pair_counts(t(a), t(b)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(JG._pair_counts_traced(a, b, interpret=True)))
    np.testing.assert_array_equal(got, np.asarray(JG._pair_counts_xla(a, b)))


@pytest.mark.parametrize("fill", [0xFFFFFFFF, 0])
def test_pair_counts_all_ones_and_zeros(rng, fill):
    a = np.full((4, WORDS), fill, dtype=np.uint32)
    b = rand_planes(rng, 6, WORDS)
    got = G.pair_counts(t(a), t(b)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(JG._pair_counts_traced(a, b, interpret=True)))
    ones = t(np.full((3, WORDS), 0xFFFFFFFF, dtype=np.uint32))
    np.testing.assert_array_equal(G.pair_counts(ones, ones).numpy(),
                                  np.full((3, 3), WORDS * 32))


def test_masked_pair_counts(rng):
    a, b = rand_planes(rng, 5, WORDS), rand_planes(rng, 9, WORDS)
    f = rand_planes(rng, WORDS)
    np.testing.assert_array_equal(
        G.masked_pair_counts(t(a), t(b), t(f)).numpy(),
        np.asarray(JG.masked_pair_counts(a, b, f)))


def test_pair_counts_rejects_mismatched_words(rng):
    with pytest.raises(ValueError):
        G.pair_counts(t(rand_planes(rng, 2, 4)), t(rand_planes(rng, 2, 5)))


# ---------------------------------------------------------------------------
# tape_count (count terminal)
# ---------------------------------------------------------------------------

TAPES = {
    "and": ((("and", 0, 1),), 2),
    "or": ((("or", 0, 1),), 2),
    "xor": ((("xor", 0, 1),), 2),
    "andnot": ((("andnot", 0, 1),), 2),
    "mixed": ((("and", 0, 1), ("or", 3, 2), ("andnot", 4, 0),
               ("xor", 5, 1)), 3),
}

_NP_OPS = {"and": lambda a, b: a & b, "or": lambda a, b: a | b,
           "xor": lambda a, b: a ^ b, "andnot": lambda a, b: a & ~b}


def _np_tape(tape, leaves):
    regs = list(leaves)
    for op, i, j in tape:
        regs.append(_NP_OPS[op](regs[i], regs[j]))
    return regs[-1]


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("name", sorted(TAPES))
def test_tape_count_vs_pallas(rng, name, masked):
    tape, n_leaves = TAPES[name]
    leaves = [rand_planes(rng, 2 * WORDS) for _ in range(n_leaves)]
    mask = rand_planes(rng, 2 * WORDS) if masked else None
    want_plane = _np_tape(tape, leaves)
    if masked:
        want_plane = want_plane & mask
    want = int(JB.plane_count_pallas_traced(jnp.asarray(want_plane), True))
    got = B.tape_count(tape, [t(x) for x in leaves],
                       t(mask) if masked else None)
    assert got.dtype == torch.int32 and int(got) == want
    np.testing.assert_array_equal(
        u(B.tape_eval(tape, [t(x) for x in leaves])),
        _np_tape(tape, leaves))


@pytest.mark.parametrize("tape,n_leaves", [
    ((), 1),
    ((("nand", 0, 1),), 2),
    ((("and", 0, 2),), 2),
    ((("or", 0, 0),), 0),
])
def test_tape_count_rejects_bad_tapes(tape, n_leaves):
    with pytest.raises(ValueError):
        B.check_tape(tape, n_leaves)


# ---------------------------------------------------------------------------
# scatter_merge + the chunked bulk import
# ---------------------------------------------------------------------------


def test_sort_updates_matches_jax(rng):
    slots = rng.integers(0, 6, size=400)
    cols = rng.integers(0, WORDS * 32, size=400)
    for g, w in zip(SC.sort_updates(slots, cols, WORDS),
                    JS.sort_updates(slots, cols, WORDS)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n,m", [(512, 1), (1024, 300), (4096, 2000)])
def test_scatter_merge_vs_pallas_and_xla(rng, n, m):
    flat = rand_planes(rng, n)
    addr, masks = JS.sort_updates(np.zeros(m, dtype=np.int64),
                                  rng.integers(0, n * 32, size=m), words=n)
    ai, mi = jnp.asarray(addr.astype(np.int32)), jnp.asarray(masks)
    pm, pc = JS._scatter_merge_pallas(jnp.asarray(flat), ai, mi, True)
    xm, xc = JS._scatter_merge_xla(jnp.asarray(flat), ai, mi)
    dev = t(flat)
    count = SC.scatter_merge_(dev, torch.from_numpy(addr.astype(np.int32)),
                              t(masks))
    np.testing.assert_array_equal(u(dev), np.asarray(pm))
    np.testing.assert_array_equal(u(dev), np.asarray(xm))
    assert int(count) == int(pc) == int(xc)


def test_scatter_new_bits_bulk_multi_chunk_vs_jax(rng):
    words = 4096  # 8 rows per 32768-word chunk: 20 rows -> 3 chunks
    base = rand_planes(rng, 24, words) & rand_planes(rng, 24, words)
    slots = rng.integers(0, 20, size=3000)
    cols = rng.integers(0, words * 32, size=3000)
    ours, theirs = base.copy(), base.copy()
    got = SC.scatter_new_bits_bulk(ours, slots, cols, torch.device("cpu"))
    want = JS.scatter_new_bits_bulk(theirs, slots, cols)
    assert got == want > 0
    np.testing.assert_array_equal(ours, theirs)
    # idempotent re-apply: nothing new
    assert SC.scatter_new_bits_bulk(ours, slots, cols,
                                    torch.device("cpu")) == 0


def test_scatter_new_bits_bulk_rejects_bad_column(rng):
    planes = np.zeros((2, 8), dtype=np.uint32)
    with pytest.raises(IndexError):
        SC.scatter_new_bits_bulk(planes, [0], [8 * 32], torch.device("cpu"))


# ---------------------------------------------------------------------------
# Plane algebra, counts, host helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["plane_and", "plane_or", "plane_xor",
                                  "plane_andnot", "plane_not"])
def test_plane_algebra(rng, name):
    a, b = rand_planes(rng, WORDS), rand_planes(rng, WORDS)
    got = u(getattr(B, name)(t(a), t(b)))
    np.testing.assert_array_equal(got, np.asarray(getattr(JB, name)(a, b)))


def test_plane_shift_carries_bit_31(rng):
    a = rand_planes(rng, WORDS) | np.uint32(0x80000000)
    np.testing.assert_array_equal(u(B.plane_shift(t(a))),
                                  np.asarray(JB.plane_shift(a)))


def test_popcount_and_counts(rng):
    a, b = rand_planes(rng, WORDS), rand_planes(rng, WORDS)
    edge = np.array([0, 1, 0x80000000, 0xFFFFFFFF, 0x7FFFFFFF],
                    dtype=np.uint32)
    np.testing.assert_array_equal(B.popcount(t(edge)).numpy(),
                                  [0, 1, 1, 32, 31])
    assert int(B.plane_count(t(a))) == int(JB.plane_count(a))
    assert int(B.plane_intersection_count(t(a), t(b))) == int(
        JB.plane_intersection_count(a, b))


@pytest.mark.parametrize("filtered", [False, True])
def test_row_counts(rng, filtered):
    planes = rand_planes(rng, 11, WORDS)
    filt = rand_planes(rng, WORDS) if filtered else None
    want = np.asarray(JB.row_counts(planes, filt))
    tf = t(filt) if filtered else None
    np.testing.assert_array_equal(T.row_counts(t(planes), tf).numpy(), want)


def test_top_rows(rng):
    planes = rand_planes(rng, 9, WORDS) & rand_planes(rng, 9, WORDS)
    counts, idx = T.top_rows(t(planes), 4)
    want = np.asarray(JB.row_counts(planes))
    assert counts.tolist() == sorted(want.tolist(), reverse=True)[:4]
    assert [want[i] for i in idx.tolist()] == counts.tolist()


def test_shard_mask_plane():
    np.testing.assert_array_equal(
        B.shard_mask_plane([0, 2, 5], {2}, words=8),
        JB.shard_mask_plane([0, 2, 5], {2}, words=8))


def test_bits_roundtrip_and_native(rng):
    cols = np.unique(rng.integers(0, WORDS * 32, size=700))
    plane = B.bits_to_plane(cols, WORDS)
    np.testing.assert_array_equal(plane, JB.bits_to_plane(cols, WORDS))
    np.testing.assert_array_equal(B.plane_to_bits(plane),
                                  JB.plane_to_bits(plane))
    assert native.popcount(plane) == cols.size == jnative.popcount(plane)
    more = rng.integers(0, WORDS * 32, size=300)
    p1, p2 = plane.copy(), plane.copy()
    assert native.scatter_new_bits(p1, more) == jnative.scatter_new_bits(
        p2, more)
    np.testing.assert_array_equal(p1, p2)


def test_device_constants():
    z = B.device_zeros(16, torch.device("cpu"))
    o = B.device_ones(16, torch.device("cpu"))
    assert int(B.plane_count(z)) == 0 and int(B.plane_count(o)) == 16 * 32
    assert B.device_zeros(16, torch.device("cpu")) is z


# ---------------------------------------------------------------------------
# Routing: CPU tensors take the plain version and launch nothing
# ---------------------------------------------------------------------------


def test_cpu_tensors_take_plain_version_without_launching(rng):
    before = KU.launches()
    a, b = t(rand_planes(rng, 2, WORDS)), t(rand_planes(rng, 3, WORDS))
    G.pair_counts(a, b)
    T.row_counts(b)
    B.tape_count((("and", 0, 1),), [a[0], a[1]])
    flat = t(rand_planes(rng, WORDS))
    SC.scatter_merge_(flat, torch.tensor([1, 2], dtype=torch.int32),
                      torch.tensor([1, 2], dtype=torch.int32))
    assert KU.launches() == before
    assert set(before) == {"tape_count", "pair_counts", "scatter_merge"}


def test_unsupported_device_raises():
    meta = torch.empty(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        B.tape_count((("and", 0, 1),), [meta, meta])

