"""The port's BSI operations against the JAX package, on the CPU.

The same seeded numpy stacks go through ``pilosa_tpu_torch.ops.bsi`` (the
plain PyTorch versions, which CPU tensors take) and through the JAX
package's Pallas compare in interpret mode, its classic XLA circuit and
its aggregate kernels; every result must be identical (tolerance 0: every
output is a bitmap or an integer). tests/test_torch_cuda.py runs the CUDA
kernel itself on a card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pilosa_tpu.ops import bsi as JS
from pilosa_tpu.ops import groupby as JG
from pilosa_tpu_torch.ops import bsi as S
from pilosa_tpu_torch.ops import groupby as G
from pilosa_tpu_torch.ops import kernel_util as KU

WORDS = 512


def t(x) -> torch.Tensor:
    """uint32 numpy -> int32 torch, same bits."""
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.uint32)
                            .view(np.int32).copy())


def u(x: torch.Tensor) -> np.ndarray:
    return x.numpy().view(np.uint32)


def encode(seed, words=WORDS, n=2000, lo=-5000, hi=5000):
    rng = np.random.default_rng(seed)
    cols = np.unique(rng.integers(0, words * 32, size=n))
    vals = rng.integers(lo, hi, size=cols.size)
    depth = max(S.bits_needed(int(vals.min())), S.bits_needed(int(vals.max())))
    return cols, vals, S.encode_values(cols, vals, depth, words)


def jax_compare(planes, op, value, value2=None):
    """The JAX package's Pallas compare (interpret mode) and its XLA
    circuit, as numpy planes."""
    depth = planes.shape[0] - S.OFFSET
    sides = [JS.value_bits(int(value), depth)]
    sides.append(sides[0] if value2 is None
                 else JS.value_bits(int(value2), depth))
    cvec = np.zeros((2, depth + 2), dtype=np.int32)
    for i, (bits, over, neg) in enumerate(sides):
        cvec[i, :depth], cvec[i, depth], cvec[i, depth + 1] = bits, over, neg
    pallas = JS._compare_pallas(planes, jnp.asarray(cvec), op=op,
                                interpret=True)
    xla = JS._compare_kernel(planes, op, *(jnp.asarray(x) for s in sides
                                           for x in s))
    return np.asarray(pallas), np.asarray(xla)


def check_compare(planes, op, value, value2=None):
    got = u(S.bsi_compare(t(planes), op, value, value2))
    pallas, xla = jax_compare(planes, op, value, value2)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, xla)
    return got


# ---------------------------------------------------------------------------
# bsi_compare
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", [S.EQ, S.NE, S.LT, S.LE, S.GT, S.GE])
@pytest.mark.parametrize("c", [-6000, -1, 0, 42, 6000])
def test_compare_vs_pallas_and_xla(op, c):
    cols, vals, planes = encode(1)
    got = check_compare(planes, op, c)
    want = {S.EQ: vals == c, S.NE: vals != c, S.LT: vals < c,
            S.LE: vals <= c, S.GT: vals > c, S.GE: vals >= c}[op]
    np.testing.assert_array_equal(got, S.encode_values(
        cols[want], np.zeros(int(want.sum()), np.int64), 1, WORDS)[S.EXISTS])


@pytest.mark.parametrize("a,b", [(-100, 100), (0, 0), (-5000, 5000),
                                 (40, 30), (-5000, -4000), (-6000, 6000)])
def test_between_vs_pallas_and_xla(a, b):
    cols, vals, planes = encode(2)
    got = check_compare(planes, S.BETWEEN, a, b)
    sel = (vals >= a) & (vals <= b)
    assert np.unpackbits(got.view(np.uint8)).sum() == int(sel.sum())


@pytest.mark.parametrize("op,c,c2", [
    (S.EQ, 1, None), (S.NE, -1, None), (S.LT, 0, None), (S.GE, -1, None),
    (S.GT, 2, None), (S.LE, -2, None), (S.BETWEEN, -1, 1),
    (S.BETWEEN, -3, 3), (S.BETWEEN, 2, -2)])
def test_depth_one_and_overflowing_constants(op, c, c2):
    """Depth 1 (values in {-1, 0, 1}); |c| = 2 and 3 overflow it."""
    _, _, planes = encode(3, lo=-1, hi=2)
    assert planes.shape[0] == S.OFFSET + 1
    check_compare(planes, op, c, c2)


@pytest.mark.parametrize("op,c,c2", [(S.GT, 123, None), (S.NE, -77, None),
                                     (S.BETWEEN, -300, 4000),
                                     (S.LT, -(1 << 20), None)])
def test_compare_at_a_width_off_the_tpu_block(op, c, c2):
    """W = 1000 is no multiple of the TPU kernel's 512-word block."""
    _, _, planes = encode(4, words=1000, n=6000)
    check_compare(planes, op, c, c2)


def test_cpu_tensor_takes_the_plain_version():
    _, _, planes = encode(5)
    before = KU.launches()["bsi_compare"]
    for op in (S.EQ, S.GT, S.BETWEEN):
        S.bsi_compare(t(planes), op, -3, 900)
    assert KU.launches()["bsi_compare"] == before
    with pytest.raises(ValueError, match="unknown op"):
        S.bsi_compare(t(planes), "gte", 1)


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lo,hi", [(-5000, 5000), (0, 1 << 20),
                                   (-(1 << 40), -(1 << 39))])
def test_encode_values_vs_jax(lo, hi):
    rng = np.random.default_rng(6)
    cols = np.unique(rng.integers(0, WORDS * 32, size=3000))
    vals = rng.integers(lo, hi, size=cols.size)
    ends = (int(vals.min()), int(vals.max()))
    depth = max(S.bits_needed(v) for v in ends)
    assert depth == max(JS.bits_needed(v) for v in ends)
    np.testing.assert_array_equal(S.encode_values(cols, vals, depth, WORDS),
                                  JS.encode_values(cols, vals, depth, WORDS))
    with pytest.raises(ValueError, match="exceeds bit depth"):
        S.encode_values(cols, vals, depth - 1, WORDS)


# ---------------------------------------------------------------------------
# aggregates
# ---------------------------------------------------------------------------


def filters(planes, kind):
    rng = np.random.default_rng(7)
    if kind == "exists":
        return planes[S.EXISTS]
    if kind == "random":
        return rng.integers(0, 1 << 32, size=planes.shape[1], dtype=np.uint32)
    return np.zeros(planes.shape[1], dtype=np.uint32)


@pytest.mark.parametrize("kind", ["exists", "random", "empty"])
def test_plane_popcounts_vs_pallas_and_xla(kind):
    _, _, planes = encode(8)
    filt = filters(planes, kind)
    got = [x.numpy() for x in S.bsi_plane_popcounts(t(planes), t(filt))]
    for want in (JS._plane_popcounts_pallas(planes, filt, interpret=True),
                 JS._plane_popcounts_xla(planes, filt)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))
    assert S.finish_sum(*got) == JS.bsi_sum(planes, filt)


VALUE_SETS = {"mixed": (-5000, 5000), "negative": (-900, -3),
              "positive": (7, 70000)}


@pytest.mark.parametrize("want_max", [False, True])
@pytest.mark.parametrize("values,kind", [("mixed", "exists"),
                                         ("mixed", "random"),
                                         ("negative", "exists"),
                                         ("positive", "random"),
                                         ("mixed", "empty")])
def test_minmax_vs_jax(values, kind, want_max):
    _, _, planes = encode(9, lo=VALUE_SETS[values][0],
                          hi=VALUE_SETS[values][1])
    filt = filters(planes, kind)
    got = S.bsi_minmax(t(planes), t(filt), want_max)
    want = JS._minmax_kernel(planes, filt, want_max)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    jfn = JS.bsi_max if want_max else JS.bsi_min
    assert S.finish_value(*(g.numpy() for g in got)) == jfn(planes, filt)


@pytest.mark.parametrize("nth", [0, 1, 50, 99.5, 100])
@pytest.mark.parametrize("values", ["mixed", "negative"])
def test_percentile_walk_vs_kth_kernel(values, nth):
    _, _, planes = encode(10, lo=VALUE_SETS[values][0],
                          hi=VALUE_SETS[values][1])
    filt = filters(planes, "random")
    got = S.bsi_kth(t(planes), t(filt), round(nth * 100))
    want = JS._kth_kernel(planes, filt, jnp.int32(round(nth * 100)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_pair_sums_vs_jax():
    rng = np.random.default_rng(11)
    _, _, planes = encode(11)
    a = rng.integers(0, 1 << 32, size=(5, WORDS), dtype=np.uint32)
    b = rng.integers(0, 1 << 32, size=(9, WORDS), dtype=np.uint32)
    mags = planes[S.OFFSET:]
    pos = planes[S.EXISTS] & ~planes[S.SIGN]
    neg = planes[S.EXISTS] & planes[S.SIGN]
    got = G.pair_sums(t(a), t(b), t(mags), t(pos), t(neg))
    want = JG.pair_sums(a, b, mags, pos, neg)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_mask_filter_vs_jax():
    rng = np.random.default_rng(12)
    f, m = (rng.integers(0, 1 << 32, size=WORDS, dtype=np.uint32)
            for _ in range(2))
    assert S.mask_filter(None, None) is None
    for fa, ma in ((f, None), (None, m), (f, m)):
        got = S.mask_filter(None if fa is None else t(fa),
                            None if ma is None else t(ma))
        np.testing.assert_array_equal(u(got), np.asarray(JS.mask_filter(fa,
                                                                        ma)))
