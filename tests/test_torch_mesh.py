"""The mesh reduces and the engine mesh (parallel/mesh.py) against the
JAX package's, on 8 virtual CPU devices.

The cases of ``tests/test_mesh.py`` run once per package through a ``P``
fixture: the JAX package over the suite's 8 virtual CPU devices
(tests/conftest.py), the port over ``[torch.device("cpu")] * 8``, each
at ``col_parallel`` 1, 2 and 4 (blocks of 512, 256 and 128 words). The
parity tests hold the port's ``ShardPlacement`` against the JAX one on
the same seeded numpy inputs: same values, same dtypes. The eighth case
of ``tests/test_mesh.py``, the engine mesh's fallback, waits for the
engine over several cards (ROADMAP A.7h). Tolerance 0: every result is
an integer.
"""

import importlib
import types

import jax
import numpy as np
import pytest
import torch

S, R, W = 8, 6, 512  # 8 shards over up to 8 devices; W divisible by 2 and 4
NBITS = W * 32
CPU8 = [torch.device("cpu")] * 8


def _load(root: str) -> types.SimpleNamespace:
    m = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    devices = jax.devices() if root == "pilosa_tpu" else CPU8
    return types.SimpleNamespace(
        root=root, parallel=m("parallel"), mesh=m("parallel.mesh"),
        devices=devices)


_PACKAGES = {}


def _pkg(root):
    if root not in _PACKAGES:
        _PACKAGES[root] = _load(root)
    return _PACKAGES[root]


@pytest.fixture(params=["pilosa_tpu", "pilosa_tpu_torch"],
                ids=["jax", "torch"])
def P(request):
    return _pkg(request.param)


@pytest.fixture(params=[1, 2, 4])
def cp(request):
    return request.param


def _placement(P, col_parallel):
    return P.parallel.ShardPlacement(
        P.parallel.analytics_mesh(P.devices, col_parallel=col_parallel))


def rand_stack(rng, s=S, r=None, density=0.05):
    shape = (s, NBITS) if r is None else (s, r, NBITS)
    raw = rng.random(shape) < density
    packed = np.packbits(raw, axis=-1, bitorder="little")
    return raw, packed.view("<u4").astype(np.uint32).reshape(*shape[:-1], W)


def _bsi_inputs(depth=12):
    from pilosa_tpu_torch.ops.bsi import encode_values

    stacks, filts, total, count = [], [], 0, 0
    rng2 = np.random.default_rng(3)
    for _ in range(S):
        cols = np.unique(rng2.integers(0, NBITS, 500))
        vals = rng2.integers(-2000, 2000, cols.size)
        stacks.append(encode_values(cols, vals, depth, W))
        filt = np.zeros(NBITS, bool)
        filt[cols[::2]] = True
        filts.append(np.packbits(filt, bitorder="little").view("<u4"))
        total += int(vals[::2].sum())
        count += cols[::2].size
    return np.stack(stacks), np.stack(filts), total, count


# -- the cases of tests/test_mesh.py, once per package -----------------------


def test_count(rng, P, cp):
    pl = _placement(P, cp)
    raw, planes = rand_stack(rng)
    assert pl.count(pl.place(planes)) == int(raw.sum())


def test_intersect_count(rng, P, cp):
    pl = _placement(P, cp)
    ra, a = rand_stack(rng)
    rb, b = rand_stack(rng)
    assert pl.intersect_count(pl.place(a), pl.place(b)) == \
        int((ra & rb).sum())


def test_row_counts(rng, P, cp):
    pl = _placement(P, cp)
    raw, planes = rand_stack(rng, r=R)
    np.testing.assert_array_equal(pl.row_counts(pl.place(planes)),
                                  raw.sum(axis=(0, 2)))


def test_groupby_counts(rng, P, cp):
    pl = _placement(P, cp)
    ra, a = rand_stack(rng, r=4)
    rb, b = rand_stack(rng, r=5)
    got = pl.groupby_counts(pl.place(a), pl.place(b))
    expect = np.einsum("sgw,srw->gr", ra.astype(np.int64),
                       rb.astype(np.int64))
    np.testing.assert_array_equal(got, expect)


def test_bsi_sum(P, cp):
    pl = _placement(P, cp)
    depth = 12
    planes, filt, total, count = _bsi_inputs(depth)
    c, per_plane = pl.bsi_sum_counts(pl.place(planes), pl.place(filt))
    got = sum(int(per_plane[k]) << k for k in range(depth))
    assert (c, got) == (count, total)


def test_uneven_devices_rejected(P):
    with pytest.raises(ValueError):
        P.parallel.analytics_mesh(P.devices, col_parallel=3)  # 8 % 3 != 0


def test_mesh_uses_all_devices(P):
    mesh = P.parallel.analytics_mesh(P.devices, col_parallel=2)
    assert mesh.devices.size == len(P.devices) == 8
    assert mesh.devices.shape == (4, 2)
    assert mesh.axis_names == ("shards", "cols")


# -- the port against the JAX package, same inputs ---------------------------


def _both(cp):
    return (_placement(_pkg("pilosa_tpu"), cp),
            _placement(_pkg("pilosa_tpu_torch"), cp))


def _same(got, want):
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    if isinstance(want, int):
        assert type(got) is int and got == want
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("reduce", ["count", "intersect_count", "row_counts",
                                    "groupby_counts", "bsi_sum_counts"])
def test_port_matches_jax_placement(reduce, cp):
    rng = np.random.default_rng(7 + cp)
    if reduce == "count":
        args = (rand_stack(rng, density=0.3)[1],)
    elif reduce == "intersect_count":
        args = (rand_stack(rng)[1], rand_stack(rng, density=0.5)[1])
    elif reduce == "row_counts":
        args = (rand_stack(rng, r=9, density=0.2)[1],)
    elif reduce == "groupby_counts":
        args = (rand_stack(rng, r=7, density=0.3)[1],
                rand_stack(rng, r=3, density=0.4)[1])
    else:
        planes, filt, _, _ = _bsi_inputs(20)
        args = (planes, filt)
    jp, tp = _both(cp)
    want = getattr(jp, reduce)(*(jp.place(a) for a in args))
    got = getattr(tp, reduce)(*(tp.place(a) for a in args))
    _same(got, want)


def test_placement_blocks_and_errors(cp):
    """Blocks hold ``[..., local_shards * local_words]``; the shapes the
    JAX placement refuses raise ValueError in both packages."""
    jp, tp = _both(cp)
    _, planes = rand_stack(np.random.default_rng(1), r=3)
    placed = tp.place(planes)
    rows, cols = 8 // cp, cp
    assert len(placed.blocks) == rows and len(placed.blocks[0]) == cols
    ls, lw = S // rows, W // cols
    blk = placed.blocks[1][cols - 1]
    assert tuple(blk.shape) == (3, ls * lw) and blk.dtype == torch.int32
    host = planes[ls:2 * ls, :, (cols - 1) * lw:]
    want = np.moveaxis(host, 0, 1).reshape(3, ls * lw)
    np.testing.assert_array_equal(blk.numpy().view(np.uint32), want)
    assert placed.nbytes == planes.nbytes
    for shape in [(6, W), (S, W - 1), (W,), (3, 4, W)]:
        bad = np.zeros(shape, np.uint32)
        if shape[0] % rows == 0 and shape[-1] % cols == 0 and len(shape) > 1:
            continue
        for pl in (jp, tp):
            with pytest.raises(ValueError):
                pl.place(bad)


def test_default_mesh_needs_a_card():
    M = _pkg("pilosa_tpu_torch").mesh
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        M.analytics_mesh()
