"""The port's compressed residency (ops/ctiles.py) against the JAX package,
on the CPU.

The same seeded numpy blocks go through ``pilosa_tpu_torch.ops.ctiles``
(CPU tensors, so every kernel wrapper takes its plain PyTorch version) and
``pilosa_tpu.ops.ctiles``: the classification, the compress decision and
its stored bytes, decode, the tile-skipping row counts (against the JAX
package's Pallas ``ctile_count`` in interpret mode and against its XLA
path), the active-tile BSI compare and the ``ctile_count`` function
itself must all be identical (tolerance 0: every output is a bitmap or an
integer). tests/test_torch_cuda.py runs the CUDA kernel on a card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pilosa_tpu.obs import metrics as JM
from pilosa_tpu.ops import bitmap as JB
from pilosa_tpu.ops import bsi as JS
from pilosa_tpu.ops import ctiles as JC
from pilosa_tpu.ops import pallas_util as PU
from pilosa_tpu_torch.ops import bsi as S
from pilosa_tpu_torch.ops import ctiles as C
from pilosa_tpu_torch.ops import kernel_util as KU

CPU = torch.device("cpu")


def tt(x) -> torch.Tensor:
    """uint32 numpy -> int32 torch, same bits."""
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.uint32)
                            .view(np.int32).copy())


def u(x: torch.Tensor) -> np.ndarray:
    return x.numpy().view(np.uint32)


def sparse_block(rng, rows, words, n_bits=40):
    host = np.zeros((rows, words), dtype=np.uint32)
    host[rng.integers(0, rows, n_bits), rng.integers(0, words, n_bits)] = \
        rng.integers(1, 2 ** 32, n_bits, dtype=np.uint32)
    return host


def clustered_block(rng, rows, words):
    """Rows that are runs of consecutive columns, as a field whose rows
    follow load order holds them: all-ones run tiles, a dense tile at
    each run boundary, zero tiles elsewhere; plus scattered bits."""
    cols = words * 32
    bounds = np.sort(rng.choice(np.arange(1, cols), rows - 1, replace=False))
    host = np.zeros((rows, words), dtype=np.uint32)
    for r, (lo, hi) in enumerate(zip(np.r_[0, bounds], np.r_[bounds, cols])):
        bits = np.zeros(cols, dtype=bool)
        bits[lo:hi] = True
        host[r] = np.packbits(bits, bitorder="little").view("<u4")
    host |= sparse_block(rng, rows, words, n_bits=rows)
    return host


@pytest.fixture(autouse=True)
def _clean_strikes():
    PU.reset_failures()
    yield
    PU.reset_failures()


@pytest.fixture
def forced(monkeypatch):
    monkeypatch.setenv("PILOSA_TPU_COMPRESS", "1")


@pytest.fixture
def single_device_mesh():
    # the auto rule: tests/conftest.py boots 8 virtual devices, and the
    # JAX package keeps blocks dense on a multi-device mesh
    import jax

    from pilosa_tpu.parallel import mesh as PM

    PM.set_engine_mesh(PM.analytics_mesh(jax.devices()[:1]))
    yield
    PM.set_engine_mesh(None)


def both(host):
    """(JAX block, port block) of one host block under the current
    policy."""
    return (JC.maybe_compress(host, kind="set"),
            C.maybe_compress(host, CPU))


def pallas_dispatches() -> float:
    return JM.REGISTRY.value(JM.METRIC_OPS_PALLAS_DISPATCH,
                             kernel="ctile_count") or 0.0


SHAPES = [(2, 1), (3, 7), (8, 512), (16, 1000), (5, 2048), (1, 4096),
          (4, 612), (16, 8192)]


# ---------------------------------------------------------------------------
# classify and the compress decision
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["sparse", "clustered"])
@pytest.mark.parametrize("shape", SHAPES)
def test_classify_matches(kind, shape):
    rng = np.random.default_rng(shape[0] * 10000 + shape[1])
    if kind == "clustered" and shape[1] * 32 < shape[0]:
        pytest.skip("fewer columns than rows")
    host = (sparse_block(rng, *shape) if kind == "sparse"
            else clustered_block(rng, *shape))
    host[0] = 0
    want = JC.classify(host)
    got = C.classify(host)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and np.array_equal(g, w)
        else:
            assert g == w


@pytest.mark.parametrize("t", [8, 64, 512])
def test_classify_matches_at_a_given_tile(t):
    host = clustered_block(np.random.default_rng(t), 12, 2048)
    for g, w in zip(C.classify(host, t), JC.classify(host, t)):
        assert np.array_equal(np.asarray(g), np.asarray(w))


def _block_attrs(cb):
    return {k: (np.asarray(getattr(cb, k)).tolist()
                if k == "active_tiles" else getattr(cb, k))
            for k in ("rows", "words", "tile_words", "n_tiles", "n_payload",
                      "nbytes", "dense_nbytes", "zero_tiles", "run_tiles",
                      "dense_tiles", "active_tiles")}


DECISIONS = {
    # name: (PILOSA_TPU_COMPRESS, block maker, compressed?)
    "forced-sparse": ("1", lambda r: sparse_block(r, 16, 4096), True),
    "forced-random": ("1", lambda r: r.integers(0, 2 ** 32, (8, 1024),
                                                 dtype=np.uint32), True),
    "forced-small": ("1", lambda r: sparse_block(r, 8, 32), True),
    "killed": ("0", lambda r: np.zeros((64, 4096), dtype=np.uint32), False),
    "auto-small": ("", lambda r: np.zeros((8, 32), dtype=np.uint32), False),
    "auto-ratio": ("", lambda r: r.integers(0, 2 ** 32, (32, 1024),
                                            dtype=np.uint32), False),
    "auto-clustered": ("", lambda r: clustered_block(r, 16, 8192), True),
    "auto-sparse": ("", lambda r: sparse_block(r, 64, 4096), True),
}


@pytest.mark.parametrize("name", sorted(DECISIONS))
def test_maybe_compress_decision_and_bytes(single_device_mesh, monkeypatch,
                                           name):
    mode, make, compressed = DECISIONS[name]
    monkeypatch.setenv("PILOSA_TPU_COMPRESS", mode)
    host = make(np.random.default_rng(len(name)))
    jcb, tcb = both(host)
    assert (jcb is not None) == (tcb is not None) == compressed
    if not compressed:
        return
    assert _block_attrs(tcb) == _block_attrs(jcb)
    for k in ("payload", "const"):
        assert np.array_equal(u(getattr(tcb, k)),
                              np.asarray(getattr(jcb, k)))
    for k in ("slot", "payload_row", "payload_tile"):
        assert np.array_equal(getattr(tcb, k).numpy(),
                              np.asarray(getattr(jcb, k)))


def test_ratio_rule_charges_the_padded_cap(single_device_mesh, monkeypatch):
    """A block whose stored size is over 0.9x dense only because the
    payload count is padded up to a power of two stays dense in both."""
    monkeypatch.delenv("PILOSA_TPU_COMPRESS", raising=False)
    rows, n_tiles, t = 4, 96, 512
    host = np.zeros((rows, n_tiles * t), dtype=np.uint32)
    rng = np.random.default_rng(2)
    # 257 dense tiles: cap 512, stored ~ 512 * 2 KiB > 0.9 x 768 KiB
    for k in range(257):
        r, tile = divmod(k, n_tiles)
        host[r, tile * t:(tile + 1) * t] = rng.integers(
            0, 2 ** 32, t, dtype=np.uint32)
    jcb, tcb = both(host)
    assert jcb is None and tcb is None
    monkeypatch.setenv("PILOSA_TPU_COMPRESS", "1")
    jcb, tcb = both(host)
    assert tcb.nbytes == jcb.nbytes > 0.9 * host.nbytes


def test_tile_words_and_policy_match(monkeypatch):
    for width in (1, 5, 8, 9, 100, 511, 512, 513, 4096):
        assert C.tile_words(width) == JC.tile_words(width)
    for mode in ("", "0", "1", "off", "force"):
        monkeypatch.setenv("PILOSA_TPU_COMPRESS", mode)
        assert (C.disabled(), C.forced()) == (JC.disabled(), JC.forced())
        assert C.why_not_compress(1 << 20) in (None, "disabled")
    monkeypatch.setenv("PILOSA_TPU_COMPRESS", "")
    assert C.why_not_compress(C.MIN_BYTES - 1) == "small"
    assert C.why_not_compress(C.MIN_BYTES) is None


SETTINGS = [("PILOSA_TPU_COMPRESS_TILE_WORDS", "64"),
            ("PILOSA_TPU_COMPRESS_TILE_WORDS", "24"),
            ("PILOSA_TPU_COMPRESS_TILE_WORDS", "not a number"),
            ("PILOSA_TPU_COMPRESS_MIN_BYTES", "1"),
            ("PILOSA_TPU_COMPRESS_MIN_BYTES", str(1 << 30))]


@pytest.mark.parametrize("mode", ["", "1"])
@pytest.mark.parametrize("name,value", SETTINGS)
def test_compress_settings_match(single_device_mesh, monkeypatch, name,
                                 value, mode):
    """The tile and least-size settings give the JAX package's tiling,
    decisions and stored bytes, under the auto rule and forced."""
    monkeypatch.setenv("PILOSA_TPU_COMPRESS", mode)
    monkeypatch.setenv(name, value)
    for width in (1, 5, 8, 9, 20, 24, 63, 64, 65, 100, 512, 513, 4096):
        assert C.tile_words(width) == JC.tile_words(width), width
    for nbytes in (0, 1, C.MIN_BYTES - 1, C.MIN_BYTES, 1 << 20, 1 << 30):
        assert C.why_not_compress(nbytes) == JC.why_not_compress(nbytes)
    rng = np.random.default_rng(len(name) + len(value))
    for host in (sparse_block(rng, 16, 4096), clustered_block(rng, 16, 8192),
                 sparse_block(rng, 2, 100), np.zeros((8, 32), np.uint32)):
        jcb, tcb = both(host)
        assert (jcb is None) == (tcb is None)
        if tcb is not None:
            assert _block_attrs(tcb) == _block_attrs(jcb)
            assert np.array_equal(u(tcb.payload), np.asarray(jcb.payload))


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES)
def test_decode_roundtrip(forced, shape):
    rng = np.random.default_rng(shape[0] * 7 + shape[1])
    host = sparse_block(rng, *shape)
    host[0] = 0
    if shape[0] > 1:
        host[-1] = 0xFFFFFFFF
    jcb, tcb = both(host)
    assert np.array_equal(u(tcb.decode()), host)
    assert np.array_equal(u(tcb.decode()), np.asarray(jcb.decode()))
    sub = [shape[0] - 1, 0]
    assert np.array_equal(u(tcb.decode(rows=sub)), host[sub])
    assert np.array_equal(u(tcb.decode(rows=sub)),
                          np.asarray(jcb.decode(rows=sub)))


# ---------------------------------------------------------------------------
# tile-skipping row counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pallas", ["1", "0"])
@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("kind", ["sparse", "clustered", "unaligned"])
def test_row_counts_match(forced, monkeypatch, pallas, filtered, kind):
    monkeypatch.setenv("PILOSA_TPU_PALLAS", pallas)
    rng = np.random.default_rng(7)
    host = {"sparse": lambda: sparse_block(rng, 16, 4096, n_bits=200),
            "clustered": lambda: clustered_block(rng, 16, 4096),
            "unaligned": lambda: clustered_block(rng, 6, 1100)}[kind]()
    filt = (rng.integers(0, 2 ** 32, host.shape[1], dtype=np.uint32)
            if filtered else None)
    jcb, tcb = both(host)
    d0 = pallas_dispatches()
    want = np.asarray(jcb.row_counts(None if filt is None
                                     else jnp.asarray(filt)))
    assert pallas_dispatches() == d0 + (pallas == "1"), \
        "the JAX package did not take the path under test"
    got = tcb.row_counts(None if filt is None else tt(filt))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JB.row_counts(host, None if filt is None
                                               else jnp.asarray(filt))))


@pytest.mark.parametrize("filtered", [False, True])
def test_zero_run_and_dense_tags(forced, filtered):
    words = 2048
    rng = np.random.default_rng(3)
    filt = rng.integers(0, 2 ** 32, words, dtype=np.uint32)
    mixed = np.zeros((4, words), dtype=np.uint32)
    mixed[1] = 0xFFFFFFFF
    mixed[2, :100] = rng.integers(1, 2 ** 32, 100, dtype=np.uint32)
    for host in (np.zeros((4, words), dtype=np.uint32),
                 np.full((4, words), 0xFFFFFFFF, dtype=np.uint32), mixed):
        jcb, tcb = both(host)
        assert (tcb.zero_tiles, tcb.run_tiles, tcb.dense_tiles) == (
            jcb.zero_tiles, jcb.run_tiles, jcb.dense_tiles)
        f = tt(filt) if filtered else None
        jf = jnp.asarray(filt) if filtered else None
        np.testing.assert_array_equal(tcb.row_counts(f).numpy(),
                                      np.asarray(jcb.row_counts(jf)))


def test_nonuniform_const_filter_takes_the_dense_route(forced, monkeypatch):
    """Whole-tile runs of an arbitrary word under a filter: the JAX
    package takes the dense route (decode, then the dense row counts); the
    port counts each constant against its filter tile in the same
    ctile_count call as the payload, without decoding. The answers are
    identical."""
    host = np.full((4, 2048), 0xDEADBEEF, dtype=np.uint32)
    host[2, 5] = 7
    host[3, 600:700] = 0
    jcb, tcb = both(host)
    assert not jcb.const_uniform
    filt = np.random.default_rng(9).integers(0, 2 ** 32, 2048,
                                             dtype=np.uint32)
    monkeypatch.setattr(C, "_decode", None)  # any decode would raise
    got = tcb.row_counts(tt(filt))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jcb.row_counts(jnp.asarray(filt))))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JB.row_counts(host, jnp.asarray(filt))))
    # unfiltered, the closed form holds for any constant
    np.testing.assert_array_equal(tcb.row_counts().numpy(),
                                  np.asarray(jcb.row_counts()))


# ---------------------------------------------------------------------------
# the ctile_count function
# ---------------------------------------------------------------------------


def ctile_oracle(payload, prow, ptile, filt_tiles, const):
    def pop(x):
        return int(np.unpackbits(np.atleast_1d(np.asarray(
            x, dtype=np.uint32)).view(np.uint8)).sum())

    rows = const.shape[0]
    out = np.zeros(rows, dtype=np.int64)
    for p in range(payload.shape[0]):
        if not 0 <= prow[p] < rows:
            continue
        x = payload[p]
        if filt_tiles is not None:
            if not 0 <= ptile[p] < filt_tiles.shape[0]:
                continue
            x = x & filt_tiles[ptile[p]]
        out[prow[p]] += pop(x)
    for r, j in zip(*np.nonzero(const)):
        out[r] += (pop(filt_tiles[j] & const[r, j]) if filt_tiles is not None
                   else pop(const[r, j]) * payload.shape[1])
    return out.astype(np.int32)


@pytest.mark.parametrize("consts", ["zero", "uniform", "words"])
@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("t", [8, 64, 512])
def test_ctile_count_matches_the_jax_chain(t, filtered, consts):
    """payload & filter tile -> Pallas ctile_count (interpret) -> scatter
    with mode="drop" onto the constant tiles' closed form, against the
    port's ctile_count on CPU tensors (its plain version) and a numpy
    loop. Rows past the end (the padding) and all-ones / all-zero tiles
    included; constants of 0 / ~0 (the closed form's domain under a
    filter) or of any word."""
    rng = np.random.default_rng(t + 2 * filtered)
    p, rows, n_tiles = 40, 9, 5
    payload = rng.integers(0, 2 ** 32, (p, t), dtype=np.uint32)
    payload[3] = 0xFFFFFFFF
    payload[4] = 0
    prow = rng.integers(0, rows, p).astype(np.int32)
    prow[[0, 7, 39]] = [rows, rows + 3, rows]  # dropped entries
    ptile = rng.integers(0, n_tiles, p).astype(np.int32)
    filt_tiles = (rng.integers(0, 2 ** 32, (n_tiles, t), dtype=np.uint32)
                  if filtered else None)
    const = np.where(rng.random((rows, n_tiles)) < 0.3,
                     np.uint32(0xFFFFFFFF), np.uint32(0))
    if consts == "zero":
        const[:] = 0
    elif consts == "words":
            const[rng.random((rows, n_tiles)) < 0.3] = rng.integers(
                1, 2 ** 32, dtype=np.uint32)
    if filtered:
        filt_tiles[1] = 0xFFFFFFFF
        filt_tiles[2] = 0
        masked = JC._mask_payload(jnp.asarray(payload), jnp.asarray(ptile),
                                  jnp.asarray(filt_tiles))
    else:
        masked = jnp.asarray(payload)
    per_entry = JC._ctile_counts_pallas(masked, interpret=True)
    if filtered:
        base = JC._const_counts_filtered(
            jnp.asarray(const), JC._ctile_counts_xla(jnp.asarray(filt_tiles)))
    else:
        base = JC._const_counts_unfiltered(jnp.asarray(const), jnp.int32(t))
    want = np.asarray(JC._scatter_counts(per_entry, jnp.asarray(prow), base,
                                         rows))
    args = (tt(payload), torch.from_numpy(prow), torch.from_numpy(ptile),
            tt(const), None if filt_tiles is None else tt(filt_tiles))
    before = KU.launches()
    got = C.ctile_count(*args)
    assert KU.launches() == before  # CPU tensors launch nothing
    oracle = ctile_oracle(payload, prow, ptile, filt_tiles, const)
    np.testing.assert_array_equal(got.numpy(), oracle)
    np.testing.assert_array_equal(got.numpy(),
                                  C.ctile_count_plain(*args).numpy())
    if not (filtered and consts == "words"):  # outside the closed form
        np.testing.assert_array_equal(got.numpy(), want)


def test_ctile_count_drops_tiles_outside_the_filter():
    rng = np.random.default_rng(4)
    payload = rng.integers(0, 2 ** 32, (8, 8), dtype=np.uint32)
    prow = np.arange(8, dtype=np.int32) % 3
    ptile = np.array([0, 1, 2, 3, -1, 1, 0, 2], dtype=np.int32)
    filt_tiles = rng.integers(0, 2 ** 32, (3, 8), dtype=np.uint32)
    const = np.zeros((3, 3), dtype=np.uint32)
    got = C.ctile_count(tt(payload), torch.from_numpy(prow),
                        torch.from_numpy(ptile), tt(const), tt(filt_tiles))
    np.testing.assert_array_equal(
        got.numpy(), ctile_oracle(payload, prow, ptile, filt_tiles, const))


def test_ctile_count_rejects_mismatched_shapes():
    payload = torch.zeros((8, 8), dtype=torch.int32)
    idx = torch.zeros(8, dtype=torch.int32)
    const = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="one entry per payload row"):
        C.ctile_count(payload, idx[:4], idx, const)
    with pytest.raises(ValueError, match="are not 4 tiles of 8 words"):
        C.ctile_count(payload, idx, idx, const,
                      torch.zeros((4, 16), dtype=torch.int32))
    with pytest.raises(ValueError, match="2-D"):
        C.ctile_count(payload.reshape(-1), idx, idx, const)
    with pytest.raises(ValueError, match="2-D"):
        C.ctile_count(payload, idx, idx, const.reshape(-1))


# ---------------------------------------------------------------------------
# the stack route: ctile_count_blocks and the non-zero constant list
# ---------------------------------------------------------------------------


def stack_blocks(rng, rows, width):
    """Blocks of one width as a stack holds them: clustered runs, sparse
    bits, whole-tile runs of non-uniform words (which the JAX package
    decodes under a filter), all-ones rows and an empty block."""
    nonuniform = np.zeros((rows, width), dtype=np.uint32)
    t = C.tile_words(width)
    for r in range(rows):
        for j in range(-(-width // t)):
            if (r + j) % 3 == 0:
                nonuniform[r, j * t:(j + 1) * t] = rng.integers(
                    1, 2 ** 32, dtype=np.uint32)
    nonuniform[min(1, rows - 1), min(3, width - 1)] ^= 7  # one dense tile
    ones = np.zeros((rows, width), dtype=np.uint32)
    ones[::2] = 0xFFFFFFFF
    return [clustered_block(rng, rows, width),
            sparse_block(rng, rows, width, n_bits=60), nonuniform, ones,
            np.zeros((rows, width), dtype=np.uint32)]


@pytest.mark.parametrize("pallas", ["1", "0"])
@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("width", [1100, 4096])
def test_ctile_count_blocks_matches_jax(forced, monkeypatch, pallas,
                                        filtered, width):
    """The port's many-block count (CPU tensors: its plain version)
    against the JAX package's _compressed_row_counts, block by block and
    concatenated; padded entries (every payload count here is below its
    power-of-two cap), non-uniform constants under a filter (decoded by
    the JAX package, counted exactly by the port) and a width that is not
    a whole number of tiles (1100) included."""
    monkeypatch.setenv("PILOSA_TPU_PALLAS", pallas)
    rng = np.random.default_rng(width + filtered)
    hosts = stack_blocks(rng, 8, width)
    pairs = [both(h) for h in hosts]
    assert any(tcb.n_payload < tcb.payload.shape[0] for _, tcb in pairs)
    assert any(not jcb.const_uniform for jcb, _ in pairs)
    filt = (rng.integers(0, 2 ** 32, width, dtype=np.uint32)
            if filtered else None)
    jf = None if filt is None else jnp.asarray(filt)
    want = [np.asarray(JC._compressed_row_counts(jcb, jf))
            for jcb, _ in pairs]
    blocks = [tcb for _, tcb in pairs]
    before = KU.launches()
    got = C.ctile_count_blocks(blocks, None if filt is None else tt(filt))
    assert KU.launches() == before  # CPU tensors launch nothing
    np.testing.assert_array_equal(got.numpy(), np.concatenate(want))
    for tcb, w in zip(blocks, want):
        one = C.ctile_count_blocks([tcb], None if filt is None else tt(filt))
        np.testing.assert_array_equal(one.numpy(), w)
    # into a zeroed stack output at given offsets, as core/stacked.py does
    out = torch.zeros(8 * len(blocks) + 8, dtype=torch.int32)
    offs = [8 * (len(blocks) - k) for k in range(len(blocks))]
    C.ctile_count_blocks(blocks, None if filt is None else tt(filt), out,
                         offs)
    for off, w in zip(offs, want):
        np.testing.assert_array_equal(out[off:off + 8].numpy(), w)
    assert not out[:8].any()


def test_ctile_count_blocks_rejects_mixed_widths_and_short_outputs(forced):
    rng = np.random.default_rng(5)
    a = C.maybe_compress(sparse_block(rng, 4, 1024), CPU)
    b = C.maybe_compress(sparse_block(rng, 4, 2048), CPU)
    with pytest.raises(ValueError, match="one width"):
        C.ctile_count_blocks([a, b])
    with pytest.raises(ValueError, match="outside the output"):
        C.ctile_count_blocks([a], out=torch.zeros(6, dtype=torch.int32),
                             offsets=[3])
    with pytest.raises(ValueError, match="no blocks"):
        C.ctile_count_blocks([])


@pytest.mark.parametrize("kind", ["sparse", "clustered", "nonuniform"])
@pytest.mark.parametrize("shape", SHAPES)
def test_nonzero_constant_list_matches_jax_classify(forced, kind, shape):
    """The kernel's list of non-zero constants is np.nonzero of the JAX
    package's constant table (row-major), with the words at those
    places, on the host and as the block holds it."""
    rng = np.random.default_rng(shape[0] + shape[1])
    if kind == "nonuniform":
        host = stack_blocks(rng, shape[0], shape[1])[2]
    elif kind == "clustered" and shape[1] * 32 >= shape[0]:
        host = clustered_block(rng, *shape)
    else:
        host = sparse_block(rng, *shape)
    const = JC.classify(host)[2]
    r, j = np.nonzero(const)
    got = C.nonzero_constants(np.asarray(const))
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, np.stack([r, j, const[r, j]]))
    tcb = C.maybe_compress(host, CPU)
    np.testing.assert_array_equal(u(tcb.nz), got)
    assert tcb.n_nz == r.size and tcb.nz_nbytes == 12 * r.size


def test_nbytes_is_unchanged_and_the_budget_charges_the_list(forced):
    from pilosa_tpu_torch.core import stacked as tstacked

    rng = np.random.default_rng(8)
    for host in stack_blocks(rng, 8, 4096):
        jcb, tcb = both(host)
        assert tcb.nbytes == jcb.nbytes
        assert tstacked._nbytes(tcb) == tcb.nbytes + 12 * tcb.n_nz
    assert any(tcb.n_nz for tcb in (C.maybe_compress(h, CPU) for h in
                                    stack_blocks(rng, 8, 4096)))


# ---------------------------------------------------------------------------
# compressed BSI compare
# ---------------------------------------------------------------------------

BSI_CASES = [(S.EQ, 3, None), (S.NE, 3, None), (S.LT, 0, None),
             (S.LE, -5, None), (S.GT, 10, None), (S.GE, -49, None),
             (S.BETWEEN, -10, 20)]


@pytest.mark.parametrize("op,v,v2", BSI_CASES)
@pytest.mark.parametrize("clustered", [False, True])
def test_bsi_compare_compressed_matches(forced, op, v, v2, clustered):
    rng = np.random.default_rng(11)
    depth, words = 7, 8192
    cols = (rng.integers(0, 2048 * 32, 3000) if clustered
            else rng.integers(0, words * 32, 300))
    cols = np.unique(cols)
    vals = rng.integers(-50, 50, cols.size)
    planes = S.encode_values(cols, vals, depth, words)
    jcb = JC.maybe_compress(planes, kind="bsi")
    tcb = C.maybe_compress(planes, CPU)
    assert tcb.active_tiles.tolist() == np.asarray(jcb.active_tiles).tolist()
    got = C.bsi_compare_compressed(tcb, op, v, v2)
    np.testing.assert_array_equal(
        u(got), np.asarray(JC.bsi_compare_compressed(jcb, op, v, v2)))
    np.testing.assert_array_equal(
        u(got), u(S.bsi_compare_plain(tcb.decode(), op, v, v2)))
    np.testing.assert_array_equal(
        u(got), np.asarray(JS.bsi_compare(jnp.asarray(planes), op, v, v2)))


def test_bsi_compare_compressed_empty_stack(forced):
    planes = np.zeros((S.OFFSET + 3, 4096), dtype=np.uint32)
    jcb = JC.maybe_compress(planes, kind="bsi")
    tcb = C.maybe_compress(planes, CPU)
    assert tcb.active_tiles.size == 0 == np.asarray(jcb.active_tiles).size
    for op, v, v2 in BSI_CASES:
        got = C.bsi_compare_compressed(tcb, op, v, v2)
        assert got.shape == (4096,) and not got.any()
        assert not np.asarray(JC.bsi_compare_compressed(jcb, op, v, v2)).any()
