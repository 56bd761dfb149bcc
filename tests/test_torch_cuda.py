"""The port's CUDA kernels against their plain PyTorch versions, on a card.

The kernels have no CPU mode, so every test here needs an NVIDIA GPU and
skips without one. This file imports neither JAX nor the JAX package, so
it also runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest`` because tests/conftest.py pins JAX to the CPU.)
Tolerance 0: every result is an integer or a bitmap.
"""

import time

import numpy as np
import pytest
import torch

from pilosa_tpu_torch.api import API
from pilosa_tpu_torch.core import stacked as STK
from pilosa_tpu_torch.ops import bitmap as B
from pilosa_tpu_torch.ops import bsi as S
from pilosa_tpu_torch.ops import ctiles as C
from pilosa_tpu_torch.ops import groupby as G
from pilosa_tpu_torch.ops import kernel_util as KU
from pilosa_tpu_torch.ops import scatter as SC
from pilosa_tpu_torch.ops import topk as T

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def words(rng, shape, device):
    host = rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)
    return torch.from_numpy(host.view(np.int32)).to(device)


#: shapes that reach every regime of ops/groupby.py _plan (one row of A;
#: both sides of at most 32 rows; more) and each of these swapped
PC_R1 = [1, 2, 3, 8, 9, 16, 130]
PC_R2 = [1, 20, 40, 127, 128, 129, 300]


def _pair_counts_once(a, b):
    before = KU.launches()["pair_counts"]
    got = G.pair_counts(a, b)
    torch.cuda.synchronize()
    assert KU.launches()["pair_counts"] == before + 1
    return got


@pytest.mark.parametrize("w", [1, 7, 1000, 32768 + 3])
@pytest.mark.parametrize("r2", PC_R2)
@pytest.mark.parametrize("r1", PC_R1)
def test_pair_counts_kernel(dev, r1, r2, w):
    rng = np.random.default_rng(r1 * 1000 + r2 + w)
    a, b = words(rng, (r1, w), dev), words(rng, (r2, w), dev)
    assert torch.equal(_pair_counts_once(a, b), G.pair_counts_plain(a, b))


@pytest.mark.parametrize("r1,r2,w", [(8, 256, 6 * 32768), (1, 256, 6 * 32768),
                                     (2, 20, 10 * 32768),
                                     (256, 40, 6 * 32768),
                                     (16, 256, 6 * 32768)])
def test_pair_counts_kernel_main_path_shapes(dev, r1, r2, w):
    """GroupBy, TopN, Sum, the one-field GroupBy-Sum and pair_sums at
    their stacked widths."""
    rng = np.random.default_rng(r1 + r2)
    a, b = words(rng, (r1, w), dev), words(rng, (r2, w), dev)
    assert torch.equal(_pair_counts_once(a, b), G.pair_counts_plain(a, b))


@pytest.mark.parametrize("off", [1, 2, 3])
@pytest.mark.parametrize("r1,r2,w", [(2, 20, 1001), (1, 129, 32768 + 3),
                                     (8, 40, 7), (40, 8, 1003)])
def test_pair_counts_kernel_on_misaligned_views(dev, r1, r2, w, off):
    """Views that start 1-3 rows into a stack, as planes[OFFSET:] does:
    at odd w their first word is not 16-byte aligned."""
    rng = np.random.default_rng(off * 100 + r1)
    sa = words(rng, (r1 + off, w), dev)
    sb = words(rng, (r2 + off, w), dev)
    a, b = sa[off:], sb[off:]
    assert a.data_ptr() % 16 != 0 or w % 4 == 0
    assert torch.equal(_pair_counts_once(a, b), G.pair_counts_plain(a, b))


@pytest.mark.parametrize("r1,r2", [(2, 20), (1, 256), (8, 40), (40, 8)])
def test_pair_counts_kernel_saturates_exactly(dev, r1, r2):
    """All-ones rows at the BSI path's width: every count is 32 * w."""
    w = 10 * 32768
    a = torch.full((r1, w), -1, dtype=torch.int32, device=dev)
    b = torch.full((r2, w), -1, dtype=torch.int32, device=dev)
    assert torch.equal(_pair_counts_once(a, b),
                       torch.full((r1, r2), 32 * w, dtype=torch.int32,
                                  device=dev))


def test_pair_counts_kernel_refuses_past_the_int32_bound(dev):
    a = torch.zeros((1, 1 << 26), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="int32"):
        G.pair_counts(a, a)


@pytest.mark.parametrize("masked", [False, True])
def test_tape_count_kernel(dev, masked):
    rng = np.random.default_rng(11)
    tape = (("and", 0, 1), ("or", 3, 2), ("andnot", 4, 0), ("xor", 5, 1))
    leaves = [words(rng, (3 * 512 + 5,), dev) for _ in range(3)]
    mask = words(rng, (3 * 512 + 5,), dev) if masked else None
    before = KU.launches()["tape_count"]
    assert int(B.tape_count(tape, leaves, mask)) == int(
        B.tape_count_plain(tape, leaves, mask))
    assert KU.launches()["tape_count"] == before + 1


def random_tape(rng, n_leaves, n_ops):
    """A seeded tape of ``n_ops`` ops over ``n_leaves`` leaves; the first
    ops fold in every leaf, so each is read."""
    ops = ["and", "or", "xor", "andnot"]
    tape = []
    for k in range(n_ops):
        regs = n_leaves + k
        if k < n_leaves - 1:
            i, j = (k if k == 0 else regs - 1), k + 1
        else:
            i, j = (int(x) for x in rng.integers(0, regs, 2))
        tape.append((ops[int(rng.integers(0, 4))], i, j))
    return tuple(tape)


#: (leaves, ops): one plane's count and a two-row Count (the one-op
#: path); 2, 6 and 7 ops over two leaves and 4 over four (the general
#: path); 32 leaves and 64 ops (the kernel's limits)
TAPE_SIZES = {"one-leaf": (1, 1), "one-op": (2, 1), "ops-2": (2, 2),
              "ops-6": (2, 6), "ops-7": (2, 7), "wide-4": (4, 4),
              "limits": (32, 64)}


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("layout", ["separate", "rows", "shifted"])
@pytest.mark.parametrize("size", sorted(TAPE_SIZES))
@pytest.mark.parametrize("w", [1, 3, 4, 5, 7, (1 << 20) + 3])
def test_tape_count_kernel_shapes(dev, w, size, layout, masked):
    """Every path of the kernel against its plain version, one launch a
    count: ``separate`` leaves are 16-byte aligned; ``rows`` are row views
    of one 2-D tensor, at different offsets modulo 16 bytes when w is odd
    (the 32-bit path); ``shifted`` leaves all start one word into their
    tensor (a peeled head)."""
    n_leaves, n_ops = TAPE_SIZES[size]
    rng = np.random.default_rng(w * 100 + n_ops)
    tape = random_tape(rng, n_leaves, n_ops)
    if n_leaves == 1:
        tape = (("or", 0, 0),)
    n = n_leaves + masked
    if layout == "rows":
        planes = list(words(rng, (n, w), dev))
    elif layout == "shifted":
        planes = [words(rng, (w + 1,), dev)[1:] for _ in range(n)]
    else:
        planes = [words(rng, (w,), dev) for _ in range(n)]
    leaves, mask = planes[:n_leaves], (planes[-1] if masked else None)
    before = KU.launches()["tape_count"]
    got = B.tape_count(tape, leaves, mask)
    torch.cuda.synchronize()
    assert KU.launches()["tape_count"] == before + 1
    assert got.dtype == torch.int32 and got.shape == ()
    assert int(got) == int(B.tape_count_plain(tape, leaves, mask))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("op", ["and", "or", "xor", "andnot"])
@pytest.mark.parametrize("a,b", [(0, 1), (1, 0), (1, 1), (4, 2)])
def test_tape_count_one_op_operands(dev, a, b, op, masked):
    """A one-op tape is passed its operands in tape order (one leaf when
    both name it), whichever of its leaves they are."""
    rng = np.random.default_rng(a * 10 + b)
    leaves = [words(rng, (6 * 32768 + 3,), dev) for _ in range(max(a, b) + 1)]
    mask = words(rng, (6 * 32768 + 3,), dev) if masked else None
    tape = ((op, a, b),)
    assert int(B.tape_count(tape, leaves, mask)) == int(
        B.tape_count_plain(tape, leaves, mask))


def test_tape_count_is_one_device_op(dev):
    """No fill before the kernel: a count is one device operation, and
    back-to-back counts on one stream agree (each launch leaves its
    accumulator zero for the next)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(21)
    a, b = words(rng, (6 * 32768,), dev), words(rng, (6 * 32768,), dev)
    want = int(B.tape_count_plain((("and", 0, 1),), [a, b]))
    B.tape_count((("and", 0, 1),), [a, b])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        outs = [B.tape_count((("and", 0, 1),), [a, b]) for _ in range(10)]
        torch.cuda.synchronize()
    # one kernel and no other op; a trace can miss an event now and then
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len({e.name for e in ops}) == 1 and 5 <= len(ops) <= 10, \
        sorted({e.name for e in ops})
    assert [int(o) for o in outs] == [want] * 10


def _compressed_blocks(monkeypatch, rng, n, width, device, rows=16):
    """``n`` forced-compressed blocks of ``rows`` x ``width``: zero,
    all-ones and non-uniform constant tiles, dense tiles of random bits,
    and one all-zero block."""
    monkeypatch.setenv("PILOSA_TPU_COMPRESS", "1")
    t = C.tile_words(width)
    n_tiles = -(-width // t)
    out = []
    for k in range(n):
        pick = rng.integers(0, 5, (rows, n_tiles))
        host = np.zeros((rows, n_tiles * t), dtype=np.uint32)
        for r, j in zip(*np.nonzero(pick)):
            kind = pick[r, j]
            tile = host[r, j * t:(j + 1) * t]
            if kind == 1:
                tile[:] = 0xFFFFFFFF
            elif kind == 2:
                tile[:] = rng.integers(1, 1 << 32, dtype=np.uint32)
            elif kind == 3:
                tile[:] = rng.integers(0, 1 << 32, t, dtype=np.uint32)
        if k == n - 1:
            host[:] = 0
        cb = C.maybe_compress(np.ascontiguousarray(host[:, :width]), device)
        assert cb is not None
        out.append(cb)
    return out


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("width", [8, 64, 3 * 512 + 100])
@pytest.mark.parametrize("n", [1, 10, 17, 35])
def test_ctile_count_blocks_kernel(dev, monkeypatch, n, width, filtered):
    """Stacks of 1, 10 and more blocks than one launch takes, at T = 8,
    64 and 512 (a ragged last tile), with non-uniform constants: one
    launch per MAX_BLOCKS blocks, equal to the plain version and to the
    dense counts of the decoded blocks."""
    rng = np.random.default_rng(n * 1000 + width + filtered)
    blocks = _compressed_blocks(monkeypatch, rng, n, width, dev)
    filt = words(rng, (width,), dev) if filtered else None
    before = KU.launches()["ctile_count"]
    got = C.ctile_count_blocks(blocks, filt)
    torch.cuda.synchronize()
    assert KU.launches()["ctile_count"] == before + -(-n // C.MAX_BLOCKS)
    assert torch.equal(got, C.ctile_count_blocks_plain(blocks, filt))
    assert torch.equal(got, torch.cat([T.row_counts(cb.decode(), filt)
                                       for cb in blocks]))


def test_ctile_count_blocks_kernel_misaligned_filter(dev, monkeypatch):
    """Filter tiles that start one word into their tensor take the
    scalar loop."""
    rng = np.random.default_rng(22)
    blocks = _compressed_blocks(monkeypatch, rng, 3, 4 * 512, dev)
    big = words(rng, (4 * 512 + 1,), dev)
    ft = big[1:].reshape(4, 512)
    assert ft.is_contiguous() and ft.data_ptr() % 16 != 0
    got = C.ctile_count_blocks(blocks, ft)
    assert torch.equal(got, C.ctile_count_blocks_plain(blocks, ft))


def test_scatter_merge_kernel(dev):
    rng = np.random.default_rng(12)
    flat = words(rng, (4096,), dev)
    addr = torch.from_numpy(np.sort(rng.choice(4096, 900, replace=False))
                            .astype(np.int32)).to(dev)
    masks = words(rng, (900,), dev)
    f1, f2 = flat.clone(), flat.clone()
    assert int(SC.scatter_merge_(f1, addr, masks)) == int(
        SC.scatter_merge_plain(f2, addr, masks))
    assert torch.equal(f1, f2)


@pytest.mark.parametrize("off_a,off_k", [(0, 0), (1, 1), (2, 2), (3, 3),
                                         (1, 2), (0, 3)])
@pytest.mark.parametrize("n,m", [(8, 1), (512, 3), (512, 7), (4096, 900),
                                 (32768, 32768)])
def test_scatter_merge_kernel_edges(dev, n, m, off_a, off_k):
    """Updates 0-3 into their tensors (a scalar head and tail around the
    16-byte body), addresses and masks at different offsets modulo 16
    bytes (32-bit loads), and addresses outside the flat (dropped)."""
    rng = np.random.default_rng(n + m + 10 * off_a + off_k)
    flat = words(rng, (n,), dev)
    addr_np = np.sort(rng.choice(n, m, replace=False)).astype(np.int32)
    if m > 4:
        addr_np[-2:] = (n, -1)
    addr = torch.from_numpy(np.r_[np.zeros(off_a, np.int32), addr_np]
                            ).to(dev)[off_a:]
    masks = words(rng, (m + off_k,), dev)[off_k:]
    f1, f2 = flat.clone(), flat.clone()
    before = SC.scatter_merge_launches.n
    got = SC.scatter_merge_(f1, addr, masks)
    assert SC.scatter_merge_launches.n == before + 1
    assert torch.equal(got, SC.scatter_merge_plain(f2, addr, masks))
    assert torch.equal(f1, f2)


def _config1_batch(t):
    """The first city batch of BASELINE.json config 1 as the bulk path
    stages it: (packed flat size, addresses, masks)."""
    from pilosa_tpu_torch.probes import import_probe as IP

    city, _ = IP.config1_data(IP.C1_BATCH)
    addr, masks = SC.sort_updates(city, np.arange(city.size), 32768)
    which, packed, _ = SC.pack_tiles(addr, t)
    return which.size * t, packed.astype(np.int32), masks.view(np.int32)


@pytest.mark.parametrize("t", [8, 32, 512])
def test_scatter_merge_kernel_config1_batch(dev, t):
    n, addr, masks = _config1_batch(t)
    rng = np.random.default_rng(t)
    flat = words(rng, (n,), dev)
    a, k = torch.from_numpy(addr).to(dev), torch.from_numpy(masks).to(dev)
    f1, f2 = flat.clone(), flat.clone()
    assert torch.equal(SC.scatter_merge_(f1, a, k),
                       SC.scatter_merge_plain(f2, a, k))
    assert torch.equal(f1, f2)
    assert int(SC.scatter_merge_(f1, a, k)) == 0  # nothing new


def test_scatter_merge_is_one_device_op(dev):
    """No fill before the kernel: a call is one device operation, and
    back-to-back calls on one stream agree with the plain version (each
    launch leaves the shared accumulator zero), interleaved with
    tape_count, which shares it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n, addr, masks = _config1_batch(32)
    rng = np.random.default_rng(23)
    flats = [words(rng, (n,), dev) for _ in range(10)]
    want = [int(SC.scatter_merge_plain(f.clone(), torch.from_numpy(addr)
                                       .to(dev), torch.from_numpy(masks)
                                       .to(dev))) for f in flats]
    a, k = torch.from_numpy(addr).to(dev), torch.from_numpy(masks).to(dev)
    SC.scatter_merge_(flats[0].clone(), a, k)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        outs = [SC.scatter_merge_(f, a, k) for f in flats]
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len({e.name for e in ops}) == 1 and 5 <= len(ops) <= 10, \
        sorted({e.name for e in ops})
    assert [int(o) for o in outs] == want
    x, y = words(rng, (4096,), dev), words(rng, (4096,), dev)
    counts = [(B.tape_count((("and", 0, 1),), [x, y]),
               SC.scatter_merge_(words(rng, (n,), dev), a, k))
              for _ in range(3)]
    for c, _ in counts:
        assert int(c) == int(B.tape_count_plain((("and", 0, 1),), [x, y]))


@pytest.mark.parametrize("cap", [64 << 20, 4096])
@pytest.mark.parametrize("t", [8, 32, 512])
def test_scatter_new_bits_bulk_on_the_card_matches_the_cpu(dev, monkeypatch,
                                                           t, cap):
    """The staged path (pinned buffer, one H2D, one launch, one D2H per
    chunk) against the CPU's, planes word for word, in one chunk and in
    many."""
    monkeypatch.setattr(SC, "TILE_WORDS", t)
    monkeypatch.setattr(SC, "MAX_STAGED_BYTES", cap)
    rng = np.random.default_rng(t + cap)
    base = rng.integers(0, 1 << 32, (40, 32768), dtype=np.uint32) \
        & rng.integers(0, 1 << 32, (40, 32768), dtype=np.uint32)
    slots = rng.integers(0, 37, 20000)
    cols = rng.integers(0, 1 << 20, 20000)
    on_card, on_cpu = base.copy(), base.copy()
    before = SC.scatter_merge_launches.n
    got = SC.scatter_new_bits_bulk(on_card, slots, cols, dev)
    assert got == SC.scatter_new_bits_bulk(on_cpu, slots, cols,
                                           torch.device("cpu")) > 0
    assert np.array_equal(on_card, on_cpu)
    if cap > 1 << 20:
        assert SC.scatter_merge_launches.n == before + 1


def test_api_on_the_card_matches_the_cpu(dev):
    rng = np.random.default_rng(13)
    cols = np.arange(1 << 20, dtype=np.int64)
    rows = rng.integers(0, 5, cols.size)
    keys = [f"k{r}" for r in rng.integers(0, 9, cols.size)]
    q = ('GroupBy(Rows(a), Rows(b), limit=20)TopN(b, n=3)'
         'Count(Intersect(Row(a=1), Row(b="k2")))Row(a=4)')
    out = []
    for device in (None, "cpu"):
        api = API(device=device)
        api.create_index("i")
        api.create_field("i", "a", {"type": "mutex"})
        api.create_field("i", "b", {"type": "mutex", "keys": True})
        api.import_bits("i", "a", rows=rows, cols=cols)
        api.import_bits("i", "b", cols=cols, row_keys=keys)
        out.append(repr(api.query("i", q)))
    assert out[0] == out[1]


BSI_OPS = [S.EQ, S.NE, S.LT, S.LE, S.GT, S.GE, S.BETWEEN]


@pytest.mark.parametrize("depth", [1, 20, 64])
@pytest.mark.parametrize("w", [1, 7, 1000, 3 * 512 + 5])
def test_bsi_compare_kernel(dev, depth, w):
    """Random bit patterns in every plane; constants negative, zero,
    positive and overflowing; BETWEEN pairs that straddle zero or are
    reversed."""
    rng = np.random.default_rng(depth * 10000 + w)
    planes = words(rng, (S.OFFSET + depth, w), dev)
    top = 1 << depth
    mid = int(rng.integers(1, min(top, 1 << 62)))
    consts = [(-mid, None), (0, None), (mid, None), (top, None),
              (-top - 3, None)]
    pairs = [(-mid, mid), (mid, -mid), (0, 0), (-top, top)]
    before = KU.launches()["bsi_compare"]
    n = 0
    for op in BSI_OPS:
        for c, c2 in (pairs if op == S.BETWEEN else consts):
            got = S.bsi_compare(planes, op, c, c2)
            torch.cuda.synchronize()
            assert torch.equal(got, S.bsi_compare_plain(planes, op, c, c2)), \
                (op, c, c2)
            n += 1
    assert KU.launches()["bsi_compare"] == before + n


def test_bsi_compare_rejects_what_the_kernel_cannot_take(dev):
    with pytest.raises(ValueError, match="depth"):
        S.bsi_compare(torch.zeros((S.OFFSET + 65, 8), dtype=torch.int32,
                                  device=dev), S.GT, 1)
    with pytest.raises(TypeError):
        S.bsi_compare(torch.zeros((S.OFFSET + 3, 8), dtype=torch.int64,
                                  device=dev), S.GT, 1)
    with pytest.raises(ValueError, match="contiguous"):
        S.bsi_compare(torch.zeros((8, S.OFFSET + 3), dtype=torch.int32,
                                  device=dev).t(), S.GT, 1)


def test_bsi_api_on_the_card_matches_the_cpu(dev):
    rng = np.random.default_rng(14)
    n = 2 << 20
    cols = np.arange(n, dtype=np.int64)
    rows = rng.integers(0, 6, n)
    vals = rng.integers(-70000, 70000, n)
    q = ("Sum(Row(v > 100), field=v)Min(field=v)Max(Row(f=2), field=v)"
         "Percentile(field=v, nth=50)Percentile(field=v, nth=1)"
         "Count(Row(-500 <= v <= 500))Count(Row(v == -7))Row(v == 12)"
         "Count(Intersect(Row(f=1), Row(v != 3)))"
         "GroupBy(Rows(f), aggregate=Sum(field=v))"
         "GroupBy(Rows(f), Rows(g), aggregate=Sum(field=v), limit=9)"
         "TopN(f, Row(v > 0), n=3)")
    out = []
    for device in (None, "cpu"):
        api = API(device=device)
        api.create_index("i")
        api.create_field("i", "f", {"type": "mutex"})
        api.create_field("i", "g", {"type": "set"})
        api.create_field("i", "v", {"type": "int", "base": -3})
        api.import_bits("i", "f", rows=rows, cols=cols)
        api.import_bits("i", "g", rows=rows[::3] % 4, cols=cols[::3])
        api.import_values("i", "v", cols=cols, values=vals)
        out.append(repr(api.query("i", q)))
    assert out[0] == out[1]


@pytest.mark.parametrize("consts", [False, True])
@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("t", [8, 12, 64, 512])
@pytest.mark.parametrize("p", [8, 1000])
def test_ctile_count_kernel(dev, p, t, filtered, consts):
    """Rows past the end (the padding) are dropped; all-ones and all-zero
    tiles included; constants of 0, ~0 and other words; T = 12 takes the
    kernel's scalar loop."""
    rng = np.random.default_rng(p * 1000 + t * 4 + filtered * 2 + consts)
    rows, n_tiles = 37, 11
    payload = words(rng, (p, t), dev)
    payload[0] = -1
    payload[1] = 0
    prow = torch.from_numpy(rng.integers(0, rows + 3, p).astype(np.int32)
                            ).to(dev)
    ptile = torch.from_numpy(rng.integers(0, n_tiles, p).astype(np.int32)
                             ).to(dev)
    filt = words(rng, (n_tiles, t), dev) if filtered else None
    pick = rng.integers(0, 4, (rows, n_tiles)) if consts else np.full(
        (rows, n_tiles), 3)
    host = np.where(pick == 0, rng.integers(0, 1 << 32, (rows, n_tiles),
                                            dtype=np.uint32),
                    np.where(pick == 1, 0xFFFFFFFF, 0)).astype(np.uint32)
    const = torch.from_numpy(host.view(np.int32)).to(dev)
    before = KU.launches()["ctile_count"]
    got = C.ctile_count(payload, prow, ptile, const, filt)
    torch.cuda.synchronize()
    assert torch.equal(got, C.ctile_count_plain(payload, prow, ptile, const,
                                                filt))
    assert KU.launches()["ctile_count"] == before + 1


@pytest.mark.parametrize("filtered", [False, True])
def test_compressed_row_counts_on_the_card(dev, filtered):
    """A clustered block compressed on the card counts as the dense
    pair_counts path counts its decoded block."""
    rng = np.random.default_rng(15)
    rows, width = 64, 4 * 32768
    bounds = np.sort(rng.choice(width * 32, rows - 1, replace=False))
    host = np.zeros((rows, width), dtype=np.uint32)
    for r, (lo, hi) in enumerate(zip(np.r_[0, bounds],
                                     np.r_[bounds, width * 32])):
        bits = np.zeros(width * 32, dtype=bool)
        bits[lo:hi] = True
        host[r] = np.packbits(bits, bitorder="little").view("<u4")
    cb = C.maybe_compress(host, dev)
    assert cb is not None and cb.payload.is_cuda
    filt = words(rng, (width,), dev) if filtered else None
    before = KU.launches()["ctile_count"]
    got = cb.row_counts(filt)
    assert KU.launches()["ctile_count"] == before + 1
    dense = cb.decode()
    assert np.array_equal(dense.cpu().numpy().view(np.uint32), host)
    assert torch.equal(got, T.row_counts(dense, filt))


@pytest.mark.parametrize("fresh", [False, True])
@pytest.mark.parametrize("n", [1, 37, 4096])
def test_apply_bit_deltas_on_the_card_matches_the_cpu(dev, n, fresh):
    """The advance's mask scatter on a CUDA block equals the same call on
    CPU tensors bit for bit, and writes a copy unless told the block is
    fresh."""
    rng = np.random.default_rng(n)
    rows, width = 16, 3 * 32768
    block = words(rng, (rows, width), torch.device("cpu"))
    flat = rng.choice(rows * width, n, replace=False)
    args = [torch.from_numpy(a.astype(np.uint32).view(np.int32))
            for a in (flat // width, flat % width,
                      rng.integers(0, 1 << 32, n, dtype=np.uint32),
                      rng.integers(0, 1 << 32, n, dtype=np.uint32))]
    want = STK._apply_bit_deltas(block, *args)
    on_card = block.to(dev)
    got = STK._apply_bit_deltas(on_card, *[a.to(dev) for a in args],
                                fresh=fresh)
    assert got.is_cuda and torch.equal(got.cpu(), want)
    assert (got is on_card) == fresh
    if not fresh:
        assert torch.equal(on_card.cpu(), block)


def test_writes_between_reads_on_the_card_match_the_cpu(dev):
    """PQL writes between reads advance the stacks on the card with no
    upload, and answer as the CPU does."""
    rng = np.random.default_rng(16)
    rows, cols = rng.integers(0, 50, 20000), rng.integers(0, 2 << 20, 20000)
    values = rng.integers(0, 1000, 5000)
    apis = [API(), API(device="cpu")]
    for api in apis:
        api.create_index("w")
        api.create_field("w", "f")
        api.create_field("w", "n", {"type": "int"})
        api.import_bits("w", "f", rows=rows, cols=cols)
        api.import_values("w", "n", cols=cols[:5000], values=values)
    reads = "Count(Row(f=3))TopN(f, n=5)Sum(Row(n > 3), field=n)"
    answers = [[api.query("w", reads)] for api in apis]
    writes = ["Set(5, f=3)", "Set(6, f=77)", "Clear(5, f=3)", "Set(9, n=12)",
              "Clear(9, n=0)", f"Set({(1 << 20) + 3}, f=3)"]
    for w in writes:
        for api, out in zip(apis, answers):
            before = STK.UPLOAD_STATS["count"]
            api.query("w", w)
            out.append(api.query("w", reads))
            assert STK.UPLOAD_STATS["count"] == before, w
    assert answers[0] == answers[1]
    st = STK.stacked_set(apis[0].holder.index("w").field("f"), [0, 1],
                         "standard")
    assert st.planes.is_cuda
    assert np.array_equal(st.planes.cpu().numpy().view(np.uint32),
                          st._assemble_host(0))


def _ranged_tape(n_views):
    """The lowering of a ranged Row: a zero leaf OR-chained with one leaf
    per covering view (``pql/programs.py``)."""
    tape, out = [], 0
    for v in range(n_views):
        tape.append(("or", out, v + 1))
        out = n_views + 1 + v
    return tuple(tape)


@pytest.mark.parametrize("n_views", [4, 12])
@pytest.mark.parametrize("shards", [1, 8, 64])
def test_tape_count_kernel_ranged_tapes(dev, n_views, shards):
    """The 5- and 13-leaf tapes of a ranged Count (a zero leaf and 4 or
    12 month views), rows of one view stack each, against the plain
    version, one launch a count."""
    rng = np.random.default_rng(n_views * 100 + shards)
    w = shards * 32768
    stack = words(rng, (n_views, w), dev)
    leaves = [B.device_zeros(w, dev)] + [stack[v] for v in range(n_views)]
    tape = _ranged_tape(n_views)
    assert len(leaves) == n_views + 1 and len(tape) == n_views
    before = KU.launches()["tape_count"]
    got = B.tape_count(tape, leaves)
    torch.cuda.synchronize()
    assert KU.launches()["tape_count"] == before + 1
    assert int(got) == int(B.tape_count_plain(tape, leaves))


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("shards", [1, 8, 64])
def test_pair_counts_kernel_ranged_topn_shape(dev, filtered, shards):
    """A ranged TopN's count step: A = one filter (or all-ones) row, B =
    the 4 rows merged across the covering views."""
    rng = np.random.default_rng(shards + 7 * filtered)
    w = shards * 32768
    merged = words(rng, (4, w), dev)
    filt = words(rng, (w,), dev) if filtered else None
    f = filt if filtered else B.device_ones(w, dev)
    want = G.pair_counts_plain(f.reshape(1, -1), merged)[0]
    before = KU.launches()["pair_counts"]
    got = T.row_counts(merged, filt)
    torch.cuda.synchronize()
    assert KU.launches()["pair_counts"] == before + 1
    assert torch.equal(got, want)


def test_time_ranges_on_the_card_match_the_cpu(dev):
    """A time field written with timestamps, then ranged reads, row-set
    calls and timestamped writes between reads, on the card and on the
    CPU alike; the writes into cached month views upload no stack."""
    rng = np.random.default_rng(18)
    apis = [API(), API(device="cpu")]
    cols = rng.integers(0, 3 << 20, 300)
    for api in apis:
        api.create_index("t")
        api.create_field("t", "cab", {"type": "time", "timeQuantum": "YMD"})
        for k, c in enumerate(cols):
            api.query("t", f"Set({int(c)}, cab={k % 4}, "
                           f"2010-{1 + k % 12:02d}-{1 + k % 28:02d}T00:00)")
    rng_ = "from='2010-03-01T00:00', to='2010-07-01T00:00'"
    reads = (f"Count(Row(cab=1, {rng_}))TopN(cab, n=4, {rng_})"
             f"Rows(cab, {rng_})Count(UnionRows(Rows(cab, {rng_})))"
             f"Count(Shift(Row(cab=1, {rng_}), n=1))"
             f"IncludesColumn(Row(cab=1, {rng_}), column={int(cols[1])})")
    answers = [[api.query("t", reads)] for api in apis]
    for k in range(6):
        w = f"Set({k + 11}, cab={k % 4}, 2010-0{3 + k % 4}-1{k}T05:00)"
        for api, out in zip(apis, answers):
            before = STK.UPLOAD_STATS["count"]
            api.query("t", w)
            out.append(api.query("t", reads))
            assert STK.UPLOAD_STATS["count"] == before, w
    assert answers[0] == answers[1]


@pytest.mark.parametrize("groups", [1, 7, 40, 300])
@pytest.mark.parametrize("rows", [8, 256])
def test_pair_counts_kernel_fold_shapes(dev, groups, rows):
    """The GroupBy fold's launches: the pruned group planes against a row
    block of the next field, and against the ones row and the signed
    magnitude planes of a Sum aggregate (depth 20: 41 rows)."""
    rng = np.random.default_rng(groups * 31 + rows)
    w = 6 * 32768
    a = words(rng, (groups, w), dev)
    for b in (words(rng, (rows, w), dev), words(rng, (41, w), dev)):
        assert torch.equal(_pair_counts_once(a, b), G.pair_counts_plain(a, b))


def test_fold_and_apply_on_the_card_match_the_cpu(dev, monkeypatch):
    """A 3-field GroupBy (dense over 2 fields is not an option: it folds,
    launching pair_counts per level) and Apply / Arrow over a dataframe,
    on the card and on the CPU alike; Apply's float sums to rel 1e-5."""
    rng = np.random.default_rng(19)
    cols = np.sort(rng.choice(3 << 20, 5000, replace=False))
    rows = {name: rng.integers(0, 5, cols.size) for name in "abc"}
    values = rng.integers(-99, 99, cols.size)
    fare = rng.random(cols.size).astype(np.float32) * 100
    n = rng.integers(0, 9, cols.size)
    apis = [API(), API(device="cpu")]
    for api in apis:
        api.create_index("f")
        for name in "abc":
            api.create_field("f", name)
            api.import_bits("f", name, rows=rows[name], cols=cols)
        api.create_field("f", "v", {"type": "int"})
        api.import_values("f", "v", cols=cols, values=values)
        for s in range(3):
            mine = cols >> 20 == s
            api.import_dataframe("f", s, cols[mine] & ((1 << 20) - 1),
                                 {"fare": fare[mine], "n": n[mine]})
    before = KU.launches()["pair_counts"]
    fold = "GroupBy(Rows(a), Rows(b), Rows(c), aggregate=Sum(field=v))"
    assert apis[0].query("f", fold) == apis[1].query("f", fold)
    assert KU.launches()["pair_counts"] > before + 2
    for q in ('Apply("sum(fare * n)")', 'Apply(Row(a=1), "mean(fare)")',
              'Apply(Row(b=2), "max(fare - n)")', 'Apply("count(n)")'):
        got, want = (api.query("f", q)[0].value for api in apis)
        assert got == pytest.approx(want, rel=1e-5), q
    for q in ('Apply(Row(c=3), "fare * 2")', "Arrow(Row(a=4))"):
        assert apis[0].query("f", q) == apis[1].query("f", q), q


# -- the serving layer on the card: shard masks and fused resolves ----------

#: a union of 8 shards of 4,096 words, and the subsets the masks select
MASK_SHARDS, MASK_WORDS = list(range(8)), 4096


def _mask(dev, subset):
    from pilosa_tpu_torch import platform

    return platform.h2d_copy(
        B.shard_mask_plane(MASK_SHARDS, subset, words=MASK_WORDS), dev)


@pytest.mark.parametrize("subset", [{0}, {1, 3, 5, 7}, {2, 3, 4, 5}, set()])
def test_tape_count_under_a_shard_mask(dev, subset):
    """A masked Count's one launch: the mask plane as the kernel's mask
    operand, and ``plane_intersection_count`` as a one-op tape."""
    rng = np.random.default_rng(len(subset) + 31)
    n = len(MASK_SHARDS) * MASK_WORDS
    a, b = words(rng, (n,), dev), words(rng, (n,), dev)
    mask = _mask(dev, subset)
    before = KU.launches()["tape_count"]
    got = B.tape_count((("and", 0, 1),), [a, b], mask)
    assert int(got) == int(B.tape_count_plain((("and", 0, 1),), [a, b],
                                              mask))
    assert int(B.plane_intersection_count(a, mask)) == int(
        B.plane_intersection_count_plain(a, mask))
    assert KU.launches()["tape_count"] == before + 2


@pytest.mark.parametrize("subset", [{0, 1, 2}, {6}, {1, 3, 5, 7}])
def test_pair_counts_under_a_shard_mask_filter(dev, subset):
    """GroupBy's and TopN's launches with the mask folded into the
    filter (``S.mask_filter``), as a masked wave runs them."""
    rng = np.random.default_rng(len(subset) + 41)
    n = len(MASK_SHARDS) * MASK_WORDS
    a, b = words(rng, (7, n), dev), words(rng, (40, n), dev)
    filt = S.mask_filter(words(rng, (n,), dev), _mask(dev, subset))
    got = G.masked_pair_counts(a, b, filt)
    assert torch.equal(got, G.pair_counts_plain(a & filt[None, :], b))
    assert torch.equal(T.row_counts(b, filt),
                       G.pair_counts_plain(filt[None, :], b)[0])


@pytest.mark.parametrize("subset", [{0, 1}, {2, 5}])
def test_ctile_count_under_a_shard_mask_filter(dev, monkeypatch, subset):
    """A masked TopN over compressed blocks: the mask as the filter."""
    rng = np.random.default_rng(len(subset) + 51)
    width = len(MASK_SHARDS) * MASK_WORDS
    blocks = _compressed_blocks(monkeypatch, rng, 3, width, dev)
    filt = S.mask_filter(None, _mask(dev, subset))
    got = C.ctile_count_blocks(blocks, filt)
    assert torch.equal(got, C.ctile_count_blocks_plain(blocks, filt))


def test_execute_many_resolves_with_one_event_wait(dev, monkeypatch):
    """A fused round of masked Counts, TopNs and a Row copies every result
    to pinned memory and waits on the card once."""
    from pilosa_tpu_torch.pql import executor as EX
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    waits = []
    real = EX._wait_copies
    monkeypatch.setattr(EX, "_wait_copies",
                        lambda ev: (waits.append(ev), real(ev))[1])
    rng = np.random.default_rng(61)
    cols = np.sort(rng.choice(4 * SHARD_WIDTH, 20000, replace=False))
    rows = rng.integers(0, 6, cols.size)
    apis = [API(), API(device="cpu")]
    for api in apis:
        api.create_index("m")
        api.create_field("m", "f")
        api.import_bits("m", "f", rows=rows, cols=cols)
    queries = ["Count(Row(f=1))", "TopN(f, n=3)", "Row(f=2)",
               "Count(Intersect(Row(f=1), Row(f=3)))"]
    subsets = [[0, 1], [1, 2, 3], [3], [0, 2]]
    want = apis[1].executor.execute_many("m", queries,
                                         per_query_shards=subsets)
    waits.clear()  # the CPU's resolve waits on no event
    got = apis[0].executor.execute_many("m", queries,
                                        per_query_shards=subsets)
    assert len(waits) == 1 and isinstance(waits[0], torch.cuda.Event)
    assert got == want
    want = apis[1].query("m", "Count(Row(f=1))TopN(f, n=2)")
    waits.clear()
    assert apis[0].query("m", "Count(Row(f=1))TopN(f, n=2)") == want
    assert len(waits) == 1 and isinstance(waits[0], torch.cuda.Event)


def test_warm_fused_round_over_compressed_leaves_syncs_only_once(dev):
    """A warm fused round of masked Counts over stacks resident
    compressed (the index is sparse): each decoded leaf's row index goes
    to the card without waiting, so the round's one event wait is its
    only sync, and ``set_sync_debug_mode("error")`` raises on any other."""
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    rng = np.random.default_rng(62)
    api = API()
    api.create_index("z")
    api.create_field("z", "city")
    api.create_field("z", "device")
    api.create_field("z", "amt", {"type": "int", "min": -100, "max": 200})
    cols = np.concatenate([s * SHARD_WIDTH + np.sort(
        rng.choice(600, 80, replace=False)) for s in range(4)])
    vals = rng.integers(-60, 120, cols.size)
    api.import_bits("z", "city", rows=cols % 5, cols=cols)
    api.import_bits("z", "device", rows=cols % 3, cols=cols)
    api.import_values("z", "amt", cols=cols, values=vals)
    queries = ["Count(Row(city=1))",
               "Count(Intersect(Row(city=0), Row(device=1)))",
               "Count(Not(Row(city=1)))", "Count(Row(amt > 10))"]
    subsets = [[0, 1], [1, 2, 3], [3], [0, 2]]
    want = api.executor.execute_many("z", queries, per_query_shards=subsets)
    st = STK.stacked_set(api.holder.index("z").field("city"),
                         [0, 1, 2, 3], "standard")
    assert any(isinstance(st._ensure_block(i), C.CompressedBlock)
               for i in range(st.n_blocks))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = api.executor.execute_many("z", queries,
                                        per_query_shards=subsets)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert got == want
    shard = cols // SHARD_WIDTH
    for q, s, (n,) in zip(
            [cols % 5 == 1, (cols % 5 == 0) & (cols % 3 == 1),
             cols % 5 != 1, vals > 10], subsets, got):
        assert n == int(np.sum(q & np.isin(shard, s)))


def test_recovery_on_the_card_matches_before_the_crash(dev, tmp_path):
    """API(path) on the card: imports, an unflushed crash, a reopen; the
    checksum, a Count, a TopN and a Sum equal their values before it."""
    from pilosa_tpu_torch.storage.recovery import abandon_holder

    rng = np.random.default_rng(21)
    api = API(str(tmp_path))
    api.create_index("i")
    api.create_field("i", "f")
    api.create_field("i", "n", {"type": "int"})
    cols = np.arange(40_000)
    api.import_bits("i", "f", rows=rng.integers(0, 16, cols.size),
                    cols=cols + (cols % 2) * (1 << 20))
    api.save()
    api.import_values("i", "n", cols=cols, values=rng.integers(-99, 99,
                                                               cols.size))
    api.query("i", "Set(5, f=3)Clear(6, f=3)")
    queries = ["Count(Intersect(Row(f=3), Row(f=4)))", "TopN(f, n=5)",
               "Sum(Row(n > 0), field=n)"]
    want = [api.query_json("i", q) for q in queries]
    digest = api.checksum()
    api.holder.flush_wals()
    abandon_holder(api.holder)
    again = API(str(tmp_path))
    assert again.checksum() == digest
    assert [again.query_json("i", q) for q in queries] == want
    assert again.holder.index("i").field("f").device.type == "cuda"


def test_checkpoint_loaded_stack_equals_a_rebuild(dev, tmp_path):
    """After release_field_cache, the stacks of a checkpoint-loaded holder
    equal a rebuild from its host planes, bit for bit."""
    rng = np.random.default_rng(22)
    api = API(str(tmp_path))
    api.create_index("i")
    api.create_field("i", "f")
    api.import_bits("i", "f", rows=rng.integers(0, 40, 60_000),
                    cols=rng.integers(0, 3 << 20, 60_000))
    api.save()
    del api
    api = API(str(tmp_path))
    fld = api.holder.index("i").field("f")
    shards = sorted(fld.shards())
    first = STK.stacked_set(fld, shards, "standard")
    dense = first.planes.clone()
    STK.release_field_cache(fld)
    st = STK.stacked_set(fld, shards, "standard")
    assert st is not first
    for bi in range(st.n_blocks):
        host = st._assemble_host(bi)
        got = STK._dense(st._ensure_block(bi)).cpu().numpy().view(np.uint32)
        assert np.array_equal(got, host)
    assert torch.equal(st.planes, dense)


def test_pipelined_load_on_the_card_matches_the_cpu(dev):
    """A chunked stream through the PipelinedIngester and through the
    classic Ingester, on the card and on the CPU: the card's loads launch
    scatter_merge and give the CPU's checksum, and a GroupBy read while
    a second pipelined pass re-applies the stream (the device thread's
    launches beside the reader's) answers as on the CPU."""
    import threading

    from pilosa_tpu_torch.ingest.ingest import Ingester
    from pilosa_tpu_torch.ingest.source import _parse_header
    from pilosa_tpu_torch.stream import (BrokerSource, PipelinedIngester,
                                         StreamBroker, make_chunk)

    rng = np.random.default_rng(17)
    n = 60_000
    city = rng.integers(0, 100, n)
    device = rng.integers(0, 10, n)
    ids = np.arange(n) * 30  # two shards
    broker = StreamBroker(partitions=1, seed=17)
    for lo in range(0, n, 4096):
        broker.produce("s", make_chunk({"id": ids[lo:lo + 4096],
                                        "city": city[lo:lo + 4096],
                                        "device": device[lo:lo + 4096]}))
    schema = _parse_header(["city__IS", "device__IS"])
    q = "GroupBy(Rows(city), Rows(device), limit=100)"
    out = {}
    for name, make in (("cpu", lambda: API(device="cpu")), ("cuda", API)):
        before = KU.launches()["scatter_merge"]
        piped = make()
        p = PipelinedIngester(piped, "s", broker.consumer(f"p{name}", ["s"]),
                              schema=schema, batch_rows=2)
        assert p.run() == n
        classic = make()
        Ingester(classic, "s", BrokerSource(
            broker.consumer(f"c{name}", ["s"]), schema)).run()
        launched = KU.launches()["scatter_merge"] - before
        answer = piped.query_json("s", q)
        digest = piped.checksum()
        churn = PipelinedIngester(piped, "s",
                                  broker.consumer(f"r{name}", ["s"]),
                                  schema=schema, batch_rows=1,
                                  group=f"r{name}")
        th = threading.Thread(target=churn.run)
        th.start()
        during, deadline = [], time.monotonic() + 120
        while len(during) < 5 or (th.is_alive()  # reads for the whole pass
                                  and time.monotonic() < deadline):
            during.append(piped.query_json("s", q))
        th.join(120)
        assert not th.is_alive() and churn.rows == n
        assert during == [answer] * len(during)
        assert piped.checksum() == digest
        out[name] = (digest, classic.checksum(), answer, launched)
        assert piped.holder.index("s").field("city").device.type == name
    assert out["cuda"][0] == out["cuda"][1] == out["cpu"][0] == out["cpu"][1]
    assert out["cuda"][2] == out["cpu"][2]
    assert out["cuda"][3] > 0 and out["cpu"][3] == 0


def test_ssb_sql_on_the_card_matches_the_oracle(dev):
    """SSB ``small`` (6,000 lineorder rows) through ``API.sql`` on the
    card: the 13 queries equal the port's oracle on the semi-join plane
    and the hash fallback, and the load and the queries launched
    scatter_merge, bsi_compare and pair_counts."""
    import os

    from pilosa_tpu_torch.loadgen import ssb

    data = ssb.generate("small", seed=7)
    api = API()
    before = KU.launches()
    ssb.load(api.sql, data)
    for semijoin in ("1", "0"):
        os.environ["PILOSA_TPU_SEMIJOIN"] = semijoin
        try:
            for qid, q in ssb.QUERIES.items():
                assert ssb.verify(data, qid, api.sql(q).data) is None, \
                    (qid, semijoin)
        finally:
            del os.environ["PILOSA_TPU_SEMIJOIN"]
    assert api.sql("SELECT SUM(lo_revenue) FROM lineorder "
                   "WHERE lo_discount = 3").data == [[int(
                       data.lineorder["lo_revenue"][
                           data.lineorder["lo_discount"] == 3].sum())]]
    after = KU.launches()
    for k in ("scatter_merge", "bsi_compare", "pair_counts"):
        assert after[k] > before[k], k


# -- the device profiler's timing on the card (obs/devprof.py) ---------------


@pytest.fixture
def prof(dev, monkeypatch):
    from pilosa_tpu_torch.obs import devprof

    monkeypatch.setenv("PILOSA_TPU_COMPRESS", "1")  # ctile_count's block
    was = devprof.ENABLED
    devprof.disable()
    devprof.reset()
    yield devprof
    devprof.reset()
    devprof.enable() if was else devprof.disable()


def _five_launches(dev):
    """One launch of each kernel through its wrapper."""
    rng = np.random.default_rng(14)
    x, y = words(rng, (1 << 16,), dev), words(rng, (1 << 16,), dev)
    B.tape_count((("and", 0, 1),), [x, y])
    G.pair_counts(words(rng, (2, 4096), dev), words(rng, (20, 4096), dev))
    S.bsi_compare(words(rng, (22, 4096), dev), S.GT, 1000)
    host = np.zeros((16, 4096), dtype=np.uint32)
    host[3, :700] = rng.integers(0, 1 << 32, 700, dtype=np.uint32)
    C.ctile_count_blocks([C.maybe_compress(host, dev)])
    flat = torch.zeros(4096, dtype=torch.int32, device=dev)
    addr = torch.arange(0, 4096, 4, dtype=torch.int32, device=dev)
    SC.scatter_merge_(flat, addr, torch.ones_like(addr))


def test_devprof_off_creates_no_event(prof, dev, monkeypatch):
    made = []
    real = torch.cuda.Event

    def counting(*a, **k):
        made.append(1)
        return real(*a, **k)

    monkeypatch.setattr(torch.cuda, "Event", counting)
    created, evals = prof.EVENTS_CREATED, prof.cost_evals()
    _five_launches(dev)
    torch.cuda.synchronize()
    assert made == [] and prof.EVENTS_CREATED == created
    assert prof.cost_evals() == evals and prof.KERNELS.profile_count() == 0


def test_devprof_events_drain_with_device_time(prof, dev):
    prof.enable()
    created = prof.EVENTS_CREATED
    _five_launches(dev)
    assert prof.EVENTS_CREATED == created  # a kernel reads its own clock
    rows = prof.KERNELS.snapshot()  # waits for the pending launches
    assert not prof._PENDING
    ops = {r["family"].split("/")[2].split("#")[0] for r in rows}
    assert ops == {"mm1", "cmp1", "pop1", "scatter1"}, rows
    assert prof.KERNELS.other_dispatches == 1  # tape_count, no tape scope
    for r in rows:
        assert r["dispatches"] == 1 and r["device_seconds"] > 0, r
        assert r["us_per_dispatch"] < 1e4, r
    assert prof.stats_json()["device"]["name"] == \
        torch.cuda.get_device_name(0)


def test_devprof_pool_reuses_event_pairs(prof, dev):
    prof.enable()
    rng = np.random.default_rng(3)
    x = words(rng, (1 << 12,), dev)
    for _ in range(50):
        B.tape_count((("or", 0, 0),), [x])
    prof.drain(block=True)
    pool = prof._FREE[(prof._Clock, dev.index)]
    made, kept = prof.EVENTS_CREATED, len(pool)
    for _ in range(50):
        B.tape_count((("or", 0, 0),), [x])
    prof.drain(block=True)
    assert len(pool) - kept <= 8  # clock slots come back to the pool
    assert prof.EVENTS_CREATED == made
    assert prof.KERNELS.other_dispatches == 100


def test_devprof_full_pending_list_waits_for_its_oldest(prof, dev,
                                                          monkeypatch):
    """Past MAX_PENDING a launch waits for the oldest and folds it in:
    no slot leaves the list while its kernel may still write to it, and
    every launch is counted with its clock."""
    monkeypatch.setattr(prof, "MAX_PENDING", 2)
    rng = np.random.default_rng(5)
    x, y = words(rng, (1 << 16,), dev), words(rng, (1 << 16,), dev)
    want = B.tape_count_plain((("and", 0, 1),), [x.cpu(), y.cpu()])
    spin = int(2e-3 * torch.cuda.get_device_properties(0).clock_rate * 1e3)
    prof.enable()
    got = []
    torch.cuda._sleep(spin)  # the launches queue up behind it
    for _ in range(40):
        got.append(B.tape_count((("and", 0, 1),), [x, y]))
        assert len(prof._PENDING) <= 2
    prof.drain(block=True)
    assert all(int(g) == int(want) for g in got)
    assert prof.KERNELS.other_dispatches == 40
    assert 0 < prof.KERNELS.other_device_s < 40 * 1e-3


def test_devprof_on_keeps_results(prof, dev):
    api = API()
    api.create_index("i")
    api.create_field("i", "f")
    api.create_field("i", "g")
    rng = np.random.default_rng(16)
    cols = np.arange(80_000)
    api.import_bits("i", "f", rows=rng.integers(0, 32, cols.size).tolist(),
                    cols=cols.tolist())
    api.import_bits("i", "g", rows=rng.integers(0, 16, cols.size).tolist(),
                    cols=cols.tolist())
    qs = ["Count(Row(f=3))", "Count(Intersect(Row(f=1), Row(g=1)))",
          "Intersect(Row(f=1), Row(g=2))", "TopN(f, n=4)"]
    off = [api.query_json("i", q) for q in qs]
    prof.enable()
    on = [api.query_json("i", q) for q in qs]
    assert on == off
    kinds = {r["family"].split("/")[0] for r in prof.KERNELS.snapshot()}
    assert {"count", "plane"} <= kinds


def test_server_on_the_card_answers_as_on_the_cpu(dev):
    """The port's HTTP server over ``API()`` on ``cuda:0`` and over
    ``API(device="cpu")``: the same imports and reads over HTTP, from 8
    concurrent clients on the card, give equal answers; the card's
    server launches ``tape_count``, ``pair_counts``, ``bsi_compare`` and
    ``scatter_merge``."""
    import base64
    import json
    import threading
    import urllib.request

    from pilosa_tpu_torch.server import serve
    from pilosa_tpu_torch.storage.roaring import encode_positions

    def call(base, path, body):
        r = urllib.request.Request(base + path, method="POST",
                                   data=body if isinstance(body, bytes)
                                   else json.dumps(body).encode())
        r.add_header("Content-Type", "text/plain" if isinstance(body, bytes)
                     else "application/json")
        with urllib.request.urlopen(r) as resp:
            return json.loads(resp.read())

    rng = np.random.default_rng(15)
    cols = rng.choice(2 << 20, 50_000, replace=False)
    city = rng.integers(0, 40, cols.size)
    amount = rng.integers(0, 1 << 20, cols.size)
    queries = [b"Count(Row(city=3))", b"TopN(city, n=5)",
               b"GroupBy(Rows(city), Rows(dev), limit=20)",
               b"Count(Intersect(Row(city=1), Row(dev=2)))",
               b"Sum(Row(amount > 524288), field=amount)",
               b"Count(Row(amount < 1000))"]
    answers, launched = [], None
    for device in (dev, "cpu"):
        KU.reset_launches()
        api = API(device=device)
        srv, _ = serve(api, port=0, background=True)
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        try:
            call(base, "/index/c", {})
            for f, o in (("city", {}), ("dev", {}),
                         ("amount", {"type": "int"})):
                call(base, f"/index/c/field/{f}", {"options": o})
            for shard in (0, 1):
                sel = cols >> 20 == shard
                blob = encode_positions(np.sort(
                    (city[sel].astype(np.uint64) << np.uint64(20))
                    | (cols[sel] & ((1 << 20) - 1)).astype(np.uint64)))
                call(base, f"/index/c/shard/{shard}/import-roaring",
                     {"field": "city",
                      "views": {"": base64.b64encode(blob).decode()}})
            call(base, "/index/c/import",
                 {"field": "dev", "rows": (cols % 7).tolist(),
                  "cols": cols.tolist()})
            call(base, "/index/c/import-values",
                 {"field": "amount", "cols": cols.tolist(),
                  "values": amount.tolist()})
            serial = [call(base, "/index/c/query", q) for q in queries]
            call(base, "/index/c/query", b"Set(7, dev=6)Set(9, city=39)")
            serial += [call(base, "/index/c/query", q) for q in queries]
            got, errors = [], []

            def client(k):
                try:
                    for q in queries[k % 3:] + queries[:k % 3]:
                        got.append((q, call(base, "/index/c/query", q)))
                except Exception as e:  # noqa: BLE001 - reported below
                    errors.append(e)

            threads = [threading.Thread(target=client, args=(k,))
                       for k in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not errors and len(got) == 8 * len(queries)
            warm = dict(zip(queries, serial[len(queries):]))
            assert all(a == warm[q] for q, a in got)
        finally:
            srv.shutdown()
            srv.server_close()
        answers.append(serial)
        if launched is None:
            torch.cuda.synchronize()
            launched = KU.launches()
    assert answers[0] == answers[1]
    for name in ("tape_count", "pair_counts", "bsi_compare",
                 "scatter_merge"):
        assert launched[name] > 0, name


# -- the mesh reduces (parallel/mesh.py) on the card ---------------------------


@pytest.mark.parametrize("w, cp", [(512, 1), (512, 2), (512, 4), (32768, 2)])
def test_mesh_reduces_at_block_widths(dev, w, cp):
    """The five reduces over 8 virtual devices on the card at blocks of
    w / cp words, against numpy, with one launch per block and kernel."""
    from pilosa_tpu_torch.parallel import ShardPlacement, analytics_mesh

    rng = np.random.default_rng(w + cp)
    n_s = 8
    raw = rng.random((n_s, 6, w * 32)) < 0.3
    planes = np.packbits(raw, axis=-1, bitorder="little").view("<u4")
    pl = ShardPlacement(analytics_mesh([dev] * 8, col_parallel=cp))
    blocks = 8

    def launched(fn, want):
        before = KU.launches()
        got = fn()
        after = KU.launches()
        assert {k: after[k] - before[k] for k in after
                if after[k] != before[k]} == want
        return got

    p0, p1 = pl.place(planes[:, 0]), pl.place(planes[:, 1])
    assert launched(lambda: pl.count(p0), {"tape_count": blocks}) == \
        int(raw[:, 0].sum())
    assert launched(lambda: pl.intersect_count(p0, p1),
                    {"tape_count": blocks}) == \
        int((raw[:, 0] & raw[:, 1]).sum())
    pr = pl.place(planes)
    got = launched(lambda: pl.row_counts(pr), {"pair_counts": blocks})
    np.testing.assert_array_equal(got, raw.sum(axis=(0, 2)))
    pa, pb = pl.place(planes[:, :2]), pl.place(planes[:, 2:])
    got = launched(lambda: pl.groupby_counts(pa, pb),
                   {"pair_counts": blocks})
    np.testing.assert_array_equal(got, np.einsum(
        "sgw,srw->gr", raw[:, :2].astype(np.int64),
        raw[:, 2:].astype(np.int64)))
    cols = np.arange(w * 32)
    vals = rng.integers(-5000, 5000, (n_s, cols.size))
    keep = rng.random((n_s, cols.size)) < 0.5
    bsi = np.stack([S.encode_values(cols, v, 14, w) for v in vals])
    filt = np.packbits(keep, axis=-1, bitorder="little").view("<u4")
    c, per = launched(
        lambda: pl.bsi_sum_counts(pl.place(bsi), pl.place(filt)),
        {"pair_counts": blocks, "tape_count": blocks})
    assert (c, sum(int(per[k]) << k for k in range(14))) == \
        (int(keep.sum()), int(vals[keep].sum()))
