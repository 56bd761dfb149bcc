"""The port's CUDA kernels against their plain PyTorch versions, on a card.

The kernels have no CPU mode, so every test here needs an NVIDIA GPU and
skips without one. This file imports neither JAX nor the JAX package, so
it also runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest`` because tests/conftest.py pins JAX to the CPU.)
Tolerance 0: every result is an integer or a bitmap.
"""

import numpy as np
import pytest
import torch

from pilosa_tpu_torch.api import API
from pilosa_tpu_torch.ops import bitmap as B
from pilosa_tpu_torch.ops import groupby as G
from pilosa_tpu_torch.ops import kernel_util as KU
from pilosa_tpu_torch.ops import scatter as SC

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def words(rng, shape, device):
    host = rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)
    return torch.from_numpy(host.view(np.int32)).to(device)


@pytest.mark.parametrize("r1,r2,w", [(1, 1, 1), (3, 5, 7), (37, 37, 512),
                                     (8, 256, 512), (1, 300, 1000),
                                     (130, 300, 1000)])
def test_pair_counts_kernel(dev, r1, r2, w):
    rng = np.random.default_rng(r1 * 1000 + r2)
    a, b = words(rng, (r1, w), dev), words(rng, (r2, w), dev)
    before = KU.launches()["pair_counts"]
    assert torch.equal(G.pair_counts(a, b), G.pair_counts_plain(a, b))
    assert KU.launches()["pair_counts"] == before + 1


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
