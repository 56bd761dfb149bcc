"""BASELINE.json config 1, scaled down, end to end against the JAX package,
on the CPU.

``bench.py`` ``bench_config1`` imports 1,000,000 records (seed 1) into set
fields ``city`` (1000 rows) and ``device`` (10 rows) and counts
``Intersect(Row(city=7), Row(device=3))``. Here 40,000 records over 50
cities and 10 devices go through ``pilosa_tpu.api.API`` and
``pilosa_tpu_torch.api.API(device="cpu")`` by ``import_bits`` in batches
of 8,192 (each call also marks ``_exists``), as the JAX package's
ingester imports a batch. The host planes of ``city``, ``device`` and
``_exists``, every call's changed count and the Counts of ten pairs must
be identical, and the Counts equal numpy's (tolerance 0: bitmaps and
integers). ``chip_smoke.py`` path 5 runs the same import at full size on
a card.
"""

import numpy as np
import pytest

from pilosa_tpu.api import API as JaxAPI
from pilosa_tpu_torch.api import API as TorchAPI
from pilosa_tpu_torch.ops import scatter as SC

RECORDS, CITIES, DEVICES, BATCH = 40_000, 50, 10, 8192
PAIRS = [(7, 3), (0, 0), (49, 9), (25, 5), (12, 1), (3, 8), (30, 2),
         (44, 7), (18, 4), (9, 6)]


def _data():
    rng = np.random.default_rng(1)
    return rng.integers(0, CITIES, RECORDS), rng.integers(0, DEVICES, RECORDS)


def _import(api, city, device):
    api.create_index("taxi")
    api.create_field("taxi", "city")
    api.create_field("taxi", "device")
    changed = []
    for lo in range(0, RECORDS, BATCH):
        ids = np.arange(lo, min(lo + BATCH, RECORDS), dtype=np.int64)
        for name, rows in (("city", city), ("device", device)):
            changed.append(int(api.import_bits(
                "taxi", name, rows=rows[lo:lo + BATCH], cols=ids)))
    return changed


def _rows(api, field):
    frag = api.holder.index("taxi").field(field).fragment(0)
    return {r: frag.planes[s] for r, s in frag.row_index.items()}


@pytest.fixture(scope="module", params=[8, 32, 512])
def imported(request):
    city, device = _data()
    keep = SC.TILE_WORDS
    SC.TILE_WORDS = request.param
    try:
        ours = TorchAPI(device="cpu")
        got = _import(ours, city, device)
    finally:
        SC.TILE_WORDS = keep
    theirs = JaxAPI()
    want = _import(theirs, city, device)
    return city, device, ours, theirs, got, want


def test_changed_counts_match(imported):
    city, device, _, _, got, want = imported
    assert got == want
    assert sum(got) == 2 * RECORDS  # each record sets one bit per field


@pytest.mark.parametrize("field", ["city", "device", "_exists"])
def test_host_planes_match(imported, field):
    _, _, ours, theirs, _, _ = imported
    a, b = _rows(ours, field), _rows(theirs, field)
    assert a.keys() == b.keys()
    for r in a:
        np.testing.assert_array_equal(a[r], b[r])


def test_intersect_counts_match_numpy(imported):
    city, device, ours, theirs, _, _ = imported
    for c, d in PAIRS:
        q = f"Count(Intersect(Row(city={c}), Row(device={d})))"
        want = int(((city == c) & (device == d)).sum())
        assert ours.query("taxi", q) == theirs.query("taxi", q) == [want], q


def test_reimport_changes_nothing(imported):
    """The same batches again: every call counts 0 in both packages."""
    city, device, ours, theirs, _, _ = imported
    cols = np.arange(BATCH, dtype=np.int64)
    for api in (ours, theirs):
        for name, rows in (("city", city), ("device", device)):
            assert api.import_bits("taxi", name, rows=rows[:BATCH],
                                   cols=cols) == 0
