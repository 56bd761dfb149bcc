"""Device-layer notes of both packages: the lock tracer hearing of every
dispatch, Apply's uploads traced as ``device.h2d_copy``, and the
re-export of the placement hashes (``cluster/hash.py``).

Every test runs once per package through a ``P`` fixture, on the CPU
(the port with ``device="cpu"``, where a dispatch is a plain version
passing ``kernel_util.on_card``). Tolerance 0.
"""

import importlib
import types

import numpy as np
import pytest

SHARD_WIDTH = 1 << 20


def _load(root: str) -> types.SimpleNamespace:
    m = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    api_mod = m("api")
    kw = {"device": "cpu"} if root == "pilosa_tpu_torch" else {}
    return types.SimpleNamespace(
        root=root, API=lambda: api_mod.API(**kw), T=m("obs.tracing"),
        locktrace=m("analysis.locktrace"), hash=m("cluster.hash"),
        hashing=m("hashing"))


_PACKAGES = {}


def _pkg(root):
    if root not in _PACKAGES:
        _PACKAGES[root] = _load(root)
    return _PACKAGES[root]


@pytest.fixture(params=["pilosa_tpu", "pilosa_tpu_torch"],
                ids=["jax", "torch"])
def P(request):
    return _pkg(request.param)


# -- dispatch notes -----------------------------------------------------------


def _warm_count_api(P):
    api = P.API()
    api.create_index("d")
    api.create_field("d", "f")
    api.import_bits("d", "f", rows=[1, 1, 2], cols=[1, 2, SHARD_WIDTH])
    assert api.query("d", "Count(Row(f=1))") == [2]  # builds the stacks
    return api


def _count_under(P, monkeypatch, **lock_kw):
    api = _warm_count_api(P)
    lt = P.locktrace
    reg = lt.LockTraceRegistry()
    monkeypatch.setattr(lt, "ACTIVE", reg)
    lock = lt._TrackedLock("test.outer", reg, **lock_kw)
    with lock:
        assert api.query("d", "Count(Row(f=1))") == [2]
        assert api.query("d", "Count(Row(f=1))") == [2]  # dedups
    return reg.violations(kind=lt.KIND_DISPATCH)


def test_lock_held_across_a_count_records_one_dispatch(P, monkeypatch):
    vs = _count_under(P, monkeypatch)
    assert len(vs) == 1, vs
    assert vs[0]["locks"] == ["test.outer"]


def test_dispatch_ok_lock_records_none(P, monkeypatch):
    assert _count_under(P, monkeypatch, dispatch_ok=True) == []


def test_upload_notes_a_dispatch(P, monkeypatch):
    """A cold read's stack upload is a dispatch too (``h2d_copy``)."""
    lt = P.locktrace
    api = P.API()
    api.create_index("d")
    api.create_field("d", "f")
    api.import_bits("d", "f", rows=[1], cols=[1])
    reg = lt.LockTraceRegistry()
    monkeypatch.setattr(lt, "ACTIVE", reg)
    with lt._TrackedLock("test.outer", reg):
        assert api.query("d", "Count(Row(f=1))") == [1]
    sites = {v["site"] for v in reg.violations(kind=lt.KIND_DISPATCH)}
    assert "platform.h2d_copy" in sites


# -- Apply's uploads ---------------------------------------------------------


def _h2d_spans(doc, acc=None):
    acc = [] if acc is None else acc
    if doc.get("name") == "device.h2d_copy":
        acc.append(doc.get("tags", {}).get("nbytes"))
    for c in doc.get("children", ()):
        _h2d_spans(c, acc)
    return acc


def _traced_h2d(P, api, q):
    prev = P.T.set_tracer(P.T.Tracer(enabled=True, sample_rate=1.0,
                                     store=P.T.TraceStore(8)))
    try:
        with P.T.get_tracer().start_trace("apply") as root:
            out = api.query_json("t", q)
        return out, _h2d_spans(root.to_json())
    finally:
        P.T.set_tracer(prev)


def _apply_api(P):
    api = P.API()
    api.create_index("t")
    for s, n in ((0, 100), (1, 300)):
        ids = list(range(0, 3 * n, 3))
        api.import_dataframe("t", s, ids,
                             {"fare": [float(i % 17) for i in ids],
                              "dist": [int(i % 5) for i in ids]})
    return api


def test_apply_uploads_are_traced(P):
    """A cold Apply stages its columns and the valid mask through
    ``platform.h2d_copy``; a warm one stages nothing."""
    api = _apply_api(P)
    q = 'Apply("sum(fare + dist)")'
    out, cold = _traced_h2d(P, api, q)
    cap, shards = 1024, 2  # pow2 of the longest frame (898 rows)
    assert sorted(cold) == sorted([shards * cap * 4] * 2 + [shards * cap])
    again, warm = _traced_h2d(P, api, q)
    assert warm == [] and again == out


def test_apply_upload_spans_match_across_packages():
    got = [_traced_h2d(_pkg(r), _apply_api(_pkg(r)), 'Apply("count(dist)")')
           for r in ("pilosa_tpu", "pilosa_tpu_torch")]
    assert got[0] == got[1]


# -- cluster/hash.py ---------------------------------------------------------

_HASH_NAMES = ("DEFAULT_PARTITION_N", "fnv64a", "jump_hash",
               "key_to_partition", "shard_to_partition")


@pytest.mark.parametrize("name", _HASH_NAMES)
def test_cluster_hash_reexports(P, name):
    assert getattr(P.hash, name) is getattr(P.hashing, name)


def test_cluster_hash_matches_across_packages():
    J, T = _pkg("pilosa_tpu").hash, _pkg("pilosa_tpu_torch").hash
    assert J.DEFAULT_PARTITION_N == T.DEFAULT_PARTITION_N
    rng = np.random.default_rng(11)
    keys = ["", "a", "brand-17", "ключ"] + [f"k{i}" for i in range(20)]
    for key in keys:
        assert T.fnv64a(key.encode()) == J.fnv64a(key.encode())
        assert T.key_to_partition("i", key) == J.key_to_partition("i", key)
    for shard in rng.integers(0, 1 << 20, 50).tolist():
        assert T.shard_to_partition("i", shard) == \
            J.shard_to_partition("i", shard)
        for n in (1, 3, 7):
            assert T.jump_hash(shard, n) == J.jump_hash(shard, n)
