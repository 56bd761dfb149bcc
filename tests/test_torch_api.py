"""The API's read, schema and residency calls, held against the JAX
package's.

* ``result_to_json`` / ``result_to_wire`` / ``result_from_wire`` for
  every result type: the port's encoding equals the JAX package's, and
  each decodes the other's;
* ``schema``, ``info`` keys, ``delete_index`` / ``delete_field``,
  ``prewarm`` and ``residency_stats``, ``program_cache_len`` and the
  span names of ``query_json(profile=True)``, once per package (the
  ``P`` fixture);
* ``bench.py`` configs 13 and 12 at a small size over both packages:
  the port's cold and warm answers equal the JAX package's classic path
  (``programs.ENABLED = False`` on the JAX side only); every cold trace
  holds ``stack.build`` and ``device.h2d_copy`` and no warm trace holds
  either; tracing off allocates no span, always-on stores traces, and
  the answers are the same in all four tracing modes;
* ``tests/test_core.py``'s ``TestParanoia`` over both packages, and the
  port reading ``PILOSA_TPU_PARANOIA`` at import.

Tolerance is exact throughout.
"""

import importlib
import os
import random
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHARD_WIDTH = 1 << 20
CPU = torch.device("cpu")


def _load(root: str) -> types.SimpleNamespace:
    m = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    api_mod = m("api")
    kw = {"device": "cpu"} if root == "pilosa_tpu_torch" else {}

    def make_api(path=None, **more):
        return api_mod.API(path, **more, **kw)

    return types.SimpleNamespace(
        root=root, API=make_api, R=m("pql.result"), T=m("obs.tracing"),
        programs=m("pql.programs"), stacked=m("core.stacked"),
        fragment=m("core.fragment"), bsi=m("ops.bsi"))


_PACKAGES = {}


def _pkg(root: str) -> types.SimpleNamespace:
    if root not in _PACKAGES:
        _PACKAGES[root] = _load(root)
    return _PACKAGES[root]


@pytest.fixture(params=["pilosa_tpu", "pilosa_tpu_torch"],
                ids=["jax", "torch"])
def P(request):
    return _pkg(request.param)


# -- result codecs -------------------------------------------------------------


def _results(R):
    """One value of every result type, built from the module ``R``."""
    return [
        None, True, 7,
        R.RowResult(columns=[1, 5, SHARD_WIDTH + 2]),
        R.RowResult(columns=[1], keys=["a"]),
        R.ValCount(val=42, count=3), R.ValCount(val=1.25, count=1),
        R.ValCount(),
        R.PairsField(field="f", pairs=[R.Pair(id=3, key=None, count=9),
                                       R.Pair(id=None, key="k", count=2)]),
        [R.GroupCount(group=[R.FieldRow(field="a", row_id=1),
                             R.FieldRow(field="b", row_key="x"),
                             R.FieldRow(field="v", value=-4)],
                      count=5, agg=11),
         R.GroupCount(group=[R.FieldRow(field="a", row_id=2)], count=1)],
        [1, 4, 9],
        R.ExtractedTable(
            fields=[R.ExtractedField(name="f", type="set")],
            columns=[R.ExtractedColumn(column=3, key=None, rows=[[1, 2]]),
                     R.ExtractedColumn(column=4, key="c", rows=[[]])]),
        R.SortedRow(columns=[4, 2], values=[9, 3]),
        R.SortedRow(columns=[4], values=[9], keys=["d"]),
        R.ApplyResult(value=2.5), R.ApplyResult(value=[1.0, 2.0]),
        R.ArrowTable(fields=[R.ExtractedField(name="fare", type="float64")],
                     columns=[[1.5, 2.5]], ids=[1, 2]),
    ]


@pytest.mark.parametrize("i", range(17))
def test_result_codecs_match_the_jax_package(i):
    ours, theirs = _pkg("pilosa_tpu_torch").R, _pkg("pilosa_tpu").R
    a, b = _results(ours)[i], _results(theirs)[i]
    assert ours.result_to_json(a) == theirs.result_to_json(b)
    wire = ours.result_to_wire(a)
    assert wire == theirs.result_to_wire(b)
    back = ours.result_from_wire(theirs.result_to_wire(b))
    assert ours.result_to_json(back) == ours.result_to_json(a)
    assert theirs.result_to_json(theirs.result_from_wire(wire)) \
        == theirs.result_to_json(b)


def test_result_codec_rejects_unknown_types(P):
    with pytest.raises(TypeError):
        P.R.result_to_wire(object())
    with pytest.raises(ValueError):
        P.R.result_from_wire({"type": "nope"})


# -- schema, info, deletes, residency -----------------------------------------


def _small(P, path=None):
    api = P.API(path)
    api.create_index("i", {"keys": False})
    api.create_field("i", "f")
    api.create_field("i", "n", {"type": "int", "min": -10, "max": 100})
    api.create_field("i", "t", {"type": "time", "timeQuantum": "YM",
                                "ttl": 30})
    api.import_bits("i", "f", rows=[1, 2, 2], cols=[1, 2, SHARD_WIDTH])
    api.import_values("i", "n", cols=[1, 2], values=[5, -3])
    return api


class TestSchemaCalls:
    def test_schema_matches_the_jax_package(self):
        ours = _small(_pkg("pilosa_tpu_torch")).schema()
        assert ours == _small(_pkg("pilosa_tpu")).schema()
        assert [f["name"] for f in ours[0]["fields"]] == ["f", "n", "t"]
        assert ours[0]["shardWidth"] == SHARD_WIDTH
        assert ours[0]["fields"][2]["options"]["ttl_seconds"] == 30

    def test_info_keys(self, P):
        info = _small(P).info()
        assert set(info) == {"shardWidth", "devices", "indexes"}
        assert info["indexes"] == ["i"] and info["devices"]

    def test_delete_field_and_index(self, P, tmp_path):
        api = _small(P, str(tmp_path))
        api.delete_field("i", "n")
        assert [f["name"] for f in api.schema()[0]["fields"]] == ["f", "t"]
        with pytest.raises(ValueError):
            api.delete_field("i", "_exists")
        api.delete_index("i")
        assert api.schema() == []
        assert not os.path.isdir(os.path.join(str(tmp_path), "indexes", "i"))
        del api
        assert P.API(str(tmp_path)).schema() == []

    def test_max_column_and_public_fields(self, P):
        idx = _small(P).holder.index("i")
        assert idx.max_column() == 2 * SHARD_WIDTH
        assert [f.name for f in idx.public_fields()] == ["f", "n", "t"]

    def test_prewarm_and_residency_stats(self, P):
        api = _small(P)
        stats0 = api.holder.residency_stats()
        assert set(stats0) == {"resident_bytes", "budget_bytes",
                               "evictions", "block_builds", "stale_retries"}
        got = api.holder.prewarm("i")
        assert got == {"set_stacks": 2, "bsi_stacks": 1}  # f, _exists; n
        stats = api.holder.residency_stats()
        assert stats["block_builds"] - stats0["block_builds"] == 2
        assert stats["resident_bytes"] > stats0["resident_bytes"]
        assert api.holder.prewarm() == got  # every index
        api.delete_index("i")  # gives its stacks back to the budget
        assert P.stacked.BUDGET.used == stats0["resident_bytes"]

    def test_program_cache_len(self, P):
        api = _small(P)
        api.query("i", "Count(Intersect(Row(f=1), Row(f=2)))")
        api.query("i", "Count(Union(Row(f=1), Row(f=2), Row(f=3)))")
        assert P.programs.program_cache_len() >= 1


def _span_names(doc, acc=None):
    acc = [] if acc is None else acc
    acc.append(doc.get("name", ""))
    for c in doc.get("children", ()):
        _span_names(c, acc)
    return acc


def test_query_json_profile_span_names(P):
    api = _small(P)
    out = api.query_json("i", "Count(Row(f=2))", profile=True)
    assert out["results"] == [2]
    names = _span_names(out["profile"])
    assert names[0] == "query.profile" and "query.pql" in names
    assert "stack.build" in names and "device.h2d_copy" in names
    out = api.query_json("i", "Count(Row(f=2))", profile=True)
    names = _span_names(out["profile"])  # warm: nothing staged
    assert "stack.build" not in names and "device.h2d_copy" not in names
    w = api.query_json("i", "Set(9, f=2)", profile=True)
    assert w["results"] == [True]
    assert api.query_json("i", "Row(f=2)") == {
        "results": [{"columns": [2, 9, SHARD_WIDTH]}]}


# -- bench.py configs 13 and 12, small -----------------------------------------

_C13_QUERIES = [
    "Count(Row(f=3))",
    "Count(Intersect(Row(f=1), Row(g=1)))",
    "Count(Union(Row(f=2), Row(g=3), Row(f=5)))",
    "Count(Difference(Row(f=4), Row(g=0)))",
    "Count(Not(Row(f=6)))",
    "Count(Intersect(Row(v > 0), Row(g=2)))",
    "Intersect(Row(f=1), Row(g=1))",
]


def _config13(P, per_shard=3000, values=400):
    """bench.py config 13 as it builds it, at a small size."""
    rng = np.random.default_rng(13)
    api = P.API()
    api.create_index("c13")
    api.create_field("c13", "f")
    api.create_field("c13", "g")
    api.create_field("c13", "v", {"type": "int"})
    for shard in range(2):
        cols = shard * SHARD_WIDTH + np.arange(per_shard)
        api.import_bits("c13", "f", rows=rng.integers(0, 64, per_shard),
                        cols=cols)
        api.import_bits("c13", "g", rows=rng.integers(0, 32, per_shard),
                        cols=cols)
        api.holder.index("c13").field("v").set_values(
            cols[:values].tolist(),
            rng.integers(-50, 50, values).tolist())
    return api


def _release(P, api, index):
    for fld in api.holder.index(index).fields.values():
        P.stacked.release_field_cache(fld)


def _traced(P, api, index, q):
    prev = P.T.set_tracer(P.T.Tracer(enabled=True, sample_rate=1.0,
                                     store=P.T.TraceStore(8)))
    try:
        with P.T.get_tracer().start_trace("q13") as root:
            out = api.query_json(index, q)
        return out, _span_names(root.to_json())
    finally:
        P.T.set_tracer(prev)


@pytest.fixture(scope="module")
def c13_oracle():
    """The JAX package's classic per-op path on fresh stacks."""
    J = _pkg("pilosa_tpu")
    api = _config13(J)
    J.programs.ENABLED = False
    try:
        _release(J, api, "c13")
        return [api.query_json("c13", q) for q in _C13_QUERIES]
    finally:
        J.programs.ENABLED = True
        _release(J, api, "c13")


def test_config13_cold_and_warm(P, c13_oracle):
    api = _config13(P)
    cold = []
    for q in _C13_QUERIES:
        _release(P, api, "c13")
        out, names = _traced(P, api, "c13", q)
        assert "stack.build" in names and "device.h2d_copy" in names, q
        cold.append(out)
    assert cold == c13_oracle
    built = api.holder.prewarm("c13")
    assert built == {"set_stacks": 3, "bsi_stacks": 1}
    stats = api.holder.residency_stats()
    for q, want in zip(_C13_QUERIES, c13_oracle):
        out, names = _traced(P, api, "c13", q)
        assert out == want, q
        assert "stack.build" not in names, f"warm query rebuilt: {q}"
        assert "device.h2d_copy" not in names, f"warm query staged: {q}"
    assert api.holder.residency_stats()["block_builds"] \
        == stats["block_builds"]
    assert P.programs.program_cache_len() >= 1
    _release(P, api, "c13")


#: bench.py's config 12 reads Row(g=2) of a field g it never creates (a
#: KeyError in both packages); its one set field f stands in
_C12_QUERIES = ["Count(Row(f=3))", "Intersect(Row(f=1), Row(f=2))",
                "TopN(f, n=4)"]


def test_config12_tracing_modes(P):
    """bench.py config 12 at a small size: the answers are the same
    untraced, off, 10% sampled and always on; off allocates no span;
    always-on stores traces."""
    rng = np.random.default_rng(12)
    api = P.API()
    api.create_index("c12")
    api.create_field("c12", "f")
    for shard in range(2):
        rows = rng.integers(0, 8, 2000)
        api.import_bits("c12", "f", rows=rows,
                        cols=shard * SHARD_WIDTH + np.arange(2000))

    def workload():
        return [api.query_json("c12", q) for q in _C12_QUERIES]

    T = P.T
    prev = T.get_tracer()
    results = {}
    try:
        T.set_tracer(T.NopTracer())
        results["untraced"] = workload()
        T.set_tracer(T.Tracer(enabled=False))
        assert T.get_tracer().start_span("probe") is T.NOP_SPAN
        assert T.get_tracer().start_trace("p") is T.NOP_SPAN
        orig_init, allocs = T.Span.__init__, [0]

        def counting_init(self, *a, **k):
            allocs[0] += 1
            orig_init(self, *a, **k)

        T.Span.__init__ = counting_init
        try:
            results["off"] = workload()
        finally:
            T.Span.__init__ = orig_init
        assert allocs[0] == 0
        T.set_tracer(T.Tracer(enabled=True, sample_rate=0.1,
                              store=T.TraceStore(64),
                              rng=random.Random(12)))
        results["sampled"] = workload()
        T.set_tracer(T.Tracer(enabled=True, sample_rate=1.0,
                              store=T.TraceStore(64)))
        results["always"] = workload()
        assert len(T.get_tracer().store) == len(_C12_QUERIES)
    finally:
        T.set_tracer(prev)
    for name in ("off", "sampled", "always"):
        assert results[name] == results["untraced"], name
    _release(P, api, "c12")


def test_config12_answers_match_across_packages():
    got = {}
    for root in ("pilosa_tpu", "pilosa_tpu_torch"):
        P = _pkg(root)
        rng = np.random.default_rng(12)
        api = P.API()
        api.create_index("c12")
        api.create_field("c12", "f")
        api.import_bits("c12", "f", rows=rng.integers(0, 8, 3000),
                        cols=np.arange(3000))
        got[root] = [api.query_json("c12", q) for q in _C12_QUERIES]
        _release(P, api, "c12")
    assert got["pilosa_tpu"] == got["pilosa_tpu_torch"]


# -- paranoia (tests/test_core.py TestParanoia) --------------------------------


def _set_fragment(P, shard):
    if P.root == "pilosa_tpu_torch":
        return P.fragment.SetFragment(shard, CPU)
    return P.fragment.SetFragment(shard)


class TestParanoia:
    def test_paranoia_catches_corruption(self, P, monkeypatch):
        monkeypatch.setattr(P.fragment, "PARANOIA", True)
        frag = _set_fragment(P, 0)
        frag.set_bit(1, 5)  # a healthy mutation passes
        frag.row_index[99] = 7  # corrupt the slot map
        with pytest.raises(AssertionError):
            frag.set_bit(1, 6)

    def test_paranoia_bsi_exists_invariant(self, P, monkeypatch):
        monkeypatch.setattr(P.fragment, "PARANOIA", True)
        frag = P.fragment.BSIFragment(0)
        frag.set_values([1, 2], [3, 4])
        frag.planes[P.bsi.OFFSET, 100] = np.uint32(1)  # no existence bit
        with pytest.raises(AssertionError):
            frag.set_values([3], [5])

    def test_paranoia_checks_every_bulk_write(self, P, monkeypatch):
        monkeypatch.setattr(P.fragment, "PARANOIA", True)
        frag = _set_fragment(P, 0)
        frag.set_many([1, 2], [3, 4])
        frag.planes[frag.planes.shape[0] - 1, 0] = np.uint32(1)  # padding
        for write in (lambda: frag.set_many([1], [9]),
                      lambda: frag.clear_bit(1, 3),
                      lambda: frag.import_row_plane(
                          1, np.zeros(frag.words, np.uint32)),
                      lambda: frag.clear_plane(
                          np.ones(frag.words, np.uint32))):
            with pytest.raises(AssertionError, match="dirty padding"):
                write()

    def test_port_reads_the_variable_at_import(self):
        env = dict(os.environ, PILOSA_TPU_PARANOIA="1", PYTHONPATH=ROOT)
        r = subprocess.run(
            [sys.executable, "-c", "import pilosa_tpu_torch.core.fragment "
             "as f; print(f.PARANOIA)"],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stderr
        assert r.stdout.strip() == "True"
