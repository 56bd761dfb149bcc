"""The SQL slice as a whole on the CPU: the Star Schema Benchmark through
``pilosa_tpu_torch.api.API(device="cpu")`` and ``pilosa_tpu.api.API``.

* The port's ``loadgen/ssb.py`` gives the JAX package's arrays for
  ``generate("small", seed=7)`` and its oracle rows for all 13 queries.
* SSB ``small`` (6,000 lineorder rows) loads through both APIs' ``sql``
  in ``ssb.load``'s 500-row INSERTs, with equal ``checksum()``.
* All 13 queries give equal rows (values and cell types) in both
  packages and equal the oracle under ``ssb.verify``, on the semi-join
  plane and with ``PILOSA_TPU_SEMIJOIN=0``, with equal ``sql_join_*``
  counter deltas; the semi plane engages on every query.
* ``fb_exec_requests`` lists the same statements, languages and
  statuses, and the query logs hold the same lines but for times and
  ids.
* A SELECT cached under ``enable_cache`` is served again from the cache,
  and an INSERT that changes its answer invalidates it.

Tolerance: exact. SSB's answers are integer sums; no float is compared.
"""

import json
import os

import numpy as np
import pytest

from pilosa_tpu.api import API as JaxAPI
from pilosa_tpu.loadgen import ssb as jssb
from pilosa_tpu.obs import metrics as JaxM
from pilosa_tpu_torch.api import API as TorchAPI
from pilosa_tpu_torch.loadgen import ssb as tssb
from pilosa_tpu_torch.obs import metrics as TorchM

QIDS = list(jssb.QUERIES)
_JOIN = ("sql_join_queries_total", "sql_join_fallback_total",
         "sql_join_dim_rows_total", "sql_join_broadcast_bytes_total")


def _typed(v):
    if isinstance(v, list):
        return [_typed(x) for x in v]
    return (type(v).__name__, v)


def _joins(M):
    c = M.REGISTRY.snapshot()["counters"]
    return np.array([c.get(k, 0) for k in _JOIN])


@pytest.fixture(scope="module")
def data():
    return tssb.generate("small", seed=7), jssb.generate("small", seed=7)


@pytest.fixture(scope="module")
def loaded(data, tmp_path_factory):
    d = tmp_path_factory.mktemp("sql_logs")
    jax_api, torch_api = JaxAPI(), TorchAPI(device="cpu")
    for name, api in (("jax", jax_api), ("torch", torch_api)):
        api.set_query_logger(str(d / f"{name}.log"))
    tssb.load(torch_api.sql, data[0])
    jssb.load(jax_api.sql, data[1])
    return jax_api, torch_api


def test_generate_gives_the_same_tables(data):
    t, j = data
    for name in ("date", "customer", "supplier", "part"):
        assert _typed(getattr(t, name)) == _typed(getattr(j, name))
    assert list(t.lineorder) == list(j.lineorder)
    for k, want in j.lineorder.items():
        assert t.lineorder[k].dtype == want.dtype
        np.testing.assert_array_equal(t.lineorder[k], want)
    assert tssb.QUERIES == jssb.QUERIES
    assert tssb.ORDER_KEYS == jssb.ORDER_KEYS and tssb._DDL == jssb._DDL


@pytest.mark.parametrize("qid", QIDS)
def test_oracle_gives_the_same_rows(data, qid):
    want = jssb.oracle(data[1], qid)
    assert _typed(tssb.oracle(data[0], qid)) == _typed(want)
    # and the check reads a result the same way, right or wrong
    bad = [list(r) for r in reversed(want)] + [list(want[0]) if want
                                               else [0]]
    for got in (want, bad, bad[:-1]):
        assert tssb.verify(data[0], qid, got) == \
            jssb.verify(data[1], qid, got)


def test_load_gives_equal_checksums(loaded):
    jax_api, torch_api = loaded
    assert torch_api.checksum() == jax_api.checksum()
    for api in loaded:
        assert api.sql("select count(*) from lineorder").data == [[6000]]


@pytest.mark.parametrize("semijoin", ["1", "0"], ids=["semi", "hash"])
def test_queries_equal_across_packages_and_oracle(loaded, data, semijoin,
                                                  monkeypatch):
    jax_api, torch_api = loaded
    monkeypatch.setenv("PILOSA_TPU_SEMIJOIN", semijoin)
    for qid in QIDS:
        q = tssb.QUERIES[qid]
        t0 = _joins(TorchM)
        got = torch_api.sql(q)
        t1 = _joins(TorchM)
        j0 = _joins(JaxM)
        want = jax_api.sql(q)
        j1 = _joins(JaxM)
        assert (got.schema, _typed(got.data)) == \
            (want.schema, _typed(want.data)), qid
        assert tssb.verify(data[0], qid, got.data) is None, qid
        assert list(t1 - t0) == list(j1 - j0), qid
        # the semi plane planned the join, or the fallback did
        assert (t1 - t0)[:2].tolist() == ([1, 0] if semijoin == "1"
                                          else [0, 0]), qid


def test_history_and_query_log_agree(loaded):
    jax_api, torch_api = loaded
    for api in loaded:
        with pytest.raises(KeyError):
            api.sql("select nosuch from lineorder")
        api.query("lineorder", "Count(Row(lo_discount=3))")
    cols = "index, query, language, status, error"
    sel = f"select {cols} from fb_exec_requests"
    got, want = torch_api.sql(sel).data, jax_api.sql(sel).data
    assert got == want
    assert 20 < len(got) <= 100  # the ring holds the newest 100
    assert got[1] == ["lineorder", "Count(Row(lo_discount=3))", "pql",
                      "complete", ""]
    assert got[2][2:4] == ["sql", "error"] and got[2][4]
    assert got[0] == ["", sel, "sql", "running", ""]

    def lines(api):
        out = []
        with open(api.query_logger.path) as f:
            for line in f:
                rec = json.loads(line)
                for k in ("ts", "duration_ms", "traceID", "requestID"):
                    rec.pop(k, None)
                out.append(rec)
        return out
    tl, jl = lines(torch_api), lines(jax_api)
    assert tl == jl
    assert sum(r["kind"] == "sql" for r in tl) > 5 + 6000 // 500
    assert tl[-1] == {"kind": "sql", "index": "", "query": sel}


def test_cached_select_is_invalidated_by_an_insert():
    for api in (JaxAPI(), TorchAPI(device="cpu")):
        data = tssb.generate("tiny", seed=7)
        tssb.load(api.sql, data)
        cache = api.enable_cache()
        q = "SELECT SUM(lo_revenue) FROM lineorder WHERE lo_discount = 3"
        before = api.sql(q).data
        assert api.sql(q).data == before
        assert cache.stats()["hits"] == 1
        api.sql("INSERT INTO lineorder (_id, lo_discount, lo_revenue) "
                "VALUES (100000, 3, 5)")
        assert api.sql(q).data == [[before[0][0] + 5]]
        assert cache.stats()["hits"] == 1
