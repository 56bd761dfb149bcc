"""The ingest and streaming slice end to end, over both packages.

At 20,000 records, in the shapes of ``bench.py``'s configs 1 and 17
(set fields ``city`` and ``device`` of 1000 x 10 and 100 x 10 rows, the
config's seed), each step runs through the JAX package's ``API`` and the
port's on the CPU, and the checksums and answers must be equal:

- config 1: a CSV through ``Ingester(CSVSource(...), batch_size=131072)``
  equals the same records loaded with ``API.import_bits``; Counts equal
  numpy;
- config 17 at two shards: the classic CSV load, the classic
  ``Ingester`` draining a broker of chunked messages (the oracle) and the
  pipelined ingester over the same stream give one checksum; then, with
  the scheduler on, ``GroupBy(Rows(city), Rows(device), limit=100)``
  alone and while a churn thread re-applies the whole stream through
  fresh pipelined consumers, every answer equal to numpy's pair counts;
  the churn must overlap the reads and leave the checksum unchanged;
- datagen's ``kitchen-sink`` through the per-record ``Batch`` path,
  answers against an oracle of the generated records;
- the service: ``API(path).enable_stream``, pushes drained by ``step``,
  a kill at ``stream.apply`` hit 2, ``abandon_holder``, a reopen and a
  resume from the replayed source: the checksum equals a clean run's and
  the offsets sum to the records pushed.

Tolerance is exact throughout.
"""

import importlib
import threading
import time
import types

import numpy as np
import pytest

SHARD_WIDTH = 1 << 20
N = 20_000
JOIN_S = 300.0
JAX, TORCH = "pilosa_tpu", "pilosa_tpu_torch"
ROOTS = (JAX, TORCH)


def _load(root: str) -> types.SimpleNamespace:
    m = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    api_mod = m("api")
    kw = {"device": "cpu"} if root == TORCH else {}

    def make_api(path=None, **more):
        return api_mod.API(path, **more, **kw)

    return types.SimpleNamespace(
        root=root, API=make_api, S=m("stream"), rec=m("storage.recovery"),
        Ingester=m("ingest.ingest").Ingester,
        CSVSource=m("ingest.source").CSVSource,
        parse_header=m("ingest.source")._parse_header,
        scenario=m("ingest.datagen").scenario,
        to_json=m("pql.result").result_to_json,
        AdmissionError=m("errors").AdmissionError)


_PACKAGES = {}


def _pkg(root: str) -> types.SimpleNamespace:
    if root not in _PACKAGES:
        _PACKAGES[root] = _load(root)
    return _PACKAGES[root]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: under xdist every worker's pool contends for
    the same cores."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def joined(fn, *args, **kw):
    out = {}

    def body():
        try:
            out["value"] = fn(*args, **kw)
        except BaseException as e:  # noqa: BLE001 - handed to the test
            out["error"] = e

    t = threading.Thread(target=body, daemon=True)
    t.start()
    t.join(JOIN_S)
    assert not t.is_alive(), f"{fn} did not end within {JOIN_S} s"
    return out.get("value"), out.get("error")


def run(fn, *args, **kw):
    value, error = joined(fn, *args, **kw)
    if error is not None:
        raise error
    return value


def csv_text(ids, city, dev) -> str:
    lines = ["id,city__IS,device__IS"]
    lines.extend(f"{i},{c},{d}" for i, c, d in zip(ids, city, dev))
    return "\n".join(lines)


def pair_oracle(city, dev, limit=100):
    """GroupBy(Rows(city), Rows(device), limit=) as JSON from numpy."""
    pairs, counts = np.unique(np.stack([city, dev]), axis=1,
                              return_counts=True)
    return [{"group": [{"field": "city", "rowID": int(c)},
                       {"field": "device", "rowID": int(d)}],
             "count": int(k)}
            for (c, d), k in zip(pairs.T[:limit], counts[:limit])]


# -- config 1 ------------------------------------------------------------------


def test_config1_csv_ingest_matches_import_bits_and_numpy():
    rng = np.random.default_rng(1)
    city = rng.integers(0, 1000, N)
    dev = rng.integers(0, 10, N)
    text = csv_text(range(N), city, dev)
    pairs = [(7, 3), (0, 0), (999, 9), (500, 5)]
    out = {}
    for root in ROOTS:
        P = _pkg(root)
        api = P.API()
        got = P.Ingester(api, "taxi", P.CSVSource(text, inline=True),
                         batch_size=131072).run()
        assert got == N
        ref = P.API()
        ref.create_index("taxi")
        ref.create_field("taxi", "city")
        ref.create_field("taxi", "device")
        ref.import_bits("taxi", "city", rows=city, cols=np.arange(N))
        ref.import_bits("taxi", "device", rows=dev, cols=np.arange(N))
        assert api.checksum() == ref.checksum()
        answers = [api.query(
            "taxi", f"Count(Intersect(Row(city={c}), Row(device={d})))")[0]
            for c, d in pairs]
        assert answers == [int(((city == c) & (dev == d)).sum())
                           for c, d in pairs]
        out[root] = (api.checksum(), answers)
    assert out[JAX] == out[TORCH]


# -- config 17 -----------------------------------------------------------------


def _config17():
    rng = np.random.default_rng(17)
    city = rng.integers(0, 100, N)
    dev = rng.integers(0, 10, N)
    ids = np.arange(N) * 100  # two shards, as 2M records fill at full size
    return ids, city, dev


def _stream(P, ids, city, dev, chunk=512):
    broker = P.S.StreamBroker(partitions=1, seed=17)
    for lo in range(0, N, chunk):
        hi = min(lo + chunk, N)
        broker.produce("s17", P.S.make_chunk({
            "id": ids[lo:hi], "city": city[lo:hi], "device": dev[lo:hi]}))
    return broker


@pytest.fixture(scope="module")
def config17():
    ids, city, dev = _config17()
    text = csv_text(ids, city, dev)
    out = {}
    for root in ROOTS:
        P = _pkg(root)
        schema = P.parse_header(["city__IS", "device__IS"])
        api_csv = P.API()
        assert P.Ingester(api_csv, "s17", P.CSVSource(text, inline=True),
                          batch_size=131072).run() == N
        broker = _stream(P, ids, city, dev)
        api_cl = P.API()
        assert P.Ingester(api_cl, "s17", P.S.BrokerSource(
            broker.consumer("classic", ["s17"]), schema),
            batch_size=131072).run() == N
        api_pp = P.API()
        p = P.S.PipelinedIngester(api_pp, "s17",
                                  broker.consumer("piped", ["s17"]),
                                  schema=schema, batch_rows=4)
        assert run(p.run) == N
        out[root] = types.SimpleNamespace(
            P=P, schema=schema, broker=broker, api=api_pp,
            csv=api_csv.checksum(), oracle=api_cl.checksum(),
            piped=api_pp.checksum(), batches=p.batches)
    return out, (ids, city, dev)


def test_config17_pipelined_equals_the_classic_oracle(config17):
    out, _ = config17
    for root in ROOTS:
        o = out[root]
        assert o.piped == o.oracle == o.csv
        assert o.batches == 10  # 40 chunks, 4 a batch
    assert out[JAX].oracle == out[TORCH].oracle


def test_config17_reads_alone_match_numpy_and_the_jax_package(config17):
    out, (ids, city, dev) = config17
    q = "GroupBy(Rows(city), Rows(device), limit=100)"
    want = pair_oracle(city, dev)
    got = {}
    for root in ROOTS:
        o = out[root]
        got[root] = [o.P.to_json(r) for r in o.api.query("s17", q)]
        assert got[root][0] == want
        assert o.api.query(
            "s17", "Count(Intersect(Row(city=7), Row(device=3)))")[0] == \
            int(((city == 7) & (dev == 3)).sum())
    assert got[JAX] == got[TORCH]


READS = 5


@pytest.mark.parametrize("scheduler", [True, False], ids=["sched", "direct"])
@pytest.mark.parametrize("root", ROOTS, ids=["jax", "torch"])
def test_config17_groupby_under_churn(config17, root, scheduler):
    """As bench.py's phase 3, with the reads paced: once a churn batch
    has landed, reads run while the passes go on, each started twice the
    scheduler's batch holdoff after the last one ended. With the
    scheduler on, the churn admits at batch priority and yields to the
    reads for that holdoff, so back-to-back reads would shut it out;
    without it, writes and reads interleave freely. A churn batch must
    start and land between the first read and the last."""
    out, (ids, city, dev) = config17
    o = out[root]
    api = o.api
    q = "GroupBy(Rows(city), Rows(device), limit=100)"
    want = pair_oracle(city, dev)
    gap_s = 0.01
    if scheduler:
        gap_s = 2 * api.enable_scheduler().batch_holdoff_s
    try:
        stop = threading.Event()
        churned = [0]
        applied = []  # (start, end) of each churn batch's apply
        errors = []

        def churn():
            w = 0
            try:
                while not stop.is_set():
                    w += 1
                    c = o.P.S.PipelinedIngester(
                        api, "s17",
                        o.broker.consumer(f"churn{root}{w}", ["s17"]),
                        schema=o.schema, batch_rows=2,
                        group=f"churn{root}{w}")

                    def timed(batch, _fn=c._apply):
                        t0 = time.perf_counter()
                        _fn(batch)
                        applied.append((t0, time.perf_counter()))
                    c._apply = timed
                    churned[0] += c.run()
            except BaseException as e:  # noqa: BLE001 - checked below
                errors.append(e)

        th = threading.Thread(target=churn, daemon=True)
        th.start()
        deadline = time.monotonic() + JOIN_S
        while not applied and time.monotonic() < deadline \
                and th.is_alive():
            time.sleep(0.005)
        first = time.perf_counter()
        reads = 0
        # READS reads, and on until a churn batch starts among them
        while reads < READS or (not [a for a in applied if a[0] > first]
                                and time.monotonic() < deadline):
            time.sleep(gap_s)
            assert [o.P.to_json(r) for r in api.query("s17", q)][0] == want
            reads += 1
        last = time.perf_counter()
        still_churning = th.is_alive()
        stop.set()
        th.join(JOIN_S)
        assert not th.is_alive() and not errors, errors
        assert [a for a in applied if first < a[0] and a[1] < last], \
            f"no churn batch started and landed during the {reads} reads"
        assert still_churning and churned[0] >= N
        assert api.checksum() == o.oracle
        assert [o.P.to_json(r) for r in api.query("s17", q)][0] == want
    finally:
        api.disable_scheduler()


# -- datagen's kitchen sink through Batch --------------------------------------


def _kitchen_oracle(recs):
    idset = {}
    for r in recs:
        for x in set(r["an_idset"]):
            idset[x] = idset.get(x, 0) + 1
    return {
        'Count(Row(a_mutex="v3"))': sum(r["a_mutex"] == "v3" for r in recs),
        "Count(Row(an_int > 0))": sum(r["an_int"] > 0 for r in recs),
        "Sum(field=an_int)": sum(r["an_int"] for r in recs),
        "Count(Row(a_bool=true))": sum(r["a_bool"] for r in recs),
        **{f"Count(Row(an_idset={x}))": k for x, k in sorted(idset.items())},
    }


def test_kitchen_sink_through_batch():
    got = {}
    for root in ROOTS:
        P = _pkg(root)
        recs = list(P.scenario("kitchen-sink", rows=2000, seed=1).records())
        want = _kitchen_oracle(recs)
        api = P.API()
        assert P.Ingester(api, "ks", P.scenario("kitchen-sink", rows=2000,
                                                seed=1),
                          batch_size=512).run() == 2000
        answers = {}
        for q in want:
            r = api.query("ks", q)[0]
            answers[q] = r.val if q.startswith("Sum") else r
        assert answers == want
        assert len(want) == 4 + 50
        got[root] = (api.checksum(), answers)
    assert got[JAX] == got[TORCH]


# -- the service and a crash ---------------------------------------------------

PUSHES, PER_PUSH, BATCH_ROWS = 16, 256, 16


def _records():
    rng = np.random.default_rng(12)
    city = rng.integers(0, 1000, PUSHES * PER_PUSH)
    dev = rng.integers(0, 10, PUSHES * PER_PUSH)
    return [{"id": i, "city": int(c), "device": int(d)}
            for i, (c, d) in enumerate(zip(city, dev))]


def _serve(P, path, recs, plan=None):
    """Push ``recs`` PER_PUSH at a time, each push drained by ``step``."""
    api = P.API(path)
    if plan is not None:
        P.rec.attach_crash_plan(api.holder, plan)
    svc = api.enable_stream(
        "taxi", schema=P.parse_header(["city__IS", "device__IS"]),
        batch_rows=BATCH_ROWS, plan=plan)
    error = None
    for lo in range(0, len(recs), PER_PUSH):
        svc.push(recs[lo:lo + PER_PUSH])
        _, error = joined(svc.step)
        if error is not None:
            break
    return api, svc, error


@pytest.mark.parametrize("root", ROOTS, ids=["jax", "torch"])
def test_service_crash_and_resume(tmp_path, root):
    P = _pkg(root)
    recs = _records()
    clean, svc, err = _serve(P, str(tmp_path / "clean"), recs)
    assert err is None and svc.stats()["rows"] == len(recs)
    api_clean = clean.checksum()
    with pytest.raises(P.AdmissionError):  # the backlog bound: 16*2*8
        svc.push(recs[:PER_PUSH])
        svc.push(recs[:PER_PUSH])
    clean.disable_stream()

    plan = P.rec.CrashPlan().kill("stream.apply", at=2)
    path = str(tmp_path / "crash")
    api, svc, err = _serve(P, path, recs, plan=plan)
    assert isinstance(err, P.rec.SimulatedCrash)
    assert plan.fired == ("stream.apply", 2)
    api.disable_stream()
    P.rec.abandon_holder(api.holder)
    # reopen; the producer replays the source into the new broker, and the
    # pipeline seeks past what the WAL's watermark made durable
    api2, svc2, err = _serve(P, path, recs)
    assert err is None
    assert api2.checksum() == api_clean
    offsets = api2.holder.index("taxi").stream_offsets["ingest"]
    assert sum(offsets.values()) == len(recs)
    assert svc2.stats()["rows"] == len(recs) - BATCH_ROWS
    api2.disable_stream()
