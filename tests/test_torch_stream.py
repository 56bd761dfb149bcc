"""The port's streaming ingest, held against the JAX package's.

Most tests run once per package (the ``P`` fixture: the stream modules
of ``pilosa_tpu`` or of ``pilosa_tpu_torch`` and an ``API`` factory, the
port's on the CPU): the broker's offsets, group commits, seek, pause and
lag; ``make_chunk``, ``chunk_columns`` and ``iter_rows``; the pipelined
ingester against the classic ``Ingester`` oracle, plain and chunked;
backpressure and credits; ``StreamService`` push, step and saturation;
the ``[stream]`` config; the ``KafkaSource`` consumer protocol over a
fake client; the crash matrix over ``STREAM_CRASH_SITES`` x hits 1-3
and ``stream_seeded`` on a data directory; offsets stamped into the
checkpoint across a prune. These are the cases of
``tests/test_stream.py`` but its HTTP surface, the health plane's
``ingest_stall`` trigger and the device profiler's stages, which wait
for their slices. Then the packages meet: each pipelined load and each
resumed crash gives the JAX package's checksum, and a data directory a
crashed port pipeline left resumes in the JAX package (and the other
way) to the same checksum and offsets.

Every pipeline run here goes on a thread that is joined with a timeout,
and the test asserts that it ended and that no pipeline thread is left
alive: a crash test never depends on timing to finish.
"""

import importlib
import json
import os
import threading
import time
import types

import numpy as np
import pytest

ROWS = 1200
BATCH = 200
JOIN_S = 120.0


def _load(root: str) -> types.SimpleNamespace:
    m = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    api_mod = m("api")
    kw = {"device": "cpu"} if root == "pilosa_tpu_torch" else {}
    stream = m("stream")

    def make_api(path=None, **more):
        return api_mod.API(path, **more, **kw)

    return types.SimpleNamespace(
        root=root, API=make_api, S=stream, rec=m("storage.recovery"),
        Config=m("config").Config,
        scenario=m("ingest.datagen").scenario,
        Ingester=m("ingest.ingest").Ingester,
        parse_header=m("ingest.source")._parse_header,
        KafkaSource=m("ingest.kafka").KafkaSource,
        FO=m("core.schema").FieldOptions, FT=m("core.schema").FieldType,
        ManualClock=m("sched.clock").ManualClock,
        AdmissionError=m("errors").AdmissionError)


_PACKAGES = {}


def _pkg(root: str) -> types.SimpleNamespace:
    if root not in _PACKAGES:
        _PACKAGES[root] = _load(root)
    return _PACKAGES[root]


@pytest.fixture(params=["pilosa_tpu", "pilosa_tpu_torch"],
                ids=["jax", "torch"])
def P(request):
    return _pkg(request.param)


JAX, TORCH = "pilosa_tpu", "pilosa_tpu_torch"


@pytest.fixture
def T():
    """The port alone: the crash tests. The JAX package's pipeline keeps
    committing a dead process's in-flight offsets to the consumer, so its
    crash matrix loses a batch when the host side dies while the device
    side is mid-batch (see ``test_a_dead_pipeline_commits_nothing``)."""
    return _pkg(TORCH)


def joined(fn, *args, **kw):
    """Run ``fn`` on a thread joined with a timeout: (result, exception).
    The thread and every pipeline thread it started must have ended."""
    out = {}

    def body():
        try:
            out["value"] = fn(*args, **kw)
        except BaseException as e:  # noqa: BLE001 - handed to the test
            out["error"] = e

    t = threading.Thread(target=body, name="test-runner", daemon=True)
    t.start()
    t.join(JOIN_S)
    assert not t.is_alive(), f"{fn} did not end within {JOIN_S} s"
    live = [th.name for th in threading.enumerate()
            if th.name in ("stream-host", "stream-device")
            and th.is_alive()]
    assert not live, f"pipeline threads left alive: {live}"
    return out.get("value"), out.get("error")


def run(p, **kw) -> int:
    value, error = joined(p.run, **kw)
    if error is not None:
        raise error
    return value


def customer(P, rows=ROWS, seed=5):
    src = P.scenario("customer", rows=rows, seed=seed)
    return list(src.records()), src.schema()


def make_broker(P, recs, partitions=2, seed=3):
    broker = P.S.StreamBroker(partitions=partitions, seed=seed)
    broker.produce_records("t", recs)
    return broker


def piped(P, path, broker, schema, plan=None, group="ingest",
          batch_rows=BATCH):
    api = P.API(path)
    if plan is not None:
        api.holder.crash_plan = plan
    p = P.S.PipelinedIngester(api, "idx", broker.consumer(group, ["t"]),
                              schema=schema, batch_rows=batch_rows,
                              plan=plan, group=group)
    return api, p


def chunked_broker(P, rows=900, chunk=100, plain_tail=0, seed=11):
    rng = np.random.default_rng(seed)
    city = rng.integers(0, 50, rows)
    dev = rng.integers(0, 10, rows)
    broker = P.S.StreamBroker(partitions=1, seed=seed)
    body = rows - plain_tail
    for lo in range(0, body, chunk):
        hi = min(lo + chunk, body)
        broker.produce("t", P.S.make_chunk({
            "id": list(range(lo, hi)), "city": city[lo:hi],
            "device": dev[lo:hi].tolist()}))
    for i in range(body, rows):
        broker.produce("t", {"id": i, "city": int(city[i]),
                             "device": int(dev[i])})
    return broker


def int_schema(P):
    return P.parse_header(["city__IS", "device__IS"])


# -- the broker ---------------------------------------------------------------


class TestBroker:
    def test_keys_and_offsets(self, P):
        b = P.S.StreamBroker(partitions=4, seed=1)
        p1, o1 = b.produce("t", {"id": 1}, key="k")
        p2, o2 = b.produce("t", {"id": 2}, key="k")
        assert p1 == p2 and o2 == o1 + 1
        assert b.end_offset("t", p1) == 2
        assert P.S.tp_key("t", p1) == f"t:{p1}"
        assert P.S.split_tp(P.S.tp_key("a:b", 3)) == ("a:b", 3)
        assert b.topics() == ["t"] and b.partitions("t") == 4

    def test_unkeyed_round_robin_deterministic(self, P):
        def spread(seed):
            b = P.S.StreamBroker(partitions=3, seed=seed)
            return [b.produce("t", {"i": i})[0] for i in range(9)]

        assert spread(7) == spread(7)
        assert sorted(set(spread(7))) == [0, 1, 2]

    def test_group_commit_monotonic(self, P):
        b = P.S.StreamBroker(partitions=1)
        b.produce_records("t", [{"i": i} for i in range(10)])
        b.commit("g", {"t:0": 7})
        b.commit("g", {"t:0": 4})
        assert b.committed("g", "t", 0) == 7
        assert b.committed("other", "t", 0) == 0

    def test_consumer_poll_commit_resume(self, P):
        b = P.S.StreamBroker(partitions=2, seed=0)
        b.produce_records("t", [{"i": i} for i in range(10)])
        c = b.consumer("g", ["t"])
        got = c.poll(max_records=6)
        assert len(got) == 6
        c.commit()
        rest = b.consumer("g", ["t"]).poll(max_records=100)
        assert len(rest) == 4
        assert len({(r.topic, r.partition, r.offset)
                    for r in got + rest}) == 10

    def test_seek(self, P):
        b = P.S.StreamBroker(partitions=1)
        b.produce_records("t", [{"i": i} for i in range(10)])
        c = b.consumer("g", ["t"])
        c.poll(10)
        c.seek("t", 0, 3)
        assert [r.offset for r in c.poll(100)] == list(range(3, 10))

    def test_pause_resume_and_lag(self, P):
        clock = P.ManualClock()
        b = P.S.StreamBroker(partitions=1, clock=clock)
        b.produce_records("t", [{"i": i} for i in range(5)])
        c = b.consumer("g", ["t"])
        assert c.lag() == 5
        c.pause()
        assert c.poll(100) == [] and c.paused
        clock.advance(3.0)
        c.resume()
        assert c.paused_s() == pytest.approx(3.0)
        assert len(c.poll(100)) == 5 and c.lag() == 0

    def test_broker_source_expands_chunks(self, P):
        b = P.S.StreamBroker(partitions=1)
        b.produce("t", P.S.make_chunk({"id": [0, 1], "x": [5, 6]}))
        b.produce("t", {"id": 2, "x": 7})
        src = P.S.BrokerSource(b.consumer("g", ["t"]), [], batch=1)
        assert list(src.records()) == [{"id": 0, "x": 5}, {"id": 1, "x": 6},
                                       {"id": 2, "x": 7}]


class TestChunks:
    def test_make_chunk_validates_lengths(self, P):
        with pytest.raises(ValueError):
            P.S.make_chunk({"a": [1, 2], "b": [1]})
        assert P.S.chunk_columns(P.S.make_chunk({"a": [1, 2]})) == \
            {"a": [1, 2]}
        assert P.S.chunk_columns({"id": 1}) is None
        assert P.S.CHUNK_KEY == "__columns__"

    def test_iter_rows_expands_chunks(self, P):
        rows = list(P.S.iter_rows(P.S.make_chunk({"a": [1, 2],
                                                  "b": [3, 4]})))
        assert rows == [{"a": 1, "b": 3}, {"a": 2, "b": 4}]
        assert list(P.S.iter_rows({"a": 5})) == [{"a": 5}]
        assert list(P.S.iter_rows(P.S.make_chunk({}))) == []


# -- pipelined against the classic Ingester -----------------------------------


def _classic(P, path, broker, schema, group="classic"):
    api = P.API(path)
    n = P.Ingester(api, "idx", P.S.BrokerSource(
        broker.consumer(group, ["t"]), schema), batch_size=BATCH).run()
    return api, n


class TestPipelineIdentity:
    def test_matches_classic_ingester(self, P, tmp_path):
        recs, schema = customer(P)
        broker = make_broker(P, recs)
        api1, n1 = _classic(P, str(tmp_path / "classic"), broker, schema)
        api2, p = piped(P, str(tmp_path / "piped"), broker, schema,
                        group="g2")
        assert n1 == run(p) == ROWS
        assert api1.checksum() == api2.checksum()
        offs = api2.holder.index("idx").stream_offsets["g2"]
        assert sum(offs.values()) == ROWS
        assert p.stats()["rows"] == ROWS and p.stats()["credits"] == 2

    def test_auto_id_records(self, P, tmp_path):
        broker = P.S.StreamBroker(partitions=1)
        broker.produce_records("t", [{"color": ["red"]} for _ in range(300)])
        api = P.API(str(tmp_path))
        api.create_index("idx")
        api.holder.index("idx").create_field(
            "color", P.FO(type=P.FT.SET, keys=True))
        p = P.S.PipelinedIngester(api, "idx", broker.consumer("g", ["t"]),
                                  id_field=None, batch_rows=100)
        assert run(p) == 300
        assert api.query("idx", "Count(Row(color=red))")[0] == 300

    def test_chunked_identity_vs_classic(self, P, tmp_path):
        broker = chunked_broker(P)
        api1, n1 = _classic(P, str(tmp_path / "classic"), broker,
                            int_schema(P))
        api2, p = piped(P, str(tmp_path / "piped"), broker, int_schema(P),
                        group="g2")
        assert n1 == run(p) == 900
        assert api1.checksum() == api2.checksum()
        assert sum(api2.holder.index("idx").stream_offsets["g2"]
                   .values()) == 9  # offsets count messages

    def test_mixed_plain_and_chunked_batch(self, P, tmp_path):
        broker = chunked_broker(P, rows=450, chunk=100, plain_tail=50)
        api1, n1 = _classic(P, str(tmp_path / "classic"), broker,
                            int_schema(P))
        api2, p = piped(P, str(tmp_path / "piped"), broker, int_schema(P),
                        group="g2")
        assert n1 == run(p) == 450
        assert api1.checksum() == api2.checksum()

    def test_chunks_must_share_columns(self, P, tmp_path):
        broker = P.S.StreamBroker(partitions=1)
        broker.produce("t", P.S.make_chunk({"id": [0], "city": [1]}))
        broker.produce("t", P.S.make_chunk({"id": [1], "device": [1]}))
        api, p = piped(P, str(tmp_path), broker, int_schema(P))
        with pytest.raises(ValueError, match="share columns"):
            run(p)

    def test_max_batches(self, P, tmp_path):
        recs, schema = customer(P, rows=600)
        api, p = piped(P, str(tmp_path), make_broker(P, recs), schema)
        assert run(p, max_batches=2) == 2 * BATCH
        assert run(p) == 600  # rows counts across runs

    @pytest.mark.parametrize("site", ["stream.handoff", "stream.apply",
                                      "stream.commit"])
    def test_chunked_crash_resume(self, T, tmp_path, site):
        P, J = T, _pkg(JAX)  # the golden: the JAX package's clean load
        g_api, g = piped(J, str(tmp_path / "golden"), chunked_broker(J),
                         int_schema(J))
        run(g)
        golden = g_api.checksum()
        broker = chunked_broker(P)
        plan = P.rec.CrashPlan().kill(site, at=2)
        api, p = piped(P, str(tmp_path / "crash"), broker, int_schema(P),
                       plan=plan, batch_rows=3)
        _, err = joined(p.run)
        assert isinstance(err, P.rec.SimulatedCrash)
        P.rec.abandon_holder(api.holder)
        api2, p2 = piped(P, str(tmp_path / "crash"), broker, int_schema(P))
        run(p2)
        assert api2.checksum() == golden


def test_pipelined_loads_match_across_packages(tmp_path):
    sums = {}
    for root in (JAX, TORCH):
        P = _pkg(root)
        recs, schema = customer(P)
        api, p = piped(P, str(tmp_path / root), make_broker(P, recs),
                       schema)
        run(p)
        api_c, p_c = piped(P, str(tmp_path / f"{root}-c"),
                           chunked_broker(P), int_schema(P), batch_rows=2)
        run(p_c)
        sums[root] = (api.checksum(), api_c.checksum(),
                      api.holder.index("idx").stream_offsets,
                      api.query("idx", "Count(Row(city=nyc))")[0],
                      api_c.query("idx", "Count(Row(city=7))")[0])
    assert sums[JAX] == sums[TORCH]


# -- exactly-once crash and resume --------------------------------------------


def _crash_then_resume(P, path, plan, recs, schema):
    broker = make_broker(P, recs)
    api, p = piped(P, path, broker, schema, plan=plan)
    _, err = joined(p.run)
    crashed = isinstance(err, P.rec.SimulatedCrash)
    if err is not None and not crashed:
        raise err
    P.rec.abandon_holder(api.holder)
    api2, p2 = piped(P, path, broker, schema)
    run(p2)
    return crashed, api2


_GOLDEN = {}


def golden(tmp_path_factory):
    """The JAX package's clean pipelined load of the same records: the
    checksum every crashed and resumed stream of the port must reach (a
    clean run does not meet the JAX package's crash race)."""
    if JAX not in _GOLDEN:
        P = _pkg(JAX)
        recs, schema = customer(P)
        api, p = piped(P, str(tmp_path_factory.mktemp("golden")),
                       make_broker(P, recs), schema)
        run(p)
        _GOLDEN[JAX] = api.checksum()
    return _GOLDEN[JAX]


class TestStreamCrashMatrix:
    @pytest.mark.parametrize("at", [1, 2, 3])
    @pytest.mark.parametrize("site", ["stream.handoff", "stream.apply",
                                      "stream.commit"])
    def test_kill_at_stage_boundary(self, T, tmp_path, tmp_path_factory,
                                    site, at):
        P = T
        recs, schema = customer(P)
        plan = P.rec.CrashPlan().kill(site, at=at)
        crashed, api2 = _crash_then_resume(P, str(tmp_path), plan, recs,
                                           schema)
        assert crashed, f"{site}@{at} never fired"
        assert plan.fired == (site, at)
        assert api2.checksum() == golden(tmp_path_factory)
        offs = api2.holder.index("idx").stream_offsets["ingest"]
        assert sum(offs.values()) == ROWS

    def test_sites_are_the_jax_packages(self):
        ours, theirs = _pkg(TORCH).rec, _pkg(JAX).rec
        assert ours.STREAM_CRASH_SITES == theirs.STREAM_CRASH_SITES == (
            "stream.handoff", "stream.apply", "stream.commit")
        assert not set(ours.STREAM_CRASH_SITES) & set(ours.CRASH_SITES)

    @pytest.mark.parametrize("seed", [0, 1, 7, 11, "lane"])
    def test_stream_seeded_picks_the_same_kill(self, seed):
        ours = _pkg(TORCH).rec.CrashPlan.stream_seeded(seed)
        theirs = _pkg(JAX).rec.CrashPlan.stream_seeded(seed)
        assert ours._arms == theirs._arms
        assert all(s in _pkg(TORCH).rec.STREAM_CRASH_SITES
                   for s in ours._arms)
        assert ours._arms != _pkg(TORCH).rec.CrashPlan.seeded(seed)._arms

    def test_seeded_stream_plan(self, T, tmp_path, tmp_path_factory):
        P = T
        seed = int(os.environ.get("PILOSA_TPU_CRASH_SEED", "1"))
        plan = P.rec.CrashPlan.stream_seeded(seed)
        recs, schema = customer(P)
        crashed, api2 = _crash_then_resume(P, str(tmp_path), plan, recs,
                                           schema)
        assert crashed
        assert api2.checksum() == golden(tmp_path_factory)

    def test_a_dead_pipeline_commits_nothing(self, T, tmp_path,
                                             tmp_path_factory):
        """The race behind the JAX package's flaky crash matrix, forced:
        the device side takes batch 1 off the queue, then the host side
        dies at ``stream.handoff`` hit 2 before the device side applies
        it. Batch 1 never becomes durable, so nothing of it may reach
        the consumer's group offsets either, or the resume (the WAL holds
        no watermark for the partition) would start past it."""
        P = T
        plan = _HoldHandoff(P.rec.CrashPlan)
        recs, schema = customer(P)
        broker = make_broker(P, recs)
        api, p = piped(P, str(tmp_path), broker, schema, plan=plan)
        apply = p._apply_admitted

        def late(batch):
            plan.entered.set()  # past the device loop's stop check
            deadline = time.monotonic() + JOIN_S
            while not plan.dead and time.monotonic() < deadline:
                time.sleep(0.001)
            return apply(batch)

        p._apply_admitted = late
        _, err = joined(p.run)
        assert isinstance(err, P.rec.SimulatedCrash)
        assert plan.fired == ("stream.handoff", 2)
        assert broker.committed("ingest", "t", 0) == 0
        assert p.batches == 0 and p.rows == 0
        P.rec.abandon_holder(api.holder)
        api2, p2 = piped(P, str(tmp_path), broker, schema)
        assert run(p2) == ROWS
        assert api2.checksum() == golden(tmp_path_factory)

    def test_checkpoint_stamps_offsets_across_prune(self, P, tmp_path):
        recs, schema = customer(P, rows=600)
        broker = make_broker(P, recs)
        api, p = piped(P, str(tmp_path), broker, schema)
        run(p)
        want = api.checksum()
        api.save()  # stamps the offsets, prunes the WAL
        assert api.holder.wal_bytes() == 0
        P.rec.abandon_holder(api.holder)
        api2, p2 = piped(P, str(tmp_path), broker, schema)
        assert sum(api2.holder.index("idx").stream_offsets["ingest"]
                   .values()) == 600
        assert run(p2) == 0
        assert api2.checksum() == want


@pytest.mark.parametrize("site", ["stream.handoff", "stream.apply",
                                  "stream.commit"])
@pytest.mark.parametrize("writer,reader", [(TORCH, JAX), (JAX, TORCH)])
def test_crashed_stream_resumes_in_the_other_package(tmp_path, writer,
                                                     reader, site):
    W, R = _pkg(writer), _pkg(reader)
    recs, schema = customer(W, rows=800)
    broker = make_broker(W, recs)
    plan = W.rec.CrashPlan().kill(site, at=2)
    api, p = piped(W, str(tmp_path / "d"), broker, schema, plan=plan)
    _, err = joined(p.run)
    assert isinstance(err, W.rec.SimulatedCrash)
    W.rec.abandon_holder(api.holder)
    # the reader drains the same records through a fresh broker of its
    # own: its group offsets are 0, so only the WAL's watermark can skip
    # what the writer made durable
    r_broker = make_broker(R, recs)
    api2, p2 = piped(R, str(tmp_path / "d"), r_broker, schema)
    run(p2)
    ref, p_ref = piped(R, str(tmp_path / "ref"), make_broker(R, recs),
                       schema)
    run(p_ref)
    assert api2.checksum() == ref.checksum()
    assert api2.holder.index("idx").stream_offsets == \
        ref.holder.index("idx").stream_offsets


def _HoldHandoff(base):
    """A crash plan armed at ``stream.handoff`` hit 2 that holds that hit
    until ``entered`` is set."""

    class HoldHandoff(base):
        def __init__(self):
            super().__init__()
            self.kill("stream.handoff", at=2)
            self.entered = threading.Event()

        def fire(self, site):
            if site == "stream.handoff" and self._hits.get(site, 0) == 1:
                assert self.entered.wait(JOIN_S)
            return super().fire(site)

    return HoldHandoff()


# -- backpressure -------------------------------------------------------------


class TestBackpressure:
    def test_enqueue_pauses_consumer_when_full(self, P, tmp_path):
        recs, schema = customer(P, rows=100)
        broker = make_broker(P, recs)
        api = P.API(str(tmp_path))
        consumer = broker.consumer("g", ["t"])
        p = P.S.PipelinedIngester(api, "idx", consumer, schema=schema,
                                  batch_rows=10, queue_depth=1)
        p._ensure_schema()
        batch = p._prepare(consumer.poll(10))
        p._queue.put_nowait(object())  # the device side is "busy"
        assert p.credits() == 0
        t = threading.Thread(target=p._enqueue, args=(batch,))
        t.start()
        for _ in range(2500):
            if consumer.paused:
                break
            time.sleep(0.002)
        assert consumer.paused
        assert p.stats()["paused"] and p.stats()["credits"] == 0
        p._queue.get_nowait()  # the device side catches up
        t.join(timeout=JOIN_S)
        assert not t.is_alive() and not consumer.paused
        assert p.paused_s >= 0.0 and p.credits() == 0

    def test_service_push_rejects_when_saturated(self, P, tmp_path):
        api = P.API(str(tmp_path))
        svc = P.S.StreamService(api, "idx", batch_rows=10, queue_depth=1,
                                max_backlog_rows=20)
        assert svc.push([{"id": i} for i in range(19)])["accepted"] == 19
        svc.push([{"id": 99}])  # reaches the backlog bound
        with pytest.raises(P.AdmissionError):
            svc.push([{"id": 100}])
        assert svc.rejected == 1 and svc.stats()["saturated"]
        joined(svc.step)
        assert not svc.saturated()
        assert svc.push([{"id": 100}])["accepted"] == 1
        svc.close()

    def test_push_validates_records(self, P, tmp_path):
        svc = P.S.StreamService(P.API(str(tmp_path)), "idx")
        with pytest.raises(ValueError):
            svc.push(["not-a-dict"])
        svc.close()

    def test_scheduler_batch_priority_keeps_read_headroom(self, P, tmp_path):
        recs, schema = customer(P, rows=600)
        broker = make_broker(P, recs)
        api = P.API(str(tmp_path))
        api.enable_scheduler()
        try:
            p = P.S.PipelinedIngester(api, "idx", broker.consumer("g", ["t"]),
                                      schema=schema, batch_rows=100)
            assert run(p) == 600
            assert api.query("idx", "Count(All())")[0] == 600
        finally:
            api.disable_scheduler()

    def test_batch_admission_sheds_while_reads_are_active(self, P, tmp_path):
        recs, schema = customer(P, rows=300)
        broker = make_broker(P, recs)
        api = P.API(str(tmp_path))
        sched = api.enable_scheduler(batch_holdoff_ms=0.0)
        try:
            p = P.S.PipelinedIngester(api, "idx", broker.consumer("g", ["t"]),
                                      schema=schema, batch_rows=100,
                                      backoff_s=0.001)
            with sched.admit():  # an interactive read holds a ticket
                t = threading.Thread(target=p.run, daemon=True)
                t.start()
                for _ in range(2500):
                    if p.shed:
                        break
                    time.sleep(0.002)
                assert p.shed > 0 and p.rows == 0
            t.join(JOIN_S)
            assert not t.is_alive() and p.rows == 300
        finally:
            api.disable_scheduler()


# -- the service and the [stream] config --------------------------------------


class TestStreamService:
    def test_push_step_and_stats(self, P, tmp_path):
        api = P.API(str(tmp_path))
        schema = [("color", P.FO(type=P.FT.SET, keys=True))]
        svc = api.enable_stream("idx", schema=schema, batch_rows=16)
        try:
            assert svc is api.stream
            out = svc.push([{"id": i, "color": [f"c{i % 3}"]}
                            for i in range(50)])
            assert out == {"accepted": 50, "lag": 50, "credits": 2}
            assert svc.stats()["lag"] == 50
            value, err = joined(svc.step)
            assert err is None and value == 50
            st = svc.stats()
            assert st["lag"] == 0 and st["rows"] == 50 and st["enabled"]
            assert st["batches"] == 4 and st["topic"] == "ingest"
            assert api.query("idx", "Count(Row(color=c1))")[0] == 17
        finally:
            api.disable_stream()
        assert api.stream is None

    def test_toml_section_and_env(self, P, tmp_path):
        p = tmp_path / "c.toml"
        p.write_text("[stream]\nbatch_rows = 4096\nqueue_depth = 3\n")
        cfg = P.Config.from_sources(
            toml_path=str(p),
            env={"PILOSA_TPU_STREAM_GROUP": "workers",
                 "PILOSA_TPU_STREAM_MAX_BACKLOG_ROWS": "500"})
        assert cfg.stream_batch_rows == 4096
        assert cfg.stream_queue_depth == 3
        assert cfg.stream_group == "workers"
        assert cfg.stream_max_backlog_rows == 500

    def test_service_from_config(self, P, tmp_path):
        cfg = P.Config()
        cfg.stream_batch_rows = 123
        cfg.stream_queue_depth = 4
        cfg.stream_group = "g9"
        api = P.API(str(tmp_path))
        svc = api.enable_stream("idx", config=cfg)
        try:
            assert svc.ingester.batch_rows == 123
            assert svc.ingester.queue_depth == 4
            assert svc.group == "g9"
            assert svc.max_backlog_rows == 123 * 4 * 8
        finally:
            api.disable_stream()

    def test_service_background_drain(self, P, tmp_path):
        api = P.API(str(tmp_path))
        svc = api.enable_stream("idx", batch_rows=10)
        try:
            svc.start(interval_s=0.01)
            svc.push([{"id": i} for i in range(25)])
            deadline = time.monotonic() + 30.0
            while time.monotonic() < deadline and svc.ingester.rows < 25:
                time.sleep(0.01)
            assert svc.ingester.rows == 25
            assert api.query("idx", "Count(All())")[0] == 25
        finally:
            api.disable_stream()
        assert not [t for t in threading.enumerate()
                    if t.name == "stream-drain" and t.is_alive()]


def test_stream_config_fields_match():
    import dataclasses

    ours = {f.name: f.default for f in
            dataclasses.fields(_pkg(TORCH).Config) if
            f.name.startswith("stream_")}
    theirs = {f.name: f.default for f in
              dataclasses.fields(_pkg(JAX).Config) if
              f.name in ours}
    # batch_rows, queue_depth, group, max_backlog_rows, read by the
    # health plane ingest_stall_s, and, read by the CLI's server,
    # enabled and index
    assert ours == theirs and len(ours) == 7


# -- the KafkaSource consumer protocol over a fake client ---------------------


class _FakeMsg:
    def __init__(self, topic, partition, offset, value, key=None):
        self._t, self._p, self._o = topic, partition, offset
        self._v, self._k = value, key

    def topic(self):
        return self._t

    def partition(self):
        return self._p

    def offset(self):
        return self._o

    def value(self):
        return self._v

    def key(self):
        return self._k

    def error(self):
        return None


class _FakeTopicPartition:
    def __init__(self, topic, partition, offset=-1001):
        self.topic, self.partition, self.offset = topic, partition, offset


class _FakeConsumer:
    """confluent-kafka-shaped consumer over an in-memory log."""

    def __init__(self, conf):
        self.conf = conf
        self.log = []
        self.pos = 0
        self.commits = []
        self.paused_tps = []
        self.seeks = []

    def subscribe(self, topics):
        self.topics = topics

    def poll(self, timeout=0.0):
        if self.pos >= len(self.log):
            return None
        msg = self.log[self.pos]
        self.pos += 1
        return msg

    def assignment(self):
        return [_FakeTopicPartition("t", 0)]

    def commit(self, offsets=None, asynchronous=True):
        self.commits.append(offsets)

    def committed(self, tps):
        last = self.commits[-1] if self.commits else []
        return last or [_FakeTopicPartition("t", 0, 0)]

    def seek(self, tp):
        self.seeks.append((tp.topic, tp.partition, tp.offset))
        self.pos = tp.offset

    def pause(self, tps):
        self.paused_tps = tps

    def resume(self, tps):
        self.paused_tps = []


class _FakeClient:
    Consumer = _FakeConsumer
    TopicPartition = _FakeTopicPartition


class TestKafkaSourceProtocol:
    def make(self, P):
        src = P.KafkaSource("b:9092", ["t"], "g", ["id", "color__SS"],
                            client=_FakeClient())
        consumer = src.connect()
        consumer.log = [_FakeMsg("t", 0, i, json.dumps(
            {"id": i, "color": ["red"]}).encode()) for i in range(5)]
        return src, consumer

    def test_poll_returns_stream_records(self, P):
        src, _ = self.make(P)
        recs = src.poll(max_records=3)
        assert [r.offset for r in recs] == [0, 1, 2]
        assert recs[0].topic == "t" and recs[0].partition == 0
        assert recs[0].value == {"id": 0, "color": ["red"]}
        assert len(src.poll(max_records=10)) == 2

    def test_commit_offsets_mapping(self, P):
        src, consumer = self.make(P)
        src.poll(max_records=5)
        src.commit({"t:0": 5})
        (tps,) = consumer.commits
        assert (tps[0].topic, tps[0].partition, tps[0].offset) == \
            ("t", 0, 5)
        assert src.committed("t", 0) == 5

    def test_seek_pause_resume(self, P):
        src, consumer = self.make(P)
        src.poll(max_records=5)
        src.seek("t", 0, 2)
        assert consumer.seeks == [("t", 0, 2)]
        assert [r.offset for r in src.poll(max_records=10)] == [2, 3, 4]
        assert not src.paused
        src.pause()
        assert src.paused and consumer.paused_tps
        src.resume()
        assert not src.paused and not consumer.paused_tps

    def test_drives_pipelined_ingester(self, P, tmp_path):
        src, _ = self.make(P)
        api = P.API(str(tmp_path))
        p = P.S.PipelinedIngester(api, "idx", src, schema=src.schema(),
                                  batch_rows=2)
        assert run(p) == 5
        assert api.query("idx", "Count(Row(color=red))")[0] == 5


def test_concurrent_pipelines_and_readers_stress(P, tmp_path):
    """More threads than cores on one API: four pipelined ingesters (eight
    pipeline threads) re-apply one stream under separate groups while four
    readers count, with a short switch interval. Re-applying is
    idempotent, so every read and the final checksum must equal the
    oracle's: a lost or torn update breaks one of them."""
    import sys

    broker = chunked_broker(P, rows=3000, chunk=100)
    api, p = piped(P, str(tmp_path), broker, int_schema(P), batch_rows=3)
    run(p)
    want = api.checksum()
    queries = {q: api.query("idx", q)[0] for q in (
        "Count(Row(city=7))", "Count(Intersect(Row(city=3), Row(device=4)))",
        "Count(Union(Row(device=1), Row(device=2)))")}
    errors, reads = [], [0]
    stop = threading.Event()

    def ingest(k):
        try:
            c = P.S.PipelinedIngester(api, "idx",
                                      broker.consumer(f"s{k}", ["t"]),
                                      schema=int_schema(P), batch_rows=1,
                                      group=f"s{k}")
            c.run()
        except BaseException as e:  # noqa: BLE001 - checked below
            errors.append(e)

    def read():
        try:
            while not stop.is_set():
                for q, w in queries.items():
                    assert api.query("idx", q)[0] == w, q
                reads[0] += 1
        except BaseException as e:  # noqa: BLE001 - checked below
            errors.append(e)

    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        writers = [threading.Thread(target=ingest, args=(k,), daemon=True)
                   for k in range(4)]
        readers = [threading.Thread(target=read, daemon=True)
                   for _ in range(4)]
        for t in writers + readers:
            t.start()
        for t in writers:
            t.join(JOIN_S)
        stop.set()
        for t in readers:
            t.join(JOIN_S)
    finally:
        sys.setswitchinterval(before)
    assert not any(t.is_alive() for t in writers + readers)
    assert not errors, errors
    assert reads[0] > 0
    assert api.checksum() == want
    assert {k: sum(v.values()) for k, v in
            api.holder.index("idx").stream_offsets.items()} == \
        {"ingest": 30, "s0": 30, "s1": 30, "s2": 30, "s3": 30}
