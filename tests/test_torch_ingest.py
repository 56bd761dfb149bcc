"""The port's ingest kit, held against the JAX package's, module by module.

Most tests run once per package: the ``P`` fixture yields the ingest
modules of ``pilosa_tpu`` or of ``pilosa_tpu_torch`` and an ``API``
factory (the port's on the CPU), and the body is the same. Covered: the
cases of ``tests/test_ingest.py`` (``Batch``, ``CSVSource``, the
``Ingester`` with auto ids, schema inference and a keyed index, the
columnar fast path's regressions, the gated ``KafkaSource``), the
rate-controlled datagen cases of ``tests/test_stream.py``, and the
extended sources (``SQLSource`` on ``sqlite3``, ``KinesisSource`` with a
stub client, ``avro_decode`` and ``AvroSource``). Then the two packages
meet: ``_parse_header``, ``_coerce``, ``coerce_column`` and
``CSVSource.columns`` / ``records`` give equal results on the same
cells; every datagen scenario gives the same records for the same seed;
and each load (CSV columnar, per-record ``Batch``, every scenario,
``SQLSource``, ``AvroSource``, a keyed index, auto ids) leaves both
packages with the same ``API.checksum()`` and the same answers.
Tolerance is exact throughout.
"""

import builtins
import importlib
import json
import sqlite3
import struct
import time
import types

import numpy as np
import pytest

SHARD_WIDTH = 1 << 20


def _load(root: str) -> types.SimpleNamespace:
    m = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    api_mod = m("api")
    kw = {"device": "cpu"} if root == "pilosa_tpu_torch" else {}
    schema = m("core.schema")

    def make_api(path=None, **more):
        return api_mod.API(path, **more, **kw)

    return types.SimpleNamespace(
        root=root, API=make_api, FO=schema.FieldOptions, FT=schema.FieldType,
        source=m("ingest.source"), batch=m("ingest.batch"),
        ingest=m("ingest.ingest"), datagen=m("ingest.datagen"),
        ext=m("ingest.sources_ext"), kafka=m("ingest.kafka"),
        ManualClock=m("sched.clock").ManualClock,
        to_json=m("pql.result").result_to_json)


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


def _opts(o) -> dict:
    return o.to_json()


def _answers(P, api, index, queries):
    return [[P.to_json(r) for r in api.query(index, q)] for q in queries]


def _both(load, queries, index):
    """Run ``load(P, api)`` through each package; the checksums and the
    answers to ``queries`` must be equal. Returns the port's answers."""
    out = {}
    for root in (JAX, TORCH):
        P = _pkg(root)
        api = P.API()
        ret = load(P, api)
        out[root] = (api.checksum(), _answers(P, api, index, queries), ret)
    assert out[JAX][0] == out[TORCH][0], "checksums differ"
    assert out[JAX][1] == out[TORCH][1], "answers differ"
    assert out[JAX][2] == out[TORCH][2]
    return out[TORCH][1]


# -- tests/test_ingest.py, once per package -----------------------------------


@pytest.fixture()
def api(P):
    a = P.API()
    a.create_index("i")
    idx = a.holder.index("i")
    idx.create_field("color", P.FO(type=P.FT.SET, keys=True))
    idx.create_field("size", P.FO(type=P.FT.MUTEX, keys=True))
    idx.create_field("age", P.FO(type=P.FT.INT))
    idx.create_field("active", P.FO(type=P.FT.BOOL))
    return a


def count(api, pql, index="i"):
    return api.query(index, pql)[0]


class TestIngestCases:
    def test_batch_basic(self, P, api):
        b = P.batch.Batch(api, "i", size=3)
        assert not b.add({"id": 1, "color": ["red", "blue"], "age": 10})
        b.add({"id": 2, "color": ["red"], "size": "L", "active": True})
        assert b.add({"id": 1 << 20, "age": -5})  # second shard; flushes
        assert b.imported == 3 and len(b) == 0
        assert count(api, "Count(Row(color=red))") == 2
        assert count(api, "Count(Row(color=blue))") == 1
        assert api.query("i", "Sum(field=age)")[0].val == 5
        assert count(api, "Count(Row(active=true))") == 1
        assert count(api, "Count(All())") == 3

    def test_batch_mutex_scalar(self, P, api):
        b = P.batch.Batch(api, "i", size=10)
        b.add({"id": 7, "size": "S"})
        b.flush()
        b.add({"id": 7, "size": "M"})  # mutex overwrite
        b.flush()
        assert count(api, "Count(Row(size=M))") == 1
        assert count(api, "Count(Row(size=S))") == 0

    def test_batch_missing_id_column(self, P, api):
        with pytest.raises(ValueError):
            P.batch.Batch(api, "i").add({"color": ["red"]})

    def test_batch_keyed_index(self, P):
        api = P.API()
        api.create_index("k", {"keys": True})
        api.holder.index("k").create_field(
            "color", P.FO(type=P.FT.SET, keys=True))
        b = P.batch.Batch(api, "k", size=10)
        b.add({"id": "userA", "color": ["red"]})
        b.add({"id": "userB", "color": ["red"]})
        b.flush()
        assert sorted(api.query("k", "Row(color=red)")[0].keys) == \
            ["userA", "userB"]

    def test_csv_source_typed_header(self, P, api, tmp_path):
        p = tmp_path / "data.csv"
        p.write_text(
            "id,name__S,age__I,tags__SS,ok__B,price__F2\n"
            "1,alice,30,a;b,true,9.99\n"
            "2,bob,40,b,false,1.50\n"
            "3,carol,,c;d,true,\n")
        ing = P.ingest.Ingester(api, "csvidx", P.source.CSVSource(str(p)),
                                batch_size=2)
        assert ing.run() == 3
        assert count(api, "Count(Row(tags=b))", "csvidx") == 2
        assert api.query("csvidx", "Sum(field=age)")[0].val == 70
        assert count(api, "Count(Row(name=carol))", "csvidx") == 1
        assert abs(api.query("csvidx", "Max(field=price)")[0].val
                   - 9.99) < 1e-9

    def test_ingester_auto_id(self, P, api):
        schema = [("color", P.FO(type=P.FT.SET, keys=True))]
        src = P.source.ListSource(
            schema, [{"color": ["x"]}, {"color": ["x", "y"]}], id_col=None)
        assert P.ingest.Ingester(api, "autoidx", src, batch_size=10).run() \
            == 2
        assert count(api, "Count(Row(color=x))", "autoidx") == 2
        assert len(api.query("autoidx", "Row(color=y)")[0].columns) == 1

    def test_ingester_schema_inference(self, P, api):
        src = P.source.CSVSource("id,city__S,pop__I\n9,nyc,8000000\n",
                                 inline=True)
        P.ingest.Ingester(api, "inferidx", src).run()
        idx = api.holder.index("inferidx")
        assert idx.field("city").options.keys
        assert idx.field("pop").options.type == P.FT.INT
        assert count(api, "Count(Row(city=nyc))", "inferidx") == 1

    def test_kafka_source_gated_and_fake(self, P, api):
        class FakeConsumer:
            def __iter__(self):
                class M:
                    def __init__(self, v):
                        self.value = v
                for v in [{"id": 1, "color": ["red"]},
                          {"id": 2, "color": ["blue"]}]:
                    yield M(json.dumps(v))

        class FakeClient:
            def KafkaConsumer(self, *a, **k):
                return FakeConsumer()

        src = P.kafka.KafkaSource("localhost:9092", ["t"], "g",
                                  fields=["id", "color__SS"],
                                  client=FakeClient())
        assert P.ingest.Ingester(api, "kafkaidx", src).run() == 2
        assert count(api, "Count(Row(color=red))", "kafkaidx") == 1

    def test_kafka_gate_raises_without_a_client(self, P, monkeypatch):
        real = builtins.__import__

        def deny(name, *a, **k):
            if name in ("confluent_kafka", "kafka"):
                raise ImportError(name)
            return real(name, *a, **k)

        monkeypatch.setattr(builtins, "__import__", deny)
        with pytest.raises(ImportError, match="no kafka client"):
            P.kafka._kafka_client()
        with pytest.raises(ImportError, match="no kafka client"):
            P.kafka.KafkaSource("b:9092", ["t"], "g", ["id"])

    def test_csv_columnar_trailing_semicolons(self, P, api):
        src = P.source.CSVSource("id,tags__IS\n1,5;6;\n2,;7\n3,\n",
                                 inline=True)
        assert P.ingest.Ingester(api, "semi", src).run() == 3
        for r in (5, 6, 7):
            assert count(api, f"Count(Row(tags={r}))", "semi") == 1

    def test_csv_columnar_ragged_rows_not_misaligned(self, P, api):
        text = "id,a__I,b__I\n1,10,20\n2,30\n3,40,50,60\n4,70,80\n"
        assert P.ingest.Ingester(
            api, "rag", P.source.CSVSource(text, inline=True)).run() == 4
        assert count(api, "Count(Row(a=10))", "rag") == 1
        assert count(api, "Count(Row(b=80))", "rag") == 1
        assert count(api, "Count(Row(b=40))", "rag") == 0

    def test_csv_columnar_bool_whitespace(self, P, api):
        src = P.source.CSVSource("id,ok__B\n1, true\n2,false \n3,TRUE\n",
                                 inline=True)
        assert P.ingest.Ingester(api, "bw", src).run() == 3
        assert count(api, "Count(Row(ok=1))", "bw") == 2
        assert count(api, "Count(Row(ok=0))", "bw") == 1

    def test_csv_columnar_matches_per_record_path(self, P):
        text = ("id,city__IS,dev__ID,age__I,name__S\n"
                + "\n".join(f"{i},{i % 7},{i % 3},{i * 2},{'u%d' % (i % 5)}"
                            for i in range(500)) + "\n")
        a1, a2 = P.API(), P.API()
        assert P.ingest.Ingester(
            a1, "x", P.source.CSVSource(text, inline=True)).run() == 500
        src2 = P.source.CSVSource(text, inline=True)
        ing2 = P.ingest.Ingester(a2, "x", src2, batch_size=64)
        # the per-record path: .columns hidden behind a plain facade
        ing2.source = type("S", (), {
            "schema": src2.schema, "records": src2.records,
            "id_column": src2.id_column})()
        assert ing2.run() == 500
        for q in ("Count(Row(city=3))", "Count(Row(dev=1))",
                  "Count(Row(name=u2))", "Count(Row(age > 500))"):
            assert a1.query("x", q)[0] == a2.query("x", q)[0], q
        assert a1.checksum() == a2.checksum()


class TestRateControlledDatagen:
    def test_manual_clock_zero_wall_sleeps(self, P):
        clock = P.ManualClock()
        src = P.datagen.scenario("customer", rows=50, seed=1,
                                 rate_rows_s=100.0, clock=clock)
        t0 = time.monotonic()
        recs = list(src.records())
        assert len(recs) == 50
        assert clock.now() == pytest.approx(49 / 100.0)
        assert time.monotonic() - t0 < 1.0

    def test_rate_deterministic(self, P):
        def run():
            return list(P.datagen.scenario(
                "customer", rows=20, seed=9, rate_rows_s=50.0,
                clock=P.ManualClock()).records())

        assert run() == run() == list(P.datagen.scenario(
            "customer", rows=20, seed=9).records())

    def test_rate_must_be_positive(self, P):
        with pytest.raises(ValueError):
            P.datagen.scenario("customer", rows=5, rate_rows_s=0.0,
                               clock=P.ManualClock())

    def test_unknown_scenario(self, P):
        with pytest.raises(KeyError, match="unknown scenario"):
            P.datagen.scenario("nope")
        assert P.datagen.scenarios() == [
            "bank", "customer", "equipment", "kitchen-sink"]


# -- the extended sources, once per package -----------------------------------


def _sqlite():
    conn = sqlite3.connect(":memory:")
    conn.execute("CREATE TABLE t (id INTEGER, city TEXT, n INTEGER, "
                 "r REAL, ok BOOLEAN)")
    rng = np.random.default_rng(21)
    rows = [(i, f"c{int(rng.integers(0, 9))}", int(rng.integers(-50, 50)),
             round(float(rng.random() * 10), 4), int(rng.random() < 0.5))
            for i in range(700)]
    conn.executemany("INSERT INTO t VALUES (?, ?, ?, ?, ?)", rows)
    return conn, rows


_SQL_TYPES = {"n": "int", "r": "real", "ok": "bool", "city": "text"}


class TestExtendedSources:
    def test_sql_source_schema_and_records(self, P):
        conn, rows = _sqlite()
        src = P.ext.SQLSource(conn, "SELECT * FROM t", types=_SQL_TYPES,
                              batch_rows=64)
        assert [n for n, _ in src.schema()] == ["city", "n", "r", "ok"]
        assert src.id_column() == "id"
        got = list(src.records())
        assert got == [dict(zip(["id", "city", "n", "r", "ok"], r))
                       for r in rows]

    def test_sql_source_loads(self, P):
        conn, rows = _sqlite()
        api = P.API()
        src = P.ext.SQLSource(conn, "SELECT * FROM t", types=_SQL_TYPES)
        assert P.ingest.Ingester(api, "sq", src, batch_size=100).run() == 700
        assert api.query("sq", "Count(Row(city=c3))")[0] == \
            sum(1 for r in rows if r[1] == "c3")
        assert api.query("sq", "Sum(field=n)")[0].val == \
            sum(r[2] for r in rows)

    def test_kinesis_source_with_a_stub_client(self, P):
        class Stub:
            def __init__(self):
                self.data = {"s0": [{"id": 1, "color": ["a"]},
                                    {"id": 2, "color": ["b"]}],
                             "s1": [{"id": 3, "color": ["a"]}]}

            def describe_stream(self, StreamName):
                return {"StreamDescription": {"Shards": [
                    {"ShardId": k} for k in sorted(self.data)]}}

            def get_shard_iterator(self, StreamName, ShardId,
                                   ShardIteratorType):
                return {"ShardIterator": (ShardId, 0)}

            def get_records(self, ShardIterator):
                shard, i = ShardIterator
                recs = self.data[shard][i:i + 1]
                return {"Records": [{"Data": json.dumps(r).encode()}
                                    for r in recs],
                        "NextShardIterator": (shard, i + 1)}

        schema = [("color", P.FO(type=P.FT.SET, keys=True))]
        src = P.ext.KinesisSource("s", client=Stub(), schema=schema)
        api = P.API()
        assert P.ingest.Ingester(api, "kin", src).run() == 3
        assert api.query("kin", "Count(Row(color=a))")[0] == 2

    def test_kinesis_without_a_client_or_boto3(self, P, monkeypatch):
        real = builtins.__import__

        def deny(name, *a, **k):
            if name == "boto3":
                raise ImportError(name)
            return real(name, *a, **k)

        monkeypatch.setattr(builtins, "__import__", deny)
        with pytest.raises(RuntimeError, match="injected client"):
            P.ext.KinesisSource("s")

    def test_avro_decode_and_source(self, P):
        schema, payloads, records = _avro_payloads(40)
        for p, rec in zip(payloads, records):
            assert P.ext.avro_decode(schema, p[5:]) == rec
        src = P.ext.AvroSource(payloads, {7: json.dumps(schema)})
        assert [n for n, _ in src.schema()] == \
            ["city", "tags", "n", "score", "ok", "note"]
        assert list(src.records()) == records
        with pytest.raises(ValueError, match="magic"):
            list(P.ext.AvroSource([b"\x01" + payloads[0][1:]],
                                  {7: schema}).records())
        with pytest.raises(ValueError, match="record"):
            P.ext.avro_decode({"type": "array"}, b"")


# -- Avro payloads ------------------------------------------------------------

_AVRO_SCHEMA = {"type": "record", "name": "r", "fields": [
    {"name": "id", "type": "long"},
    {"name": "city", "type": "string"},
    {"name": "tags", "type": {"type": "array", "items": "string"}},
    {"name": "n", "type": ["null", "int"]},
    {"name": "score", "type": "double"},
    {"name": "ok", "type": "boolean"},
    {"name": "note", "type": ["null", "string"]},
]}


def _zz(n: int) -> bytes:
    n = (n << 1) ^ (n >> 63)
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _avro_str(s: str) -> bytes:
    raw = s.encode()
    return _zz(len(raw)) + raw


def _avro_payloads(n: int):
    rng = np.random.default_rng(33)
    payloads, records = [], []
    for i in range(n):
        city = f"c{int(rng.integers(0, 5))}"
        tags = [f"t{int(x)}" for x in rng.integers(0, 6,
                                                   int(rng.integers(0, 3)))]
        num = None if rng.random() < 0.2 else int(rng.integers(-300, 300))
        score = float(rng.random())
        ok = bool(rng.random() < 0.5)
        body = _zz(i) + _avro_str(city)
        if tags:
            body += _zz(len(tags)) + b"".join(_avro_str(t) for t in tags)
        body += _zz(0)
        body += _zz(0) if num is None else _zz(1) + _zz(num)
        body += struct.pack("<d", score) + bytes([ok]) + _zz(0)
        payloads.append(b"\x00" + (7).to_bytes(4, "big") + body)
        records.append({"id": i, "city": city, "tags": tags, "n": num,
                        "score": score, "ok": ok, "note": None})
    return _AVRO_SCHEMA, payloads, records


# -- the two packages on the same cells ---------------------------------------

_HEADERS = [
    ["id", "name__S", "age__I", "tags__SS", "ok__B", "price__F2"],
    ["ids__IS", "one__ID", "t__T", "d__F", "d4__F4", "plain"],
    ["x__S", "__I", "a__b__SS"],
]


@pytest.mark.parametrize("cells", _HEADERS, ids=["typed", "unkeyed", "odd"])
def test_parse_header_matches(cells):
    ours = _pkg(TORCH).source._parse_header(cells)
    theirs = _pkg(JAX).source._parse_header(cells)
    assert [(n, _opts(o)) for n, o in ours] == \
        [(n, _opts(o)) for n, o in theirs]


def test_parse_header_rejects_unknown_suffix():
    for root in (JAX, TORCH):
        with pytest.raises(ValueError, match="unknown type suffix"):
            _pkg(root).source._parse_header(["a__Q"])


_CELLS = ["", "0", "17", "-3", "1;2;", "true", " yes ", "T", "no", "2.5",
          "x", ";", "2023-01-02T03:04:05"]


@pytest.mark.parametrize("header", ["a__I", "a__F2", "a__B", "a__T", "a__SS",
                                    "a__IS", "a__ID", "a__S", "a"])
def test_coerce_matches(header):
    (_, o_t), = _pkg(TORCH).source._parse_header([header])
    (_, o_j), = _pkg(JAX).source._parse_header([header])

    def run(mod, o, cell):
        try:
            return ("ok", mod._coerce(cell, o))
        except ValueError as e:
            return ("err", type(e).__name__)

    for cell in _CELLS:
        assert run(_pkg(TORCH).source, o_t, cell) == \
            run(_pkg(JAX).source, o_j, cell), cell


_COLUMNS = {
    "ints": ("a__I", ["1", "-2", "30"]),
    "ints_missing": ("a__I", ["1", "", "30"]),
    "decimals": ("a__F2", ["1.5", "", "-0.25"]),
    "id_set_lists": ("a__IS", ["1;2", "3", ""]),
    "id_mutex": ("a__ID", ["4", "5", "6"]),
    "bools": ("a__B", [" true", "false ", "TRUE", "", "  ", "1", "no"]),
    "keyed": ("a__S", ["x", "y", ""]),
    "timestamps": ("a__T", ["2023-01-01", ""]),
    "junk": ("a__I", ["1", "x"]),
}


@pytest.mark.parametrize("case", sorted(_COLUMNS))
def test_coerce_column_matches(case):
    header, cells = _COLUMNS[case]
    got = {}
    for root in (JAX, TORCH):
        src = _pkg(root).source
        (_, o), = src._parse_header([header])
        vals, valid = src.coerce_column(cells, o)
        got[root] = (None if vals is None else (vals.dtype.str,
                                                vals.tolist()),
                     None if valid is None else valid.tolist())
    assert got[TORCH] == got[JAX]


_TEXTS = {
    "plain": "id,a__I,b__S\n1,10,x\n2,20,y\n",
    "crlf": "id,a__I\r\n1,10\r\n2,20\r\n",
    "trailing_semicolons": "id,tags__IS\n1,5;6;\n2,;7\n3,\n",
    "ragged": "id,a__I,b__I\n1,10,20\n2,30\n3,40,50,60\n4,70,80\n",
    "bool_whitespace": "id,ok__B\n1, true\n2,false \n3,TRUE\n",
    "quoted": 'id,name__S\n1,"a,b"\n2,"c"\n',
    "blank_line": "id,a__I\n1,10\n\n2,20\n",
    "header_only": "id,a__I\n",
    "no_newline": "id,a__I\n1,10",
}


@pytest.mark.parametrize("case", sorted(_TEXTS))
def test_csv_columns_and_records_match(case):
    text = _TEXTS[case]
    cols, recs = {}, {}
    for root in (JAX, TORCH):
        S = _pkg(root).source
        n, c = S.CSVSource(text, inline=True).columns()
        cols[root] = (n, {k: (_opts(o), list(v)) for k, (o, v) in c.items()})
        src = S.CSVSource(text, inline=True)
        recs[root] = (list(src.records()),
                      [(k, _opts(o)) for k, o in src.schema()],
                      src.id_column())
    assert cols[TORCH] == cols[JAX]
    assert recs[TORCH] == recs[JAX]


@pytest.mark.parametrize("name", ["bank", "customer", "equipment",
                                  "kitchen-sink"])
def test_datagen_scenarios_give_the_same_records(name):
    src_t = _pkg(TORCH).datagen.scenario(name, rows=300, seed=4)
    src_j = _pkg(JAX).datagen.scenario(name, rows=300, seed=4)
    assert list(src_t.records()) == list(src_j.records())
    assert [(n, _opts(o)) for n, o in src_t.schema()] == \
        [(n, _opts(o)) for n, o in src_j.schema()]
    assert src_t.id_column() == src_j.id_column() == "id"


# -- the two packages on the same loads ---------------------------------------

_SCENARIO_QUERIES = {
    "customer": ["Count(Row(city=nyc))", "Count(Row(hobbies=golf))",
                 "Sum(field=ltv)", "Count(Row(age > 60))",
                 "Count(Row(active=true))", "TopN(segment, n=3)",
                 "GroupBy(Rows(city), Rows(segment), limit=12)"],
    "bank": ["Count(Row(category=travel))", "Sum(field=amount_cents)",
             "Min(field=amount_cents)", "Count(Row(flagged=true))",
             "TopN(merchant, n=5)"],
    "equipment": ["Count(Row(type=pump))", "Max(field=temp_c)",
                  "Sum(Row(site=site07), field=uptime_h)",
                  "GroupBy(Rows(type), limit=10)"],
    "kitchen-sink": ["Count(Row(a_mutex=v3))", "Count(Row(an_idset=7))",
                     "Count(Row(a_stringset=s5))", "Count(Row(an_int > 0))",
                     "Sum(field=an_int)", "Sum(field=a_decimal)",
                     "Count(Row(a_bool=true))", "TopN(an_idset, n=5)"],
}


@pytest.mark.parametrize("name", sorted(_SCENARIO_QUERIES))
def test_datagen_loads_match(name):
    def load(P, api):
        src = P.datagen.scenario(name, rows=1500, seed=2)
        return P.ingest.Ingester(api, "g", src, batch_size=512).run()

    _both(load, _SCENARIO_QUERIES[name], "g")


_CSV_QUERIES = ["Count(Row(city=3))", "Count(Row(dev=1))",
                "Count(Row(name=u2))", "Count(Row(tags=t1))",
                "Count(Row(age > 500))", "Sum(field=age)",
                "Max(field=price)", "Count(Row(ok=true))",
                "GroupBy(Rows(city), Rows(dev), limit=50)",
                "TopN(name, n=3)"]


def _csv_text(n=2000, shard=0):
    rng = np.random.default_rng(8)
    lines = ["id,city__IS,dev__ID,age__I,name__S,tags__SS,ok__B,price__F2"]
    for i in range(n):
        tags = ";".join(f"t{int(x)}" for x in
                        rng.integers(0, 4, int(rng.integers(0, 3))))
        price = "" if rng.random() < 0.1 else f"{rng.random() * 50:.2f}"
        lines.append(
            f"{shard * SHARD_WIDTH + i * 3},{int(rng.integers(0, 7))},"
            f"{int(rng.integers(0, 3))},{int(rng.integers(0, 900))},"
            f"u{int(rng.integers(0, 5))},{tags},"
            f"{'true' if rng.random() < 0.5 else 'false'},{price}")
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("path", ["columnar", "per_record"])
def test_csv_loads_match(path):
    text = _csv_text() + _csv_text(300, shard=2).split("\n", 1)[1]

    def load(P, api):
        src = P.source.CSVSource(text, inline=True)
        ing = P.ingest.Ingester(api, "c", src, batch_size=256)
        if path == "per_record":
            ing.source = type("S", (), {
                "schema": src.schema, "records": src.records,
                "id_column": src.id_column})()
        return ing.run()

    _both(load, _CSV_QUERIES, "c")


def test_columnar_and_per_record_checksums_equal():
    text = _csv_text(800)
    P = _pkg(TORCH)
    a1, a2 = P.API(), P.API()
    P.ingest.Ingester(a1, "c", P.source.CSVSource(text, inline=True)).run()
    src = P.source.CSVSource(text, inline=True)
    ing = P.ingest.Ingester(a2, "c", src, batch_size=100)
    ing.source = type("S", (), {"schema": src.schema,
                                "records": src.records,
                                "id_column": src.id_column})()
    ing.run()
    assert a1.checksum() == a2.checksum()


def test_batch_loads_match():
    rng = np.random.default_rng(12)
    recs = [{"id": int(c), "color": [f"k{int(x)}" for x in
                                     rng.integers(0, 6, 2)],
             "size": f"s{int(rng.integers(0, 3))}",
             "age": int(rng.integers(-40, 90)),
             "active": bool(rng.random() < 0.3)}
            for c in rng.choice(3 * SHARD_WIDTH, 900, replace=False)]

    def load(P, api):
        api.create_index("i")
        idx = api.holder.index("i")
        idx.create_field("color", P.FO(type=P.FT.SET, keys=True))
        idx.create_field("size", P.FO(type=P.FT.MUTEX, keys=True))
        idx.create_field("age", P.FO(type=P.FT.INT))
        idx.create_field("active", P.FO(type=P.FT.BOOL))
        b = P.batch.Batch(api, "i", size=128)
        flushes = sum(b.add(dict(r)) for r in recs)
        b.flush()
        return flushes, b.imported

    _both(load, ["Count(Row(color=k1))", "TopN(color, n=6)",
                 "Count(Row(size=s2))", "Sum(field=age)",
                 "Count(Row(active=true))", "Count(All())",
                 "GroupBy(Rows(size), Rows(active))"], "i")


def test_keyed_index_and_auto_id_loads_match():
    def load(P, api):
        schema = [("color", P.FO(type=P.FT.SET, keys=True)),
                  ("n", P.FO(type=P.FT.INT))]
        keyed = P.source.ListSource(
            schema, [{"id": f"user{i % 37}", "color": [f"c{i % 4}"],
                      "n": i} for i in range(200)])
        P.ingest.Ingester(api, "k", keyed, batch_size=64, keys=True).run()
        auto = P.source.ListSource(
            schema, [{"color": [f"c{i % 3}"], "n": -i} for i in range(150)],
            id_col=None)
        P.ingest.Ingester(api, "a", auto, batch_size=40).run()
        csv = P.source.CSVSource(
            "id,city__S\nu1,x\nu2,y\nu1,z\n", inline=True)
        P.ingest.Ingester(api, "kc", csv, keys=True).run()
        return [api.query("a", "Count(Row(color=c1))")[0],
                sorted(api.query("kc", "Row(city=z)")[0].keys)]

    _both(load, ["Count(Row(color=c2))", "Sum(field=n)", "Count(All())"],
          "k")


def test_sql_and_avro_loads_match():
    def load(P, api):
        conn, _ = _sqlite()
        P.ingest.Ingester(api, "sq", P.ext.SQLSource(
            conn, "SELECT * FROM t", types=_SQL_TYPES), batch_size=128).run()
        schema, payloads, _ = _avro_payloads(60)
        P.ingest.Ingester(api, "av", P.ext.AvroSource(
            payloads, {7: schema}), batch_size=16).run()
        return [api.query("av", "Count(Row(tags=t2))")[0],
                api.query("av", "Sum(field=n)")[0].val,
                api.query("av", "Count(Row(ok=true))")[0]]

    _both(load, ["Count(Row(city=c3))", "Sum(field=n)", "Max(field=r)",
                 "Count(Row(ok=true))", "TopN(city, n=4)"], "sq")
