"""The port's storage modules, held against the JAX package's.

Every test runs once per package: the ``P`` fixture yields the storage
modules of ``pilosa_tpu`` or of ``pilosa_tpu_torch`` and an ``API``
factory (the port's on the CPU), and the body is the same. Covered: the
WAL cases of ``tests/test_wal.py`` (``TestWALFraming``) and
``tests/test_recovery.py`` (segments, LSNs, legacy adoption, torn tails
against markers, ``repair``, ``tail_bytes`` / ``iter_frames``, record
filtering, checkpoint metadata), the roaring codec cases of
``tests/test_roaring.py``, the crash plan's seeds, the
``[storage.recovery]`` config section (``tests/test_recovery.py``
``TestRecoveryConfig``), the ID allocator (``tests/test_ingest.py``) and
the transaction manager (``tests/test_ops_aux.py``). Then the bytes
cross packages: a WAL written by either replays in the other to equal
records and LSNs, a roaring blob encodes to the same bytes and decodes
in the other, and an npz snapshot or a shard's arrays written by either
load in the other to equal planes. Tolerance is exact throughout.
"""

import importlib
import os
import pickle
import struct
import types
import zlib

import numpy as np
import pytest

SHARD_WIDTH = 1 << 20


def _load(root: str) -> types.SimpleNamespace:
    m = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    api_mod = m("api")
    recovery = m("storage.recovery")
    kw = {"device": "cpu"} if root == "pilosa_tpu_torch" else {}

    def make_api(path=None, **more):
        return api_mod.API(path, **more, **kw)

    return types.SimpleNamespace(
        root=root,
        wal=m("storage.wal"),
        WAL=m("storage.wal").WAL,
        iter_frames=m("storage.wal").iter_frames,
        R=m("storage.roaring"),
        rec=recovery,
        store=m("storage.store"),
        API=make_api,
        Config=m("config").Config,
        IDAllocator=m("ingest.idalloc").IDAllocator,
        txn=m("transaction"),
    )


_PACKAGES = {}


def _pkg(root: str) -> types.SimpleNamespace:
    if root not in _PACKAGES:
        _PACKAGES[root] = _load(root)
    return _PACKAGES[root]


@pytest.fixture(params=["pilosa_tpu", "pilosa_tpu_torch"],
                ids=["jax", "torch"])
def P(request):
    return _pkg(request.param)


# -- WAL framing (tests/test_wal.py TestWALFraming) ---------------------------


class TestWALFraming:
    def test_roundtrip_and_torn_tail(self, P, tmp_path):
        w = P.WAL(str(tmp_path / "x" / "wal.log"), sync="never")
        recs = [("a", 1), ("b", [1, 2, 3]), ("c", {"k": "v"})]
        for r in recs:
            w.append(r)
        w.flush()
        assert list(w.records()) == recs
        with open(w.path, "ab") as f:  # torn tail: a half record
            f.write(b"\x01\x02\x03")
        assert list(w.records()) == recs
        data = open(w.path, "rb").read()  # corrupt a middle record
        with open(w.path, "wb") as f:
            f.write(data[:10] + b"\xff" + data[11:])
        assert list(w.records()) == []
        w.close()

    def test_truncate(self, P, tmp_path):
        w = P.WAL(str(tmp_path / "wal.log"), sync="never")
        w.append(("x",))
        w.truncate()
        w.append(("y",))
        w.flush()
        assert list(w.records()) == [("y",)]
        w.close()

    def test_bad_sync_mode(self, P, tmp_path):
        with pytest.raises(ValueError):
            P.WAL(str(tmp_path / "wal.log"), sync="sometimes")


# -- segmented WAL (tests/test_recovery.py TestSegmentedWAL) -----------------


def _legacy_log(path, recs, torn=b""):
    with open(path, "wb") as f:
        for rec in recs:
            payload = pickle.dumps(rec, protocol=5)
            f.write(struct.pack("<II", zlib.crc32(payload), len(payload))
                    + payload)
        f.write(torn)


class TestSegmentedWAL:
    def test_rotation_produces_numbered_segments(self, P, tmp_path):
        w = P.WAL(str(tmp_path / "wal.log"), segment_bytes=64)
        lsns = [w.append(("set_bit", "f", "", i, i)) for i in range(8)]
        w.flush()
        assert lsns == sorted(lsns) and len(set(lsns)) == 8
        segs = sorted(p.name for p in tmp_path.iterdir()
                      if p.name.startswith("wal.log."))
        assert len(segs) > 1 and segs[0] == "wal.log.00000001"
        assert list(w.records()) == [("set_bit", "f", "", i, i)
                                     for i in range(8)]
        w.close()

    def test_lsn_survives_reopen_and_truncate(self, P, tmp_path):
        p = str(tmp_path / "wal.log")
        w = P.WAL(p, segment_bytes=64)
        for i in range(5):
            w.append(("set_bit", "f", "", 0, i))
        w.flush()
        top = w.last_lsn
        w.close()
        w2 = P.WAL(p, segment_bytes=64)
        assert w2.last_lsn == top
        old = {int(q.name.rsplit(".", 1)[1]) for q in tmp_path.iterdir()}
        w2.truncate()
        assert w2.last_lsn == top  # the counter never resets
        new = {int(q.name.rsplit(".", 1)[1]) for q in tmp_path.iterdir()}
        assert min(new) > max(old)
        assert w2.append(("set_bit", "f", "", 0, 9)) == top + 1
        w2.close()

    def test_prune_drops_only_wholly_covered_segments(self, P, tmp_path):
        w = P.WAL(str(tmp_path / "wal.log"), segment_bytes=64)
        lsns = [w.append(("set_bit", "f", "", 0, i)) for i in range(9)]
        w.flush()
        assert len(list(tmp_path.iterdir())) > 2
        mid = lsns[4]
        w.prune(mid)
        assert [lsn for lsn, _r, _n in w.replay(after_lsn=mid)] == lsns[5:]
        w.prune(w.last_lsn)
        assert w.record_bytes == 0 and list(w.records()) == []
        w.close()

    def test_legacy_single_file_adopted_as_segment(self, P, tmp_path):
        p = str(tmp_path / "wal.log")
        w = P.WAL(p)
        w.append(("set_bit", "f", "", 1, 2))
        w.flush()
        w.close()
        os.rename(w.path, p)  # a pre-segmentation install: one bare file
        w2 = P.WAL(p)
        assert list(w2.records()) == [("set_bit", "f", "", 1, 2)]
        assert not os.path.exists(p)
        w2.close()

    def test_legacy_ii_framed_log_converted_not_truncated(self, P, tmp_path):
        recs = [("set_bit", "f", "", r, r + 1) for r in range(5)]
        p = str(tmp_path / "wal.log")
        _legacy_log(p, recs)
        w = P.WAL(p)
        assert not os.path.exists(p)
        assert list(w.records()) == recs
        assert [lsn for lsn, _r, _n in w.replay(0)] == [1, 2, 3, 4, 5]
        w.repair()  # a no-op: the converted segment is intact
        assert list(w.records()) == recs
        assert w.append(("set_bit", "f", "", 9, 9)) == 6
        w.flush()
        w.close()
        w2 = P.WAL(p)
        assert len(list(w2.records())) == 6
        w2.close()

    def test_legacy_log_torn_tail_keeps_intact_prefix(self, P, tmp_path):
        recs = [("set_bit", "f", "", r, r) for r in range(3)]
        p = str(tmp_path / "wal.log")
        _legacy_log(p, recs, torn=b"\x01\x02\x03")
        w = P.WAL(p)
        assert list(w.records()) == recs
        w.close()


class TestTornTailVsMarker:
    def test_byte_exact_torn_tail_drops_only_last_write(self, P, tmp_path):
        recs = [("set_bit", "f", "", 0, 1), ("import_bits", "f", [1], [9])]
        p = str(tmp_path / "wal.log")
        w = P.WAL(p)
        w.append(recs[0])
        w.flush()
        size_first = os.path.getsize(w.path)
        w.append(recs[1])
        w.flush()
        active = w.path
        w.close()
        blob = open(active, "rb").read()
        for cut in range(size_first, len(blob)):  # every torn byte count
            with open(active, "wb") as f:
                f.write(blob[:cut])
            w2 = P.WAL(p)
            assert list(w2.records()) == recs[:1], f"cut at {cut} bytes"
            w2.close()
        with open(active, "wb") as f:
            f.write(blob)
        w3 = P.WAL(p)
        assert list(w3.records()) == recs
        w3.close()

    def test_segment_markers_do_not_stop_replay(self, P, tmp_path):
        w = P.WAL(str(tmp_path / "wal.log"), segment_bytes=1)
        recs = [("set_bit", "f", "", 0, i) for i in range(4)]
        for r in recs:
            w.append(r)
        w.flush()
        assert len(list(tmp_path.iterdir())) >= 4
        assert list(w.records()) == recs
        w.close()

    def test_corrupt_interior_byte_stops_at_tear(self, P, tmp_path):
        w = P.WAL(str(tmp_path / "wal.log"))
        w.append(("set_bit", "f", "", 0, 1))
        w.append(("set_bit", "f", "", 0, 2))
        w.flush()
        active = w.path
        w.close()
        with open(active, "r+b") as f:
            f.seek(20)  # inside the first record's frame, after the marker
            b = f.read(1)
            f.seek(20)
            f.write(bytes([b[0] ^ 0xFF]))
        assert list(P.WAL(str(tmp_path / "wal.log")).records()) == []

    def test_repair_truncates_to_valid_prefix(self, P, tmp_path):
        p = str(tmp_path / "wal.log")
        w = P.WAL(p)
        w.append(("set_bit", "f", "", 0, 1))
        w.flush()
        good = os.path.getsize(w.path)
        active = w.path
        w.close()
        with open(active, "ab") as f:
            f.write(b"\x01\x02\x03")
        w2 = P.WAL(p)
        w2.repair()
        assert os.path.getsize(active) == good
        assert list(w2.records()) == [("set_bit", "f", "", 0, 1)]
        w2.close()

    def test_flush_lag_and_sizes(self, P, tmp_path):
        w = P.WAL(str(tmp_path / "wal.log"))
        assert w.flush_lag_s() == 0.0 and w.record_bytes == 0
        w.append(("set_bit", "f", "", 0, 1))
        assert w.flush_lag_s() >= 0.0 and w.record_bytes > 0
        w.flush()
        assert w.flush_lag_s() == 0.0
        assert w.size == w.valid_prefix() == w.record_bytes + 16
        w.close()


class TestTailShipping:
    def test_tail_bytes_round_trips_through_iter_frames(self, P, tmp_path):
        w = P.WAL(str(tmp_path / "wal.log"), segment_bytes=96)
        recs = [("import_bits", "f", [i], [i * 3]) for i in range(6)]
        lsns = [w.append(r) for r in recs]
        w.flush()
        data, last, more = w.tail_bytes(0)
        assert not more and last == lsns[-1]
        assert [r for _lsn, r in P.iter_frames(data)] == recs
        data2, last2, _ = w.tail_bytes(lsns[2])
        assert [r for _l, r in P.iter_frames(data2)] == recs[3:]
        assert last2 == lsns[-1]
        w.close()

    def test_tail_bytes_paginates(self, P, tmp_path):
        w = P.WAL(str(tmp_path / "wal.log"), segment_bytes=96)
        recs = [("import_bits", "f", [i], [i]) for i in range(6)]
        for r in recs:
            w.append(r)
        w.flush()
        got, since, rounds = [], 0, 0
        while True:
            data, last, more = w.tail_bytes(since, max_bytes=64)
            got.extend(r for _l, r in P.iter_frames(data))
            rounds += 1
            since = last
            if not more:
                break
        assert got == recs and rounds > 1
        w.close()

    def test_iter_frames_rejects_corrupt_stream(self, P):
        with pytest.raises(ValueError):
            list(P.iter_frames(b"\x00" * 20))


class TestAppendHook:
    def test_hook_sees_framed_bytes(self, P, tmp_path):
        seen = []
        P.wal.set_append_hook(seen.append)
        try:
            w = P.WAL(str(tmp_path / "wal.log"))
            w.append(("set_bit", "f", "", 0, 1))
            w.close()
        finally:
            P.wal.set_append_hook(None)
        payload = pickle.dumps(("set_bit", "f", "", 0, 1), protocol=5)
        assert seen == [16 + len(payload)]

    def test_pack_plane_round_trip(self, P):
        plane = np.random.default_rng(3).integers(
            0, 1 << 32, 1000, dtype=np.uint32)
        out = P.wal.unpack_plane(P.wal.pack_plane(plane), 1000)
        assert out.dtype == np.uint32 and np.array_equal(out, plane)


# -- record filtering and checkpoint metadata --------------------------------


class TestRecordFiltering:
    def test_record_shards(self, P):
        W, rs = SHARD_WIDTH, P.rec.record_shards
        assert rs(("set_bit", "f", 3, W + 1, None), W) == {1}
        assert rs(("clear_bit", "f", 3, 2 * W), W) == {2}
        assert rs(("import_bits", "f", [1, 2], [0, 2 * W]), W) == {0, 2}
        assert rs(("set_values", "f", [0, W], [7, 8]), W) == {0, 1}
        assert rs(("row_plane", "f", b"", 5), W) == {5}
        assert rs(("clear_value", "f", W + 3), W) == {1}
        assert rs(("df_changeset", "t", 2, {}), W) == {2}
        assert rs(("delete_field", "f"), W) is None

    def test_filter_record_subsets_pairwise(self, P):
        W, fr = SHARD_WIDTH, P.rec.filter_record
        rec = ("import_bits", "f", [1, 2, 3], [0, W, 2 * W])
        assert fr(rec, lambda s: s == 1, W) == ("import_bits", "f", [2], [W])
        rec2 = ("set_values", "f", [0, W], [7, 8])
        assert fr(rec2, lambda s: s == 0, W) == ("set_values", "f", [0], [7])
        assert fr(rec, lambda s: s == 9, W) is None
        assert fr(("clear_row", "f", "", 3), lambda s: False, W) \
            == ("clear_row", "f", "", 3)


class TestCheckpointMeta:
    def test_roundtrip_and_missing(self, P, tmp_path):
        rd, wr = P.rec.read_checkpoint_meta, P.rec.write_checkpoint_meta
        assert rd(str(tmp_path)) == 0 and rd(None) == 0
        wr(str(tmp_path), 42)
        assert rd(str(tmp_path)) == 42
        wr(str(tmp_path), 43, stream_offsets={"g": {"t:0": 5}})
        assert rd(str(tmp_path)) == 43
        assert P.rec.read_checkpoint_offsets(str(tmp_path)) \
            == {"g": {"t:0": 5}}

    def test_checkpoint_stamps_lsn_and_prunes(self, P, tmp_path):
        api = P.API(str(tmp_path))
        api.create_index("i")
        api.create_field("i", "f")
        api.import_bits("i", "f", rows=[0, 1], cols=[3, 9])
        idx = api.holder.index("i")
        assert idx.wal.record_bytes > 0
        api.save()
        assert idx.wal.record_bytes == 0
        ipath = api.holder._index_path("i")
        assert os.path.isfile(os.path.join(ipath, P.rec.CHECKPOINT_META))
        assert P.rec.read_checkpoint_meta(ipath) == idx.wal.last_lsn

    def test_recovery_replays_only_above_checkpoint(self, P, tmp_path):
        api = P.API(str(tmp_path))
        api.create_index("i")
        api.create_field("i", "f")
        api.import_bits("i", "f", rows=[0], cols=[1])
        api.save()
        api.import_bits("i", "f", rows=[1], cols=[2])
        want = api.checksum()
        api.holder.flush_wals()
        del api
        api2 = P.API(str(tmp_path))
        assert api2.checksum() == want
        assert api2.query("i", "Row(f=1)")[0].columns == [2]


# -- crash plans --------------------------------------------------------------


class TestCrashPlan:
    def test_dead_plan_noops_instead_of_rearming(self, P):
        plan = P.rec.CrashPlan().kill("wal.append", at=1)
        with pytest.raises(P.rec.SimulatedCrash):
            plan.fire("wal.append")
        assert plan.dead and plan.fired == ("wal.append", 1)
        assert plan.fire("wal.append") is False
        assert plan.fire("wal.flush") is False

    def test_from_env_parses(self, P, monkeypatch):
        monkeypatch.delenv("PILOSA_TPU_CRASH_SEED", raising=False)
        assert P.rec.CrashPlan.from_env() is None
        monkeypatch.setenv("PILOSA_TPU_CRASH_SEED", "7")
        plan = P.rec.CrashPlan.from_env()
        assert plan._arms == P.rec.CrashPlan.seeded("7")._arms

    def test_bad_site_and_hit(self, P):
        with pytest.raises(ValueError):
            P.rec.CrashPlan().kill("nowhere")
        with pytest.raises(ValueError):
            P.rec.CrashPlan().kill("wal.flush", at=0)

    @pytest.mark.parametrize("seed", [0, 1, 7, 11, "lane-default"])
    def test_seeds_pick_the_same_site_in_both_packages(self, seed):
        ours = _pkg("pilosa_tpu_torch").rec
        theirs = _pkg("pilosa_tpu").rec
        assert ours.CRASH_SITES == theirs.CRASH_SITES
        assert ours.CrashPlan.seeded(seed)._arms \
            == theirs.CrashPlan.seeded(seed)._arms
        assert ours.crash_workload(8, seed=seed) \
            == theirs.crash_workload(8, seed=seed)


# -- config, ID allocation, transactions --------------------------------------


class TestStorageConfig:
    def test_toml_section_and_env_override(self, P, tmp_path):
        cfg_file = tmp_path / "pt.toml"
        cfg_file.write_text(
            'data-dir = "/data"\nwal-sync = "always"\n'
            "[storage.recovery]\n"
            "segment-bytes = 8192\n"
            "checkpoint-interval-bytes = 4096\n"
            "catchup-batch-bytes = 2048\n")
        cfg = P.Config.from_sources(toml_path=str(cfg_file), env={})
        assert (cfg.data_dir, cfg.wal_sync) == ("/data", "always")
        assert cfg.storage_recovery_segment_bytes == 8192
        assert cfg.storage_recovery_checkpoint_interval_bytes == 4096
        assert cfg.storage_recovery_catchup_batch_bytes == 2048
        cfg2 = P.Config.from_sources(
            toml_path=str(cfg_file),
            env={"PILOSA_TPU_STORAGE_RECOVERY_SEGMENT_BYTES": "123",
                 "PILOSA_TPU_CHECKPOINT_BYTES": "77"})
        assert cfg2.storage_recovery_segment_bytes == 123
        assert cfg2.checkpoint_bytes == 77
        assert cfg2.storage_recovery_checkpoint_interval_bytes == 4096

    def test_defaults_agree(self):
        ours = _pkg("pilosa_tpu_torch").Config()
        theirs = _pkg("pilosa_tpu").Config()
        for name in ("data_dir", "wal_sync", "checkpoint_bytes",
                     "storage_recovery_segment_bytes",
                     "storage_recovery_checkpoint_interval_bytes",
                     "storage_recovery_catchup_batch_bytes"):
            assert getattr(ours, name) == getattr(theirs, name), name


class TestIDAllocator:
    def test_sessions_and_reload(self, P, tmp_path):
        path = str(tmp_path / "ids.journal")
        a = P.IDAllocator(path)
        r1 = a.reserve("s1", 100, offset=0)
        assert (r1.base, r1.count) == (1, 100)
        assert a.reserve("s1", 100, offset=0).base == r1.base
        r2 = a.reserve("s2", 10, offset=0)
        assert r2.base == r1.end
        a.commit("s1")
        assert P.IDAllocator(path).reserve("s3", 5).base >= r2.end
        with pytest.raises(ValueError):
            a.reserve("s4", 0)

    def test_commit_tail_survives_reload(self, P, tmp_path):
        path = str(tmp_path / "ids.jsonl")
        a = P.IDAllocator(path)
        r = a.reserve("s", 1000)
        a.commit("s", count=10)
        assert P.IDAllocator(path).next_id == a.next_id == r.base + 10
        a.reset("never-reserved")
        assert a.reserve("t", 5).to_json() == {"base": r.base + 10,
                                               "count": 5}


class TestTransactions:
    def test_exclusive_blocks_others(self, P):
        tm = P.txn.TransactionManager()
        t1 = tm.start("a")
        assert t1.active and not t1.exclusive
        tex = tm.start("x", exclusive=True)
        assert not tex.active  # pending until alone
        with pytest.raises(P.txn.TransactionError):
            tm.start("b")
        tm.finish("a")
        assert tm.get("x").active and tm.exclusive_active()
        assert tm.get("x").to_json()["exclusive"] is True
        tm.finish("x")
        assert tm.list() == []

    def test_deadline_expiry_and_remote_sync(self, P):
        tm = P.txn.TransactionManager()
        tm.start("t", timeout_s=-1)  # already expired
        with pytest.raises(P.txn.TransactionError):
            tm.get("t")
        seen = []
        tm.on_change = lambda action, tx: seen.append((action, tx.id))
        tm.start("u")
        tm.finish("u")
        assert seen == [("start", "u"), ("finish", "u")]
        tm.apply_remote("start", {"id": "r", "active": True,
                                  "exclusive": False})
        assert [t.id for t in tm.list()] == ["r"] and len(seen) == 2
        with pytest.raises(P.txn.TransactionError):
            tm.apply_remote("bogus", {"id": "r"})


# -- roaring (tests/test_roaring.py) ------------------------------------------


def _fixture(R, containers):
    """A pilosa-roaring blob built straight from the spec."""
    n = len(containers)
    out = [struct.pack("<II", R.MAGIC, n)]
    headers, bodies = [], []
    for key, typ, vals in containers:
        if typ == R.TYPE_ARRAY:
            body = np.asarray(vals, "<u2").tobytes()
            card = len(vals)
        elif typ == R.TYPE_BITMAP:
            bits = np.zeros(1 << 16, np.uint8)
            bits[np.asarray(vals)] = 1
            body = np.packbits(bits, bitorder="little").tobytes()
            card = len(vals)
        else:
            body = struct.pack("<H", len(vals)) + b"".join(
                struct.pack("<HH", a, b) for a, b in vals)
            card = sum(b - a + 1 for a, b in vals)
        headers.append(struct.pack("<QHH", key, typ, card - 1))
        bodies.append(body)
    out.extend(headers)
    off = 8 + 16 * n
    for body in bodies:
        out.append(struct.pack("<I", off))
        off += len(body)
    out.extend(bodies)
    return b"".join(out)


class TestRoaring:
    def test_roundtrip_mixed_containers(self, P, rng):
        sparse = np.sort(rng.choice(65536, 100, replace=False)).astype(
            np.uint64)
        dense = np.sort(rng.choice(65536, 30000, replace=False)).astype(
            np.uint64)
        run = np.arange(5000, 15000, dtype=np.uint64)
        pos = np.concatenate([sparse, (1 << 16) + dense, (7 << 16) + run])
        blob = P.R.encode_positions(pos)
        np.testing.assert_array_equal(P.R.decode_to_positions(blob),
                                      np.unique(pos))
        assert set(P.R.decode(blob)) == {0, 1, 7}

    def test_roundtrip_fuzz(self, P, rng):
        for _ in range(10):
            n = int(rng.integers(0, 5000))
            pos = rng.integers(0, 1 << 24, n, dtype=np.uint64)
            np.testing.assert_array_equal(
                P.R.decode_to_positions(P.R.encode_positions(pos)),
                np.unique(pos))

    def test_empty(self, P):
        blob = P.R.encode_positions([])
        assert P.R.decode_to_positions(blob).size == 0
        assert P.R.decode(blob) == {}

    def test_decode_spec_fixture(self, P):
        R = P.R
        blob = _fixture(R, [(0, R.TYPE_ARRAY, [1, 5, 9]),
                            (3, R.TYPE_RUN, [(10, 12), (100, 100)]),
                            (2**40, R.TYPE_ARRAY, [65535])])
        got = R.decode(blob)
        np.testing.assert_array_equal(got[0], [1, 5, 9])
        np.testing.assert_array_equal(got[3], [10, 11, 12, 100])
        np.testing.assert_array_equal(got[2**40], [65535])
        assert int(R.decode_to_positions(blob)[-1]) == (2**40 << 16) + 65535

    def test_decode_bitmap_fixture(self, P):
        vals = list(range(0, 65536, 2))
        blob = _fixture(P.R, [(1, P.R.TYPE_BITMAP, vals)])
        np.testing.assert_array_equal(P.R.decode(blob)[1], vals)

    def test_bad_inputs(self, P):
        R = P.R
        for bad in (b"\x00", struct.pack("<II", 99999, 0),
                    struct.pack("<II", 12346, 0),
                    struct.pack("<II", R.MAGIC, 5)):
            with pytest.raises(R.RoaringError):
                R.decode(bad)

    def test_encoder_picks_smallest(self, P):
        blob = P.R.encode({0: np.arange(0, 10000, dtype=np.uint16)})
        assert P.R.decode(blob)[0].size == 10000 and len(blob) < 64
        vals = np.sort(np.random.default_rng(1).choice(
            65536, 30000, replace=False)).astype(np.uint16)
        assert len(P.R.encode({0: vals})) < 2 * 30000


# -- bytes across packages ----------------------------------------------------

_RECORDS = [
    ("set_bit", "f", 3, 7, None),
    ("set_bit", "t", 1, 9, "2024-05-01T00:00:00"),
    ("import_bits", "f", np.array([1, 2], dtype=np.int64),
     np.array([5, SHARD_WIDTH + 1], dtype=np.int64)),
    ("set_values", "n", np.array([3], dtype=np.int64), np.array([-6])),
    ("row_plane", "f", "standard", 0, 4, b"packed", True),
    ("df_changeset", "", 0, [1, 2], {"fare": [1.5, 2.5]}),
    ("delete_field", "g"),
]


def _same_records(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert len(ra) == len(rb) and ra[0] == rb[0]
        for x, y in zip(ra, rb):
            if isinstance(x, np.ndarray):
                assert isinstance(y, np.ndarray) and x.dtype == y.dtype
                assert np.array_equal(x, y)
            else:
                assert x == y


@pytest.mark.parametrize("writer,reader", [
    ("pilosa_tpu", "pilosa_tpu_torch"), ("pilosa_tpu_torch", "pilosa_tpu")],
    ids=["jax-to-torch", "torch-to-jax"])
class TestAcrossPackages:
    def test_wal_replays_in_the_other(self, writer, reader, tmp_path):
        p = str(tmp_path / "wal.log")
        w = _pkg(writer).WAL(p, segment_bytes=200)
        lsns = [w.append(r) for r in _RECORDS]
        w.close()
        r = _pkg(reader).WAL(p, segment_bytes=200)
        got = list(r.replay(0))
        assert [lsn for lsn, _rec, _n in got] == lsns
        _same_records([rec for _l, rec, _n in got], _RECORDS)
        data, last, _ = r.tail_bytes(lsns[1])
        assert last == lsns[-1]
        _same_records([rec for _l, rec in _pkg(writer).iter_frames(data)],
                      _RECORDS[2:])
        assert r.append(("clear_row", "f", 3)) == lsns[-1] + 1
        r.close()

    def test_roaring_blob_decodes_in_the_other(self, writer, reader, rng):
        pos = np.concatenate([
            rng.integers(0, 1 << 16, 90, dtype=np.uint64),
            (3 << 16) + np.arange(0, 40000, 2, dtype=np.uint64),
            (9 << 16) + np.arange(100, 9000, dtype=np.uint64)])
        blob = _pkg(writer).R.encode_positions(pos)
        assert blob == _pkg(reader).R.encode_positions(pos)
        np.testing.assert_array_equal(
            _pkg(reader).R.decode_to_positions(blob), np.unique(pos))

    def test_snapshot_loads_in_the_other(self, writer, reader, tmp_path):
        src = _pkg(writer).API()
        src.create_index("i", {"keys": True})
        src.create_field("i", "f")
        src.create_field("i", "n", {"type": "int"})
        src.import_bits("i", "f", rows=[1, 2, 2],
                        cols=[3, SHARD_WIDTH + 4, 9])
        src.import_values("i", "n", cols=[3, 9], values=[-5, 700])
        src.import_bits("i", "f", rows=[5], col_keys=["k"])
        src.import_dataframe("i", 0, [1, 2], {"fare": [1.5, 2.5]})
        root = str(tmp_path / "snap")
        _pkg(writer).store.export_holder(src.holder, root)
        arrays = _pkg(writer).store.export_shard_arrays(
            src.holder.index("i"), 1)

        # the export tree is a data directory: recover it in the other
        dst = _pkg(reader).API(root)
        assert dst.checksum() == src.checksum()
        assert dst.query("i", "Row(f=2)")[0].keys is not None
        # one shard's arrays install in the other
        other = _pkg(reader).API()
        other.create_index("i", {"keys": True})
        other.create_field("i", "f")
        other.create_field("i", "n", {"type": "int"})
        _pkg(reader).store.install_shard_arrays(
            other.holder.index("i"), 1, arrays)
        frag = other.holder.index("i").field("f").fragment(1)
        want = src.holder.index("i").field("f").fragment(1)
        assert frag.row_ids == want.row_ids
        assert np.array_equal(frag.planes[:len(frag.row_ids)],
                              want.planes[:len(want.row_ids)])
