"""Durability through the API, over both packages, and across them.

Every class but the last runs once per package (the ``P`` fixture: the
JAX package's ``API`` or the port's on the CPU): the ``API`` cases of
``tests/test_wal.py`` (``TestCrashRecovery``, ``TestQcx``,
``TestReviewRegressions``, ``TestTombstones``; SQL DML and the ingest
``Batch`` wait for their slices) and ``TestCrashInjection`` /
``TestReplayIdempotence`` of ``tests/test_recovery.py``, the 36-point
kill matrix included. "Crash" means dropping the API object without a
save, or ``abandon_holder`` (no flush of buffered bytes).

``TestAcrossPackages`` recovers a data directory written by one package
in the other: imports, Set / Clear / ClearRow / Store / Delete, BSI
values, keyed fields, time views, a dataframe changeset, a
``delete_field`` tombstone and a checkpoint plus a tail. The
``checksum()`` and every answer must be equal, then writes continue in
the reader; the same for a ``backup_tar`` restored by the other.
Tolerance is exact throughout.
"""

import importlib
import io
import threading
import time
import types

import pytest

SHARD_WIDTH = 1 << 20


def _load(root: str) -> types.SimpleNamespace:
    m = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    api_mod = m("api")
    rec = m("storage.recovery")
    kw = {"device": "cpu"} if root == "pilosa_tpu_torch" else {}

    def make_api(path=None, **more):
        return api_mod.API(path, **more, **kw)

    return types.SimpleNamespace(
        root=root, API=make_api, rec=rec, kw=kw,
        oracle=lambda base, batches: rec.oracle_checksums(base, batches,
                                                          **kw),
        crash=lambda base, plan, batches, **more: rec.run_crash_point(
            base, plan, batches, **more, **kw))


_PACKAGES = {}


def _pkg(root: str) -> types.SimpleNamespace:
    if root not in _PACKAGES:
        _PACKAGES[root] = _load(root)
    return _PACKAGES[root]


@pytest.fixture(params=["pilosa_tpu", "pilosa_tpu_torch"],
                ids=["jax", "torch"])
def P(request):
    return _pkg(request.param)


def _fresh(P, tmp_path, fields=("f",)):
    api = P.API(str(tmp_path))
    api.create_index("i")
    for f in fields:
        api.create_field("i", f)
    return api


class TestCrashRecovery:
    def test_writes_survive_without_save(self, P, tmp_path):
        api = _fresh(P, tmp_path)
        api.create_field("i", "n", {"type": "int"})
        api.query("i", "Set(1, f=3)Set(2, f=3)Set(1, n=42)")
        big = 2 * SHARD_WIDTH + 5
        api.import_bits("i", "f", rows=[7, 7], cols=[9, big])
        api.import_values("i", "n", cols=[big], values=[-6])
        del api
        api2 = P.API(str(tmp_path))
        assert api2.query("i", "Row(f=3)")[0].columns == [1, 2]
        assert api2.query("i", "Row(f=7)")[0].columns == [9, big]
        assert api2.query("i", "Sum(field=n)")[0].val == 36
        assert api2.query("i", "Count(All())")[0] == 4

    def test_clears_and_deletes_survive(self, P, tmp_path):
        api = _fresh(P, tmp_path)
        api.query("i", "Set(1, f=3)Set(2, f=3)Set(3, f=3)")
        api.query("i", "Clear(2, f=3)")
        api.query("i", "Delete(Row(f=9))")
        api.query("i", "Set(5, f=4)")
        api.query("i", "Delete(ConstRow(columns=[3]))")
        want_row = api.query("i", "Row(f=3)")[0].columns
        want_all = api.query("i", "Count(All())")[0]
        del api
        api2 = P.API(str(tmp_path))
        assert api2.query("i", "Row(f=3)")[0].columns == want_row == [1]
        assert api2.query("i", "Count(All())")[0] == want_all == 3

    def test_store_and_clearrow_survive(self, P, tmp_path):
        api = _fresh(P, tmp_path)
        api.query("i", "Set(1, f=1)Set(2, f=1)Set(2, f=2)")
        api.query("i", "Store(Row(f=1), f=9)")
        api.query("i", "ClearRow(f=2)")
        del api
        api2 = P.API(str(tmp_path))
        assert api2.query("i", "Row(f=9)")[0].columns == [1, 2]
        assert api2.query("i", "Row(f=2)")[0].columns == []

    def test_recovery_after_checkpoint_plus_tail(self, P, tmp_path):
        api = _fresh(P, tmp_path)
        api.query("i", "Set(1, f=1)")
        api.save()
        assert api.holder.index("i").wal.record_bytes == 0
        api.query("i", "Set(2, f=1)")
        del api
        api2 = P.API(str(tmp_path))
        assert api2.query("i", "Row(f=1)")[0].columns == [1, 2]

    def test_torn_tail_drops_only_last_write(self, P, tmp_path):
        api = _fresh(P, tmp_path)
        api.query("i", "Set(1, f=1)")
        wal = api.holder.index("i").wal
        size_after_first = wal.size
        api.query("i", "Set(2, f=1)")
        wal_path = wal.path
        del api
        with open(wal_path, "r+b") as f:
            f.truncate(size_after_first + 4)
        api2 = P.API(str(tmp_path))
        assert api2.query("i", "Row(f=1)")[0].columns == [1]

    def test_mutex_and_time_fields_replay(self, P, tmp_path):
        api = P.API(str(tmp_path))
        api.create_index("i")
        api.create_field("i", "m", {"type": "mutex"})
        api.create_field("i", "t", {"type": "time", "timeQuantum": "YMD"})
        api.query("i", "Set(1, m=1)")
        api.query("i", "Set(1, m=2)")
        api.query("i", "Set(3, t=5, 2024-05-01T00:00)")
        del api
        api2 = P.API(str(tmp_path))
        assert api2.query("i", "Row(m=1)")[0].columns == []
        assert api2.query("i", "Row(m=2)")[0].columns == [1]
        got = api2.query(
            "i", "Row(t=5, from=2024-04-01T00:00, to=2024-06-01T00:00)")[0]
        assert got.columns == [3]

    def test_auto_checkpoint_threshold(self, P, tmp_path):
        api = P.API(str(tmp_path))
        api.holder.checkpoint_bytes = 1
        api.create_index("i")
        api.create_field("i", "f")
        api.query("i", "Set(1, f=1)")
        assert api.holder.index("i").wal.record_bytes == 0
        del api
        api2 = P.API(str(tmp_path))
        assert api2.query("i", "Row(f=1)")[0].columns == [1]


class TestQcx:
    def test_qcx_flushes_dirty_wals(self, P, tmp_path):
        api = _fresh(P, tmp_path)
        with api.txf.qcx() as q:
            api.holder.index("i").field("f").set_bit(1, 2)
        assert q.lsn == api.holder.last_lsn() > 0
        assert list(api.holder.index("i").wal.records())

    def test_path_less_holder_commits_nothing(self, P):
        api = P.API()
        api.create_index("i")
        api.create_field("i", "f")
        with api.txf.qcx() as q:
            api.holder.index("i").field("f").set_bit(1, 2)
        assert q.lsn == 0 and api.holder.wal_bytes() == 0


class TestReviewRegressions:
    def test_double_restart_after_torn_tail(self, P, tmp_path):
        api = _fresh(P, tmp_path)
        api.query("i", "Set(1, f=1)")
        wal_path = api.holder.index("i").wal.path
        del api
        with open(wal_path, "ab") as f:
            f.write(b"\xde\xad\xbe")
        api2 = P.API(str(tmp_path))
        api2.query("i", "Set(2, f=1)")
        del api2
        api3 = P.API(str(tmp_path))
        assert api3.query("i", "Row(f=1)")[0].columns == [1, 2]

    def test_rejected_write_does_not_poison_wal(self, P, tmp_path):
        api = P.API(str(tmp_path))
        api.create_index("i")
        api.create_field("i", "n", {"type": "int", "min": 0, "max": 100})
        api.import_values("i", "n", cols=[1], values=[50])
        with pytest.raises(ValueError):
            api.import_values("i", "n", cols=[2], values=[10**9])
        del api
        api2 = P.API(str(tmp_path))
        assert api2.query("i", "Sum(field=n)")[0].val == 50

    def test_delete_index_removes_data_dir(self, P, tmp_path):
        api = _fresh(P, tmp_path)
        api.query("i", "Set(1, f=1)")
        api.save()
        api.delete_index("i")
        api.create_index("i")
        api.create_field("i", "f")
        api.query("i", "Set(9, f=1)")
        del api
        api2 = P.API(str(tmp_path))
        assert api2.query("i", "Row(f=1)")[0].columns == [9]

    def test_delete_records_one_wal_record_per_shard(self, P, tmp_path):
        api = _fresh(P, tmp_path, ("a", "b", "c"))
        api.query("i", "Set(1, a=1)Set(1, b=1)Set(1, c=1)")
        wal = api.holder.index("i").wal
        before = sum(1 for _ in wal.records())
        api.query("i", "Delete(ConstRow(columns=[1]))")
        assert [r[0] for r in list(wal.records())[before:]] == ["delete_cols"]
        del api
        api2 = P.API(str(tmp_path))
        assert api2.query("i", "Count(All())")[0] == 0
        assert api2.query("i", "Row(a=1)")[0].columns == []

    def test_import_clear_and_existence_survive(self, P, tmp_path):
        api = _fresh(P, tmp_path)
        api.import_bits("i", "f", rows=[1, 1, 2], cols=[5, 6, 7])
        api.import_bits("i", "f", rows=[1], cols=[6], clear=True)
        del api
        api2 = P.API(str(tmp_path))
        assert api2.query("i", "Row(f=1)")[0].columns == [5]
        assert api2.query("i", "Count(All())")[0] == 3


class TestImportRoaring:
    def test_import_clear_and_views_survive(self, P, tmp_path):
        api = P.API(str(tmp_path))
        api.create_index("i")
        api.create_field("i", "f")
        api.create_field("i", "t", {"type": "time", "timeQuantum": "Y"})
        api.import_roaring("i", "f", 2, {
            "": _roaring_blob({1: [0, 9, 65536 + 3], 4: [9]})})
        api.import_roaring("i", "t", 0, {"standard_2024": _roaring_blob(
            {3: [1, 2]})})
        api.import_roaring("i", "f", 2, {"": _roaring_blob({1: [9]})},
                           clear=True)
        w = 2 * SHARD_WIDTH
        assert api.query("i", "Row(f=1)")[0].columns == [w, w + 65539]
        assert api.query("i", "Count(All())")[0] == 5
        with pytest.raises(ValueError):
            api.create_field("i", "n", {"type": "int"})
            api.import_roaring("i", "n", 0, {"": _roaring_blob({1: [1]})})
        want = api.checksum()
        del api
        api2 = P.API(str(tmp_path))
        assert api2.checksum() == want
        assert api2.query("i", "Row(f=4)")[0].columns == [w + 9]
        assert api2.query(
            "i", "Row(t=3, from=2024-01-01T00:00, to=2025-01-01T00:00)"
        )[0].columns == [1, 2]

    def test_same_digest_in_both_packages(self, tmp_path):
        digests = []
        for root in ("pilosa_tpu", "pilosa_tpu_torch"):
            api = _pkg(root).API(str(tmp_path / root))
            api.create_index("i")
            api.create_field("i", "f")
            api.import_roaring("i", "f", 1, {"": _roaring_blob(
                {0: [1, 2, 3], 7: list(range(100, 5000, 7))})})
            api.import_roaring("i", "f", 1, {"": _roaring_blob({0: [2]})},
                               clear=True)
            digests.append(api.checksum())
        assert digests[0] == digests[1]


class TestTombstones:
    def test_dataframe_delete_survives_reopen(self, P, tmp_path):
        api = P.API(str(tmp_path))
        api.create_index("t")
        api.import_dataframe("t", 0, [1], {"fare": [5.0]})
        api.delete_dataframe("t")
        del api
        api2 = P.API(str(tmp_path))
        assert api2.query("t", 'Apply("sum(fare)")')[0].value == 0
        assert api2.dataframe_schema("t") == []

    def test_dataframe_checkpoint_plus_tail(self, P, tmp_path):
        api = P.API(str(tmp_path))
        api.create_index("t")
        api.import_dataframe("t", 0, [1, 2], {"fare": [5.0, 1.5]})
        api.save()
        api.import_dataframe("t", 1, [3], {"fare": [2.0], "n": [4]})
        want = api.checksum()
        del api
        api2 = P.API(str(tmp_path))
        assert api2.checksum() == want
        assert api2.query("t", 'Apply("sum(fare)")')[0].value == 8.5

    def test_field_delete_recreate_no_resurrection(self, P, tmp_path):
        api = _fresh(P, tmp_path)
        api.query("i", "Set(1, f=1)")
        api.save()
        api.delete_field("i", "f")
        api.create_field("i", "f")
        api.query("i", "Set(9, f=2)")
        del api
        api2 = P.API(str(tmp_path))
        assert api2.query("i", "Row(f=1)")[0].columns == []
        assert api2.query("i", "Row(f=2)")[0].columns == [9]

    def test_concurrent_writers_no_wal_corruption(self, P, tmp_path):
        api = _fresh(P, tmp_path)

        def worker(row):
            for c in range(50):
                api.query("i", f"Set({c}, f={row})")

        threads = [threading.Thread(target=worker, args=(r,))
                   for r in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        del api
        api2 = P.API(str(tmp_path))
        for r in range(4):
            assert api2.query("i", f"Count(Row(f={r}))")[0] == 50

    def test_read_queries_take_no_write_lock(self, P, tmp_path):
        api = _fresh(P, tmp_path)
        api.query("i", "Set(1, f=2)")
        api.query("i", "Row(f=2)")  # warm the stacked cache
        with api.holder.write_lock:
            out = {}

            def read():
                out["cols"] = api.query("i", "Row(f=2)")[0].columns

            t = threading.Thread(target=read)
            t.start()
            t.join(timeout=30)
            assert out.get("cols") == [1], "read blocked on write lock"

    def test_concurrent_reads_and_writes_no_torn_state(self, P, tmp_path):
        api = _fresh(P, tmp_path)
        api.query("i", "Set(0, f=0)")
        stop = threading.Event()
        errors = []

        def writer():
            r = 0
            while not stop.is_set():
                r += 1
                try:
                    api.query("i", f"Set({r % 100}, f={r})")
                except Exception as e:  # pragma: no cover
                    errors.append(e)

        def reader():
            while not stop.is_set():
                try:
                    api.query("i", "TopN(f, n=5)")
                    api.query("i", "Count(Row(f=0))")
                except Exception as e:  # pragma: no cover
                    errors.append(e)

        threads = [threading.Thread(target=writer)] + [
            threading.Thread(target=reader) for _ in range(2)]
        for t in threads:
            t.start()
        time.sleep(1.5)
        stop.set()
        for t in threads:
            t.join(timeout=60)
        assert not errors, errors[:3]


# -- kill points (tests/test_recovery.py TestCrashInjection) ------------------


def _assert_oracle_prefix(result, oracle):
    """A crash may lose unacked work, never acked work, and never leaves
    a state that is not an exact committed prefix."""
    assert result["checksum"] in oracle, "recovered state not a prefix"
    k = oracle.index(result["checksum"])
    assert k >= result["acked"], \
        f"acked batch lost: recovered prefix {k} < acked {result['acked']}"


_ORACLES = {}


def _oracle(P, tmp_path_factory, n_batches, seed):
    """The uncrashed oracle, once per (package, workload)."""
    key = (P.root, n_batches, seed)
    if key not in _ORACLES:
        batches = P.rec.crash_workload(n_batches=n_batches, seed=seed)
        base = str(tmp_path_factory.mktemp("oracle"))
        _ORACLES[key] = (batches, P.oracle(base, batches))
    return _ORACLES[key]


class TestCrashInjection:
    @pytest.mark.parametrize("site", ["wal.append", "wal.flush",
                                      "savez.pre_replace",
                                      "savez.post_replace",
                                      "checkpoint.mid"])
    @pytest.mark.parametrize("at", [1, 2, 3, 4, 5, 6])
    def test_kill_point_matrix(self, P, tmp_path, tmp_path_factory, site,
                               at):
        batches, oracle = _oracle(P, tmp_path_factory, 6, 0)
        res = P.crash(str(tmp_path), P.rec.CrashPlan().kill(site, at=at),
                      batches, checkpoint_bytes=1)
        _assert_oracle_prefix(res, oracle)
        if not res["crashed"]:
            assert res["checksum"] == oracle[-1]

    @pytest.mark.parametrize("site", ["wal.append", "wal.flush"])
    @pytest.mark.parametrize("at", [1, 2, 3])
    def test_kill_point_no_checkpoint(self, P, tmp_path, tmp_path_factory,
                                      site, at):
        batches, oracle = _oracle(P, tmp_path_factory, 6, 1)
        res = P.crash(str(tmp_path), P.rec.CrashPlan().kill(site, at=at),
                      batches)
        assert res["crashed"]
        _assert_oracle_prefix(res, oracle)

    @pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5, 6, 7])
    def test_seeded_crash_points(self, P, tmp_path, tmp_path_factory, seed):
        batches, oracle = _oracle(P, tmp_path_factory, 6, seed)
        res = P.crash(str(tmp_path), P.rec.CrashPlan.seeded(seed), batches,
                      checkpoint_bytes=1)
        _assert_oracle_prefix(res, oracle)

    def test_config11_seeded_kill_point(self, P, tmp_path, tmp_path_factory):
        """bench.py config 11's injected crash: seed 11 over 8 batches."""
        batches, oracle = _oracle(P, tmp_path_factory, 8, 11)
        res = P.crash(str(tmp_path), P.rec.CrashPlan.seeded(11), batches,
                      checkpoint_bytes=1)
        _assert_oracle_prefix(res, oracle)

    def test_abandon_holder_loses_buffered_bytes(self, P, tmp_path):
        api = P.API(str(tmp_path))
        api.create_index("ci", {"trackExistence": False})
        api.create_field("ci", "f")
        api.save()
        idx = api.holder.index("ci")
        idx.wal.sync = "never"  # keep bytes in the BufferedWriter
        with api.holder.write_lock:
            idx.wal.append(("set_bit", "f", "", 0, 1))
        P.rec.abandon_holder(api.holder)
        api2 = P.API(str(tmp_path))
        assert api2.query("ci", "Row(f=0)")[0].columns == []

    def test_oracles_agree_across_packages(self, tmp_path_factory):
        """The same workload digests the same after every batch in both
        packages."""
        ours = _oracle(_pkg("pilosa_tpu_torch"), tmp_path_factory, 6, 0)
        theirs = _oracle(_pkg("pilosa_tpu"), tmp_path_factory, 6, 0)
        assert ours[1] == theirs[1]


class TestReplayIdempotence:
    def _source(self, P, path):
        api = P.API(path)
        api.create_index("i", {"keys": True})
        api.create_field("i", "f")
        api.create_field("i", "b", {"type": "int", "min": 0, "max": 1000})
        api.import_bits("i", "f", rows=[0, 1, 0], cols=[3, 9, SHARD_WIDTH])
        api.query("i", "Clear(9, f=1)")
        api.import_values("i", "b", cols=[3, 9], values=[10, 20])
        api.query("i", "Clear(9, b=20)")
        api.import_bits("i", "f", rows=[2], col_keys=["k1"])
        api.holder.flush_wals()
        return api

    @pytest.mark.parametrize("times", [1, 2, 3])
    def test_same_tail_applied_n_times_is_identical(self, P, tmp_path,
                                                    times):
        src = self._source(P, str(tmp_path / "src"))
        recs = list(src.holder.index("i").wal.records())
        assert len(recs) >= 5
        replica = P.API(str(tmp_path / f"rep{times}"))
        replica.create_index("i", {"keys": True})
        replica.create_field("i", "f")
        replica.create_field("i", "b", {"type": "int", "min": 0,
                                        "max": 1000})
        idx = replica.holder.index("i")
        checks = []
        for _ in range(times):
            with replica.holder.write_lock:
                assert replica.holder.replay_records(idx, recs) == len(recs)
            checks.append(replica.checksum())
        assert len(set(checks)) == 1, "replay is not idempotent"
        for pql in ("Row(f=0)", "Row(f=1)", "Row(f=2)", "Row(b > 5)"):
            assert replica.query("i", pql)[0].columns == \
                src.query("i", pql)[0].columns


# -- across packages ----------------------------------------------------------

_QUERIES = [
    "Row(f=1)", "Row(f=2)", "Count(All())", "Count(Row(f=3))",
    "TopN(f, n=5)", "Sum(field=n)", "Min(field=n)", "Max(field=n)",
    "Count(Row(n > 3))", "Row(m=2)", 'Row(k="b")', 'Count(Row(k="a"))',
    "Row(t=1, from=2024-04-01T00:00, to=2024-06-01T00:00)",
    "Row(t=1, from=2024-05-02T00:00, to=2024-05-03T00:00)",
    "Row(g=1)", 'Apply("sum(fare)")', "Row(s=4)", "Row(r=1)", "Row(r=2)",
]


def _answers(api, queries=_QUERIES):
    out = []
    for q in queries:
        r = api.query("i", q)[0]
        if hasattr(r, "to_json"):
            r = r.to_json()
        out.append(r)
    return out


def _write_everything(api):
    """Every record type the port logs, a checkpoint in the middle."""
    api.create_index("i")
    api.create_field("i", "f")
    api.create_field("i", "g")
    api.create_field("i", "n", {"type": "int"})
    api.create_field("i", "m", {"type": "mutex"})
    api.create_field("i", "k", {"keys": True})
    api.create_field("i", "t", {"type": "time", "timeQuantum": "YMD"})
    api.create_field("i", "s")
    api.create_field("i", "r")
    api.import_bits("i", "f", rows=[1, 1, 2, 3, 3, 3],
                    cols=[1, SHARD_WIDTH + 2, 3, 4, 5, 2 * SHARD_WIDTH])
    api.import_values("i", "n", cols=[1, 3, SHARD_WIDTH + 7],
                      values=[5, -2, 40])
    api.import_bits("i", "k", row_keys=["a", "b", "a"], cols=[1, 2, 9])
    api.query("i", "Set(7, m=1)Set(7, m=2)Set(8, m=2)")
    api.query("i", "Set(3, t=1, 2024-05-01T00:00)"
                   "Set(4, t=1, 2024-05-02T05:00)")
    api.import_bits("i", "g", rows=[1, 1], cols=[2, 3])
    api.import_dataframe("i", 0, [1, 2], {"fare": [1.5, 2.25]})
    api.save()  # checkpoint: everything above is in npz files now
    api.query("i", "Set(10, f=1)Clear(1, f=1)Set(11, n=9)Clear(3, n=-2)")
    api.query("i", "Store(Row(f=3), s=4)")
    api.query("i", "ClearRow(f=2)")
    api.query("i", "Delete(ConstRow(columns=[5]))")
    api.delete_field("i", "g")  # tombstone after the checkpoint
    api.create_field("i", "g")
    api.query("i", "Set(12, g=1)")
    api.import_values("i", "n", cols=[SHARD_WIDTH + 8], values=[77])
    api.import_dataframe("i", 1, [4], {"fare": [10.0]})
    blob = _roaring_blob({1: [0, 5, 70000], 2: [5, 6]})
    api.import_roaring("i", "r", 1, {"": blob})
    api.import_roaring("i", "r", 1, {"": _roaring_blob({2: [6]})}, clear=True)
    api.holder.flush_wals()


def _roaring_blob(rows):
    """A pilosa-roaring blob of shard-local ``{row: [cols]}``."""
    from pilosa_tpu_torch.storage.roaring import encode_positions

    return encode_positions([r * SHARD_WIDTH + c for r, cs in rows.items()
                             for c in cs])


@pytest.mark.parametrize("writer,reader", [
    ("pilosa_tpu", "pilosa_tpu_torch"), ("pilosa_tpu_torch", "pilosa_tpu")],
    ids=["jax-to-torch", "torch-to-jax"])
class TestAcrossPackages:
    def test_data_dir_recovers_in_the_other(self, writer, reader, tmp_path):
        W, R = _pkg(writer), _pkg(reader)
        src = W.API(str(tmp_path))
        _write_everything(src)
        assert src.holder.index("i").wal.record_bytes > 0  # a tail
        want, answers = src.checksum(), _answers(src)
        W.rec.abandon_holder(src.holder)
        dst = R.API(str(tmp_path))
        assert dst.checksum() == want
        assert _answers(dst) == answers
        assert dst.schema() == src.schema()
        # writes continue in the reader and recover in the writer
        dst.query("i", "Set(20, f=1)Set(21, n=3)")
        dst.import_bits("i", "k", row_keys=["c"], cols=[22])
        want2, answers2 = dst.checksum(), _answers(dst)
        R.rec.abandon_holder(dst.holder)
        back = W.API(str(tmp_path))
        assert back.checksum() == want2
        assert _answers(back) == answers2

    def test_backup_restores_in_the_other(self, writer, reader, tmp_path):
        W, R = _pkg(writer), _pkg(reader)
        src = W.API(str(tmp_path / "src"))
        _write_everything(src)
        buf = io.BytesIO()
        src.backup_tar(buf)
        dst = R.API(str(tmp_path / "dst"))
        dst.create_index("old")  # restore replaces everything
        dst.restore_tar(io.BytesIO(buf.getvalue()))
        assert dst.checksum() == src.checksum()
        assert _answers(dst) == _answers(src)
        assert "old" not in dst.schema()
        del dst
        again = R.API(str(tmp_path / "dst"))  # the restore is durable
        assert again.checksum() == src.checksum()

    def test_idalloc_journal_reads_in_the_other(self, writer, reader,
                                                tmp_path):
        src = _pkg(writer).API(str(tmp_path))
        a = src.idalloc.reserve("s1", 10)
        src.idalloc.commit("s1", 4)
        b = src.idalloc.reserve("s2", 5)
        dst = _pkg(reader).API(str(tmp_path))
        assert dst.idalloc.reserve("s2", 5).base == b.base
        assert dst.idalloc.next_id == src.idalloc.next_id == a.base + 4 + 5
