"""Holder: root container owning all indexes.

Port of ``pilosa_tpu/core/holder.py`` (reference: holder.go:58). A
holder with a data directory is durable: the schema is a JSON document
there (``schema.json``), every index keeps its own segmented WAL
(storage/wal.py) and checkpoints its planes as npz files
(storage/store.py), and :meth:`recover` loads the last checkpoint and
replays the WAL tail above its LSN through the same field write methods
that logged it. The directory layout, the schema document and the WAL
records are the JAX package's, so either package recovers the other's
data directory. The holder fixes the device every index of it runs on;
recovery writes only host planes, and stacks build or advance on the
next read.
"""

from __future__ import annotations

import datetime as dt
import json
import logging
import os
import shutil
import time
from typing import Dict, List, Optional

import torch

from pilosa_tpu_torch.analysis import locktrace
from pilosa_tpu_torch.core import stacked
from pilosa_tpu_torch.core.index import Index
from pilosa_tpu_torch.core.schema import FieldOptions, IndexOptions
from pilosa_tpu_torch.obs import metrics as M
from pilosa_tpu_torch.shardwidth import SHARD_WIDTH, WORDS_PER_SHARD
from pilosa_tpu_torch.storage import recovery, store
from pilosa_tpu_torch.storage.wal import DEFAULT_SEGMENT_BYTES, WAL, \
    unpack_plane

log = logging.getLogger(__name__)


class Holder:
    def __init__(self, device: torch.device, path: Optional[str] = None,
                 wal_sync: str = "batch", checkpoint_bytes: int = 64 << 20,
                 readonly: bool = False,
                 segment_bytes: Optional[int] = None):
        self.device = device
        self.path = path
        self.wal_sync = wal_sync
        # readonly: a snapshot-only read pass (restore): no WAL handles
        # are opened and recover() replays no log (a foreign wal.log is
        # untrusted input; see API.restore_tar)
        self.readonly = readonly
        # WAL record bytes that trigger an automatic fuzzy checkpoint
        # (reference: rbf/cfg/cfg.go:10-13 MaxWALCheckpointSize)
        self.checkpoint_bytes = checkpoint_bytes
        self.segment_bytes = segment_bytes or DEFAULT_SEGMENT_BYTES
        # storage/recovery.CrashPlan for kill-point tests; attach with
        # recovery.attach_crash_plan so open WALs get it too
        self.crash_plan = None
        # serializes write requests against each other, against
        # checkpoints and against stack builds; reads never take it
        # (core/stacked.py). Held across device work by design: a build
        # uploads, and an advance launches, from a still snapshot of the
        # host planes (dispatch_ok)
        self.write_lock = locktrace.tracked_lock("core.holder.write",
                                                 rlock=True,
                                                 dispatch_ok=True)
        self.indexes: Dict[str, Index] = {}
        if path:
            os.makedirs(path, exist_ok=True)
            self._load_schema()

    # -- schema persistence -------------------------------------------------

    def _schema_path(self) -> str:
        return os.path.join(self.path, "schema.json")

    def _load_schema(self) -> None:
        if not os.path.exists(self._schema_path()):
            return
        with open(self._schema_path()) as f:
            doc = json.load(f)
        for idx_doc in doc.get("indexes", []):
            idx = self._new_index(idx_doc["name"],
                                  IndexOptions.from_json(idx_doc["options"]))
            for f_doc in idx_doc.get("fields", []):
                if f_doc["name"] not in idx.fields:
                    idx.create_field(f_doc["name"],
                                     FieldOptions.from_json(f_doc["options"]))

    def save_schema(self) -> None:
        if not self.path:
            return
        doc = {"indexes": [
            {"name": idx.name, "options": idx.options.to_json(),
             "fields": [{"name": f.name, "options": f.options.to_json()}
                        for f in idx.public_fields()]}
            for idx in sorted(self.indexes.values(), key=lambda i: i.name)]}
        tmp = self._schema_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1)
        os.replace(tmp, self._schema_path())

    # -- index management ---------------------------------------------------

    def _index_path(self, name: str) -> Optional[str]:
        return os.path.join(self.path, "indexes", name) if self.path else None

    def _new_index(self, name: str, options: Optional[IndexOptions]) -> Index:
        wal = None
        if self.path and not self.readonly:
            wal = WAL(os.path.join(self._index_path(name), "wal.log"),
                      sync=self.wal_sync, segment_bytes=self.segment_bytes,
                      crash_plan=self.crash_plan)
        idx = Index(name, self.device, options, lock=self.write_lock,
                    path=self._index_path(name), wal=wal)
        self.indexes[name] = idx
        return idx

    def create_index(self, name: str,
                     options: Optional[IndexOptions] = None) -> Index:
        if name in self.indexes:
            raise ValueError(f"index {name!r} already exists")
        idx = self._new_index(name, options)
        self.save_schema()
        return idx

    def index(self, name: str) -> Index:
        idx = self.indexes.get(name)
        if idx is None:
            raise KeyError(f"index {name!r} not found")
        return idx

    def delete_index(self, name: str) -> None:
        """Drop an index, every field's device stacks and budget entries,
        and its whole data directory (WAL, checkpoint, translate
        journals), so re-creating the name resurrects nothing (reference:
        holder.go DeleteIndex)."""
        idx = self.indexes.pop(name)
        for f in idx.fields.values():
            stacked.release_field_cache(f)
        idx.dataframe.release_device()
        if idx.wal is not None:
            idx.wal.close()
        path = self._index_path(name)
        if path and os.path.isdir(path):
            shutil.rmtree(path)
        self.save_schema()

    # -- durability (reference: rbf WAL/checkpoint, rbf/db.go:149-230) ------

    def _wals(self) -> List[WAL]:
        return [idx.wal for idx in self.indexes.values()
                if idx.wal is not None]

    def flush_wals(self) -> None:
        """Group commit: one write barrier per dirty index (the
        Qcx.finish analog, txfactory.go:114)."""
        for w in self._wals():
            w.flush()

    def wal_bytes(self) -> int:
        """Record bytes pending checkpoint (segment markers excluded: a
        freshly checkpointed holder reports 0)."""
        return sum(w.record_bytes for w in self._wals())

    def wal_flush_lag_s(self) -> float:
        """Max seconds any index WAL has held unflushed records."""
        return max((w.flush_lag_s() for w in self._wals()), default=0.0)

    def last_lsn(self) -> int:
        """The holder-wide commit position: the max LSN across the index
        WALs (LSNs only grow, so it orders any two holder states)."""
        return max((w.last_lsn for w in self._wals()), default=0)

    def checkpoint(self) -> None:
        """Fuzzy checkpoint: flush, capture each index's LSN, snapshot all
        planes, stamp ``checkpoint.json`` with the LSN, then prune the
        segments wholly below it. A crash between any two steps is safe:
        before the stamp, recovery replays from the old LSN over mixed
        old and new npz files (every WAL op is plane-idempotent); after
        it, the snapshot covers everything the stamp claims. Takes the
        write lock so no writer appends between snapshot and stamp."""
        if not self.path or self.readonly:
            return
        plan = self.crash_plan
        if plan is not None and plan.dead:
            return
        t0 = time.perf_counter()
        pruned = 0
        with self.write_lock:
            self.flush_wals()
            lsns = {name: idx.wal.last_lsn
                    for name, idx in self.indexes.items()
                    if idx.wal is not None}
            offsets = {name: {g: dict(m)
                              for g, m in idx.stream_offsets.items()}
                       for name, idx in self.indexes.items()
                       if idx.stream_offsets}
            with recovery.crash_scope(plan):
                store.save_holder_data(self)
                if plan is not None and not plan.fire("checkpoint.mid"):
                    return
                for name, lsn in lsns.items():
                    recovery.write_checkpoint_meta(
                        self._index_path(name), lsn,
                        stream_offsets=offsets.get(name))
            for name, lsn in lsns.items():
                idx = self.indexes.get(name)
                if idx is not None and idx.wal is not None:
                    pruned += idx.wal.prune(lsn)
        M.REGISTRY.observe(M.METRIC_RECOVERY_CHECKPOINT_SECONDS,
                           time.perf_counter() - t0)
        if pruned:
            M.REGISTRY.count(M.METRIC_RECOVERY_SEGMENTS_PRUNED, pruned)

    def maybe_checkpoint(self) -> bool:
        if self.path and self.wal_bytes() > self.checkpoint_bytes:
            self.checkpoint()
            return True
        return False

    def replay_records(self, idx: Index, records) -> int:
        """Apply WAL record tuples to ``idx`` with re-logging suppressed.
        A bad record is skipped with a warning, never a brick. Returns
        the records applied."""
        wal = idx.wal
        prev = wal.replaying if wal is not None else False
        if wal is not None:
            wal.replaying = True
        applied = 0
        try:
            for rec in records:
                try:
                    self._apply_wal_record(idx, rec)
                    applied += 1
                except (ValueError, KeyError) as e:
                    log.warning("skipping unreplayable WAL record %r: %s",
                                rec[:2], e)
        finally:
            if wal is not None:
                wal.replaying = prev
        return applied

    def recover(self) -> None:
        """Crash recovery: load the last checkpoint, then replay each
        index's WAL records ABOVE its checkpoint LSN through the field
        write methods that produced them (reference: rbf/db.go WAL replay
        on open), then chop any torn tail."""
        store.load_holder_data(self)
        for name, idx in self.indexes.items():
            if idx.wal is None:
                continue
            ipath = self._index_path(name)
            ckpt = recovery.read_checkpoint_meta(ipath)
            # checkpoint-stamped stream watermarks first; the tail's
            # stream_offsets records only move them forward
            for g, m in recovery.read_checkpoint_offsets(ipath).items():
                cur = idx.stream_offsets.setdefault(g, {})
                for k, v in m.items():
                    cur[k] = max(int(v), int(cur.get(k, 0)))
            nbytes = [0]

            def _tail(w=idx.wal, after=ckpt, nb=nbytes):
                for _lsn, rec, frame_len in w.replay(after):
                    nb[0] += frame_len
                    yield rec

            applied = self.replay_records(idx, _tail())
            if applied:
                M.REGISTRY.count(M.METRIC_RECOVERY_REPLAY_RECORDS, applied)
                M.REGISTRY.count(M.METRIC_RECOVERY_REPLAY_BYTES, nbytes[0])
            idx.wal.repair()

    @staticmethod
    def _apply_wal_record(idx: Index, rec) -> None:
        op, fname = rec[0], rec[1]
        if op == "stream_offsets":  # consumer watermark; rec[1] is a group
            cur = idx.stream_offsets.setdefault(fname, {})
            for k, v in dict(rec[2]).items():
                cur[k] = max(int(v), int(cur.get(k, 0)))
            return
        if op == "df_changeset":  # dataframe record, no field name
            _, _, shard, ids, columns = rec
            idx.dataframe.apply_changeset(shard, ids, columns, log=False)
            return
        if op == "df_delete":  # tombstone: wipe changesets replayed so far
            idx.dataframe.delete(log=False)
            return
        if op == "delete_view":  # TTL sweep tombstone
            f = idx.fields.get(fname)
            if f is not None:
                f.views.pop(rec[2], None)
                stacked.release_field_cache(f)
            return
        if op == "delete_field":
            # a field deleted (and maybe re-created) after earlier records
            # were logged: wipe what replay built so far
            f = idx.fields.get(fname)
            if f is not None:
                f.views.clear()
                f.bsi.clear()
                stacked.release_field_cache(f)
            return
        if op == "delete_cols":  # index-level record, no field name
            _, _, shard, packed = rec
            plane = unpack_plane(packed, WORDS_PER_SHARD)
            for field in idx.fields.values():
                field.clear_columns(shard, plane, log=False)
            return
        field = idx.fields.get(fname)
        if field is None:  # field deleted after the record was logged
            return
        if op == "set_bit":
            _, _, row, col, ts = rec
            field.set_bit(row, col,
                          dt.datetime.fromisoformat(ts) if ts else None)
        elif op == "clear_bit":
            field.clear_bit(rec[2], rec[3])
        elif op == "set_values":
            field.set_values(rec[2], rec[3])
        elif op == "clear_value":
            field.clear_value(rec[2])
        elif op == "import_bits":
            field.import_bits(rec[2], rec[3])
        elif op == "row_plane":
            _, _, view, shard, row, packed, clear = rec
            field.write_row_plane(shard, row,
                                  unpack_plane(packed, WORDS_PER_SHARD),
                                  clear=clear, view=view)
        elif op == "clear_row_bits":
            _, _, view, shard, row, packed = rec
            field.clear_row_plane_bits(
                shard, row, unpack_plane(packed, WORDS_PER_SHARD), view=view)
        elif op == "clear_row":
            field.clear_row(rec[2])
        elif op == "clear_cols":
            _, _, shard, packed = rec
            field.clear_columns(shard, unpack_plane(packed, WORDS_PER_SHARD))
        # unknown ops from a newer version are skipped (forward compat)

    # -- device residency (core/stacked.py) ---------------------------------

    def prewarm(self, index: Optional[str] = None) -> Dict[str, int]:
        """Build every (field, view) stack up front, so the first query
        of each family runs warm: no ``stack.build`` and no
        ``device.h2d_copy`` on the serving path. Returns
        ``{"set_stacks": n, "bsi_stacks": n}``; more than the budget
        holds LRU-evicts the coldest, as demand paging would."""
        indexes = ([self.index(index)] if index is not None
                   else list(self.indexes.values()))
        sets = bsis = 0
        for idx in indexes:
            shard_list = sorted(idx.shards())
            if not shard_list:
                continue
            for field in idx.fields.values():
                for view in sorted(field.views):
                    stacked.stacked_set(field, shard_list, view)
                    sets += 1
                if field.bsi:
                    stacked.stacked_bsi(field, shard_list)
                    bsis += 1
        return {"set_stacks": sets, "bsi_stacks": bsis}

    def residency_stats(self) -> Dict[str, float]:
        """The device budget's bytes and capacity, and the paging
        counters (``stacked.PAGING_STATS``)."""
        st = stacked.PAGING_STATS
        return {
            "resident_bytes": stacked.BUDGET.used,
            "budget_bytes": stacked.BUDGET.cap,
            "evictions": st["evictions"],
            "block_builds": st["block_builds"],
            "stale_retries": st["stale_retries"],
        }

    def schema(self) -> List[dict]:
        """JSON-facing schema (reference: api.go Schema, schema.go:502)."""
        return [
            {"name": idx.name, "options": idx.options.to_json(),
             "shardWidth": SHARD_WIDTH,
             "fields": [{"name": f.name, "options": f.options.to_json()}
                        for f in idx.public_fields()]}
            for idx in sorted(self.indexes.values(), key=lambda i: i.name)]
