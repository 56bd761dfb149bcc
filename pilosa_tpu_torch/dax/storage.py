"""Writelogger + Snapshotter: DAX durability on a shared filesystem.

Port of ``pilosa_tpu/dax/storage.py`` with the same bytes on disk: a
log or a snapshot written by either package replays in the other. Op
payloads are JSON; snapshots are ``np.savez_compressed`` of host numpy
planes (never tensors).

Reference: dax/writelogger/writelogger.go:22 (append-only op logs per
table/partition; durability = the log, computers are stateless) and
dax/snapshotter/snapshotter.go (versioned shard snapshots; resume =
snapshot + log replay, dax/storage/). Layout:

    <root>/wl/<table>/<shard>.<seq:08d>   CRC-framed log segments
    <root>/snap/<table>/<shard>.<v>.npz   planes at log version v

The writelog borrows storage/wal.py's segment framing wholesale: each
record is ``<u32 crc32(lsn||payload)><u32 len><u64 lsn>`` + a JSON op
payload, every segment opens with a zero-length marker frame carrying
the base LSN, a torn tail stops replay (crash mid-append — the op was
never acked), and segments rotate past ``segment_bytes`` so a snapshot
can prune exactly the sealed segments it covers. The LSN here IS the
log version: op count per (table, shard), so ``length()`` and
``replay(from_version)`` keep the op-count semantics.

Group commit (sync="batch", the default): ``append`` buffers; ``commit``
issues one flush+fsync for every op buffered since the last barrier, and
skips entirely when a concurrent committer already fsynced past the
caller's LSN — N writers to one hot shard share one disk flush. Locks
are per-(table, shard) (each shard log carries its own tracked lock), so
appends to different shards never serialize on each other's fsync.

A snapshot's version is the log offset (op count) it covers; replay
starts after it. Ops are either replayable PQL write calls or bulk
imports — both deterministic, so replay through the normal engine write
path reproduces the planes bit for bit.
"""

from __future__ import annotations

import io
import json
import os
import re
import shutil
import time
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from pilosa_tpu_torch.analysis import locktrace
from pilosa_tpu_torch.obs import metrics as obs_metrics
from pilosa_tpu_torch.storage.wal import _HDR, _LSN, _scan_segment, fsync_dir

# <shard>.<8-digit segment seq> — the wal.py segment naming applied
# per-shard (shards() must not confuse shard 12's segments with 1's)
_SHARD_SEG_RE = re.compile(r"^(\d+)\.(\d{8})$")
_SNAP_RE = re.compile(r"^(\d+)\.(\d+)\.npz$")

DEFAULT_SEGMENT_BYTES = 1 << 20


def _frame(lsn: int, payload: bytes) -> bytes:
    return _HDR.pack(zlib.crc32(_LSN.pack(lsn) + payload),
                     len(payload), lsn)


class _ShardLog:
    """One (table, shard)'s segmented op log. Own lock — the striping
    that keeps concurrent shard appends off each other's fsync."""

    def __init__(self, dirpath: str, shard: int, segment_bytes: int):
        self.dir = dirpath
        self.shard = shard
        self.segment_bytes = max(1, int(segment_bytes))
        self.lock = locktrace.tracked_lock(f"dax.wl.{shard}")
        self.lsn = 0            # last assigned op index == log version
        self._synced_lsn = 0    # highest lsn a commit barrier covers
        self._seg_bytes = 0     # record bytes in the active segment
        self._segs: List[Tuple[int, str, int]] = []  # (seq, path, max_lsn)
        self._f = None
        self._open()

    # -- open / adopt ------------------------------------------------------

    def _seg_path(self, seq: int) -> str:
        return os.path.join(self.dir, f"{self.shard}.{seq:08d}")

    def _open(self) -> None:
        seqs = []
        for name in os.listdir(self.dir):
            m = _SHARD_SEG_RE.match(name)
            if m and int(m.group(1)) == self.shard:
                seqs.append(int(m.group(2)))
        for seq in sorted(seqs):
            p = self._seg_path(seq)
            _valid, rec_bytes, max_lsn, _torn = _scan_segment(p)
            self._segs.append((seq, p, max_lsn))
            self.lsn = max(self.lsn, max_lsn)
            self._seg_bytes = rec_bytes
        legacy = os.path.join(self.dir, f"{self.shard}.jsonl")
        if not self._segs and os.path.exists(legacy):
            self._adopt_jsonl(legacy)
            return
        self._synced_lsn = self.lsn
        if self._segs:
            self._f = open(self._segs[-1][1], "ab")
        else:
            self._new_segment()

    def _adopt_jsonl(self, path: str) -> None:
        """Rewrite a JSONL log of the first on-disk form into segment
        framing (the wal.py _adopt_base discipline: rename-in-place
        would scan as torn at byte 0 and silently truncate)."""
        self._new_segment()
        with open(path) as f:
            for line in f:
                if line.strip():
                    self._append_bytes(line.strip().encode("utf-8"))
        self.flush(fsync=True)
        os.remove(path)
        fsync_dir(self.dir)

    def _new_segment(self) -> None:
        seq = (self._segs[-1][0] + 1) if self._segs else 1
        path = self._seg_path(seq)
        if self._f is not None:
            self._f.flush()
            os.fsync(self._f.fileno())
            self._f.close()
        self._f = open(path, "ab")
        # marker frame: base LSN survives even after older segments prune
        self._f.write(_frame(self.lsn, b""))
        self._segs.append((seq, path, self.lsn))
        self._seg_bytes = 0
        fsync_dir(self.dir)

    # -- append / commit ---------------------------------------------------

    def _append_bytes(self, payload: bytes) -> int:
        self.lsn += 1
        self._f.write(_frame(self.lsn, payload))
        self._f.write(payload)
        self._seg_bytes += _HDR.size + len(payload)
        self._segs[-1] = (self._segs[-1][0], self._segs[-1][1], self.lsn)
        if self._seg_bytes >= self.segment_bytes:
            self.flush(fsync=True)
            self._new_segment()
        return self.lsn

    def flush(self, fsync: bool) -> None:
        if self._f is None:
            return
        self._f.flush()
        if fsync:
            os.fsync(self._f.fileno())
            self._synced_lsn = self.lsn

    def commit(self, upto: Optional[int] = None) -> bool:
        """Durability barrier: fsync if any op at or below ``upto``
        (default: all) is still unsynced. Returns whether a flush was
        actually issued — False means a concurrent committer's barrier
        already covered us (the group-commit share)."""
        target = self.lsn if upto is None else upto
        if self._synced_lsn >= target:
            return False
        self.flush(fsync=True)
        return True

    # -- replay / prune ----------------------------------------------------

    def replay(self, from_version: int) -> Iterator[dict]:
        for _seq, path, _max in list(self._segs):
            with open(path, "rb") as f:
                while True:
                    hdr = f.read(_HDR.size)
                    if len(hdr) < _HDR.size:
                        break
                    crc, n, lsn = _HDR.unpack(hdr)
                    payload = f.read(n)
                    if len(payload) < n or \
                            zlib.crc32(_LSN.pack(lsn) + payload) != crc:
                        return  # torn tail: nothing past it was acked
                    if n and lsn > from_version:
                        yield json.loads(payload)

    def prune(self, upto: int) -> int:
        """Drop sealed segments fully covered by a snapshot at log
        version ``upto`` (never the active segment)."""
        removed = 0
        keep = []
        for seq, path, max_lsn in self._segs:
            if max_lsn <= upto and path != self._segs[-1][1]:
                try:
                    os.remove(path)
                    removed += 1
                    continue
                except OSError:
                    pass
            keep.append((seq, path, max_lsn))
        if removed:
            self._segs = keep
            fsync_dir(self.dir)
        return removed

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


class WriteLogger:
    def __init__(self, root: str, *, sync: str = "batch",
                 segment_bytes: int = DEFAULT_SEGMENT_BYTES,
                 crash_plan=None, registry=None):
        if sync not in ("always", "batch", "never"):
            raise ValueError(f"bad sync mode {sync!r}")
        self.root = os.path.join(root, "wl")
        os.makedirs(self.root, exist_ok=True)
        self.sync = sync
        self.segment_bytes = segment_bytes
        # storage/recovery.CrashPlan (or None): consulted at the
        # dax.wl.append kill site; once fired this "process" is dead and
        # every append/commit silently no-ops.
        self.crash_plan = crash_plan
        self.registry = registry if registry is not None \
            else obs_metrics.REGISTRY
        self._logs: Dict[Tuple[str, int], _ShardLog] = {}
        # guards only the log map; per-shard appends hold the shard
        # log's own lock, so one shard's fsync never stalls another's
        self._maplock = locktrace.tracked_lock("dax.wl.map")

    def _log(self, table: str, shard: int) -> _ShardLog:
        key = (table, shard)
        with self._maplock:
            lg = self._logs.get(key)
            if lg is None:
                d = os.path.join(self.root, table)
                os.makedirs(d, exist_ok=True)
                lg = _ShardLog(d, shard, self.segment_bytes)
                self._logs[key] = lg
            return lg

    def append(self, table: str, shard: int, op: dict) -> Optional[int]:
        """Append one op; returns the new log length (the version a
        subsequent snapshot would cover), or None once a crash plan has
        fired (dead process: no IO). Durable only after :meth:`commit`
        in batch mode (always-mode fsyncs inline)."""
        plan = self.crash_plan
        payload = json.dumps(op, separators=(",", ":")).encode("utf-8")
        lg = self._log(table, shard)
        # kill point fires before the critical section (plan.fire takes
        # its own lock — never call out while holding ours)
        if plan is not None and not plan.fire("dax.wl.append"):
            return None
        with lg.lock:
            lsn = lg._append_bytes(payload)
            if self.sync == "always":
                lg.flush(fsync=True)
            return lsn

    def commit(self, table: str, shard: int,
               upto: Optional[int] = None) -> None:
        """Group-commit barrier for one shard log: one fsync covers
        every op appended since the last barrier (skipped when a
        concurrent committer already synced past ``upto``)."""
        plan = self.crash_plan
        if plan is not None and plan.dead:
            return
        if self.sync == "never":
            return
        lg = self._log(table, shard)
        t0 = time.perf_counter()
        with lg.lock:
            flushed = lg.commit(upto)
        if flushed:
            self.registry.observe_bucketed(
                obs_metrics.METRIC_DAX_WL_APPEND_SECONDS,
                time.perf_counter() - t0,
                obs_metrics.DAX_WL_APPEND_BUCKETS)

    def length(self, table: str, shard: int) -> int:
        lg = self._log(table, shard)
        with lg.lock:
            return lg.lsn

    def prune(self, table: str, shard: int, upto: int) -> int:
        lg = self._log(table, shard)
        with lg.lock:
            return lg.prune(upto)

    def drop_table(self, table: str) -> None:
        with self._maplock:
            for key in [k for k in self._logs if k[0] == table]:
                self._logs.pop(key).close()
            d = os.path.join(self.root, table)
            if os.path.isdir(d):
                shutil.rmtree(d, ignore_errors=True)

    def replay(self, table: str, shard: int,
               from_version: int = 0) -> Iterator[dict]:
        d = os.path.join(self.root, table)
        if not os.path.isdir(d):
            return
        lg = self._log(table, shard)
        with lg.lock:
            lg.flush(fsync=False)
            yield from lg.replay(from_version)

    def shards(self, table: str) -> List[int]:
        d = os.path.join(self.root, table)
        if not os.path.isdir(d):
            return []
        out = set()
        for name in os.listdir(d):
            m = _SHARD_SEG_RE.match(name)
            if m:
                out.add(int(m.group(1)))
            elif name.endswith(".jsonl"):  # JSONL log awaiting adoption
                try:
                    out.add(int(name[:-6]))
                except ValueError:
                    pass
        return sorted(out)

    def tables(self) -> List[str]:
        return sorted(t for t in os.listdir(self.root)
                      if os.path.isdir(os.path.join(self.root, t)))

    def close(self) -> None:
        with self._maplock:
            for lg in self._logs.values():
                lg.close()
            self._logs.clear()


class Snapshotter:
    """Versioned per-(table, shard) plane snapshots (compaction points
    for the writelog). Writes follow the storage/store._atomic_savez
    discipline — tmp write + fsync, rename, dir fsync — with the
    ``dax.snap.replace`` kill point between fsync and rename."""

    def __init__(self, root: str, crash_plan=None):
        self.root = os.path.join(root, "snap")
        os.makedirs(self.root, exist_ok=True)
        self.crash_plan = crash_plan

    def _dir(self, table: str) -> str:
        d = os.path.join(self.root, table)
        os.makedirs(d, exist_ok=True)
        return d

    def _versions(self, table: str, shard: int) -> List[int]:
        """The one filename scan behind latest()/latest_version()."""
        d = os.path.join(self.root, table)
        out = []
        if os.path.isdir(d):
            for fname in os.listdir(d):
                m = _SNAP_RE.match(fname)
                if m and int(m.group(1)) == shard:
                    out.append(int(m.group(2)))
        return sorted(out)

    def write(self, table: str, shard: int, version: int,
              arrays: Dict[str, np.ndarray]) -> bool:
        """Atomic write of the shard's planes at log ``version``; older
        versions of the same shard are pruned. Strictly NEWER versions
        are kept — two racing snapshotters (old and new owner during a
        handoff) must never delete each other's later work. Returns
        False when a crash plan killed the write."""
        plan = self.crash_plan
        if plan is not None and plan.dead:
            return False
        d = self._dir(table)
        final = os.path.join(d, f"{shard}.{version}.npz")
        tmp = final + ".tmp"
        buf = io.BytesIO()
        np.savez_compressed(buf, **arrays)
        with open(tmp, "wb") as f:
            f.write(buf.getvalue())
            f.flush()
            os.fsync(f.fileno())
        if plan is not None and not plan.fire("dax.snap.replace"):
            return False
        os.replace(tmp, final)
        fsync_dir(d)
        for fname in os.listdir(d):
            m = _SNAP_RE.match(fname)
            if m and int(m.group(1)) == shard and int(m.group(2)) < version:
                try:
                    os.remove(os.path.join(d, fname))
                except OSError:
                    pass
        return True

    def drop_table(self, table: str) -> None:
        d = os.path.join(self.root, table)
        if os.path.isdir(d):
            shutil.rmtree(d, ignore_errors=True)

    def latest_version(self, table: str, shard: int) -> int:
        """Newest snapshot's covered log version (0 = none) — a filename
        scan, no payload load."""
        versions = self._versions(table, shard)
        return versions[-1] if versions else 0

    def latest(self, table: str, shard: int
               ) -> Optional[Tuple[int, Dict[str, np.ndarray]]]:
        versions = self._versions(table, shard)
        if not versions:
            return None
        best = versions[-1]
        path = os.path.join(self.root, table, f"{shard}.{best}.npz")
        with np.load(path) as z:
            return best, {k: z[k] for k in z.files}
