"""Write-ahead log: crash-safe durability for the host-canonical planes.

Port of ``pilosa_tpu/storage/wal.py`` with the same bytes on disk: a log
written by either package replays in the other (records hold numpy
arrays and Python scalars, never torch tensors). The flush's stage
accounting for the device profiler is not ported.

The reference's durability is RBF's page WAL + checkpoint (rbf/db.go:44,
WAL copy-back at :149-230) — physical 8KB pages because its storage is a
mmap B-tree. Here the host store is dense numpy planes snapshotted as npz
(storage/store.py = the checkpoint), so the WAL logs *logical* write
operations between checkpoints and recovery replays them through the same
field-level write methods that produced them (deterministic; the analog of
DAX's op-level writelogger, dax/writelogger/writelogger.go:22).

The log is SEGMENTED: records land in numbered files
``<base>.00000001``, ``<base>.00000002``, ... and the writer rotates to a
fresh segment once the active one passes ``segment_bytes``. Every record
carries a monotonic LSN, so a checkpoint stamped with LSN ``L`` can prune
exactly the segments whose records are all <= L and leave the tail for
replay (or for shipping to a lagging replica — storage/recovery.py). The
LSN counter never resets, not even across truncate(), so any two states
of one holder are ordered by it.

Framing per record: ``<u32 crc32(lsn||payload)><u32 payload len><u64 lsn>``
followed by the payload — pickle of a plain tuple (host-trusted file,
like any DB's WAL). A zero-length payload whose CRC checks out is a
*marker* (each segment opens with one carrying the base LSN — the last
LSN assigned before the segment existed); replay skips it and keeps
going. A short header or a CRC/length mismatch is a torn tail (crash
mid-append) and replay stops there — everything before it is intact,
matching WAL semantics. The two cases used to be conflated ("stop" for
both), which would have dropped everything after a legitimate empty
record; now only genuine tears stop the scan.

Sync modes (reference: rbf cfg fsync knobs, rbf/cfg/cfg.go):
- "batch" (default): buffered appends, fsync once per flush() — the group
  commit issued at the end of each API request (Qcx.finish).
- "always": fsync every append.
- "never": OS-buffered only (tests/bulk loads).
"""

from __future__ import annotations

import os
import pickle
import re
import struct
import time
import zlib
from typing import Iterator, List, Optional, Tuple

from pilosa_tpu_torch.analysis import locktrace
from pilosa_tpu_torch.obs import devprof

# crc32 over (lsn bytes || payload), payload length, lsn
_HDR = struct.Struct("<IIQ")
_LSN = struct.Struct("<Q")
# pre-segmentation framing: crc32 over payload alone, payload length —
# no LSN. Only ever seen in a bare <base> file left by an old install.
_LEGACY_HDR = struct.Struct("<II")
_SEG_RE = re.compile(r"\.(\d{8})$")

DEFAULT_SEGMENT_BYTES = 4 << 20

# Process-wide append observer: called with the framed byte count of
# every appended record, AFTER the WAL lock is released. The tenant
# attribution plane (obs/tenants.py) chains through it to charge WAL
# bytes to the writing tenant; None (the default) costs one load per
# append.
_APPEND_HOOK = None


def set_append_hook(hook) -> None:
    """Install (or clear, with None) the per-append byte observer
    (``(nbytes: int) -> None``). Chain by capturing the previous value
    before installing."""
    global _APPEND_HOOK
    _APPEND_HOOK = hook


def fsync_dir(path: str) -> None:
    """fsync a directory so renames/creates/unlinks inside it survive
    power loss, not just process death (the missing half of the classic
    tmp+rename pattern)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # pragma: no cover - exotic filesystems
        return
    try:
        os.fsync(fd)
    except OSError:  # pragma: no cover
        pass
    finally:
        os.close(fd)


def _scan_segment(path: str) -> Tuple[int, int, int, bool]:
    """Walk one segment's frames: (valid bytes, record bytes excluding
    markers, max lsn seen, torn?). Stops at the first torn/corrupt
    frame; bytes behind a tear are unreachable garbage."""
    valid = rec_bytes = max_lsn = 0
    torn = False
    with open(path, "rb") as f:
        while True:
            hdr = f.read(_HDR.size)
            if len(hdr) < _HDR.size:
                torn = len(hdr) > 0  # short header = tear; EOF = clean
                break
            crc, n, lsn = _HDR.unpack(hdr)
            payload = f.read(n)
            if len(payload) < n or \
                    zlib.crc32(_LSN.pack(lsn) + payload) != crc:
                torn = True
                break
            valid += _HDR.size + n
            if n:  # n == 0 is a valid marker, not a torn header
                rec_bytes += _HDR.size + n
            max_lsn = max(max_lsn, lsn)
    return valid, rec_bytes, max_lsn, torn


def _scan_legacy(path: str) -> List[bytes]:
    """Payloads of the intact prefix of a pre-segmentation ``<II>``-framed
    log (crc over payload only, no LSN); stops at the first torn/corrupt
    frame. An empty list means the file carries no legacy records."""
    out: List[bytes] = []
    with open(path, "rb") as f:
        while True:
            hdr = f.read(_LEGACY_HDR.size)
            if len(hdr) < _LEGACY_HDR.size:
                break
            crc, n = _LEGACY_HDR.unpack(hdr)
            payload = f.read(n)
            if len(payload) < n or zlib.crc32(payload) != crc:
                break
            out.append(payload)
    return out


class _Segment:
    __slots__ = ("seq", "path", "record_bytes", "max_lsn")

    def __init__(self, seq: int, path: str, record_bytes: int = 0,
                 max_lsn: int = 0):
        self.seq = seq
        self.path = path
        self.record_bytes = record_bytes
        self.max_lsn = max_lsn


class WAL:
    """Single-writer log shared by concurrent request threads — the
    server handles queries on a ThreadingHTTPServer, so every file
    mutation holds the instance lock (the reference serializes through
    RBF's single-writer tx lock instead, rbf/db.go)."""

    def __init__(self, path: str, sync: str = "batch",
                 segment_bytes: int = DEFAULT_SEGMENT_BYTES,
                 crash_plan=None):
        if sync not in ("always", "batch", "never"):
            raise ValueError(f"bad sync mode {sync!r}")
        self.base = path
        self.sync = sync
        self.segment_bytes = max(1, int(segment_bytes))
        self.replaying = False  # when True, writers must not re-log
        # storage/recovery.CrashPlan (or None): consulted at the
        # wal.append / wal.flush kill sites; once it has fired, this
        # "process" is dead and every hooked operation silently no-ops.
        self.crash_plan = crash_plan
        self._lock = locktrace.tracked_lock("storage.wal")
        self._dir = os.path.dirname(path)
        os.makedirs(self._dir, exist_ok=True)
        self._lsn = 0
        self._segments: List[_Segment] = []
        self._dirty = False
        # monotonic stamp of the oldest append still awaiting its write
        # barrier (None when clean) — the health plane's WAL-stall read
        self._dirty_since: Optional[float] = None
        # record bytes since the last write barrier: the device
        # profiler's ``wal_commit`` stage bytes
        self._pending_flush_bytes = 0
        self._open_existing()

    # -- open / segments -----------------------------------------------------

    def _open_existing(self) -> None:
        base_name = os.path.basename(self.base)
        seqs = []
        for name in os.listdir(self._dir):
            if not name.startswith(base_name + "."):
                continue
            m = _SEG_RE.search(name)
            if m:
                seqs.append(int(m.group(1)))
        seqs.sort()
        for seq in seqs:
            p = self._seg_path(seq)
            _valid, rec_bytes, max_lsn, _torn = _scan_segment(p)
            self._segments.append(_Segment(seq, p, rec_bytes, max_lsn))
            self._lsn = max(self._lsn, max_lsn)
        if os.path.isfile(self.base):
            self._adopt_base()
        if self._segments:
            self._f = open(self._segments[-1].path, "ab")
        else:
            self._new_segment_locked(1)

    def _adopt_base(self) -> None:
        """Adopt a pre-segmentation single-file ``<base>`` log as the
        next segment. A file already in segment framing (or empty) is
        renamed in place; a legacy ``<II>``-framed log (old installs:
        crc over payload, no LSN) is rewritten frame-by-frame with
        synthesized LSNs — renaming it untouched would make every frame
        fail the new crc-over-(lsn||payload) check, scan as torn at byte
        0, and get silently truncated by the first repair()."""
        seq = (self._segments[-1].seq + 1) if self._segments else 1
        path = self._seg_path(seq)
        valid, _rb, _ml, torn = _scan_segment(self.base)
        legacy = _scan_legacy(self.base) if valid == 0 and torn else []
        if not legacy:
            os.rename(self.base, path)
            fsync_dir(self._dir)
            _valid, rec_bytes, max_lsn, _torn = _scan_segment(path)
            self._segments.append(_Segment(seq, path, rec_bytes, max_lsn))
            self._lsn = max(self._lsn, max_lsn)
            return
        tmp = path + ".tmp"
        rec_bytes = 0
        with open(tmp, "wb") as f:
            f.write(_HDR.pack(zlib.crc32(_LSN.pack(self._lsn)), 0,
                              self._lsn))
            for payload in legacy:
                self._lsn += 1
                f.write(_HDR.pack(
                    zlib.crc32(_LSN.pack(self._lsn) + payload),
                    len(payload), self._lsn) + payload)
                rec_bytes += _HDR.size + len(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        os.unlink(self.base)
        fsync_dir(self._dir)
        self._segments.append(_Segment(seq, path, rec_bytes, self._lsn))

    def _seg_path(self, seq: int) -> str:
        return f"{self.base}.{seq:08d}"

    def _new_segment_locked(self, seq: int) -> None:
        """Create + activate segment ``seq``, stamped with a marker frame
        carrying the base LSN (the last LSN assigned before this segment
        existed — the prune boundary for everything before it)."""
        path = self._seg_path(seq)
        f = open(path, "wb")
        f.write(_HDR.pack(zlib.crc32(_LSN.pack(self._lsn)), 0, self._lsn))
        f.flush()
        if self.sync != "never":
            os.fsync(f.fileno())
        fsync_dir(self._dir)
        self._segments.append(_Segment(seq, path))
        self._f = f

    def _rotate_locked(self) -> None:
        self._flush_locked()
        if self.sync == "never":  # make the sealed tail readable
            self._f.flush()
        self._f.close()
        self._new_segment_locked(self._segments[-1].seq + 1)

    @property
    def path(self) -> str:
        """The ACTIVE segment's path (tests and tooling poke bytes at the
        write frontier; sealed segments are immutable)."""
        return self._segments[-1].path

    @property
    def last_lsn(self) -> int:
        return self._lsn

    # -- write side ----------------------------------------------------------

    def append(self, record: Tuple) -> Optional[int]:
        """Append one record; returns its LSN (None when replaying or
        when the simulated process is dead)."""
        if self.replaying:
            return None
        plan = self.crash_plan
        if plan is not None and not plan.fire("wal.append"):
            return None
        with self._lock:
            lsn = self._lsn + 1
            payload = pickle.dumps(record, protocol=5)
            framed = _HDR.pack(zlib.crc32(_LSN.pack(lsn) + payload),
                               len(payload), lsn) + payload
            self._f.write(framed)  # one write: no interleaved half-records
            self._lsn = lsn
            seg = self._segments[-1]
            seg.record_bytes += len(framed)
            seg.max_lsn = lsn
            self._pending_flush_bytes += len(framed)
            if not self._dirty:
                self._dirty_since = time.monotonic()
            self._dirty = True
            if self.sync == "always":
                self._flush_locked()
            if seg.record_bytes + _HDR.size >= self.segment_bytes:
                self._rotate_locked()
        hook = _APPEND_HOOK
        if hook is not None:  # outside the lock: accounting never blocks I/O
            hook(len(framed))
        return lsn

    def _flush_locked(self) -> None:
        if not self._dirty:
            return
        t0 = time.perf_counter() if devprof.ENABLED else None
        self._f.flush()
        if self.sync != "never":
            os.fsync(self._f.fileno())
        if t0 is not None:
            devprof.record_stage("wal_commit", time.perf_counter() - t0,
                                 nbytes=self._pending_flush_bytes)
        self._pending_flush_bytes = 0
        self._dirty = False
        self._dirty_since = None

    def flush_lag_s(self) -> float:
        """Seconds the oldest unflushed append has waited for a write
        barrier (0 when clean) — a stall here means a group commit is
        stuck, the flight recorder's ``wal_stall`` trigger."""
        with self._lock:
            if self._dirty_since is None:
                return 0.0
            return max(0.0, time.monotonic() - self._dirty_since)

    def flush(self) -> None:
        """Group commit: one write barrier for everything appended since
        the last flush (reference: rbf tx commit fsync)."""
        plan = self.crash_plan
        if plan is not None and not plan.fire("wal.flush"):
            return
        with self._lock:
            self._flush_locked()

    @property
    def size(self) -> int:
        """Total physical bytes across all segments (markers included)."""
        with self._lock:
            self._f.flush()
            total = 0
            for seg in self._segments:
                try:
                    total += os.path.getsize(seg.path)
                except OSError:
                    pass
            return total

    @property
    def record_bytes(self) -> int:
        """Bytes of actual records (markers excluded) — the checkpoint
        trigger: 0 right after a checkpoint even though each fresh
        segment physically holds its 16-byte marker."""
        with self._lock:
            return sum(seg.record_bytes for seg in self._segments)

    def truncate(self) -> None:
        """Drop all records — called after a checkpoint persisted the
        planes they subsume (reference: rbf/db.go WAL copy-back). The
        LSN counter is NOT reset; segment numbering keeps climbing so a
        crash mid-truncate never resurrects a reused name."""
        with self._lock:
            self._flush_locked()
            self._f.close()
            next_seq = self._segments[-1].seq + 1
            for seg in self._segments:
                try:
                    os.unlink(seg.path)
                except OSError:
                    pass
            self._segments = []
            fsync_dir(self._dir)
            self._new_segment_locked(next_seq)

    def prune(self, upto_lsn: int) -> int:
        """Fuzzy-checkpoint GC: rotate the active segment if it holds
        records, then delete every SEALED segment whose records are all
        <= ``upto_lsn``. A segment with any record above the checkpoint
        LSN survives whole — replay is op-idempotent, so re-applying its
        below-LSN prefix over the snapshot is harmless. Returns segments
        removed."""
        with self._lock:
            if self._segments[-1].record_bytes > 0:
                self._rotate_locked()
            keep: List[_Segment] = []
            removed = 0
            for seg in self._segments[:-1]:
                if seg.max_lsn <= upto_lsn:
                    try:
                        os.unlink(seg.path)
                    except OSError:
                        pass
                    removed += 1
                else:
                    keep.append(seg)
            self._segments = keep + self._segments[-1:]
            if removed:
                fsync_dir(self._dir)
            return removed

    def close(self) -> None:
        with self._lock:
            self._flush_locked()
            self._f.close()

    # -- read side -----------------------------------------------------------

    def _frames(self, after_lsn: int = 0) -> Iterator[Tuple[int, Tuple, int]]:
        """(lsn, record, frame bytes) for every intact record above
        ``after_lsn``, across segments in order; markers skipped; stops
        at the first torn/corrupt frame (tears only ever occur at the
        true write frontier — sealed segments are immutable)."""
        with self._lock:
            self._f.flush()
            paths = [seg.path for seg in self._segments]
        for path in paths:
            try:
                f = open(path, "rb")
            except OSError:
                continue
            with f:
                while True:
                    hdr = f.read(_HDR.size)
                    if len(hdr) < _HDR.size:
                        if len(hdr) > 0:
                            return  # torn header
                        break  # clean segment end
                    crc, n, lsn = _HDR.unpack(hdr)
                    payload = f.read(n)
                    if len(payload) < n or \
                            zlib.crc32(_LSN.pack(lsn) + payload) != crc:
                        return  # torn tail
                    if n == 0:  # marker: valid, carries no record
                        continue
                    if lsn > after_lsn:
                        yield lsn, pickle.loads(payload), _HDR.size + n

    def replay(self, after_lsn: int = 0) -> Iterator[Tuple[int, Tuple, int]]:
        """Replay iterator for recovery: (lsn, record, frame bytes) with
        lsn > ``after_lsn`` (the checkpoint LSN)."""
        return self._frames(after_lsn)

    def records(self) -> Iterator[Tuple]:
        """All intact records (compat surface; stops silently at a
        torn/corrupt tail)."""
        return (rec for _lsn, rec, _nb in self._frames(0))

    def valid_prefix(self) -> int:
        """Byte length of the intact frame prefix across all segments."""
        with self._lock:
            self._f.flush()
            paths = [seg.path for seg in self._segments]
        good = 0
        for path in paths:
            valid, _rb, _ml, torn = _scan_segment(path)
            good += valid
            if torn or valid < os.path.getsize(path):
                break
        return good

    def repair(self) -> None:
        """Chop a torn tail so post-recovery appends don't land behind
        garbage (which the next replay would stop at, silently dropping
        them). Segments after the torn one are unreachable by replay and
        are dropped too. Called once after recovery replay."""
        with self._lock:
            self._f.flush()
            bad = None
            for i, seg in enumerate(self._segments):
                valid, rec_bytes, max_lsn, torn = _scan_segment(seg.path)
                seg.record_bytes = rec_bytes
                seg.max_lsn = max_lsn
                if torn or valid < os.path.getsize(seg.path):
                    bad = (i, valid)
                    break
            if bad is None:
                return
            i, valid = bad
            self._f.close()
            seg = self._segments[i]
            with open(seg.path, "r+b") as f:
                f.truncate(valid)
                f.flush()
                os.fsync(f.fileno())
            for later in self._segments[i + 1:]:
                try:
                    os.unlink(later.path)
                except OSError:
                    pass
            self._segments = self._segments[:i + 1]
            fsync_dir(self._dir)
            self._f = open(seg.path, "ab")

    # -- log shipping (storage/recovery.py catch-up) -------------------------

    def tail_bytes(self, since_lsn: int,
                   max_bytes: int = 1 << 20) -> Tuple[bytes, int, bool]:
        """Raw CRC-framed bytes of records with lsn > ``since_lsn``:
        (frames, last lsn included, more remaining). At least one frame
        ships even when it alone exceeds ``max_bytes``; the receiver
        parses with :func:`iter_frames` and applies idempotently."""
        chunks: List[bytes] = []
        total = 0
        last = since_lsn
        for lsn, rec, _nb in self._frames(since_lsn):
            payload = pickle.dumps(rec, protocol=5)
            framed = _HDR.pack(zlib.crc32(_LSN.pack(lsn) + payload),
                               len(payload), lsn) + payload
            if chunks and total + len(framed) > max_bytes:
                return b"".join(chunks), last, True
            chunks.append(framed)
            total += len(framed)
            last = lsn
        return b"".join(chunks), last, False


def iter_frames(data: bytes) -> Iterator[Tuple[int, Tuple]]:
    """Parse shipped WAL frames (tail_bytes payloads): yields (lsn,
    record); raises ValueError on a corrupt frame — shipped tails come
    from intact segments, so damage means transport corruption, not a
    tear to tolerate."""
    off = 0
    while off < len(data):
        if off + _HDR.size > len(data):
            raise ValueError("truncated WAL frame header")
        crc, n, lsn = _HDR.unpack_from(data, off)
        payload = data[off + _HDR.size: off + _HDR.size + n]
        if len(payload) < n or zlib.crc32(_LSN.pack(lsn) + payload) != crc:
            raise ValueError("corrupt WAL frame")
        off += _HDR.size + n
        if n == 0:
            continue
        yield lsn, pickle.loads(payload)


def pack_plane(plane) -> bytes:
    """Compressed plane bytes for plane-granular records (Store/Delete);
    dense zero runs deflate to almost nothing."""
    import numpy as np

    arr = np.ascontiguousarray(plane, dtype=np.uint32)
    return zlib.compress(arr.tobytes(), level=1)


def unpack_plane(data: bytes, words: int):
    import numpy as np

    return np.frombuffer(zlib.decompress(data), dtype=np.uint32)[:words].copy()
