"""Kernel performance attribution: an analytic cost model, MFU and
roofline shares per kernel family, and per-stage ingest throughput.

Port of ``pilosa_tpu/obs/devprof.py``. The cost model (``tape_cost``),
``family_name``, ``shape_bucket``, :class:`KernelProfileRegistry`,
:class:`IngestAccounting`, ``kernel_scope``, ``ingest_scope``,
``record_stage``, ``stats_json`` and ``timeline_probe`` keep the JAX
package's formulas and keys: the same arguments give the same FLOPs,
bytes and family names in both packages, and each entry is keyed by the
engine mesh's ``mesh_epoch`` (``parallel/mesh.py``), so a mesh switch
profiles apart. Two things differ, because the port runs on a card whose launches are
asynchronous:

**Device time on the card, without a sync on the query path.** The JAX
package times the wall clock around a dispatch, which on an
asynchronous backend is a launch floor, not device time. Here every
launch site of the five kernels times itself (``launch``): on a CUDA
tensor the kernel reads the card's nanosecond timer when its first
block starts and its last block ends, and its last block writes the span
to pinned host words (``csrc/launch_timing.cuh``). The launch is queued
with its profile entry and the host seconds of the launch call on a
bounded pending list; a launch whose end word is set is done, and is
folded in at the next launch; only the admin reads
(``KERNELS.snapshot``, ``stats_json``, ``timeline_probe``) and a full
list wait, on the launch's stream. ``device_seconds`` and every rate
derived from it come from the kernel's clock, ``dispatch_seconds`` is
the host time of the launch call. (An event pair around the kernel
would read the stream's time instead: on an H100 an empty pair alone
takes about 3 us of it, and a pair behind a copy waits for it.) A
``plane`` program's eager op chain has no kernel of its own: a pair of
``torch.cuda.Event(enable_timing=True)`` around it is its device time
(``time_body``), folded in once its end event's ``query()`` is true. On
CPU tensors the plain versions run synchronously, so the wall time is
the device time, as in the JAX
package on the CPU. A tape family is an attribution scope
(``kernel_scope``) around one program run: its ``tape_count`` launch, or
its eager chain, records under it; a launch outside any scope lands in
``other``.

**The peak table names the card.** :func:`peaks` looks the card up by
``torch.cuda.get_device_name()``; an unnamed card gets no MFU or
bandwidth share unless ``PILOSA_TPU_DEVPROF_PEAK_TFLOPS`` /
``PILOSA_TPU_DEVPROF_PEAK_GBPS`` give its peaks.

**Device seconds per tenant, at the fold.** The JAX package charges a
dispatch's wall time to the calling tenant from a synchronous dispatch
hook. A launch here is read when it folds, which can happen later, on
another thread, under another tenant; so a launch captures the tenant of
the thread that opens it (``obs/tenants.current_tenant_id``), carries it
on the pending list, and at the fold the fold hook (``set_fold_hook``,
which the tenant registry chains) receives ``(tenant, device_seconds)``.
While a fold hook is installed the launch sites time their launches
(``TIMED``) even with the profiler's tables off; such a launch is folded
into no profile. On the CPU a launch's slot is its wall clock, folded
through the same list.

Zero cost when disabled: ``ENABLED`` is False by default
(``PILOSA_TPU_DEVPROF=1`` turns it on at import), every instrumentation
site checks the module flag first, and a disabled launch site creates
no event, no profile and evaluates no cost (``cost_evals()``,
``KERNELS.allocations`` and ``EVENTS_CREATED`` back that assert).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import torch

from pilosa_tpu_torch import platform
from pilosa_tpu_torch.analysis import locktrace
from pilosa_tpu_torch.config import env_bool
from pilosa_tpu_torch.obs import metrics as M
from pilosa_tpu_torch.obs.tenants import current_tenant_id

#: Module switch consulted by every instrumentation site (the launch
#: sites, the programs, ingest, the WAL). Flip via enable()/disable() so
#: the h2d hook stays in sync; operators use the env var.
ENABLED = env_bool("PILOSA_TPU_DEVPROF", False)

#: Fold hook ``(tenant, device_seconds) -> None`` called for every timed
#: launch when it folds (obs/tenants.py chains through it); None costs
#: nothing.
_FOLD_HOOK = None

#: The launch sites time a launch while this is true: the profiler is on
#: or a fold hook is installed.
TIMED = ENABLED

WORD_BYTES = 4   # planes are 32-bit words
BIT_LANES = 32   # one 32-bit bitwise op = 32 bit-ops ("flops" here)

#: Card name (``torch.cuda.get_device_name()``) or ``cpu`` -> (peak
#: bit-op TOP/s, peak memory GB/s, where the figures come from). The
#: H100 row holds the data sheet's figures, the ones the port's bounds
#: use (chip_smoke.py): 3.35 TB/s of HBM3 and 1,979 TOP/s of dense INT8
#: tensor-core work, taken for 1-bit operations. The CPU row is an
#: order-of-magnitude host default (a relative gauge, not a data-sheet
#: claim), as in the JAX package.
PEAK_TABLE: Dict[str, Tuple[float, float, str]] = {
    "NVIDIA H100 80GB HBM3": (
        1979.0, 3350.0,
        "NVIDIA H100 SXM5 data sheet (3.35 TB/s HBM3, 1,979 TOP/s dense "
        "INT8); power limit 700.00 W as nvidia-smi reports it"),
    "cpu": (0.5, 25.0, "order-of-magnitude host default"),
}

#: pending launches kept before a launch waits for the oldest
MAX_PENDING = 4096

_BACKEND: Optional[str] = None

# Cost-model evaluation counter: the "exactly zero cost-model work when
# disabled" asserts (chip_smoke path 14a, the CPU tests) snapshot it.
_COST_EVALS = 0

#: CUDA events ever created by this module (eager chains' pairs; 0
#: while disabled)
EVENTS_CREATED = 0

_TLS = threading.local()

def backend_name() -> str:
    """The card's name when CUDA is in use in this process, else
    ``cpu`` (cached once a card is seen)."""
    global _BACKEND
    if _BACKEND is not None:
        return _BACKEND
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        _BACKEND = torch.cuda.get_device_name(torch.cuda.current_device())
        return _BACKEND
    return "cpu"


def peaks() -> Optional[Tuple[float, float]]:
    """(peak bit-op TOP/s, peak memory GB/s) of the device in use, with
    the env overrides applied; None for a card the table does not name
    and the environment gives no peaks for (no share is then
    computed)."""
    row = PEAK_TABLE.get(backend_name())
    tf, gb = (row[0], row[1]) if row is not None else (None, None)
    try:
        tf = float(os.environ.get("PILOSA_TPU_DEVPROF_PEAK_TFLOPS", tf))
        gb = float(os.environ.get("PILOSA_TPU_DEVPROF_PEAK_GBPS", gb))
    except (TypeError, ValueError):
        pass
    if tf is None or gb is None:
        return None
    return tf, gb


def peak_source() -> str:
    row = PEAK_TABLE.get(backend_name())
    if "PILOSA_TPU_DEVPROF_PEAK_TFLOPS" in os.environ \
            or "PILOSA_TPU_DEVPROF_PEAK_GBPS" in os.environ:
        return "environment"
    return row[2] if row is not None else "none (unnamed device)"


def cost_evals() -> int:
    """How many times the cost model has run (0 while disabled)."""
    return _COST_EVALS


def tape_cost(kind: str, tape: Tuple, n_leaves: int, masked: bool,
              total_words: int) -> Tuple[float, float]:
    """Analytic (FLOPs, HBM bytes) for ONE dispatch of a tape over
    ``total_words`` 32-bit words, formula for formula the JAX package's
    (``pilosa_tpu/obs/devprof.py`` ``tape_cost``):

    - tapes: FLOPs = 32 * total_words * (len(tape) + mask-AND + popcount
      pass); HBM = 4 * total_words * (leaf planes + mask plane + the
      plane terminal's write) [+ 8 B count scalar];
    - ``pallas`` kernel families, one (op, d1, d2) entry: ``mm``
      (pair counts C[d1, d2] over 32 * W bit lanes), ``cmp`` (the BSI
      compare walk, d1 = depth, d2 = constant sides), ``scatter`` (the
      import merge and count), ``pop`` (per-row popcounts of d1 tiles of
      ``total_words`` words)."""
    global _COST_EVALS
    _COST_EVALS += 1
    if kind == "pallas":
        op, d1, d2 = tape[0]
        if op == "mm":
            flops = 2.0 * d1 * d2 * BIT_LANES * total_words
            hbm = float(WORD_BYTES) * (d1 + d2) * total_words \
                + 4.0 * d1 * d2
        elif op == "cmp":
            word_ops = 6 * d1 * d2 + 8
            flops = float(BIT_LANES) * word_ops * total_words
            hbm = float(WORD_BYTES) * (3 + d1) * total_words
        elif op == "scatter":
            flops = float(BIT_LANES) * 2.0 * total_words
            hbm = float(WORD_BYTES) * 3.0 * total_words
        elif op == "pop":
            flops = float(BIT_LANES) * 2.0 * d1 * total_words
            hbm = float(WORD_BYTES) * d1 * total_words + 4.0 * d1
        else:
            raise ValueError(f"unknown pallas cost family {op!r}")
        return flops, hbm
    word_ops = len(tape) + (1 if masked else 0)
    if kind == "count":
        word_ops += 1  # the popcount reduction pass
    flops = float(BIT_LANES) * word_ops * total_words
    planes = n_leaves + (1 if masked else 0) + (1 if kind == "plane" else 0)
    hbm = float(WORD_BYTES) * planes * total_words \
        + (8.0 if kind == "count" else 0.0)
    return flops, hbm


def family_name(kind: str, tape: Tuple, n_leaves: int,
                masked: bool) -> str:
    """Readable per-family label: terminal kind, leaf count, op mix, a
    mask tag, and a short structural digest (``count/2l/and1#a1b2c3``)."""
    mix: Dict[str, int] = {}
    for op, _a, _b in tape:
        mix[op] = mix.get(op, 0) + 1
    ops = "+".join(f"{k}{v}" for k, v in sorted(mix.items())) or "leaf"
    sig = hashlib.sha1(
        repr((kind, tape, n_leaves, masked)).encode()).hexdigest()[:6]
    return f"{kind}/{n_leaves}l/{ops}{'/m' if masked else ''}#{sig}"


def shape_bucket(total_words: int) -> int:
    """Next power of two >= total_words."""
    b = 1
    while b < total_words:
        b <<= 1
    return b


class KernelProfile:
    """Accumulated totals for one (family, shape_bucket, mesh_epoch)."""

    __slots__ = ("family", "bucket", "mesh_epoch", "dispatches",
                 "dispatch_s", "block_s", "device_s", "flops", "hbm_bytes",
                 "pending_flops", "pending_bytes")

    def __init__(self, family: str, bucket: int, mesh_epoch: int):
        self.family = family
        self.bucket = bucket
        self.mesh_epoch = mesh_epoch
        self.dispatches = 0
        self.dispatch_s = 0.0
        self.block_s = 0.0
        self.device_s = 0.0
        self.flops = 0.0
        self.hbm_bytes = 0.0
        # registry-counter publication lag (flushed every 16th dispatch)
        self.pending_flops = 0.0
        self.pending_bytes = 0.0


class KernelProfileRegistry:
    """Thread-safe accumulator behind the ``device_kernel_*`` series."""

    def __init__(self) -> None:
        self._lock = locktrace.tracked_lock("obs.devprof.kernels")
        self._profiles: Dict[Tuple[str, int, int], KernelProfile] = {}
        self._by_call: Dict[Tuple, Tuple[KernelProfile, float, float]] = {}
        #: profiles + call-cache entries ever created
        self.allocations = 0
        self.other_dispatches = 0
        self.other_device_s = 0.0
        self.h2d_copies = 0
        self.h2d_bytes = 0
        self.h2d_seconds = 0.0

    def entry_for(self, kind: str, tape: Tuple, n_leaves: int,
                  masked: bool, total_words: int, epoch: int = 0):
        ckey = (kind, tape, n_leaves, masked, total_words, epoch)
        with self._lock:
            ent = self._by_call.get(ckey)
            if ent is None:
                fam = family_name(kind, tape, n_leaves, masked)
                flops, nbytes = tape_cost(kind, tape, n_leaves, masked,
                                          total_words)
                pkey = (fam, shape_bucket(total_words), epoch)
                prof = self._profiles.get(pkey)
                if prof is None:
                    prof = KernelProfile(*pkey)
                    self._profiles[pkey] = prof
                    self.allocations += 1
                if len(self._by_call) >= 256:
                    self._by_call.clear()
                ent = (prof, flops, nbytes)
                self._by_call[ckey] = ent
                self.allocations += 1
            return ent

    def record(self, ent, dispatch_s: float, block_s: float,
               device_s: Optional[float] = None) -> None:
        """One dispatch of ``ent`` (None: ``other``). Without
        ``device_s`` the device time is ``dispatch_s + block_s`` (a
        synchronous run: the JAX package's convention); on the card it is
        the kernel's clock (or an eager chain's event pair) and
        ``block_s`` is 0."""
        if device_s is None:
            device_s = dispatch_s + block_s
        reg = M.REGISTRY
        if ent is None:
            with self._lock:
                self.other_dispatches += 1
                self.other_device_s += device_s
            reg.count(M.METRIC_KERNEL_DISPATCHES, family="other")
            reg.count(M.METRIC_KERNEL_DEVICE_SECONDS, device_s,
                      family="other")
            return
        prof, flops, nbytes = ent
        with self._lock:
            prof.dispatches += 1
            prof.dispatch_s += dispatch_s
            prof.block_s += block_s
            prof.device_s += device_s
            prof.flops += flops
            prof.hbm_bytes += nbytes
            prof.pending_flops += flops
            prof.pending_bytes += nbytes
            flush = (prof.dispatches - 1) % 16 == 0
            if flush:
                flush_flops = prof.pending_flops
                flush_bytes = prof.pending_bytes
                prof.pending_flops = 0.0
                prof.pending_bytes = 0.0
                total_s = prof.device_s
                total_flops = prof.flops
                total_bytes = prof.hbm_bytes
        fam = prof.family
        reg.count(M.METRIC_KERNEL_DISPATCHES, family=fam)
        reg.count(M.METRIC_KERNEL_DEVICE_SECONDS, device_s, family=fam)
        reg.observe_bucketed(M.METRIC_KERNEL_DISPATCH_US, device_s * 1e6,
                             M.KERNEL_DISPATCH_BUCKETS_US, family=fam)
        # flop/byte counters and the derived MFU/GB/s gauges publish on
        # the 1st and every 16th dispatch per profile, as in the JAX
        # package; snapshot()/stats_json() always derive fresh
        if flush:
            reg.count(M.METRIC_KERNEL_FLOPS, flush_flops, family=fam)
            reg.count(M.METRIC_KERNEL_HBM_BYTES, flush_bytes, family=fam)
            if total_s > 0:
                reg.gauge(M.METRIC_KERNEL_GBPS,
                          total_bytes / total_s / 1e9, family=fam)
                pk = peaks()
                if pk is not None:
                    reg.gauge(M.METRIC_KERNEL_MFU_PCT,
                              100.0 * (total_flops / total_s / 1e12)
                              / pk[0], family=fam)

    def record_h2d(self, nbytes: int, seconds: float) -> None:
        with self._lock:
            self.h2d_copies += 1
            self.h2d_bytes += nbytes
            self.h2d_seconds += seconds
        reg = M.REGISTRY
        reg.count(M.METRIC_KERNEL_H2D_BYTES, nbytes)
        reg.count(M.METRIC_KERNEL_H2D_SECONDS, seconds)

    def h2d_json(self) -> dict:
        with self._lock:
            copies, nbytes, secs = (self.h2d_copies, self.h2d_bytes,
                                    self.h2d_seconds)
        out = {"copies": copies, "bytes": nbytes,
               "seconds": round(secs, 6)}
        if secs > 0:
            out["achieved_gbps"] = round(nbytes / secs / 1e9, 4)
        return out

    def snapshot(self, limit: Optional[int] = None) -> List[dict]:
        """Per-profile totals plus the derived roofline reads, sorted by
        device time. Waits for the card's pending launches first."""
        drain(block=True)
        pk = peaks()
        ridge = (pk[0] * 1e12) / (pk[1] * 1e9) if pk else None
        with self._lock:
            rows = [(p.family, p.bucket, p.mesh_epoch, p.dispatches,
                     p.dispatch_s, p.block_s, p.device_s, p.flops,
                     p.hbm_bytes) for p in self._profiles.values()]
        out = []
        for (fam, bucket, epoch, n, disp_s, blk_s, device_s, flops,
             nbytes) in rows:
            d = {"family": fam, "shape_bucket": bucket,
                 "mesh_epoch": epoch, "dispatches": n,
                 "device_seconds": round(device_s, 6),
                 "dispatch_seconds": round(disp_s, 6),
                 "block_seconds": round(blk_s, 6),
                 "flops": flops, "hbm_bytes": nbytes}
            if nbytes > 0:
                intensity = flops / nbytes
                d["intensity_flops_per_byte"] = round(intensity, 4)
                if ridge is not None:
                    d["roofline_bound"] = ("memory" if intensity < ridge
                                           else "compute")
            if device_s > 0 and n > 0:
                tflops = flops / device_s / 1e12
                gbps = nbytes / device_s / 1e9
                d["achieved_tflops"] = round(tflops, 6)
                d["achieved_gbps"] = round(gbps, 4)
                if pk is not None:
                    d["mfu_pct"] = round(100.0 * tflops / pk[0], 4)
                    d["bw_util_pct"] = round(100.0 * gbps / pk[1], 4)
                d["us_per_dispatch"] = round(device_s / n * 1e6, 2)
            out.append(d)
        out.sort(key=lambda d: -d["device_seconds"])
        return out[:limit] if limit is not None else out

    def profile_count(self) -> int:
        with self._lock:
            return len(self._profiles)

    def reset(self) -> None:
        drain(block=True)
        with self._lock:
            self._profiles.clear()
            self._by_call.clear()
            self.other_dispatches = 0
            self.other_device_s = 0.0
            self.h2d_copies = 0
            self.h2d_bytes = 0
            self.h2d_seconds = 0.0


class IngestAccounting:
    """Per-stage ingest throughput: cumulative wall seconds, rows, and
    bytes per named stage, republished as ``ingest_stage_*`` rates."""

    def __init__(self) -> None:
        self._lock = locktrace.tracked_lock("obs.devprof.ingest")
        # stage -> [seconds, rows, bytes, batches]
        self._stages: Dict[str, list] = {}

    def record(self, stage: str, seconds: float, rows: int = 0,
               nbytes: int = 0) -> None:
        with self._lock:
            ent = self._stages.get(stage)
            if ent is None:
                ent = self._stages[stage] = [0.0, 0, 0, 0]
            ent[0] += seconds
            ent[1] += rows
            ent[2] += nbytes
            ent[3] += 1
            tot_s, tot_rows, tot_bytes = ent[0], ent[1], ent[2]
        reg = M.REGISTRY
        reg.count(M.METRIC_INGEST_STAGE_SECONDS, seconds, stage=stage)
        if rows:
            reg.count(M.METRIC_INGEST_STAGE_ROWS, rows, stage=stage)
        if nbytes:
            reg.count(M.METRIC_INGEST_STAGE_BYTES, nbytes, stage=stage)
        if tot_s > 0:
            if tot_rows:
                reg.gauge(M.METRIC_INGEST_STAGE_ROWS_PER_S,
                          tot_rows / tot_s, stage=stage)
            if tot_bytes:
                reg.gauge(M.METRIC_INGEST_STAGE_BYTES_PER_S,
                          tot_bytes / tot_s, stage=stage)

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            rows = {s: list(e) for s, e in self._stages.items()}
        out: Dict[str, dict] = {}
        for stage, (secs, nrows, nbytes, batches) in rows.items():
            d = {"seconds": round(secs, 6), "rows": nrows,
                 "bytes": nbytes, "batches": batches}
            if secs > 0:
                if nrows:
                    d["rows_per_s"] = round(nrows / secs, 1)
                if nbytes:
                    d["bytes_per_s"] = round(nbytes / secs, 1)
            out[stage] = d
        return out

    def reset(self) -> None:
        with self._lock:
            self._stages.clear()


KERNELS = KernelProfileRegistry()
INGEST = IngestAccounting()


# ---------------------------------------------------------------------------
# Device time: the kernels' own clocks (eager chains: event pairs), pooled,
# drained without waiting
# ---------------------------------------------------------------------------

_SLOTS_LOCK = locktrace.tracked_lock("obs.devprof.slots")
#: free timing slots per (slot class, device index)
_FREE: Dict[Tuple[type, int], List] = {}
#: (profile entry, slot, host seconds, tenant) in launch order
_PENDING: deque = deque()

#: ``ent`` of a launch timed for the fold hook only (the profiler's
#: tables are off): its fold records no profile
UNTABLED = object()


def set_fold_hook(hook) -> None:
    """Install (or with None, remove) the fold hook. Chain by capturing
    the previous value (``fold_hook()``) before installing."""
    global _FOLD_HOOK, TIMED
    _FOLD_HOOK = hook
    TIMED = ENABLED or hook is not None


def fold_hook():
    return _FOLD_HOOK


class _Clock:
    """What one kernel launch is timed with: the kernel clock's words, 3
    on the device and 2 of pinned host memory the kernel writes
    (csrc/launch_timing.cuh), bound together in the launchers'
    ``KU.PkTiming``."""

    __slots__ = ("dev", "host", "words", "timing", "index")

    def __init__(self, index: int):
        from pilosa_tpu_torch.ops import kernel_util as KU

        # (~0, 0, 0): earliest start, latest end, blocks done
        self.dev = torch.tensor([-1, 0, 0], dtype=torch.int64,
                                device=torch.device("cuda", index))
        self.host = torch.zeros(2, dtype=torch.int64, pin_memory=True)
        self.words = self.host.numpy()  # read and cleared without a torch op
        t = KU.PkTiming()
        t.dev, t.host = self.dev.data_ptr(), self.host.data_ptr()
        self.timing = ctypes.pointer(t)
        self.index = index

    def reuse(self) -> None:
        self.words[:] = 0

    def begin(self) -> None:
        pass

    def end(self) -> None:
        pass

    def done(self) -> bool:
        """The last block wrote the end word, after the start: the kernel
        is done with the slot's words."""
        return int(self.words[1]) != 0

    def wait(self) -> None:
        # the launch's stream may be any of the device's
        torch.cuda.synchronize(self.index)

    def seconds(self) -> float:
        t1, t0 = int(self.words[1]), int(self.words[0])
        return (t1 - t0) / 1e9


class _Pair:
    """What one eager op chain is timed with: a pair of CUDA events
    recorded around it on the current stream."""

    __slots__ = ("start", "stop", "index", "stream")

    def __init__(self, index: int):
        global EVENTS_CREATED
        self.start = torch.cuda.Event(enable_timing=True)
        self.stop = torch.cuda.Event(enable_timing=True)
        EVENTS_CREATED += 2
        self.index = index
        self.stream = None

    def reuse(self) -> None:
        pass

    def begin(self) -> None:
        self.stream = torch.cuda.current_stream(self.index)
        self.start.record(self.stream)

    def end(self) -> None:
        self.stop.record(self.stream)

    def done(self) -> bool:
        return self.stop.query()

    def wait(self) -> None:
        self.stop.synchronize()

    def seconds(self) -> float:
        return self.start.elapsed_time(self.stop) / 1e3


class _Wall:
    """What one launch on the CPU is timed with: the wall clock around
    the plain version, which runs synchronously, so it is done when the
    launch returns."""

    __slots__ = ("t0", "t1")

    def begin(self) -> None:
        self.t0 = time.perf_counter()

    def end(self) -> None:
        self.t1 = time.perf_counter()

    def done(self) -> bool:
        return True

    def wait(self) -> None:
        pass

    def seconds(self) -> float:
        return self.t1 - self.t0


def _take_slot(cls, device: torch.device):
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    with _SLOTS_LOCK:
        free = _FREE.get((cls, idx))
        slot = free.pop() if free else None
    if slot is None:
        return cls(idx)
    slot.reuse()
    return slot


def _give_back(slot) -> None:
    if type(slot) is _Wall:
        return
    with _SLOTS_LOCK:
        _FREE.setdefault((type(slot), slot.index), []).append(slot)


def _fold_oldest(block: bool) -> bool:
    """Fold the oldest pending launch into its profile once it is done
    (``block``: wait for it); False when there is none to fold."""
    with _SLOTS_LOCK:
        if not _PENDING:
            return False
        if not block and not _PENDING[0][1].done():
            return False
        ent, slot, host_s, tenant = _PENDING.popleft()
    if not slot.done():
        slot.wait()
    device_s = slot.seconds()
    _give_back(slot)
    if ent is not UNTABLED:
        KERNELS.record(ent, host_s, 0.0, device_s=device_s)
    hook = _FOLD_HOOK
    if hook is not None:
        hook(tenant, device_s)
    return True


def drain(block: bool = False) -> None:
    """Fold finished launches into their profiles, oldest first; ``block``
    waits for every pending one (admin reads only)."""
    while _fold_oldest(block):
        pass


def _queue(ent, slot, host_s: float, tenant) -> None:
    """Queue a launched slot; a full list waits for its oldest launch, so
    no slot leaves the list while its kernel may still write to it."""
    with _SLOTS_LOCK:
        _PENDING.append((ent, slot, host_s, tenant))
        full = len(_PENDING) > MAX_PENDING
    if full:
        _fold_oldest(True)
    drain()


class _Launch:
    """Times one launch. On the card ``timing`` is a clock slot's
    ``KU.PkTiming`` pointer for the C launcher (its last argument), or,
    for an eager op chain (``eager``), an event pair is recorded from
    Python around it on the current stream; on the CPU ``timing`` is
    None and the wall time is the device time. The launch carries the
    tenant of the thread that opens it to its fold. A launch that raises
    records nothing, and its slot goes back to the pool once the device
    is done (the kernel may have been launched)."""

    __slots__ = ("ent", "device", "eager", "slot", "timing", "t0",
                 "tenant")

    def __init__(self, ent, device: torch.device, eager: bool = False):
        self.ent = ent
        self.device = device
        self.eager = eager
        self.slot = self.timing = None

    def __enter__(self) -> "_Launch":
        self.tenant = current_tenant_id()
        if self.device.type == "cuda":
            self.slot = _take_slot(_Pair if self.eager else _Clock,
                                   self.device)
            if not self.eager:
                self.timing = self.slot.timing
        else:
            self.slot = _Wall()
        self.slot.begin()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        host_s = time.perf_counter() - self.t0
        if exc_type is not None:
            self.slot.wait()
            _give_back(self.slot)
            return False
        self.slot.end()
        _queue(self.ent, self.slot, host_s, self.tenant)
        return False


class _NullScope:
    """The shared no-op scope of a disabled site: nothing timed,
    nothing recorded, no ``timing`` for a launcher."""

    __slots__ = ()
    timing = None

    def __enter__(self) -> "_NullScope":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


#: Shared no-op context for disabled-path call sites (never allocate a
#: fresh one per batch or launch when the plane is off).
NULL_SCOPE = _NullScope()


def launch(ent, device: torch.device) -> _Launch:
    """Timing scope of one kernel launch attributed to ``ent`` (callers
    check ``TIMED`` first; ``ent`` None: the thread's current tape
    family, else ``other``; with the profiler off, no profile)."""
    if not ENABLED:
        ent = UNTABLED
    elif ent is None:
        ent = getattr(_TLS, "kernel", None)
    return _Launch(ent, device)


def time_body(device: torch.device):
    """Timing scope of an eager op chain run inside a tape family (its
    event pair is its device time; callers check ``ENABLED`` first);
    outside a family, the no-op scope."""
    ent = getattr(_TLS, "kernel", None)
    if ent is None:
        return NULL_SCOPE
    return _Launch(ent, device, eager=True)


# ---------------------------------------------------------------------------
# Attribution scopes + the h2d hook
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def kernel_scope(kind: str, tape: Tuple, n_leaves: int, masked: bool,
                 total_words: int):
    """Attribute the launches of this thread to a tape's kernel family
    (callers check ``ENABLED`` first). Nests: the inner scope wins."""
    from pilosa_tpu_torch.parallel.mesh import mesh_epoch

    ent = KERNELS.entry_for(kind, tape, n_leaves, masked, total_words,
                            mesh_epoch())
    prev = getattr(_TLS, "kernel", None)
    _TLS.kernel = ent
    try:
        yield
    finally:
        _TLS.kernel = prev


@contextlib.contextmanager
def ingest_scope():
    """Mark this thread as inside the ingest pipeline so h2d bytes land
    in the ``h2d_copy`` ingest stage (callers check ``ENABLED``)."""
    prev = getattr(_TLS, "ingest", 0)
    _TLS.ingest = prev + 1
    try:
        yield
    finally:
        _TLS.ingest = prev


def record_stage(stage: str, seconds: float, rows: int = 0,
                 nbytes: int = 0) -> None:
    """Module-level convenience for the ingest/wal call sites."""
    INGEST.record(stage, seconds, rows=rows, nbytes=nbytes)


def _on_h2d(nbytes: int, seconds: float) -> None:
    KERNELS.record_h2d(nbytes, seconds)
    if getattr(_TLS, "ingest", 0):
        INGEST.record("h2d_copy", seconds, nbytes=nbytes)


def enable() -> None:
    global ENABLED, TIMED
    ENABLED = TIMED = True
    platform.set_h2d_hook(_on_h2d)


def disable() -> None:
    global ENABLED, TIMED
    ENABLED = False
    TIMED = _FOLD_HOOK is not None
    platform.set_h2d_hook(None)


def reset() -> None:
    """Clear accumulated profiles/stages (bench phases; tests). Leaves
    the enable state and the cost-eval counter alone."""
    KERNELS.reset()
    INGEST.reset()


# ---------------------------------------------------------------------------
# Reads: the stats payload + the health plane's timeline probe
# ---------------------------------------------------------------------------


def stats_json() -> dict:
    """The kernel-stats payload (the JAX package serves it at
    ``GET /internal/stats/kernels``)."""
    if not ENABLED and not KERNELS.profile_count():
        return {"enabled": False}
    kernels = KERNELS.snapshot()
    pk = peaks()
    out = {
        "enabled": bool(ENABLED),
        "backend": backend_name(),
        "peak_tflops": pk[0] if pk else None,
        "peak_gbps": pk[1] if pk else None,
        "ridge_flops_per_byte": (round((pk[0] * 1e12) / (pk[1] * 1e9), 4)
                                 if pk else None),
        "kernels": kernels,
        "other": {"dispatches": KERNELS.other_dispatches,
                  "device_seconds": round(KERNELS.other_device_s, 6)},
        "h2d": KERNELS.h2d_json(),
        "ingest": INGEST.snapshot(),
        "cost_evals": cost_evals(),
        "device": {"name": backend_name(), "peaks_from": peak_source(),
                   "events_created": EVENTS_CREATED},
    }
    return out


def timeline_probe() -> dict:
    """Registered on the health plane's sampler so flight-recorder
    bundles capture kernel profiles at anomaly time (top families only —
    bundles are size-bounded)."""
    if not ENABLED:
        return {"enabled": False}
    return {"enabled": True,
            "kernels": KERNELS.snapshot(limit=8),
            "h2d": KERNELS.h2d_json(),
            "ingest": INGEST.snapshot()}


if ENABLED:  # env opt-in: install the hook at import
    platform.set_h2d_hook(_on_h2d)
