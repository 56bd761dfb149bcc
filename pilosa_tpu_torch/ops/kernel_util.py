"""Build, load and route the port's hand-written CUDA kernels.

Port of the routing half of ``pilosa_tpu/ops/pallas_util.py``, with a
different rule: a wrapper routes by the **device of its tensors**. A CPU
tensor takes the kernel's plain PyTorch version; a CUDA tensor launches
the kernel or raises. There is no kill switch, no strike-out and no
fallback reason: a kernel that fails to build or launch is an error.

Kernels live in ``csrc/*.cu`` with a plain C interface. On first use every
source is compiled by its own ``nvcc`` (all started together) into
``build/kernels/``, linked into one shared library keyed by the sources'
hash, and loaded with ``ctypes``. Importing this module builds nothing:
the CPU tests import every module on a machine without ``nvcc``.

Each kernel keeps a :class:`LaunchCounter` beside its wrapper, bumped
exactly where the wrapper launches it, so a run can show which kernels
its main path went through. Each launch site is also a device-profiler
scope (:func:`kernel_scope`, :func:`launch_scope`): with the profiler
off it is one flag check and a shared no-op object.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

from pilosa_tpu_torch.native import BUILD_DIR
from pilosa_tpu_torch.obs import devprof

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")

#: kernel sources, one nvcc process each
SOURCES = ("tape_count.cu", "pair_counts.cu", "scatter_merge.cu",
           "bsi_compare.cu", "ctile_count.cu")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

#: compile-only flags: ptxas reports each kernel's registers, stack frame
#: and spills, kept beside the library (:func:`ptxas_info`)
COMPILE_FLAGS = ("-Xptxas", "-v")

#: leaf and op limits of one tape launch (csrc/tape_count.cu TapeDesc)
MAX_LEAVES = 32
MAX_OPS = 64

class TapeOps(ctypes.Structure):
    """Mirror of ``struct TapeOps`` in csrc/tape_count.cu: a tape's op
    list, encoded once per tape and passed by pointer."""
    _fields_ = [
        ("n_leaves", ctypes.c_int),
        ("n_ops", ctypes.c_int),
        ("op", ctypes.c_uint8 * MAX_OPS),
        ("a", ctypes.c_uint8 * MAX_OPS),
        ("b", ctypes.c_uint8 * MAX_OPS),
    ]


class BsiSide(ctypes.Structure):
    """Mirror of ``struct BsiSide`` in csrc/bsi_compare.cu: one predicate
    constant as its magnitude bits (LSB-first), overflow and sign."""
    _fields_ = [
        ("bits", ctypes.c_uint64),
        ("overflow", ctypes.c_int),
        ("neg", ctypes.c_int),
    ]


class BsiDesc(ctypes.Structure):
    """Mirror of ``struct BsiDesc`` in csrc/bsi_compare.cu, passed to the
    kernel by value."""
    _fields_ = [
        ("planes", ctypes.c_void_p),
        ("out", ctypes.c_void_p),
        ("w", ctypes.c_longlong),
        ("depth", ctypes.c_int),
        ("op", ctypes.c_int),
        ("side", BsiSide * 2),
    ]


class PkTiming(ctypes.Structure):
    """Mirror of ``struct PkTiming`` in csrc/launch_timing.cuh: the device
    profiler's kernel clock words for one launch, passed by pointer as
    every launcher's last argument (None: no timing)."""
    _fields_ = [
        ("dev", ctypes.c_void_p),
        ("host", ctypes.c_void_p),
    ]


class LaunchCounter:
    """Plain-integer count of one kernel's launches."""

    def __init__(self, name: str):
        self.name = name
        self.n = 0
        _COUNTERS[name] = self

    def bump(self) -> None:
        self.n += 1


_COUNTERS: Dict[str, LaunchCounter] = {}


def launches() -> Dict[str, int]:
    return {name: c.n for name, c in _COUNTERS.items()}


def reset_launches() -> None:
    for c in _COUNTERS.values():
        c.n = 0


# ---------------------------------------------------------------------------
# Build + load
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: wall seconds the last build took (0.0 when the library was cached)
BUILD_SECONDS = 0.0


def nvcc() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _sources() -> List[str]:
    return [os.path.join(_CSRC, s) for s in SOURCES]


def _headers() -> List[str]:
    """Headers the sources include: part of the library's hash."""
    return sorted(os.path.join(_CSRC, f) for f in os.listdir(_CSRC)
                  if f.endswith(".cuh"))


def build() -> str:
    """Compile the kernels (when their hash is new) and return the .so."""
    global BUILD_SECONDS
    h = hashlib.sha256(" ".join(NVCC_FLAGS + COMPILE_FLAGS).encode())
    for src in _sources() + _headers():
        with open(src, "rb") as f:
            h.update(f.read())
    out_dir = os.path.join(BUILD_DIR, "kernels")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, f"libpilosa_kernels_{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        BUILD_SECONDS = 0.0
        return so
    t0 = time.perf_counter()
    exe = nvcc()
    tag = f"{os.getpid()}"
    objs, procs = [], []
    for src in _sources():
        obj = os.path.join(out_dir, os.path.basename(src) + f".{tag}.o")
        objs.append(obj)
        procs.append(subprocess.Popen(
            [exe, *NVCC_FLAGS, *COMPILE_FLAGS, "-c", src, "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    tmp = so + f".tmp{tag}"
    try:
        errors, info = [], []
        for src, p in zip(SOURCES, procs):
            _, err = p.communicate()
            if p.returncode != 0:
                errors.append(f"{src}: {err.decode(errors='replace')}")
            info.append(err.decode(errors="replace"))
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        with open(so + ".ptxas", "w") as f:
            f.write("".join(info))
        r = subprocess.run([exe, "-shared", *NVCC_FLAGS[:2], "-o", tmp,
                            *objs], capture_output=True)
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    if r.returncode != 0:
        raise RuntimeError("nvcc link failed:\n"
                           + r.stderr.decode(errors="replace"))
    os.replace(tmp, so)  # atomic publish for concurrent builds
    BUILD_SECONDS = time.perf_counter() - t0
    return so


def ptxas_info() -> str:
    """What ptxas reported for every kernel when the library was built
    (registers, stack frame, spills)."""
    with open(build() + ".ptxas") as f:
        return f.read()


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        dll = ctypes.CDLL(build())
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        # every launcher's last argument: the profiler's timing or None
        # (csrc/launch_timing.cuh)
        tm = ctypes.POINTER(PkTiming)
        dll.pk_tape_count.argtypes = [ctypes.POINTER(TapeOps),
                                      ctypes.POINTER(vp), vp, ll, vp, vp, i,
                                      vp, tm]
        dll.pk_tape_count.restype = i
        dll.pk_pair_counts.argtypes = [vp, vp, i, i, ll, i, i, i, ll, ll,
                                       ll, vp, vp, tm]
        dll.pk_pair_counts.restype = i
        dll.pk_scatter_merge.argtypes = [vp, ll, vp, vp, ll, vp, vp, i, vp,
                                         tm]
        dll.pk_scatter_merge.restype = i
        dll.pk_bsi_compare.argtypes = [ctypes.POINTER(BsiDesc), vp, tm]
        dll.pk_bsi_compare.restype = i
        dll.pk_ctile_count.argtypes = [ctypes.POINTER(ll), i, vp, i, i, vp,
                                       i, vp, tm]
        dll.pk_ctile_count.restype = i
        dll.pk_error_string.argtypes = [i]
        dll.pk_error_string.restype = ctypes.c_char_p
        _lib = dll
        return _lib


def check(rc: int, kernel: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` from a launch."""
    if rc != 0:
        msg = lib().pk_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{kernel}: CUDA launch failed ({rc}): {msg}")


# ---------------------------------------------------------------------------
# Routing + argument checks
# ---------------------------------------------------------------------------


def on_card(kernel: str, *tensors: torch.Tensor) -> bool:
    """True when every tensor is on one CUDA device (launch the kernel),
    False when every tensor is on the CPU (plain version). Anything else
    raises."""
    first = tensors[0]
    if first.is_cuda:  # the launch path: one attribute read per tensor
        idx = first.get_device()
        if all(t.is_cuda and t.get_device() == idx for t in tensors):
            return True
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{kernel}: tensors on several devices {devs}")
    dev = next(iter(devs))
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"{kernel}: unsupported device {dev}")


def check_words(kernel: str, name: str, t: torch.Tensor, ndim: int) -> None:
    """A kernel operand must be a contiguous int32 tensor of ``ndim``."""
    if t.dtype != torch.int32:
        raise TypeError(f"{kernel}: {name} must be int32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{kernel}: {name} must be {ndim}-D, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")


def stream(t: torch.Tensor) -> int:
    """The ``cudaStream_t`` of the current stream on ``t``'s device."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


_SCRATCH: Dict[Tuple[int, int], Tuple[torch.Tensor, int]] = {}


def tape_scratch(device: torch.device, stream_handle: int) -> int:
    """Device pointer of the count accumulator for one stream, shared by
    ``tape_count`` and ``scatter_merge`` (csrc/count_finish.cuh): one
    64-bit word (a ticket and a running sum), zero between launches,
    since each launch leaves it so. Launches on one stream run in order,
    so they share it; it is zeroed once, when first made."""
    key = (device.index, stream_handle)
    hit = _SCRATCH.get(key)
    if hit is None:
        t = torch.zeros(1, dtype=torch.int64, device=device)
        hit = _SCRATCH.setdefault(key, (t, t.data_ptr()))
    return hit[1]


_SMS: Dict[int, int] = {}


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (cached)."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


# ---------------------------------------------------------------------------
# Device-profiler scopes of the launch sites (obs/devprof.py)
# ---------------------------------------------------------------------------


def kernel_scope(op: str, d1: int, d2: int, n_inputs: int,
                 total_words: int, like: torch.Tensor):
    """Profiler scope of one launch of a kernel family, the counterpart
    of ``pilosa_tpu/ops/pallas_util.py`` ``kernel_scope``: ``op`` is the
    cost family (``mm`` | ``cmp`` | ``scatter`` | ``pop``), ``d1`` /
    ``d2`` its two dimensions (``devprof.tape_cost``), with the port
    kernel's own shapes. ``like`` is a tensor on the launch's device.
    The scope's ``timing`` goes to the C launcher as its last argument.
    The shared no-op scope when no launch is timed (``devprof.TIMED``);
    a launch timed for the tenant plane alone evaluates no cost."""
    if not devprof.TIMED:
        return devprof.NULL_SCOPE
    if not devprof.ENABLED:
        return devprof.launch(None, like.device)
    ent = devprof.KERNELS.entry_for(
        "pallas", ((op, int(d1), int(d2)),), n_inputs, False,
        int(total_words), 0)
    return devprof.launch(ent, like.device)


def launch_scope(like: torch.Tensor):
    """Profiler scope of one launch attributed to the calling thread's
    tape family (``devprof.kernel_scope``), or to ``other`` outside one;
    the shared no-op scope when no launch is timed."""
    if not devprof.TIMED:
        return devprof.NULL_SCOPE
    return devprof.launch(None, like.device)
