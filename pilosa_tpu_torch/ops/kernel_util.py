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
its main path went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional

import torch

from pilosa_tpu_torch.native import BUILD_DIR

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")

#: kernel sources, one nvcc process each
SOURCES = ("tape_count.cu", "pair_counts.cu", "scatter_merge.cu")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

#: leaf and op limits of one tape launch (csrc/tape_count.cu TapeDesc)
MAX_LEAVES = 32
MAX_OPS = 64


class TapeDesc(ctypes.Structure):
    """Mirror of ``struct TapeDesc`` in csrc/tape_count.cu, passed to the
    kernel by value."""
    _fields_ = [
        ("leaves", ctypes.c_void_p * MAX_LEAVES),
        ("mask", ctypes.c_void_p),
        ("n_leaves", ctypes.c_int),
        ("n_ops", ctypes.c_int),
        ("op", ctypes.c_uint8 * MAX_OPS),
        ("a", ctypes.c_uint8 * MAX_OPS),
        ("b", ctypes.c_uint8 * MAX_OPS),
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


def build() -> str:
    """Compile the kernels (when their hash is new) and return the .so."""
    global BUILD_SECONDS
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
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
            [exe, *NVCC_FLAGS, "-c", src, "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    tmp = so + f".tmp{tag}"
    try:
        errors = []
        for src, p in zip(SOURCES, procs):
            _, err = p.communicate()
            if p.returncode != 0:
                errors.append(f"{src}: {err.decode(errors='replace')}")
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
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


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        dll = ctypes.CDLL(build())
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        dll.pk_tape_count.argtypes = [ctypes.POINTER(TapeDesc), ll, vp, vp]
        dll.pk_tape_count.restype = i
        dll.pk_pair_counts.argtypes = [vp, vp, i, i, ll, vp, vp]
        dll.pk_pair_counts.restype = i
        dll.pk_scatter_merge.argtypes = [vp, ll, vp, vp, ll, vp, vp]
        dll.pk_scatter_merge.restype = i
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
    return torch.cuda.current_stream(t.device).cuda_stream
