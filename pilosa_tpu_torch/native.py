"""ctypes loader for the host bit helpers (csrc/host/pilosa_native.cpp).

Port of ``pilosa_tpu/native.py``. These are HOST loops — bulk-import
scatter, popcounts, bit materialization — that sit around the device
path (the reference runs them in compiled Go, roaring/roaring.go:711,
:2380). The shared object compiles on first use with ``g++ -O3`` into
``build/native/`` of the checkout and is memoized. Each entry point keeps
a numpy fallback for a machine without a host C++ compiler: this is host
code, not a device path, so the fallback hides no kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
from typing import Optional

import numpy as np

#: build outputs of the port (host library and CUDA kernels); listed in
#: .gitignore, made on first use
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build")

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "csrc", "host", "pilosa_native.cpp")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> Optional[str]:
    """Compile into build/native keyed by the source hash; returns the .so
    path, or None when no host toolchain is present or the build fails."""
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    out_dir = os.path.join(BUILD_DIR, "native")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, f"pilosa_native_{tag}.so")
    if os.path.exists(so):
        return so
    tmp = so + f".tmp{os.getpid()}"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-o", tmp, _SRC]
    try:
        r = subprocess.run(cmd, capture_output=True, timeout=120)
        if r.returncode != 0:
            cmd.remove("-march=native")  # unsupported on some hosts
            r = subprocess.run(cmd, capture_output=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if r.returncode != 0:
        print("pilosa_tpu_torch.native: build failed: "
              + r.stderr.decode(errors="replace")[-300:], file=sys.stderr)
        return None
    os.replace(tmp, so)  # atomic publish for concurrent builds
    return so


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        so = _build()
        if so is None:
            return None
        lib = ctypes.CDLL(so)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.scatter_bits.argtypes = [u32p, i64p, ctypes.c_size_t]
        lib.scatter_bits.restype = None
        lib.scatter_new_bits.argtypes = [u32p, i64p, ctypes.c_size_t]
        lib.scatter_new_bits.restype = ctypes.c_int64
        lib.popcount_words.argtypes = [u32p, ctypes.c_size_t]
        lib.popcount_words.restype = ctypes.c_int64
        lib.plane_to_bits.argtypes = [u32p, ctypes.c_size_t, u64p]
        lib.plane_to_bits.restype = ctypes.c_int64
        _lib = lib
        return _lib


def _u32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def _i64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _check_plane(plane: np.ndarray) -> None:
    if plane.dtype != np.uint32 or not plane.flags.c_contiguous:
        raise ValueError("plane must be a contiguous uint32 array")


def _check_bounds(plane: np.ndarray, cols: np.ndarray) -> None:
    """The C loops write unchecked; a bad column raises here instead of
    corrupting the heap."""
    if cols.size and (int(cols.min()) < 0
                      or (int(cols.max()) >> 5) >= plane.size):
        raise IndexError(
            f"column out of range for plane of {plane.size} words")


def scatter_bits(plane: np.ndarray, cols) -> None:
    """plane |= bits at cols (duplicate-safe)."""
    _check_plane(plane)
    lib = _load()
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    _check_bounds(plane, cols)
    if lib is None:
        np.bitwise_or.at(plane, cols >> 5,
                         np.uint32(1) << (cols & 31).astype(np.uint32))
        return
    lib.scatter_bits(_u32(plane), _i64(cols), cols.size)


def scatter_new_bits(plane: np.ndarray, cols) -> int:
    """Set bits at cols; returns how many were NOT already set."""
    _check_plane(plane)
    lib = _load()
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    _check_bounds(plane, cols)
    if lib is None:
        cols = np.unique(cols)  # a duplicated column is one change
        w = cols >> 5
        b = (cols & 31).astype(np.uint32)
        old = (plane[w] >> b) & np.uint32(1)
        changed = int(np.count_nonzero(old == 0))
        np.bitwise_or.at(plane, w, np.uint32(1) << b)
        return changed
    return int(lib.scatter_new_bits(_u32(plane), _i64(cols), cols.size))


def popcount(plane: np.ndarray) -> int:
    """Total set bits of a uint32 plane (any shape)."""
    words = np.ascontiguousarray(plane, dtype=np.uint32).ravel()
    lib = _load()
    if lib is None:
        return int(np.unpackbits(words.view(np.uint8)).sum())
    return int(lib.popcount_words(_u32(words), words.size))


def plane_to_bits(plane: np.ndarray) -> np.ndarray:
    """Set-bit positions of a plane as uint64 offsets."""
    plane = np.ascontiguousarray(plane.ravel(), dtype=np.uint32)
    lib = _load()
    if lib is None:
        bits = np.unpackbits(plane.view(np.uint8), bitorder="little")
        return np.nonzero(bits)[0].astype(np.uint64)
    n = int(lib.popcount_words(_u32(plane), plane.size))
    out = np.empty(n, dtype=np.uint64)
    lib.plane_to_bits(_u32(plane), plane.size,
                      out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
    return out
