"""Measure the launch floor of a small kernel, and what a wrapper call costs.

    python3 -m pilosa_tpu_torch.probes.launch_probe [--out FILE]

Builds ``launch_probe.cu`` alone with ``nvcc`` (``-Xptxas -v`` prints each
kernel's registers, stack frame and spills) and, on one NVIDIA GPU:

1. launches an empty kernel through ``ctypes``, as the port launches its
   kernels, and gives its kernel time in a ``torch.profiler`` trace, its
   call time by CUDA events over back-to-back calls, and the host time of
   one ``ctypes`` call; the same for an empty kernel passed a 480-byte
   parameter (the size of ``tape_count``'s general-path descriptor);
2. times on the host clock, one by one, the parts of the ``tape_count``
   wrapper before it cached the tape (``check_tape``, building the 464-byte
   ``TapeDesc``, ``torch.zeros(1)``, the ``torch.cuda.device`` guard, the
   stream lookup, the ``ctypes`` call, ``out[0]``) beside cheaper
   candidates (``torch.empty(())``, the raw stream handle, a pointer
   array), then the port's ``tape_count`` as it stands: its call and
   kernel time and its device operations per call, and its kernel time
   over the main paths' other tapes and a 3-op tape on the general path;
3. times a trivial kernel, ``popcount(a & b)`` over 2 x 196,608 words
   (1.57 MB, the main path's Count shape) with 16-byte loads, over
   threads per block, vectors in flight per thread and three ways to
   finish (an atomicAdd into a zeroed output; one pass with partials and
   a last-block ticket; one pass with the sum and the ticket packed in
   one 64-bit atomic), with L2 warm and with a 512 MB buffer zeroed
   before every call, and the 128-thread, 2-vector, packed-atomic count
   again with the 480-byte parameter;
4. counts, kernel by kernel, the device operations a ``torch.profiler``
   trace shows for a zero fill before a ``tape_count`` call (the pattern
   of ``StackedSet.row_counts``) and for ``tape_count`` alone, over 5, 20
   and 100 calls, with CUDA activity alone and with CPU activity too.

Prints one line per measurement and writes them all as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def _smi(query: str) -> str:
    r = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else ""


def start_build():
    """Start ``nvcc`` on ``launch_probe.cu`` (``-Xptxas -v``) into
    ``build/probes/``, unless a library of the same source and flags is
    there already; returns (process or None, temporary path, library
    path) for :func:`load`."""
    from pilosa_tpu_torch.native import BUILD_DIR
    from pilosa_tpu_torch.ops import kernel_util as KU

    src = os.path.join(HERE, "launch_probe.cu")
    h = hashlib.sha256(" ".join(KU.NVCC_FLAGS + KU.COMPILE_FLAGS).encode())
    with open(src, "rb") as f:
        h.update(f.read())
    out_dir = os.path.join(BUILD_DIR, "probes")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, f"liblaunch_probe_{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return None, None, so
    tmp = so + f".tmp{os.getpid()}"
    proc = subprocess.Popen(
        [KU.nvcc(), *KU.NVCC_FLAGS, *KU.COMPILE_FLAGS, "-shared", "-o", tmp,
         src], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, tmp, so


def load(proc, tmp: str, so: str, verbose: bool = True) -> ctypes.CDLL:
    """Wait for :func:`start_build` and load the library."""
    if proc is not None:
        _, err = proc.communicate()
        if verbose:
            print(err)
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed:\n" + err)
        os.replace(tmp, so)  # atomic publish for concurrent builds
    lib = ctypes.CDLL(so)
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.probe_empty_launch.argtypes = [i, i, vp]
    lib.probe_empty_launch.restype = i
    lib.probe_read_launch.argtypes = [i, i, i, vp, vp, ll, i, vp, vp, vp]
    lib.probe_read_launch.restype = i
    lib.probe_empty_padded_launch.argtypes = [i, i, vp]
    lib.probe_empty_padded_launch.restype = i
    lib.probe_read_padded_launch.argtypes = [vp, vp, ll, i, vp, vp, vp]
    lib.probe_read_padded_launch.restype = i
    return lib


def build() -> ctypes.CDLL:
    return load(*start_build())


FINISHES = {0: "atomicAdd", 1: "one pass, partials and a ticket",
            2: "one pass, packed 64-bit atomic"}


def read_runner(lib, a, b, threads: int, v: int, finish: int):
    """A function launching the probe's count of ``popcount(a & b)``
    (int32 planes of one length, a multiple of 4 words, 16-byte aligned)
    and its output tensor."""
    import torch

    n_vec = a.numel() // 4
    blocks = -(-n_vec // (threads * v))
    out = torch.zeros(1, dtype=torch.int32, device=a.device)
    scratch = torch.zeros(3 + blocks, dtype=torch.int32, device=a.device)
    stream = torch._C._cuda_getCurrentRawStream(a.device.index)

    def run():
        if finish == 0:
            out.zero_()
        rc = lib.probe_read_launch(threads, v, finish, a.data_ptr(),
                                   b.data_ptr(), n_vec, blocks,
                                   scratch.data_ptr(), out.data_ptr(),
                                   stream)
        if rc != 0:
            raise RuntimeError(f"probe_read: launch {rc}")

    return run, out, blocks


def floor(lib, a, b, flush=None) -> dict:
    """The launch floor beside a count over ``a`` and ``b``: the empty
    kernel's device ms and the fastest probe count's (over threads,
    vectors and finish) warm and, with ``flush``, with L2 flushed."""
    import torch

    stream = torch._C._cuda_getCurrentRawStream(a.device.index)

    def empty():
        lib.probe_empty_launch(1, 32, stream)

    best = None
    for finish in (0, 2):
        for threads in (128, 256):
            for v in (1, 2):
                run, _, blocks = read_runner(lib, a, b, threads, v, finish)
                ms, _, _ = device_trace(run, "probe_read")
                if best is None or ms < best[0]:
                    best = (ms, threads, v, finish, blocks, run)
    ms, threads, v, finish, blocks, run = best
    return {"empty_kernel_ms": device_trace(empty, "probe_empty")[0],
            "read_kernel_ms": ms,
            "read_kernel_ms_l2_flushed": (
                None if flush is None
                else device_trace(run, "probe_read", flush=flush)[0]),
            "threads": threads, "vectors_per_thread": v,
            "finish": FINISHES[finish], "blocks": blocks}


def host_us(fn, reps: int = 200, trials: int = 15) -> float:
    """Median host microseconds per call of ``fn`` over ``trials`` batches
    of ``reps`` calls (the device is not waited for)."""
    import torch

    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(trials):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        per.append((time.perf_counter() - t0) / reps * 1e6)
        torch.cuda.synchronize()
    return statistics.median(per)


def call_ms(fn, reps: int = 20, trials: int = 9) -> float:
    """Median per-call ms of back-to-back calls by CUDA events."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(trials):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        e.synchronize()
        per.append(s.elapsed_time(e) / reps)
    return statistics.median(per)


def device_trace(fn, kernel: str, calls: int = 20, flush=None):
    """(mean device ms per call in kernels whose name holds ``kernel``,
    device operations per call, their names) from a ``torch.profiler``
    trace; with ``flush``, a tensor larger than L2 is zeroed before every
    call (its zeroing is left out of both numbers)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            if flush is not None:
                flush.zero_()
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if kernel in e.key)
    ops = [e.name for e in prof.events()
           if e.device_type == DeviceType.CUDA]
    n_flush = calls if flush is not None else 0
    names = sorted(set(ops))
    return us / calls / 1e3, (len(ops) - n_flush) / calls, names


def trace_names(fn, calls: int, with_cpu: bool):
    """Device events of ``calls`` calls of ``fn`` in one ``torch.profiler``
    trace, counted by name: (from ``prof.events()``, from the raw Kineto
    events)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if with_cpu
                                      else [])
    with profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = collections.Counter(
        e.name.split("(")[0] for e in prof.events()
        if e.device_type == DeviceType.CUDA)
    raw = collections.Counter(
        e.name().split("(")[0] for e in prof.profiler.kineto_results.events()
        if e.device_type() == DeviceType.CUDA)
    return events, raw


class OldTapeDesc(ctypes.Structure):
    """The 464-byte tape descriptor the uncached wrapper filled on every
    call (32 leaf pointers, the mask, two counts, 64 x (op, a, b))."""
    _fields_ = [("leaves", ctypes.c_void_p * 32), ("mask", ctypes.c_void_p),
                ("n_leaves", ctypes.c_int), ("n_ops", ctypes.c_int),
                ("op", ctypes.c_uint8 * 64), ("a", ctypes.c_uint8 * 64),
                ("b", ctypes.c_uint8 * 64)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/launch_probe.json")
    args = ap.parse_args()

    import numpy as np
    import torch

    from pilosa_tpu_torch.ops import bitmap as B
    from pilosa_tpu_torch.ops import kernel_util as KU

    if not torch.cuda.is_available():
        print("launch_probe: no CUDA device", file=sys.stderr)
        return 1
    card = _smi("name,power.limit")
    print(card)
    lib = build()
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []

    def record(**kw):
        kw["card"] = card
        rows.append(kw)
        print(json.dumps(kw))

    # -- 1. the empty kernel --------------------------------------------------
    def empty(blocks=1, threads=32):
        rc = lib.probe_empty_launch(blocks, threads, stream)
        if rc != 0:
            raise RuntimeError(f"probe_empty: launch {rc}")

    def empty_padded(blocks=1, threads=32):
        rc = lib.probe_empty_padded_launch(blocks, threads, stream)
        if rc != 0:
            raise RuntimeError(f"probe_empty_padded: launch {rc}")

    for blocks, threads in ((1, 32), (sms, 256), (4 * sms, 128)):
        for what, launch, kernel in (
                ("empty kernel", empty, "probe_empty"),
                ("empty kernel, 480-byte parameter", empty_padded,
                 "probe_empty_padded")):
            fn = lambda b=blocks, t=threads, f=launch: f(b, t)  # noqa: E731
            k_ms, ops, _ = device_trace(fn, kernel)
            record(what=what, grid=[blocks, threads], kernel_ms=k_ms,
                   call_ms=call_ms(fn), host_us=host_us(fn), device_ops=ops)

    # -- 2. the parts of a tape_count call ------------------------------------
    rng = np.random.default_rng(9)
    w = 6 * 32768
    leaves = [torch.from_numpy(rng.integers(0, 1 << 32, w, dtype=np.uint32)
                               .view(np.int32)).to(dev) for _ in range(2)]
    tape = (("and", 0, 1),)
    out = torch.zeros(1, dtype=torch.int32, device=dev)
    codes = {"and": 0, "or": 1, "xor": 2, "andnot": 3}

    def old_desc():
        d = OldTapeDesc()
        for i, t in enumerate(leaves):
            d.leaves[i] = t.data_ptr()
        d.mask = None
        d.n_leaves, d.n_ops = 2, 1
        for k, (op, i, j) in enumerate(tape):
            d.op[k], d.a[k], d.b[k] = codes[op], i, j
        return d

    def guard():
        with torch.cuda.device(dev):
            pass

    template = old_desc()
    parts = {
        "check_tape": lambda: B.check_tape(tape, 2),
        "KU.on_card (2 leaves)": lambda: KU.on_card("p", *leaves),
        "KU.check_words (one leaf)":
            lambda: KU.check_words("p", "leaf", leaves[0], 1),
        "TapeDesc built per call": old_desc,
        "TapeDesc.from_buffer_copy of a cached one":
            lambda: OldTapeDesc.from_buffer_copy(template),
        "data_ptr of 2 leaves": lambda: [t.data_ptr() for t in leaves],
        "c_void_p * 2 pointer array":
            lambda: (ctypes.c_void_p * 2)(leaves[0].data_ptr(),
                                          leaves[1].data_ptr()),
        "torch.zeros(1)": lambda: torch.zeros(1, dtype=torch.int32,
                                              device=dev),
        "torch.empty(())": lambda: torch.empty((), dtype=torch.int32,
                                               device=dev),
        "with torch.cuda.device(...)": guard,
        "torch.cuda.current_device()": torch.cuda.current_device,
        "KU.stream": lambda: KU.stream(out),
        "current_stream(dev).cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "torch._C._cuda_getCurrentRawStream(0)":
            lambda: torch._C._cuda_getCurrentRawStream(0),
        "ctypes call, empty kernel": empty,
        "out[0]": lambda: out[0],
    }
    for name, fn in parts.items():
        record(what="wrapper part", part=name, host_us=host_us(fn))

    def port_call():
        return B.tape_count(tape, leaves)

    assert int(port_call()) == int(B.tape_count_plain(tape, leaves))
    k_ms, ops, names = device_trace(port_call, "tape_")
    record(what="port tape_count, 2 leaves x 196,608 words",
           host_us=host_us(port_call), call_ms=call_ms(port_call),
           kernel_ms=k_ms, device_ops=ops, device_op_names=names)

    # the port's tape_count over the main paths' other tapes (the BSI
    # aggregates' one-leaf count, the Percentile walk's two-leaf counts at
    # the BSI width) and a 4-leaf Count tree on the general path
    shapes = {
        "or, 1 x 327,680": ((("or", 0, 0),), 1, 10 * 32768),
        "andnot, 2 x 327,680": ((("andnot", 0, 1),), 2, 10 * 32768),
        "3 ops, 4 x 196,608 (general path)": (
            (("and", 0, 1), ("or", 4, 2), ("andnot", 5, 3)), 4, w),
    }
    for name, (tp, n_leaves, width) in shapes.items():
        ls = [torch.from_numpy(rng.integers(0, 1 << 32, width,
                                            dtype=np.uint32).view(np.int32))
              .to(dev) for _ in range(n_leaves)]
        assert int(B.tape_count(tp, ls)) == int(B.tape_count_plain(tp, ls))
        k_ms, ops, _ = device_trace(lambda: B.tape_count(tp, ls), "tape_")
        record(what=f"port tape_count, {name}", kernel_ms=k_ms,
               device_ops=ops,
               bytes_bound_ms=n_leaves * width * 4 / 3.35e12 * 1e3)

    # -- 3. a trivial kernel reading the same 1.57 MB -------------------------
    a, b = leaves
    want = int(B.tape_count_plain(tape, leaves))
    flush = torch.empty(128 << 20, dtype=torch.int32, device=dev)
    for finish in FINISHES:
        for threads in (128, 256):
            for v in (1, 2, 4):
                run, o, blocks = read_runner(lib, a, b, threads, v, finish)
                run()
                torch.cuda.synchronize()
                ok = int(o.item()) == want
                warm, _, _ = device_trace(run, "probe_read")
                cold, _, _ = device_trace(run, "probe_read", flush=flush)
                record(what="read 2 x 196,608 words", threads=threads,
                       vectors_per_thread=v, blocks=blocks,
                       finish=FINISHES[finish], kernel_ms=warm,
                       kernel_ms_l2_flushed=cold,
                       bytes_bound_ms=2 * w * 4 / 3.35e12 * 1e3, equal=ok)
                if not ok:
                    raise AssertionError("probe_read disagrees")
    n_vec = a.numel() // 4
    blocks = -(-n_vec // 256)
    scratch = torch.zeros(3 + blocks, dtype=torch.int32, device=dev)
    o = torch.zeros(1, dtype=torch.int32, device=dev)

    def padded():
        rc = lib.probe_read_padded_launch(a.data_ptr(), b.data_ptr(), n_vec,
                                          blocks, scratch.data_ptr(),
                                          o.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"probe_read_padded: launch {rc}")

    padded()
    torch.cuda.synchronize()
    if int(o.item()) != want:
        raise AssertionError("probe_read_padded disagrees")
    record(what="read 2 x 196,608 words, 480-byte parameter", threads=128,
           vectors_per_thread=2, blocks=blocks, finish=FINISHES[2],
           kernel_ms=device_trace(padded, "probe_read_padded")[0],
           kernel_ms_l2_flushed=device_trace(padded, "probe_read_padded",
                                             flush=flush)[0],
           bytes_bound_ms=2 * w * 4 / 3.35e12 * 1e3, equal=True)

    # -- 4. device operations as a trace counts them ---------------------------
    # a zero fill (an ATen kernel) before a ctypes launch, the pattern of
    # StackedSet.row_counts, and tape_count alone; per kernel name, over
    # 5, 20 and 100 calls, with CUDA activity alone and with CPU activity
    # too, from prof.events() and from the raw Kineto events
    def fill_then_count():
        torch.zeros(2560, dtype=torch.int32, device=dev)
        B.tape_count(tape, leaves)

    for what, fn, want in (("zero fill + tape_count", fill_then_count, 2),
                           ("tape_count", port_call, 1)):
        for with_cpu in (False, True):
            for calls in (5, 20, 100):
                events, raw = trace_names(fn, calls, with_cpu)
                record(what="device ops in a trace", fn=what,
                       activities="cpu+cuda" if with_cpu else "cuda",
                       calls=calls, want_per_call=want,
                       events_per_call=sum(events.values()) / calls,
                       kineto_per_call=sum(raw.values()) / calls,
                       events=dict(events), kineto=dict(raw))
    print(_smi("clocks.sm,power.draw,power.limit"))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
