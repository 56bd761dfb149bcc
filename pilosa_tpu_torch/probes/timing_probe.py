"""What a CUDA event pair and a kernel's own clock read of one launch.

    python3 -m pilosa_tpu_torch.probes.timing_probe [--out FILE]

Builds ``timing_probe.cu`` with ``nvcc`` into ``build/probes/`` and, on one
NVIDIA GPU, with a 256 MB buffer zeroed before every call (L2 flushed):

1. the tick of ``%globaltimer``, the clock ``csrc/launch_timing.cuh``
   reads;
2. the time of a pair of ``torch.cuda.Event(enable_timing=True)``
   recorded around nothing, around an empty kernel and around one
   ``tape_count`` launch (2 x 196,608 words), on an idle stream (a sync
   first) and on a busy one (a 2 ms spin kernel ahead, so the pair does
   not wait for the host's launch), beside the kernel's time in a
   ``torch.profiler`` trace;
3. a kernel that spins 2,000, 10,000 and 100,000 SM cycles in 132
   blocks, timed by its own blocks' clock, by an event pair and by a
   trace;
4. ``obs/devprof.py``'s own reading of ``tape_count`` (the kernel's
   clock), idle and busy.

Prints one line per measurement and writes them all as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
CALLS = 50


def _build() -> ctypes.CDLL:
    from pilosa_tpu_torch.native import BUILD_DIR
    from pilosa_tpu_torch.ops import kernel_util as KU

    src = os.path.join(HERE, "timing_probe.cu")
    with open(src, "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(KU.NVCC_FLAGS).encode())
    out_dir = os.path.join(BUILD_DIR, "probes")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, f"libtiming_probe_{h.hexdigest()[:16]}.so")
    if not os.path.exists(so):
        tmp = so + f".tmp{os.getpid()}"
        subprocess.run([KU.nvcc(), *KU.NVCC_FLAGS, "-shared", "-o", tmp,
                        src], check=True)
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.tp_ticks.argtypes = [vp, i, vp]
    lib.tp_empty.argtypes = [vp]
    lib.tp_spin.argtypes = [vp, ll, i, vp]
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/timing_probe.json")
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("timing_probe: no CUDA device", file=sys.stderr)
        return 1
    from pilosa_tpu_torch.obs import devprof
    from pilosa_tpu_torch.ops import bitmap as B

    lib = _build()
    dev = torch.device("cuda", 0)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    spin2ms = int(2e-3 * torch.cuda.get_device_properties(0).clock_rate
                  * 1e3)
    flush = torch.empty(64 << 20, dtype=torch.int32, device=dev)
    card = torch.cuda.get_device_name(0)
    out = {"card": card}

    def prep(busy):
        flush.zero_()
        if busy:
            torch.cuda._sleep(spin2ms)
        else:
            torch.cuda.synchronize()

    def pair_us(op, busy):
        res = []
        for _ in range(CALLS):
            prep(busy)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            op()
            b.record()
            b.synchronize()
            res.append(a.elapsed_time(b) * 1e3)
        return statistics.median(res)

    def trace_us(op, fragment):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(CALLS):
                prep(True)
                op()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages() if fragment in e.key]
        n = sum(e.count for e in hits)
        return sum(e.self_device_time_total for e in hits) / n if n else None

    ticks = torch.zeros(200, dtype=torch.int64, device=dev)
    lib.tp_ticks(ctypes.c_void_p(ticks.data_ptr()), 200, stream)
    t = ticks.cpu().numpy()
    t = t[t > 0]
    out["globaltimer_tick_ns"] = {"min": int(t.min()),
                                  "median": float(np.median(t))}
    print(f"%globaltimer ticks: min {t.min()} ns, median "
          f"{np.median(t):.0f} ns ({card})")

    rng = np.random.default_rng(1)
    x, y = (torch.from_numpy(rng.integers(0, 1 << 32, 196608,
                                          dtype=np.uint32).view(np.int32)
                             ).to(dev) for _ in range(2))
    ops = {"nothing": (lambda: None, None),
           "empty kernel": (lambda: lib.tp_empty(stream), "empty"),
           "tape_count": (lambda: B.tape_count((("and", 0, 1),), [x, y]),
                          "tape_")}
    out["pairs_us"] = {}
    for name, (op, fragment) in ops.items():
        row = {"idle": pair_us(op, False), "busy": pair_us(op, True),
               "trace": trace_us(op, fragment) if fragment else None}
        out["pairs_us"][name] = row
        print(f"event pair around {name}: idle {row['idle']:.2f} us, busy "
              f"{row['busy']:.2f} us; trace {row['trace']} us ({card})")

    clk = torch.zeros(2, dtype=torch.int64, device=dev)
    out["spin_us"] = {}
    for cycles in (2000, 10000, 100000):
        def run():
            lib.tp_spin(ctypes.c_void_p(clk.data_ptr()),
                        ctypes.c_longlong(cycles), 132, stream)
        clocks = []
        for _ in range(CALLS):
            clk[0], clk[1] = (1 << 62), 0
            prep(True)
            run()
            torch.cuda.synchronize()
            t0, t1 = clk.tolist()
            clocks.append((t1 - t0) / 1e3)
        row = {"clock": statistics.median(clocks),
               "pair": pair_us(run, True),
               "trace": trace_us(run, "clocked_spin")}
        out["spin_us"][cycles] = row
        print(f"spin {cycles} cycles: its clock {row['clock']:.2f} us, "
              f"event pair {row['pair']:.2f} us, trace {row['trace']:.2f} "
              f"us ({card})")

    out["devprof_tape_count_us"] = {}
    was = devprof.ENABLED
    devprof.enable()
    try:
        for mode in ("idle", "busy"):
            devprof.reset()
            for _ in range(CALLS):
                prep(mode == "busy")
                B.tape_count((("and", 0, 1),), [x, y])
            devprof.KERNELS.snapshot()
            k = devprof.KERNELS
            row = {"clock": k.other_device_s / k.other_dispatches * 1e6}
            out["devprof_tape_count_us"][mode] = row
            print(f"devprof tape_count ({mode}): clock {row['clock']:.2f} "
                  f"us ({card})")
    finally:
        devprof.reset()
        devprof.enable() if was else devprof.disable()

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
