"""Time three inner loops for ``pair_counts`` at the GroupBy shape.

    python3 -m pilosa_tpu_torch.probes.pair_counts_probe [--out FILE]
    python3 -m pilosa_tpu_torch.probes.pair_counts_probe --sweep [--out FILE]

Builds ``pair_counts_probe.cu`` alone with ``nvcc`` (``-Xptxas -v``
prints each kernel's registers), then, on one NVIDIA GPU, times at
8 x 256 x 196,608 words (SSB SF-1's GroupBy: the year block against one
brand block) and at 40 x 256 x 196,608 (a one-field GroupBy-Sum of depth
20, transposed):

- (a) ``mma.sync`` m16n8k256 ``.b1 .and.popc`` on packed words,
- (b) bits expanded to int8 in registers fed to ``mma.sync`` m16n8k32 s8,
- (c) the SIMT loop, AND + ``__popc`` per word and a carry-save count of
  8 words (5 ``__popc``),

each over a few grid sizes, against ``pair_counts_plain``, beside the
port's ``pair_counts`` as it stands. While the plain ``__popc`` loop runs
it reads the SM clock and power draw with ``nvidia-smi``. Prints one line
per measurement and writes them all as JSON to ``--out``.

``--sweep`` times the port's own kernel instead (``ops/groupby.launch``)
at the four main-path shapes — GroupBy 8 x 256 x 196,608, TopN 1 x 256 x
196,608, BSI Sum 2 x 20 x 327,680 and the one-field GroupBy-Sum 40 x 256 x
196,608 — over tiles and grid sizes around what ``_plan`` picks, and at
the TopN and Sum shapes beside (d), a SIMT tile kernel for 1-2 rows of A
(16-byte loads, counts in registers). Each is checked against
``pair_counts_plain`` and timed as kernel device time in a
``torch.profiler`` trace, with L2 warm and with a 512 MB buffer zeroed
before every call.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading

HERE = os.path.dirname(os.path.abspath(__file__))
NAMES = {0: "simt_popc", 1: "simt_csa8", 2: "b1_mma", 3: "s8_mma"}


def _smi(query: str) -> str:
    r = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else ""


def build(out_dir: str) -> ctypes.CDLL:
    from pilosa_tpu_torch.ops import kernel_util as KU

    so = os.path.join(out_dir, "libpair_counts_probe.so")
    r = subprocess.run([KU.nvcc(), *KU.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
                        "-o", so, os.path.join(HERE, "pair_counts_probe.cu")],
                       capture_output=True, text=True)
    print(r.stderr)
    if r.returncode != 0:
        raise RuntimeError("nvcc failed")
    lib = ctypes.CDLL(so)
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.probe_launch.argtypes = [i, vp, vp, i, i, ll, ll, vp, vp]
    lib.probe_launch.restype = i
    lib.probe_tile.argtypes = [i, i, vp, vp, i, i, ll, ll, vp, vp]
    lib.probe_tile.restype = i
    return lib


def _slice_words(w: int, slices: int) -> int:
    """Words per block: w over ``slices``, rounded up to 256."""
    return max(256, -(-(-(-w // slices)) // 256) * 256)


def time_ms(fn, reps: int = 20, trials: int = 7) -> float:
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


def kernel_ms(fn, calls: int = 20, flush=None):
    """Mean device ms per call in kernels named pc_* or simt_tile
    (torch.profiler);
    with ``flush`` (a tensor larger than L2), zeroed before every call,
    the operands come from HBM and not from L2."""
    import torch
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
             if "pc_" in e.key or "simt_tile" in e.key)
    return us / calls / 1e3


def _custom(r1, r2, w, ta, tb, per_sm, sms, step):
    """(ta, tb, words per block, blocks) of a grid like ``_plan``'s with
    the tile and blocks per SM given."""
    tiles = -(-r1 // ta) * -(-r2 // tb)
    slices = max(1, min(-(-per_sm * sms // tiles), -(-w // step)))
    size = -(-(-(-w // slices)) // step) * step
    return ta, tb, size, tiles * -(-w // size)


def sweep(out_path: str) -> int:
    import numpy as np
    import torch

    from pilosa_tpu_torch.ops import groupby as G

    card = _smi("name,power.limit")
    print(card)
    lib = build(tempfile.mkdtemp())
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(6)
    # (kernel, ta, tb, blocks per SM): "b1" is the port's kernel through
    # ops/groupby.launch, "tile" the probe's SIMT tile kernel (d)
    shapes = {
        "GroupBy": (8, 256, 6 * 32768, [("b1", 8, tb, k) for tb in (16, 32)
                                        for k in (2, 4)]),
        "TopN": (1, 256, 6 * 32768, [("b1", 8, 16, k) for k in (2, 4)]
                 + [("tile", 1, tb, k) for tb in (8, 16) for k in (4, 8)]),
        "Sum": (2, 20, 10 * 32768, [("b1", 8, 16, k) for k in (1, 2)]
                + [("tile", 2, 8, k) for k in (2, 3)]),
        "GroupBy-Sum": (40, 256, 6 * 32768, [("b1", 40, tb, k)
                                             for tb in (16, 32)
                                             for k in (2, 4)]
                        + [("b1", 64, 32, 2)]),
    }
    flush = torch.empty(128 << 20, dtype=torch.int32, device=dev)
    rows = []
    for name, (r1, r2, w, options) in shapes.items():
        a = torch.from_numpy(rng.integers(0, 1 << 32, (r1, w), dtype=np.uint32
                                          ).view(np.int32)).to(dev)
        b = torch.from_numpy(rng.integers(0, 1 << 32, (r2, w), dtype=np.uint32
                                          ).view(np.int32)).to(dev)
        want = G.pair_counts_plain(a, b)
        planned = G._plan(r1, r2, w, True, sms)
        bytes_ms = ((r1 + r2) * w * 4 + r1 * r2 * 4) / 3.35e12 * 1e3
        for kernel, ta, tb, per_sm in options:
            if kernel == "b1":
                ta, tb, size, blocks = _custom(r1, r2, w, ta, tb, per_sm, sms,
                                               256)
                plan = G.Plan(planned.variant, False, ta, tb, 4, size, blocks)

                def run():
                    return G.launch(a, b, plan)
            else:
                ta, tb, size, blocks = _custom(r1, r2, w, ta, tb, per_sm, sms,
                                               4)

                def run():
                    out = torch.zeros((r1, r2), dtype=torch.int32, device=dev)
                    rc = lib.probe_tile(ta, tb, a.data_ptr(), b.data_ptr(),
                                        r1, r2, w, size, out.data_ptr(),
                                        stream)
                    if rc != 0:
                        raise RuntimeError(f"simt_tile: launch {rc}")
                    return out
            ok = bool(torch.equal(run(), want))
            ms = kernel_ms(run)
            cold = kernel_ms(run, flush=flush)
            row = {"shape": name, "dims": [r1, r2, w], "kernel": kernel,
                   "ta": ta, "tb": tb, "slice": size, "blocks": blocks,
                   "blocks_per_sm": per_sm, "kernel_ms": ms,
                   "kernel_ms_l2_flushed": cold, "equal": ok,
                   "bytes_bound_ms": bytes_ms,
                   "planned": kernel == "b1" and (ta, tb, size) == (
                       planned.ta, planned.tb, planned.slice),
                   "card": card}
            rows.append(row)
            print(json.dumps(row))
            if not ok:
                raise AssertionError(f"{name} {kernel} {ta}x{tb} disagrees")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(rows, f, indent=1)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/pair_counts_probe.json")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    if args.sweep:
        return sweep(args.out)

    import numpy as np
    import torch

    from pilosa_tpu_torch.ops import groupby as G

    if not torch.cuda.is_available():
        print("pair_counts_probe: no CUDA device", file=sys.stderr)
        return 1
    card = _smi("name,power.limit")
    print(card)
    lib = build(tempfile.mkdtemp())
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(5)
    w = 6 * 32768
    rows = []
    for r1 in (8, 40):
        host_a = rng.integers(0, 1 << 32, (r1, w), dtype=np.uint32)
        host_b = rng.integers(0, 1 << 32, (256, w), dtype=np.uint32)
        a = torch.from_numpy(host_a.view(np.int32)).to(dev)
        b = torch.from_numpy(host_b.view(np.int32)).to(dev)
        want = G.pair_counts_plain(a, b)
        out = torch.zeros((r1, 256), dtype=torch.int32, device=dev)
        tiles = -(-256 // 32) * -(-r1 // 8)
        bytes_ms = (r1 + 256) * w * 4 / 3.35e12 * 1e3
        ops_ms = 2 * r1 * 256 * w * 32 / 1979e12 * 1e3
        for variant in NAMES:
            best = None
            for per_sm in (2, 4, 8):
                slices = max(1, -(-per_sm * sms // tiles))
                slice_w = _slice_words(w, slices)

                def launch():
                    rc = lib.probe_launch(variant, a.data_ptr(), b.data_ptr(),
                                          r1, 256, w, slice_w, out.data_ptr(),
                                          stream)
                    if rc != 0:
                        raise RuntimeError(f"{NAMES[variant]}: launch {rc}")

                out.zero_()
                launch()
                torch.cuda.synchronize()
                ok = bool(torch.equal(out, want))
                ms = time_ms(launch)
                row = {"shape": f"{r1}x256x{w}", "kernel": NAMES[variant],
                       "blocks_per_sm": per_sm, "slice_words": slice_w,
                       "ms": ms, "equal": ok, "bytes_bound_ms": bytes_ms,
                       "int8_ops_bound_ms": ops_ms, "card": card}
                print(json.dumps(row))
                rows.append(row)
                if not ok:
                    raise AssertionError(f"{NAMES[variant]} disagrees")
                if best is None or ms < best["ms"]:
                    best = row
            print(f"best {best['kernel']} at {best['shape']}: "
                  f"{best['ms']:.4f} ms ({best['blocks_per_sm']} blocks/SM; "
                  f"bytes bound {bytes_ms:.4f} ms) {card}")
        got = G.pair_counts(a, b)
        assert torch.equal(got, want)
        ms = time_ms(lambda: G.pair_counts(a, b))
        rows.append({"shape": f"{r1}x256x{w}", "kernel": "port pair_counts",
                     "ms": ms, "card": card})
        print(f"port pair_counts at {r1}x256x{w}: {ms:.4f} ms (call) {card}")
        if r1 == 8:
            # SM clock and power under the plain __popc loop, ~2 s of work
            seen = {}

            def sample():
                import time
                time.sleep(0.7)
                seen["smi"] = _smi("clocks.sm,clocks.max.sm,power.draw,"
                                   "power.limit,temperature.gpu")

            th = threading.Thread(target=sample)
            slices = max(1, -(-4 * sms // tiles))
            slice_w = _slice_words(w, slices)
            th.start()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            n = 20000
            for _ in range(n):
                lib.probe_launch(0, a.data_ptr(), b.data_ptr(), r1, 256, w,
                                 slice_w, out.data_ptr(), stream)
            e.record()
            e.synchronize()
            th.join()
            ms = s.elapsed_time(e) / n
            clock = float(seen["smi"].split(",")[0].split()[0])
            rate = r1 * 256 * w / (ms * 1e-3) / (sms * clock * 1e6)
            row = {"shape": f"{r1}x256x{w}", "kernel": "simt_popc under load",
                   "ms": ms, "smi": seen["smi"],
                   "popc_per_clock_per_sm": rate, "card": card}
            rows.append(row)
            print(json.dumps(row))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
