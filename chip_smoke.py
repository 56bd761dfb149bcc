"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 3] [--shards 6]

Phases, each printed on its own line:

1. environment: torch version, the card's name and power limit
   (``nvidia-smi``), the ``nvcc --version`` line;
2. build: compiles the port's CUDA kernels from ``pilosa_tpu_torch/csrc``
   into ``build/`` and prints the build time;
3. kernel parity: every kernel against its plain PyTorch version on the
   card, bit for bit (tolerance 0: every result is an integer or a
   bitmap), at edge shapes and at the main path's shapes, timed with CUDA
   events beside its bound;
4. main path: the SSB scale-factor-1 deployment (6 shards x 2^20
   lineorder columns, a 7-row mutex ``year`` and a 1000-row keyed mutex
   ``brand``) imported through ``API.import_bits`` and queried with
   ``GroupBy(Rows(year), Rows(brand), limit=100)TopN(brand, n=10)`` and a
   set of ``Count`` trees, every answer checked against a numpy oracle
   built from the generator, every kernel's launch count checked above 0;
5. one ``{"kernels": [...]}`` JSON line;
6. the last line: ``{"ok": true, "device": {...}}``.

Exits non-zero, without the last line, when there is no CUDA device, when
the port is not importable, or when any phase fails.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time


def _smi(query: str) -> str:
    r = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else ""


def _mem_rate(name: str) -> float:
    """Published device-memory bandwidth, bytes/s (H100 data sheet)."""
    if "PCIe" in name:
        return 2.0e12
    if "NVL" in name:
        return 3.9e12
    return 3.35e12


#: 32-bit __popc results per clock per SM, compute capability 9.0
#: (NVIDIA's arithmetic instruction throughput table)
POPC_PER_CLOCK_PER_SM = 16


def _time_ms(fn, reps: int = 10, trials: int = 9) -> float:
    """Median per-call milliseconds over ``trials`` batches of ``reps``
    calls, after warm-up, timed with CUDA events."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        per.append(start.elapsed_time(end) / reps)
    return statistics.median(per)


def _rand_words(rng, shape, device):
    import numpy as np
    import torch

    host = rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)
    return torch.from_numpy(host.view(np.int32)).to(device)


class Report:
    def __init__(self, gpu_name: str, power_limit: str):
        self.label = f"({gpu_name}, power limit {power_limit})"
        self.kernels = {}

    def kernel(self, name: str, **kw) -> None:
        self.kernels.setdefault(name, {"name": name, "route": "cuda",
                                       "max_abs_err": 0})
        self.kernels[name].update(kw)

    def err(self, name: str, got, want) -> None:
        import torch

        e = int((got.long() - want.long()).abs().max().item()) \
            if got.numel() else 0
        k = self.kernels.setdefault(name, {"name": name, "route": "cuda",
                                           "max_abs_err": 0})
        k["max_abs_err"] = max(k["max_abs_err"], e)
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: kernel disagrees with its plain "
                                 f"version (max abs err {e})")


def phase_kernels(report: Report, rng, device, popc_rate: float,
                  mem_rate: float) -> None:
    import numpy as np
    import torch

    from pilosa_tpu_torch.ops import bitmap as B
    from pilosa_tpu_torch.ops import groupby as G
    from pilosa_tpu_torch.ops import scatter as SC
    from pilosa_tpu_torch.shardwidth import WORDS_PER_SHARD

    main_w = 6 * WORDS_PER_SHARD  # the main path's stacked width

    # -- tape_count ---------------------------------------------------------
    tapes = [
        ((("and", 0, 1),), 2),
        ((("or", 0, 1), ("xor", 2, 0)), 2),
        ((("and", 0, 1), ("andnot", 3, 2)), 3),
        ((("and", 0, 1), ("or", 4, 2), ("andnot", 5, 3)), 4),
    ]
    for w in (1, 7, 512, main_w):
        for tape, n_leaves in tapes:
            leaves = [_rand_words(rng, (w,), device) for _ in range(n_leaves)]
            mask = _rand_words(rng, (w,), device)
            for m in (None, mask):
                report.err("tape_count", B.tape_count(tape, leaves, m),
                           B.tape_count_plain(tape, leaves, m))
    leaves = [_rand_words(rng, (main_w,), device) for _ in range(2)]
    tape = (("and", 0, 1),)  # Count(Intersect(Row, Row)) on the main path
    ms = _time_ms(lambda: B.tape_count(tape, leaves))
    plain_ms = _time_ms(lambda: B.tape_count_plain(tape, leaves))
    by_bytes = (2 * main_w * 4 + 4) / mem_rate * 1e3
    by_ops = main_w / popc_rate * 1e3
    report.kernel("tape_count", source="pilosa_tpu_torch/csrc/tape_count.cu",
                  replaces="pilosa_tpu/ops/bitmap.py:209", ms=ms,
                  plain_ms=plain_ms, bound_ms=max(by_bytes, by_ops),
                  bound_by="bytes" if by_bytes >= by_ops else "operations",
                  library_ms=None, shape=f"2 leaves x {main_w} words")
    print(f"kernel tape_count: 2x{main_w} words {ms:.4f} ms "
          f"(plain {plain_ms:.4f} ms, bound {max(by_bytes, by_ops):.4f} ms) "
          f"{report.label}")

    # -- pair_counts --------------------------------------------------------
    cases = [(1, 1, 1), (3, 5, 7), (37, 37, 512), (8, 256, 512),
             (1, 256, main_w), (8, 256, main_w), (130, 300, 1000)]
    for r1, r2, w in cases:
        a = _rand_words(rng, (r1, w), device)
        b = _rand_words(rng, (r2, w), device)
        report.err("pair_counts", G.pair_counts(a, b),
                   G.pair_counts_plain(a, b))
    ones = torch.full((4, 512), -1, dtype=torch.int32, device=device)
    zeros = torch.zeros((4, 512), dtype=torch.int32, device=device)
    report.err("pair_counts", G.pair_counts(ones, ones),
               torch.full((4, 4), 512 * 32, dtype=torch.int32, device=device))
    report.err("pair_counts", G.pair_counts(ones, zeros),
               torch.zeros((4, 4), dtype=torch.int32, device=device))
    timings = {}
    for r1 in (8, 1):  # GroupBy year x brand block; TopN filter x block
        a = _rand_words(rng, (r1, main_w), device)
        b = _rand_words(rng, (256, main_w), device)
        ms = _time_ms(lambda: G.pair_counts(a, b))
        plain_ms = _time_ms(lambda: G.pair_counts_plain(a, b), reps=2,
                            trials=5)
        by_bytes = ((r1 + 256) * main_w * 4 + r1 * 256 * 4) / mem_rate * 1e3
        by_ops = r1 * 256 * main_w / popc_rate * 1e3
        timings[r1] = (ms, plain_ms, by_bytes, by_ops)
        print(f"kernel pair_counts: {r1}x256x{main_w} words {ms:.4f} ms "
              f"(plain {plain_ms:.4f} ms, bytes bound {by_bytes:.4f} ms, "
              f"popc bound {by_ops:.4f} ms) {report.label}")
    ms, plain_ms, by_bytes, by_ops = timings[8]
    report.kernel("pair_counts",
                  source="pilosa_tpu_torch/csrc/pair_counts.cu",
                  replaces="pilosa_tpu/ops/groupby.py:98", ms=ms,
                  plain_ms=plain_ms, bound_ms=max(by_bytes, by_ops),
                  bound_by="bytes" if by_bytes >= by_ops else "operations",
                  library_ms=None, shape=f"8x256x{main_w}",
                  topn_ms=timings[1][0],
                  topn_bound_ms=max(timings[1][2], timings[1][3]))

    # -- scatter_merge ------------------------------------------------------
    for n, m in ((512, 1), (1024, 300), (32768, 5000), (32768, 32768)):
        flat = _rand_words(rng, (n,), device)
        addr_np = np.sort(rng.choice(n, size=m, replace=False)).astype(
            np.int32)
        addr = torch.from_numpy(addr_np).to(device)
        masks = _rand_words(rng, (m,), device)
        f_k, f_p = flat.clone(), flat.clone()
        report.err("scatter_merge", SC.scatter_merge_(f_k, addr, masks),
                   SC.scatter_merge_plain(f_p, addr, masks))
        report.err("scatter_merge", f_k, f_p)
    # the main path's chunk: one shard's _exists row, every word touched
    n = m = WORDS_PER_SHARD
    flat = torch.zeros(n, dtype=torch.int32, device=device)
    addr = torch.arange(n, dtype=torch.int32, device=device)
    masks = torch.full((n,), -1, dtype=torch.int32, device=device)
    ms = _time_ms(lambda: SC.scatter_merge_(flat, addr, masks))
    plain_ms = _time_ms(lambda: SC.scatter_merge_plain(flat, addr, masks))
    by_bytes = (16 * m + 4) / mem_rate * 1e3
    by_ops = m / popc_rate * 1e3
    report.kernel("scatter_merge",
                  source="pilosa_tpu_torch/csrc/scatter_merge.cu",
                  replaces="pilosa_tpu/ops/scatter.py:91", ms=ms,
                  plain_ms=plain_ms, bound_ms=max(by_bytes, by_ops),
                  bound_by="bytes" if by_bytes >= by_ops else "operations",
                  library_ms=None, shape=f"{m} updates into {n} words")
    print(f"kernel scatter_merge: {m} updates into {n} words {ms:.4f} ms "
          f"(plain {plain_ms:.4f} ms, bound {max(by_bytes, by_ops):.4f} ms) "
          f"{report.label}")
    torch.cuda.synchronize()
    print("library_ms: null for every kernel: PyTorch has no popcount op, "
          "so no single PyTorch call computes any of these functions")


def phase_main_path(report: Report, args) -> None:
    import numpy as np
    import torch

    from pilosa_tpu_torch.api import API
    from pilosa_tpu_torch.core.stacked import stacked_set
    from pilosa_tpu_torch.ops import groupby as G
    from pilosa_tpu_torch.ops import kernel_util as KU
    from pilosa_tpu_torch.ops import topk as T
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    rng = np.random.default_rng(args.seed)
    shards, years, brands = args.shards, 7, 1000
    if shards != 6:
        print(f"reduced: {shards} shards instead of 6")
    n = shards * SHARD_WIDTH
    year_of = rng.integers(0, years, n)
    brand_of = rng.integers(0, brands, n)
    names = np.array([f"MFGR#{1000 + b}" for b in range(brands)])
    cols = np.arange(n, dtype=np.int64)

    KU.reset_launches()
    t0 = time.perf_counter()
    api = API()
    api.create_index("ssb")
    api.create_field("ssb", "year", {"type": "mutex"})
    api.create_field("ssb", "brand", {"type": "mutex", "keys": True})
    api.import_bits("ssb", "year", rows=year_of, cols=cols)
    api.import_bits("ssb", "brand", cols=cols, row_keys=names[brand_of])
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0

    q = "GroupBy(Rows(year), Rows(brand), limit=100)TopN(brand, n=10)"
    counts_q = {
        'Count(Intersect(Row(year=1), Row(brand="MFGR#1003")))':
            (year_of == 1) & (brand_of == 3),
        'Count(Union(Row(year=2), Row(brand="MFGR#1500")))':
            (year_of == 2) | (brand_of == 500),
        'Count(Difference(Row(year=3), Row(brand="MFGR#1007")))':
            (year_of == 3) & (brand_of != 7),
        "Count(Xor(Row(year=4), Row(year=5)))":
            (year_of == 4) ^ (year_of == 5),
        "Count(Not(Row(year=0)))": year_of != 0,
        "Count(All())": np.ones(n, dtype=bool),
        # 40 leaves: over the kernel's 32, so the plane terminal reduces
        # sub-trees first and one tape_count launch counts
        "Count(Union(" + ", ".join(f'Row(brand="MFGR#{1000 + b}")'
                                   for b in range(40)) + "))":
            brand_of < 40,
    }
    groups, top = api.query("ssb", q)
    got_counts = {cq: api.query("ssb", cq)[0] for cq in counts_q}
    filtered_top = api.query("ssb", "TopN(brand, Row(year=3), n=5)")[0]
    torch.cuda.synchronize()
    launched = KU.launches()

    # -- oracle ---------------------------------------------------------------
    fb = api.holder.index("ssb").field("brand")
    table = np.bincount(year_of * brands + brand_of,
                        minlength=years * brands).reshape(years, brands)
    bid = {b: fb.translate.key_to_id[names[b]] for b in range(brands)}
    want_groups = sorted(((y, bid[b], int(table[y, b]))
                          for y in range(years) for b in range(brands)
                          if table[y, b]))[:100]
    got_groups = [(g.group[0].row_id, bid[int(g.group[1].row_key[5:]) - 1000],
                   g.count) for g in groups]
    assert got_groups == want_groups, "GroupBy disagrees with the oracle"

    def want_top(counts, k):
        ranked = sorted(((-int(c), bid[b], names[b])
                         for b, c in enumerate(counts) if c))[:k]
        return [(key, -c) for c, _, key in ranked]

    assert [(p.key, p.count) for p in top.pairs] == want_top(
        np.bincount(brand_of, minlength=brands), 10), "TopN disagrees"
    assert [(p.key, p.count) for p in filtered_top.pairs] == want_top(
        np.bincount(brand_of[year_of == 3], minlength=brands), 5), \
        "filtered TopN disagrees"
    for cq, sel in counts_q.items():
        assert got_counts[cq] == int(sel.sum()), f"{cq} disagrees"

    idx = api.holder.index("ssb")
    for fname in ("year", "brand", "_exists"):
        s = stacked_set(idx.field(fname), list(range(shards)), "standard")
        assert all(b.is_cuda for _, b in s.iter_blocks()), \
            f"{fname} stack is not on the card"
    st = stacked_set(fb, list(range(shards)), "standard")
    if shards == 6:
        assert st.n_blocks == 4, f"brand stack has {st.n_blocks} blocks"
    for name, c in launched.items():
        assert c > 0, f"kernel {name} was not launched on the main path"
        report.kernel(name, launches=c)

    p50 = statistics.median(_wall_ms(lambda: api.query("ssb", q))
                            for _ in range(11))
    count_p50 = statistics.median(
        _wall_ms(lambda: api.query("ssb", next(iter(counts_q))))
        for _ in range(11))
    # device time of the GroupBy+TopN query's own launches, on its own
    # resident blocks: the rest of the p50 is host work and copies
    year_blk = stacked_set(idx.field("year"), list(range(shards)),
                           "standard").planes

    def query_kernels():
        for _, b in st.iter_blocks():
            G.pair_counts(year_blk, b)
        for _, b in st.iter_blocks():
            T.row_counts(b)

    kern_ms = _time_ms(query_kernels, reps=3, trials=5)
    print(f"main path: the GroupBy+TopN query's {2 * st.n_blocks} "
          f"pair_counts launches take {kern_ms:.3f} ms of device time, "
          f"{100 * kern_ms / p50:.1f}% of its p50 {report.label}")
    print(f"main path: {n} columns, {years} years x {brands} brands; "
          f"import {import_s:.3f} s; brand blocks {st.n_blocks} of "
          f"{st.block_rows} rows; device bytes allocated "
          f"{torch.cuda.memory_allocated()}; launches {launched} "
          f"{report.label}")
    print(f"main path: p50 of the GroupBy+TopN query {p50:.3f} ms; p50 of "
          f"Count(Intersect) {count_p50:.3f} ms {report.label}")
    print("main path: every answer matches the numpy oracle")


def _wall_ms(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--shards", type=int, default=6)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from pilosa_tpu_torch.ops import kernel_util as KU

    name_power = _smi("name,power.limit")
    gpu_name = torch.cuda.get_device_name(0)
    power_limit = name_power.split(",")[-1].strip() if name_power else "?"
    nvcc_line = subprocess.run([KU.nvcc(), "--version"], capture_output=True,
                               text=True).stdout.strip().splitlines()[-1]
    print(f"environment: torch {torch.__version__} cuda {torch.version.cuda}")
    print(name_power)
    print(f"environment: {nvcc_line}")

    t0 = time.perf_counter()
    KU.lib()
    print(f"build: kernels built and loaded in "
          f"{time.perf_counter() - t0:.2f} s (nvcc {KU.BUILD_SECONDS:.2f} s)")

    props = torch.cuda.get_device_properties(0)
    clock = _smi("clocks.max.sm").split()
    clock_mhz = float(clock[0]) if clock else 1980.0  # H100 SXM boost
    popc_rate = POPC_PER_CLOCK_PER_SM * props.multi_processor_count \
        * clock_mhz * 1e6
    mem_rate = _mem_rate(gpu_name)
    print(f"bounds: {mem_rate / 1e12:.2f} TB/s memory, {popc_rate / 1e12:.3f} "
          f"T popc/s ({props.multi_processor_count} SMs x "
          f"{POPC_PER_CLOCK_PER_SM}/clock x {clock_mhz:.0f} MHz)")

    report = Report(gpu_name, power_limit)
    device = torch.device("cuda", 0)
    phase_kernels(report, np.random.default_rng(args.seed + 1), device,
                  popc_rate, mem_rate)
    print("kernel parity: every kernel matches its plain version bit for "
          "bit")
    phase_main_path(report, args)

    print(json.dumps({"kernels": list(report.kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": gpu_name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
