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
   events (the call, host enqueue included) and with ``torch.profiler``
   (the kernel alone) beside its bound;
4. main path 1: the SSB scale-factor-1 deployment (6 shards x 2^20
   lineorder columns, a 7-row mutex ``year`` and a 1000-row keyed mutex
   ``brand``) imported through ``API.import_bits`` and queried with
   ``GroupBy(Rows(year), Rows(brand), limit=100)TopN(brand, n=10)`` and a
   set of ``Count`` trees, every answer checked against a numpy oracle
   built from the generator, the launch count of every kernel this path
   runs checked above 0;
5. main path 2: the BSI deployment (``BASELINE.json`` config 2: 10 shards
   x 2^20 columns, one ``int`` field ``amount`` of depth 20, a value in
   every column) imported through ``API.import_values`` and queried with
   ``Sum(Row(amount > 524288), field=amount)`` plus Range counts, Min,
   Max and Percentile, each against a numpy oracle, with all four
   kernels' launch counts checked above 0; then a small index with
   negative values, a base, a decimal field and GroupBy aggregates,
   whose stacks also hold bsi_compare and pair_counts against their
   plain versions at that index's shapes;
6. one ``{"kernels": [...]}`` JSON line;
7. the last line: ``{"ok": true, "device": {...}}``.

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
#: 32-bit bitwise AND/OR/XOR results per clock per SM, same table
LOP_PER_CLOCK_PER_SM = 64


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


def _device_ms(fn, kernel: str = "", calls: int = 20):
    """Mean device milliseconds per call of ``fn`` spent in kernels whose
    name contains ``kernel`` ("" = every device activity, copies
    included), from a ``torch.profiler`` trace of ``calls`` calls; None
    when the trace holds no device time for them. Unlike ``_time_ms``,
    this excludes the host's time to enqueue each launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
    except RuntimeError as e:  # no CUPTI tracing on this machine
        print(f"profiler: {e}")
        return None
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if kernel in e.key)
    return us / calls / 1e3 if us > 0 else None


def _fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def _rand_words(rng, shape, device):
    import numpy as np
    import torch

    host = rng.integers(0, 1 << 32, size=shape, dtype=np.uint32)
    return torch.from_numpy(host.view(np.int32)).to(device)


class Report:
    def __init__(self, gpu_name: str, power_limit: str):
        self.label = f"({gpu_name}, power limit {power_limit})"
        self.kernels = {}

    def launched(self, path: str, counts: dict, expected) -> None:
        """Record one main path's launch counts; every kernel of
        ``expected`` must have launched on it."""
        for name in expected:
            assert counts.get(name, 0) > 0, \
                f"kernel {name} was not launched on the {path} path"
        for name, c in counts.items():
            k = self.kernels.setdefault(name, {"name": name, "route": "cuda",
                                               "max_abs_err": 0})
            k["launches"] = k.get("launches", 0) + c
            k.setdefault("launches_by_path", {})[path] = c

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
                  mem_rate: float, lop_rate: float) -> None:
    import numpy as np
    import torch

    from pilosa_tpu_torch.ops import bitmap as B
    from pilosa_tpu_torch.ops import bsi as S
    from pilosa_tpu_torch.ops import groupby as G
    from pilosa_tpu_torch.ops import scatter as SC
    from pilosa_tpu_torch.shardwidth import WORDS_PER_SHARD

    main_w = 6 * WORDS_PER_SHARD  # the SSB path's stacked width
    bsi_w = 10 * WORDS_PER_SHARD  # the BSI path's stacked width

    # -- tape_count ---------------------------------------------------------
    tapes = [
        ((("or", 0, 0),), 1),  # the BSI aggregates' one-plane count
        ((("and", 0, 1),), 2),
        ((("andnot", 0, 1),), 2),  # the Percentile walk's low half
        ((("or", 0, 1), ("xor", 2, 0)), 2),
        ((("and", 0, 1), ("andnot", 3, 2)), 3),
        ((("and", 0, 1), ("or", 4, 2), ("andnot", 5, 3)), 4),
    ]
    # the edge-case index's one shard, and both main paths' widths
    for w in (1, 7, 512, WORDS_PER_SHARD, main_w, bsi_w):
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
    kern_ms = _device_ms(lambda: B.tape_count(tape, leaves), "tape_count")
    by_bytes = (2 * main_w * 4 + 4) / mem_rate * 1e3
    by_ops = main_w / popc_rate * 1e3
    report.kernel("tape_count", source="pilosa_tpu_torch/csrc/tape_count.cu",
                  replaces="pilosa_tpu/ops/bitmap.py:209", ms=ms,
                  plain_ms=plain_ms, bound_ms=max(by_bytes, by_ops),
                  bound_by="bytes" if by_bytes >= by_ops else "operations",
                  library_ms=None, shape=f"2 leaves x {main_w} words",
                  kernel_ms=kern_ms)
    print(f"kernel tape_count: 2x{main_w} words {ms:.4f} ms "
          f"(kernel alone {_fmt_ms(kern_ms)}, plain {plain_ms:.4f} ms, "
          f"bound {max(by_bytes, by_ops):.4f} ms) {report.label}")

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
    timings, kernel_alone = {}, {}
    for r1 in (8, 1):  # GroupBy year x brand block; TopN filter x block
        a = _rand_words(rng, (r1, main_w), device)
        b = _rand_words(rng, (256, main_w), device)
        ms = _time_ms(lambda: G.pair_counts(a, b))
        plain_ms = _time_ms(lambda: G.pair_counts_plain(a, b), reps=2,
                            trials=5)
        kernel_alone[r1] = _device_ms(lambda: G.pair_counts(a, b),
                                      "pair_counts")
        by_bytes = ((r1 + 256) * main_w * 4 + r1 * 256 * 4) / mem_rate * 1e3
        by_ops = r1 * 256 * main_w / popc_rate * 1e3
        timings[r1] = (ms, plain_ms, by_bytes, by_ops)
        print(f"kernel pair_counts: {r1}x256x{main_w} words {ms:.4f} ms "
              f"(kernel alone {_fmt_ms(kernel_alone[r1])}, plain "
              f"{plain_ms:.4f} ms, bytes bound {by_bytes:.4f} ms, "
              f"popc bound {by_ops:.4f} ms) {report.label}")
    # Sum on the BSI path: the two sign classes x the 20 magnitude planes
    # (a view of the stack)
    a = _rand_words(rng, (2, bsi_w), device)
    stack = _rand_words(rng, (2 + 20, bsi_w), device)
    report.err("pair_counts", G.pair_counts(a, stack[2:]),
               G.pair_counts_plain(a, stack[2:]))
    sum_ms = _time_ms(lambda: G.pair_counts(a, stack[2:]))
    sum_kern_ms = _device_ms(lambda: G.pair_counts(a, stack[2:]),
                             "pair_counts")
    sum_bound = max((22 * bsi_w * 4 + 2 * 20 * 4) / mem_rate * 1e3,
                    2 * 20 * bsi_w / popc_rate * 1e3)
    print(f"kernel pair_counts: 2x20x{bsi_w} words (Sum) {sum_ms:.4f} ms "
          f"(kernel alone {_fmt_ms(sum_kern_ms)}, bound {sum_bound:.4f} ms) "
          f"{report.label}")
    ms, plain_ms, by_bytes, by_ops = timings[8]
    report.kernel("pair_counts",
                  source="pilosa_tpu_torch/csrc/pair_counts.cu",
                  replaces="pilosa_tpu/ops/groupby.py:98", ms=ms,
                  plain_ms=plain_ms, bound_ms=max(by_bytes, by_ops),
                  bound_by="bytes" if by_bytes >= by_ops else "operations",
                  library_ms=None, shape=f"8x256x{main_w}",
                  kernel_ms=kernel_alone[8], topn_kernel_ms=kernel_alone[1],
                  topn_ms=timings[1][0],
                  topn_bound_ms=max(timings[1][2], timings[1][3]),
                  sum_ms=sum_ms, sum_kernel_ms=sum_kern_ms,
                  sum_bound_ms=sum_bound)

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
    kern_ms = _device_ms(lambda: SC.scatter_merge_(flat, addr, masks),
                         "scatter_merge")
    by_bytes = (16 * m + 4) / mem_rate * 1e3
    by_ops = m / popc_rate * 1e3
    report.kernel("scatter_merge",
                  source="pilosa_tpu_torch/csrc/scatter_merge.cu",
                  replaces="pilosa_tpu/ops/scatter.py:91", ms=ms,
                  plain_ms=plain_ms, bound_ms=max(by_bytes, by_ops),
                  bound_by="bytes" if by_bytes >= by_ops else "operations",
                  library_ms=None, shape=f"{m} updates into {n} words",
                  kernel_ms=kern_ms)
    print(f"kernel scatter_merge: {m} updates into {n} words {ms:.4f} ms "
          f"(kernel alone {_fmt_ms(kern_ms)}, plain {plain_ms:.4f} ms, "
          f"bound {max(by_bytes, by_ops):.4f} ms) {report.label}")

    # -- bsi_compare --------------------------------------------------------
    for depth in (1, 20, 64):
        top = 1 << depth
        mid = int(rng.integers(1, min(top, 1 << 62)))
        consts = [(-mid, None), (-1, None), (0, None), (mid, None),
                  (top, None), (-top - 5, None)]
        pairs = [(-mid, mid), (mid, -mid), (0, 0), (-top, top), (5, 4)]
        for w in (1, 7, 512, 1000, bsi_w):
            planes = _rand_words(rng, (S.OFFSET + depth, w), device)
            for op in (S.EQ, S.NE, S.LT, S.LE, S.GT, S.GE, S.BETWEEN):
                for c, c2 in (pairs if op == S.BETWEEN else consts):
                    report.err("bsi_compare",
                               S.bsi_compare(planes, op, c, c2),
                               S.bsi_compare_plain(planes, op, c, c2))
    planes = _rand_words(rng, (S.OFFSET + 20, bsi_w), device)
    ms = _time_ms(lambda: S.bsi_compare(planes, S.GT, 524288))
    plain_ms = _time_ms(lambda: S.bsi_compare_plain(planes, S.GT, 524288),
                        reps=3, trials=5)
    kern_ms = _device_ms(lambda: S.bsi_compare(planes, S.GT, 524288),
                         "bsi_compare")
    by_bytes = (22 + 1) * bsi_w * 4 / mem_rate * 1e3
    # per word: two sign-class masks, six logic ops per plane (3 per
    # class), the overflow/sign selection and the op
    by_ops = (2 + 6 * 20 + 4) * bsi_w / lop_rate * 1e3
    report.kernel("bsi_compare", source="pilosa_tpu_torch/csrc/bsi_compare.cu",
                  replaces="pilosa_tpu/ops/bsi.py:138", ms=ms,
                  plain_ms=plain_ms, bound_ms=max(by_bytes, by_ops),
                  bound_by="bytes" if by_bytes >= by_ops else "operations",
                  library_ms=None, shape=f"GT over 22 x {bsi_w} words",
                  ops_bound_ms=by_ops, kernel_ms=kern_ms)
    print(f"kernel bsi_compare: GT over 22x{bsi_w} words {ms:.4f} ms "
          f"(kernel alone {_fmt_ms(kern_ms)}, plain {plain_ms:.4f} ms, bytes "
          f"bound {by_bytes:.4f} ms, logic bound {by_ops:.4f} ms) "
          f"{report.label}")
    torch.cuda.synchronize()
    print("library_ms: null for every kernel: PyTorch has no popcount op "
          "and no bit-sliced compare, so no single PyTorch call computes "
          "any of these functions")


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
    report.launched("ssb", launched,
                    ("tape_count", "pair_counts", "scatter_merge"))

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


def _percentile_oracle(sorted_vals, nth: float):
    """(value, count) at percentile ``nth`` by the JAX package's rank rule
    (pilosa_tpu/ops/bsi.py:491-496): rank = ceil(nth/100 * total) in
    integers, clipped to [1, total], counted from the smallest value."""
    total = sorted_vals.size
    x100 = round(nth * 100)
    q, rem = divmod(total, 10000)
    rank = min(max(x100 * q + (x100 * rem + 9999) // 10000, 1), total)
    v = int(sorted_vals[rank - 1])
    return v, int((sorted_vals == v).sum())


def phase_bsi_path(report: Report, args, shards: int = 10) -> None:
    import numpy as np
    import torch

    from pilosa_tpu_torch.api import API
    from pilosa_tpu_torch.core.stacked import stacked_bsi
    from pilosa_tpu_torch.ops import bsi as S
    from pilosa_tpu_torch.ops import kernel_util as KU
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    rng = np.random.default_rng(args.seed)
    n = shards * SHARD_WIDTH
    amount = rng.integers(0, 1 << 20, n)
    cols = np.arange(n, dtype=np.int64)

    KU.reset_launches()
    t0 = time.perf_counter()
    api = API()
    api.create_index("b")
    api.create_field("b", "amount", {"type": "int"})
    api.import_values("b", "amount", cols=cols, values=amount)
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0

    half = 524288
    v = int(amount[12345])
    sum_q = f"Sum(Row(amount > {half}), field=amount)"
    counts_q = {
        f"Count(Row(amount > {half}))": amount > half,
        "Count(Row(1000 <= amount <= 2000))":
            (amount >= 1000) & (amount <= 2000),
        f"Count(Row(amount == {v}))": amount == v,
        f"Count(Row(amount != {v}))": amount != v,
        "Count(Row(amount < 100))": amount < 100,
    }
    got_sum = api.query("b", sum_q)[0]
    got_counts = {q: api.query("b", q)[0] for q in counts_q}
    got_min = api.query("b", "Min(field=amount)")[0]
    got_max = api.query("b", f"Max(Row(amount < {half}), field=amount)")[0]
    got_pct = {nth: api.query("b", f"Percentile(field=amount, nth={nth})")[0]
               for nth in (50, 99)}
    torch.cuda.synchronize()
    launched = KU.launches()

    # -- oracle ---------------------------------------------------------------
    big = amount[amount > half]
    assert (got_sum.val, got_sum.count) == (int(big.sum()), big.size), \
        f"{sum_q} disagrees: {got_sum}"
    for q, sel in counts_q.items():
        assert got_counts[q] == int(sel.sum()), f"{q} disagrees"
    lo = int(amount.min())
    assert (got_min.val, got_min.count) == (lo, int((amount == lo).sum())), \
        "Min disagrees"
    below = amount[amount < half]
    hi = int(below.max())
    assert (got_max.val, got_max.count) == (hi, int((below == hi).sum())), \
        "filtered Max disagrees"
    ordered = np.sort(amount)
    for nth, got in got_pct.items():
        assert (got.val, got.count) == _percentile_oracle(ordered, nth), \
            f"Percentile nth={nth} disagrees"

    field = api.holder.index("b").field("amount")
    st = stacked_bsi(field, list(range(shards)))
    assert st.depth == 20, f"stack depth {st.depth}"
    assert st.planes.is_cuda and st.planes.shape == (22, n // 32)
    report.launched("bsi", launched, ("tape_count", "pair_counts",
                                      "scatter_merge", "bsi_compare"))

    p50 = statistics.median(_wall_ms(lambda: api.query("b", sum_q))
                            for _ in range(11))

    def sum_kernels():  # the Sum query's device work on its resident stack
        filt = st.compare(S.GT, half)
        S.bsi_plane_popcounts(st.planes, filt)

    kern_ms = _time_ms(sum_kernels, reps=5, trials=7)
    busy_ms = _device_ms(lambda: api.query("b", sum_q), calls=11)
    print(f"bsi path: {n} columns, depth {st.depth}; import {import_s:.3f} s; "
          f"BSI stack bytes {st.planes.numel() * 4}; device bytes allocated "
          f"{torch.cuda.memory_allocated()} (earlier paths' stacks "
          f"included); launches {launched} {report.label}")
    print(f"bsi path: p50 of {sum_q} {p50:.3f} ms; its device work "
          f"(bsi_compare, sign masks, pair_counts, tape_count) {kern_ms:.4f} "
          f"ms, {100 * kern_ms / p50:.1f}% of the p50; device busy per query "
          f"in a profiler trace {_fmt_ms(busy_ms)} {report.label}")
    _bsi_edge_cases(report, API)
    print("bsi path: every answer matches the numpy oracle")


def _bsi_edge_cases(report: Report, API) -> None:
    """One shard: negative values with a base, a decimal field, GroupBy
    Sum aggregates over one and two fields, against numpy; then the
    kernels at this index's shapes against their plain versions."""
    import numpy as np
    import torch

    from pilosa_tpu_torch.core.stacked import stacked_bsi, stacked_set
    from pilosa_tpu_torch.ops import bsi as S
    from pilosa_tpu_torch.ops import groupby as G
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    rng = np.random.default_rng(17)
    n = SHARD_WIDTH
    cols = np.arange(n, dtype=np.int64)
    m = rng.integers(0, 5, n)
    g = rng.integers(0, 3, n)
    base = -250
    v = rng.integers(-30000, 30000, n)
    d_stored = rng.integers(-10 ** 6, 10 ** 6, n)
    api = API()
    api.create_index("e")
    api.create_field("e", "m", {"type": "mutex"})
    api.create_field("e", "g", {"type": "mutex"})
    api.create_field("e", "v", {"type": "int", "base": base})
    api.create_field("e", "d", {"type": "decimal", "scale": 2})
    api.import_bits("e", "m", rows=m, cols=cols)
    api.import_bits("e", "g", rows=g, cols=cols)
    api.import_values("e", "v", cols=cols, values=v)
    api.import_values("e", "d", cols=cols, values=d_stored / 100)

    stored = v - base  # GroupBy's agg is the raw stored sum
    got = api.query("e", "GroupBy(Rows(m), aggregate=Sum(field=v))")[0]
    want = [(r, int((m == r).sum()), int(stored[m == r].sum()))
            for r in range(5)]
    assert [(x.group[0].row_id, x.count, x.agg) for x in got] == want, \
        "1-field GroupBy Sum disagrees"
    got = api.query("e", "GroupBy(Rows(m), Rows(g), aggregate=Sum(field=v))")[0]
    want = [(a, b, int(((m == a) & (g == b)).sum()),
             int(stored[(m == a) & (g == b)].sum()))
            for a in range(5) for b in range(3)]
    assert [(x.group[0].row_id, x.group[1].row_id, x.count, x.agg)
            for x in got] == want, "2-field GroupBy Sum disagrees"
    neg = v[v < 0]
    checks = {
        "Min(field=v)": (int(v.min()), int((v == v.min()).sum())),
        "Max(Row(v < 0), field=v)": (int(neg.max()),
                                     int((neg == neg.max()).sum())),
        "Percentile(field=v, nth=10)": _percentile_oracle(np.sort(v), 10),
        "Sum(Row(m=2), field=v)": (int(v[m == 2].sum()), int((m == 2).sum())),
        "Sum(field=d)": (int(d_stored.sum()) / 100, n),
    }
    for q, want in checks.items():
        r = api.query("e", q)[0]
        assert (r.val, r.count) == want, f"{q}: {r} != {want}"

    # the kernels on this index's own stacks, at the shapes its queries
    # give them, against their plain versions
    idx = api.holder.index("e")
    for fname in ("v", "d"):
        planes = stacked_bsi(idx.field(fname), [0]).planes
        for op, c, c2 in ((S.GT, 0, None), (S.LT, -7000, None),
                          (S.EQ, 250, None), (S.NE, 250, None),
                          (S.BETWEEN, -30000, 12345)):
            report.err("bsi_compare", S.bsi_compare(planes, op, c, c2),
                       S.bsi_compare_plain(planes, op, c, c2))
    planes = stacked_bsi(idx.field("v"), [0]).planes
    mags = planes[S.OFFSET:]
    pos_m = planes[S.EXISTS] & ~planes[S.SIGN]
    neg_m = planes[S.EXISTS] & planes[S.SIGN]
    # 1-field GroupBy Sum: a row block x the 2 * depth signed planes
    signed = torch.cat([mags & pos_m[None, :], mags & neg_m[None, :]])
    st_g = stacked_set(idx.field("g"), [0], "standard")
    for _, a in stacked_set(idx.field("m"), [0], "standard").iter_blocks():
        report.err("pair_counts", G.pair_counts(a, signed),
                   G.pair_counts_plain(a, signed))
        # 2-field GroupBy Sum: both sign classes of a block x one plane
        # of the other field's block
        a2 = torch.cat([a & pos_m[None, :], a & neg_m[None, :]])
        for _, b in st_g.iter_blocks():
            bk = (b & mags[-1][None, :]).contiguous()
            report.err("pair_counts", G.pair_counts(a2, bk),
                       G.pair_counts_plain(a2, bk))


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
    lop_rate = LOP_PER_CLOCK_PER_SM * props.multi_processor_count \
        * clock_mhz * 1e6
    phase_kernels(report, np.random.default_rng(args.seed + 1), device,
                  popc_rate, mem_rate, lop_rate)
    print("kernel parity: every kernel matches its plain version bit for "
          "bit")
    phase_main_path(report, args)
    phase_bsi_path(report, args)

    print(json.dumps({"kernels": list(report.kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": gpu_name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
