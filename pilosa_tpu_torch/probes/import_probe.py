"""Split a bulk set-field import into its stages, on one NVIDIA GPU.

    python3 -m pilosa_tpu_torch.probes.import_probe [--out FILE] [--no-sweep]

Drives ``BASELINE.json`` config 1 as ``bench.py`` ``bench_config1`` builds
it: 1,000,000 records in shard 0 from seed 1, set field ``city`` (row
uniform in [0, 1000)) and set field ``device`` (uniform in [0, 10)),
existence tracked, imported through the public ``API.import_bits`` in
batches of 131,072 records (per batch ``city``, then ``device``; each call
also marks ``_exists``). It measures, on the card:

1. the import's wall seconds, per field and in total (a device sync
   closes every ``Field.import_bits``);
2. the same import with each stage function wrapped by the probe, a
   device sync before and after every call: seconds by stage (sort and
   dedup, row or tile gather, H2D, kernel, D2H, host write-back, the
   rest), each function's own time without the functions it calls, and
   where the tree stages its copies, their bytes as counted;
3. the same import under ``torch.profiler``: device operations by name,
   ``scatter_merge`` launches and device operations per launch, and the
   bytes each way over PCIe (the memcpy events' own byte counts);
4. the pinned and the pageable copy rates, each way, for 128 KiB and
   16 MiB buffers;
5. where ``ops/scatter.py`` stages touched tiles (it has ``TILE_WORDS``),
   the import at every tile size from 8 to 512 words, at config 1 and at
   a sparse shape (131,072 random columns over 1000 rows of one shard).

Every import answers checks against numpy (row popcounts, the changed
counts), so a wrong import cannot pass for a fast one. The functions it
wraps are looked up by name and skipped where a tree lacks them, and only
public entry points drive the import, so the probe runs unchanged on a
tree whose import path differs. Prints one line per measurement and
writes them all as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import collections
import importlib
import json
import os
import statistics
import subprocess
import sys
import time

#: bench.py bench_config1: the seed, records, and rows of each field
C1_SEED = 1
C1_RECORDS = 1_000_000
C1_CITIES, C1_DEVICES = 1000, 10
#: records per batch (bench.py's Ingester batch_size)
C1_BATCH = 131_072
#: the sparse shape of the tile sweep: random columns over 1000 rows
SPARSE_BITS, SPARSE_ROWS = 131_072, 1000

#: (stage, module, function) the split wraps, where the module has it.
#: Stage "own" functions report only what they do themselves; the
#: functions they call report their own share.
STAGE_FUNCTIONS = (
    ("sort/dedup", "pilosa_tpu_torch.core.fragment", "group_sorted"),
    ("sort/dedup", "pilosa_tpu_torch.core.field", "group_sorted"),
    ("sort/dedup", "pilosa_tpu_torch.ops.scatter", "sort_updates"),
    # the row gather, and on a row-chunked tree the addresses' H2D
    ("gather", "pilosa_tpu_torch.ops.scatter", "_scatter_chunk"),
    ("gather", "pilosa_tpu_torch.ops.scatter", "_gather_tiles"),
    ("h2d", "pilosa_tpu_torch.platform", "h2d_copy"),
    ("h2d", "pilosa_tpu_torch.ops.scatter", "_h2d"),
    ("kernel", "pilosa_tpu_torch.ops.scatter", "scatter_merge_"),
    ("d2h", "pilosa_tpu_torch.platform", "d2h"),
    ("d2h", "pilosa_tpu_torch.ops.scatter", "_d2h"),
    ("write-back", "pilosa_tpu_torch.ops.scatter", "_put_tiles"),
    # its own time: the write-back on a row-chunked tree; the tile ranks
    # and chunking where _put_tiles writes back
    ("bulk", "pilosa_tpu_torch.ops.scatter", "scatter_new_bits_bulk"),
)

#: staged copies whose word count is an argument (by position): their
#: bytes are counted exactly, where a profiler trace may miss an event
COPY_WORDS_ARG = {"_h2d": 2, "_d2h": 2}


def _smi(query: str) -> str:
    r = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else ""


def config1_data(records: int = C1_RECORDS):
    """(city, device) row of every record, as bench_config1 draws them."""
    import numpy as np

    rng = np.random.default_rng(C1_SEED)
    return (rng.integers(0, C1_CITIES, records),
            rng.integers(0, C1_DEVICES, records))


def import_config1(api, city, device, index: str = "taxi",
                   batch: int = C1_BATCH) -> list:
    """Create the config-1 index on ``api`` and import every batch through
    ``API.import_bits``; returns ``(field, changed)`` per call."""
    import numpy as np

    api.create_index(index)
    api.create_field(index, "city")
    api.create_field(index, "device")
    changed = []
    for lo in range(0, city.size, batch):
        hi = min(lo + batch, city.size)
        ids = np.arange(lo, hi, dtype=np.int64)
        for name, rows in (("city", city), ("device", device)):
            changed.append((name, api.import_bits(index, name,
                                                  rows=rows[lo:hi], cols=ids)))
    return changed


def check_config1(api, city, device, changed, index: str = "taxi") -> None:
    """Every row's popcount equals numpy's count of its records, and the
    changed counts sum to the distinct bits (one per record per field)."""
    import numpy as np

    from pilosa_tpu_torch import native

    idx = api.holder.index(index)
    n = city.size
    for name, rows in (("city", city), ("device", device),
                       ("_exists", np.zeros(n, dtype=np.int64))):
        frag = idx.field(name).fragment(0)
        want = np.bincount(rows)
        got = np.zeros(want.size, dtype=np.int64)
        for r, s in frag.row_index.items():
            got[r] = native.popcount(frag.planes[s])
        assert np.array_equal(got, want), f"{name}: row counts disagree"
    for name in ("city", "device"):
        total = sum(c for f, c in changed if f == name)
        assert total == n, f"{name}: {total} changed bits, {n} records"


class StageTimer:
    """Wraps :data:`STAGE_FUNCTIONS` and ``Field.import_bits`` while
    active. Each wrapped call syncs the device before and after, and adds
    its own seconds (without its wrapped callees) to its stage and its
    whole seconds to its field; ``stages=False`` wraps only
    ``Field.import_bits``."""

    def __init__(self, sync, stages: bool = True):
        self.sync = sync
        self.stages = stages
        self.stage_s = collections.defaultdict(float)
        self.fn_s = collections.defaultdict(float)
        self.calls = collections.Counter()
        self.field_s = collections.defaultdict(float)
        self.moved = collections.Counter()
        self._stack = []
        self._undo = []

    def _wrap(self, stage: str, key: str, fn, field: bool = False):
        words_arg = COPY_WORDS_ARG.get(key.rsplit(".", 1)[-1])

        def run(*a, **kw):
            if words_arg is not None:
                self.moved[stage] += 4 * a[words_arg]
            self.sync()
            self._stack.append(0.0)
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.sync()
                dt = time.perf_counter() - t0
                own = dt - self._stack.pop()
                self.stage_s[stage] += own
                self.fn_s[key] += own
                self.calls[key] += 1
                if field:
                    self.field_s[a[0].name] += dt
                if self._stack:
                    self._stack[-1] += dt
        return run

    def __enter__(self):
        from pilosa_tpu_torch.core.field import Field

        targets = [("rest", Field, "import_bits", True)]
        if self.stages:
            for stage, mod, name in STAGE_FUNCTIONS:
                m = importlib.import_module(mod)
                if hasattr(m, name):
                    targets.append((stage, m, name, False))
        for stage, owner, name, field in targets:
            fn = getattr(owner, name)
            key = f"{getattr(owner, '__name__', owner)}.{name}"
            self._undo.append((owner, name, fn))
            setattr(owner, name, self._wrap(stage, key, fn, field))
        return self

    def __exit__(self, *exc):
        for owner, name, fn in reversed(self._undo):
            setattr(owner, name, fn)
        self._undo.clear()


def split(stage_s: dict, total_s: float, has_put: bool) -> dict:
    """Seconds by stage: sort/dedup, gather, h2d, kernel,
    d2h, write-back, rest (whatever no wrapped function holds)."""
    out = {k: stage_s.get(k, 0.0) for k in ("sort/dedup", "gather", "h2d",
                                            "kernel", "d2h", "write-back")}
    bulk = stage_s.get("bulk", 0.0)
    if not has_put:  # the row-chunked tree writes back in the bulk call
        out["write-back"] += bulk
    out["rest"] = total_s - sum(out.values())
    return out


def trace_ops(fn, path: str) -> dict:
    """Device operations of ``fn()`` in a ``torch.profiler`` trace: count
    and device ms by name (kernels, copies, fills) and the bytes of the
    copies each way, read from the exported trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    ops = collections.defaultdict(lambda: [0, 0.0])
    moved = {"h2d": 0, "d2h": 0, "d2d": 0}
    for e in events:
        cat = e.get("cat", "")
        if cat not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        name = e["name"].split("(")[0].strip() if cat == "kernel" \
            else e["name"]
        ops[name][0] += 1
        ops[name][1] += e.get("dur", 0) / 1e3
        if cat == "gpu_memcpy":
            way = "h2d" if "HtoD" in name else "d2h" if "DtoH" in name \
                else "d2d"
            moved[way] += int(e.get("args", {}).get("bytes", 0))
    return {"ops": {k: {"events": v[0], "device_ms": v[1]}
                    for k, v in sorted(ops.items())},
            "events": sum(v[0] for v in ops.values()),
            "bytes": moved}


def timed_import(api, city, device, index: str = "taxi"):
    """Config 1 into ``api``, checked: (changed per call, wall seconds,
    seconds per field; a device sync closes every ``Field.import_bits``)."""
    import torch

    sync = torch.cuda.synchronize
    with StageTimer(sync, stages=False) as tm:
        sync()
        t0 = time.perf_counter()
        changed = import_config1(api, city, device, index)
        sync()
        import_s = time.perf_counter() - t0
    check_config1(api, city, device, changed, index)
    return changed, import_s, dict(tm.field_s)


def split_import(api, city, device, index: str = "taxi") -> dict:
    """Config 1 into ``api`` with every stage function wrapped, checked:
    the wall seconds, seconds by stage and by function, calls."""
    import torch

    from pilosa_tpu_torch.ops import scatter as SC

    sync = torch.cuda.synchronize
    with StageTimer(sync) as tm:
        sync()
        t0 = time.perf_counter()
        changed = import_config1(api, city, device, index)
        sync()
        total = time.perf_counter() - t0
    check_config1(api, city, device, changed, index)
    return {"import_s": total,
            "stages_s": split(tm.stage_s, total, hasattr(SC, "_put_tiles")),
            "functions_s": dict(tm.fn_s), "function_calls": dict(tm.calls),
            "staged_bytes": dict(tm.moved)}


def traced_import(api, city, device, trace_path: str,
                  index: str = "taxi") -> dict:
    """Config 1 into ``api`` under ``torch.profiler``, checked:
    :func:`trace_ops` plus the ``scatter_merge`` launches and the device
    operations and kernel events per launch."""
    from pilosa_tpu_torch.ops import kernel_util as KU

    before = KU.launches().get("scatter_merge", 0)
    changed = []
    tr = trace_ops(lambda: changed.extend(import_config1(api, city, device,
                                                         index)), trace_path)
    check_config1(api, city, device, changed, index)
    launches = KU.launches().get("scatter_merge", 0) - before
    tr["scatter_merge_launches"] = launches
    tr["device_ops_per_launch"] = tr["events"] / max(launches, 1)
    tr["kernel_events_per_launch"] = sum(
        v["events"] for k, v in tr["ops"].items()
        if "scatter_merge" in k) / max(launches, 1)
    return tr


def copy_rates(device) -> dict:
    """Milliseconds and GB/s of one copy each way, pinned and pageable,
    for 128 KiB and 16 MiB, by CUDA events over back-to-back copies."""
    import torch

    out = {}
    for size in (128 << 10, 16 << 20):
        reps = 200 if size < (1 << 20) else 20
        d = torch.empty(size // 4, dtype=torch.int32, device=device)
        for pinned in (False, True):
            h = torch.empty(size // 4, dtype=torch.int32, pin_memory=pinned)
            for way in ("h2d", "d2h"):
                dst, src = (d, h) if way == "h2d" else (h, d)
                for _ in range(3):
                    dst.copy_(src, non_blocking=True)
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(reps):
                    dst.copy_(src, non_blocking=True)
                end.record()
                end.synchronize()
                ms = start.elapsed_time(end) / reps
                key = f"{way} {'pinned' if pinned else 'pageable'} {size}"
                out[key] = {"bytes": size, "ms": ms, "GB_per_s": size / ms / 1e6}
    return out


def sparse_data():
    """(rows, cols) of the sweep's sparse shape, one shard."""
    import numpy as np

    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    rng = np.random.default_rng(C1_SEED + 1)
    return (rng.integers(0, SPARSE_ROWS, SPARSE_BITS),
            rng.integers(0, SHARD_WIDTH, SPARSE_BITS))


def _import_sparse(api, rows, cols) -> int:
    api.create_index("sparse", {"trackExistence": False})
    api.create_field("sparse", "f")
    return api.import_bits("sparse", "f", rows=rows, cols=cols)


def tile_sweep(make_api, city, device, trace_path: str):
    """Config 1 and the sparse shape at every tile size ``ops/scatter.py``
    may take: import seconds and the bytes each way (traced), checked;
    None on a tree without tiles."""
    import numpy as np
    import torch

    from pilosa_tpu_torch.ops import scatter as SC

    if not hasattr(SC, "TILE_WORDS"):
        return None
    rows, cols = sparse_data()
    n_bits = np.unique(rows * (1 << 20) + cols).size
    keep = SC.TILE_WORDS
    out = {}
    try:
        for t in (8, 16, 32, 64, 128, 256, 512):
            SC.TILE_WORDS = t
            api = make_api()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            changed = import_config1(api, city, device)
            torch.cuda.synchronize()
            c1_s = time.perf_counter() - t0
            check_config1(api, city, device, changed)
            del api
            tr = trace_ops(lambda: import_config1(make_api(), city, device),
                           trace_path)
            sp = []
            for _ in range(5):
                api = make_api()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = _import_sparse(api, rows, cols)
                torch.cuda.synchronize()
                sp.append(time.perf_counter() - t0)
                assert got == n_bits, f"sparse: {got} changed, {n_bits} bits"
            sp_tr = trace_ops(lambda: _import_sparse(make_api(), rows, cols),
                              trace_path)
            out[t] = {"config1_import_s": c1_s, "config1_bytes": tr["bytes"],
                      "sparse_import_s": statistics.median(sp),
                      "sparse_bytes": sp_tr["bytes"]}
    finally:
        SC.TILE_WORDS = keep
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/import_probe.json")
    ap.add_argument("--no-sweep", action="store_true",
                    help="skip the tile-size sweep")
    args = ap.parse_args()

    import numpy as np  # noqa: F401  (fail early without numpy)
    import torch

    if not torch.cuda.is_available():
        print("import_probe: no CUDA device", file=sys.stderr)
        return 1
    from pilosa_tpu_torch.api import API
    from pilosa_tpu_torch.ops import kernel_util as KU

    name_power = _smi("name,power.limit")
    print(f"import_probe: {name_power}; torch {torch.__version__}")
    KU.lib()
    device = torch.device("cuda", 0)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    trace_path = os.path.abspath(args.out) + ".trace.json"
    city, dev = config1_data()
    # warm-up: kernels loaded, allocators and staging buffers made
    warm = import_config1(API(), city[:20000], dev[:20000], batch=8192)
    assert sum(c for f, c in warm if f == "city") == 20000

    res = {"card": name_power, "records": int(city.size)}
    KU.reset_launches()
    changed, import_s, field_s = timed_import(API(), city, dev)
    imp = {"import_s": import_s, "field_s": field_s, "changed": changed,
           "launches": KU.launches().get("scatter_merge", 0)}
    imp["split"] = split_import(API(), city, dev)
    imp["trace"] = traced_import(API(), city, dev, trace_path)
    res["config1"] = imp
    res["copy_rates"] = copy_rates(device)
    if not args.no_sweep:
        res["tile_sweep"] = tile_sweep(API, city, dev, trace_path)

    tr = imp["trace"]
    print(f"import_probe: config 1, {city.size} records in batches of "
          f"{C1_BATCH}: import {imp['import_s']:.3f} s ("
          + ", ".join(f"{k} {v:.3f} s" for k, v in imp["field_s"].items())
          + f"); {imp['launches']} scatter_merge launches ({name_power})")
    sp = imp["split"]
    print(f"import_probe: split ({sp['import_s']:.3f} s with a sync "
          f"around every stage call): " + ", ".join(
              f"{k} {v:.3f} s" for k, v in sp["stages_s"].items()))
    if sp["staged_bytes"]:
        print(f"import_probe: staged copies, counted: {sp['staged_bytes']}")
    print("import_probe: functions, own seconds (calls): " + ", ".join(
        f"{k} {v:.3f} ({sp['function_calls'][k]})"
        for k, v in sp["functions_s"].items()))
    print(f"import_probe: trace: {tr['events']} device ops, "
          f"{tr['device_ops_per_launch']:.2f} per launch "
          f"({tr['kernel_events_per_launch']:.2f} kernel events per launch); "
          f"PCIe bytes h2d {tr['bytes']['h2d']}, d2h {tr['bytes']['d2h']}; "
          + ", ".join(f"{k} x{v['events']} {v['device_ms']:.3f} ms"
                      for k, v in tr["ops"].items()))
    for k, v in res["copy_rates"].items():
        print(f"import_probe: copy {k} B: {v['ms']:.4f} ms, "
              f"{v['GB_per_s']:.2f} GB/s ({name_power})")
    for t, v in (res.get("tile_sweep") or {}).items():
        print(f"import_probe: T={t}: config 1 {v['config1_import_s']:.3f} s, "
              f"h2d {v['config1_bytes']['h2d']} B, d2h "
              f"{v['config1_bytes']['d2h']} B; sparse "
              f"{v['sparse_import_s'] * 1e3:.2f} ms, h2d "
              f"{v['sparse_bytes']['h2d']} B, d2h {v['sparse_bytes']['d2h']} B")
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1, default=str)
    print(f"import_probe: wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
