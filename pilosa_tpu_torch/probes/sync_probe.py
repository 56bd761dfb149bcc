"""Time a warm fused round of config 8's Counts with each compressed
leaf's row index copied to the card pageable or pinned.

    python3 -m pilosa_tpu_torch.probes.sync_probe [--rounds N] [--out FILE]

On one NVIDIA GPU, builds ``bench.py`` config 8's index through
``API()`` (8 shards x 200,000 records, seed 8, ``city`` 50 rows and
``device`` 10 rows; sparse enough that the stacks sit compressed) and
runs its 32 ``Count(Intersect(Row(city), Row(device)))`` over random
4-of-8 shard subsets as one ``execute_many(per_query_shards=...)`` round.
``ops/ctiles._device_index`` is swapped between the pageable copy (a
``torch.as_tensor(..., device=)``, which waits for the card's queued
work) and the port's pinned ``non_blocking`` one, in the order pageable,
pinned, pinned, pageable. For each it prints the median wall ms of a
warm round and the implicit syncs that
``torch.cuda.set_sync_debug_mode("warn")`` reports in one round, beside
the card's name and power limit, and writes them as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
import warnings


def _card() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else ""


def _pageable(values, device):
    import numpy as np
    import torch

    return torch.as_tensor(np.asarray(values, dtype=np.int64), device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("sync_probe: no CUDA device")
    from pilosa_tpu_torch.api import API
    from pilosa_tpu_torch.core import stacked as STK
    from pilosa_tpu_torch.ops import ctiles as C
    from pilosa_tpu_torch.ops import kernel_util as KU
    from pilosa_tpu_torch.shardwidth import SHARD_WIDTH

    KU.lib()
    rng = np.random.default_rng(8)
    n_shards, per_shard, nq = 8, 200_000, 32
    api = API()
    api.create_index("c8")
    api.create_field("c8", "city")
    api.create_field("c8", "device")
    for shard in range(n_shards):
        cols = shard * SHARD_WIDTH + np.arange(per_shard)
        api.import_bits("c8", "city", rows=rng.integers(0, 50, per_shard),
                        cols=cols)
        api.import_bits("c8", "device", rows=rng.integers(0, 10, per_shard),
                        cols=cols)
    subsets = [sorted(rng.choice(n_shards, size=4, replace=False).tolist())
               for _ in range(nq)]
    queries = [f"Count(Intersect(Row(city={i % 50}), Row(device={i % 10})))"
               for i in range(nq)]

    def fused_round():
        return api.executor.execute_many("c8", queries,
                                         per_query_shards=subsets)

    want = fused_round()
    idx = api.holder.index("c8")
    kinds = {}
    for f in ("city", "device"):
        st = STK.stacked_set(idx.field(f), list(range(n_shards)), "standard")
        kinds[f] = [type(st._ensure_block(i)).__name__
                    for i in range(st.n_blocks)]
    card = _card()
    print(f"sync_probe: config 8 blocks {kinds} ({card})")
    pinned = C._device_index
    out = {"card": card, "blocks": kinds, "runs": []}
    try:
        for name in ("pageable", "pinned", "pinned", "pageable"):
            C._device_index = _pageable if name == "pageable" else pinned
            assert fused_round() == want
            torch.cuda.synchronize()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    assert fused_round() == want
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            syncs = sum("prototype" not in str(w.message) for w in caught)
            ms = []
            for _ in range(args.rounds):
                t0 = time.perf_counter()
                fused_round()
                ms.append((time.perf_counter() - t0) * 1e3)
            run = {"index_copy": name, "round_ms_p50": statistics.median(ms),
                   "implicit_syncs_per_round": syncs}
            out["runs"].append(run)
            print(f"sync_probe: {name} index copy: a warm fused round of "
                  f"{nq} Counts {run['round_ms_p50']:.3f} ms (median of "
                  f"{args.rounds}), {syncs} implicit syncs ({card})")
    finally:
        C._device_index = pinned
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
