"""Time ``API.query``'s own work on the small reads of ``bench.py``
config 7, for setting two trees of the port side by side.

    python3 pilosa_tpu_torch/probes/query_overhead_probe.py \\
        [--config 7|1] [--iters N] [--blocks B] [--device cpu] [--out FILE]

Builds config 7 as ``chip_smoke.py``'s path 9b does (1,000,000 records
of seed 7, ``city`` 50 rows and ``device`` 10, one shard) through
``API()`` and times, in ``--blocks`` interleaved blocks of ``--iters``
calls each, ``Count(Intersect(Row(city=3), Row(device=7)))`` through
``api.query`` and through ``api.executor.execute`` on the parsed query, the calls in
a rotating order:
with the result cache off (a ``tape_count`` launch and a wait) and on
and warm (no launch). ``api.query`` less ``executor.execute`` is the
API's own work: the metric, the span, and from the SQL slice on the
history record. Where the API has that recording (``API._recorded``),
the query is also timed with it taken out, in the same blocks, and the
difference is the recording's own cost. It prints the median and p99 microseconds of each,
each piece of a request's own work alone (a request id, the clocks, a
span, the parse, the history record, the whole recording around a
request), the file of the
``pilosa_tpu_torch`` package it imported and the card's name and power
limit, and writes them as JSON to ``--out``.

``--config 1`` builds and reads ``bench.py`` config 1 as path 5 does
(the import timed, split and traced into fresh APIs) and also prints
path 5's figure, the p50 of 11 queries right after, before the blocks.

Run as a file, the probe imports the package that ``PYTHONPATH`` names
first, so one copy of it times any tree of the port:
``PYTHONPATH=<tree> python3 <this file>``. Compare two trees only on one
machine in one sitting, in the order A, B, B, A.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time


def _card() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except OSError:
        return ""
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else ""


def _pct(us, q: float) -> float:
    s = sorted(us)
    return s[min(len(s) - 1, int(q * len(s)))]


def _pieces(api, index: str, q: str, parse, n: int = 20_000) -> dict:
    """Median microseconds a call of each piece of a request's own work
    (over 5 blocks of ``n`` calls)."""
    import os
    import random
    import statistics
    import uuid

    from pilosa_tpu_torch.obs.tracing import get_tracer

    rng = random.Random(os.urandom(16))

    def nop_span():
        get_tracer().start_trace("query.pql", index=index).finish()

    fns = {"os.urandom(16)": lambda: os.urandom(16),
           "str(uuid.uuid4())": lambda: str(uuid.uuid4()),
           "str(uuid.UUID(int=getrandbits(128)))": lambda: str(
               uuid.UUID(int=rng.getrandbits(128), version=4)),
           "time.time()": time.time, "time.monotonic()": time.monotonic,
           "span start and finish": nop_span, "parse": lambda: parse(q)}
    hist = getattr(api, "history", None)
    if hist is not None:
        def begin_end():
            hist.end(hist.begin(index, q, "pql"))
        fns["history begin and end"] = begin_end
    if hasattr(api, "_recorded"):
        from pilosa_tpu_torch.obs.tracing import NOP_SPAN

        fns["the recording around a request"] = lambda: api._recorded(
            "pql", index, q, lambda: None, NOP_SPAN)
    out = {}
    for name, fn in fns.items():
        blocks = []
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            blocks.append((time.perf_counter() - t0) * 1e6 / n)
        out[name] = statistics.median(blocks)
    return out


def _config1(new_api, out: dict):
    """Config 1 as ``chip_smoke.py``'s path 5 builds and reads it: the
    timed import, the first query and five more, the split and the
    traced import into fresh APIs, then the p50 of 11 queries (path 5's
    figure) into ``out``, beside the API under ``out["api"]``."""
    import os
    import statistics

    import torch

    from pilosa_tpu_torch.probes import import_probe as IP

    city, dev = IP.config1_data()
    api = new_api()
    IP.timed_import(api, city, dev)
    for c, d in [(7, 3), (0, 0), (999, 9), (500, 5), (123, 1), (42, 8)]:
        api.query("taxi", f"Count(Intersect(Row(city={c}), Row(device={d})))")
    IP.split_import(new_api(), city, dev)
    trace = os.path.abspath(os.path.join("build", "overhead_trace.json"))
    os.makedirs(os.path.dirname(trace), exist_ok=True)
    IP.traced_import(new_api(), city, dev, trace)
    q = "Count(Intersect(Row(city=7), Row(device=3)))"

    def wall_us():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        api.query("taxi", q)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e6

    out["path 5 p50_us of 11"] = statistics.median(
        wall_us() for _ in range(11))
    out["api"] = api
    return city, dev


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=500)
    ap.add_argument("--blocks", type=int, default=8)
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--config", type=int, choices=(7, 1), default=7)
    ap.add_argument("--device", default=None)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import numpy as np

    import pilosa_tpu_torch
    from pilosa_tpu_torch.api import API
    from pilosa_tpu_torch.pql.parser import parse

    def new_api():
        return API() if args.device is None else API(device=args.device)

    out = {"package": pilosa_tpu_torch.__file__, "card": _card(),
           "config": args.config}
    if args.config == 7:
        rng = np.random.default_rng(7)
        city = rng.integers(0, 50, args.n)
        dev = rng.integers(0, 10, args.n)
        index, c, d = "c7", 3, 7
        api = new_api()
        api.create_index(index)
        api.create_field(index, "city")
        api.create_field(index, "device")
        cols = np.arange(args.n)
        api.import_bits(index, "city", rows=city, cols=cols)
        api.import_bits(index, "device", rows=dev, cols=cols)
    else:
        city, dev = _config1(new_api, out)
        api = out.pop("api")
        index, c, d = "taxi", 7, 3
    q = f"Count(Intersect(Row(city={c}), Row(device={d})))"
    parsed = parse(q)
    want = [int(np.sum((city == c) & (dev == d)))]

    def run(fn):
        t0 = time.perf_counter()
        r = fn()
        us = (time.perf_counter() - t0) * 1e6
        assert r == want, (r, want)
        return us

    calls = {"query": lambda: api.query(index, q),
             "execute": lambda: api.executor.execute(index, parsed)}
    if hasattr(api, "_recorded"):
        # the same query with the recording around it taken out
        recorded = api._recorded

        def bare(kind, index, text, run, span):
            try:
                return run()
            finally:
                span.finish()

        def unrecorded():
            api._recorded = bare
            try:
                return api.query(index, q)
            finally:
                api._recorded = recorded

        calls["query unrecorded"] = unrecorded
    us = {f"{mode} {name}": [] for mode in ("off", "warm") for name in calls}
    for fn in calls.values():
        run(fn)
    names = list(calls)
    for b in range(args.blocks):
        # each block starts with the next call, so that none always
        # follows the switch of mode
        order = names[b % len(names):] + names[:b % len(names)]
        api.disable_cache()
        for name in order:
            us[f"off {name}"].extend(run(calls[name])
                                     for _ in range(args.iters))
        api.enable_cache()
        run(calls["query"])  # fill
        for name in order:
            us[f"warm {name}"].extend(run(calls[name])
                                      for _ in range(args.iters))
    api.disable_cache()
    out.update({"iters": args.iters * args.blocks, "n": city.size,
                "history": hasattr(api, "history"),
                "p50_us": {k: float(np.median(v)) for k, v in us.items()},
                "p99_us": {k: _pct(v, 0.99) for k, v in us.items()}})
    for mode in ("off", "warm"):
        p50 = out["p50_us"]
        p50[f"{mode} api own"] = p50[f"{mode} query"] - p50[f"{mode} execute"]
        if f"{mode} query unrecorded" in p50:
            p50[f"{mode} recording"] = (p50[f"{mode} query"]
                                        - p50[f"{mode} query unrecorded"])
    out["pieces_us"] = _pieces(api, index, q, parse)
    print("query_overhead_probe: " + json.dumps(out))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
