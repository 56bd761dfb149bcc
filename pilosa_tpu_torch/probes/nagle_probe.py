"""Time ``GET /status`` over one keep-alive connection with the port's
``TCP_NODELAY`` and with Nagle's algorithm on.

    python3 -m pilosa_tpu_torch.probes.nagle_probe [--n N] [--device D]
        [--out FILE]

Serves an empty ``API()`` in-process twice on a free loopback port:
once with the port's handler (``disable_nagle_algorithm = True``) and
once with Nagle's algorithm left on, as the JAX package's handler does.
Only the second server's own bound handler class is changed. A response
is two writes (headers, then body); with Nagle's algorithm on, the body
can wait for the client's delayed ACK. Prints the median ms of ``--n``
requests (after 5 warm-up requests) for each, beside the card's name and
power limit, and writes them as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import http.client
import json
import statistics
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


def status_p50_ms(api, nodelay: bool, n: int) -> float:
    """Median ms of ``n`` keep-alive ``GET /status`` requests to an
    in-process server of ``api``."""
    from pilosa_tpu_torch.server.http import serve

    srv, _ = serve(api, port=0, background=True)
    srv.RequestHandlerClass.disable_nagle_algorithm = nodelay
    conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1],
                                      timeout=60)
    lat = []
    try:
        for i in range(n + 5):
            t0 = time.perf_counter()
            conn.request("GET", "/status")
            resp = conn.getresponse()
            data = resp.read()
            assert resp.status == 200, data
            if i >= 5:
                lat.append((time.perf_counter() - t0) * 1e3)
    finally:
        conn.close()
        srv.shutdown()
        srv.server_close()
    return statistics.median(lat)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=40)
    ap.add_argument("--device", default=None,
                    help="the API's device (default: the card)")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    from pilosa_tpu_torch.api import API

    api = API() if args.device is None else API(device=args.device)
    out = {"device": str(api.device), "card": _card(), "n": args.n}
    for nodelay in (True, False, False, True):
        key = "nodelay_ms" if nodelay else "nagle_ms"
        out.setdefault(key, []).append(status_p50_ms(api, nodelay, args.n))
    print(f"nagle_probe: GET /status p50 over keep-alive "
          f"{out['nodelay_ms']} ms with TCP_NODELAY, {out['nagle_ms']} ms "
          f"with Nagle's algorithm on, {out['device']} ({out['card']})")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
