"""The ``pilosa-tpu`` command-line interface.

Port of ``pilosa_tpu/ctl/cli.py``. ``server`` and the in-process
``datagen`` run on the card (``cuda:0``) unless ``--device cpu`` asks
for the plain PyTorch versions; without a card and without ``--device
cpu``, ``server`` exits non-zero with the device error and serves
nothing.

Reference: cmd/root.go:50 cobra dispatch over ctl/ implementations:
``server`` (ctl/server.go), ``backup``/``restore`` (ctl/backup.go,
restore.go), ``import``/``export`` (ctl/import.go, export.go), ``chksum``
(ctl/chksum.go), ``generate-config`` (ctl/generate_config.go), plus the
``fbsql`` shell (cli/cli.go) as a subcommand here.

Run as ``python -m pilosa_tpu_torch <subcommand>``.
"""

from __future__ import annotations

import argparse
import csv
import sys
import urllib.request
from typing import List, Optional

from pilosa_tpu_torch.config import Config


def _http(host: str, method: str, path: str, body: Optional[bytes] = None,
          headers: Optional[dict] = None):
    req = urllib.request.Request(host.rstrip("/") + path, data=body,
                                 method=method, headers=headers or {})
    return urllib.request.urlopen(req)


def _device(args):
    """The device the command runs on: the card unless ``--device``
    names another; no card is an error, never a move to the CPU."""
    from pilosa_tpu_torch.platform import resolve_device

    try:
        return resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"pilosa-tpu: {e}")


def cmd_server(args) -> int:
    cfg = Config.from_sources(toml_path=args.config, flags={
        "bind": args.bind, "port": args.port, "data_dir": args.data_dir,
        "wal_sync": args.wal_sync,
    })
    device = _device(args)
    from pilosa_tpu_torch.api import API
    from pilosa_tpu_torch.obs.logger import configure as configure_logging
    from pilosa_tpu_torch.server.http import serve

    configure_logging(cfg.log_level, cfg.log_path or None)
    api = API(cfg.data_dir or None, wal_sync=cfg.wal_sync,
              segment_bytes=cfg.storage_recovery_segment_bytes,
              device=device)
    # [storage.recovery] checkpoint interval wins when set; the legacy
    # top-level checkpoint-bytes knob stays the fallback
    api.holder.checkpoint_bytes = (
        cfg.storage_recovery_checkpoint_interval_bytes
        or cfg.checkpoint_bytes)
    if cfg.scheduler_enabled:
        api.enable_scheduler(cfg)
    if cfg.cache_enabled:
        api.enable_cache(cfg)
    # the JAX package's server leaves these to PILOSA_TPU_TENANTS /
    # PILOSA_TPU_DEGRADE; the port's also reads the config's switches
    if cfg.tenants_enabled:
        api.enable_tenants(cfg)
    if cfg.degrade_enabled:
        api.enable_degrade(cfg)
    if cfg.stream_enabled:
        if not cfg.stream_index:
            raise SystemExit("stream.enabled requires stream.index")
        api.enable_stream(cfg.stream_index, cfg).start()
    if cfg.query_log_path:
        api.set_query_logger(cfg.query_log_path)
    auth = None
    if cfg.auth_enable:
        from pilosa_tpu_torch.server.auth import Auth, Permissions, \
            parse_permissions

        perms = Permissions()
        if cfg.auth_permissions_file:
            with open(cfg.auth_permissions_file) as f:
                perms = parse_permissions(f.read())
        if not cfg.auth_secret:
            raise SystemExit("auth.enable requires auth.secret")
        auth = Auth(cfg.auth_secret, perms,
                    allowed_networks=cfg.auth_allowed_networks,
                    secure_cookies=cfg.auth_secure_cookies)
    srv, thread = serve(api, host=cfg.bind, port=cfg.port, background=True,
                        maintenance_interval_s=cfg.ttl_removal_interval_s,
                        auth=auth)
    # the bound port (``--port 0`` picks a free one), once it listens
    host, port = srv.server_address[:2]
    print(f"pilosa-tpu serving on {host}:{port} "
          f"(data-dir={cfg.data_dir or '<memory>'}, device={device}"
          f"{', auth on' if auth else ''})", file=sys.stderr, flush=True)
    thread.join()
    return 0


def cmd_generate_config(args) -> int:
    sys.stdout.write(Config().to_toml())
    return 0


def cmd_backup(args) -> int:
    with _http(args.host, "GET", "/internal/backup.tar") as resp, \
            open(args.output, "wb") as f:
        while True:
            chunk = resp.read(1 << 20)
            if not chunk:
                break
            f.write(chunk)
    print(f"backup written to {args.output}", file=sys.stderr)
    return 0


def cmd_restore(args) -> int:
    with open(args.source, "rb") as f:
        data = f.read()
    _http(args.host, "POST", "/internal/restore", body=data)
    print(f"restored {args.source} to {args.host}", file=sys.stderr)
    return 0


def cmd_chksum(args) -> int:
    import json

    with _http(args.host, "GET", "/internal/chksum") as resp:
        print(json.loads(resp.read())["checksum"])
    return 0


def cmd_import(args) -> int:
    """CSV import (reference: ctl/import.go): set fields take
    ``row,col`` lines; int fields (--field-type int) take ``col,value``;
    --keys treats both columns as string keys."""
    import json

    rows: List = []
    cols: List = []
    with open(args.file, newline="") as f:
        for line in csv.reader(f):
            if not line:
                continue
            rows.append(line[0])
            cols.append(line[1])
    if args.field_type == "int":
        body = {"field": args.field,
                "cols": [int(c) for c in rows],
                "values": [int(v) for v in cols]}
        path = f"/index/{args.index}/import-values"
    else:
        if args.keys:
            body = {"field": args.field, "rowKeys": rows, "colKeys": cols,
                    "rows": [], "cols": []}
        else:
            body = {"field": args.field,
                    "rows": [int(r) for r in rows],
                    "cols": [int(c) for c in cols]}
        path = f"/index/{args.index}/import"
    _http(args.host, "POST", path, body=json.dumps(body).encode())
    print(f"imported {len(rows)} rows into {args.index}/{args.field}",
          file=sys.stderr)
    return 0


def cmd_export(args) -> int:
    """CSV export of a set field as ``row,col`` lines (reference:
    ctl/export.go)."""
    import json

    q = f"Rows({args.field})"
    with _http(args.host, "POST", f"/index/{args.index}/query",
               body=q.encode()) as resp:
        rows = json.loads(resp.read())["results"][0]
    w = csv.writer(sys.stdout)
    for row in rows:
        rq = f"Row({args.field}={json.dumps(row)})"
        with _http(args.host, "POST", f"/index/{args.index}/query",
                   body=rq.encode()) as resp:
            res = json.loads(resp.read())["results"][0]
        for col in res.get("columns") or res.get("keys") or []:
            w.writerow([row, col])
    return 0


def cmd_datagen(args) -> int:
    """Generate a synthetic scenario and ingest it (reference:
    idk/datagen/datagen.go main driver). In-process without --host
    (smoke tests); with --host, schema + batched imports drive a remote
    server through the client library."""
    from pilosa_tpu_torch.ingest.datagen import scenario
    from pilosa_tpu_torch.core.schema import FieldType

    src = scenario(args.scenario, rows=args.rows, seed=args.seed)
    if not args.host:
        from pilosa_tpu_torch.api import API
        from pilosa_tpu_torch.ingest.ingest import Ingester

        n = Ingester(API(device=_device(args)), args.index, src).run()
        print(f"datagen: ingested {n} {args.scenario!r} records "
              f"in-process", file=sys.stderr)
        return 0
    from pilosa_tpu_torch.client import Client

    c = Client(args.host)
    c.create_index(args.index)
    opts_by_field = {}
    for fname, fo in src.schema():
        d = {"type": fo.type.value, "keys": fo.keys}
        if fo.min is not None:
            d["min"] = fo.min
        if fo.max is not None:
            d["max"] = fo.max
        if fo.scale:
            d["scale"] = fo.scale
        c._json("POST", f"/index/{args.index}/field/{fname}",
                {"options": d})
        opts_by_field[fname] = fo
    n = 0
    batch_bits = {}
    batch_vals = {}

    def flush():
        for fname, pairs in batch_bits.items():
            fo = opts_by_field[fname]
            if fo.keys:
                c._json("POST", f"/index/{args.index}/import",
                        {"field": fname,
                         "rowKeys": [str(r) for r, _ in pairs],
                         "cols": [col for _, col in pairs]})
            else:
                c.import_bits(args.index, fname, pairs)
        for fname, pairs in batch_vals.items():
            c.import_values(args.index, fname, pairs)
        batch_bits.clear()
        batch_vals.clear()

    for rec in src.records():
        col = int(rec[src.id_column()])
        for fname, v in rec.items():
            if fname == src.id_column() or v is None:
                continue
            fo = opts_by_field[fname]
            if fo.type.is_bsi:
                sv = int(round(v * 10 ** fo.scale)) \
                    if fo.type == FieldType.DECIMAL else int(v)
                batch_vals.setdefault(fname, []).append((col, sv))
            elif fo.type == FieldType.BOOL:
                batch_bits.setdefault(fname, []).append(
                    (1 if v else 0, col))
            else:
                for item in (v if isinstance(v, list) else [v]):
                    batch_bits.setdefault(fname, []).append((item, col))
        n += 1
        if n % 10_000 == 0:
            flush()
    flush()
    print(f"datagen: ingested {n} {args.scenario!r} records into "
          f"{args.index!r} at {args.host}", file=sys.stderr)
    return 0


def cmd_fbsql(args) -> int:
    from pilosa_tpu_torch.ctl.fbsql import Shell

    return Shell(host=args.host).run()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="pilosa-tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("server", help="run a server node")
    s.add_argument("--config", help="TOML config file")
    s.add_argument("--bind", default=None)
    s.add_argument("--port", type=int, default=None)
    s.add_argument("--data-dir", dest="data_dir", default=None)
    s.add_argument("--wal-sync", dest="wal_sync", default=None,
                   choices=("always", "batch", "never"))
    s.add_argument("--device", default=None,
                   help="torch device to serve from (default: cuda:0)")
    s.set_defaults(fn=cmd_server)

    g = sub.add_parser("generate-config", help="print default TOML config")
    g.set_defaults(fn=cmd_generate_config)

    for name, fn, extra in (
        ("backup", cmd_backup, [("--output", dict(required=True))]),
        ("restore", cmd_restore, [("--source", dict(required=True))]),
        ("chksum", cmd_chksum, []),
    ):
        c = sub.add_parser(name)
        c.add_argument("--host", default="http://127.0.0.1:10101")
        for flag, kw in extra:
            c.add_argument(flag, **kw)
        c.set_defaults(fn=fn)

    i = sub.add_parser("import", help="CSV import")
    i.add_argument("--host", default="http://127.0.0.1:10101")
    i.add_argument("--index", required=True)
    i.add_argument("--field", required=True)
    i.add_argument("--field-type", dest="field_type", default="set",
                   choices=("set", "int"))
    i.add_argument("--keys", action="store_true")
    i.add_argument("file")
    i.set_defaults(fn=cmd_import)

    e = sub.add_parser("export", help="CSV export of a set field")
    e.add_argument("--host", default="http://127.0.0.1:10101")
    e.add_argument("--index", required=True)
    e.add_argument("--field", required=True)
    e.set_defaults(fn=cmd_export)

    f = sub.add_parser("fbsql", help="interactive SQL shell")
    f.add_argument("--host", default="http://127.0.0.1:10101")
    f.set_defaults(fn=cmd_fbsql)

    d = sub.add_parser("datagen",
                       help="generate + ingest a synthetic scenario")
    d.add_argument("--scenario", required=True)
    d.add_argument("--rows", type=int, default=1000)
    d.add_argument("--seed", type=int, default=1)
    d.add_argument("--index", required=True)
    d.add_argument("--host", default=None,
                   help="target server; omit for an in-process run "
                        "(smoke tests)")
    d.add_argument("--device", default=None,
                   help="torch device of an in-process run (default: "
                        "cuda:0)")
    d.set_defaults(fn=cmd_datagen)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)
