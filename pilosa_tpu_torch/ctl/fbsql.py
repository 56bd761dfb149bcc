"""fbsql: the interactive SQL shell (port of ``pilosa_tpu/ctl/fbsql.py``).

Reference: cli/cli.go (readline REPL) + cli/meta.go (backslash meta
commands). Talks to a server's POST /sql; meta commands: ``\\q`` quit,
``\\dt`` list tables, ``\\d <table>`` describe, ``\\timing`` toggle,
``\\!pql <index> <query>`` raw PQL escape hatch.
"""

from __future__ import annotations

import json
import sys
import urllib.request
from typing import IO, Optional


class Shell:
    def __init__(self, host: str = "http://127.0.0.1:10101",
                 stdin: Optional[IO] = None, stdout: Optional[IO] = None):
        self.host = host.rstrip("/")
        self.stdin = stdin or sys.stdin
        self.stdout = stdout or sys.stdout
        self.timing = False

    def _post(self, path: str, body: str) -> dict:
        req = urllib.request.Request(self.host + path, data=body.encode(),
                                     method="POST")
        with urllib.request.urlopen(req) as resp:
            return json.loads(resp.read())

    def _print(self, *parts) -> None:
        print(*parts, file=self.stdout)

    def _print_result(self, res: dict) -> None:
        schema = res.get("schema", {}).get("fields", [])
        names = [c["name"] for c in schema]
        rows = res.get("data", [])
        widths = [max(len(str(n)), *(len(str(r[i])) for r in rows), 1)
                  if rows else len(str(n)) for i, n in enumerate(names)]
        if names:
            self._print(" | ".join(str(n).ljust(w)
                                   for n, w in zip(names, widths)))
            self._print("-+-".join("-" * w for w in widths))
        for r in rows:
            self._print(" | ".join(str(v).ljust(w)
                                   for v, w in zip(r, widths)))
        self._print(f"({len(rows)} row{'s' if len(rows) != 1 else ''})")
        if self.timing:
            self._print(f"Time: {res.get('execution-time', 0) / 1000:.3f} ms")

    def _meta(self, line: str) -> bool:
        """Handle a backslash meta command; returns False on \\q."""
        cmd, _, rest = line.partition(" ")
        if cmd in ("\\q", "\\quit"):
            return False
        if cmd == "\\timing":
            self.timing = not self.timing
            self._print(f"Timing is {'on' if self.timing else 'off'}.")
        elif cmd == "\\dt":
            self._print_result(self._post("/sql", "show tables"))
        elif cmd == "\\d" and rest:
            self._print_result(self._post("/sql", f"show columns from {rest}"))
        elif cmd == "\\!pql" and rest:
            index, _, q = rest.partition(" ")
            out = self._post(f"/index/{index}/query", q)
            self._print(json.dumps(out["results"]))
        else:
            self._print(f"unknown meta command {cmd!r}")
        return True

    def run(self) -> int:
        interactive = self.stdin is sys.stdin and sys.stdin.isatty()
        if interactive:
            try:
                import readline  # noqa: F401 — line editing side effect
            except ImportError:
                pass
            self._print("fbsql for pilosa-tpu. Type \\q to quit.")
        buf = ""
        while True:
            if interactive:
                try:
                    line = input("fbsql> " if not buf else "  ...> ")
                except EOFError:
                    break
            else:
                line = self.stdin.readline()
                if not line:
                    break
                line = line.rstrip("\n")
            if not buf and line.strip().startswith("\\"):
                if not self._meta(line.strip()):
                    break
                continue
            buf += (" " if buf else "") + line
            if not buf.strip():
                buf = ""
                continue
            if buf.rstrip().endswith(";") or not interactive:
                stmt = buf.rstrip().rstrip(";")
                buf = ""
                if not stmt:
                    continue
                try:
                    self._print_result(self._post("/sql", stmt))
                except Exception as e:  # show errors, keep the shell alive
                    self._print(f"error: {e}")
        return 0
