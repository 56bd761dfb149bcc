"""The port stands alone: it never imports JAX or the JAX package.

Checked two ways: a subprocess with a clean environment imports
``pilosa_tpu_torch`` and answers a query on the CPU, then reports what
``sys.modules`` holds (this test process cannot tell: tests/conftest.py
loads JAX in every worker); and an AST scan of every module of the port
and of ``chip_smoke.py``. The port also refuses to fall back to the CPU
by itself.
"""

import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_FORBIDDEN = ("jax", "pilosa_tpu")

_PROBE = r"""
import json, sys
import numpy as np
import pilosa_tpu_torch
from pilosa_tpu_torch.api import API

api = API(device="cpu")
api.create_index("i")
api.create_field("i", "f", {"type": "mutex", "keys": True})
api.import_bits("i", "f", cols=np.arange(600), row_keys=["a", "b"] * 300)
got = api.query("i", 'Count(Intersect(Row(f="a"), All()))TopN(f, n=1)')
print(json.dumps({"count": got[0], "top": got[1].pairs[0].count,
                  "modules": sorted(sys.modules)}))
"""


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in _FORBIDDEN)


def test_import_and_query_load_neither_jax_nor_the_jax_package():
    env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "PYTHONPATH": ROOT, "HOME": os.environ.get("HOME", ROOT)}
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    import json

    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["count"] == 300 and out["top"] == 300
    bad = [m for m in out["modules"] if _forbidden(m)]
    assert not bad, f"port loaded {bad}"


def _sources():
    for dirpath, _, files in os.walk(os.path.join(ROOT, "pilosa_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_module_imports_jax_or_the_jax_package(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    assert not [n for n in names if _forbidden(n)]


def test_api_without_a_device_needs_a_card(monkeypatch):
    from pilosa_tpu_torch.api import API

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        API()
    with pytest.raises(RuntimeError):
        API(device="cuda")
    assert API(device="cpu").device.type == "cpu"


def test_chip_smoke_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    r = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
