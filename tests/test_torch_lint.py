"""The project-invariant linter (analysis/lint.py) of both packages.

The 26 cases of ``tests/test_analysis.py`` run once per package through
a ``P`` fixture, each fixture on the package's own paths
(``pilosa_tpu/...`` or ``pilosa_tpu_torch/...``) and, for the device
rule, in its own device idiom (``jnp.*`` / ``jax.device_put`` or
``torch.*`` / ``.to(device)``); the CLI is ``scripts/lint_invariants.py``
for the JAX package and ``python -m pilosa_tpu_torch.analysis.lint`` for
the port. Then the port's own cases: every form of its device rule, the
scopes not crossing packages, its baseline against the JAX one, the
repaired sites (the dataframe store's uploads, devprof's slots lock) and
a CLI that loads no ``torch``.
"""

import importlib
import json
import os
import subprocess
import sys
import textwrap
import types

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_JAX_DEVICE = types.SimpleNamespace(
    bad="""
        import jax
        import jax.numpy as jnp
        def f(x):
            y = jnp.sum(x)
            return jax.device_put(y)
    """,
    kernel="""
        import jax.numpy as jnp
        def kernel(x):
            return jnp.bitwise_and(x, x)
    """,
    seed="import jax.numpy as jnp\ndef f(x):\n    return jnp.sum(x)\n",
)
_TORCH_DEVICE = types.SimpleNamespace(
    bad="""
        import torch
        def f(x, dev):
            y = torch.sum(x)
            return y.to(dev)
    """,
    kernel="""
        import torch
        def kernel(x):
            return torch.bitwise_and(x, x)
    """,
    seed="import torch\ndef f(x):\n    return torch.sum(x)\n",
)


def _load(root: str) -> types.SimpleNamespace:
    jax_pkg = root == "pilosa_tpu"
    return types.SimpleNamespace(
        root=root,
        lint=importlib.import_module(f"{root}.analysis.lint"),
        cli=([sys.executable, os.path.join(REPO, "scripts",
                                           "lint_invariants.py")]
             if jax_pkg else
             [sys.executable, "-m", "pilosa_tpu_torch.analysis.lint"]),
        baseline=os.path.join(root, "analysis", "baseline.json"),
        device=_JAX_DEVICE if jax_pkg else _TORCH_DEVICE,
    )


_PACKAGES = {}


def _pkg(root):
    if root not in _PACKAGES:
        _PACKAGES[root] = _load(root)
    return _PACKAGES[root]


@pytest.fixture(params=["pilosa_tpu", "pilosa_tpu_torch"],
                ids=["jax", "torch"])
def P(request):
    return _pkg(request.param)


def _check(P, path, src):
    return P.lint.default_engine().check_source(f"{P.root}/{path}",
                                               textwrap.dedent(src))


def _rules(P, path, src):
    return [v.rule for v in _check(P, path, src)]


# -- no-raw-time ------------------------------------------------------------


def test_raw_time_flagged_in_clock_module(P):
    vs = _check(P, "sched/thing.py", """
        import time
        def age(t0):
            return time.monotonic() - t0
    """)
    assert [v.rule for v in vs] == ["no-raw-time"]
    assert "time.monotonic()" in vs[0].match


def test_raw_time_clean_cases(P):
    assert _rules(P, "obs/thing.py", """
        def age(clock, t0):
            return clock.now() - t0
    """) == []
    assert _rules(P, "obs/thing.py", """
        import time
        class WallClock:
            def now(self):
                return time.monotonic()
    """) == []
    assert _rules(P, "core/thing.py", """
        import time
        def stamp():
            return time.time()
    """) == []


# -- no-bare-lock -----------------------------------------------------------


def test_bare_lock_flagged_in_migrated_package(P):
    src = """
        import threading
        class C:
            def __init__(self):
                self._lock = threading.RLock()
    """
    assert _rules(P, "storage/thing.py", src) == ["no-bare-lock"]


def test_tracked_lock_and_unmigrated_package_clean(P):
    assert _rules(P, "cluster/thing.py", f"""
        from {P.root}.analysis import locktrace
        LOCK = locktrace.tracked_lock("cluster.thing")
    """) == []
    assert _rules(P, "core/thing.py", """
        import threading
        LOCK = threading.Lock()
    """) == []


# -- no-callback-under-lock -------------------------------------------------


def test_listener_loop_under_lock_flagged(P):
    vs = _check(P, "cluster/thing.py", """
        class C:
            def fire(self):
                with self._lock:
                    for listener in self._listeners:
                        listener(1, 2)
    """)
    assert [v.rule for v in vs] == ["no-callback-under-lock"]


def test_collect_then_fire_outside_lock_clean(P):
    assert _rules(P, "cluster/thing.py", """
        class C:
            def fire(self):
                with self._lock:
                    pending = list(self._listeners)
                for fn in pending:
                    fn(1, 2)
    """) == []


def test_cv_notify_under_lock_is_not_flagged(P):
    assert _rules(P, "cluster/thing.py", """
        class C:
            def wake(self):
                with self._lock:
                    self._cv.notify_all()
    """) == []


def test_on_hook_call_under_lock_flagged(P):
    vs = _check(P, "obs/thing.py", """
        class C:
            def bump(self):
                with self.state_lock:
                    self.on_transition("a", "b")
    """)
    assert [v.rule for v in vs] == ["no-callback-under-lock"]


# -- no-device-call-outside-platform ----------------------------------------


def test_device_call_outside_device_layer_flagged(P):
    vs = _check(P, "stream/thing.py", P.device.bad)
    assert sorted(v.rule for v in vs) == [
        "no-device-call-outside-platform"] * 2


def test_device_layer_and_platform_helpers_clean(P):
    assert _rules(P, "ops/thing.py", P.device.kernel) == []
    assert _rules(P, "stream/thing.py", f"""
        from {P.root} import platform
        def stage(host):
            return platform.h2d_copy(host)
    """) == []


# -- contextvar-set-reset ---------------------------------------------------


def test_discarded_contextvar_token_flagged(P):
    vs = _check(P, "obs/thing.py", """
        import contextvars
        CV = contextvars.ContextVar("cv")
        def enter(v):
            CV.set(v)
    """)
    assert [v.rule for v in vs] == ["contextvar-set-reset"]


def test_kept_token_never_reset_flagged(P):
    vs = _check(P, "obs/thing.py", """
        import contextvars
        CV = contextvars.ContextVar("cv")
        def enter(v):
            token = CV.set(v)
            return 7
    """)
    assert [v.rule for v in vs] == ["contextvar-set-reset"]


def test_paired_or_escaping_token_clean(P):
    assert _rules(P, "obs/thing.py", """
        import contextvars
        CV = contextvars.ContextVar("cv")
        def scoped(v):
            token = CV.set(v)
            try:
                pass
            finally:
                CV.reset(token)
    """) == []
    assert _rules(P, "obs/thing.py", """
        import contextvars
        CV = contextvars.ContextVar("cv")
        def enter(v):
            token = CV.set(v)
            return token
    """) == []


# -- metrics-label-hygiene --------------------------------------------------


def test_computed_label_value_flagged(P):
    vs = _check(P, "server/thing.py", """
        def rec(registry, shard):
            registry.count("reads_total", shard=f"shard-{shard}")
    """)
    assert [v.rule for v in vs] == ["metrics-label-hygiene"]
    vs = _check(P, "server/thing.py", """
        def rec(registry, node):
            registry.gauge("state", 1.0, node=str(node))
    """)
    assert [v.rule for v in vs] == ["metrics-label-hygiene"]


def test_bounded_label_value_clean(P):
    assert _rules(P, "server/thing.py", """
        def rec(registry, outcome, n):
            registry.count("reads_total", n, outcome=outcome)
            registry.observe("latency_seconds", 0.5, op="query")
    """) == []


# -- engine + baseline ------------------------------------------------------


def test_parse_error_is_reported_not_raised(P):
    vs = _check(P, "obs/broken.py", "def f(:\n")
    assert [v.rule for v in vs] == ["parse-error"]


def test_violation_key_survives_line_churn(P):
    src = """
        import time
        def age(t0):
            return time.monotonic() - t0
    """
    v1 = _check(P, "sched/thing.py", src)[0]
    v2 = _check(P, "sched/thing.py", "# a new header comment\n"
                + textwrap.dedent(src))[0]
    assert v1.line != v2.line
    assert v1.key() == v2.key()


def test_baseline_round_trip(P, tmp_path):
    lint = P.lint
    vs = _check(P, "sched/thing.py", """
        import time
        def age(t0):
            return time.monotonic() - t0
    """)
    entries = lint.baseline_entries_for(vs, reason="known real-time spin")
    path = str(tmp_path / "baseline.json")
    lint.save_baseline(path, entries)
    loaded = lint.load_baseline(path)
    assert loaded == sorted(entries, key=lambda e: (e["rule"], e["path"],
                                                    e["match"]))
    new, suppressed, stale = lint.apply_baseline(vs, loaded)
    assert new == [] and len(suppressed) == len(vs) and stale == []
    extra = loaded + [{"rule": "no-raw-time", "path": "gone.py",
                       "match": "time.time()", "reason": "fixed"}]
    new, _, stale = lint.apply_baseline(vs, extra)
    assert new == [] and len(stale) == 1
    other = _check(P, "cache/thing.py",
                   "import threading\nL = threading.Lock()\n")
    new, _, _ = lint.apply_baseline(other, loaded)
    assert [v.rule for v in new] == ["no-bare-lock"]


def test_baseline_entry_requires_reason(P, tmp_path):
    p = tmp_path / "bad.json"
    p.write_text(json.dumps({"entries": [
        {"rule": "no-raw-time", "path": "x.py", "match": "time.time()"}
    ]}))
    with pytest.raises(ValueError, match="reason"):
        P.lint.load_baseline(str(p))


def test_check_tree_walks_and_reports_relative_paths(P, tmp_path):
    pkg = tmp_path / P.root / "sched"
    pkg.mkdir(parents=True)
    (pkg / "bad.py").write_text("import time\nT = time.time()\n")
    (pkg / "good.py").write_text("def f(clock):\n    return clock.now()\n")
    vs = P.lint.default_engine().check_tree(str(tmp_path),
                                           rel_to=str(tmp_path))
    assert [(v.rule, v.path) for v in vs] == [
        ("no-raw-time", f"{P.root}/sched/bad.py")]


# -- CLI --------------------------------------------------------------------


def _run_cli(P, *args):
    return subprocess.run([*P.cli, *args], cwd=REPO, capture_output=True,
                          text=True, timeout=120)


def test_cli_selftest_passes(P):
    r = _run_cli(P, "--selftest")
    assert r.returncode == 0, r.stderr
    assert "selftest OK" in r.stdout


def test_cli_exits_nonzero_on_seeded_violation_each_category(P, tmp_path):
    seeds = {
        "sched/a.py": "import time\nT = time.time()\n",
        "cache/b.py": "import threading\nL = threading.Lock()\n",
        "cluster/c.py": (
            "def f(self):\n    with self._lock:\n"
            "        for listener in self._listeners:\n"
            "            listener()\n"),
        "stream/d.py": P.device.seed,
        "obs/e.py": (
            "import contextvars\nCV = contextvars.ContextVar('cv')\n"
            "def f(v):\n    CV.set(v)\n"),
        "server/f.py": (
            "def f(registry, s):\n"
            "    registry.count('x_total', shard=f's{s}')\n"),
    }
    expect = ["no-raw-time", "no-bare-lock", "no-callback-under-lock",
              "no-device-call-outside-platform", "contextvar-set-reset",
              "metrics-label-hygiene"]
    for (rel, src), rule in zip(seeds.items(), expect):
        p = tmp_path / P.root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(src)
        r = _run_cli(P, str(p), "--baseline", "-")
        assert r.returncode == 1, (rel, r.stdout, r.stderr)
        assert rule in r.stdout, (rule, r.stdout)


def test_cli_zero_on_shipped_tree_with_baseline(P):
    r = _run_cli(P, P.root, "--baseline", P.baseline)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "0 new" in r.stdout and "0 stale" in r.stdout


def test_cli_json_output(P, tmp_path):
    p = tmp_path / P.root / "sched" / "a.py"
    p.parent.mkdir(parents=True)
    p.write_text("import time\nT = time.time()\n")
    r = _run_cli(P, str(p), "--baseline", "-", "--json")
    assert r.returncode == 1
    doc = json.loads(r.stdout)
    assert [v["rule"] for v in doc["new"]] == ["no-raw-time"]
    assert doc["suppressed"] == [] and doc["stale_baseline_entries"] == []


def test_cli_write_baseline_then_green(P, tmp_path):
    p = tmp_path / P.root / "sched" / "a.py"
    p.parent.mkdir(parents=True)
    p.write_text("import time\nT = time.time()\n")
    bl = str(tmp_path / "baseline.json")
    r = _run_cli(P, str(p), "--baseline", bl, "--write-baseline")
    assert r.returncode == 0, r.stderr
    r = _run_cli(P, str(p), "--baseline", bl)
    assert r.returncode == 0, r.stdout
    assert "1 baselined" in r.stdout


def test_cli_list_rules(P):
    r = _run_cli(P, "--list-rules")
    assert r.returncode == 0
    for rule in ("no-raw-time", "no-bare-lock", "no-callback-under-lock",
                 "no-device-call-outside-platform", "contextvar-set-reset",
                 "metrics-label-hygiene"):
        assert rule in r.stdout


# -- the port's own cases -----------------------------------------------------


_TORCH_FORMS = [
    ("x.to(dev)", "def f(x, dev):\n    return x.to(dev)\n"),
    ("x.to('cuda')",
     "def f(x):\n    return x.to('cuda', non_blocking=True)\n"),
    ("x.to(device=)", "def f(x, d):\n    return x.to(device=d)\n"),
    ("x.to(dtype var)", "def f(x, dt):\n    return x.to(dt)\n"),
    ("x.cuda()", "def f(x):\n    return x.cuda()\n"),
    ("torch.zeros(device=)",
     "import torch\ndef f(d):\n    return torch.zeros(3, device=d)\n"),
    ("torch.cuda.synchronize()",
     "import torch\ndef f():\n    torch.cuda.synchronize()\n"),
    ("event.synchronize()", "def f(ev):\n    ev.synchronize()\n"),
    ("torch.sum", "import torch\ndef f(x):\n    return torch.sum(x)\n"),
    ("torch.full (host)",
     "import torch\ndef f():\n    return torch.full((2,), 1)\n"),
]


@pytest.mark.parametrize("form, src", _TORCH_FORMS,
                         ids=[f for f, _ in _TORCH_FORMS])
def test_port_device_rule_flags_each_form(form, src):
    P = _pkg("pilosa_tpu_torch")
    assert _rules(P, "server/thing.py", src) == [
        "no-device-call-outside-platform"], form
    assert _rules(P, "ops/thing.py", src) == []  # the device layer


def test_port_device_rule_exempts_non_computing_calls():
    P = _pkg("pilosa_tpu_torch")
    assert _rules(P, "api.py", """
        import torch
        def info(x):
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            names = [torch.cuda.get_device_name(i) for i in range(n)]
            return torch.device("cpu"), names, x.to(torch.int64), \\
                x.to(dtype=torch.float32), torch.from_numpy(x)
    """) == []


def test_scopes_do_not_cross_packages():
    """A JAX scope never matches a port path, nor the reverse."""
    src = ("import time\nimport threading\nT = time.time()\n"
           "L = threading.Lock()\n")
    for linter, other in (("pilosa_tpu", "pilosa_tpu_torch"),
                          ("pilosa_tpu_torch", "pilosa_tpu")):
        eng = _pkg(linter).lint.default_engine()
        assert [v.rule for v in eng.check_source(
            f"{other}/sched/thing.py", src)] == []
        assert sorted(v.rule for v in eng.check_source(
            f"{linter}/sched/thing.py", src)) == ["no-bare-lock",
                                                   "no-raw-time"]


def test_port_baseline_carries_the_jax_entries():
    """Each JAX baseline entry has its port counterpart, path renamed,
    and the port's baseline holds nothing else."""
    J, T = _pkg("pilosa_tpu").lint, _pkg("pilosa_tpu_torch").lint
    jax_entries = J.load_baseline(os.path.join(REPO, "pilosa_tpu",
                                               "analysis", "baseline.json"))
    port = T.load_baseline(os.path.join(REPO, "pilosa_tpu_torch",
                                        "analysis", "baseline.json"))
    renamed = sorted((e["rule"], e["path"].replace(
        "pilosa_tpu/", "pilosa_tpu_torch/", 1), e["match"])
        for e in jax_entries)
    assert sorted((e["rule"], e["path"], e["match"]) for e in port) == \
        renamed
    assert all(len(e["reason"]) > 40 for e in port)


def test_port_tree_without_baseline_flags_only_the_baselined_sites():
    T = _pkg("pilosa_tpu_torch").lint
    vs = T.default_engine().check_tree(os.path.join(REPO, "pilosa_tpu_torch"),
                                       rel_to=REPO)
    entries = T.load_baseline(os.path.join(REPO, "pilosa_tpu_torch",
                                           "analysis", "baseline.json"))
    new, suppressed, stale = T.apply_baseline(vs, entries)
    assert (new, stale) == ([], [])
    paths = {v.path for v in vs}
    # the repaired sites: the store's uploads go through platform, and
    # devprof's slots lock is tracked
    assert "pilosa_tpu_torch/dataframe/store.py" not in paths
    assert "pilosa_tpu_torch/obs/devprof.py" not in paths
    with open(os.path.join(REPO, "pilosa_tpu_torch", "obs",
                           "devprof.py")) as f:
        assert 'tracked_lock("obs.devprof.slots")' in f.read()


def test_port_linter_loads_no_torch():
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys, pilosa_tpu_torch.analysis.lint as L; "
         "print(L.selftest() == 0, 'torch' in sys.modules)"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split()[-2:] == ["True", "False"]
