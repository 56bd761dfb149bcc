"""AST-based project-invariant linter with a pluggable rule engine.

Port of ``pilosa_tpu/analysis/lint.py`` and of its CLI,
``scripts/lint_invariants.py``, checking the port's own tree: every
scope names ``pilosa_tpu_torch/...`` (the JAX package's
``pilosa_tpu/...`` scopes never match the port's paths). The codebase
states its concurrency and hygiene invariants in prose — "fired outside
the lock", "injectable clock", "labels must be bounded", "every staging
path routes through platform" — and these rules check them:

- ``no-raw-time``          no ``time.time()``/``time.monotonic()`` in
                           modules that take injectable clocks (sched/,
                           obs/, gossip/, stream/, dax/,
                           transaction.py); ``*Clock`` classes — the
                           injectable defaults themselves — are exempt.
- ``no-bare-lock``         no bare ``threading.Lock()``/``RLock()`` in
                           packages migrated to
                           ``analysis.locktrace.tracked_lock``.
- ``no-callback-under-lock``  no listener/callback/hook invocation
                           lexically inside a ``with <...lock...>:``
                           body (the breaker-listener deadlock shape).
- ``no-device-call-outside-platform``  no ``torch.*`` compute call,
                           ``.to(<device>)``, ``.cuda()`` or
                           ``.synchronize()`` outside the device layer,
                           which routes copies through
                           ``platform.h2d_copy`` and launches through
                           ``kernel_util.on_card`` (the forms flagged are
                           listed on :class:`DeviceCallRule`).
- ``contextvar-set-reset`` every ContextVar ``set()`` keeps its token
                           and pairs it with ``reset``/returns it.
- ``metrics-label-hygiene``  metric label values must be bounded
                           (names/constants), never computed strings.

Rules run against a checked-in baseline (``analysis/baseline.json``):
pre-existing violations are suppressed **with a reason** and ratcheted
down (a stale entry is reported so it gets deleted); anything new fails
the run. The CLI::

    python -m pilosa_tpu_torch.analysis.lint [root] [--baseline F]
        [--json] [--write-baseline] [--list-rules] [--selftest]

lints ``pilosa_tpu_torch`` against
``pilosa_tpu_torch/analysis/baseline.json`` by default, run from the
repo's root, and exits 1 on a new violation. ``--selftest`` seeds one
positive and one negative fixture per rule (one per flagged form of the
device rule) plus a baseline round-trip. The module imports no
``torch``.

Lexical honesty: these are AST checks, not whole-program analysis. A
callback invoked by a helper whose *callers* hold the lock is invisible
here — that is what the dynamic half (locktrace) exists for.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import os
import re
import sys
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Violation", "Rule", "RuleEngine", "default_engine", "load_baseline",
    "save_baseline", "apply_baseline", "baseline_entries_for", "ALL_RULES",
    "selftest", "main",
]


@dataclasses.dataclass
class Violation:
    rule: str
    path: str
    line: int
    match: str       # normalized source snippet — stable under line churn
    message: str

    def key(self) -> Tuple[str, str, str]:
        """Baseline identity: line numbers churn with every edit above a
        site, so entries match on (rule, path, snippet) instead."""
        return (self.rule, self.path, self.match)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def _norm_path(path: str) -> str:
    return path.replace(os.sep, "/")


def _snippet(source: str, node: ast.AST) -> str:
    seg = ast.get_source_segment(source, node)
    if seg is None:
        seg = getattr(node, "name", "") or ast.dump(node)[:80]
    return " ".join(seg.split())[:160]


def _dotted(node: ast.AST) -> str:
    """Best-effort dotted-name text of an expression ('self._lock',
    'threading.Lock', ...); '' for anything non-name-like."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base else node.attr
    if isinstance(node, ast.Call):
        return _dotted(node.func)
    return ""


def _terminal(node: ast.AST) -> str:
    """Last path component of a call target ('fn', 'Lock', 'set')."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


class Rule:
    """One invariant. Subclasses set ``name``/``description`` and
    implement :meth:`check`. ``scopes``/``exempt`` are path substrings
    (matched against the /-normalized path), so the same rule works on
    repo-relative paths and on test fixture trees."""

    name = ""
    description = ""
    scopes: Sequence[str] = ()   # empty = every file
    exempt: Sequence[str] = ()

    def in_scope(self, path: str) -> bool:
        p = _norm_path(path)
        if any(e in p for e in self.exempt):
            return False
        return not self.scopes or any(s in p for s in self.scopes)

    def check(self, path: str, tree: ast.AST,
              source: str) -> Iterable[Violation]:
        raise NotImplementedError

    def _v(self, path: str, source: str, node: ast.AST,
           message: str) -> Violation:
        return Violation(rule=self.name, path=_norm_path(path),
                         line=getattr(node, "lineno", 0),
                         match=_snippet(source, node), message=message)


# ---------------------------------------------------------------------------
# no-raw-time
# ---------------------------------------------------------------------------


class NoRawTimeRule(Rule):
    name = "no-raw-time"
    description = ("time.time()/time.monotonic() in a module that takes "
                   "injectable clocks (thread a clock= parameter through "
                   "instead; *Clock classes are the injectable defaults "
                   "and are exempt)")
    scopes = ("pilosa_tpu_torch/sched/", "pilosa_tpu_torch/obs/",
              "pilosa_tpu_torch/gossip/", "pilosa_tpu_torch/stream/",
              "pilosa_tpu_torch/dax/", "pilosa_tpu_torch/transaction.py")

    def check(self, path, tree, source):
        out: List[Violation] = []

        def visit(node: ast.AST, in_clock_class: bool) -> None:
            if isinstance(node, ast.ClassDef):
                in_clock_class = (in_clock_class
                                  or node.name.endswith("Clock"))
            if isinstance(node, ast.Call) and not in_clock_class:
                f = node.func
                if (isinstance(f, ast.Attribute)
                        and isinstance(f.value, ast.Name)
                        and f.value.id == "time"
                        and f.attr in ("time", "monotonic")):
                    out.append(self._v(
                        path, source, node,
                        f"raw time.{f.attr}() in an injectable-clock "
                        f"module — take clock= and call clock.now()"))
            for child in ast.iter_child_nodes(node):
                visit(child, in_clock_class)

        visit(tree, False)
        return out


# ---------------------------------------------------------------------------
# no-bare-lock
# ---------------------------------------------------------------------------


class NoBareLockRule(Rule):
    name = "no-bare-lock"
    description = ("bare threading.Lock()/RLock() in a package migrated "
                   "to analysis.locktrace.tracked_lock(name)")
    scopes = ("pilosa_tpu_torch/sched/", "pilosa_tpu_torch/cache/",
              "pilosa_tpu_torch/cluster/", "pilosa_tpu_torch/storage/",
              "pilosa_tpu_torch/obs/", "pilosa_tpu_torch/dax/",
              "pilosa_tpu_torch/platform.py", "pilosa_tpu_torch/analysis/")
    # the wrapper implementation hands out and uses bare locks by design
    exempt = ("analysis/locktrace.py",)

    def check(self, path, tree, source):
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "threading"
                    and node.func.attr in ("Lock", "RLock")):
                yield self._v(
                    path, source, node,
                    f"bare threading.{node.func.attr}() in a tracked-lock "
                    f"package — use locktrace.tracked_lock(name)")


# ---------------------------------------------------------------------------
# no-callback-under-lock
# ---------------------------------------------------------------------------

# NOTE: no "notify" — Condition.notify/notify_all MUST be called while
# holding the lock; flagging them would teach people to ignore the rule.
_CALLBACK_RE = re.compile(
    r"(listener|callback|hook|provider|fire|on_[a-z0-9_]+)",
    re.IGNORECASE)
_LISTENERISH_RE = re.compile(r"(listener|callback|hook)", re.IGNORECASE)


class CallbackUnderLockRule(Rule):
    name = "no-callback-under-lock"
    description = ("listener/callback/hook invoked lexically inside a "
                   "'with <lock>:' body (registered-listener pattern: "
                   "collect under the lock, fire after release — the "
                   "health-plane deadlock shape)")

    def check(self, path, tree, source):
        out: List[Violation] = []

        def lockish(items) -> bool:
            return any("lock" in _dotted(i.context_expr).lower()
                       for i in items)

        def scan(node: ast.AST, loop_vars: Dict[str, bool]) -> None:
            # loop_vars: name -> bound from a *listeners-ish iterable
            if isinstance(node, ast.For):
                lv = dict(loop_vars)
                if isinstance(node.target, ast.Name):
                    it = _snippet(source, node.iter)
                    lv[node.target.id] = bool(_LISTENERISH_RE.search(it))
                for child in ast.iter_child_nodes(node):
                    scan(child, lv)
                return
            if isinstance(node, ast.Call):
                term = _terminal(node.func)
                bare_listener = (isinstance(node.func, ast.Name)
                                 and loop_vars.get(node.func.id, False))
                if bare_listener or (term and _CALLBACK_RE.search(term)):
                    out.append(self._v(
                        path, source, node,
                        f"callback {_dotted(node.func) or term!r} invoked "
                        f"under a lock — fire it after release"))
            for child in ast.iter_child_nodes(node):
                scan(child, loop_vars)

        def visit(node: ast.AST) -> None:
            if isinstance(node, ast.With) and lockish(node.items):
                for stmt in node.body:
                    scan(stmt, {})
                return  # scan() covered nested withs' bodies already
            for child in ast.iter_child_nodes(node):
                visit(child)

        visit(tree)
        return out


# ---------------------------------------------------------------------------
# no-device-call-outside-platform
# ---------------------------------------------------------------------------


#: ``torch.*`` calls that compute nothing and touch no device memory
_NON_COMPUTING = frozenset((
    "torch.device", "torch.dtype", "torch.is_tensor", "torch.from_numpy",
    "torch.get_num_threads", "torch.set_num_threads",
    "torch.get_default_dtype", "torch.no_grad", "torch.inference_mode",
    "torch.cuda.is_available", "torch.cuda.device_count",
    "torch.cuda.get_device_name", "torch.cuda.current_device",
    "torch.cuda.is_initialized", "torch.cuda.get_device_properties",
    "torch.cuda.get_device_capability",
))


def _is_torch_dtype(node: ast.AST) -> bool:
    """``torch.<name>`` other than ``torch.device``: a dtype such as
    ``torch.int64`` (the only attribute of ``torch`` a ``.to`` takes
    that is not a device)."""
    return (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "torch" and node.attr != "device")


class DeviceCallRule(Rule):
    """Device calls belong to the device layer. Outside it, flags:

    - ``x.to(...)``, unless its one argument is a dtype spelled
      ``torch.<dtype>`` (positionally or as ``dtype=``). An AST cannot
      tell ``x.to(dtype)`` from ``x.to(device)``, so ``.to(dev)``,
      ``.to("cuda")``, ``.to(t.device)``, ``.to(device=...)``,
      ``.to(other_tensor)`` and ``.to(some_dtype_variable)`` are all
      flagged;
    - ``x.cuda(...)``;
    - ``torch.cuda.synchronize()`` and any ``x.synchronize()``;
    - every ``torch.*(...)`` call (a ``device=`` keyword is named in the
      message), except those in ``_NON_COMPUTING``, which compute
      nothing and touch no device memory.
    """

    name = "no-device-call-outside-platform"
    description = ("torch.* compute call, .to(<device>), .cuda() or "
                   ".synchronize() outside the device-layer modules "
                   "(ops/, parallel/, pql/, core/, platform.py) — route "
                   "transfers through platform.h2d_copy and launches "
                   "through the ops wrappers (kernel_util.on_card) so "
                   "the tracer, the lock tracer and devprof see them")
    # device-layer modules whose torch use IS the routed implementation;
    # obs/devprof.py times launches with CUDA events, kernel clocks and
    # syncs (its job), and probes/ are measurement tools that drive the
    # card directly by design
    _ALLOWED = ("pilosa_tpu_torch/ops/", "pilosa_tpu_torch/parallel/",
                "pilosa_tpu_torch/pql/", "pilosa_tpu_torch/core/",
                "pilosa_tpu_torch/platform.py",
                "pilosa_tpu_torch/dataframe/expr.py",
                "pilosa_tpu_torch/obs/devprof.py",
                "pilosa_tpu_torch/probes/")

    def in_scope(self, path: str) -> bool:
        p = _norm_path(path)
        return not any(a in p for a in self._ALLOWED)

    def check(self, path, tree, source):
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if not isinstance(f, ast.Attribute):
                continue
            dotted = _dotted(f)
            if dotted.startswith("torch."):
                if dotted in _NON_COMPUTING:
                    continue
                on_dev = any(kw.arg == "device" for kw in node.keywords)
                yield self._v(
                    path, source, node,
                    f"{dotted}()"
                    f"{' allocates on a device' if on_dev else ''} "
                    f"outside the device layer — put it behind platform "
                    f"or an ops wrapper")
            elif f.attr == "to":
                args = list(node.args) + [kw.value for kw in node.keywords
                                          if kw.arg == "dtype"]
                if (len(args) == 1 and _is_torch_dtype(args[0])
                        and all(kw.arg in ("dtype", "copy")
                                for kw in node.keywords)):
                    continue
                yield self._v(
                    path, source, node,
                    ".to() that may name a device outside the device "
                    "layer — use platform.h2d_copy")
            elif f.attr in ("cuda", "synchronize"):
                yield self._v(
                    path, source, node,
                    f".{f.attr}() outside the device layer — use "
                    f"platform.h2d_copy / the ops wrappers")


# ---------------------------------------------------------------------------
# contextvar-set-reset
# ---------------------------------------------------------------------------


class ContextvarResetRule(Rule):
    name = "contextvar-set-reset"
    description = ("ContextVar.set() whose token is dropped or never "
                   "reset/returned in the same function — an unreset "
                   "scope silently re-parents every later request on "
                   "that thread")

    @staticmethod
    def _module_contextvars(tree: ast.AST) -> set:
        names = set()
        for node in ast.iter_child_nodes(tree):
            if isinstance(node, (ast.Assign, ast.AnnAssign)):
                value = node.value
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                if (isinstance(value, ast.Call)
                        and _terminal(value.func) == "ContextVar"):
                    for t in targets:
                        if isinstance(t, ast.Name):
                            names.add(t.id)
        return names

    def check(self, path, tree, source):
        cvars = self._module_contextvars(tree)
        if not cvars:
            return []
        out: List[Violation] = []

        def is_set_call(node) -> bool:
            return (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "set"
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id in cvars)

        for fn in ast.walk(tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            has_reset = any(
                isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)
                and n.func.attr == "reset"
                for n in ast.walk(fn))
            returned: set = set()
            for n in ast.walk(fn):
                if isinstance(n, ast.Return) and isinstance(n.value,
                                                            ast.Name):
                    returned.add(n.value.id)
            for stmt in ast.walk(fn):
                if isinstance(stmt, ast.Expr) and is_set_call(stmt.value):
                    out.append(self._v(
                        path, source, stmt,
                        "ContextVar.set() token discarded — keep it and "
                        "reset(token) (or return it to the caller that "
                        "will)"))
                elif isinstance(stmt, ast.Assign) and \
                        is_set_call(stmt.value):
                    tgt = stmt.targets[0]
                    if isinstance(tgt, ast.Attribute):
                        continue  # token escapes via self.* — reset later
                    if isinstance(tgt, ast.Name) and not has_reset \
                            and tgt.id not in returned:
                        out.append(self._v(
                            path, source, stmt,
                            f"token {tgt.id!r} from ContextVar.set() is "
                            f"neither reset nor returned in this "
                            f"function"))
                elif isinstance(stmt, ast.Return) and stmt.value is not None \
                        and is_set_call(stmt.value):
                    pass  # returning the token hands reset to the caller
        return out


# ---------------------------------------------------------------------------
# metrics-label-hygiene
# ---------------------------------------------------------------------------

_METRIC_METHODS = ("count", "gauge", "observe", "observe_bucketed")
# non-label keywords of the MetricsRegistry API
_NON_LABEL_KW = {"n", "value", "seconds", "buckets", "exemplar_trace_id"}


class LabelCardinalityRule(Rule):
    name = "metrics-label-hygiene"
    description = ("metric label value built from a computed string "
                   "(f-string / concat / str(...)) — labels must come "
                   "from bounded enums, never request data: every "
                   "distinct value is a series the registry keeps "
                   "forever")

    def check(self, path, tree, source):
        out: List[Violation] = []
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _METRIC_METHODS):
                continue
            recv = _dotted(node.func.value).lower()
            if "registry" not in recv:
                continue
            for kw in node.keywords:
                if kw.arg is None or kw.arg in _NON_LABEL_KW:
                    continue
                v = kw.value
                computed = (
                    isinstance(v, ast.JoinedStr)
                    or isinstance(v, ast.BinOp)
                    or (isinstance(v, ast.Call)
                        and _terminal(v.func) in ("str", "format", "repr")))
                if computed:
                    out.append(self._v(
                        path, source, node,
                        f"label {kw.arg}= is a computed string — use a "
                        f"bounded enum value (or bucket/clamp it first)"))
        return out


ALL_RULES: Tuple[Rule, ...] = (
    NoRawTimeRule(), NoBareLockRule(), CallbackUnderLockRule(),
    DeviceCallRule(), ContextvarResetRule(), LabelCardinalityRule(),
)


# ---------------------------------------------------------------------------
# engine + baseline
# ---------------------------------------------------------------------------


class RuleEngine:
    def __init__(self, rules: Sequence[Rule] = ALL_RULES):
        self.rules = list(rules)

    def check_source(self, path: str, source: str) -> List[Violation]:
        try:
            tree = ast.parse(source)
        except SyntaxError as e:
            return [Violation(rule="parse-error", path=_norm_path(path),
                              line=e.lineno or 0, match="",
                              message=f"syntax error: {e.msg}")]
        out: List[Violation] = []
        for rule in self.rules:
            if rule.in_scope(path):
                out.extend(rule.check(path, tree, source))
        out.sort(key=lambda v: (v.path, v.line, v.rule))
        return out

    def check_file(self, path: str, rel: Optional[str] = None
                   ) -> List[Violation]:
        with open(path, encoding="utf-8") as f:
            source = f.read()
        return self.check_source(rel or path, source)

    def check_tree(self, root: str, rel_to: Optional[str] = None
                   ) -> List[Violation]:
        """Lint every .py under ``root`` (or the single file ``root``),
        reporting paths relative to ``rel_to`` (default: cwd)."""
        rel_to = rel_to or os.getcwd()
        out: List[Violation] = []
        if os.path.isfile(root):
            files = [root]
        else:
            files = []
            for dirpath, dirnames, filenames in os.walk(root):
                dirnames[:] = sorted(d for d in dirnames
                                     if d != "__pycache__")
                files.extend(os.path.join(dirpath, f)
                             for f in sorted(filenames)
                             if f.endswith(".py"))
        for f in files:
            rel = _norm_path(os.path.relpath(f, rel_to))
            out.extend(self.check_file(f, rel=rel))
        out.sort(key=lambda v: (v.path, v.line, v.rule))
        return out


def default_engine() -> RuleEngine:
    return RuleEngine(ALL_RULES)


def load_baseline(path: str) -> List[dict]:
    if not os.path.exists(path):
        return []
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    entries = data.get("entries", []) if isinstance(data, dict) else data
    for e in entries:
        for field in ("rule", "path", "match", "reason"):
            if field not in e:
                raise ValueError(
                    f"baseline entry missing {field!r}: {e!r}")
    return entries


def save_baseline(path: str, entries: List[dict]) -> None:
    payload = {
        "_comment": ("Suppressed-with-reason pre-existing lint "
                     "violations. Ratchet DOWN only: fix a site, delete "
                     "its entry. New entries need review + a real "
                     "reason. Matching is (rule, path, source snippet) "
                     "so line churn does not invalidate entries."),
        "entries": sorted(entries, key=lambda e: (e["rule"], e["path"],
                                                  e["match"])),
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=1)
        f.write("\n")


def baseline_entries_for(violations: Sequence[Violation],
                         reason: str = "TODO: justify or fix"
                         ) -> List[dict]:
    return [{"rule": v.rule, "path": v.path, "match": v.match,
             "reason": reason} for v in violations]


def apply_baseline(violations: Sequence[Violation],
                   entries: Sequence[dict]
                   ) -> Tuple[List[Violation], List[Violation], List[dict]]:
    """Split ``violations`` against the baseline. Returns
    ``(new, suppressed, stale_entries)`` — stale entries matched nothing
    and should be deleted (the ratchet)."""
    by_key = {(e["rule"], e["path"], e["match"]): e for e in entries}
    new: List[Violation] = []
    suppressed: List[Violation] = []
    used = set()
    for v in violations:
        e = by_key.get(v.key())
        if e is not None:
            suppressed.append(v)
            used.add(v.key())
        else:
            new.append(v)
    stale = [e for k, e in by_key.items() if k not in used]
    return new, suppressed, stale


# ---------------------------------------------------------------------------
# CLI (the counterpart of scripts/lint_invariants.py)
# ---------------------------------------------------------------------------

DEFAULT_BASELINE = os.path.join("pilosa_tpu_torch", "analysis",
                                "baseline.json")


def _fmt(v: Violation) -> str:
    return f"{v.path}:{v.line}: [{v.rule}] {v.message}\n    {v.match}"


#: selftest fixtures: (rule name, violating source, clean source, path);
#: the device rule has one per form it flags
_FIXTURES = [
    ("no-raw-time",
     "import time\ndef tick():\n    return time.time()\n",
     "import time\nclass WallClock:\n    def now(self):\n"
     "        return time.time()\n"
     "def tick(clock):\n    return clock.now()\n",
     "pilosa_tpu_torch/obs/sample.py"),
    ("no-bare-lock",
     "import threading\nLOCK = threading.Lock()\n",
     "from pilosa_tpu_torch.analysis import locktrace\n"
     "LOCK = locktrace.tracked_lock('sample.lock')\n",
     "pilosa_tpu_torch/cache/sample.py"),
    ("no-callback-under-lock",
     "def fire(self):\n    with self._lock:\n"
     "        for listener in self._listeners:\n            listener(1)\n",
     "def fire(self):\n    with self._lock:\n"
     "        pending = list(self._listeners)\n"
     "    for fn in pending:\n        fn(1)\n",
     "pilosa_tpu_torch/cluster/sample.py"),
    ("no-device-call-outside-platform",
     "def up(x, dev):\n    return x.to(dev, non_blocking=True)\n",
     "from pilosa_tpu_torch import platform\n"
     "def up(x, dev):\n    return platform.h2d_copy(x, dev)\n",
     "pilosa_tpu_torch/stream/sample.py"),
    ("no-device-call-outside-platform",
     "def up(x):\n    return x.cuda()\n",
     "import torch\ndef wide(x):\n    return x.to(torch.int64)\n",
     "pilosa_tpu_torch/stream/sample.py"),
    ("no-device-call-outside-platform",
     "import torch\ndef buf(n, dev):\n"
     "    return torch.zeros(n, device=dev)\n",
     "import torch\ndef dev():\n    return torch.device('cpu')\n",
     "pilosa_tpu_torch/server/sample.py"),
    ("no-device-call-outside-platform",
     "import torch\ndef wait():\n    torch.cuda.synchronize()\n",
     "import torch\ndef cards():\n"
     "    return torch.cuda.device_count() if "
     "torch.cuda.is_available() else 0\n",
     "pilosa_tpu_torch/sched/sample.py"),
    ("no-device-call-outside-platform",
     "def wait(event):\n    event.synchronize()\n",
     "def wait(done):\n    done.wait()\n",
     "pilosa_tpu_torch/cluster/sample.py"),
    ("no-device-call-outside-platform",
     "import torch\ndef total(x):\n    return torch.sum(x)\n",
     "import numpy as np\ndef total(x):\n    return np.sum(x)\n",
     "pilosa_tpu_torch/sql/sample.py"),
    ("contextvar-set-reset",
     "import contextvars\nCV = contextvars.ContextVar('cv')\n"
     "def enter(v):\n    CV.set(v)\n",
     "import contextvars\nCV = contextvars.ContextVar('cv')\n"
     "def enter(v):\n    token = CV.set(v)\n    return token\n"
     "def leave(token):\n    CV.reset(token)\n",
     "pilosa_tpu_torch/obs/sample2.py"),
    ("metrics-label-hygiene",
     "def rec(registry, shard):\n"
     "    registry.count('reads_total', shard=f'shard-{shard}')\n",
     "def rec(registry, outcome):\n"
     "    registry.count('reads_total', outcome=outcome)\n",
     "pilosa_tpu_torch/server/sample.py"),
]


def selftest() -> int:
    engine = default_engine()
    failures = []
    for rule, bad, good, path in _FIXTURES:
        hits = [v for v in engine.check_source(path, bad) if v.rule == rule]
        if not hits:
            failures.append(f"{rule}: positive fixture not flagged: "
                            f"{bad!r}")
        clean = [v for v in engine.check_source(path, good)
                 if v.rule == rule]
        if clean:
            failures.append(f"{rule}: negative fixture flagged: "
                            f"{clean[0].message}")
    # baseline round-trip: suppressing the positive fixtures yields zero
    # new violations and zero stale entries; an extra entry goes stale
    all_bad = [v for rule, bad, _, path in _FIXTURES
               for v in engine.check_source(path, bad) if v.rule == rule]
    entries = baseline_entries_for(all_bad, reason="selftest")
    new, suppressed, stale = apply_baseline(all_bad, entries)
    if new or stale or len(suppressed) != len(all_bad):
        failures.append(f"baseline round-trip: new={len(new)} "
                        f"stale={len(stale)} "
                        f"suppressed={len(suppressed)}/{len(all_bad)}")
    extra = entries + [{"rule": "no-raw-time", "path": "gone.py",
                        "match": "time.time()", "reason": "fixed"}]
    _, _, stale2 = apply_baseline(all_bad, extra)
    if len(stale2) != 1:
        failures.append(f"stale detection: expected 1, got {len(stale2)}")
    if failures:
        for f in failures:
            print(f"SELFTEST FAIL: {f}", file=sys.stderr)
        return 1
    rules = len({r for r, _, _, _ in _FIXTURES})
    print(f"selftest OK: {rules} rules, {len(_FIXTURES)} fixtures x "
          f"(positive+negative) + baseline round-trip")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m pilosa_tpu_torch.analysis.lint",
        description="Project-invariant linter of the port (static half "
                    "of the analysis plane).")
    ap.add_argument("root", nargs="?", default="pilosa_tpu_torch",
                    help="file or directory to lint (default: "
                         "pilosa_tpu_torch)")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help=f"baseline JSON (default: {DEFAULT_BASELINE}; "
                         f"'-' disables)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit machine-readable JSON report")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write current violations to --baseline "
                         "(entries need reasons filled in) and exit 0")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--selftest", action="store_true",
                    help="run built-in fixtures for every rule and exit")
    args = ap.parse_args(argv)

    if args.selftest:
        return selftest()

    engine = default_engine()
    if args.list_rules:
        for r in engine.rules:
            print(f"{r.name:36s} {r.description}")
        return 0

    violations = engine.check_tree(args.root)

    if args.write_baseline:
        entries = baseline_entries_for(violations)
        save_baseline(args.baseline, entries)
        print(f"wrote {len(entries)} entries to {args.baseline} "
              f"(fill in reasons before committing)")
        return 0

    entries = [] if args.baseline == "-" else load_baseline(args.baseline)
    new, suppressed, stale = apply_baseline(violations, entries)

    if args.as_json:
        print(json.dumps({
            "new": [v.to_json() for v in new],
            "suppressed": [v.to_json() for v in suppressed],
            "stale_baseline_entries": stale,
        }, indent=1))
    else:
        for v in new:
            print(_fmt(v))
        for e in stale:
            print(f"STALE baseline entry (site fixed — delete it): "
                  f"[{e['rule']}] {e['path']} :: {e['match']}")
        print(f"lint: {len(new)} new, {len(suppressed)} baselined, "
              f"{len(stale)} stale baseline entries")

    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
