"""Concurrency-correctness plane of the port: two halves, one invariant
set, as ``pilosa_tpu/analysis``.

- :mod:`.locktrace` — the *dynamic* half: the lock-order graph that the
  scheduler, the result cache, the holder's write lock, the stacks'
  locks and the observability planes feed when tracing is on, with the
  dispatch notes of ``platform.h2d_copy`` and ``kernel_util.on_card``.
- :mod:`.lint` — the *static* half: the AST linter of the port's tree
  (``python -m pilosa_tpu_torch.analysis.lint``) against its ratcheted
  baseline (``analysis/baseline.json``).

This package must stay import-light: ``platform``, ``obs.metrics`` and
``ops.kernel_util`` import :mod:`.locktrace` at module scope, and the
linter's CLI imports no ``torch``.
"""
