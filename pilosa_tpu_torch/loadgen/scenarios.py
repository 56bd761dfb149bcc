"""Weighted scenario mixes for the open-loop driver.

A scenario *kind* names what one virtual-user operation does; the
caller's ``execute(op)`` binds kinds to real work (HTTP against a
LocalCluster, direct API calls, ...). The mix only decides WHICH kind
each scheduled op is, from a seeded RNG, so a fixed seed replays the
identical op sequence against any binding.

Port of ``pilosa_tpu/loadgen/scenarios.py``; the same seed gives the same
schedule, mix and tenant picks in both packages.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Tuple

#: interactive PQL read (scheduler interactive priority)
KIND_INTERACTIVE = "interactive"
#: SQL SELECT (engine + result cache path)
KIND_SQL = "sql"
#: streaming ingest push (broker backpressure path)
KIND_STREAM_PUSH = "stream_push"
#: bulk import (batch priority; first to be shed)
KIND_BULK_IMPORT = "bulk_import"
#: quota churn: a tail tenant touching its token buckets / registry row
KIND_QUOTA_CHURN = "quota_churn"

#: a standing mixed workload: read-heavy with a steady ingest trickle
DEFAULT_MIX: Dict[str, float] = {
    KIND_INTERACTIVE: 0.45,
    KIND_SQL: 0.20,
    KIND_STREAM_PUSH: 0.15,
    KIND_BULK_IMPORT: 0.10,
    KIND_QUOTA_CHURN: 0.10,
}


class ScenarioMix:
    """Normalized weighted choice over scenario kinds (seed-stable)."""

    def __init__(self, weights: Optional[Dict[str, float]] = None):
        weights = dict(weights if weights is not None else DEFAULT_MIX)
        if not weights:
            raise ValueError("empty scenario mix")
        total = sum(weights.values())
        if total <= 0:
            raise ValueError("scenario mix weights must sum > 0")
        # sorted for PYTHONHASHSEED-independent pick order
        self._kinds: List[Tuple[str, float]] = []
        acc = 0.0
        for kind in sorted(weights):
            w = weights[kind]
            if w < 0:
                raise ValueError(f"negative weight for {kind!r}")
            acc += w / total
            self._kinds.append((kind, acc))

    def pick(self, rng: random.Random) -> str:
        u = rng.random()
        for kind, edge in self._kinds:
            if u <= edge:
                return kind
        return self._kinds[-1][0]

    def kinds(self) -> List[str]:
        return [k for k, _ in self._kinds]

    @classmethod
    def interactive_only(cls) -> "ScenarioMix":
        return cls({KIND_INTERACTIVE: 1.0})
