"""Synthetic tenant populations for soak runs.

Real multi-tenant traffic is never uniform: a handful of tenants carry
most of the load while a long tail of 10^4..10^6 mostly-idle IDs churns
through every bounded per-tenant table (registry rows, token buckets,
vtime entries, cache quota cells). Both halves matter — the head drives
contention, the tail proves the caps hold — so picks follow a
Zipf-like rank distribution over a seeded shuffle.

Port of ``pilosa_tpu/loadgen/tenants.py``; the same seed gives the same
schedule, mix and tenant picks in both packages.
"""

from __future__ import annotations

import random
from typing import List, Optional


class SyntheticTenants:
    """Seeded tenant-ID population with a skewed pick distribution.

    ``pick`` draws tenant ranks from a power-law (P(rank) ~ 1/rank^s),
    so rank 0 dominates while deep-tail IDs still appear — exactly the
    shape that both exercises the hot-tenant paths and churns the
    bounded tables past their caps. All draws come from the caller's
    ``random.Random`` (or the internal seeded one), so a fixed seed
    replays the identical tenant sequence.
    """

    def __init__(self, n: int, *, seed: int = 0, skew: float = 1.1,
                 prefix: str = "t"):
        if n < 1:
            raise ValueError("need at least one tenant")
        self.n = int(n)
        self.skew = float(skew)
        self.prefix = prefix
        self._rng = random.Random(seed)
        # harmonic normalizer over a capped rank table: beyond ~4096
        # ranks the power-law mass is negligible, and the uncapped tail
        # is sampled uniformly below so every ID stays reachable
        self._head = min(self.n, 4096)
        weights = [1.0 / (r + 1) ** self.skew for r in range(self._head)]
        total = sum(weights)
        self._cdf: List[float] = []
        acc = 0.0
        for w in weights:
            acc += w / total
            self._cdf.append(acc)

    def name(self, i: int) -> str:
        return f"{self.prefix}{i:07d}"

    def pick(self, rng: Optional[random.Random] = None) -> str:
        """One skewed draw: mostly head ranks, occasionally (5%) a
        uniform draw over the whole population so the deep tail churns
        even when n >> the ranked head."""
        r = rng if rng is not None else self._rng
        if self.n > self._head and r.random() < 0.05:
            return self.name(r.randrange(self.n))
        u = r.random()
        lo, hi = 0, self._head - 1
        while lo < hi:
            mid = (lo + hi) // 2
            if self._cdf[mid] < u:
                lo = mid + 1
            else:
                hi = mid
        return self.name(lo)

    def all_ids(self):
        """Every tenant ID, generated (not materialized) — the bounded-
        table audit iterates 10^5 of these without holding a list."""
        for i in range(self.n):
            yield self.name(i)
