"""Load generation: the Star Schema Benchmark's data, queries and oracle
(:mod:`.ssb`).

Port of ``pilosa_tpu/loadgen``'s ``ssb`` module. The open-loop harness,
chaos schedules, scenarios and synthetic tenants wait for the port's
cluster plane.
"""

from pilosa_tpu_torch.loadgen import ssb

__all__ = ["ssb"]
