"""Synthetic data generator.

Port of ``pilosa_tpu/ingest/datagen.py``: the same scenarios give the
same records for the same seed. The ``datagen`` command line waits for
the port's front ends.

Reference: idk/datagen/ — a registry of named scenarios (customer, bank,
equipment, kitchen sink, ...) each producing a Source of synthetic
records for load tests and demos. The reference embeds ~187k LoC of
static data files; here scenarios generate deterministically from a
seed, which serves the same purpose (repeatable load shapes) in a few
hundred lines.

Use programmatically: ``scenario("customer", rows=...)`` returns a
Source for the Ingester.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Optional

import numpy as np

from pilosa_tpu_torch.core.schema import FieldOptions, FieldType
from pilosa_tpu_torch.ingest.source import Record, Source

_SCENARIOS: Dict[str, Callable] = {}


def register(name: str):
    def deco(fn):
        _SCENARIOS[name] = fn
        return fn
    return deco


def scenarios() -> List[str]:
    return sorted(_SCENARIOS)


def scenario(name: str, rows: int = 1000, seed: int = 1,
             rate_rows_s: Optional[float] = None, clock=None) -> Source:
    """A named synthetic Source.

    With ``rate_rows_s`` the source streams: records are released at the
    given rate against ``clock`` (sched/clock.py), modeling a live feed
    for the streaming ingest pipeline. A ManualClock makes the pacing
    fully deterministic — the wrapper advances the clock itself instead
    of sleeping, so tests and benches never wall-block.
    """
    if name not in _SCENARIOS:
        raise KeyError(
            f"unknown scenario {name!r}; have {', '.join(scenarios())}")
    src = _SCENARIOS[name](rows, seed)
    if rate_rows_s is not None:
        src = _RateLimitedSource(src, rate_rows_s, clock=clock)
    return src


class _RateLimitedSource(Source):
    """Release an inner source's records at a fixed rows/s.

    Record ``i`` becomes due at ``t0 + i / rate``. Against a ManualClock
    (detected by its ``advance`` method) the wrapper advances time to the
    due instant — zero wall sleeps, bit-reproducible pacing. Against a
    real clock it waits out the remaining interval.
    """

    def __init__(self, inner: Source, rate_rows_s: float, clock=None):
        if rate_rows_s <= 0:
            raise ValueError("rate_rows_s must be positive")
        from pilosa_tpu_torch.sched.clock import MonotonicClock

        self._inner = inner
        self._rate = float(rate_rows_s)
        self._clock = clock or MonotonicClock()

    def schema(self):
        return self._inner.schema()

    def id_column(self):
        return self._inner.id_column()

    def records(self):
        clock = self._clock
        manual = hasattr(clock, "advance")
        t0 = clock.now()
        released = 0
        for rec in self._inner.records():
            due = t0 + released / self._rate
            now = clock.now()
            if now < due:
                if manual:
                    clock.advance(due - now)
                else:
                    import time

                    time.sleep(due - now)
            yield rec
            released += 1


class _GenSource(Source):
    def __init__(self, schema, gen: Callable[[], Iterator[Record]],
                 id_col: str = "id"):
        self._schema = schema
        self._gen = gen
        self._id_col = id_col

    def schema(self):
        return self._schema

    def id_column(self):
        return self._id_col

    def records(self):
        return self._gen()


_CITIES = ["nyc", "sf", "chicago", "austin", "seattle", "denver",
           "boston", "miami", "portland", "atlanta"]
_SEGMENTS = ["free", "basic", "pro", "enterprise"]
_HOBBIES = ["golf", "chess", "cycling", "climbing", "cooking", "reading",
            "gaming", "sailing"]


@register("customer")
def _customer(rows: int, seed: int) -> Source:
    """Customer profile shape (reference: idk/datagen customer): mutex
    demographics, set-valued interests, BSI spend."""
    schema = [
        ("city", FieldOptions(type=FieldType.MUTEX, keys=True)),
        ("segment", FieldOptions(type=FieldType.MUTEX, keys=True)),
        ("hobbies", FieldOptions(type=FieldType.SET, keys=True)),
        ("age", FieldOptions(type=FieldType.INT, min=0, max=120)),
        ("ltv", FieldOptions(type=FieldType.INT)),
        ("active", FieldOptions(type=FieldType.BOOL)),
    ]

    def gen():
        rng = np.random.default_rng(seed)
        for i in range(rows):
            n_hob = int(rng.integers(0, 4))
            yield {
                "id": i,
                "city": _CITIES[int(rng.integers(0, len(_CITIES)))],
                "segment": _SEGMENTS[int(rng.integers(0, len(_SEGMENTS)))],
                "hobbies": list(rng.choice(_HOBBIES, n_hob, replace=False)),
                "age": int(rng.integers(18, 95)),
                "ltv": int(rng.integers(0, 100_000)),
                "active": bool(rng.random() < 0.7),
            }

    return _GenSource(schema, gen)


@register("bank")
def _bank(rows: int, seed: int) -> Source:
    """Transaction-ish shape (reference: idk/datagen bank)."""
    schema = [
        ("category", FieldOptions(type=FieldType.MUTEX, keys=True)),
        ("merchant", FieldOptions(type=FieldType.MUTEX, keys=True)),
        ("amount_cents", FieldOptions(type=FieldType.INT)),
        ("flagged", FieldOptions(type=FieldType.BOOL)),
    ]
    cats = ["grocery", "travel", "dining", "utilities", "salary", "rent"]

    def gen():
        rng = np.random.default_rng(seed)
        for i in range(rows):
            yield {
                "id": i,
                "category": cats[int(rng.integers(0, len(cats)))],
                "merchant": f"m{int(rng.integers(0, 500)):03d}",
                "amount_cents": int(rng.integers(-500_000, 500_000)),
                "flagged": bool(rng.random() < 0.01),
            }

    return _GenSource(schema, gen)


@register("equipment")
def _equipment(rows: int, seed: int) -> Source:
    """IoT/asset shape (reference: idk/datagen equipment)."""
    schema = [
        ("type", FieldOptions(type=FieldType.MUTEX, keys=True)),
        ("site", FieldOptions(type=FieldType.MUTEX, keys=True)),
        ("temp_c", FieldOptions(type=FieldType.INT, min=-50, max=200)),
        ("uptime_h", FieldOptions(type=FieldType.INT)),
    ]
    types = ["pump", "valve", "compressor", "turbine", "sensor"]

    def gen():
        rng = np.random.default_rng(seed)
        for i in range(rows):
            yield {
                "id": i,
                "type": types[int(rng.integers(0, len(types)))],
                "site": f"site{int(rng.integers(0, 40)):02d}",
                "temp_c": int(rng.normal(60, 25)),
                "uptime_h": int(rng.integers(0, 80_000)),
            }

    return _GenSource(schema, gen)


@register("kitchen-sink")
def _kitchen_sink(rows: int, seed: int) -> Source:
    """Every field type at once (reference: idk/datagen kitchen sink)."""
    schema = [
        ("a_mutex", FieldOptions(type=FieldType.MUTEX, keys=True)),
        ("an_idset", FieldOptions(type=FieldType.SET)),
        ("a_stringset", FieldOptions(type=FieldType.SET, keys=True)),
        ("an_int", FieldOptions(type=FieldType.INT)),
        ("a_decimal", FieldOptions(type=FieldType.DECIMAL, scale=2)),
        ("a_bool", FieldOptions(type=FieldType.BOOL)),
    ]

    def gen():
        rng = np.random.default_rng(seed)
        for i in range(rows):
            yield {
                "id": i,
                "a_mutex": f"v{int(rng.integers(0, 20))}",
                "an_idset": [int(x) for x in
                             rng.integers(0, 50, int(rng.integers(0, 5)))],
                "a_stringset": [f"s{int(x)}" for x in
                                rng.integers(0, 30, int(rng.integers(0, 4)))],
                "an_int": int(rng.integers(-1000, 1000)),
                "a_decimal": round(float(rng.random() * 100), 2),
                "a_bool": bool(rng.random() < 0.5),
            }

    return _GenSource(schema, gen)
