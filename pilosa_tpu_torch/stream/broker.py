"""In-process Kafka-shaped stream broker.

Port of ``pilosa_tpu/stream/broker.py``.

The continuous-ingest pipeline (stream/pipeline.py) consumes through the
:class:`StreamConsumer` protocol — poll / commit / committed / seek /
pause / resume — which both this broker's :class:`BrokerConsumer` and the
gated ``ingest/kafka.KafkaSource`` implement, so tests, bench, and chaos
lanes run without external Kafka while the real client drops in
unchanged.

The broker is a durable-log *shape*, not a durable log: topics are
partitioned in-memory lists with monotonic per-partition offsets and
per-consumer-group committed-offset tracking. Exactly-once resume does
NOT lean on the broker's group offsets — the pipeline stamps its
watermarks into the WAL frame stream (one ``stream_offsets`` record per
group commit) and seeks past the broker's view on restart, exactly as it
would against a real Kafka whose committed offsets lag the database's
own durable state.

Determinism: partition choice is crc32-keyed (never PYTHONHASHSEED-
dependent), unkeyed produce round-robins from a seed-derived phase, and
all timing reads an injectable clock (sched/clock.py) — the same
discipline as FaultPlan/CrashPlan.
"""

from __future__ import annotations

import threading
import zlib
from typing import Any, Dict, List, Optional, Tuple

from pilosa_tpu_torch.ingest.source import Source
from pilosa_tpu_torch.sched.clock import MonotonicClock


def tp_key(topic: str, partition: int) -> str:
    """Canonical ``"topic:partition"`` key used everywhere offsets are a
    mapping — WAL ``stream_offsets`` records, checkpoint stamps, commit
    maps — a flat string so the mapping survives JSON round-trips."""
    return f"{topic}:{int(partition)}"


def split_tp(key: str) -> Tuple[str, int]:
    topic, _, part = key.rpartition(":")
    return topic, int(part)


#: Chunked message marker: a record whose value is
#: ``{CHUNK_KEY: {column: [cells...]}}`` carries MANY rows as equal-length
#: columns — the Kafka batch-per-message shape producers use at
#: production rates. The pipelined ingester prepares chunks as single
#: numpy conversions per column (no per-cell Python loop); cells must be
#: dense scalars (one value per row, no None, no per-cell lists).
CHUNK_KEY = "__columns__"


def make_chunk(columns: Dict[str, list]) -> dict:
    """Wrap equal-length columns as one chunked record value."""
    sizes = {len(c) for c in columns.values()}
    if len(sizes) > 1:
        raise ValueError(f"chunk columns differ in length: {sorted(sizes)}")
    return {CHUNK_KEY: columns}


def chunk_columns(value: Any) -> Optional[Dict[str, list]]:
    """The column dict of a chunked record value, or None for a plain
    one-row record."""
    if isinstance(value, dict):
        return value.get(CHUNK_KEY)
    return None


def iter_rows(value: Any):
    """Yield row dicts from a record value, expanding chunks — how
    row-at-a-time consumers (BrokerSource -> classic Ingester) see a
    stream that mixes plain and chunked messages."""
    cols = chunk_columns(value)
    if cols is None:
        yield value
        return
    names = list(cols)
    for i in range(len(cols[names[0]]) if names else 0):
        yield {name: cols[name][i] for name in names}


class StreamRecord:
    """One consumed message: ``value`` is the record dict (Batch value
    conventions), ``offset`` the monotonic per-partition position."""

    __slots__ = ("topic", "partition", "offset", "value", "key", "timestamp")

    def __init__(self, topic: str, partition: int, offset: int, value: Any,
                 key: Optional[str] = None, timestamp: float = 0.0):
        self.topic = topic
        self.partition = int(partition)
        self.offset = int(offset)
        self.value = value
        self.key = key
        self.timestamp = timestamp

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"StreamRecord({self.topic}[{self.partition}]"
                f"@{self.offset})")


class StreamConsumer:
    """The consumer surface the pipelined ingester drives.

    Offsets in ``commit`` mappings are EXCLUSIVE next-read positions
    (Kafka semantics: committing N means records < N are consumed).
    """

    def poll(self, max_records: int = 500,
             timeout_s: float = 0.0) -> List[StreamRecord]:
        raise NotImplementedError

    def commit(self, offsets: Optional[Dict[str, int]] = None) -> None:
        """Commit ``{"topic:partition": next_offset}`` (or the current
        poll positions when None)."""
        raise NotImplementedError

    def committed(self, topic: str, partition: int) -> int:
        raise NotImplementedError

    def seek(self, topic: str, partition: int, offset: int) -> None:
        raise NotImplementedError

    def pause(self) -> None:
        raise NotImplementedError

    def resume(self) -> None:
        raise NotImplementedError

    @property
    def paused(self) -> bool:
        return False

    def lag(self) -> int:
        """Records behind the end of the assigned partitions (0 when
        unknown — a real Kafka client may not expose end offsets)."""
        return 0


class StreamBroker:
    """Topics, partitions, monotonic offsets, consumer groups."""

    def __init__(self, partitions: int = 1, seed: int = 0, clock=None):
        self.clock = clock or MonotonicClock()
        self.seed = seed
        self._lock = threading.RLock()
        self._default_partitions = max(1, int(partitions))
        # topic -> list of per-partition record lists
        self._logs: Dict[str, List[List[StreamRecord]]] = {}
        # (group, topic, partition) -> committed next offset
        self._committed: Dict[Tuple[str, str, int], int] = {}
        self._rr: Dict[str, int] = {}  # unkeyed-produce round-robin

    # -- topics ------------------------------------------------------------

    def create_topic(self, topic: str,
                     partitions: Optional[int] = None) -> None:
        with self._lock:
            if topic not in self._logs:
                n = max(1, int(partitions or self._default_partitions))
                self._logs[topic] = [[] for _ in range(n)]
                # seed-derived starting phase: deterministic, but not the
                # same partition 0 for every topic
                self._rr[topic] = zlib.crc32(
                    f"{topic}:{self.seed}".encode()) % n

    def topics(self) -> List[str]:
        with self._lock:
            return sorted(self._logs)

    def partitions(self, topic: str) -> int:
        with self._lock:
            return len(self._logs[topic])

    # -- produce -----------------------------------------------------------

    def produce(self, topic: str, value: Any, key: Optional[str] = None,
                partition: Optional[int] = None) -> Tuple[int, int]:
        """Append one record; returns (partition, offset). Keyed records
        land on crc32(key) % partitions (stable co-partitioning), unkeyed
        ones round-robin."""
        with self._lock:
            if topic not in self._logs:
                self.create_topic(topic)
            parts = self._logs[topic]
            if partition is None:
                if key is not None:
                    partition = zlib.crc32(str(key).encode()) % len(parts)
                else:
                    partition = self._rr[topic] % len(parts)
                    self._rr[topic] += 1
            log = parts[partition]
            rec = StreamRecord(topic, partition, len(log), value, key=key,
                               timestamp=self.clock.now())
            log.append(rec)
            return partition, rec.offset

    def produce_records(self, topic: str, values) -> int:
        n = 0
        for v in values:
            self.produce(topic, v)
            n += 1
        return n

    # -- offsets -----------------------------------------------------------

    def end_offset(self, topic: str, partition: int) -> int:
        with self._lock:
            return len(self._logs[topic][partition])

    def fetch(self, topic: str, partition: int, offset: int,
              max_records: int) -> List[StreamRecord]:
        if max_records <= 0:
            return []
        with self._lock:
            log = self._logs[topic][partition]
            return log[offset:offset + max_records]

    def commit(self, group: str, offsets: Dict[str, int]) -> None:
        """Advance a group's committed offsets (monotonic max — a late
        duplicate commit can never regress the group)."""
        with self._lock:
            for k, off in offsets.items():
                topic, part = split_tp(k)
                cur = self._committed.get((group, topic, part), 0)
                self._committed[(group, topic, part)] = max(cur, int(off))

    def committed(self, group: str, topic: str, partition: int) -> int:
        with self._lock:
            return self._committed.get((group, topic, int(partition)), 0)

    def consumer(self, group: str,
                 topics: Optional[List[str]] = None) -> "BrokerConsumer":
        return BrokerConsumer(self, group, topics)


class BrokerConsumer(StreamConsumer):
    """One group member consuming every partition of its topics.

    Poll order is deterministic: topics sorted, partitions ascending,
    records in offset order — the same input always yields the same
    batch sequence.
    """

    def __init__(self, broker: StreamBroker, group: str,
                 topics: Optional[List[str]] = None):
        self.broker = broker
        self.group = group
        self._topics = sorted(topics) if topics else None
        self._lock = threading.RLock()
        self._positions: Dict[Tuple[str, int], int] = {}
        self._paused = False
        self._paused_at: Optional[float] = None
        self._paused_total = 0.0

    def _assignment(self) -> List[Tuple[str, int]]:
        topics = self._topics if self._topics is not None \
            else self.broker.topics()
        return [(t, p) for t in topics
                for p in range(self.broker.partitions(t))]

    def _position(self, topic: str, partition: int) -> int:
        pos = self._positions.get((topic, partition))
        if pos is None:
            pos = self.broker.committed(self.group, topic, partition)
            self._positions[(topic, partition)] = pos
        return pos

    # -- StreamConsumer ----------------------------------------------------

    def poll(self, max_records: int = 500,
             timeout_s: float = 0.0) -> List[StreamRecord]:
        with self._lock:
            if self._paused:
                return []
            out: List[StreamRecord] = []
            for topic, part in self._assignment():
                if len(out) >= max_records:
                    break
                pos = self._position(topic, part)
                recs = self.broker.fetch(topic, part, pos,
                                         max_records - len(out))
                if recs:
                    out.extend(recs)
                    self._positions[(topic, part)] = pos + len(recs)
            return out

    def commit(self, offsets: Optional[Dict[str, int]] = None) -> None:
        with self._lock:
            if offsets is None:
                offsets = {tp_key(t, p): pos
                           for (t, p), pos in self._positions.items()}
            self.broker.commit(self.group, offsets)

    def committed(self, topic: str, partition: int) -> int:
        return self.broker.committed(self.group, topic, partition)

    def seek(self, topic: str, partition: int, offset: int) -> None:
        with self._lock:
            self._positions[(topic, int(partition))] = int(offset)

    def pause(self) -> None:
        with self._lock:
            if not self._paused:
                self._paused = True
                self._paused_at = self.broker.clock.now()

    def resume(self) -> None:
        with self._lock:
            if self._paused:
                self._paused = False
                if self._paused_at is not None:
                    self._paused_total += \
                        self.broker.clock.now() - self._paused_at
                self._paused_at = None

    @property
    def paused(self) -> bool:
        return self._paused

    def paused_s(self) -> float:
        """Cumulative seconds spent paused (includes the current stretch
        when still paused) — the backpressure stall the flight recorder's
        ``ingest_stall`` trigger watches."""
        with self._lock:
            total = self._paused_total
            if self._paused and self._paused_at is not None:
                total += self.broker.clock.now() - self._paused_at
            return total

    def lag(self) -> int:
        with self._lock:
            return sum(
                max(0, self.broker.end_offset(t, p) - self._position(t, p))
                for t, p in self._assignment())


class BrokerSource(Source):
    """Adapts a :class:`StreamConsumer` to the classic ``Source``
    protocol so the single-threaded ``Ingester`` can drain the same
    stream — the bit-identity oracle the pipelined path is checked
    against (bench ``--configs 17``, tests/test_stream.py)."""

    def __init__(self, consumer: StreamConsumer, schema,
                 id_col: Optional[str] = "id", batch: int = 4096):
        self._consumer = consumer
        self._schema = list(schema)
        self._id_col = id_col
        self._batch = batch

    def schema(self):
        return self._schema

    def id_column(self):
        return self._id_col

    def records(self):
        while True:
            recs = self._consumer.poll(self._batch)
            if not recs:
                return
            for r in recs:
                yield from iter_rows(r.value)
