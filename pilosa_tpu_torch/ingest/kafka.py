"""Kafka record source (gated).

Port of ``pilosa_tpu/ingest/kafka.py``; nothing is installed for it:
without a client ``_kafka_client()`` raises ``ImportError``.

Reference: idk/kafka/ — a cgo confluent-kafka consumer feeding the idk
Main loop with Avro/JSON decoding. The client library is an *external
dependency* in the reference too (SURVEY.md header note); this build
gates on an importable kafka client rather than bundling one. The JSON
message decoding and Source surface match the reference's
``idk/kafka_static`` JSON mode.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

from pilosa_tpu_torch.core.schema import FieldOptions
from pilosa_tpu_torch.ingest.source import Source, _parse_header
from pilosa_tpu_torch.stream.broker import StreamConsumer, StreamRecord, split_tp


def _kafka_client():
    try:
        import confluent_kafka  # type: ignore
        return confluent_kafka
    except ImportError:
        try:
            import kafka  # type: ignore  # kafka-python
            return kafka
        except ImportError:
            raise ImportError(
                "no kafka client installed (confluent_kafka or kafka-python "
                "required); the KafkaSource is gated like the reference's "
                "external librdkafka dependency")


class KafkaSource(Source, StreamConsumer):
    """Consume JSON records from Kafka topics.

    ``fields`` uses the same ``name__TYPE`` annotations as the CSV header
    (source.py) to type the schema; message values are JSON objects keyed
    by bare field name.

    Implements both surfaces: the classic batch ``Source`` protocol
    (``records()``) for the single-threaded Ingester, and the
    :class:`StreamConsumer` protocol (poll/commit/committed/seek/
    pause/resume) so the pipelined ingester (stream/pipeline.py) can
    drive a real Kafka exactly like the in-process StreamBroker. The
    client library stays import-gated; tests inject a fake.
    """

    def __init__(self, bootstrap: str, topics: List[str], group: str,
                 fields: List[str], id_field: Optional[str] = "id",
                 max_messages: Optional[int] = None, client=None):
        self._client = client or _kafka_client()
        self._bootstrap = bootstrap
        self._topics = topics
        self._group = group
        self._schema = _parse_header(fields)
        self._id = id_field
        self._max = max_messages
        self._consumer = None
        self._paused = False

    def schema(self) -> List[Tuple[str, FieldOptions]]:
        return [(n, o) for n, o in self._schema if n != self._id]

    def id_column(self) -> Optional[str]:
        return self._id

    def records(self):
        consumer = self._make_consumer()
        names = {n for n, _ in self._schema}
        seen = 0
        for msg in self._poll(consumer):
            rec = {k: v for k, v in json.loads(msg).items() if k in names
                   or k == self._id}
            yield rec
            seen += 1
            if self._max is not None and seen >= self._max:
                break

    # thin shims so tests can inject a fake client
    def _make_consumer(self):
        c = self._client
        if hasattr(c, "Consumer"):  # confluent-kafka
            consumer = c.Consumer({"bootstrap.servers": self._bootstrap,
                                   "group.id": self._group,
                                   "auto.offset.reset": "earliest"})
            consumer.subscribe(self._topics)
            return consumer
        return c.KafkaConsumer(*self._topics,
                               bootstrap_servers=self._bootstrap,
                               group_id=self._group)

    def _poll(self, consumer):
        if hasattr(consumer, "poll") and not hasattr(consumer, "__iter__"):
            while True:
                msg = consumer.poll(timeout=1.0)
                if msg is None:
                    return
                if msg.error():
                    continue
                yield msg.value()
        else:
            for msg in consumer:
                yield msg.value

    # -- StreamConsumer protocol (stream/broker.py) ------------------------
    #
    # Both client flavors are duck-typed through the same shims used
    # above: confluent-kafka messages expose topic()/partition()/offset()
    # methods, kafka-python messages expose attributes.

    def connect(self):
        """Bind the underlying client consumer lazily (so constructing a
        KafkaSource never dials a broker)."""
        if self._consumer is None:
            self._consumer = self._make_consumer()
        return self._consumer

    def _tp(self, topic: str, partition: int, offset: Optional[int] = None):
        """A client TopicPartition (both libraries export the name)."""
        cls = getattr(self._client, "TopicPartition")
        if offset is None:
            return cls(topic, int(partition))
        return cls(topic, int(partition), int(offset))

    def _decode(self, raw) -> Any:
        if isinstance(raw, (bytes, bytearray)):
            raw = raw.decode("utf-8")
        return json.loads(raw) if isinstance(raw, str) else raw

    def poll(self, max_records: int = 500,
             timeout_s: float = 0.0) -> List[StreamRecord]:
        consumer = self.connect()
        out: List[StreamRecord] = []
        if hasattr(self._client, "Consumer"):  # confluent-kafka
            while len(out) < max_records:
                msg = consumer.poll(timeout=timeout_s)
                if msg is None:
                    break
                if msg.error():
                    continue
                out.append(StreamRecord(
                    msg.topic(), msg.partition(), msg.offset(),
                    self._decode(msg.value()), key=msg.key()))
        else:  # kafka-python: poll() returns {TopicPartition: [records]}
            got = consumer.poll(timeout_ms=int(timeout_s * 1000),
                                max_records=max_records)
            for tp in sorted(got, key=lambda t: (t.topic, t.partition)):
                for m in got[tp]:
                    out.append(StreamRecord(
                        m.topic, m.partition, m.offset,
                        self._decode(m.value),
                        key=getattr(m, "key", None)))
        return out

    def commit(self, offsets: Optional[Dict[str, int]] = None) -> None:
        consumer = self.connect()
        if offsets is None:
            consumer.commit()
            return
        tps = [self._tp(*split_tp(k), offset=off)
               for k, off in sorted(offsets.items())]
        if hasattr(self._client, "Consumer"):  # confluent-kafka
            consumer.commit(offsets=tps, asynchronous=False)
        else:  # kafka-python wants {TopicPartition: OffsetAndMetadata}
            meta = getattr(self._client, "OffsetAndMetadata", None)
            consumer.commit({self._tp(*split_tp(k)):
                             (meta(off, None) if meta else off)
                             for k, off in offsets.items()})

    def committed(self, topic: str, partition: int) -> int:
        consumer = self.connect()
        if hasattr(self._client, "Consumer"):  # confluent: list in/out
            got = consumer.committed([self._tp(topic, partition)])
            off = got[0].offset if got else 0
        else:
            off = consumer.committed(self._tp(topic, partition))
        return max(0, int(off or 0))

    def seek(self, topic: str, partition: int, offset: int) -> None:
        consumer = self.connect()
        if hasattr(self._client, "Consumer"):
            consumer.seek(self._tp(topic, partition, offset))
        else:
            consumer.seek(self._tp(topic, partition), int(offset))

    def pause(self) -> None:
        consumer = self.connect()
        if hasattr(self._client, "Consumer"):  # confluent takes a list
            consumer.pause(list(consumer.assignment()))
        else:  # kafka-python takes *partitions
            consumer.pause(*consumer.assignment())
        self._paused = True

    def resume(self) -> None:
        consumer = self.connect()
        if hasattr(self._client, "Consumer"):
            consumer.resume(list(consumer.assignment()))
        else:
            consumer.resume(*consumer.assignment())
        self._paused = False

    @property
    def paused(self) -> bool:
        return self._paused
