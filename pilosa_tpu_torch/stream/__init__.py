"""Streaming ingest subsystem: in-process Kafka-shaped broker, the
two-stage pipelined ingester with exactly-once WAL offsets, and the
service facade ``API.enable_stream`` wires. Port of
``pilosa_tpu/stream``."""

from pilosa_tpu_torch.stream.broker import (CHUNK_KEY, BrokerConsumer,
                                            BrokerSource, StreamBroker,
                                            StreamConsumer, StreamRecord,
                                            chunk_columns, iter_rows,
                                            make_chunk, split_tp, tp_key)
from pilosa_tpu_torch.stream.pipeline import (PipelinedIngester,
                                              PreparedBatch, StreamService)

__all__ = [
    "BrokerConsumer",
    "BrokerSource",
    "CHUNK_KEY",
    "PipelinedIngester",
    "PreparedBatch",
    "StreamBroker",
    "StreamConsumer",
    "StreamRecord",
    "StreamService",
    "chunk_columns",
    "iter_rows",
    "make_chunk",
    "split_tp",
    "tp_key",
]
