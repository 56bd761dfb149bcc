"""Ingest kit: batch importer, record sources, ingester driver, auto-ID.

Port of ``pilosa_tpu/ingest``. Reference: batch/ (client-side columnar
batcher, batch/batch.go:99), idk/ (ingester framework: Source iface
idk/interfaces.go, Main driver idk/ingest.go:59), idalloc.go
(crash-safe ID reservation).
"""

from pilosa_tpu_torch.ingest.batch import Batch
from pilosa_tpu_torch.ingest.idalloc import IDAllocator
from pilosa_tpu_torch.ingest.source import CSVSource, ListSource, Record, Source
from pilosa_tpu_torch.ingest.ingest import Ingester

__all__ = ["Batch", "IDAllocator", "CSVSource", "ListSource", "Record",
           "Source", "Ingester"]
