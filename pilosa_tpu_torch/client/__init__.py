"""Standalone client library (reference: client/ — Client + ORM query
builder + shard-aware importer)."""

from pilosa_tpu_torch.client.client import Client
from pilosa_tpu_torch.client.orm import Schema

__all__ = ["Client", "Schema"]
