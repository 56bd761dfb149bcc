"""Holder: root container owning all indexes, in memory.

Port of ``pilosa_tpu/core/holder.py`` without persistence: no schema
file, no WAL, no checkpoint (durability waits for a later slice). The
holder fixes the device every index of it runs on.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import torch

from pilosa_tpu_torch.core.index import Index
from pilosa_tpu_torch.core.schema import IndexOptions


class Holder:
    def __init__(self, device: torch.device):
        self.device = device
        # serializes writes against each other and against stack builds;
        # reads never take it (core/stacked.py)
        self.write_lock = threading.RLock()
        self.indexes: Dict[str, Index] = {}

    def create_index(self, name: str,
                     options: Optional[IndexOptions] = None) -> Index:
        if name in self.indexes:
            raise ValueError(f"index {name!r} already exists")
        idx = Index(name, self.device, options, lock=self.write_lock)
        self.indexes[name] = idx
        return idx

    def index(self, name: str) -> Index:
        idx = self.indexes.get(name)
        if idx is None:
            raise KeyError(f"index {name!r} not found")
        return idx
