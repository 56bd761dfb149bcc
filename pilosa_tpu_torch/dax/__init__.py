"""DAX analog: the serverless/elastic deployment mode.

Reference: dax/ (18.9k LoC) — Controller pushes Directives assigning
shards to stateless Computer nodes; Writelogger (append-only op logs on
shared FS) is the durability story, Snapshotter compacts; the Queryer is
a stateless front-end that asks the Controller for topology instead of
etcd. Mapping here (reusing the classic-cluster machinery):

- Controller  -> dax/controller.py (registry + sticky balancer + poller)
- Directive   -> dax/directive.py (full/diff/reset; schema + assignment)
- Computer    -> dax/computer.py (stateless API wrapper; WL-then-apply
                 writes; loads shards from snapshot + log replay)
- Writelogger/Snapshotter -> dax/storage.py (shared-FS dir)
- Queryer     -> dax/queryer.py (ClusterExecutor over a controller-fed
                 topology — the reference's orchestrator is likewise a
                 fork of the executor's plan walk, dax/queryer/orchestrator.go:83)

Port of ``pilosa_tpu/dax/``: the same classes, wire form and on-disk
bytes; every entry point takes ``device`` (``cuda:0`` unless the caller
asks for the CPU). No classic path imports this package.
"""

from pilosa_tpu_torch.dax.controller import Controller
from pilosa_tpu_torch.dax.computer import Computer
from pilosa_tpu_torch.dax.directive import Directive
from pilosa_tpu_torch.dax.queryer import Queryer
from pilosa_tpu_torch.dax.storage import Snapshotter, WriteLogger

__all__ = ["Controller", "Computer", "Directive", "Queryer",
           "Snapshotter", "WriteLogger"]
