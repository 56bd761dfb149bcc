"""Operator command implementations behind the ``pilosa-tpu`` CLI.

Reference: ctl/ (cobra command impls: server, backup, restore, import,
export, chksum, generate-config) dispatched from cmd/root.go.
"""

from pilosa_tpu_torch.ctl.cli import main

__all__ = ["main"]
