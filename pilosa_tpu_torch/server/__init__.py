"""HTTP serving layer (reference: http_handler.go + server/)."""

from pilosa_tpu_torch.server.http import Handler, serve

__all__ = ["Handler", "serve"]
