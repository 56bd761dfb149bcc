"""Broadcast bus: schema and status changes pushed to every peer.

Port of ``pilosa_tpu/cluster/broadcast.py`` (reference: broadcast.go:30,
the broadcaster interface; :55-77, the message types; messages POSTed to
/internal/cluster/message, http_handler.go:552, and received at
server.go:995). Messages are JSON dicts with a "type" tag, carried by the
InternalClient. NopBroadcaster mirrors broadcast.go:19 for one node.
``GossipBroadcaster`` comes with the gossip plane.
"""
from __future__ import annotations

from typing import Callable, Dict, List


# Message types (reference: broadcast.go:55-77 messageType* values).
MSG_CREATE_INDEX = "create-index"
MSG_DELETE_INDEX = "delete-index"
MSG_CREATE_FIELD = "create-field"
MSG_DELETE_FIELD = "delete-field"
MSG_AVAILABLE_SHARDS = "available-shards"
MSG_CREATE_VIEW = "create-view"
MSG_DELETE_VIEW = "delete-view"
MSG_UPDATE_FIELD = "update-field"
MSG_NODE_STATE = "node-state"
MSG_RECALCULATE_CACHES = "recalculate-caches"
MSG_NODE_STATUS = "node-status"
MSG_TRANSACTION = "transaction"


class Broadcaster:
    """send_sync: schema-critical, all peers must ack; send_async:
    best-effort; send_to: one peer (reference: server.go:1109-1152)."""

    def send_sync(self, msg: Dict) -> None:
        raise NotImplementedError

    def send_async(self, msg: Dict) -> None:
        raise NotImplementedError

    def send_to(self, msg: Dict, node) -> None:
        raise NotImplementedError


class NopBroadcaster(Broadcaster):
    """Reference: broadcast.go:19 NopBroadcaster."""

    def send_sync(self, msg: Dict) -> None:
        pass

    def send_async(self, msg: Dict) -> None:
        pass

    def send_to(self, msg: Dict, node) -> None:
        pass


class HTTPBroadcaster(Broadcaster):
    """Fan the message out to every *other* node over the internal RPC
    client. ``nodes_fn`` returns the current peer list; ``self_id``
    excludes the local node (the reference does the same split in
    server.go:1109 SendSync)."""

    def __init__(self, client, nodes_fn: Callable[[], List], self_id: str):
        self._client = client
        self._nodes_fn = nodes_fn
        self._self_id = self_id

    def _peers(self) -> List:
        return [n for n in self._nodes_fn() if n.id != self._self_id]

    def send_sync(self, msg: Dict) -> None:
        errors = []
        for node in self._peers():
            try:
                self._client.send_message(node, msg)
            except Exception as e:  # collect; schema must reach all live peers
                errors.append((node.id, e))
        if errors:
            raise RuntimeError(f"broadcast failed to {errors!r}")

    def send_async(self, msg: Dict) -> None:
        for node in self._peers():
            try:
                self._client.send_message(node, msg)
            except Exception:
                pass

    def send_to(self, msg: Dict, node) -> None:
        self._client.send_message(node, msg)


def apply_message(api, msg: Dict) -> None:
    """Apply a received broadcast to the local holder (reference:
    server.go:995 receiveMessage switch)."""
    t = msg.get("type")
    if t == MSG_CREATE_INDEX:
        api.ensure_index(msg["index"], msg.get("options"))
    elif t == MSG_DELETE_INDEX:
        try:
            api.delete_index(msg["index"], broadcast=False)
        except KeyError:
            pass
    elif t == MSG_CREATE_FIELD:
        api.ensure_field(msg["index"], msg["field"], msg.get("options"))
    elif t == MSG_DELETE_FIELD:
        try:
            api.delete_field(msg["index"], msg["field"], broadcast=False)
        except KeyError:
            pass
    elif t == MSG_RECALCULATE_CACHES:
        pass  # rank caches recalc lazily in this engine
    elif t in (MSG_NODE_STATE, MSG_NODE_STATUS, MSG_TRANSACTION,
               MSG_CREATE_VIEW, MSG_DELETE_VIEW, MSG_UPDATE_FIELD):
        pass  # informational for now
    else:
        raise ValueError(f"unknown broadcast message type {t!r}")
