"""Cluster-wide named transactions (backup coordination).

Port of ``pilosa_tpu/transaction.py``.

Reference: transaction.go — ``Transaction{ID, Active, Exclusive, Timeout,
Deadline}`` managed by ``TransactionManager`` (:56): non-exclusive
transactions are always active; an exclusive transaction becomes active
only when it is alone, and while an exclusive transaction exists (active
or pending) no new transaction may start. Deadlines expire transactions
lazily. Served at /transaction(s) endpoints (http_handler.go:528-533).
"""

from __future__ import annotations

import dataclasses
import uuid
from typing import Dict, List, Optional

from pilosa_tpu_torch.analysis import locktrace
from pilosa_tpu_torch.obs.metrics import (
    METRIC_EXCLUSIVE_TXN_REQUEST, METRIC_TXN_BLOCKED, METRIC_TXN_END,
    METRIC_TXN_START, REGISTRY, EpochClock)


class TransactionError(ValueError):
    pass


@dataclasses.dataclass
class Transaction:
    id: str
    active: bool
    exclusive: bool
    timeout_s: float
    deadline: float

    def to_json(self) -> dict:
        return {
            "id": self.id,
            "active": self.active,
            "exclusive": self.exclusive,
            "timeout": self.timeout_s,
            "deadline": self.deadline,
        }


class TransactionManager:
    """Reference: transaction.go:56 TransactionManager."""

    def __init__(self, default_timeout_s: float = 300.0, clock=None):
        self.default_timeout_s = default_timeout_s
        self._clock = clock or EpochClock()
        self._lock = locktrace.tracked_lock("transaction.manager")
        self._txs: Dict[str, Transaction] = {}
        # Cluster sync hook (reference: server.go:1082 — transaction
        # changes broadcast to peers so exclusive state excludes
        # cluster-wide). Called AFTER the local change, outside the lock
        # (the broadcast does HTTP). Set by ClusterNode; None standalone.
        self.on_change = None

    def _notify(self, action: str, tx: Transaction) -> None:
        if self.on_change is not None:
            self.on_change(action, tx)

    def apply_remote(self, action: str, tx_json: dict) -> None:
        """Mirror a peer's transaction change into the local manager
        (receive side of the broadcast sync). Never fires on_change —
        no re-broadcast loops."""
        with self._lock:
            if action == "start":
                self._txs[tx_json["id"]] = Transaction(
                    id=tx_json["id"],
                    active=bool(tx_json.get("active")),
                    exclusive=bool(tx_json.get("exclusive")),
                    timeout_s=float(tx_json.get("timeout")
                                    or self.default_timeout_s),
                    deadline=float(tx_json.get("deadline")
                                   or self._clock.now() + self.default_timeout_s),
                )
            elif action == "finish":
                self._txs.pop(tx_json.get("id"), None)
                self._activate_locked()
            else:
                raise TransactionError(
                    f"unknown transaction sync action {action!r}")

    def _expire_locked(self) -> None:
        now = self._clock.now()
        # pending exclusives expire too — otherwise an expired blocker
        # leaves them pending forever and the manager deadlocks
        for tid in [t.id for t in self._txs.values() if t.deadline < now]:
            del self._txs[tid]
        self._activate_locked()

    def _activate_locked(self) -> None:
        """A pending exclusive activates once it is alone (whether its
        blockers finished OR expired; reference: transaction.go Finish +
        deadline handling)."""
        exclusives = [t for t in self._txs.values() if t.exclusive]
        if len(self._txs) == 1 and exclusives and not exclusives[0].active:
            exclusives[0].active = True
            exclusives[0].deadline = (self._clock.now()
                                      + exclusives[0].timeout_s)

    def start(self, tid: Optional[str] = None, timeout_s: Optional[float] = None,
              exclusive: bool = False) -> Transaction:
        """Start (or report conflict). Mirrors transaction.go Start: while
        any exclusive transaction exists no other may start; an exclusive
        start with others present is accepted but pending
        (active=False)."""
        with self._lock:
            self._expire_locked()
            tid = tid or str(uuid.uuid4())
            if tid in self._txs:
                raise TransactionError(f"transaction {tid!r} already exists")
            if any(t.exclusive for t in self._txs.values()):
                REGISTRY.count(METRIC_TXN_BLOCKED)
                raise TransactionError(
                    "an exclusive transaction is in progress")
            timeout_s = timeout_s or self.default_timeout_s
            if exclusive:
                REGISTRY.count(METRIC_EXCLUSIVE_TXN_REQUEST)
            active = not exclusive or not self._txs
            tx = Transaction(id=tid, active=active, exclusive=exclusive,
                             timeout_s=timeout_s,
                             deadline=self._clock.now() + timeout_s)
            self._txs[tid] = tx
            REGISTRY.count(METRIC_TXN_START)
        self._notify("start", tx)
        return tx

    def finish(self, tid: str) -> Transaction:
        with self._lock:
            tx = self._txs.pop(tid, None)
            if tx is None:
                raise TransactionError(f"transaction {tid!r} not found")
            REGISTRY.count(METRIC_TXN_END)
            self._expire_locked()  # also activates a now-alone exclusive
        self._notify("finish", tx)
        return tx

    def get(self, tid: str) -> Transaction:
        with self._lock:
            self._expire_locked()
            tx = self._txs.get(tid)
            if tx is None:
                raise TransactionError(f"transaction {tid!r} not found")
            return tx

    def list(self) -> List[Transaction]:
        with self._lock:
            self._expire_locked()
            return sorted(self._txs.values(), key=lambda t: t.id)

    def exclusive_active(self) -> bool:
        with self._lock:
            self._expire_locked()
            return any(t.exclusive and t.active for t in self._txs.values())
