"""Shared error types, importable by the executor and its lowering
without cycles."""


class PQLError(ValueError):
    """A query the engine rejects: malformed, or not ported yet."""


def not_ported(what: str) -> PQLError:
    return PQLError(f"not ported yet: {what}")


class ClusterStateError(RuntimeError):
    """Operation not allowed in the current cluster state (reference:
    api.go:160-187 validAPIMethods gating). Maps to HTTP 412."""


class AdmissionError(RuntimeError):
    """Query rejected at admission: the scheduler queue is full, the
    scheduler is closed, or the degradation ladder is shedding. Maps to
    HTTP 429 — shed load under overload instead of queueing unboundedly.
    ``retry_after_s``, when set, is surfaced as a Retry-After header;
    scheduler sheds derive it from the live adaptive arrival window so
    clients back off for roughly one queue-drain instead of blind."""

    def __init__(self, message: str = "", retry_after_s=None):
        super().__init__(message)
        if retry_after_s is not None:
            self.retry_after_s = retry_after_s


class QueryDeadlineError(RuntimeError):
    """Query missed its deadline (or was cancelled) while queued.
    Maps to HTTP 408."""


class QuotaExceededError(AdmissionError):
    """A tenant exhausted one of its token-bucket quotas (QPS, ingest
    rows/s). Subclasses AdmissionError so it rides the existing 429
    mapping; ``retry_after_s`` is surfaced as a Retry-After header."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = retry_after_s
