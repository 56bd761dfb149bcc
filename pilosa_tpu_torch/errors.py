"""Shared error types, importable by the executor and its lowering
without cycles."""


class PQLError(ValueError):
    """A query the engine rejects: malformed, or not ported yet."""


def not_ported(what: str) -> PQLError:
    return PQLError(f"not ported yet: {what}")
