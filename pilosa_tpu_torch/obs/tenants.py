"""The tenant context the scheduler and the result cache read.

Port of the context half of ``pilosa_tpu/obs/tenants.py`` (``:50-91``):
the calling context's tenant rides a ``ContextVar``, so the scheduler's
fair-share admission and a tenant-scoped cache namespace see the tenant
of the request that submitted the work. ``TenantRegistry`` (accounting,
quotas, weights) and ``API.enable_tenants`` wait for the
distributed-planes slice.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

__all__ = ["DEFAULT_TENANT", "current_tenant_id", "set_current_tenant",
           "reset_current_tenant", "tenant_scope"]

DEFAULT_TENANT = "default"

_CURRENT: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "pilosa_tenant", default=None)

#: scopes entered since import — the disabled-path allocation proof
SCOPE_COUNT = 0


def current_tenant_id() -> Optional[str]:
    """The tenant the calling context acts as (None = no tenant plane
    touched this request)."""
    return _CURRENT.get()


def set_current_tenant(tenant_id: Optional[str]):
    """Low-level scope entry returning the reset token, for a caller
    whose enter and exit span a try/finally rather than a with."""
    global SCOPE_COUNT
    SCOPE_COUNT += 1
    return _CURRENT.set(tenant_id)


def reset_current_tenant(token) -> None:
    _CURRENT.reset(token)


@contextlib.contextmanager
def tenant_scope(tenant_id: Optional[str]):
    """All work inside the block is attributed to ``tenant_id``."""
    token = set_current_tenant(tenant_id)
    try:
        yield tenant_id
    finally:
        _CURRENT.reset(token)
