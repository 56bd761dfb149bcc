"""Observability of the port: the metrics registry (:mod:`.metrics`),
spans and traces (:mod:`.tracing`) and the tenant context
(:mod:`.tenants`) that the scheduler and the result cache read, the
query-history ring (:mod:`.history`) and the query logger
(:mod:`.logger`). The device profiler and the health plane wait for the
observability slice."""
