"""Observability of the port: the metrics registry (:mod:`.metrics`),
spans and traces (:mod:`.tracing`) and the tenant context
(:mod:`.tenants`) that the scheduler and the result cache read. The
device profiler, query history, logger and health plane wait for the
observability slice."""
