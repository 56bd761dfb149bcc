"""Card measurements that PERF.md quotes; not part of the port's runtime."""
