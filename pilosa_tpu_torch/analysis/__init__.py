"""Concurrency checks of the port: :mod:`.locktrace`, the lock-order
graph that the scheduler, the result cache, the holder's write lock and
the stacks' locks feed when tracing is on. The static lint half waits
for the analysis slice."""
