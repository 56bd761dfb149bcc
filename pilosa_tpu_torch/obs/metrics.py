"""Metrics registry with Prometheus text exposition.

Reference: metrics.go — the rebuild emits the same series names
(pql_queries_total, query_row_total, set_bit_total,
http_request_duration_seconds, ...) so dashboards written against the
reference keep working; served at /metrics (text) and /metrics.json
(http_handler.go:495-497).

Port of ``pilosa_tpu/obs/metrics.py``, whole: every series name and
bucket constant of the JAX package is kept letter for letter (bench.py
reads ``sched_batches_total`` and ``sched_superset_merges_total`` from
``as_json()["counters"]``), though the port's modules move only the
series of the layers it has ported.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

from pilosa_tpu_torch.analysis import locktrace

# Series names mirrored from the reference (metrics.go:7-57).
METRIC_CREATE_INDEX = "create_index_total"
METRIC_DELETE_INDEX = "delete_index_total"
METRIC_CREATE_FIELD = "create_field_total"
METRIC_DELETE_FIELD = "delete_field_total"
METRIC_SET_BIT = "set_bit_total"
METRIC_CLEAR_BIT = "clear_bit_total"
METRIC_IMPORTED = "imported_total"
METRIC_CLEARED = "cleared_total"
METRIC_PQL_QUERIES = "pql_queries_total"
METRIC_SQL_QUERIES = "sql_queries_total"
METRIC_MAX_SHARD = "maximum_shard"
METRIC_HTTP_DURATION = "http_request_duration_seconds"
METRIC_SNAPSHOT_DURATION = "snapshot_duration_seconds"
METRIC_TXN_START = "transaction_start"
METRIC_TXN_END = "transaction_end"
METRIC_TXN_BLOCKED = "transaction_blocked"
METRIC_EXCLUSIVE_TXN_REQUEST = "transaction_exclusive_request"
METRIC_EXCLUSIVE_TXN_ACTIVE = "transaction_exclusive_active"
METRIC_DELETE_DATAFRAME = "delete_dataframe"
# a stacked tensor could not shard over the engine mesh and fell back to
# single-device placement (misconfigured mesh loses all parallelism)
METRIC_MESH_FALLBACK = "mesh_sharding_fallback_total"
# rows received from peers by SQL subtree fanout (transfer accounting:
# asserts reduced streams, not whole tables, cross the wire)
METRIC_SQL_FANOUT_ROWS = "sql_fanout_rows_total"
# bitwise semi-join plane (sql/joins.py): star joins planned as
# dimension-bitmap broadcasts into one masked fact dispatch
METRIC_SQL_JOIN_QUERIES = "sql_join_queries_total"  # semi-join planned
# star joins that fell back to the host hash join (unsupported shape or
# PILOSA_TPU_SEMIJOIN=0)
METRIC_SQL_JOIN_FALLBACK = "sql_join_fallback_total"
# dimension row ids broadcast as fact-side filters (per dim leg)
METRIC_SQL_JOIN_DIM_ROWS = "sql_join_dim_rows_total"
# approximate serialized bytes of the broadcast in= lists (what a
# cluster fan-out leg carries on the wire per dimension)
METRIC_SQL_JOIN_BROADCAST_BYTES = "sql_join_broadcast_bytes_total"
# query scheduler (sched/): micro-batching health
METRIC_SCHED_QUEUE_DEPTH = "sched_queue_depth"
METRIC_SCHED_INFLIGHT = "sched_inflight"
METRIC_SCHED_BATCH_SIZE = "sched_batch_size"  # histogram
METRIC_SCHED_BATCH_WAIT = "sched_batch_wait_seconds"
METRIC_SCHED_DISPATCH = "sched_dispatch_seconds"
METRIC_SCHED_AMORTIZED_DISPATCH = "sched_amortized_dispatch_seconds"
METRIC_SCHED_REJECTED = "sched_rejected_total"
METRIC_SCHED_DEADLINE_MISS = "sched_deadline_missed_total"
METRIC_SCHED_BATCHES = "sched_batches_total"
METRIC_SCHED_QUERIES = "sched_queries_total"
# batch-size buckets: powers of two up to the default max_batch
BATCH_SIZE_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0)
# superset fusion (sched/ cross-shard-set merging): queries that rode a
# merged (padded/masked) dispatch, shard-set groups folded into another
# group's dispatch, and the padding-waste ratio |union| / max(|subset|)
# each merged dispatch paid for its amortization
METRIC_SCHED_FUSED_QUERIES = "sched_fused_queries_total"
METRIC_SCHED_SUPERSET_MERGES = "sched_superset_merges_total"
METRIC_SCHED_PADDING_WASTE = "sched_padding_waste_ratio"  # histogram
METRIC_SCHED_WINDOW_MS = "sched_window_ms"  # gauge (adaptive sizing)
# waste-ratio buckets: 1.0 = zero padding (identical sets); the default
# fuse-waste-ratio gate (2.0) sits mid-range so both admitted and
# hypothetical overflow land visibly
PADDING_WASTE_BUCKETS = (1.0, 1.25, 1.5, 2.0, 3.0, 4.0, 8.0)
# result cache (cache/): version-keyed read caching + single-flight
METRIC_CACHE_HITS = "cache_hits_total"
METRIC_CACHE_MISSES = "cache_misses_total"
METRIC_CACHE_BYPASS = "cache_bypass_total"
METRIC_CACHE_EVICTIONS = "cache_evictions_total"
METRIC_CACHE_SINGLEFLIGHT = "cache_singleflight_waits_total"
METRIC_CACHE_ENTRIES = "cache_entries"
METRIC_CACHE_BYTES = "cache_resident_bytes"
METRIC_CACHE_HIT_LATENCY = "cache_hit_seconds"  # histogram
METRIC_CACHE_DISPATCH_LATENCY = "cache_dispatch_seconds"  # histogram
# the bucket layout of the JAX package (whose TPU dispatch floor sat at
# tens of ms); one layout spans hits and dispatches so the two
# histograms compare directly
CACHE_LATENCY_BUCKETS = (0.0005, 0.001, 0.005, 0.01, 0.025, 0.05,
                         0.1, 0.25, 1.0)
# cluster fan-out resilience (cluster/resilience.py): hedged remote legs
# (launched / won the race), per-node breaker state (0=closed,
# 1=half-open, 2=open) + transition counts, adaptive-timeout reaps, and
# the per-leg latency distribution feeding the hedge percentile
METRIC_CLUSTER_HEDGES = "cluster_hedges_total"
METRIC_CLUSTER_HEDGE_WINS = "cluster_hedge_wins_total"
METRIC_CLUSTER_BREAKER_STATE = "cluster_breaker_state"
METRIC_CLUSTER_BREAKER_TRANSITIONS = "cluster_breaker_transitions_total"
METRIC_CLUSTER_LEG_TIMEOUTS = "cluster_leg_timeouts_total"
METRIC_CLUSTER_LEG_LATENCY = "cluster_leg_latency_ms"
# coalesced fan-out (cluster/batch.py): legs per batched node RPC
# (histogram — mean >> 1 is the amortization proof), batch RPCs sent,
# and per-leg failures delivered out of a batch demux (a per-query
# remote error or a whole-batch transport failure, labelled why=)
METRIC_CLUSTER_BATCH_SIZE = "cluster_batch_size"  # histogram
METRIC_CLUSTER_BATCHED_RPCS = "cluster_batched_rpcs_total"
METRIC_CLUSTER_BATCH_DEMUX_FAILURES = "cluster_batch_demux_failures_total"
# batch-size buckets: powers of two up to the default max_batch (32),
# with one decade above so oversized windows stay visible
CLUSTER_BATCH_SIZE_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0)
# loopback legs sit ~1-10ms; injected stragglers and WAN legs land in
# the upper decades
LEG_LATENCY_BUCKETS_MS = (1.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                          500.0, 1000.0, 2500.0, 5000.0)
# cluster metadata gossip (gossip/): anti-entropy rounds by outcome
# (ok / err / idle), delta entries shipped and applied, envelopes that
# rode existing RPC traffic, per-node state-table gauges, how old an
# applied delta was when it landed (the convergence/staleness read), and
# breakers pre-warmed from a peer's observed transitions
METRIC_GOSSIP_ROUNDS = "gossip_rounds_total"
METRIC_GOSSIP_DELTAS_SENT = "gossip_deltas_sent_total"
METRIC_GOSSIP_DELTAS_APPLIED = "gossip_deltas_applied_total"
METRIC_GOSSIP_PIGGYBACKS = "gossip_piggybacks_total"
METRIC_GOSSIP_ENTRIES = "gossip_entries"
METRIC_GOSSIP_ORIGINS = "gossip_known_origins"
METRIC_GOSSIP_ROUND_MS = "gossip_round_ms"  # histogram
METRIC_GOSSIP_STALENESS_MS = "gossip_apply_staleness_ms"  # histogram
METRIC_GOSSIP_BREAKER_PREWARMS = "gossip_breaker_prewarms_total"
# SWIM membership (gossip/membership.py): per-node merged status gauge
# (0=alive 1=suspect 2=down), status transitions by target node and new
# status, probe outcomes (ok / fail), and self-refutations (incarnation
# bumps answering a false suspicion)
METRIC_MEMBERSHIP_STATUS = "membership_status"
METRIC_MEMBERSHIP_TRANSITIONS = "membership_transitions_total"
METRIC_MEMBERSHIP_PINGS = "membership_pings_total"
METRIC_MEMBERSHIP_REFUTATIONS = "membership_refutations_total"
# a loopback anti-entropy round is a couple of HTTP exchanges (~1-10ms);
# staleness spans one piggyback hop up to several missed rounds
GOSSIP_ROUND_BUCKETS_MS = (0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
                           100.0, 250.0)
GOSSIP_STALENESS_BUCKETS_MS = (1.0, 5.0, 10.0, 25.0, 50.0, 100.0,
                               250.0, 1000.0, 5000.0)
# crash-consistent recovery plane (storage/recovery.py): WAL records and
# bytes replayed on open or during catch-up, fuzzy-checkpoint duration
# (summary), segments pruned below the checkpoint LSN, shards repaired
# by snapshot+tail shipping, writes queued while a node caught up, and
# the wall-clock lag of each catch-up run
METRIC_RECOVERY_REPLAY_RECORDS = "recovery_replay_records_total"
METRIC_RECOVERY_REPLAY_BYTES = "recovery_replay_bytes_total"
METRIC_RECOVERY_CHECKPOINT_SECONDS = "recovery_checkpoint_seconds"
METRIC_RECOVERY_SEGMENTS_PRUNED = "recovery_wal_segments_pruned_total"
METRIC_RECOVERY_CATCHUP_SHARDS = "recovery_catchup_shards_total"
METRIC_RECOVERY_CATCHUP_QUEUED = "recovery_catchup_queued_writes_total"
METRIC_RECOVERY_CATCHUP_LAG_MS = "recovery_catchup_lag_ms"  # histogram
# a loopback snapshot+tail round trip is a few ms; WAN catch-up of a
# fat tail spans seconds
RECOVERY_CATCHUP_LAG_BUCKETS_MS = (1.0, 5.0, 10.0, 50.0, 100.0, 500.0,
                                   1000.0, 5000.0, 30000.0)
# distributed tracing (obs/tracing.py): sampled roots started/finished,
# roots skipped by head sampling, remote spans adopted from a peer's
# traceparent, trace-store evictions, root-trace wall time and per-stage
# latencies (labelled stage=<span name> — the dispatch-floor breakdown)
METRIC_TRACE_STARTED = "trace_started_total"
METRIC_TRACE_FINISHED = "trace_finished_total"
METRIC_TRACE_UNSAMPLED = "trace_unsampled_total"
METRIC_TRACE_REMOTE_SPANS = "trace_remote_spans_total"
METRIC_TRACE_STORE_DROPPED = "trace_store_dropped_total"
METRIC_TRACE_SLOW_QUERIES = "trace_slow_queries_total"
METRIC_TRACE_DURATION = "trace_duration_ms"  # histogram
METRIC_TRACE_STAGE_LATENCY = "trace_stage_latency_ms"  # histogram
# sub-ms cache hits up through slow dispatches and remote fan-outs —
# one layout for both the root and per-stage histograms so
# a stage's share of the root is readable bucket-for-bucket
TRACE_DURATION_BUCKETS_MS = (0.5, 1.0, 5.0, 10.0, 25.0, 50.0, 100.0,
                             250.0, 500.0, 1000.0, 5000.0)
# device-residency plane (core/stacked.py): bytes of stacked fragment
# planes pinned in HBM under the DeviceBudget, resident stacks evicted
# to make room (each eviction means a future query pays stack.build +
# device.h2d_copy again), and queries served entirely from resident
# device planes (the warm path the dispatch-floor work exists for)
METRIC_DEVICE_HBM_RESIDENT_BYTES = "device_hbm_resident_bytes"
METRIC_DEVICE_STACK_EVICTIONS = "device_stack_evictions_total"
METRIC_DEVICE_RESIDENT_HITS = "device_resident_hits_total"
# DeviceBudget's own accounting exported directly (same numbers the LRU
# enforces): bytes currently charged against the HBM cap, and entries it
# has evicted to stay under it
METRIC_DEVICE_BUDGET_RESIDENT_BYTES = "device_budget_resident_bytes"
METRIC_DEVICE_BUDGET_EVICTIONS = "device_budget_evictions_total"
# compressed-residency plane (ops/ctiles.py): blocks stored in
# compressed-tile form (labelled kind=set|bsi), blocks kept dense and
# why (disabled is never ticked — the kill switch costs nothing),
# cumulative dense-vs-stored bytes (the corpus-level compression win),
# the last block's dense/stored ratio, and zero/run tiles skipped by
# compressed scans instead of being read
METRIC_COMPRESS_BLOCKS = "device_compress_blocks_total"
METRIC_COMPRESS_FALLBACK = "device_compress_fallback_total"
METRIC_COMPRESS_DENSE_BYTES = "device_compress_dense_bytes_total"
METRIC_COMPRESS_STORED_BYTES = "device_compress_stored_bytes_total"
METRIC_COMPRESS_RATIO = "device_compress_ratio"
METRIC_COMPRESS_TILES_SKIPPED = "device_compress_tiles_skipped_total"
# cluster health plane (obs/timeline.py + slo.py + flight.py): samples
# appended to the in-memory timeline ring, per-objective error-budget
# burn rate over the fast/slow windows (gauge {slo=,window=}), and
# diagnostic bundles the flight recorder captured (labelled trigger=)
METRIC_TIMELINE_SAMPLES = "timeline_samples_total"
METRIC_SLO_BURN_RATE = "slo_burn_rate"
METRIC_FLIGHT_BUNDLES = "flight_bundles_total"
# graceful-degradation control plane (sched/degrade.py): current ladder
# level as a gauge (0=normal 1=shed_batch 2=brownout 3=saturated),
# hysteresis-bounded transitions (labelled from=/to=/reason=), work shed
# by the ladder (labelled priority=/level= — rides on top of the
# per-reason sched_rejected_total series), and result-cache entries
# served past their version fingerprint during brownout (every one is
# tagged stale=true on the response). PILOSA_TPU_DEGRADE=0 ticks none.
METRIC_DEGRADE_STATE = "degrade_state"
METRIC_DEGRADE_TRANSITIONS = "degrade_transitions_total"
METRIC_DEGRADE_SHED = "degrade_shed_total"
METRIC_CACHE_STALE_SERVES = "cache_stale_serves_total"
# kernel performance attribution plane (obs/devprof.py): the analytic
# FLOP/byte cost model over the compiled op tapes. Counters accumulate
# per-family dispatches / device seconds / bit-op FLOPs / HBM bytes
# (labelled family=<tape signature>); the gauges are the derived
# achieved-vs-peak reads (MFU as a percentage of the backend peak table,
# achieved GB/s); the histogram is per-dispatch device time with trace
# exemplars; h2d_* account every platform.h2d_copy byte
METRIC_KERNEL_DISPATCHES = "device_kernel_dispatches_total"
METRIC_KERNEL_DEVICE_SECONDS = "device_kernel_device_seconds_total"
METRIC_KERNEL_FLOPS = "device_kernel_flops_total"
METRIC_KERNEL_HBM_BYTES = "device_kernel_hbm_bytes_total"
METRIC_KERNEL_MFU_PCT = "device_kernel_mfu_pct"
METRIC_KERNEL_GBPS = "device_kernel_achieved_gbps"
METRIC_KERNEL_DISPATCH_US = "device_kernel_dispatch_us"  # histogram
METRIC_KERNEL_H2D_BYTES = "device_kernel_h2d_bytes_total"
METRIC_KERNEL_H2D_SECONDS = "device_kernel_h2d_seconds_total"
# Pallas L0 kernel plane (ops/pallas_util.py): successful MXU/VPU
# kernel dispatches per kernel family, and counted fallbacks to the
# classic XLA path labelled with why (failures|tracer|shape|interpret|
# backend|error|mesh) — silent per-call degradation shows up on the
# timeline instead
# of a debug log. The PILOSA_TPU_PALLAS=0 kill switch ticks neither.
METRIC_OPS_PALLAS_DISPATCH = "ops_pallas_dispatch_total"
METRIC_OPS_PALLAS_FALLBACK = "ops_pallas_fallback_total"
# a warm compiled-tape dispatch is tens of µs of launch overhead on CPU
# up through multi-ms sharded collectives; cold paths land in the tail
KERNEL_DISPATCH_BUCKETS_US = (50.0, 100.0, 250.0, 500.0, 1000.0,
                              2500.0, 5000.0, 10000.0, 25000.0,
                              100000.0, 500000.0)
# ingest stage accounting (ingest/ + storage/wal.py via obs/devprof.py):
# per-stage wall seconds / rows / bytes counters and the derived
# cumulative rows-per-s / bytes-per-s gauges, labelled
# stage=parse|key_translate|h2d_copy|fragment_advance|wal_commit — the
# overlap work reads these to see which stage hides which
METRIC_INGEST_STAGE_SECONDS = "ingest_stage_seconds_total"
METRIC_INGEST_STAGE_ROWS = "ingest_stage_rows_total"
METRIC_INGEST_STAGE_BYTES = "ingest_stage_bytes_total"
METRIC_INGEST_STAGE_ROWS_PER_S = "ingest_stage_rows_per_s"
METRIC_INGEST_STAGE_BYTES_PER_S = "ingest_stage_bytes_per_s"
# streaming ingest plane (stream/): rows/batches through the pipelined
# path, hand-off credits + consumer lag gauges, shed device-stage
# admissions (backpressure retries), and push-endpoint 429 rejections
METRIC_STREAM_ROWS = "stream_ingest_rows_total"
METRIC_STREAM_BATCHES = "stream_ingest_batches_total"
METRIC_STREAM_CREDITS = "stream_pipeline_credits"
METRIC_STREAM_LAG = "stream_consumer_lag"
METRIC_STREAM_SHED = "stream_ingest_shed_total"
METRIC_STREAM_REJECTED = "stream_push_rejected_total"
# tenant attribution plane (obs/tenants.py): per-tenant consumption
# counters published as gauges by the bounded registry (a top-K label
# guard keeps the label space finite no matter how many tenant IDs
# arrive), quota rejections, and the unattributed-request counter that
# satellite 3's never-a-400 clamping contract feeds
METRIC_TENANT_QUERIES = "tenant_queries_total"
METRIC_TENANT_ERRORS = "tenant_errors_total"
METRIC_TENANT_REJECTED = "tenant_rejected_total"
METRIC_TENANT_ROWS = "tenant_rows_ingested_total"
METRIC_TENANT_DEVICE_SECONDS = "tenant_device_seconds_total"
METRIC_TENANT_CACHE_HITS = "tenant_cache_hits_total"
METRIC_TENANT_CACHE_BYTES = "tenant_cache_bytes_total"
METRIC_TENANT_WAL_BYTES = "tenant_wal_bytes_total"
METRIC_TENANT_UNATTRIBUTED = "tenant_unattributed_total"
METRIC_TENANT_TRACKED = "tenant_tracked"
# concurrency-correctness plane (analysis/locktrace.py): lock-order
# cycles, locks held across device dispatch, and locks held across
# blocking socket I/O observed by the tracer (labelled kind=), counted
# only while PILOSA_TPU_LOCKCHECK is on
METRIC_LOCK_VIOLATIONS = "lock_order_violations_total"
# elastic serverless plane (dax/): directive version + seconds since the
# last bump (staleness read), pushes by method/outcome, diff-gap FULL
# resyncs, group-commit writelog fsync latency, writelog ops replayed on
# warm handoff + the replay wall time, autoscaler decisions (labelled
# direction=up|down), and stacked planes built by directive prewarm
METRIC_DAX_DIRECTIVE_VERSION = "dax_directive_version"
METRIC_DAX_DIRECTIVE_AGE = "dax_directive_age_seconds"
METRIC_DAX_DIRECTIVE_PUSHES = "dax_directive_pushes_total"
METRIC_DAX_FULL_RESYNCS = "dax_full_resyncs_total"
METRIC_DAX_WL_APPEND_SECONDS = "dax_wl_append_seconds"  # histogram
METRIC_DAX_REPLAY_OPS = "dax_replay_ops_total"
METRIC_DAX_REPLAY_SECONDS = "dax_replay_seconds"  # histogram
METRIC_DAX_AUTOSCALE_EVENTS = "dax_autoscale_events_total"
METRIC_DAX_PREWARM_STACKS = "dax_prewarm_stacks_total"
# a group-commit fsync on local disk is sub-ms; shared-FS tail latencies
# reach tens of ms
DAX_WL_APPEND_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
                         0.05, 0.1, 0.25)
# replaying a short tail after snapshot install is ms-scale; a cold log
# with no snapshot spans seconds
DAX_REPLAY_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0)

_Key = Tuple[str, Tuple[Tuple[str, str], ...]]

# Exemplar source, set by obs.tracing at import (metrics must not import
# tracing — the dependency runs the other way): returns the active
# sampled trace ID or None. Registries opt in per-instance (`exemplars`);
# the hook alone records nothing.
_EXEMPLAR_PROVIDER = None


def set_exemplar_provider(fn) -> None:
    """Install the callable `observe_bucketed` asks for the active trace
    ID (``() -> Optional[str]``). Pass None to detach."""
    global _EXEMPLAR_PROVIDER
    _EXEMPLAR_PROVIDER = fn


class EpochClock:
    """Injectable wall clock for exemplar timestamps: ``now()`` is Unix
    epoch seconds. Distinct from ``timeline.WallClock`` (monotonic, for
    intervals) — exemplar timestamps must be real dates because the
    OpenMetrics line carries them to Grafana. The ``*Clock`` suffix is
    the linter's marker that raw ``time.time()`` lives here on purpose."""

    def now(self) -> float:
        return time.time()


class MetricsRegistry:
    """Thread-safe counters/gauges/summaries (a summary keeps _count and
    _sum, enough for rate+mean dashboards; the reference's prometheus
    client keeps quantiles we don't need for parity of names)."""

    def __init__(self, namespace: str = "pilosa",
                 exemplars: bool = False, clock=None):
        self.namespace = namespace
        self.exemplars = exemplars
        self._clock = clock or EpochClock()
        self._lock = locktrace.tracked_lock("obs.metrics.registry")
        self._counters: Dict[_Key, float] = {}
        self._gauges: Dict[_Key, float] = {}
        self._summaries: Dict[_Key, Tuple[int, float]] = {}
        # histogram: [buckets, per-bucket counts (+overflow), sum, count]
        self._histograms: Dict[_Key, list] = {}
        # per-series latest exemplar per bucket index:
        # {series_key: {bucket_idx: (trace_id, value, unix_ts)}}
        self._exemplars: Dict[_Key, Dict[int, Tuple[str, float, float]]] = {}

    @staticmethod
    def _key(name: str, labels: Optional[dict]) -> _Key:
        return name, tuple(sorted((labels or {}).items()))

    def count(self, name: str, n: float = 1, **labels) -> None:
        k = self._key(name, labels)
        with self._lock:
            self._counters[k] = self._counters.get(k, 0) + n

    def gauge(self, name: str, value: float, **labels) -> None:
        with self._lock:
            self._gauges[self._key(name, labels)] = value

    def observe(self, name: str, seconds: float, **labels) -> None:
        k = self._key(name, labels)
        with self._lock:
            c, s = self._summaries.get(k, (0, 0.0))
            self._summaries[k] = (c + 1, s + seconds)

    def observe_bucketed(self, name: str, value: float,
                         buckets: Tuple[float, ...],
                         exemplar_trace_id: Optional[str] = None,
                         **labels) -> None:
        """Histogram observation with explicit upper bounds (Prometheus
        ``le`` semantics: a value lands in the first bucket whose bound
        is >= value; beyond the last bound it only counts toward +Inf).
        The bucket layout is fixed by the first observation of a series.

        ``exemplar_trace_id`` pins the exemplar for call sites that run
        outside the span scope (the tracer's finish hooks observe the
        duration histograms AFTER the contextvar is reset); otherwise
        the registered provider supplies the active trace ID."""
        import bisect

        k = self._key(name, labels)
        with self._lock:
            h = self._histograms.get(k)
            if h is None:
                bs = tuple(sorted(float(b) for b in buckets))
                h = [bs, [0] * (len(bs) + 1), 0.0, 0]
                self._histograms[k] = h
            idx = bisect.bisect_left(h[0], value)
            h[1][idx] += 1
            h[2] += value
            h[3] += 1
            if self.exemplars:
                tid = exemplar_trace_id
                if tid is None and _EXEMPLAR_PROVIDER is not None:
                    tid = _EXEMPLAR_PROVIDER()
                if tid:
                    self._exemplars.setdefault(k, {})[idx] = (
                        tid, value, self._clock.now())

    def histogram(self, name: str, **labels) -> Optional[dict]:
        """Snapshot of one histogram series (None if never observed)."""
        with self._lock:
            h = self._histograms.get(self._key(name, labels))
            if h is None:
                return None
            return {"buckets": dict(zip(h[0], h[1])), "sum": h[2],
                    "count": h[3]}

    def timer(self, name: str, **labels):
        """Context manager observing wall time into a summary."""
        reg = self

        class _T:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                reg.observe(name, time.perf_counter() - self.t0, **labels)

        return _T()

    def value(self, name: str, **labels) -> float:
        """Counter or gauge value (a name is one kind — counters take
        precedence if ever misused for both); for summaries use
        ``summary()``."""
        k = self._key(name, labels)
        with self._lock:
            if k in self._counters:
                return self._counters[k]
            return self._gauges.get(k, 0.0)

    def summary(self, name: str, **labels) -> Tuple[int, float]:
        """(observation count, seconds sum) of a summary series."""
        with self._lock:
            return self._summaries.get(self._key(name, labels), (0, 0.0))

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._summaries.clear()
            self._histograms.clear()
            self._exemplars.clear()

    def snapshot(self) -> dict:
        """One consistent point-in-time copy of every series, keyed by
        formatted series name — what the timeline sampler diffs between
        cadence ticks (counters -> rates, histograms -> quantiles)."""
        with self._lock:
            return {
                "counters": {f"{n}{self._fmt_labels(l)}": v
                             for (n, l), v in self._counters.items()},
                "gauges": {f"{n}{self._fmt_labels(l)}": v
                           for (n, l), v in self._gauges.items()},
                "histograms": {
                    f"{n}{self._fmt_labels(l)}": {
                        "bounds": list(h[0]), "counts": list(h[1]),
                        "sum": h[2], "count": h[3],
                    }
                    for (n, l), h in self._histograms.items()
                },
            }

    # -- exposition --------------------------------------------------------

    @staticmethod
    def _escape_label_value(v) -> str:
        # Prometheus text-format spec: label values escape backslash,
        # double-quote, and line-feed (query text and error strings
        # routinely contain all three)
        return (str(v).replace("\\", "\\\\").replace('"', '\\"')
                .replace("\n", "\\n"))

    def _fmt_labels(self, labels: Tuple[Tuple[str, str], ...]) -> str:
        if not labels:
            return ""
        inner = ",".join(f'{k}="{self._escape_label_value(v)}"'
                         for k, v in labels)
        return "{" + inner + "}"

    def prometheus_text(self) -> str:
        """Text exposition format (served at /metrics, reference:
        http_handler.go:495)."""
        out: List[str] = []
        ns = self.namespace
        with self._lock:
            for (name, labels), v in sorted(self._counters.items()):
                out.append(f"# TYPE {ns}_{name} counter")
                out.append(f"{ns}_{name}{self._fmt_labels(labels)} {v}")
            for (name, labels), v in sorted(self._gauges.items()):
                out.append(f"# TYPE {ns}_{name} gauge")
                out.append(f"{ns}_{name}{self._fmt_labels(labels)} {v}")
            for (name, labels), (c, s) in sorted(self._summaries.items()):
                out.append(f"# TYPE {ns}_{name} summary")
                lbl = self._fmt_labels(labels)
                out.append(f"{ns}_{name}_count{lbl} {c}")
                out.append(f"{ns}_{name}_sum{lbl} {s}")
            for (name, labels), h in sorted(self._histograms.items()):
                out.append(f"# TYPE {ns}_{name} histogram")
                bs, counts, total, n = h
                ex = self._exemplars.get((name, labels), {})
                cum = 0
                for i, (ub, c) in enumerate(zip(bs, counts)):
                    cum += c
                    lbl = self._fmt_labels(labels + (("le", f"{ub:g}"),))
                    line = f"{ns}_{name}_bucket{lbl} {cum}"
                    if self.exemplars and i in ex:
                        tid, val, ts = ex[i]
                        # OpenMetrics exemplar: links this bucket to the
                        # trace that landed in it (/internal/traces/{id})
                        line += (f' # {{trace_id="{tid}"}} {val:g}'
                                 f" {ts:.3f}")
                    out.append(line)
                lbl = self._fmt_labels(labels + (("le", "+Inf"),))
                line = f"{ns}_{name}_bucket{lbl} {n}"
                if self.exemplars and len(bs) in ex:
                    tid, val, ts = ex[len(bs)]
                    line += f' # {{trace_id="{tid}"}} {val:g} {ts:.3f}'
                out.append(line)
                lbl = self._fmt_labels(labels)
                out.append(f"{ns}_{name}_sum{lbl} {total}")
                out.append(f"{ns}_{name}_count{lbl} {n}")
        return "\n".join(out) + "\n"

    def as_json(self) -> dict:
        with self._lock:
            def enc(d):
                return {f"{n}{self._fmt_labels(l)}": v for (n, l), v in d.items()}
            return {
                "counters": enc(self._counters),
                "gauges": enc(self._gauges),
                "summaries": {
                    f"{n}{self._fmt_labels(l)}": {"count": c, "sum": s}
                    for (n, l), (c, s) in self._summaries.items()
                },
                "histograms": {
                    f"{n}{self._fmt_labels(l)}": {
                        "buckets": {f"{ub:g}": c
                                    for ub, c in zip(h[0], h[1])},
                        "overflow": h[1][-1], "sum": h[2], "count": h[3],
                    }
                    for (n, l), h in self._histograms.items()
                },
            }


REGISTRY = MetricsRegistry()
