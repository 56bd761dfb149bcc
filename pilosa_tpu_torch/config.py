"""Configuration of the serving layer: defaults <- TOML <- env <- flags.

Port of ``pilosa_tpu/config.py`` (reference: server/config.go:51, bound
through viper/pflag with PILOSA_* env, ctl/server.go:160
BuildServerFlags, ``featurebase generate-config``). Same layering with
the stdlib: tomllib for files, PILOSA_TPU_* env vars, flag dicts — the
last source wins per field. The port carries the sections of the modules
it has ported: the listener, ``[auth]`` and the maintenance period
(``server/``, ``ctl/``), the storage fields and ``[storage.recovery]``
(``storage/``), ``[obs.tracing]`` and ``[obs.timeline]`` (``obs/``), the
log fields, ``[scheduler]`` (``sched/``), ``[cache]`` (``cache/``),
``[stream]`` (``stream/``), ``[tenants]`` with its ``[tenants.<id>]``
stanzas (``obs/tenants.py``), ``[gossip]`` and ``[membership]``
(``gossip/``), ``[cluster.resilience]`` / ``[cluster.batch]``
(``cluster/``), ``[dax]`` (``dax/``) and ``[degrade]``
(``sched/degrade.py``), with the JAX package's defaults and variable
names.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional

_ENV_PREFIX = "PILOSA_TPU_"


def _truthy(v: str) -> bool:
    return v.strip().lower() in ("1", "true", "t", "yes", "on")


def env_bool(name: str, default: bool = False) -> bool:
    """The one boolean-env dialect (shared by config parsing and opt-in
    feature flags)."""
    raw = os.environ.get(name)
    return default if raw is None else _truthy(raw)


def _toml_value(val: str):
    if val.startswith("[") and val.endswith("]"):
        inner = val[1:-1].strip()
        return [_toml_value(p.strip()) for p in inner.split(",")
                if p.strip()] if inner else []
    if len(val) >= 2 and val[0] == val[-1] and val[0] in ("'", '"'):
        return val[1:-1]
    if val in ("true", "false"):
        return val == "true"
    for conv in (int, float):
        try:
            return conv(val)
        except ValueError:
            pass
    return val


def _parse_toml_subset(text: str) -> Dict[str, Any]:
    """Minimal TOML reader for Pythons without stdlib tomllib (< 3.11):
    [section] headers, key = string / int / float / bool /
    array-of-strings, full-line # comments — the dialect ``to_toml``
    emits and the docs use. Real tomllib is preferred when present."""
    doc: Dict[str, Any] = {}
    cur = doc
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("[") and line.endswith("]"):
            cur = doc.setdefault(line[1:-1].strip(), {})
            continue
        key, sep, val = line.partition("=")
        if not sep:
            raise ValueError(f"unparsable config line: {raw!r}")
        cur[key.strip()] = _toml_value(val.strip())
    return doc


@dataclasses.dataclass
class Config:
    # The fields keep the JAX package's order, so ``to_toml`` prints its
    # lines less those of the sections still to port.
    # listener
    bind: str = "127.0.0.1"
    port: int = 10101
    # storage: the data directory (empty: in memory), the WAL's sync mode
    # and the record bytes that trigger a checkpoint
    data_dir: str = ""
    wal_sync: str = "batch"  # always | batch | never
    checkpoint_bytes: int = 64 << 20
    # maintenance: the TTL view-removal sweep's period
    ttl_removal_interval_s: float = 3600.0
    # auth (reference: auth section)
    auth_enable: bool = False
    auth_secret: str = ""
    auth_permissions_file: str = ""
    auth_allowed_networks: List[str] = dataclasses.field(default_factory=list)
    # mark session cookies Secure (HTTPS-only); leave off for plain-HTTP
    # dev deployments or the login flow's cookies never come back
    auth_secure_cookies: bool = False
    # distributed tracing ([obs.tracing] section / PILOSA_TPU_TRACE_*):
    # contextvar span scopes + traceparent propagation (obs/tracing.py;
    # install via obs.tracing.configure(cfg)). sample-rate head-samples
    # roots; slow-ms > 0 writes a structured slow-query line linking
    # request_id <-> trace_id; store-capacity bounds the trace store
    trace_enabled: bool = False
    trace_sample_rate: float = 1.0
    trace_slow_ms: float = 0.0  # <=0: slow-query log off
    trace_store_capacity: int = 256
    # health plane ([obs.timeline] section — the names flatten straight
    # to these fields, so env vars read PILOSA_TPU_OBS_TIMELINE_*; the
    # bare PILOSA_TPU_OBS_TIMELINE=1 switch is honored by API.__init__).
    # Sampler cadence/ring, SLO burn windows + alert threshold,
    # flight-recorder ring/cooldown, and the exemplar flag on the
    # registry's histograms (obs/health.py HealthPlane.from_config)
    obs_timeline_interval_ms: float = 1000.0
    obs_timeline_capacity: int = 300
    obs_timeline_slo_fast_window_s: float = 300.0
    obs_timeline_slo_slow_window_s: float = 3600.0
    obs_timeline_slo_fast_burn_alert: float = 10.0
    obs_timeline_flight_capacity: int = 16
    obs_timeline_flight_cooldown_s: float = 30.0
    obs_timeline_flight_dump_dir: str = ""
    obs_timeline_exemplars: bool = False
    log_level: str = "info"
    log_path: str = ""
    query_log_path: str = ""  # reference: server.go:792 query logger
    # query scheduler ([scheduler] section / PILOSA_TPU_SCHEDULER_*):
    # micro-batches concurrent reads to amortize the per-dispatch floor
    scheduler_enabled: bool = False
    scheduler_window_ms: float = 0.5  # batching horizon per group
    scheduler_max_batch: int = 64  # queries fused per dispatch
    scheduler_max_queue: int = 1024  # admission bound (429 beyond)
    scheduler_default_deadline_ms: float = 0.0  # <=0: no deadline
    # cross-shard-set superset fusion: groups whose shard sets overlap
    # merge into one padded/masked dispatch when
    # |union| / max(|subset|) <= fuse-waste-ratio; <=0 disables merging
    scheduler_fuse_waste_ratio: float = 2.0
    # adaptive batching window: derive the window from an EWMA of the
    # observed arrival rate (short when idle, longer under load),
    # clamped to [window-min-ms, window-max-ms]
    scheduler_adaptive_window: bool = False
    scheduler_window_min_ms: float = 0.2
    scheduler_window_max_ms: float = 5.0
    # batch-priority admits (streaming-ingest applies) yield until reads
    # have been quiet this long — the write side of read protection
    scheduler_batch_holdoff_ms: float = 5.0
    # result cache ([cache] section / PILOSA_TPU_CACHE_*): version-keyed
    # read result caching + single-flight dedup (cache/)
    cache_enabled: bool = False
    cache_max_bytes: int = 64 << 20
    cache_max_entries: int = 4096
    cache_ttl_ms: float = 0.0  # <=0: no TTL (and remote-leg caching off)
    # cluster metadata gossip ([gossip] section / PILOSA_TPU_GOSSIP_*):
    # fragment version vectors, health + breaker digests, piggybacked on
    # internode RPCs with periodic anti-entropy rounds (gossip/; attach
    # via ClusterNode.enable_gossip). With gossip on, remote-leg cache
    # entries key on the gossiped fingerprint and cache-ttl-ms is
    # deprecated for that path. No ``enabled`` field: nothing builds the
    # agent from the config yet (ROADMAP C.16).
    gossip_interval_ms: float = 100.0  # anti-entropy round period
    gossip_fanout: int = 1  # peers contacted per round
    gossip_seed: int = 0  # deterministic peer selection seed
    gossip_max_deltas: int = 512  # entries per envelope (complete windows)
    gossip_piggyback: bool = True  # ride envelopes on query/import/broadcast
    # gossip-native SWIM membership ([membership] section /
    # PILOSA_TPU_MEMBERSHIP_*): incarnation-numbered alive/suspect/down
    # records on the gossip plane, direct + indirect probing, bounded
    # suspect timeouts (gossip/membership.py; attach via
    # ClusterNode.enable_membership — requires gossip; no ``enabled``
    # field, as for [gossip])
    membership_interval_ms: float = 500.0  # protocol tick period
    membership_ping_timeout_ms: float = 200.0  # direct/indirect probe cap
    membership_indirect_k: int = 2  # ping-req relays before suspecting
    # suspect timeout = tick interval x mult x log2(cluster size)
    membership_suspect_mult: float = 3.0
    membership_flap_window_s: float = 30.0  # flap-detection window
    # fan-out resilience ([cluster.resilience] section /
    # PILOSA_TPU_CLUSTER_RESILIENCE_*): hedged remote shard legs,
    # per-node circuit breakers, adaptive per-leg timeouts
    # (cluster/resilience.py; attach via ClusterNode.enable_resilience)
    cluster_resilience_enabled: bool = False
    cluster_resilience_hedge: bool = True
    # hedge a leg once it's been outstanding past this percentile of the
    # node's recent leg latencies, clamped to [hedge-min-ms, hedge-max-ms]
    cluster_resilience_hedge_percentile: float = 95.0
    cluster_resilience_hedge_min_ms: float = 2.0
    cluster_resilience_hedge_max_ms: float = 2000.0
    # consecutive transport failures/timeouts that open a node's breaker,
    # and how long it stays open before a half-open probe is allowed
    cluster_resilience_breaker_threshold: int = 3
    cluster_resilience_breaker_open_ms: float = 3000.0
    # per-leg timeout = timeout-factor x node p99, clamped to
    # [timeout-min-ms, timeout-max-ms] and to the query's deadline budget
    cluster_resilience_timeout_factor: float = 4.0
    cluster_resilience_timeout_min_ms: float = 50.0
    cluster_resilience_timeout_max_ms: float = 30000.0
    cluster_resilience_latency_window: int = 64  # rolling samples per node
    # fan-out leg batching ([cluster.batch] section /
    # PILOSA_TPU_CLUSTER_BATCH_*): concurrent remote read legs bound for
    # the same node coalesce into one multi-query RPC (cluster/batch.py;
    # attach via ClusterNode.enable_cluster_batch, or set
    # PILOSA_TPU_CLUSTER_BATCH=1 to attach it at node construction)
    cluster_batch_enabled: bool = False
    cluster_batch_window_ms: float = 0.2  # fixed window when non-adaptive
    cluster_batch_max_batch: int = 32  # legs per node RPC
    # adaptive window: EWMA arrival-rate sizing shared with the local
    # scheduler (sched/window.py), clamped to [window-min, window-max]
    cluster_batch_adaptive_window: bool = True
    cluster_batch_window_min_ms: float = 0.05
    cluster_batch_window_max_ms: float = 2.0
    # crash recovery ([storage.recovery] section /
    # PILOSA_TPU_STORAGE_RECOVERY_*): WAL segment rotation size
    # (checkpoints prune whole sealed segments), the record bytes that
    # trigger a checkpoint (0 falls back to checkpoint-bytes), and the
    # shipped WAL-tail bytes per catch-up fetch (storage/recovery.py
    # RecoveryManager)
    storage_recovery_segment_bytes: int = 4 << 20
    storage_recovery_checkpoint_interval_bytes: int = 0
    storage_recovery_catchup_batch_bytes: int = 1 << 20
    # streaming ingest ([stream] section / PILOSA_TPU_STREAM_*): the
    # service the CLI's ``server`` starts when ``enabled`` is set, on
    # ``index`` (stream/pipeline.py; API.enable_stream). Batch rows per
    # pipeline hand-off, bounded queue depth (2 = double-buffered), the
    # consumer group name and the broker backlog at which push starts
    # rejecting (0 = batch_rows * queue_depth * 8), and the
    # paused/saturated stall seconds that fire the flight recorder's
    # ingest_stall trigger
    stream_enabled: bool = False
    stream_index: str = ""  # target index; required when enabled
    stream_batch_rows: int = 8192
    stream_queue_depth: int = 2
    stream_group: str = "ingest"
    stream_max_backlog_rows: int = 0
    stream_ingest_stall_s: float = 5.0
    # tenant attribution plane ([tenants] section / PILOSA_TPU_TENANTS_*):
    # bounded per-tenant accounting, tenant-scoped SLOs, token-bucket
    # quotas and weighted-fair admission (obs/tenants.py; attach via
    # API.enable_tenants, PILOSA_TPU_TENANTS=1, or ``enabled`` for the
    # CLI's server). Default quotas of 0 mean unlimited — attribution
    # without enforcement until an operator opts a rate in.
    tenants_enabled: bool = False
    tenants_max_tracked: int = 64  # distinct tenant stat rows
    tenants_top_k: int = 8  # label guard on tenant_* gauges
    tenants_default_qps: float = 0.0  # queries/s per tenant; 0 = off
    tenants_default_ingest_rows_s: float = 0.0  # rows/s per tenant
    tenants_cache_quota_bytes: int = 0  # resident cache bytes per tenant
    tenants_fair_share: bool = True  # weighted-fair admission ordering
    # [tenants.<id>] stanzas: per-tenant quota/weight overrides applied
    # at enable_tenants time. Recognized keys per stanza: qps,
    # ingest-rows-s, cache-bytes, weight.
    tenants_overrides: Dict[str, Dict[str, Any]] = dataclasses.field(
        default_factory=dict)

    # elastic serverless plane ([dax] section / PILOSA_TPU_DAX_*): the
    # disaggregated deployment shape (dax/) — group-commit shared-FS
    # writelog, directive push cadence, warm handoff, and the autoscaler
    # bounds (dax/autoscale.py), read by DaxCluster.from_config. Off
    # unless a fleet is built: zero dax threads, metrics or spans.
    dax_segment_bytes: int = 1 << 20  # writelog segment rotation size
    dax_sync: str = "batch"  # writelog fsync: always | batch | never
    dax_snapshot_every: int = 256  # ops between shard snapshots
    dax_dead_after_s: float = 5.0  # checkin deadline (no membership)
    dax_directive_retries: int = 2  # per-node push retries
    dax_directive_backoff_ms: float = 50.0  # base push retry backoff
    dax_warm_handoff: bool = True  # prewarm hot fields before ack
    dax_autoscale_min: int = 1  # autoscaler pool floor
    dax_autoscale_max: int = 8  # autoscaler pool ceiling
    dax_autoscale_cooldown_s: float = 30.0  # hold after each decision
    dax_autoscale_queue_high: int = 16  # queue depth scale-up trigger
    dax_autoscale_p99_high_ms: float = 250.0  # leg p99 scale-up trigger

    # graceful-degradation ladder ([degrade] section / PILOSA_TPU_DEGRADE_*):
    # NORMAL -> SHED_BATCH -> BROWNOUT -> SATURATED state machine driven
    # by timeline signals (sched/degrade.py; attach via API.enable_degrade,
    # PILOSA_TPU_DEGRADE=1, or ``enabled`` for the CLI's server).
    # Thresholds are the ENTER edges; exit edges are enter *
    # degrade_exit_ratio, and a level change additionally needs
    # degrade_up_hold / degrade_down_hold consecutive samples past the edge
    # plus degrade_min_dwell_s since the last transition (hysteresis).
    degrade_enabled: bool = False
    degrade_queue_shed: float = 0.50  # queue fraction -> SHED_BATCH
    degrade_queue_brownout: float = 0.75  # queue fraction -> BROWNOUT
    degrade_queue_saturate: float = 0.92  # queue fraction -> SATURATED
    degrade_burn_shed: float = 2.0  # SLO fast-burn -> SHED_BATCH
    degrade_burn_brownout: float = 6.0  # SLO fast-burn -> BROWNOUT
    degrade_burn_saturate: float = 14.0  # SLO fast-burn -> SATURATED
    degrade_miss_rate_brownout: float = 1.0  # deadline misses/s -> BROWNOUT
    degrade_eviction_rate_shed: float = 50.0  # budget evictions/s -> SHED
    degrade_exit_ratio: float = 0.7  # exit edge = enter edge * ratio
    degrade_up_hold: int = 1  # consecutive hot samples to escalate
    degrade_down_hold: int = 3  # consecutive cool samples to step down
    degrade_min_dwell_s: float = 1.0  # floor between transitions
    degrade_deadline_factor: float = 0.5  # brownout deadline multiplier
    degrade_brownout_deadline_ms: float = 250.0  # imposed when none set
    degrade_stale_ttl_ms: float = 30000.0  # max age of a brownout stale read
    degrade_retry_after_s: float = 1.0  # saturated-shed fallback hint

    # -- sources -----------------------------------------------------------

    @classmethod
    def from_sources(cls, toml_path: Optional[str] = None,
                     env: Optional[Dict[str, str]] = None,
                     flags: Optional[Dict[str, Any]] = None) -> "Config":
        cfg = cls()
        if toml_path:
            cfg._apply(cls._load_toml(toml_path))
        cfg._apply(cls._from_env(env if env is not None else os.environ))
        if flags:
            cfg._apply({k: v for k, v in flags.items() if v is not None})
        return cfg

    def _apply(self, values: Dict[str, Any]) -> None:
        for f in dataclasses.fields(self):
            if f.name not in values:
                continue
            v = values[f.name]
            if f.type in ("int", int):
                v = int(v)
            elif f.type in ("float", float):
                v = float(v)
            elif f.type in ("bool", bool) and isinstance(v, str):
                v = _truthy(v)
            elif "List" in str(f.type) and isinstance(v, str):
                v = [p for p in v.split(",") if p]
            setattr(self, f.name, v)

    @staticmethod
    def _load_toml(path: str) -> Dict[str, Any]:
        try:
            import tomllib
        except ModuleNotFoundError:  # Python < 3.11: stdlib has no tomllib
            tomllib = None
        if tomllib is not None:
            with open(path, "rb") as f:
                doc = tomllib.load(f)
        else:
            with open(path, encoding="utf-8") as f:
                doc = _parse_toml_subset(f.read())
        # [section] key -> section_key; dotted sections nest with real
        # tomllib ([cluster.resilience] -> {"cluster": {"resilience":
        # ...}}) but stay dotted flat keys in the subset parser — both
        # flatten to cluster_resilience_*
        flat: Dict[str, Any] = {}

        # [tenants.<id>] stanzas are per-tenant override MAPS, not
        # scalar config fields — lift them out before flattening (real
        # tomllib nests them under "tenants"; the subset parser keeps
        # the dotted header as a flat "tenants.<id>" key)
        overrides: Dict[str, Dict[str, Any]] = {}
        tsec = doc.get("tenants")
        if isinstance(tsec, dict):
            for k in [k for k, v in tsec.items() if isinstance(v, dict)]:
                overrides[k] = {ik.replace("-", "_"): iv
                                for ik, iv in tsec.pop(k).items()}
        for k in [k for k in doc if k.startswith("tenants.")
                  and isinstance(doc[k], dict)]:
            overrides[k[len("tenants."):]] = {
                ik.replace("-", "_"): iv for ik, iv in doc.pop(k).items()}

        def _flatten(prefix: str, d: Dict[str, Any]) -> None:
            for k, v in d.items():
                key = (f"{prefix}_{k}" if prefix else k) \
                    .replace("-", "_").replace(".", "_")
                if isinstance(v, dict):
                    _flatten(key, v)
                else:
                    flat[key] = v

        _flatten("", doc)
        # [obs.tracing] keys land as obs_tracing_*; the fields are named
        # trace_* so their env vars read PILOSA_TPU_TRACE_* (the
        # documented dialect) — remap the TOML spelling onto them
        for k in list(flat):
            if k.startswith("obs_tracing_"):
                flat["trace_" + k[len("obs_tracing_"):]] = flat.pop(k)
        if overrides:
            flat["tenants_overrides"] = overrides
        return flat

    @classmethod
    def _from_env(cls, env) -> Dict[str, Any]:
        out = {}
        for f in dataclasses.fields(cls):
            key = _ENV_PREFIX + f.name.upper()
            if key in env:
                out[f.name] = env[key]
        return out

    # -- generate-config (reference: ctl/generate_config.go) ---------------

    def to_toml(self) -> str:
        lines = ["# pilosa-tpu configuration (all keys optional)"]

        def scalar(v) -> str:
            if isinstance(v, bool):
                return "true" if v else "false"
            if isinstance(v, (int, float)):
                return str(v)
            if isinstance(v, list):
                return "[" + ", ".join(f'"{x}"' for x in v) + "]"
            return f'"{v}"'

        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, dict):
                continue  # emitted as [section.id] stanzas below
            lines.append(f"{f.name.replace('_', '-')} = {scalar(v)}")
        # per-tenant stanzas last: a TOML table header scopes every key
        # after it, so they must follow all top-level keys
        for tid, kv in sorted(self.tenants_overrides.items()):
            lines.append(f"\n[tenants.{tid}]")
            for k, v in sorted(kv.items()):
                lines.append(f"{k.replace('_', '-')} = {scalar(v)}")
        return "\n".join(lines) + "\n"
