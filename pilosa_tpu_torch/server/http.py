"""HTTP API: the reference's REST surface over the port's engine.

Port of ``pilosa_tpu/server/http.py``: the same routes, bodies, status
codes and headers, served over the port's ``API`` on the card (or on
the CPU when the API was built with ``device="cpu"``).

Reference routes (http_handler.go:488-610):
    POST   /index/{index}/query          PQL (http_handler.go:521)
    POST   /index/{index}                create index
    DELETE /index/{index}
    POST   /index/{index}/field/{field}  create field
    DELETE /index/{index}/field/{field}
    GET    /schema                        (http_handler.go:500)
    GET    /status
    GET    /info
    POST   /index/{i}/import              bulk bits (JSON body)
    POST   /index/{i}/import-values       bulk BSI values (JSON body)

Import bodies are JSON rather than the reference's protobuf (the wire
codec is an L8 detail; the shard-transactional semantics match
api.go:1647 ImportRoaringShard's one-fragment-per-request batching).
Serving uses a stdlib ThreadingHTTPServer: each connection runs on its
own thread, and every thread launches onto the card's one stream.

A single node answers the node-to-node routes (``/internal/index/*/
query``, the query batch, cluster messages, SQL subtrees, translate
replication, partition nodes, gossip, membership and recovery) and
``/directive`` with the JAX package's single-node 404s. A cluster node
serves them all but ``/directive``, which only a DAX ``Computer`` answers
(``dax/computer.py``); a node's query, batch, message, import and ping
bodies carry the gossip envelope both ways. The optional planes (tenants,
degradation, health, cache, stream, history) are read with ``getattr``,
so the handler serves any object with the API's surface, a ``Computer``
among them, whatever planes it lacks.
With the tenant plane on, each request acts as the tenant its
``X-Tenant`` header (or ``?tenant=``) names, clamped to a safe id; its
queries and imports are charged to that tenant's quotas (429 +
``Retry-After`` when one is spent), and ``/internal/tenants`` lists every
tracked tenant. With the degradation ladder on, the import routes shed
batch work from SHED_BATCH up, a brownout read says ``"stale": true``,
and ``/internal/degrade`` reads the ladder. Either route answers
``{"enabled": false}`` while its plane is off.
"""

from __future__ import annotations

import base64
import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple
from urllib.parse import parse_qs, urlsplit

from pilosa_tpu_torch.api import API
from pilosa_tpu_torch.errors import (AdmissionError, ClusterStateError,
                               QueryDeadlineError)
from pilosa_tpu_torch.obs.tenants import (current_tenant_id,
                                          reset_current_tenant,
                                          set_current_tenant)

_ROUTES = [
    # node-to-node endpoints (reference: http_handler.go:552-585 /internal/*)
    ("POST", re.compile(r"^/internal/index/([^/]+)/query$"),
     "post_internal_query"),
    # coalesced multi-query fan-out leg (cluster/batch.py): one RPC
    # carries many (index, query, shards) legs, served by one fused
    # superset-merge dispatch per index group
    ("POST", re.compile(r"^/internal/query-batch$"),
     "post_internal_query_batch"),
    ("POST", re.compile(r"^/internal/cluster/message$"), "post_cluster_message"),
    # serialized SQL subtree execution (reference: /sql-exec-graph,
    # http_handler.go:538)
    ("POST", re.compile(r"^/internal/sql/subtree$"), "post_sql_subtree"),
    ("POST", re.compile(r"^/internal/translate/index/([^/]+)/keys/(create|find)$"),
     "post_translate_index_keys"),
    ("POST", re.compile(r"^/internal/translate/index/([^/]+)/ids$"),
     "post_translate_index_ids"),
    ("POST", re.compile(
        r"^/internal/translate/field/([^/]+)/([^/]+)/keys/(create|find)$"),
     "post_translate_field_keys"),
    ("POST", re.compile(r"^/internal/translate/replicate$"),
     "post_translate_replicate"),
    ("POST", re.compile(r"^/internal/translate/field/([^/]+)/([^/]+)/ids$"),
     "post_translate_field_ids"),
    ("POST", re.compile(r"^/index/([^/]+)/query$"), "post_query"),
    ("POST", re.compile(r"^/index/([^/]+)/field/([^/]+)$"), "post_field"),
    ("DELETE", re.compile(r"^/index/([^/]+)/field/([^/]+)$"), "delete_field"),
    ("POST", re.compile(r"^/index/([^/]+)/shard/(\d+)/import-roaring$"),
     "post_import_roaring"),
    ("POST", re.compile(r"^/index/([^/]+)/import$"), "post_import"),
    ("POST", re.compile(r"^/index/([^/]+)/import-values$"), "post_import_values"),
    # dataframe (reference: http_handler.go:506-509)
    ("POST", re.compile(r"^/index/([^/]+)/dataframe/(\d+)$"), "post_dataframe"),
    ("GET", re.compile(r"^/index/([^/]+)/dataframe/(\d+)$"), "get_dataframe"),
    ("GET", re.compile(r"^/index/([^/]+)/dataframe$"), "get_dataframe_schema"),
    ("DELETE", re.compile(r"^/index/([^/]+)/dataframe$"), "delete_dataframe"),
    ("POST", re.compile(r"^/index/([^/]+)$"), "post_index"),
    ("DELETE", re.compile(r"^/index/([^/]+)$"), "delete_index"),
    ("POST", re.compile(r"^/sql$"), "post_sql"),
    ("GET", re.compile(r"^/schema$"), "get_schema"),
    ("GET", re.compile(r"^/status$"), "get_status"),
    ("GET", re.compile(r"^/version$"), "get_version"),
    ("GET", re.compile(r"^/health$"), "get_health"),
    ("GET", re.compile(r"^/schema/details$"), "get_schema_details"),
    ("GET", re.compile(r"^/internal/nodes$"), "get_internal_nodes"),
    ("GET", re.compile(r"^/internal/shards/max$"), "get_shards_max"),
    ("GET", re.compile(r"^/internal/index/([^/]+)/shards$"),
     "get_index_shards"),
    ("GET", re.compile(r"^/internal/partition/nodes$"),
     "get_partition_nodes"),
    ("GET", re.compile(r"^/internal/oauth-config$"), "get_oauth_config"),
    ("GET", re.compile(r"^/userinfo$"), "get_userinfo"),
    ("GET", re.compile(r"^/queries$"), "get_queries"),
    ("POST", re.compile(r"^/recalculate-caches$"), "post_recalculate_caches"),
    ("GET", re.compile(r"^/ui/shard-distribution$"),
     "get_shard_distribution"),
    ("POST", re.compile(r"^/cpu-profile/start$"), "post_cpu_profile_start"),
    ("POST", re.compile(r"^/cpu-profile/stop$"), "post_cpu_profile_stop"),
    ("POST", re.compile(
        r"^/internal/translate/field/([^/]+)/([^/]+)/keys/like$"),
     "post_translate_field_keys_like"),
    ("GET", re.compile(r"^/info$"), "get_info"),
    # per-shard snapshot stream (reference: api.go:1265 IndexShardSnapshot
    # via /internal/index/{i}/shard/{s}/snapshot)
    ("GET", re.compile(r"^/internal/index/([^/]+)/shard/(\d+)/snapshot$"),
     "get_shard_snapshot"),
    # auto-ID allocation (reference: http_handler.go:582-585)
    ("POST", re.compile(r"^/internal/idalloc/reserve$"),
     "post_idalloc_reserve"),
    ("POST", re.compile(r"^/internal/idalloc/commit$"),
     "post_idalloc_commit"),
    # profiling (reference: /debug/pprof http_handler.go:493; per-query
    # CPU profiles :1301 DoPerQueryProfiling — ours via ?profile=true)
    ("GET", re.compile(r"^/debug/pprof$"), "get_pprof"),
    # resource accounting (reference: http_handler.go:557-559
    # /internal/mem-usage, /disk-usage)
    ("GET", re.compile(r"^/internal/mem-usage$"), "get_mem_usage"),
    ("GET", re.compile(r"^/disk-usage$"), "get_disk_usage"),
    ("GET", re.compile(r"^/disk-usage/([^/]+)$"), "get_disk_usage"),
    # backup/restore/chksum (reference: ctl/backup.go internal endpoints)
    ("GET", re.compile(r"^/internal/backup\.tar$"), "get_backup_tar"),
    ("POST", re.compile(r"^/internal/restore$"), "post_restore"),
    ("GET", re.compile(r"^/internal/chksum$"), "get_chksum"),
    # result cache maintenance (cache/): admin-gated like every
    # /internal/* route (auth.py ROUTE_LEVELS falls back to admin)
    ("POST", re.compile(r"^/internal/cache/flush$"), "post_cache_flush"),
    ("GET", re.compile(r"^/internal/cache/stats$"), "get_cache_stats"),
    # cluster metadata gossip (gossip/): anti-entropy exchange + state
    ("POST", re.compile(r"^/internal/gossip/exchange$"),
     "post_gossip_exchange"),
    ("GET", re.compile(r"^/internal/gossip/state$"), "get_gossip_state"),
    # SWIM membership (gossip/membership.py): probe/relay + merged view
    ("POST", re.compile(r"^/internal/membership/ping$"),
     "post_membership_ping"),
    ("GET", re.compile(r"^/internal/membership$"), "get_membership"),
    # replica catch-up log shipping (storage/recovery.py): shard
    # snapshot + WAL tail, JSON+base64 like every internal route
    ("GET", re.compile(r"^/internal/recovery/snapshot$"),
     "get_recovery_snapshot"),
    ("GET", re.compile(r"^/internal/recovery/wal$"), "get_recovery_wal"),
    # observability (reference: http_handler.go:495-497, :540)
    ("GET", re.compile(r"^/metrics$"), "get_metrics"),
    ("GET", re.compile(r"^/metrics\.json$"), "get_metrics_json"),
    ("GET", re.compile(r"^/query-history$"), "get_query_history"),
    # concurrency-correctness plane (analysis/locktrace.py): lock-order
    # graph + cycle/dispatch/io violations ({"enabled": false} when the
    # PILOSA_TPU_LOCKCHECK tracer is off)
    ("GET", re.compile(r"^/internal/analysis/locks$"),
     "get_analysis_locks"),
    # distributed traces (obs/tracing.py TraceStore): summaries + one
    # assembled span tree per trace id
    ("GET", re.compile(r"^/internal/traces$"), "get_internal_traces"),
    ("GET", re.compile(r"^/internal/traces/([^/]+)$"), "get_internal_trace"),
    # health plane (obs/health.py): local timeline window, cluster-wide
    # fan-out merge, SLO burn status, flight-recorder bundles
    ("GET", re.compile(r"^/internal/stats/timeline$"), "get_stats_timeline"),
    ("GET", re.compile(r"^/internal/stats/cluster$"), "get_stats_cluster"),
    # kernel performance attribution (obs/devprof.py): per-family
    # MFU/roofline profiles + ingest stage rates
    ("GET", re.compile(r"^/internal/stats/kernels$"), "get_stats_kernels"),
    # streaming ingest (stream/): backpressured push + pipeline stats
    ("POST", re.compile(r"^/index/([^/]+)/stream/push$"), "post_stream_push"),
    ("GET", re.compile(r"^/internal/stats/stream$"), "get_stats_stream"),
    ("GET", re.compile(r"^/internal/slo$"), "get_slo"),
    # graceful-degradation ladder (sched/degrade.py): current level,
    # transition count, last signal snapshot
    ("GET", re.compile(r"^/internal/degrade$"), "get_internal_degrade"),
    # tenant attribution plane (obs/tenants.py): per-tenant usage,
    # quota state, fair-share weights — every tracked tenant, not just
    # the top-K that get metric labels
    ("GET", re.compile(r"^/internal/tenants$"), "get_internal_tenants"),
    ("GET", re.compile(r"^/internal/debug/bundles$"), "get_debug_bundles"),
    ("GET", re.compile(r"^/internal/debug/bundles/([^/]+)$"),
     "get_debug_bundle"),
    ("GET", re.compile(r"^/index/([^/]+)/mutex-check$"), "get_mutex_check"),
    # DAX directive push (reference: dax computer /directive endpoint)
    ("POST", re.compile(r"^/directive$"), "post_directive"),
    # gRPC service over HTTP/1.1 framing (reference: server/grpc.go
    # service surface; transport documented in server/grpc.py)
    ("POST", re.compile(r"^/grpc/pilosa\.Pilosa/([A-Za-z]+)$"),
     "post_grpc"),
    # cluster transactions (reference: http_handler.go:528-533)
    ("POST", re.compile(r"^/transaction/?$"), "post_transaction"),
    ("GET", re.compile(r"^/transaction/([^/]+)$"), "get_transaction"),
    ("POST", re.compile(r"^/transaction/([^/]+)/finish$"),
     "post_transaction_finish"),
    ("GET", re.compile(r"^/transactions$"), "get_transactions"),
    # OIDC login flow (reference: authn/authenticate.go:251-300
    # Login/Logout/Redirect handlers)
    ("GET", re.compile(r"^/login$"), "get_login"),
    ("GET", re.compile(r"^/redirect$"), "get_redirect"),
    ("GET", re.compile(r"^/logout$"), "get_logout"),
]

# The login flow (and liveness/identity probes) must be reachable
# without credentials; /userinfo authenticates via its own cookies.
_AUTH_EXEMPT = {"get_login", "get_redirect", "get_logout",
                "get_version", "get_health", "get_userinfo"}


def _token_cookies(access: str, refresh: str, expire: bool = False,
                   secure: bool = False):
    """Set-Cookie headers for the token pair (reference:
    authenticate.go:346 SetCookie; names :33-36). ``secure`` adds the
    HTTPS-only attribute (config auth.secure_cookies)."""
    tail = "; Path=/; HttpOnly; SameSite=Strict"
    if secure:
        tail += "; Secure"
    if expire:
        tail += "; Expires=Thu, 01 Jan 1970 00:00:00 GMT"
    return [f"molecula-chip={access}{tail}",
            f"refresh-molecula-chip={refresh}{tail}"]


_STATE_COOKIE = "molecula-chip-state"


def _state_cookie(state: str, secure: bool = False,
                  expire: bool = False):
    """Set-Cookie header binding the OIDC anti-CSRF state to this
    browser: /login sets it, /redirect requires it to match the query
    state. SameSite=Lax (not Strict) because the IdP→/redirect hop is a
    cross-site top-level navigation and Strict would withhold the cookie
    on exactly the request that needs it."""
    max_age = 0 if expire else 600
    tail = f"; Path=/redirect; Max-Age={max_age}; HttpOnly; SameSite=Lax"
    if secure:
        tail += "; Secure"
    if expire:
        state = ""
        tail += "; Expires=Thu, 01 Jan 1970 00:00:00 GMT"
    return f"{_STATE_COOKIE}={state}{tail}"


class Handler(BaseHTTPRequestHandler):
    """One handler class bound to an API instance via serve()."""

    api: API  # set by serve()
    protocol_version = "HTTP/1.1"
    # TCP_NODELAY: a response is two writes (headers, then body), and on
    # a keep-alive connection Nagle's algorithm holds the body until the
    # client's delayed ACK of the headers, ~40 ms a response (the JAX
    # package's handler leaves it on)
    disable_nagle_algorithm = True

    # -- plumbing ----------------------------------------------------------

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _body(self) -> bytes:
        length = int(self.headers.get("Content-Length") or 0)
        return self.rfile.read(length) if length else b""

    def _json_body(self) -> dict:
        raw = self._body()
        if not raw:
            return {}
        return json.loads(raw)

    @staticmethod
    def _require(body: dict, key: str):
        """Missing request-body keys are 400s (ValueError), not the 404s
        reserved for holder lookups (KeyError)."""
        if key not in body:
            raise ValueError(f"request body missing required key {key!r}")
        return body[key]

    #: remote rpc span for the in-flight request (set by _dispatch when
    #: the caller sent a sampled traceparent header)
    _trace_span = None

    def _send(self, code: int, payload: dict, headers=None) -> None:
        sp = self._trace_span
        if sp is not None:
            # ship the serving node's finished span tree back to the
            # caller piggybacked on the response (the gossip-envelope
            # pattern); the client grafts it under its leg span
            self._trace_span = None
            sp.finish()
            if isinstance(payload, dict):
                payload = dict(payload)
                payload["trace"] = sp.to_json()
        data = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self._emit_cookies()
        self.end_headers()
        self.wfile.write(data)

    def _emit_cookies(self) -> None:
        for header in getattr(self, "_pending_cookies", ()):
            self.send_header("Set-Cookie", header)
        self._pending_cookies = []

    def _redirect(self, location: str) -> None:
        self.send_response(302)
        self.send_header("Location", location)
        self.send_header("Content-Length", "0")
        self._emit_cookies()
        self.end_headers()

    #: set by serve(auth=...); None = auth disabled
    auth = None
    _auth_ctx: dict = {}

    def _check_auth(self, name: str, match) -> None:
        """Per-route gating (reference: http_handler.go:497 chkAuthZ).
        Unlisted routes — including every /internal/* — need admin."""
        from pilosa_tpu_torch.server.auth import ROUTE_LEVELS

        ctx = self.auth.authenticate(self.headers, self.client_address[0])
        self._auth_ctx = ctx
        info = ctx.get("oidc")
        if info and info.get("rotated"):
            # expired access token was refreshed mid-request: rotate the
            # caller's cookies on this response (authenticate.go:174
            # "caller's responsibility to inform the user")
            self._pending_cookies = _token_cookies(
                info["access"], info["refresh"],
                secure=self._secure_cookies())
        level, takes_index = ROUTE_LEVELS.get(name, ("admin", False))
        index = match.group(1) if takes_index and match.groups() else None
        self.auth.authorize(ctx, level, index)

    def _require_write(self, index) -> None:
        """Post-parse escalation: a query statement that writes needs
        write permission even though the route admits readers
        (reference: the handler checks query write-ness for authz)."""
        if self.auth is not None:
            self.auth.authorize(self._auth_ctx, "write", index)

    def _dispatch(self, method: str) -> None:
        from pilosa_tpu_torch.obs.metrics import METRIC_HTTP_DURATION, REGISTRY
        from pilosa_tpu_torch.server.auth import AuthError

        for m, pattern, name in _ROUTES:
            if m != method:
                continue
            match = pattern.match(self.path.split("?", 1)[0])
            if match:
                tp = self.headers.get("traceparent")
                if tp:
                    # join the caller's trace: every handler under this
                    # scope (query legs, translate, sql subtrees,
                    # recovery fetches) nests its spans below rpc.<route>
                    from pilosa_tpu_torch.obs.tracing import get_tracer

                    span = get_tracer().start_remote(
                        f"rpc.{name}", tp,
                        node=getattr(getattr(self.api, "node", None),
                                     "id", ""))
                    attempt = self.headers.get("x-trace-attempt")
                    if attempt and span.recording:
                        span.set_tag("attempt", attempt)
                    self._trace_span = span if span.recording else None
                tenant_token = None
                reg = getattr(self.api, "tenants", None)
                if reg is not None:
                    # attribution entry point: X-Tenant header (or
                    # ?tenant= for curl-ability), clamped to a safe id,
                    # never rejected — unattributed traffic just lands
                    # on "default"
                    raw = self.headers.get("x-tenant")
                    if raw is None and "?" in self.path:
                        vals = parse_qs(urlsplit(self.path).query).get(
                            "tenant")
                        raw = vals[-1] if vals else None
                    tenant = reg.resolve(raw)
                    tenant_token = set_current_tenant(tenant)
                    sp = self._trace_span
                    if sp is not None and sp.recording:
                        sp.set_tag("tenant", tenant)
                try:
                    if self.auth is not None and name not in _AUTH_EXEMPT:
                        self._check_auth(name, match)
                    with REGISTRY.timer(METRIC_HTTP_DURATION,
                                        method=method, route=name):
                        getattr(self, name)(*match.groups())
                except AuthError as e:
                    self._send(e.code, {"error": str(e)})
                except KeyError as e:
                    self._send(404, {"error": str(e)})
                except (ValueError, json.JSONDecodeError) as e:
                    self._send(400, {"error": str(e)})
                except ClusterStateError as e:
                    # gated by cluster state (reference: api.go:160)
                    self._send(412, {"error": str(e)})
                except AdmissionError as e:
                    # scheduler backpressure / tenant quota: shed load,
                    # retryable; quota rejections say when to come back
                    ra = getattr(e, "retry_after_s", None)
                    self._send(429, {"error": str(e)},
                               headers=({"Retry-After":
                                         str(max(1, int(ra + 0.999)))}
                                        if ra is not None else None))
                except QueryDeadlineError as e:
                    self._send(408, {"error": str(e)})
                except Exception as e:  # pragma: no cover - last resort
                    self._send(500, {"error": f"{type(e).__name__}: {e}"})
                finally:
                    # a span _send never consumed (handler wrote its own
                    # response) must still finish, or its scope would
                    # leak into the next keep-alive request
                    sp, self._trace_span = self._trace_span, None
                    if sp is not None:
                        sp.finish()
                    if tenant_token is not None:
                        # same leak hazard as the span: keep-alive reuses
                        # this thread for the next (possibly tenant-less)
                        # request
                        reset_current_tenant(tenant_token)
                return
        self._send(404, {"error": f"no route for {method} {self.path}"})

    def do_GET(self):
        self._dispatch("GET")

    def do_POST(self):
        self._dispatch("POST")

    def do_DELETE(self):
        self._dispatch("DELETE")

    # -- tenant quota gates ------------------------------------------------

    def _charge_tenant_query(self) -> None:
        """One unit against the current tenant's QPS bucket; raises
        QuotaExceededError -> 429 + Retry-After when exhausted. No-op
        when the tenant plane is off or the tenant is unlimited."""
        reg = getattr(self.api, "tenants", None)
        if reg is not None:
            reg.charge_query(current_tenant_id())

    def _charge_tenant_ingest(self, rows: int, body=None) -> None:
        """``rows`` against the current tenant's ingest bucket. Forwarded
        internal legs (body["remote"]) are exempt: the entry node already
        charged the whole batch, and double-charging fan-out would make
        effective quota depend on cluster size."""
        if body is not None and body.get("remote"):
            return
        reg = getattr(self.api, "tenants", None)
        if reg is not None:
            reg.charge_ingest(current_tenant_id(), rows)

    # -- handlers ----------------------------------------------------------

    def post_query(self, index: str):
        """PQL query; body is raw PQL or JSON {"query": "..."} (reference:
        http_handler.go:1295 handlePostQuery)."""
        self._charge_tenant_query()
        raw = self._body()
        ctype = (self.headers.get("Content-Type") or "").split(";")[0]
        if ctype == "application/json":
            q = json.loads(raw or b"{}").get("query", "")
        else:
            q = raw.decode()
        if self.auth is not None:
            from pilosa_tpu_torch.pql.executor import has_write_calls
            from pilosa_tpu_torch.pql.parser import parse

            q = parse(q)  # parsed once; api.query accepts the AST
            if has_write_calls(q):
                self._require_write(index)
        from urllib.parse import parse_qs, urlsplit

        qs = parse_qs(urlsplit(self.path).query)
        # scheduler hints (?priority=interactive|batch, ?timeout_ms=N);
        # ignored when the scheduler is disabled
        kw = {}
        if qs.get("priority"):
            kw["priority"] = qs["priority"][-1]
        if qs.get("timeout_ms"):
            kw["deadline_ms"] = float(qs["timeout_ms"][-1])
        if qs.get("profile", [""])[-1].lower() == "true":
            # per-query latency attribution (reference: http_handler.go
            # :1301 DoPerQueryProfiling): the response carries the full
            # span tree — queue wait, cache, device dispatch/sync, remote
            # legs — even when tracing is globally off (forced root).
            # Process-wide CPU profiles stay on /cpu-profile/start|stop.
            kw["profile"] = True
        self._send(200, self.api.query_json(index, q, **kw))

    def post_sql(self):
        """SQL query; body is the raw SQL text (reference:
        http_handler.go:536 POST /sql -> :1440 handlePostSQL)."""
        # SQLError subclasses ValueError -> _dispatch maps it to a 400
        self._charge_tenant_query()
        text = self._body().decode()
        parsed = None
        if self.auth is not None:
            parsed = self._authorize_sql(text)
        from urllib.parse import parse_qs, urlsplit

        qs = parse_qs(urlsplit(self.path).query)
        cache = getattr(self.api, "cache", None)
        if cache is not None:
            cache.take_stale_flag()  # clear any untagged leftover
        if qs.get("profile", [""])[-1].lower() == "true":
            # same span-tree surface as /index/{i}/query?profile=true
            from pilosa_tpu_torch.obs.tracing import get_tracer

            with get_tracer().profile("sql.profile") as root:
                res = self.api.sql(text, parsed=parsed)
            out = res.to_json()
            out["profile"] = root.to_json()
            if cache is not None and cache.take_stale_flag():
                out["stale"] = True
            self._send(200, out)
            return
        out = self.api.sql(text, parsed=parsed).to_json()
        if cache is not None and cache.take_stale_flag():
            # brownout: SELECT served past its version fingerprint
            out["stale"] = True
        self._send(200, out)

    def _authorize_sql(self, text: str):
        """SQL statements escalate by kind, checked against the SPECIFIC
        tables they touch (the same levels as the REST surface): SELECT
        needs read on every table it reads (incl. join sides), DDL needs
        admin on its table, DML write on its table."""
        from pilosa_tpu_torch.sql import ast as sql_ast
        from pilosa_tpu_torch.sql.parser import parse_statement

        stmt = parse_statement(text)
        ctx = self._auth_ctx
        if isinstance(stmt, sql_ast.SelectStatement):
            for t in self._select_tables(stmt):
                self.auth.authorize(ctx, "read", t)
            return stmt
        if isinstance(stmt, sql_ast.ShowColumns):
            self.auth.authorize(ctx, "read", stmt.table)
            return stmt
        if isinstance(stmt, (sql_ast.ShowTables, sql_ast.ShowDatabases)):
            return stmt
        if isinstance(stmt, (sql_ast.CreateTable, sql_ast.DropTable,
                             sql_ast.AlterTable, sql_ast.CreateView,
                             sql_ast.DropView)):
            # per-table admin grant or the global admin group (mirrors
            # DELETE /index/{i} which checks admin on i)
            self.auth.authorize(ctx, "admin", stmt.name)
            return stmt
        if isinstance(stmt, sql_ast.CopyStatement):
            # read on the source, admin for the implicit target CREATE;
            # shipping rows to an external URL is an export -> admin too
            self.auth.authorize(ctx, "read", stmt.source)
            if stmt.url:
                self.auth.authorize(ctx, "admin", None)
            else:
                self.auth.authorize(ctx, "admin", stmt.target)
            return stmt
        table = getattr(stmt, "table", None) or getattr(stmt, "name", None)
        self._require_write(table)
        return stmt

    def _select_tables(self, stmt) -> list:
        """Every base table a SELECT reads, recursing into FROM-
        subqueries — a derived table must not bypass per-table read
        grants."""
        from pilosa_tpu_torch.sql import ast as sql_ast
        from pilosa_tpu_torch.sql.engine import _SYSTEM_TABLES

        out: list = []

        def walk(s: "sql_ast.SelectStatement"):
            if s.derived is not None:
                walk(s.derived)
            if s.table is not None and s.table not in _SYSTEM_TABLES:
                out.append(s.table)
            for j in s.joins:
                out.append(j.table)
        walk(stmt)
        return out

    def post_index(self, index: str):
        self.api.create_index(index, self._json_body().get("options"))
        self._send(200, {"success": True})

    def delete_index(self, index: str):
        self.api.delete_index(index)
        self._send(200, {"success": True})

    def post_field(self, index: str, field: str):
        self.api.create_field(index, field, self._json_body().get("options"))
        self._send(200, {"success": True})

    def delete_field(self, index: str, field: str):
        self.api.delete_field(index, field)
        self._send(200, {"success": True})

    def post_dataframe(self, index: str, shard: str):
        """Changeset ingest (reference: http_handler.go:506
        handlePostDataframe; apply.go:278 ChangesetRequest). Body:
        {"shard_ids": [...], "columns": {name: [values]}}."""
        b = self._json_body()
        self.api.import_dataframe(index, int(shard),
                                  self._require(b, "shard_ids"),
                                  self._require(b, "columns"))
        self._send(200, {"success": True})

    def get_dataframe(self, index: str, shard: str):
        self._send(200, self.api.dataframe_shard(index, int(shard)))

    def get_dataframe_schema(self, index: str):
        self._send(200, {"schema": self.api.dataframe_schema(index)})

    def delete_dataframe(self, index: str):
        self.api.delete_dataframe(index)
        self._send(200, {"success": True})

    def _degrade_shed_import(self, b: dict) -> None:
        """Ladder gate for the bulk-import ingress: SHED_BATCH and above
        refuse the whole request before any apply (429 + Retry-After);
        replica fan-out legs (``remote``) were already admitted at the
        entry node and pass through."""
        if not b.get("remote"):
            shed = getattr(self.api, "_degrade_shed_batch", None)
            if shed is not None:
                shed()

    def post_import(self, index: str):
        b = self._json_body()
        self._degrade_shed_import(b)
        self._charge_tenant_ingest(len(b.get("cols") or []), b)
        peer = self._gossip_apply(b)
        n = self.api.import_bits(
            index, self._require(b, "field"),
            rows=b.get("rows", []), cols=b.get("cols", []),
            row_keys=b.get("rowKeys"), col_keys=b.get("colKeys"),
            clear=bool(b.get("clear", False)), **self._remote_kw(b))
        self._send(200, self._gossip_reply(peer, {"changed": n}))

    def post_import_roaring(self, index: str, shard: str):
        """Shard-transactional roaring import (reference:
        http_handler.go:520 + api.go:1647). Body JSON: {"field": ...,
        "views": {view-name: base64 pilosa-roaring blob}, "clear": bool}.
        """
        b = self._json_body()
        # roaring blobs don't expose a row count pre-decode; charge one
        # unit per view as a coarse rate signal
        self._charge_tenant_ingest(len(b.get("views") or {}), b)
        peer = self._gossip_apply(b)
        views = {v: base64.b64decode(blob)
                 for v, blob in (b.get("views") or {}).items()}
        self.api.import_roaring(index, self._require(b, "field"), int(shard),
                                views, clear=bool(b.get("clear", False)),
                                **self._remote_kw(b))
        self._send(200, self._gossip_reply(peer, {"success": True}))

    def post_import_values(self, index: str):
        b = self._json_body()
        self._degrade_shed_import(b)
        self._charge_tenant_ingest(len(b.get("cols") or []), b)
        peer = self._gossip_apply(b)
        n = self.api.import_values(
            index, self._require(b, "field"), cols=b.get("cols", []),
            values=b.get("values", []), col_keys=b.get("colKeys"),
            **self._remote_kw(b))
        self._send(200, self._gossip_reply(peer, {"imported": n}))

    def get_backup_tar(self):
        import io

        buf = io.BytesIO()
        self.api.backup_tar(buf)
        body = buf.getvalue()
        self.send_response(200)
        self.send_header("Content-Type", "application/x-gtar")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def post_restore(self):
        import io

        self.api.restore_tar(io.BytesIO(self._body()))
        self._send(200, {"success": True})

    def get_chksum(self):
        self._send(200, {"checksum": self.api.checksum()})

    def post_cache_flush(self):
        cache = getattr(self.api, "cache", None)
        if cache is None:
            self._send(200, {"enabled": False, "flushed": 0})
            return
        self._send(200, {"enabled": True, "flushed": cache.flush()})

    def get_cache_stats(self):
        cache = getattr(self.api, "cache", None)
        if cache is None:
            self._send(200, {"enabled": False})
            return
        self._send(200, {"enabled": True, **cache.stats()})

    def get_metrics(self):
        from pilosa_tpu_torch.obs.metrics import REGISTRY

        body = REGISTRY.prometheus_text().encode()
        self.send_response(200)
        self.send_header("Content-Type", "text/plain; version=0.0.4")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def get_metrics_json(self):
        from pilosa_tpu_torch.obs.metrics import REGISTRY

        self._send(200, REGISTRY.as_json())

    def get_query_history(self):
        from urllib.parse import parse_qs, urlsplit

        qs = parse_qs(urlsplit(self.path).query)
        limit = None
        if "n" in qs:
            try:
                limit = int(qs["n"][0])
            except ValueError:
                self._send(400, {"error": "n must be an integer"})
                return
        self._send(200, [r.to_json()
                         for r in self.api.history.list(limit=limit)])

    # -- health plane (obs/health.py) --------------------------------------

    def _health_plane(self):
        return getattr(self.api, "health", None)

    def _window_param(self, default=None):
        from urllib.parse import parse_qs, urlsplit

        qs = parse_qs(urlsplit(self.path).query)
        if "window" not in qs:
            return default
        return float(qs["window"][0])

    def get_stats_timeline(self):
        hp = self._health_plane()
        if hp is None:
            self._send(200, {"enabled": False})
            return
        try:
            window = self._window_param()
        except ValueError:
            self._send(400, {"error": "window must be a number"})
            return
        self._send(200, hp.timeline_json(window))

    def get_stats_cluster(self):
        try:
            window = self._window_param(default=60.0)
        except ValueError:
            self._send(400, {"error": "window must be a number"})
            return
        fanout = getattr(self.api, "cluster_stats", None)
        if fanout is not None:
            self._send(200, fanout(window))
            return
        # single-node API: the "cluster" is just us
        hp = self._health_plane()
        local = (hp.timeline_json(window) if hp is not None
                 else {"enabled": False})
        self._send(200, {"window_s": window, "nodes": {"local": local},
                         "cluster": {"nodes_reporting":
                                     1 if hp is not None else 0}})

    def get_slo(self):
        hp = self._health_plane()
        if hp is None:
            self._send(200, {"enabled": False})
            return
        self._send(200, {"enabled": True, **hp.slo.status()})

    def get_internal_tenants(self):
        reg = getattr(self.api, "tenants", None)
        if reg is None:
            self._send(200, {"enabled": False})
            return
        self._send(200, {"enabled": True, **reg.stats_json()})

    def get_internal_degrade(self):
        deg = getattr(self.api, "degrade", None)
        if deg is None:
            self._send(200, {"enabled": False})
            return
        self._send(200, deg.probe())

    def get_stats_kernels(self):
        # the devprof registry is process-global (not hung off the
        # health plane): every launch of this process is in it
        from pilosa_tpu_torch.obs import devprof

        self._send(200, devprof.stats_json())

    def get_stats_stream(self):
        svc = getattr(self.api, "stream", None)
        self._send(200, svc.stats() if svc is not None else
                   {"enabled": False})

    def post_stream_push(self, index: str):
        """Push records into the streaming ingest broker. Saturation
        (device stages behind, backlog over limit) surfaces as 429 via
        AdmissionError -> _dispatch, telling producers to back off."""
        svc = getattr(self.api, "stream", None)
        if svc is None or svc.index != index:
            raise KeyError(f"no stream service on index {index!r}")
        body = self._json_body()
        records = body.get("records") or []
        self._charge_tenant_ingest(len(records))
        self._send(200, svc.push(records))

    def get_debug_bundles(self):
        hp = self._health_plane()
        if hp is None:
            self._send(200, {"enabled": False, "bundles": []})
            return
        self._send(200, {"enabled": True,
                         "bundles": hp.flight.summaries()})

    def get_debug_bundle(self, bundle_id: str):
        hp = self._health_plane()
        if hp is None:
            raise KeyError("health plane disabled (enable [obs.timeline])")
        self._send(200, hp.flight.get(bundle_id))  # KeyError -> 404

    def get_analysis_locks(self):
        """Lock-acquisition graph + violations from the lock tracer
        (analysis/locktrace.py); {"enabled": false} with empty tables
        when PILOSA_TPU_LOCKCHECK is off."""
        from pilosa_tpu_torch.analysis import locktrace

        self._send(200, locktrace.report())

    def get_internal_traces(self):
        """Newest-first summaries of finished traces (the span trees stay
        behind /internal/traces/{id})."""
        from pilosa_tpu_torch.obs.tracing import get_tracer

        store = get_tracer().store
        self._send(200, {"enabled": store is not None,
                         "traces": store.list() if store is not None else []})

    def get_internal_trace(self, trace_id: str):
        from pilosa_tpu_torch.obs.tracing import get_tracer

        store = get_tracer().store
        if store is None:
            raise KeyError("trace store disabled (enable [obs.tracing])")
        self._send(200, store.get(trace_id))  # KeyError -> 404

    def get_mutex_check(self, index: str):
        from pilosa_tpu_torch.server.maintenance import mutex_check

        out = mutex_check(self.api.holder, index)
        self._send(200, {f: {str(c): rows for c, rows in bad.items()}
                         for f, bad in out.items()})

    def post_transaction(self):
        from pilosa_tpu_torch.transaction import TransactionError

        b = self._json_body()
        try:
            tx = self.api.transactions.start(
                tid=b.get("id"), timeout_s=b.get("timeout"),
                exclusive=bool(b.get("exclusive", False)))
        except TransactionError as e:
            self._send(409, {"error": str(e)})
            return
        self._send(200, {"transaction": tx.to_json()})

    def get_transaction(self, tid: str):
        from pilosa_tpu_torch.transaction import TransactionError

        try:
            tx = self.api.transactions.get(tid)
        except TransactionError as e:
            self._send(404, {"error": str(e)})
            return
        self._send(200, {"transaction": tx.to_json()})

    def post_transaction_finish(self, tid: str):
        from pilosa_tpu_torch.transaction import TransactionError

        try:
            tx = self.api.transactions.finish(tid)
        except TransactionError as e:
            self._send(404, {"error": str(e)})
            return
        self._send(200, {"transaction": tx.to_json()})

    def get_transactions(self):
        self._send(200, {"transactions": [
            t.to_json() for t in self.api.transactions.list()]})

    def get_schema(self):
        self._send(200, {"indexes": self.api.schema()})

    def get_status(self):
        status_fn = getattr(self.api, "status", None)
        if status_fn is not None:
            self._send(200, status_fn())
            return
        self._send(200, {"state": "NORMAL", "indexes": sorted(
            self.api.holder.indexes)})

    def get_version(self):
        """(reference: /version, http_handler.go handleGetVersion)."""
        from pilosa_tpu_torch import __version__

        self._send(200, {"version": __version__})

    def get_health(self):
        """Liveness probe (reference: /health — 200 while serving)."""
        self._send(200, {"state": "healthy"})

    def get_schema_details(self):
        """Schema with per-field detail incl. row cardinality (reference:
        /schema/details includes cardinality the plain /schema omits)."""
        out = []
        for iname in sorted(self.api.holder.indexes):
            idx = self.api.holder.index(iname)
            fields = []
            for f in idx.public_fields():
                if f.options.type.is_bsi:
                    # BSI fields: distinct stored values via the
                    # device-accelerated Distinct kernel
                    if f.bsi:
                        card = self.api.query(
                            iname, f"Count(Distinct(field={f.name}))")[0]
                    else:
                        card = 0
                else:
                    rows = set()
                    for frags in list(f.views.values()):
                        for frag in list(frags.values()):
                            rows.update(frag.existing_rows())
                    card = len(rows)
                fields.append({"name": f.name,
                               "options": f.options.to_json(),
                               "cardinality": card})
            out.append({"name": iname, "fields": fields,
                        "options": idx.options.to_json()})
        self._send(200, {"indexes": out})

    def get_internal_nodes(self):
        """(reference: /internal/nodes — the membership list)."""
        snap_fn = getattr(self.api, "snapshot", None)
        if snap_fn is None:
            self._send(200, [{"id": "local", "uri": "", "state": "STARTED"}])
            return
        self._send(200, [n.to_json() for n in snap_fn().nodes])

    def get_shards_max(self):
        """(reference: /internal/shards/max — max shard per index)."""
        out = {}
        for iname in self.api.holder.indexes:
            idx = self.api.holder.index(iname)
            shards = set()
            for f in idx.fields.values():
                shards |= f.shards()
            out[iname] = max(shards) if shards else 0
        self._send(200, {"standard": out})

    def get_index_shards(self, index: str):
        """(reference: /internal/index/{i}/shards)."""
        all_fn = getattr(self.api, "all_shards", None)
        if all_fn is not None:
            shards = sorted(all_fn(index))
        else:
            idx = self.api.holder.index(index)
            shards = sorted(set().union(
                *[f.shards() for f in idx.fields.values()]) or set())
        self._send(200, {"shards": shards})

    def get_partition_nodes(self):
        """(reference: /internal/partition/nodes?partition=N)."""
        from urllib.parse import parse_qs, urlsplit

        self._node_only()
        q = parse_qs(urlsplit(self.path).query)
        p = int((q.get("partition") or ["0"])[0])
        snap = self.api.snapshot()
        self._send(200, [n.to_json() for n in snap.partition_nodes(p)])

    def get_oauth_config(self):
        """(reference: /internal/oauth-config — the IdP config minus the
        client secret, authenticate.go CleanOAuthConfig)."""
        oidc = getattr(self.auth, "oidc", None) if self.auth else None
        if oidc is None:
            raise KeyError("OIDC not configured")
        c = oidc.config
        self._send(200, {"authUrl": c.auth_url, "tokenUrl": c.token_url,
                         "groupEndpoint": c.group_endpoint,
                         "logoutEndpoint": c.logout_endpoint,
                         "clientId": c.client_id,
                         "redirectUrl": c.redirect_url,
                         "scopes": c.scopes})

    def get_userinfo(self):
        """(reference: /userinfo — the cookie session's identity)."""
        from pilosa_tpu_torch.server.auth import AuthError, _auth_cookies

        oidc = getattr(self.auth, "oidc", None) if self.auth else None
        if oidc is None:
            raise KeyError("OIDC not configured")
        access, refresh = _auth_cookies(self.headers)
        try:
            info = oidc.authenticate(access, refresh)
        except AuthError as e:
            self._send(e.code, {"error": str(e)})
            return
        if info.get("rotated"):
            # re-set cookies, or a one-time-use refresh token is lost
            self._pending_cookies = _token_cookies(
                info["access"], info["refresh"],
                secure=self._secure_cookies())
        self._send(200, {"userid": info["userid"],
                         "username": info["username"],
                         "groups": [{"id": g} for g in info["groups"]]})

    def get_queries(self):
        """Currently executing queries (reference: /queries; completed
        history rides /query-history)."""
        hist = getattr(self.api, "history", None)
        if hist is None:
            self._send(200, {"queries": []})
            return
        self._send(200, {"queries": [r.to_json() for r in hist.list()
                                     if r.status == "running"]})

    def post_recalculate_caches(self):
        """(reference: /recalculate-caches — forces TopN cache rebuilds;
        this engine recounts on device, so there is nothing to rebuild
        and the call acks immediately.)"""
        self._send(200, {})

    def get_shard_distribution(self):
        """(reference: /ui/shard-distribution — shard->node placement)."""
        snap_fn = getattr(self.api, "snapshot", None)
        out: dict = {}
        for iname in sorted(self.api.holder.indexes):
            if snap_fn is None:
                out[iname] = {"local": sorted(
                    set().union(*[f.shards() for f in self.api.holder
                                  .index(iname).fields.values()])
                    or set())}
                continue
            snap = snap_fn()
            per: dict = {}
            for s in sorted(self.api.all_shards(iname)):
                owner = snap.shard_nodes(iname, s)[0].id
                per.setdefault(owner, []).append(s)
            out[iname] = per
        self._send(200, out)

    def post_cpu_profile_start(self):
        """(reference: /cpu-profile/start — process-wide profile until
        /cpu-profile/stop)."""
        import cProfile

        cls = type(self)
        if getattr(cls, "_cpu_profile", None) is not None:
            raise ValueError("cpu profile already running")
        cls._cpu_profile = cProfile.Profile()
        cls._cpu_profile.enable()
        self._send(200, {})

    def post_cpu_profile_stop(self):
        import io as _io
        import pstats

        cls = type(self)
        prof = getattr(cls, "_cpu_profile", None)
        if prof is None:
            raise ValueError("no cpu profile running")
        prof.disable()
        cls._cpu_profile = None
        s = _io.StringIO()
        pstats.Stats(prof, stream=s).sort_stats("cumulative").print_stats(50)
        self._send(200, {"profile": s.getvalue().splitlines()})

    def post_translate_field_keys_like(self, index: str, field: str):
        """(reference: /internal/translate/.../keys/like — LIKE-pattern
        row-key search used by SQL LIKE pushdown on keyed fields). Uses
        the engine's own LIKE semantics (metachars escaped, case-
        insensitive) so pushdown and host evaluation agree."""
        from pilosa_tpu_torch.sql.plan import _like_to_regex

        pat = self._json_body().get("like") or ""
        rx = _like_to_regex(pat)
        store = self._translate_store(index, field)
        out = {k: v for k, v in store.key_to_id.items() if rx.match(k)}
        self._send(200, {"ids": out})

    # -- internal (node-to-node) handlers ---------------------------------

    def _remote_kw(self, b: dict) -> dict:
        """An import body's ``remote`` flag, for a cluster node (a leg
        another node forwarded); a plain API applies every import alike."""
        if not hasattr(self.api, "query_remote"):
            return {}
        return {"remote": bool(b.get("remote", False))}

    def _node_only(self):
        """Internal endpoints exist only on cluster nodes (the plain API
        has no peers)."""
        if not hasattr(self.api, "query_remote"):
            raise KeyError("not a cluster node")

    # -- gossip piggybacking (gossip/agent.py) -----------------------------

    def _gossip_apply(self, body):
        """Apply a piggybacked request envelope BEFORE running the
        request; returns the sender's node id (for the reply window) or
        None. A write's envelope lands first, so the forwarded write's
        version bumps are visible to what runs below it."""
        env = body.get("gossip") if isinstance(body, dict) else None
        agent = getattr(self.api, "gossip", None)
        if agent is None or not isinstance(env, dict):
            return None
        agent.receive(env)
        return env.get("from")

    def _gossip_reply(self, peer, payload: dict) -> dict:
        """Attach our envelope to the response AFTER running the
        request: a write handled above has already bumped the local
        versions, so the caller applies our new seqs with no stale
        window."""
        agent = getattr(self.api, "gossip", None)
        if agent is not None and peer is not None:
            payload["gossip"] = agent.envelope(peer)
        return payload

    def post_internal_query(self, index: str):
        self._node_only()
        b = self._json_body()
        peer = self._gossip_apply(b)
        results = self.api.query_remote(
            index, self._require(b, "query"), b.get("shards") or [])
        self._send(200, self._gossip_reply(peer, {"results": results}))

    def post_internal_query_batch(self):
        """A coordinator's coalesced node batch (cluster/batch.py): every
        entry runs against this node's shards through the fused remote
        executor, with per-entry error slots so the caller can demux
        partial failures. The gossip envelope and the trace tree ride
        the batch once."""
        self._node_only()
        serve_batch = getattr(self.api, "query_remote_batch", None)
        if serve_batch is None:
            raise KeyError("peer does not serve query batches")
        b = self._json_body()
        peer = self._gossip_apply(b)
        out = serve_batch(self._require(b, "queries"))
        self._send(200, self._gossip_reply(peer, {"results": out}))

    def post_cluster_message(self):
        self._node_only()
        b = self._json_body()
        peer = self._gossip_apply(b)
        self.api.receive_message(b)
        self._send(200, self._gossip_reply(peer, {"success": True}))

    def post_translate_replicate(self):
        """Follower side of the translate replication stream (reference:
        translate.go EntryReader)."""
        self._node_only()
        b = self._json_body()
        idx = self.api.holder.index(self._require(b, "index"))
        field = b.get("field")
        store = idx.translate if field is None \
            else idx.field(field).translate
        store.apply_entries(b.get("entries") or [])
        self._send(200, {"success": True})

    def post_sql_subtree(self):
        """Serve a coordinator's SQL subtree on this node's shards
        (sql/fanout.py; reference: /sql-exec-graph)."""
        self._node_only()
        from pilosa_tpu_torch.sql.fanout import execute_subtree

        b = self._json_body()
        self._send(200, execute_subtree(
            self.api, self._require(b, "spec"), b.get("shards") or []))

    def post_gossip_exchange(self):
        self._node_only()
        agent = getattr(self.api, "gossip", None)
        if agent is None:
            self._send(200, {"enabled": False})
            return
        b = self._json_body()
        env = b.get("gossip")
        peer = None
        if isinstance(env, dict):
            agent.receive(env)
            peer = env.get("from")
        self._send(200, {"enabled": True,
                         "gossip": agent.envelope(peer)})

    def get_gossip_state(self):
        self._node_only()
        agent = getattr(self.api, "gossip", None)
        if agent is None:
            self._send(200, {"enabled": False})
            return
        self._send(200, {"enabled": True, **agent.state_json()})

    def post_membership_ping(self):
        """SWIM direct probe / ping-req relay. The piggybacked envelope
        applies FIRST, so a ping that carries a suspicion of US makes us
        refute before we build the reply, and the refuting alive record
        rides back on this response."""
        self._node_only()
        b = self._json_body()
        peer = self._gossip_apply(b)
        out = self.api.membership_ping(b)
        self._send(200, self._gossip_reply(peer, out))

    def get_membership(self):
        self._node_only()
        self._send(200, self.api.membership_json())

    def get_recovery_snapshot(self):
        """One shard's snapshot and the WAL LSN it covers, for replica
        catch-up (storage/recovery.py). Taken under the write lock, so
        planes and LSN agree exactly: every record <= lsn is in the
        arrays, every record > lsn in the shipped tail."""
        import io
        from urllib.parse import parse_qs, urlsplit

        import numpy as np

        from pilosa_tpu_torch.storage.store import export_shard_arrays

        self._node_only()
        qs = parse_qs(urlsplit(self.path).query)
        index = qs.get("index", [""])[0]
        shard = int(qs.get("shard", ["0"])[0])
        holder = self.api.holder
        idx = holder.index(index)
        with holder.write_lock:
            if idx.wal is not None:
                idx.wal.flush()
            arrays = export_shard_arrays(idx, shard)
            lsn = idx.wal.last_lsn if idx.wal is not None else 0
        buf = io.BytesIO()
        if arrays:
            np.savez_compressed(buf, **arrays)
        self._send(200, {
            "index": index, "shard": shard, "lsn": lsn,
            "npz": base64.b64encode(buf.getvalue()).decode()
            if arrays else "",
        })

    def get_recovery_wal(self):
        """A batch of this node's WAL tail above ``since`` as raw CRC
        frames (wal.tail_bytes). ``floor_lsn`` is the checkpoint LSN: a
        caller whose ``since`` is below it raced a prune and must take a
        snapshot again before it trusts the tail."""
        from urllib.parse import parse_qs, urlsplit

        from pilosa_tpu_torch.storage.recovery import read_checkpoint_meta

        self._node_only()
        qs = parse_qs(urlsplit(self.path).query)
        index = qs.get("index", [""])[0]
        since = int(qs.get("since", ["0"])[0])
        max_bytes = int(qs.get("max_bytes", [str(1 << 20)])[0])
        holder = self.api.holder
        idx = holder.index(index)
        if idx.wal is None:
            self._send(200, {"frames": "", "last_lsn": since,
                             "more": False, "floor_lsn": 0})
            return
        frames, last, more = idx.wal.tail_bytes(since, max_bytes)
        # the meta AFTER the tail read: a checkpoint stamps the meta
        # before it prunes, so any prune that could have removed
        # segments while tail_bytes ran shows in this floor, and a tail
        # with a gap always arrives with floor > since
        floor = read_checkpoint_meta(holder._index_path(index))
        self._send(200, {
            "frames": base64.b64encode(frames).decode(),
            "last_lsn": last, "more": more, "floor_lsn": floor,
        })

    def post_grpc(self, method: str):
        """gRPC method over HTTP/1.1 with standard gRPC message framing
        (server/grpc.py; grpc-status rides a header since HTTP/1.1 lacks
        trailers)."""
        from pilosa_tpu_torch.server.grpc import PilosaServicer, frame, unframe

        body = self._body()
        messages = unframe(body) if body else [b""]
        request = messages[0] if messages else b""
        parsed_sql = None
        if self.auth is not None:
            parsed_sql = self._authorize_grpc(method, request)
        from pilosa_tpu_torch.server.grpc import UnknownGRPCMethod

        try:
            responses = PilosaServicer(self.api).call(
                method, request, parsed_sql=parsed_sql)
        except UnknownGRPCMethod as e:
            self._send_grpc(b"", status=12, message=str(e))  # UNIMPLEMENTED
            return
        except KeyError as e:
            self._send_grpc(b"", status=5, message=str(e))  # NOT_FOUND
            return
        except Exception as e:
            self._send_grpc(b"", status=13, message=str(e))  # INTERNAL
            return
        self._send_grpc(b"".join(frame(m) for m in responses))

    def _authorize_grpc(self, method: str, request: bytes) -> None:
        """Per-method gRPC authz mirroring the HTTP routes (reference:
        the same chkAuthZ levels apply to grpc handlers): index CRUD is
        admin, queries escalate read -> write/admin on their content."""
        from pilosa_tpu_torch.server import proto as P

        ctx = self._auth_ctx
        if method in ("CreateIndex", "DeleteIndex"):
            self.auth.authorize(ctx, "admin", None)
        elif method in ("QueryPQL", "QueryPQLUnary"):
            from pilosa_tpu_torch.pql.executor import has_write_calls
            from pilosa_tpu_torch.pql.parser import parse

            req = P.decode_query_pql_request(request)
            self.auth.authorize(ctx, "read", req["index"])
            if has_write_calls(parse(req["pql"])):
                self.auth.authorize(ctx, "write", req["index"])
        elif method in ("QuerySQL", "QuerySQLUnary"):
            req = P.decode_query_sql_request(request)
            return self._authorize_sql(req["sql"])
        elif method == "Inspect":
            req = P.decode_inspect_request(request)
            self.auth.authorize(ctx, "read", req["index"])
        elif method in ("GetIndex", "GetIndexes"):
            pass  # names only; route-level read suffices
        return None

    def _send_grpc(self, payload: bytes, status: int = 0,
                   message: str = "") -> None:
        self.send_response(200)
        self.send_header("Content-Type", "application/grpc")
        self.send_header("grpc-status", str(status))
        if message:
            self.send_header("grpc-message", message.replace("\n", " "))
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def get_shard_snapshot(self, index: str, shard: str):
        """Stream one shard's planes as npz (reference: api.go:1265 —
        backup reads per-shard snapshots concurrently with writes; our
        export walks versioned host planes, so it is consistent per
        fragment)."""
        import io as _io

        import numpy as _np

        from pilosa_tpu_torch.storage.store import export_shard_arrays

        idx = self.api.holder.index(index)
        arrays = export_shard_arrays(idx, int(shard))
        buf = _io.BytesIO()
        _np.savez_compressed(buf, **arrays)
        data = buf.getvalue()
        self.send_response(200)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def post_idalloc_reserve(self):
        b = self._json_body()
        rng = self.api.idalloc.reserve(
            self._require(b, "session"), int(self._require(b, "count")),
            int(b.get("offset", 0)))
        self._send(200, {"base": rng.base, "count": rng.count})

    def post_idalloc_commit(self):
        b = self._json_body()
        self.api.idalloc.commit(self._require(b, "session"),
                                b.get("count"))
        self._send(200, {"success": True})

    def get_pprof(self):
        """Thread stack dump (the Python analog of goroutine profiles at
        /debug/pprof; per-query CPU profiling rides ?profile=true on
        query routes)."""
        import sys
        import traceback

        stacks = {}
        for tid, frame in sys._current_frames().items():
            stacks[str(tid)] = traceback.format_stack(frame)
        self._send(200, {"threads": stacks})

    def post_directive(self):
        """DAX assignment push (reference: api_directive.go:21
        ApplyDirective); only compute nodes implement it."""
        apply = getattr(self.api, "apply_directive", None)
        if apply is None:
            raise KeyError("not a DAX compute node")
        self._send(200, apply(self._json_body()))

    # -- resource accounting (reference: http_handler.go:557-559) ----------

    def get_mem_usage(self):
        """Process + holder memory accounting (reference:
        /internal/mem-usage)."""
        import resource

        ru = resource.getrusage(resource.RUSAGE_SELF)
        holder_bytes = 0
        # list() snapshots: concurrent imports mutate these dicts and a
        # live iteration would intermittently RuntimeError under load
        for idx in list(self.api.holder.indexes.values()):
            for fld in list(idx.fields.values()):
                for frags in list(fld.views.values()):
                    for frag in list(frags.values()):
                        holder_bytes += frag.planes.nbytes
                for frag in list(fld.bsi.values()):
                    holder_bytes += frag.planes.nbytes
        self._send(200, {
            "maxRSSBytes": ru.ru_maxrss * 1024,  # linux reports KiB
            "holderPlaneBytes": holder_bytes,
        })

    def get_disk_usage(self, index: str = None):
        """On-disk footprint of the holder (or one index) — reference:
        /disk-usage and /disk-usage/{index}."""
        import os as _os

        root = self.api.holder.path
        if root is None:
            self._send(200, {"usage": 0})
            return
        if index is not None:
            self.api.holder.index(index)  # 404 on unknown index
            root = _os.path.join(root, "indexes", index)
        total = 0
        for dirpath, _dirs, files in _os.walk(root):
            for f in files:
                try:
                    total += _os.path.getsize(_os.path.join(dirpath, f))
                except OSError:
                    pass
        self._send(200, {"usage": total})

    # -- OIDC login flow (reference: authn/authenticate.go:251-300) --------

    def _oidc(self):
        oidc = getattr(self.auth, "oidc", None) if self.auth else None
        if oidc is None:
            raise KeyError("OIDC login is not configured")
        return oidc

    def _secure_cookies(self) -> bool:
        return bool(getattr(self.auth, "secure_cookies", False))

    def get_login(self):
        oidc = self._oidc()
        state = oidc.new_state()
        # bind the state to THIS browser: /redirect requires the cookie
        # to match the query state (login-CSRF hardening)
        self._pending_cookies = [
            _state_cookie(state, secure=self._secure_cookies())]
        self._redirect(oidc.login_url(state))

    def get_redirect(self):
        from urllib.parse import parse_qs, urlparse

        oidc = self._oidc()
        q = parse_qs(urlparse(self.path).query)
        code = (q.get("code") or [""])[0]
        if not code:
            raise ValueError("missing code")
        state = (q.get("state") or [""])[0]
        if self._state_from_cookie() != state or not oidc.check_state(state):
            # unknown/expired state, or a state this browser did not
            # initiate (no/mismatched state cookie): a code this
            # server's /login did not hand THIS user agent must not set
            # session cookies (login CSRF)
            from pilosa_tpu_torch.server.auth import AuthError
            raise AuthError(403, "invalid OAuth state")
        access, refresh = oidc.exchange_code(code)
        secure = self._secure_cookies()
        self._pending_cookies = _token_cookies(access, refresh,
                                               secure=secure)
        self._pending_cookies.append(_state_cookie("", secure=secure,
                                                   expire=True))
        self._redirect("/")

    def _state_from_cookie(self) -> str:
        from http.cookies import SimpleCookie

        jar = SimpleCookie()
        try:
            jar.load(self.headers.get("Cookie") or "")
        except Exception:
            return ""
        return jar[_STATE_COOKIE].value if _STATE_COOKIE in jar else ""

    def get_logout(self):
        from pilosa_tpu_torch.server.auth import _auth_cookies

        oidc = self._oidc()
        access, _ = _auth_cookies(self.headers)
        oidc.evict(access)  # drop this session's cached groups
        self._pending_cookies = _token_cookies(
            "", "", expire=True, secure=self._secure_cookies())
        self._redirect(oidc.logout_url())

    def _translate_store(self, index: str, field: str = None):
        idx = self.api.holder.index(index)
        store = idx.translate if field is None else idx.field(field).translate
        if store is None:
            raise ValueError(f"no key translation on {index}/{field or ''}")
        return store

    def _translator(self):
        """A node's ClusterTranslator (None on a plain API)."""
        return getattr(getattr(self.api, "executor", None), "translator",
                       None)

    def post_translate_index_keys(self, index: str, op: str):
        keys = self._json_body().get("keys") or []
        tr = self._translator()
        if op == "create" and tr is not None:
            # owner-side create replicates new entries to the partition's
            # replicas (reference: TranslationSyncer push)
            ids = tr.create_local(index, None, keys)
        else:
            store = self._translate_store(index)
            ids = (store.create_keys(keys) if op == "create"
                   else store.find_keys(keys))
        self._send(200, {"ids": ids})

    def post_translate_index_ids(self, index: str):
        ids = self._json_body().get("ids") or []
        self._send(200, {"keys": self._translate_store(index).translate_ids(ids)})

    def post_translate_field_keys(self, index: str, field: str, op: str):
        keys = self._json_body().get("keys") or []
        tr = self._translator()
        if op == "create" and tr is not None:
            ids = tr.create_local(index, field, keys)
        else:
            store = self._translate_store(index, field)
            ids = (store.create_keys(keys) if op == "create"
                   else store.find_keys(keys))
        self._send(200, {"ids": ids})

    def post_translate_field_ids(self, index: str, field: str):
        ids = self._json_body().get("ids") or []
        self._send(200, {"keys": self._translate_store(
            index, field).translate_ids(ids)})

    def get_info(self):
        self._send(200, self.api.info())


def serve(api: API, host: str = "127.0.0.1", port: int = 10101,
          background: bool = False, maintenance_interval_s: Optional[float] = None,
          auth=None
          ) -> Tuple[ThreadingHTTPServer, Optional[threading.Thread]]:
    """Start the HTTP server (reference: server.go:618 Open + listener).
    With background=True returns (server, thread) for in-process use —
    the test harness pattern (reference: test/cluster.go). A maintenance
    interval starts the TTL view-removal loop (reference: server.go:902
    ViewsRemoval ticker). ``auth`` (a server.auth.Auth) enables per-route
    JWT gating (reference: http_handler.go chkAuthZ)."""
    handler = type("BoundHandler", (Handler,), {"api": api, "auth": auth})

    class _Server(ThreadingHTTPServer):
        maintenance_loop = None
        # socketserver's default backlog of 5 drops loopback connects
        # under burst fan-in (a 64-way wave outruns accept()), and an
        # exhausted-retries connect reads as node death to the fan-out,
        # which then marks a perfectly live peer down in membership
        request_queue_size = 128

        def server_close(self):  # stop the sweep with the listener
            if self.maintenance_loop is not None:
                self.maintenance_loop.stop()
            super().server_close()

        def shutdown(self):
            if self.maintenance_loop is not None:
                self.maintenance_loop.stop()
            super().shutdown()

    srv = _Server((host, port), handler)
    if maintenance_interval_s:
        from pilosa_tpu_torch.server.maintenance import MaintenanceLoop

        loop = MaintenanceLoop(api.holder, interval_s=maintenance_interval_s)
        loop.start()
        srv.maintenance_loop = loop
    if background:
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        return srv, t
    srv.serve_forever()
    return srv, None
