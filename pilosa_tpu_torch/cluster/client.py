"""InternalClient: node-to-node RPC over HTTP+JSON.

Port of ``pilosa_tpu/cluster/client.py`` (reference: internal_client.go,
SURVEY.md §5.8): query fan-out (QueryNode :602), import forwarding
(:691-931), the translate-key RPCs, broadcasts and peer status. Retries
with jittered backoff like retryablehttp (internal_client.go:1744); a
transport failure surfaces as NodeDownError, so the executor fails over
to a replica (executor.go:6500-6515). Every request carries the
caller's ``traceparent`` and tenant (``x-tenant``), and a traced peer's
span tree comes back on its response and is grafted under the calling
span.

Transport: per-node keep-alive connection pools (the server speaks
HTTP/1.1 with Content-Length on every response), so repeated legs to
the same peer reuse a socket. A pooled connection the peer quietly
closed gets one fresh-socket retry that does not use up a retry or
consult the fault plan again.

A ``FaultPlan`` (``cluster/resilience.py``) set as ``fault_plan`` is
consulted before every send attempt, keyed on the target node id. With a
gossip agent set as ``gossip`` (``ClusterNode.enable_gossip``), query,
import, message and ping payloads carry its envelope and the envelope on
each response is applied (gossip/agent.py).
"""
from __future__ import annotations

import http.client
import json
import random
import socket
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional, Sequence
from urllib.parse import quote, urlsplit

from pilosa_tpu_torch.analysis import locktrace
from pilosa_tpu_torch.obs.tenants import current_tenant_id
from pilosa_tpu_torch.obs.tracing import active_span, current_traceparent


class NodeDownError(ConnectionError):
    """The peer did not answer at the transport level — retarget replicas."""


class RemoteError(RuntimeError):
    """The peer answered with an application error (4xx/5xx)."""

    def __init__(self, status: int, message: str):
        super().__init__(f"remote status {status}: {message}")
        self.status = status


class LegCancelled(RuntimeError):
    """This leg's cancellation token fired (it lost a hedge race or its
    query completed/expired). Deliberately NOT an OSError/ConnectionError:
    the retry loop must not swallow it and the executor must not count it
    as a node failure."""


class _ConnPool:
    """Bounded per-node pool of keep-alive HTTP connections.

    Keyed on the target node id when the caller knows it (so a node's
    sockets can be evicted by id) and on netloc otherwise.
    ``per_key`` bounds idle sockets per node; overflow returns close
    rather than queue — a fan-out burst briefly opens extras and the
    steady state keeps the newest ``per_key``."""

    def __init__(self, per_key: int = 4):
        self.per_key = max(1, int(per_key))
        self._lock = locktrace.tracked_lock("cluster.client.pool")
        self._idle: Dict[str, List[http.client.HTTPConnection]] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key: str) -> Optional[http.client.HTTPConnection]:
        with self._lock:
            conns = self._idle.get(key)
            if conns:
                self.hits += 1
                return conns.pop()
            self.misses += 1
            return None

    def put(self, key: str, conn: http.client.HTTPConnection) -> None:
        with self._lock:
            conns = self._idle.setdefault(key, [])
            if len(conns) < self.per_key:
                conns.append(conn)
                return
            self.evictions += 1
        conn.close()

    def evict(self, key: str) -> int:
        """Close every idle socket for a node (it was paused or failed:
        whatever made it fail may have wedged its half of the
        connections)."""
        with self._lock:
            conns = self._idle.pop(key, [])
            self.evictions += len(conns)
        for c in conns:
            c.close()
        return len(conns)

    def close(self) -> None:
        with self._lock:
            all_conns = [c for conns in self._idle.values() for c in conns]
            self._idle.clear()
        for c in all_conns:
            c.close()


class InternalClient:
    def __init__(self, timeout: float = 30.0, retries: int = 2,
                 backoff: float = 0.05, sleep=None, rng=None,
                 fault_plan=None, pool_size: int = 4):
        self.timeout = timeout
        self.retries = retries
        self.backoff = backoff
        # Injectable for tests (sched/clock.py clocks provide .wait); the
        # retry path never calls bare time.sleep directly.
        self._sleep = sleep if sleep is not None else time.sleep
        self._rng = rng if rng is not None else random.Random()
        # Optional cluster/resilience.FaultPlan consulted before every
        # send, keyed on the target node id (duck-typed: anything with
        # on_request(node_id, token=, op=)).
        self.fault_plan = fault_plan
        # The node id this client sends AS (ClusterNode sets it). Only
        # when it is set do FaultPlan partition rules see a source, so
        # anonymous clients and fault doubles that take no source= keep
        # working unchanged.
        self.self_id: Optional[str] = None
        self.pool = _ConnPool(per_key=pool_size)
        # Optional gossip.GossipAgent: when set, query/import/broadcast
        # requests carry a piggybacked gossip envelope and responses'
        # envelopes are applied, so cluster metadata spreads with no
        # extra round trips. ClusterNode.enable_gossip wires this.
        self.gossip = None
        # wire-RPC accounting by op tag (one increment per actual send
        # attempt, retries included)
        self.op_counts: Dict[str, int] = {}
        self._count_lock = locktrace.tracked_lock("cluster.client.counts")

    def evict_node(self, node_id: str) -> int:
        """Drop pooled sockets for a peer (a paused node's, in the
        harness; ClusterNode also wires this to the breaker's open
        transition)."""
        return self.pool.evict(node_id)

    def close(self) -> None:
        self.pool.close()

    # -- transport ---------------------------------------------------------

    def _request(self, method: str, url: str, body: Optional[bytes] = None,
                 ctype: str = "application/json", node_id: Optional[str] = None,
                 token=None, op: Optional[str] = None) -> dict:
        if locktrace.ACTIVE is not None:
            # the wire boundary: any lock held here is held across
            # blocking socket I/O (and loopback HTTP re-enters the
            # server, so it is also a latent distributed deadlock)
            locktrace.ACTIVE.note_io("cluster.client._request")
        last: Optional[Exception] = None
        for attempt in range(self.retries + 1):
            if token is not None and token.cancelled:
                raise LegCancelled(f"request to {node_id or url} cancelled")
            # a token's per-leg timeout caps the client's default
            timeout = self.timeout
            if token is not None and token.timeout_s is not None:
                timeout = max(1e-3, min(timeout, token.timeout_s))
            headers: Dict[str, str] = {}
            if body is not None:
                headers["Content-Type"] = ctype
            # W3C-style trace propagation: every RPC made under a sampled
            # span scope (query legs, retries, translate) carries the
            # context so the serving node's spans join the coordinator's
            # trace.
            tp = current_traceparent()
            if tp is not None:
                headers["traceparent"] = tp
                if attempt:
                    headers["x-trace-attempt"] = str(attempt)
            # tenant context rides internal RPCs the same way, so fan-out
            # legs and forwarded writes attribute to the original tenant
            tenant = current_tenant_id()
            if tenant is not None:
                headers["x-tenant"] = tenant
            try:
                if self.fault_plan is not None and node_id is not None:
                    if self.self_id is not None:
                        self.fault_plan.on_request(node_id, token=token,
                                                   op=op, source=self.self_id)
                    else:
                        self.fault_plan.on_request(node_id, token=token,
                                                   op=op)
                status, data = self._send_once(method, url, body, headers,
                                               timeout, node_id, op)
                if status >= 400:
                    msg = data.decode(errors="replace")
                    try:
                        msg = json.loads(msg).get("error", msg)
                    except Exception:
                        pass
                    raise RemoteError(status, msg)
                out = json.loads(data) if data else {}
                self._apply_trace(out)
                return out
            except (urllib.error.URLError, http.client.HTTPException,
                    socket.timeout, OSError) as e:
                last = e
                if attempt < self.retries:
                    # Jittered exponential backoff: full-jitter over
                    # [0.5x, 1.5x) of the nominal step so synchronized
                    # retry storms against a recovering peer decorrelate.
                    delay = (self.backoff * (2 ** attempt)
                             * (0.5 + self._rng.random()))
                    if token is not None:
                        if token.wait(delay):
                            raise LegCancelled(
                                f"request to {node_id or url} cancelled "
                                f"during backoff") from None
                    else:
                        self._sleep(delay)
        raise NodeDownError(str(last))

    def _send_once(self, method: str, url: str, body: Optional[bytes],
                   headers: Dict[str, str], timeout: float,
                   node_id: Optional[str],
                   op: Optional[str]) -> "tuple[int, bytes]":
        """One wire send over a pooled (or fresh) keep-alive connection.
        Returns (status, body-bytes); transport problems raise OSError /
        HTTPException for the caller's retry loop."""
        sp = urlsplit(url)
        with self._count_lock:
            key = op or "other"
            self.op_counts[key] = self.op_counts.get(key, 0) + 1
        if sp.scheme != "http":  # https/unix/etc: one-shot via urllib
            req = urllib.request.Request(url, data=body, method=method,
                                         headers=headers)
            try:
                with urllib.request.urlopen(req, timeout=timeout) as resp:
                    return resp.status, resp.read()
            except urllib.error.HTTPError as e:
                return e.code, e.read()
        pool_key = node_id or sp.netloc
        path = sp.path + (f"?{sp.query}" if sp.query else "")
        conn = self.pool.get(pool_key)
        pooled = conn is not None
        if conn is None:
            conn = http.client.HTTPConnection(sp.hostname, sp.port,
                                              timeout=timeout)
        # a pooled socket the server already closed fails at send or at
        # the status line — retry ONCE on a fresh socket, free of charge
        for fresh_retry in (False, True):
            try:
                conn.timeout = timeout
                if conn.sock is not None:
                    conn.sock.settimeout(timeout)
                conn.request(method, path, body=body, headers=headers)
                resp = conn.getresponse()
                data = resp.read()
                if resp.will_close:
                    conn.close()
                else:
                    self.pool.put(pool_key, conn)
                return resp.status, data
            except (OSError, http.client.HTTPException):
                conn.close()
                if not pooled or fresh_retry:
                    raise
                conn = http.client.HTTPConnection(sp.hostname, sp.port,
                                                  timeout=timeout)
        raise NodeDownError("unreachable")  # pragma: no cover

    def _post(self, node, path: str, payload: dict, token=None,
              op: Optional[str] = None) -> dict:
        return self._request("POST", node.uri + path,
                             json.dumps(payload).encode(),
                             node_id=node.id, token=token, op=op)

    def _get(self, node, path: str, token=None,
             op: Optional[str] = None) -> dict:
        return self._request("GET", node.uri + path, node_id=node.id,
                             token=token, op=op)

    # -- gossip piggybacking (gossip/agent.py) ------------------------------

    def _piggyback(self, node, payload: dict) -> dict:
        """A copy of ``payload`` carrying a gossip envelope for the
        target node (a copy: broadcast callers share one message dict
        across peers, and each peer gets its own delta window)."""
        g = self.gossip
        if g is None:
            return payload
        out = dict(payload)
        out["gossip"] = g.envelope(node.id)
        from pilosa_tpu_torch.obs import metrics as M

        g.registry.count(M.METRIC_GOSSIP_PIGGYBACKS)
        return out

    def _apply_gossip(self, out) -> None:
        """Apply the gossip envelope a server attached to its response."""
        g = self.gossip
        if g is not None and isinstance(out, dict):
            env = out.get("gossip")
            if isinstance(env, dict):
                g.receive(env)

    def _apply_trace(self, out) -> None:
        """Graft the remote span tree a traced server piggybacked on its
        response under the calling span (for a query leg, the cluster.leg
        span on this thread)."""
        if isinstance(out, dict):
            sub = out.pop("trace", None)
            if isinstance(sub, dict):
                active_span().add_remote(sub)

    # -- query fan-out (reference: internal_client.go:602 QueryNode) -------

    def query_node(self, node, index: str, pql: str,
                   shards: Sequence[int], token=None) -> List[dict]:
        """Run `pql` for the given shards on a peer; results come back as
        wire-tagged JSON (pql/result.py result_to_wire). ``token`` is a
        cancellation token (``cancelled``, ``timeout_s``, ``wait``): a
        cancelled token aborts the leg between retries, and its
        timeout_s caps the transport timeout."""
        out = self._post(node, f"/internal/index/{index}/query",
                         self._piggyback(node, {
                             "query": pql, "shards": list(shards),
                             "remote": True,
                         }), token=token, op="query")
        self._apply_gossip(out)
        return out["results"]

    def query_node_batch(self, node, entries: Sequence[dict],
                         token=None) -> List[dict]:
        """Ship many coalesced read legs to one peer as a single RPC
        (cluster/batch.py -> /internal/query-batch). Each entry carries
        ``index`` / ``query`` / ``shards``; the reply holds one slot per
        entry, ``{"results": [wire...]}`` on success or ``{"error": msg,
        "status": code}``, so one bad query never fails its
        batch-mates. The gossip envelope and the trace tree ride the
        batch once."""
        out = self._post(node, "/internal/query-batch",
                         self._piggyback(node, {
                             "queries": [{"index": e["index"],
                                          "query": e["query"],
                                          "shards": list(e["shards"])}
                                         for e in entries],
                             "remote": True,
                         }), token=token, op="query_batch")
        self._apply_gossip(out)
        return out["results"]

    # -- SQL subtree fan-out (reference: /sql-exec-graph,
    #    http_handler.go:538 + sql3/planner/wireprotocol.go) --------------

    def sql_subtree(self, node, spec: dict, shards: Sequence[int],
                    token=None) -> dict:
        return self._post(node, "/internal/sql/subtree",
                          {"spec": spec, "shards": list(shards)},
                          token=token, op="sql")

    # -- imports (reference: internal_client.go:691-931) -------------------

    def import_bits(self, node, index: str, field: str, payload: dict) -> dict:
        out = self._post(node, f"/index/{index}/import",
                         self._piggyback(node, payload), op="import")
        self._apply_gossip(out)
        return out

    def import_values(self, node, index: str, field: str, payload: dict) -> dict:
        out = self._post(node, f"/index/{index}/import-values",
                         self._piggyback(node, payload), op="import")
        self._apply_gossip(out)
        return out

    def import_roaring_shard(self, node, index: str, shard: int,
                             payload: dict) -> dict:
        out = self._post(
            node, f"/index/{index}/shard/{shard}/import-roaring",
            self._piggyback(node, payload), op="import")
        self._apply_gossip(out)
        return out

    # -- translation (reference: cluster.go:233-887 key RPC loops) ---------

    def create_index_keys(self, node, index: str, keys: List[str]) -> Dict[str, int]:
        out = self._post(node, f"/internal/translate/index/{index}/keys/create",
                         {"keys": keys}, op="translate")
        return {k: int(v) for k, v in out["ids"].items()}

    def find_index_keys(self, node, index: str, keys: List[str]) -> Dict[str, int]:
        out = self._post(node, f"/internal/translate/index/{index}/keys/find",
                         {"keys": keys}, op="translate")
        return {k: int(v) for k, v in out["ids"].items()}

    def translate_index_ids(self, node, index: str, ids: List[int]) -> Dict[int, str]:
        out = self._post(node, f"/internal/translate/index/{index}/ids",
                         {"ids": list(ids)}, op="translate")
        return {int(k): v for k, v in out["keys"].items()}

    def create_field_keys(self, node, index: str, field: str,
                          keys: List[str]) -> Dict[str, int]:
        out = self._post(
            node, f"/internal/translate/field/{index}/{field}/keys/create",
            {"keys": keys}, op="translate")
        return {k: int(v) for k, v in out["ids"].items()}

    def find_field_keys(self, node, index: str, field: str,
                        keys: List[str]) -> Dict[str, int]:
        out = self._post(
            node, f"/internal/translate/field/{index}/{field}/keys/find",
            {"keys": keys}, op="translate")
        return {k: int(v) for k, v in out["ids"].items()}

    def translate_field_ids(self, node, index: str, field: str,
                            ids: List[int]) -> Dict[int, str]:
        out = self._post(node, f"/internal/translate/field/{index}/{field}/ids",
                         {"ids": list(ids)}, op="translate")
        return {int(k): v for k, v in out["keys"].items()}

    def replicate_translate(self, node, index: str, field: Optional[str],
                            entries: List) -> None:
        """Push newly created (key, id) entries to a replica (reference:
        translate.go EntryReader / http_translator.go sync stream)."""
        self._post(node, "/internal/translate/replicate",
                   {"index": index, "field": field,
                    "entries": [[k, int(i)] for k, i in entries]},
                   op="translate")

    # -- control plane -----------------------------------------------------

    def send_message(self, node, msg: dict) -> None:
        out = self._post(node, "/internal/cluster/message",
                         self._piggyback(node, msg), op="broadcast")
        self._apply_gossip(out)

    def membership_ping(self, node, payload: dict, token=None) -> dict:
        """SWIM probe / ping-req relay (gossip/membership.py). Tagged
        op="ping" so FaultPlan partition rules can sever only the probe
        path; it carries a piggybacked gossip envelope, so the ping that
        discovers a suspicion also delivers the refutation."""
        out = self._post(node, "/internal/membership/ping",
                         self._piggyback(node, payload),
                         token=token, op="ping")
        self._apply_gossip(out)
        return out

    def gossip_exchange(self, node, payload: dict) -> dict:
        """Anti-entropy push/pull: POST our envelope; the peer replies
        with one of its own, which GossipAgent.run_round applies (the
        agent keeps its own digest books)."""
        return self._post(node, "/internal/gossip/exchange", payload,
                          op="gossip")

    # -- recovery log shipping (storage/recovery.py catch-up) --------------

    def recovery_snapshot(self, node, index: str, shard: int,
                          token=None) -> dict:
        """One shard's snapshot from a peer: {"npz": base64 savez of
        export_shard_arrays, "lsn": the peer's WAL position it covers}.
        JSON and base64 (not raw octets), so retries, backoff and fault
        injection apply unchanged."""
        return self._get(
            node, f"/internal/recovery/snapshot?index={quote(index)}"
                  f"&shard={int(shard)}", token=token, op="recovery")

    def recovery_wal(self, node, index: str, since_lsn: int,
                     max_bytes: int, token=None) -> dict:
        """A batch of the peer's WAL tail above ``since_lsn``:
        {"frames": base64 CRC-framed records, "last_lsn", "more",
        "floor_lsn": the peer's checkpoint LSN; a fetch below it means
        the peer pruned, and the caller must snapshot again}."""
        return self._get(
            node, f"/internal/recovery/wal?index={quote(index)}"
                  f"&since={int(since_lsn)}&max_bytes={int(max_bytes)}",
            token=token, op="recovery")

    def status(self, node) -> Optional[dict]:
        """None when the node is unreachable (used as the liveness probe)."""
        try:
            return self._get(node, "/status")
        except (NodeDownError, RemoteError):
            return None

    def stats_timeline(self, node, window_s: float = 60.0,
                       token=None) -> dict:
        """One peer's health-plane timeline window (obs/health.py), the
        leg that GET /internal/stats/cluster's fan-out merges. It takes
        the usual retries and fault plan under ``op="stats"``."""
        return self._get(
            node, f"/internal/stats/timeline?window={float(window_s):g}",
            token=token, op="stats")
