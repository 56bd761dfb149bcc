"""Authentication + authorization for the HTTP surface.

Port of ``pilosa_tpu/server/auth.py`` (stdlib only): the same tokens,
permission levels and route table, byte for byte.

Reference: authn/authenticate.go:77 (Auth: JWT validation with cached
group claims), authz/authorization.go:15 (YAML group -> index ->
permission map, levels read < write < admin), http_handler.go:497+
(chkAuthZ per route), authn/authenticate.go:426 (allowed-networks
bypass granting admin to trusted CIDRs).

The reference's interactive OIDC/OAuth2 login flow needs an external
identity provider; in this build tokens are issued offline (keygen +
:func:`issue_token`) and validated the same way the reference validates
IdP-issued JWTs: HS256 signature + expiry + group claims. Everything is
stdlib (hmac/hashlib/base64) — no external crypto dependency.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import ipaddress
import json
import time
from typing import Dict, List, Optional

LEVEL_NONE = 0
LEVEL_READ = 1
LEVEL_WRITE = 2
LEVEL_ADMIN = 3

_LEVELS = {"read": LEVEL_READ, "write": LEVEL_WRITE, "admin": LEVEL_ADMIN}


class AuthError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code  # 401 unauthenticated / 403 forbidden


# -- JWT (HS256, stdlib) ------------------------------------------------------

def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _unb64url(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


def issue_token(secret: str, groups: List[str], subject: str = "",
                ttl_s: int = 3600) -> str:
    """Mint an HS256 JWT with the reference's group claim shape
    (authn reads group ids from the token to drive authz)."""
    header = {"alg": "HS256", "typ": "JWT"}
    payload = {"sub": subject, "groups": groups,
               "exp": int(time.time()) + ttl_s}
    signing = (_b64url(json.dumps(header).encode()) + "." +
               _b64url(json.dumps(payload).encode()))
    sig = hmac.new(secret.encode(), signing.encode(), hashlib.sha256).digest()
    return signing + "." + _b64url(sig)


def validate_token(secret: str, token: str) -> dict:
    """Signature + expiry check; returns the claims. Raises AuthError
    401 on anything wrong (reference: authenticate.go Authenticate)."""
    parts = token.split(".")
    if len(parts) != 3:
        raise AuthError(401, "malformed token")
    signing = parts[0] + "." + parts[1]
    want = hmac.new(secret.encode(), signing.encode(),
                    hashlib.sha256).digest()
    try:
        got = _unb64url(parts[2])
        header = json.loads(_unb64url(parts[0]))
        claims = json.loads(_unb64url(parts[1]))
    except (ValueError, json.JSONDecodeError):
        raise AuthError(401, "malformed token")
    if header.get("alg") != "HS256":
        raise AuthError(401, "unsupported token algorithm")
    if not hmac.compare_digest(want, got):
        raise AuthError(401, "bad token signature")
    if int(claims.get("exp", 0)) < time.time():
        raise AuthError(401, "token expired")
    return claims


# -- permissions file ---------------------------------------------------------

class Permissions:
    """group -> index -> level, plus the admin group (reference:
    authz/authorization.go GroupPermissions)."""

    def __init__(self, user_groups: Optional[Dict[str, Dict[str, str]]] = None,
                 admin: str = ""):
        self.user_groups = user_groups or {}
        self.admin = admin

    def level(self, groups: List[str], index: Optional[str]) -> int:
        if self.admin and self.admin in groups:
            return LEVEL_ADMIN
        best = LEVEL_NONE
        for g in groups:
            perms = self.user_groups.get(g)
            if not perms:
                continue
            if index is not None and index in perms:
                best = max(best, _LEVELS.get(perms[index], LEVEL_NONE))
            elif index is None:
                # No specific index (schema-wide reads / transactions):
                # any grant counts, but capped below admin — per-index
                # grants must never confer GLOBAL admin (only the admin
                # group does; reference: authz IsAdmin is group-based).
                for lvl in perms.values():
                    best = max(best, min(_LEVELS.get(lvl, LEVEL_NONE),
                                         LEVEL_WRITE))
        return best


def parse_permissions(text: str) -> Permissions:
    """Parse the permissions file. Accepts JSON or the reference's
    two-level YAML shape:

        user-groups:
          "group-id":
            "index": "read"
        admin: "admin-group-id"
    """
    text = text.strip()
    if text.startswith("{"):
        d = json.loads(text)
        return Permissions(d.get("user-groups", {}), d.get("admin", ""))
    user_groups: Dict[str, Dict[str, str]] = {}
    admin = ""
    group: Optional[str] = None
    in_groups = False
    for raw in text.splitlines():
        if not raw.strip() or raw.strip().startswith("#"):
            continue
        indent = len(raw) - len(raw.lstrip())
        key, _, val = raw.strip().partition(":")
        key = key.strip().strip('"').strip("'")
        val = val.strip().strip('"').strip("'")
        if indent == 0:
            in_groups = key == "user-groups"
            if key == "admin":
                admin = val
            group = None
        elif in_groups and not val:
            group = key
            user_groups[group] = {}
        elif in_groups and group is not None:
            user_groups[group][key] = val
    return Permissions(user_groups, admin)


# -- route gating -------------------------------------------------------------

# handler-method name -> (required level, takes index from the first
# path capture). Unlisted routes default to admin (deny-safe).
ROUTE_LEVELS: Dict[str, tuple] = {
    # reads
    "post_query": ("read", True),   # write PQL re-checked post-parse
    "post_sql": ("read", False),    # write SQL re-checked post-parse
    "get_schema": ("read", False),
    "get_status": ("read", False),
    "get_info": ("read", False),
    "get_metrics": ("read", False),
    "get_metrics_json": ("read", False),
    "get_query_history": ("read", False),
    "get_mutex_check": ("read", True),
    "get_dataframe_shard": ("read", True),
    "get_dataframe_schema": ("read", True),
    "get_transaction": ("read", False),
    "get_transactions": ("read", False),
    # round-5 read surface (siblings of /schema and /query-history)
    "get_schema_details": ("read", False),
    "get_queries": ("read", False),
    "get_shard_distribution": ("read", False),
    "get_internal_nodes": ("read", False),
    "get_shards_max": ("read", False),
    "get_index_shards": ("read", True),
    # writes
    "post_index": ("admin", True),
    "delete_index": ("admin", True),
    "post_field": ("admin", True),
    "delete_field": ("admin", True),
    "post_import": ("write", True),
    "post_import_values": ("write", True),
    "post_import_roaring": ("write", True),
    "post_import_dataframe": ("write", True),
    "delete_dataframe": ("write", True),
    "post_transaction": ("write", False),
    "post_transaction_finish": ("write", False),
    # gRPC authorizes per METHOD inside post_grpc (queries escalate on
    # write-ness, index CRUD needs admin — same as the HTTP routes)
    "post_grpc": ("read", False),
}


def _auth_cookies(headers) -> "tuple":
    """(access, refresh) from the request's cookies (reference cookie
    names authenticate.go:33-36)."""
    from http.cookies import SimpleCookie

    jar = SimpleCookie()
    try:
        jar.load(headers.get("Cookie") or "")
    except Exception:
        return "", ""
    get = lambda k: jar[k].value if k in jar else ""  # noqa: E731
    return get("molecula-chip"), get("refresh-molecula-chip")


class Auth:
    """Bound to the HTTP handler; authenticates a request and authorizes
    it against the route's level (reference: http_handler.go chkAuthZ)."""

    def __init__(self, secret: str, permissions: Permissions,
                 allowed_networks: Optional[List[str]] = None,
                 oidc=None, secure_cookies: bool = False):
        self.secret = secret
        self.permissions = permissions
        self.networks = [ipaddress.ip_network(n)
                         for n in (allowed_networks or [])]
        #: optional server.oidc.OIDCAuth — enables the IdP cookie flow
        self.oidc = oidc
        #: add `Secure` to every session cookie (config
        #: auth.secure_cookies; off by default so plain-HTTP dev
        #: deployments keep a working login flow)
        self.secure_cookies = secure_cookies

    def authenticate(self, headers, client_ip: str) -> dict:
        """Returns {"groups": [...], "admin_net": bool}; with OIDC
        configured, cookie-bearing requests resolve groups through the
        IdP (reference: authenticate.go:174 + getGroups cache) and may
        carry rotated tokens in ``oidc`` for the handler to re-set."""
        try:
            ip = ipaddress.ip_address(client_ip)
            for net in self.networks:
                if ip in net:
                    # trusted network: full access, no token needed
                    # (reference: authenticate.go:426)
                    return {"groups": [], "admin_net": True}
        except ValueError:
            pass
        authz = headers.get("Authorization") or ""
        if authz.startswith("Bearer "):
            claims = validate_token(self.secret, authz[len("Bearer "):])
            return {"groups": list(claims.get("groups", [])),
                    "admin_net": False}
        if self.oidc is not None:
            access, refresh = _auth_cookies(headers)
            if access:
                info = self.oidc.authenticate(access, refresh)
                return {"groups": info["groups"], "admin_net": False,
                        "oidc": info}
        raise AuthError(401, "missing Bearer token")

    def authorize(self, ctx: dict, level_name: str,
                  index: Optional[str]) -> None:
        if ctx.get("admin_net"):
            return
        need = _LEVELS.get(level_name, LEVEL_ADMIN)
        have = self.permissions.level(ctx.get("groups", []), index)
        if have < need:
            raise AuthError(
                403, f"requires {level_name} permission"
                     + (f" on {index!r}" if index else ""))
