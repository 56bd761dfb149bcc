"""OIDC / OAuth2 login flow on top of the JWT enforcement layer.

Port of ``pilosa_tpu/server/oidc.py`` (stdlib only).

Reference: authn/authenticate.go:77-426 — interactive IdP login
(auth-code redirect), token exchange and refresh, a TTL'd cache of the
IdP's group claims, cookie round-tripping, and allowed-network bypass
(the bypass + per-route enforcement live in server/auth.py; this module
adds the IdP integration the VERDICT r4 missing #4 called out).

Flow (mirrors the reference's handler trio):
- GET /login          -> 302 to <auth_url>?response_type=code&...
- GET /redirect?code= -> POST <token_url> (grant_type=authorization_code)
                         -> access+refresh cookies ("molecula-chip" /
                         "refresh-molecula-chip", authenticate.go:33-36)
- GET /logout         -> clear cookies, 302 to <logout_endpoint>

Authentication of a cookie-bearing request (authenticate.go:174):
parse the access JWT UNVERIFIED (the IdP is the signature authority —
the groups call validates the token server-side), check expiry, refresh
through the token endpoint when expired, then resolve group memberships
from <group_endpoint> (MS-Graph shape {"value": [{"id","displayName"}],
"@odata.nextLink": ...}) with a cacheTTL'd cache keyed by access token.

``FakeIdP`` is the in-process test IdP (reference: idk/fakeidp — /token
and /groups on a loopback server).
"""

from __future__ import annotations

import base64
import json
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from pilosa_tpu_torch.server.auth import AuthError, _b64url, _unb64url

ACCESS_COOKIE = "molecula-chip"
REFRESH_COOKIE = "refresh-molecula-chip"


@dataclass
class OAuthConfig:
    auth_url: str
    token_url: str
    group_endpoint: str
    logout_endpoint: str = ""
    client_id: str = ""
    client_secret: str = ""
    redirect_url: str = ""
    scopes: List[str] = field(default_factory=lambda: ["openid"])


def _decode_claims_unverified(token: str) -> dict:
    """Parse a JWT's claims without verifying the signature (reference:
    jwt.Parser.ParseUnverified, authenticate.go:192 — the IdP validates
    the signature when the groups endpoint is called)."""
    parts = token.split(".")
    if len(parts) != 3:
        raise AuthError(401, "malformed access token")
    try:
        return json.loads(_unb64url(parts[1]))
    except (ValueError, UnicodeDecodeError):
        raise AuthError(401, "malformed access token claims")


class OIDCAuth:
    """IdP-backed authenticator: exchanges auth codes, refreshes expired
    tokens, and resolves groups through the IdP with a TTL cache."""

    def __init__(self, config: OAuthConfig, cache_ttl: float = 600.0,
                 clock=time.time):
        self.config = config
        self.cache_ttl = cache_ttl
        self._clock = clock
        self._lock = threading.Lock()
        # access token -> (groups, cached_at); authenticate.go groupsCache
        self._groups_cache: Dict[str, Tuple[List[str], float]] = {}
        self._last_clean = clock()
        # pending anti-CSRF states for the auth-code flow
        self._states: Dict[str, float] = {}
        self._state_ttl = 600.0

    # -- endpoints ---------------------------------------------------------

    def login_url(self, state: str = "") -> str:
        q = urllib.parse.urlencode({
            "response_type": "code",
            "client_id": self.config.client_id,
            "redirect_uri": self.config.redirect_url,
            "scope": " ".join(self.config.scopes),
            "state": state or self.new_state(),
        })
        return f"{self.config.auth_url}?{q}"

    def new_state(self) -> str:
        """One-time anti-CSRF state for the auth-code round trip."""
        import secrets

        s = secrets.token_urlsafe(24)
        with self._lock:
            self._states[s] = self._clock()
        return s

    def check_state(self, state: str) -> bool:
        """Consume a state issued by new_state(); False = unknown/expired
        (login CSRF: an attacker-initiated code must not set cookies)."""
        with self._lock:
            issued = self._states.pop(state, None)
        return issued is not None and \
            self._clock() - issued < self._state_ttl

    def evict(self, access: str) -> None:
        """Drop a session's cached groups (logout)."""
        with self._lock:
            self._groups_cache.pop(access, None)

    def logout_url(self, post_logout: str = "/") -> str:
        if not self.config.logout_endpoint:
            return post_logout
        return (f"{self.config.logout_endpoint}"
                f"?post_logout_redirect_uri={post_logout}")

    def exchange_code(self, code: str) -> Tuple[str, str]:
        """Auth-code -> (access, refresh) via the token endpoint
        (reference: oAuthConfig.Exchange, authenticate.go:288)."""
        tok = self._token_request({
            "grant_type": "authorization_code",
            "code": code,
            "redirect_uri": self.config.redirect_url,
            "client_id": self.config.client_id,
            "client_secret": self.config.client_secret,
        })
        return tok.get("access_token", ""), tok.get("refresh_token", "")

    def refresh(self, access: str, refresh: str) -> Tuple[str, str]:
        """(reference: authenticate.go:142 refreshToken — also evicts
        the stale access token's cached groups)."""
        tok = self._token_request({
            "grant_type": "refresh_token",
            "refresh_token": refresh,
            "client_id": self.config.client_id,
            "client_secret": self.config.client_secret,
        })
        with self._lock:
            self._groups_cache.pop(access, None)
        return tok.get("access_token", ""), tok.get("refresh_token", "")

    def _token_request(self, form: dict) -> dict:
        body = urllib.parse.urlencode(form).encode()
        req = urllib.request.Request(
            self.config.token_url, data=body, method="POST")
        req.add_header("Content-Type", "application/x-www-form-urlencoded")
        try:
            with urllib.request.urlopen(req, timeout=10.0) as r:
                return json.loads(r.read())
        except urllib.error.HTTPError as e:
            raise AuthError(401, f"token endpoint: HTTP {e.code}")
        except (urllib.error.URLError, OSError) as e:
            raise AuthError(401, f"token endpoint unreachable: {e}")

    # -- request authentication -------------------------------------------

    def authenticate(self, access: str, refresh: str = "") -> dict:
        """Returns {"groups", "userid", "username", "access", "refresh"};
        ``access``/``refresh`` come back rotated when a refresh happened
        (the caller re-sets cookies, authenticate.go:174 contract)."""
        now = self._clock()
        if now - self._last_clean > 1800:
            self._clean_cache(now)
        if not access:
            raise AuthError(401, "auth token is empty")
        claims = _decode_claims_unverified(access)
        exp = claims.get("exp")
        try:
            expired = exp is not None and float(exp) < now
        except (TypeError, ValueError):
            raise AuthError(401, "malformed exp claim")
        rotated = False
        if expired:
            if not refresh:
                raise AuthError(401, "access token expired")
            access, refresh = self.refresh(access, refresh)
            if not access:
                raise AuthError(401, "token refresh failed")
            claims = _decode_claims_unverified(access)
            rotated = True
        groups = self._get_groups(access)
        return {
            "groups": groups,
            "userid": claims.get("sub", ""),
            "username": claims.get("name", ""),
            "access": access,
            "refresh": refresh,
            "rotated": rotated,
        }

    def _get_groups(self, access: str) -> List[str]:
        now = self._clock()
        with self._lock:
            hit = self._groups_cache.get(access)
            if hit is not None and now - hit[1] < self.cache_ttl and hit[0]:
                return list(hit[0])
        groups: List[str] = []
        next_link = self.config.group_endpoint
        while next_link:
            req = urllib.request.Request(next_link)
            req.add_header("Authorization", f"Bearer {access}")
            try:
                with urllib.request.urlopen(req, timeout=10.0) as r:
                    page = json.loads(r.read())
            except urllib.error.HTTPError as e:
                raise AuthError(401, f"group endpoint: HTTP {e.code}")
            except (urllib.error.URLError, OSError) as e:
                raise AuthError(401, f"group endpoint unreachable: {e}")
            groups += [g.get("id", "") for g in page.get("value", [])]
            next_link = page.get("@odata.nextLink", "")
        if not groups:
            raise AuthError(403, "no groups found")
        with self._lock:
            self._groups_cache[access] = (groups, now)
        return groups

    def _clean_cache(self, now: float) -> None:
        with self._lock:
            self._groups_cache = {
                k: v for k, v in self._groups_cache.items()
                if now - v[1] < self.cache_ttl}
            # abandoned logins (states never consumed by /redirect) must
            # not accumulate forever
            self._states = {
                k: v for k, v in self._states.items()
                if now - v < self._state_ttl}
            self._last_clean = now


# ---------------------------------------------------------------------------
# In-process fake IdP for tests (reference: idk/fakeidp/server.go)
# ---------------------------------------------------------------------------

class FakeIdP:
    """Loopback IdP: /authorize 302s back with a code, /token exchanges
    codes and refresh tokens for HS256-ish JWTs, /groups serves the
    MS-Graph-shaped membership document."""

    def __init__(self, groups: Optional[List[dict]] = None,
                 token_ttl: float = 3600.0):
        self.groups = groups or [{"id": "g1", "displayName": "group-one"}]
        self.token_ttl = token_ttl
        self.codes: Dict[str, str] = {}       # auth code -> subject
        self.refreshes: Dict[str, str] = {}   # refresh token -> subject
        self.valid_tokens: set = set()
        self.token_calls = 0
        self.group_calls = 0
        self._n = 0
        self._httpd = None

    # -- token minting -----------------------------------------------------

    def mint(self, sub: str = "user", ttl: Optional[float] = None) -> str:
        header = _b64url(json.dumps({"alg": "none", "typ": "JWT"}).encode())
        claims = _b64url(json.dumps({
            "sub": sub, "name": sub,
            "exp": time.time() + (self.token_ttl if ttl is None else ttl),
        }).encode())
        tok = f"{header}.{claims}.fakesig{self._n}"
        self._n += 1
        self.valid_tokens.add(tok)
        return tok

    def issue_code(self, sub: str = "user") -> str:
        code = f"code{self._n}"
        self._n += 1
        self.codes[code] = sub
        return code

    # -- HTTP server -------------------------------------------------------

    def serve(self) -> str:
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        idp = self

        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _json(self, code: int, obj: dict):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                u = urllib.parse.urlparse(self.path)
                if u.path == "/authorize":
                    q = urllib.parse.parse_qs(u.query)
                    redirect = q.get("redirect_uri", [""])[0]
                    code = idp.issue_code()
                    state = q.get("state", [""])[0]
                    loc = f"{redirect}?code={code}&state={state}"
                    self.send_response(302)
                    self.send_header("Location", loc)
                    self.end_headers()
                    return
                if u.path == "/groups":
                    idp.group_calls += 1
                    authz = self.headers.get("Authorization") or ""
                    tok = authz[len("Bearer "):]
                    if tok not in idp.valid_tokens:
                        self._json(401, {"error": "bad token"})
                        return
                    self._json(200, {"value": idp.groups})
                    return
                self._json(404, {"error": "not found"})

            def do_POST(self):
                if urllib.parse.urlparse(self.path).path != "/token":
                    self._json(404, {"error": "not found"})
                    return
                idp.token_calls += 1
                n = int(self.headers.get("Content-Length") or 0)
                form = urllib.parse.parse_qs(self.rfile.read(n).decode())
                grant = form.get("grant_type", [""])[0]
                if grant == "authorization_code":
                    sub = idp.codes.pop(form.get("code", [""])[0], None)
                    if sub is None:
                        self._json(400, {"error": "invalid_grant"})
                        return
                elif grant == "refresh_token":
                    sub = idp.refreshes.pop(
                        form.get("refresh_token", [""])[0], None)
                    if sub is None:
                        self._json(400, {"error": "invalid_grant"})
                        return
                else:
                    self._json(400, {"error": "unsupported_grant_type"})
                    return
                access = idp.mint(sub)
                refresh = f"refresh{idp._n}"
                idp._n += 1
                idp.refreshes[refresh] = sub
                self._json(200, {"access_token": access,
                                 "refresh_token": refresh,
                                 "token_type": "Bearer",
                                 "expires_in": int(idp.token_ttl)})

        self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
        threading.Thread(target=self._httpd.serve_forever,
                         daemon=True).start()
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def close(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
