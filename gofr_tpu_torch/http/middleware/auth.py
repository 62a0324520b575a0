"""Auth middleware: Basic, API-key, OAuth/JWT (a copy of
``gofr_tpu/http/middleware/auth.py``).

Reference parity: pkg/gofr/http/middleware/{auth,basic_auth,apikey_auth,
oauth}.go — pluggable AuthProvider (auth.go:32-35), the generic middleware
that skips the ``/.well-known/*`` probes (auth.go:38-57), Basic auth with
plain-map / validate-func / validate-with-container variants
(basic_auth.go:13-68), API-key auth with the same variants (apikey_auth.go),
and OAuth with JWKS refresh + claims into the context (oauth.go:33-148).

One deliberate difference: the reference skips every method on
``/.well-known/*``, so with auth enabled an unauthenticated
``POST /.well-known/drain`` (``serving/handlers.py``
``register_admin_drain``) still drains the replica. Here the skip covers
only the read methods (``GET``, ``HEAD``, ``OPTIONS``): the health and
alive probes, swagger and the OpenAPI spec stay open, and a state-changing
request under ``/.well-known/`` must authenticate.
"""

from __future__ import annotations

import base64
import binascii
import hmac
import json
from typing import Any, Callable, Protocol

from gofr_tpu_torch.context import AuthInfo
from gofr_tpu_torch.http.middleware.core import Middleware, WireHandler
from gofr_tpu_torch.http.middleware import jwt as jwtlib
from gofr_tpu_torch.http.responder import WireResponse

WELL_KNOWN = "/.well-known/"
# methods that pass ``/.well-known/*`` unauthenticated: the probes and docs
# are read-only, and the admin drain (a POST) must not be one of them
OPEN_WELL_KNOWN_METHODS = ("GET", "HEAD", "OPTIONS")


class AuthProvider(Protocol):
    """auth.go:32-35."""

    def get_auth_method(self) -> str: ...

    def authenticate(self, req: Any) -> AuthInfo | None: ...


def _unauthorized(message: str = "Unauthorized") -> WireResponse:
    return WireResponse(
        status=401,
        headers={"Content-Type": "application/json", "WWW-Authenticate": "Basic"},
        body=json.dumps({"error": {"message": message}}).encode(),
    )


def _auth_middleware(provider: AuthProvider) -> Middleware:
    """Generic auth wrapper (auth.go:38-57): probe routes stay open to the
    read methods."""

    def mw(inner: WireHandler) -> WireHandler:
        async def handle(req: Any) -> WireResponse:
            if req.method == "OPTIONS" or (
                req.path.startswith(WELL_KNOWN) and req.method in OPEN_WELL_KNOWN_METHODS
            ):
                return await inner(req)
            info = provider.authenticate(req)
            if info is None:
                return _unauthorized()
            req.auth = info
            return await inner(req)

        return handle

    return mw


class BasicAuthProvider:
    """basic_auth.go:13-68. Exactly one of ``users`` (user->password map),
    ``validate_func`` (user, pass) -> bool, or ``validate_with_container``
    (container, user, pass) -> bool."""

    def __init__(
        self,
        users: dict[str, str] | None = None,
        validate_func: Callable[[str, str], bool] | None = None,
        validate_with_container: Callable[[Any, str, str], bool] | None = None,
        container: Any = None,
    ) -> None:
        self.users = users or {}
        self.validate_func = validate_func
        self.validate_with_container = validate_with_container
        self.container = container

    def get_auth_method(self) -> str:
        return "basic"

    def authenticate(self, req: Any) -> AuthInfo | None:
        header = req.header("authorization")
        if not header.lower().startswith("basic "):
            return None
        try:
            decoded = base64.b64decode(header[6:].strip()).decode("utf-8")
        except (binascii.Error, UnicodeDecodeError):
            return None
        if ":" not in decoded:
            return None
        username, _, password = decoded.partition(":")
        if self.validate_with_container is not None:
            ok = self.validate_with_container(self.container, username, password)
        elif self.validate_func is not None:
            ok = self.validate_func(username, password)
        else:
            expected = self.users.get(username)
            ok = expected is not None and hmac.compare_digest(expected, password)
        return AuthInfo(method="basic", username=username) if ok else None


class APIKeyAuthProvider:
    """apikey_auth.go: keys from a static list or a validator."""

    def __init__(
        self,
        keys: list[str] | None = None,
        validate_func: Callable[[str], bool] | None = None,
        validate_with_container: Callable[[Any, str], bool] | None = None,
        container: Any = None,
    ) -> None:
        self.keys = set(keys or [])
        self.validate_func = validate_func
        self.validate_with_container = validate_with_container
        self.container = container

    def get_auth_method(self) -> str:
        return "apikey"

    def authenticate(self, req: Any) -> AuthInfo | None:
        key = req.header("x-api-key")
        if not key:
            return None
        if self.validate_with_container is not None:
            ok = self.validate_with_container(self.container, key)
        elif self.validate_func is not None:
            ok = self.validate_func(key)
        else:
            ok = key in self.keys
        return AuthInfo(method="apikey", api_key=key) if ok else None


class OAuthProvider:
    """oauth.go:33-148: Bearer JWT validated against a JWKS endpoint (RS256)
    or a shared secret (HS256); claims exposed via ctx.get_auth_info()."""

    def __init__(
        self,
        jwks_url: str | None = None,
        jwks_provider: Any = None,
        hs_secret: str | None = None,
        issuer: str | None = None,
        audience: str | None = None,
        refresh_interval: float = 3600.0,
    ) -> None:
        self.jwks = jwks_provider
        if self.jwks is None and jwks_url:
            self.jwks = jwtlib.JWKSProvider(jwks_url, refresh_interval)
        self.hs_secret = hs_secret
        self.issuer = issuer
        self.audience = audience

    def get_auth_method(self) -> str:
        return "oauth"

    def authenticate(self, req: Any) -> AuthInfo | None:
        header = req.header("authorization")
        if not header.lower().startswith("bearer "):
            return None
        token = header[7:].strip()
        try:
            claims = jwtlib.decode(
                token,
                hs_secret=self.hs_secret,
                rsa_keys=self.jwks.keys() if self.jwks else None,
                issuer=self.issuer,
                audience=self.audience,
            )
        except jwtlib.JWTError:
            return None
        return AuthInfo(method="oauth", username=str(claims.get("sub", "")), claims=claims)


def basic_auth_middleware(**kw: Any) -> Middleware:
    return _auth_middleware(BasicAuthProvider(**kw))


def api_key_auth_middleware(**kw: Any) -> Middleware:
    return _auth_middleware(APIKeyAuthProvider(**kw))


def oauth_middleware(**kw: Any) -> Middleware:
    return _auth_middleware(OAuthProvider(**kw))


def auth_middleware(provider: AuthProvider) -> Middleware:
    return _auth_middleware(provider)
