"""Minimal JWT + JWKS verification (no external jwt dependency; a copy of
``gofr_tpu/http/middleware/jwt.py``).

Reference parity: the reference uses golang-jwt/jwt/v5 + a background JWKS
refresher (middleware/oauth.go:33-101 refresh loop, :138-148 parse+claims).
Supported algs: HS256 (shared secret) and RS256 (JWKS / PEM public key via
``cryptography``). Validates ``exp``/``nbf`` and optional issuer/audience.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import threading
import time
import urllib.request
from typing import Any

try:
    from cryptography.exceptions import InvalidSignature
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import padding, rsa

    _HAS_CRYPTO = True
except ImportError:  # image without cryptography: HS256 (pure stdlib)
    InvalidSignature = hashes = padding = rsa = None  # type: ignore[assignment]
    _HAS_CRYPTO = False


class JWTError(Exception):
    pass


def _b64url_decode(data: str) -> bytes:
    padded = data + "=" * (-len(data) % 4)
    return base64.urlsafe_b64decode(padded.encode("ascii"))


def _b64url_encode(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode("ascii")


def encode_hs256(claims: dict, secret: str | bytes, headers: dict | None = None) -> str:
    """Issue an HS256 token (used by tests and the oauth client-credentials
    test fixture)."""
    if isinstance(secret, str):
        secret = secret.encode()
    header = {"alg": "HS256", "typ": "JWT", **(headers or {})}
    h = _b64url_encode(json.dumps(header, separators=(",", ":")).encode())
    p = _b64url_encode(json.dumps(claims, separators=(",", ":")).encode())
    sig = hmac.new(secret, f"{h}.{p}".encode(), hashlib.sha256).digest()
    return f"{h}.{p}.{_b64url_encode(sig)}"


def decode(
    token: str,
    *,
    hs_secret: str | bytes | None = None,
    rsa_keys: dict[str, rsa.RSAPublicKey] | None = None,
    issuer: str | None = None,
    audience: str | None = None,
    leeway: float = 30.0,
) -> dict[str, Any]:
    """Verify and decode a JWT, returning its claims."""
    parts = token.split(".")
    if len(parts) != 3:
        raise JWTError("malformed token")
    try:
        header = json.loads(_b64url_decode(parts[0]))
        claims = json.loads(_b64url_decode(parts[1]))
        signature = _b64url_decode(parts[2])
    except (ValueError, json.JSONDecodeError) as exc:
        raise JWTError(f"malformed token: {exc}") from exc

    signing_input = f"{parts[0]}.{parts[1]}".encode()
    alg = header.get("alg")
    if alg == "HS256":
        if hs_secret is None:
            raise JWTError("HS256 token but no shared secret configured")
        secret = hs_secret.encode() if isinstance(hs_secret, str) else hs_secret
        expected = hmac.new(secret, signing_input, hashlib.sha256).digest()
        if not hmac.compare_digest(expected, signature):
            raise JWTError("signature verification failed")
    elif alg == "RS256":
        if not _HAS_CRYPTO:
            raise JWTError("RS256 token but the cryptography package is unavailable")
        if not rsa_keys:
            raise JWTError("RS256 token but no JWKS configured")
        kid = header.get("kid")
        candidates = [rsa_keys[kid]] if kid and kid in rsa_keys else list(rsa_keys.values())
        if not candidates:
            raise JWTError(f"no key for kid {kid}")
        for key in candidates:
            try:
                key.verify(signature, signing_input, padding.PKCS1v15(), hashes.SHA256())
                break
            except InvalidSignature:
                continue
        else:
            raise JWTError("signature verification failed")
    else:
        raise JWTError(f"unsupported alg {alg}")

    now = time.time()
    if "exp" in claims and now > float(claims["exp"]) + leeway:
        raise JWTError("token expired")
    if "nbf" in claims and now < float(claims["nbf"]) - leeway:
        raise JWTError("token not yet valid")
    if issuer is not None and claims.get("iss") != issuer:
        raise JWTError("issuer mismatch")
    if audience is not None:
        aud = claims.get("aud")
        auds = aud if isinstance(aud, list) else [aud]
        if audience not in auds:
            raise JWTError("audience mismatch")
    return claims


def jwk_to_rsa_key(jwk: dict) -> rsa.RSAPublicKey:
    if not _HAS_CRYPTO:
        raise JWTError("JWKS keys need the cryptography package")
    n = int.from_bytes(_b64url_decode(jwk["n"]), "big")
    e = int.from_bytes(_b64url_decode(jwk["e"]), "big")
    return rsa.RSAPublicNumbers(e, n).public_key()


class JWKSProvider:
    """Fetches a JWKS endpoint and refreshes on an interval in a daemon
    thread (oauth.go:33-101)."""

    def __init__(self, url: str, refresh_interval: float = 3600.0, timeout: float = 5.0) -> None:
        self.url = url
        self.timeout = timeout
        self._keys: dict[str, rsa.RSAPublicKey] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self.refresh()
        self._thread = threading.Thread(target=self._loop, args=(refresh_interval,), daemon=True, name="jwks-refresh")
        self._thread.start()

    def refresh(self) -> None:
        try:
            with urllib.request.urlopen(self.url, timeout=self.timeout) as resp:
                data = json.loads(resp.read().decode())
        except Exception:
            return
        keys: dict[str, rsa.RSAPublicKey] = {}
        for jwk in data.get("keys", []):
            if jwk.get("kty") != "RSA":
                continue
            try:
                keys[jwk.get("kid", str(len(keys)))] = jwk_to_rsa_key(jwk)
            except (KeyError, ValueError):
                continue
        if keys:
            with self._lock:
                self._keys = keys

    def keys(self) -> dict[str, rsa.RSAPublicKey]:
        with self._lock:
            return dict(self._keys)

    def _loop(self, interval: float) -> None:
        while not self._stop.wait(interval):
            self.refresh()

    def close(self) -> None:
        self._stop.set()
