"""Option decorators for the HTTP service client (a copy of
``gofr_tpu/service/options.py``; ``gofr_tpu_torch.errors`` re-exports its
``CircuitBreakerError``, which the router's failover counts retriable).

Reference parity: service/options.go:3-5 — each option wraps the client and
returns a client with the same surface. Implemented: circuit breaker
(service/circuit_breaker.go:24-157: failure counting, Open state, async
health-probe recovery loop), retry (service/retry.go:96-109: retry on error
or 5xx), Basic/API-key/OAuth client-credentials auth (service/{basic_auth,
apikey_auth,oauth}.go, token cache), default headers (custom_header.go),
custom health endpoint/timeout (health_config.go:5-31).
"""

from __future__ import annotations

import base64
import collections
import dataclasses
import threading
import time
from typing import Any

from gofr_tpu_torch.service.client import ServiceResponse


class _Wrapper:
    """Forwards the client surface; subclasses override ``request``."""

    def __init__(self, inner: Any) -> None:
        self._inner = inner

    def __getattr__(self, name: str) -> Any:
        return getattr(self._inner, name)

    def request(self, method: str, path: str, **kw: Any) -> ServiceResponse:
        return self._inner.request(method, path, **kw)

    def get(self, path: str, params: dict | None = None, **kw: Any) -> ServiceResponse:
        return self.request("GET", path, params=params, **kw)

    def post(self, path: str, params: dict | None = None, body: bytes | None = None, **kw: Any) -> ServiceResponse:
        return self.request("POST", path, params=params, body=body, **kw)

    def put(self, path: str, params: dict | None = None, body: bytes | None = None, **kw: Any) -> ServiceResponse:
        return self.request("PUT", path, params=params, body=body, **kw)

    def patch(self, path: str, params: dict | None = None, body: bytes | None = None, **kw: Any) -> ServiceResponse:
        return self.request("PATCH", path, params=params, body=body, **kw)

    def delete(self, path: str, body: bytes | None = None, **kw: Any) -> ServiceResponse:
        return self.request("DELETE", path, body=body, **kw)

    def health_check(self) -> dict[str, Any]:
        return self._inner.health_check()


class CircuitBreakerError(Exception):
    """503: an inter-replica circuit breaker is open, so the replica behind
    it is treated as gone."""

    status_code = 503

    def __init__(self, address: str) -> None:
        super().__init__(f"circuit breaker open for {address}")


@dataclasses.dataclass
class CircuitBreakerConfig:
    """service/circuit_breaker.go: Closed until ``threshold`` consecutive
    failures, then Open; a background probe hits the health endpoint every
    ``interval`` seconds and closes the breaker on success."""

    threshold: int = 5
    interval: float = 10.0

    def add_option(self, inner: Any) -> "CircuitBreaker":
        return CircuitBreaker(inner, self.threshold, self.interval)


class CircuitBreaker(_Wrapper):
    def __init__(self, inner: Any, threshold: int, interval: float) -> None:
        super().__init__(inner)
        self.threshold = threshold
        self.interval = interval
        self._failures = 0
        self._open = False
        self._lock = threading.Lock()
        self._probe_thread: threading.Thread | None = None
        self._probe_stop: threading.Event | None = None
        # transitions not yet published to the gauge and the hook, in the
        # order the state changed; one thread at a time drains them (Queue C
        # 58: a reopening racing the closing probe reordered them)
        self._pending: collections.deque[bool] = collections.deque()
        self._publishing = False
        # optional hook fired on every open/close transition (bool: open).
        # The router tier wires it into replica membership — the breaker
        # opening marks the replica DOWN ahead of the heartbeat timers
        # (serving/router.py HTTPReplica).
        self.on_state_change: Any = None
        self._set_state_gauge(False)  # the closed state is visible from t=0

    @property
    def is_open(self) -> bool:
        return self._open

    def _set_state_gauge(self, open_: bool) -> None:
        """An open breaker used to surface only through health_check()
        details; the per-address gauge makes it alertable in Prometheus
        (one series per configured downstream — bounded cardinality)."""
        metrics = getattr(self, "metrics", None)  # innermost client's
        if metrics is None:
            return
        address = getattr(self, "address", "?")
        try:
            metrics.set_gauge(
                "app_service_breaker_state", 1.0 if open_ else 0.0,
                address=address,
            )
        except Exception:
            pass  # a metrics backend hiccup must never affect the breaker

    def _notify_state(self, open_: bool) -> None:
        hook = self.__dict__.get("on_state_change")
        if hook is None:
            return
        try:
            hook(open_)
        except Exception:
            pass  # a listener failure must never affect the breaker

    def request(self, method: str, path: str, **kw: Any) -> ServiceResponse:
        with self._lock:
            if self._open:
                raise CircuitBreakerError(getattr(self._inner, "address", "?"))
        try:
            resp = self._inner.request(method, path, **kw)
        except Exception:
            self._record_failure()
            raise
        if resp.status_code >= 500:
            self._record_failure()
        else:
            with self._lock:
                self._failures = 0
        return resp

    def stream(self, method: str, path: str, **kw: Any) -> Any:
        """Breaker-aware streaming open (the remote token-stream
        transport, serving/remote.py). The breaker observes the CONNECT:
        an open breaker refuses up front, a failed open or 5xx head
        counts a failure, a streaming head that arrived resets the
        count. Mid-stream tears are the router's failover problem — by
        then tokens may have crossed, which is not an admission failure."""
        with self._lock:
            if self._open:
                raise CircuitBreakerError(getattr(self._inner, "address", "?"))
        try:
            resp = self._inner.stream(method, path, **kw)
        except Exception:
            self._record_failure()
            raise
        if resp.status_code >= 500:
            self._record_failure()
        else:
            with self._lock:
                self._failures = 0
        return resp

    def _record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            opened = self._failures >= self.threshold and not self._open
            if opened:
                self._open = True
                self._pending.append(True)
                self._start_probe()
        if opened:
            self._publish()

    def _publish(self) -> None:
        """Publish queued transitions to the gauge and the hook in the order
        they happened. A transition queued while another thread (or the hook
        itself, re-entering) publishes is left to that publisher, so the
        last value published is always the breaker's current state."""
        with self._lock:
            if self._publishing:
                return
            self._publishing = True
        while True:
            with self._lock:
                if not self._pending:
                    # cleared under the same hold as the emptiness test, so a
                    # transition queued after it finds no publisher and
                    # publishes itself
                    self._publishing = False
                    return
                open_ = self._pending.popleft()
            try:
                self._set_state_gauge(open_)
                self._notify_state(open_)
            except BaseException:  # a hook's SystemExit: hand the queue back, then re-raise
                with self._lock:
                    self._publishing = False
                raise

    def _start_probe(self) -> None:
        """Async recovery loop (circuit_breaker.go:100-119). Each probe has
        its own stop event: a closing probe can no longer end the probe
        that a reopening started behind it (Queue C 58)."""
        self._probe_stop = threading.Event()
        self._probe_thread = threading.Thread(
            target=self._probe_loop, args=(self._probe_stop,), daemon=True, name="cb-probe")
        self._probe_thread.start()

    def _probe_loop(self, stop: threading.Event) -> None:
        while not stop.wait(self.interval):
            health = self._inner.health_check()
            if health.get("status") == "UP":
                with self._lock:
                    self._open = False
                    self._failures = 0
                    self._pending.append(False)
                self._publish()
                return

    def close(self) -> None:
        """Stop a live probe, then close the inner client."""
        with self._lock:
            stop = self._probe_stop
        if stop is not None:
            stop.set()
        inner_close = getattr(self._inner, "close", None)
        if inner_close is not None:
            inner_close()

    def health_check(self) -> dict[str, Any]:
        if self._open:
            return {"status": "DOWN", "details": {"circuit_breaker": "open"}}
        return self._inner.health_check()


@dataclasses.dataclass
class RetryConfig:
    """service/retry.go:96-109: retry on transport error, 5xx, or 429.

    Backoff is exponential with FULL jitter (delay drawn uniformly from
    [0, base·multiplier^(attempt-1)], capped at ``max_backoff``): a fixed
    interval synchronizes every client's retries into coordinated waves
    against a recovering backend — the retry storm IS the second outage.
    ``max_elapsed`` caps the whole ladder (wait included): a retry that
    would start past the cap is not attempted. A ``Retry-After`` header on
    a 429/503 response (the shed estimator's hint) takes precedence over
    the jittered delay when larger."""

    max_retries: int = 3
    backoff: float = 0.0  # base delay (seconds) for the first retry
    multiplier: float = 2.0
    max_backoff: float = 30.0
    jitter: bool = True  # full jitter; False = deterministic exponential
    max_elapsed: float | None = None  # total ladder budget, seconds

    def add_option(self, inner: Any) -> "Retry":
        return Retry(self, inner)


# statuses worth retrying: transient server failure, plus explicit
# backpressure (429) which always carries a Retry-After hint here
_RETRIABLE_STATUS = {429, 500, 502, 503, 504}


def retry_after_from_headers(headers: dict[str, str]) -> float | None:
    """Seconds-form ``Retry-After``, or None. RFC 7231 also allows an
    HTTP-date form — an unparseable value must degrade to "no hint",
    never to a raise that demotes a retriable 429/503. Shared by the
    Retry option and the router tier's HTTPReplica."""
    for key, value in headers.items():
        if key.lower() == "retry-after":
            try:
                return float(value)
            except ValueError:
                return None
    return None


class Retry(_Wrapper):
    def __init__(self, cfg: RetryConfig, inner: Any) -> None:
        super().__init__(inner)
        self.cfg = cfg
        self.max_retries = cfg.max_retries
        self._stop = threading.Event()
        import random as _random

        self._rng = _random.Random()  # tests may reseed for determinism

    def close(self) -> None:
        """Interrupt any in-flight backoff wait, then close the inner
        client — shutdown must not ride out a retry ladder."""
        self._stop.set()
        inner_close = getattr(self._inner, "close", None)
        if inner_close is not None:
            inner_close()

    def _delay(self, attempt: int, retry_after: float | None) -> float:
        cfg = self.cfg
        exp = min(cfg.max_backoff, cfg.backoff * (cfg.multiplier ** (attempt - 1)))
        delay = self._rng.uniform(0.0, exp) if cfg.jitter else exp
        if retry_after is not None:
            delay = max(delay, min(retry_after, cfg.max_backoff))
        return delay

    @staticmethod
    def _retry_after_of(resp: ServiceResponse | None) -> float | None:
        if resp is None:
            return None
        return retry_after_from_headers(resp.headers)

    def request(self, method: str, path: str, **kw: Any) -> ServiceResponse:
        last_exc: Exception | None = None
        last_resp: ServiceResponse | None = None
        start = time.monotonic()
        for attempt in range(self.cfg.max_retries + 1):
            if attempt:
                # the delay gate runs even with backoff=0: a server's
                # Retry-After hint must be honored regardless of the
                # client's own base interval
                delay = self._delay(attempt, self._retry_after_of(last_resp))
                if (self.cfg.max_elapsed is not None
                        and time.monotonic() - start + delay > self.cfg.max_elapsed):
                    break  # the ladder's budget is spent; return what we have
                if delay and self._stop.wait(delay):
                    break  # closing: return what we already have
            try:
                resp = self._inner.request(method, path, **kw)
            except CircuitBreakerError:
                raise  # breaker opening mid-retry: stop hammering
            except Exception as exc:
                last_exc = exc
                last_resp = None
                continue
            if resp.status_code not in _RETRIABLE_STATUS:
                return resp
            last_resp = resp
            last_exc = None
        if last_resp is not None:
            return last_resp
        assert last_exc is not None
        raise last_exc


class _HeaderOption(_Wrapper):
    def __init__(self, inner: Any, headers: dict[str, str]) -> None:
        super().__init__(inner)
        self._headers = headers

    def request(self, method: str, path: str, **kw: Any) -> ServiceResponse:
        headers = dict(self._headers)
        headers.update(kw.pop("headers", None) or {})
        return self._inner.request(method, path, headers=headers, **kw)


@dataclasses.dataclass
class BasicAuthConfig:
    username: str = ""
    password: str = ""

    def add_option(self, inner: Any) -> Any:
        token = base64.b64encode(f"{self.username}:{self.password}".encode()).decode()
        return _HeaderOption(inner, {"Authorization": f"Basic {token}"})


@dataclasses.dataclass
class APIKeyConfig:
    api_key: str = ""

    def add_option(self, inner: Any) -> Any:
        return _HeaderOption(inner, {"X-API-Key": self.api_key})


@dataclasses.dataclass
class DefaultHeaders:
    headers: dict[str, str] = dataclasses.field(default_factory=dict)

    def add_option(self, inner: Any) -> Any:
        return _HeaderOption(inner, dict(self.headers))


@dataclasses.dataclass
class OAuthConfig:
    """Client-credentials flow with token cache (service/oauth.go)."""

    token_url: str = ""
    client_id: str = ""
    client_secret: str = ""
    scopes: tuple[str, ...] = ()
    early_refresh: float = 30.0

    def add_option(self, inner: Any) -> "OAuth":
        return OAuth(inner, self)


class OAuth(_Wrapper):
    def __init__(self, inner: Any, cfg: OAuthConfig) -> None:
        super().__init__(inner)
        self.cfg = cfg
        self._token: str | None = None
        self._expires_at = 0.0
        self._lock = threading.Lock()

    def _fetch_token(self) -> str:
        import json
        import urllib.parse
        import urllib.request

        data = urllib.parse.urlencode(
            {
                "grant_type": "client_credentials",
                "client_id": self.cfg.client_id,
                "client_secret": self.cfg.client_secret,
                **({"scope": " ".join(self.cfg.scopes)} if self.cfg.scopes else {}),
            }
        ).encode()
        req = urllib.request.Request(self.cfg.token_url, data=data, method="POST")
        with urllib.request.urlopen(req, timeout=10) as resp:
            payload = json.loads(resp.read())
        self._token = payload["access_token"]
        self._expires_at = time.time() + float(payload.get("expires_in", 3600))
        return self._token

    def _bearer(self) -> str:
        with self._lock:
            if self._token is None or time.time() > self._expires_at - self.cfg.early_refresh:
                self._fetch_token()
            return self._token  # type: ignore[return-value]

    def request(self, method: str, path: str, **kw: Any) -> ServiceResponse:
        headers = kw.pop("headers", None) or {}
        headers.setdefault("Authorization", f"Bearer {self._bearer()}")
        return self._inner.request(method, path, headers=headers, **kw)


@dataclasses.dataclass
class HealthConfig:
    """Custom health endpoint/timeout (service/health_config.go:5-31)."""

    endpoint: str = ".well-known/alive"
    timeout: float | None = None

    def add_option(self, inner: Any) -> Any:
        base = inner
        while hasattr(base, "_inner"):
            base = base._inner
        base.health_endpoint = self.endpoint.lstrip("/")
        if self.timeout is not None:
            base.health_timeout = self.timeout
        return inner
