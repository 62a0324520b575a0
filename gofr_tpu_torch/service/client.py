"""Base HTTP service client (a copy of ``gofr_tpu/service/client.py`` over
the port's tracer and chaos tier: ``service.request`` fires on every
request and stream open).

Reference parity: service/new.go — every request opens a client span,
injects the W3C traceparent header, logs a structured line and records the
``app_http_service_response`` histogram (:136-210). Sync under the hood
(urllib; handlers run in executor threads), with async wrappers for use on
the event loop.
"""

from __future__ import annotations

import io
import json as json_mod
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Any

from gofr_tpu_torch import chaos
from gofr_tpu_torch.tracing.trace import current_span, format_traceparent


class ServiceResponse:
    def __init__(self, status: int, headers: dict[str, str], body: bytes) -> None:
        self.status_code = status
        self.headers = headers
        self.body = body

    def json(self) -> Any:
        return json_mod.loads(self.body.decode("utf-8"))

    @property
    def text(self) -> str:
        return self.body.decode("utf-8", "replace")

    @property
    def ok(self) -> bool:
        return 200 <= self.status_code < 300


class StreamingServiceResponse:
    """A response whose body is consumed incrementally (SSE / chunked
    transfer): status + headers up front, the body as a line iterator.
    The caller owns the lifetime — iterate :meth:`lines` to the end or
    :meth:`close` early (closing the socket is how a client aborts a
    server-sent stream)."""

    def __init__(self, status: int, headers: dict[str, str], raw: Any) -> None:
        self.status_code = status
        self.headers = headers
        self._raw = raw

    @property
    def ok(self) -> bool:
        return 200 <= self.status_code < 300

    def lines(self) -> Any:
        """Iterate decoded lines (newline-stripped) as they arrive."""
        for line in self._raw:
            yield line.decode("utf-8", "replace").rstrip("\r\n")

    def read_body(self) -> bytes:
        """Drain the remaining body (error responses carry JSON)."""
        return self._raw.read()

    def close(self) -> None:
        try:
            self._raw.close()
        except Exception:
            pass  # already torn down by the server side


class ServiceLog:
    def __init__(self, method: str, url: str, status: int, duration_us: int) -> None:
        self.method, self.url, self.response_code, self.duration = method, url, status, duration_us

    def pretty_print(self, writer: io.TextIOBase) -> None:
        color = 34 if self.response_code < 400 else 31
        writer.write(
            f"\x1b[{color}m{self.response_code}\x1b[0m {self.duration:>8}µs "
            f"{self.method:>6} {self.url}"
        )

    def __str__(self) -> str:
        return f"{self.response_code} {self.duration}µs {self.method} {self.url}"


class HTTPService:
    """The innermost client; Options wrap it (service/new.go:78-87)."""

    def __init__(self, address: str, logger: Any = None, metrics: Any = None,
                 tracer: Any = None, timeout: float = 30.0) -> None:
        self.address = address.rstrip("/")
        self.logger = logger
        self.metrics = metrics
        self.tracer = tracer
        self.timeout = timeout

    # -- request core ----------------------------------------------------------
    def request(
        self,
        method: str,
        path: str,
        *,
        params: dict | None = None,
        body: bytes | None = None,
        json: Any = None,
        headers: dict[str, str] | None = None,
        timeout: float | None = None,
    ) -> ServiceResponse:
        url = f"{self.address}/{path.lstrip('/')}" if path else self.address
        if params:
            url += ("&" if "?" in url else "?") + urllib.parse.urlencode(params, doseq=True)
        hdrs = dict(headers or {})
        if json is not None:
            body = json_mod.dumps(json).encode("utf-8")
            hdrs.setdefault("Content-Type", "application/json")

        span = None
        if self.tracer is not None:
            span = self.tracer.start_span(f"http-service {method} {url}", kind="client")
        parent = span or current_span()
        if parent is not None:
            hdrs.setdefault("traceparent", format_traceparent(parent))

        start = time.perf_counter()
        try:
            chaos.maybe_fail("service.request")
            req = urllib.request.Request(url, data=body, method=method.upper(), headers=hdrs)
            try:
                with urllib.request.urlopen(req, timeout=timeout or self.timeout) as resp:
                    result = ServiceResponse(resp.status, dict(resp.headers), resp.read())
            except urllib.error.HTTPError as exc:
                result = ServiceResponse(exc.code, dict(exc.headers), exc.read())
            self._observe(method, url, result.status_code, start)
            return result
        except Exception as exc:
            self._observe(method, url, 0, start)
            if span is not None:
                span.record_exception(exc)
            raise
        finally:
            if span is not None:
                span.end()

    def stream(
        self,
        method: str,
        path: str,
        *,
        json: Any = None,
        headers: dict[str, str] | None = None,
        timeout: float | None = None,
    ) -> StreamingServiceResponse:
        """Open a request whose response body streams (SSE / chunked):
        returns a :class:`StreamingServiceResponse` once the response
        HEAD arrives — the body is read incrementally by the caller, so
        a token can be observed the moment the server emits it instead
        of at completion. Error statuses return normally (status +
        drainable body); transport failures raise. The caller must
        close() or fully consume the stream."""
        url = f"{self.address}/{path.lstrip('/')}" if path else self.address
        hdrs = dict(headers or {})
        body = None
        if json is not None:
            body = json_mod.dumps(json).encode("utf-8")
            hdrs.setdefault("Content-Type", "application/json")
        parent = current_span()
        if parent is not None:
            hdrs.setdefault("traceparent", format_traceparent(parent))
        start = time.perf_counter()
        try:
            chaos.maybe_fail("service.request")
            req = urllib.request.Request(
                url, data=body, method=method.upper(), headers=hdrs
            )
            try:
                resp = urllib.request.urlopen(
                    req, timeout=timeout or self.timeout
                )
            except urllib.error.HTTPError as exc:
                resp = exc  # HTTPError IS a readable response object
            self._observe(method, url, resp.status, start)
            return StreamingServiceResponse(
                resp.status, dict(resp.headers), resp
            )
        except Exception:
            self._observe(method, url, 0, start)
            raise

    def _observe(self, method: str, url: str, status: int, start: float) -> None:
        duration_us = int((time.perf_counter() - start) * 1e6)
        if self.logger is not None:
            log = ServiceLog(method.upper(), url, status, duration_us)
            (self.logger.info if 0 < status < 500 else self.logger.error)(log)
        if self.metrics is not None:
            self.metrics.record_histogram(
                "app_http_service_response", duration_us / 1e6,
                path=self.address, method=method.upper(), status=str(status),
            )

    # -- verbs (service/new.go HTTP interface) ---------------------------------
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

    # -- health (service/health.go:24-26) --------------------------------------
    health_endpoint = ".well-known/alive"
    health_timeout: float | None = None

    def health_check(self) -> dict[str, Any]:
        try:
            resp = self.request("GET", self.health_endpoint, timeout=self.health_timeout)
            if resp.ok:
                return {"status": "UP", "details": {"host": self.address}}
            return {"status": "DOWN", "details": {"host": self.address, "code": resp.status_code}}
        except Exception as exc:
            return {"status": "DOWN", "details": {"host": self.address, "error": str(exc)}}


def new_http_service(address: str, logger: Any = None, metrics: Any = None,
                     tracer: Any = None, *options: Any) -> Any:
    """NewHTTPService (service/new.go:78-87): build the base client then
    apply each Option decorator in order."""
    svc: Any = HTTPService(address, logger, metrics, tracer)
    for opt in options:
        svc = opt.add_option(svc)
    return svc
