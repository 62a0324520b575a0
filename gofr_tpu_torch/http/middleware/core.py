"""Core middleware: tracing, logging, CORS, metrics (a copy of
``gofr_tpu/http/middleware/core.py`` over the port's tracer).

Reference parity:
- tracing: middleware/tracer.go:15-32 — extract W3C tracecontext, start span
  ``"METHOD /path"``.
- logging: middleware/logger.go — per-request structured log with trace id,
  span id, µs latency, client IP from X-Forwarded-For (:118-170), panic
  recovery to a 500 JSON (:177-201), probe-path suppression (:142-156),
  X-Correlation-ID response header (:101).
- CORS: middleware/cors.go:13-57 — defaults '*' + methods from registered
  routes, overridable via ACCESS_CONTROL_* configs (middleware/config.go:29-41).
- metrics: middleware/metrics.go:22-54 — app_http_response histogram with
  path-template/method/status labels.
"""

from __future__ import annotations

import io
import json
import time
import traceback
from typing import Any, Awaitable, Callable

from gofr_tpu_torch.http.responder import WireResponse
from gofr_tpu_torch.tracing.trace import current_span, extract_traceparent

# A wire handler maps the parsed request to a WireResponse.
WireHandler = Callable[[Any], Awaitable[WireResponse]]
Middleware = Callable[[WireHandler], WireHandler]

PROBE_PATHS = ("/.well-known/health", "/.well-known/alive", "/favicon.ico")


def chain(handler: WireHandler, middlewares: list[Middleware]) -> WireHandler:
    """Wrap ``handler`` so the first middleware in the list runs outermost
    (http_server.go:36-41 ordering)."""
    for mw in reversed(middlewares):
        handler = mw(handler)
    return handler


def tracing_middleware(tracer: Any) -> Middleware:
    def mw(inner: WireHandler) -> WireHandler:
        async def handle(req: Any) -> WireResponse:
            remote = extract_traceparent(req.header("traceparent"))
            span = tracer.start_span(
                f"{req.method} {req.path}",
                remote_trace_id=remote[0] if remote else None,
                remote_span_id=remote[1] if remote else None,
                kind="server",
            )
            with span:
                span.set_attribute("http.method", req.method)
                span.set_attribute("http.target", req.path)
                resp = await inner(req)
                span.set_attribute("http.status_code", resp.status)
                if resp.status >= 500:
                    span.set_status("ERROR", f"HTTP {resp.status}")
                return resp

        return handle

    return mw


class RequestLog:
    """The per-request log payload (middleware/logger.go:60-91), pretty-
    printable for terminals."""

    def __init__(self, method: str, uri: str, status: int, duration_us: int, ip: str,
                 trace_id: str = "", span_id: str = "") -> None:
        self.method = method
        self.uri = uri
        self.response = status
        self.response_time = duration_us
        self.ip = ip
        self.trace_id = trace_id
        self.span_id = span_id

    def pretty_print(self, writer: io.TextIOBase) -> None:
        color = 34 if self.response < 400 else (33 if self.response < 500 else 31)
        writer.write(
            f"\x1b[{color}m{self.response}\x1b[0m "
            f"{self.response_time:>8}µs {self.method:>6} {self.uri}"
        )

    def __str__(self) -> str:
        return f"{self.response} {self.response_time}µs {self.method} {self.uri}"


def logging_middleware(logger: Any, *, suppress_probes: bool | None = None, config: Any = None) -> Middleware:
    if suppress_probes is None:
        suppress_probes = True
        if config is not None:
            suppress_probes = config.get_or_default("LOG_DISABLE_PROBES", "true").lower() == "true"

    def mw(inner: WireHandler) -> WireHandler:
        async def handle(req: Any) -> WireResponse:
            start = time.perf_counter_ns()
            try:
                resp = await inner(req)
            except Exception as exc:
                # panic recovery → 500 JSON (logger.go:177-201)
                logger.error(
                    f"panic in middleware chain: {exc}",
                    stack=traceback.format_exc(limit=20),
                )
                resp = WireResponse(
                    status=500,
                    headers={"Content-Type": "application/json"},
                    body=json.dumps(
                        {"error": {"message": "some unexpected error has occurred"}}
                    ).encode(),
                )
            duration_us = (time.perf_counter_ns() - start) // 1000
            if suppress_probes and req.path in PROBE_PATHS:
                return resp
            span = current_span()
            ip = req.header("x-forwarded-for").split(",")[0].strip() or req.remote_addr
            entry = RequestLog(
                req.method, req.path, resp.status, duration_us, ip,
                trace_id=span.trace_id if span else "",
                span_id=span.span_id if span else "",
            )
            kw = {"trace_id": entry.trace_id or None, "span_id": entry.span_id or None}
            if resp.status >= 500:
                logger.error(entry, **kw)
            else:
                logger.info(entry, **kw)
            return resp

        return handle

    return mw


class CORSConfig:
    """ACCESS_CONTROL_* overrides (middleware/config.go:29-41)."""

    HEADER_NAMES = (
        "Access-Control-Allow-Origin",
        "Access-Control-Allow-Headers",
        "Access-Control-Allow-Methods",
        "Access-Control-Allow-Credentials",
        "Access-Control-Expose-Headers",
        "Access-Control-Max-Age",
    )

    def __init__(self, config: Any = None) -> None:
        self.overrides: dict[str, str] = {}
        if config is not None:
            for header in self.HEADER_NAMES:
                env_key = header.upper().replace("-", "_")
                val = config.get(env_key)
                if val:
                    self.overrides[header] = val


def cors_middleware(cors: CORSConfig | None = None, router: Any = None) -> Middleware:
    cors = cors or CORSConfig()

    def mw(inner: WireHandler) -> WireHandler:
        async def handle(req: Any) -> WireResponse:
            if req.method == "OPTIONS":
                resp = WireResponse(status=200)
            else:
                resp = await inner(req)
            resp.headers.setdefault(
                "Access-Control-Allow-Origin", cors.overrides.get("Access-Control-Allow-Origin", "*")
            )
            methods = cors.overrides.get("Access-Control-Allow-Methods")
            if not methods and router is not None:
                registered = router.registered_methods()
                methods = ", ".join(registered + ["OPTIONS"]) if registered else None
            if methods:
                resp.headers.setdefault("Access-Control-Allow-Methods", methods)
            resp.headers.setdefault(
                "Access-Control-Allow-Headers",
                cors.overrides.get(
                    "Access-Control-Allow-Headers",
                    "Authorization, Content-Type, x-requested-with, origin, true-client-ip, X-Correlation-ID",
                ),
            )
            for header in ("Access-Control-Allow-Credentials", "Access-Control-Expose-Headers", "Access-Control-Max-Age"):
                if header in cors.overrides:
                    resp.headers.setdefault(header, cors.overrides[header])
            return resp

        return handle

    return mw


def metrics_middleware(metrics: Any, router: Any = None) -> Middleware:
    def mw(inner: WireHandler) -> WireHandler:
        async def handle(req: Any) -> WireResponse:
            start = time.perf_counter()
            resp = await inner(req)
            elapsed = time.perf_counter() - start
            path = req.path
            if router is not None:
                path = router.route_template(req.method, req.path) or _normalize_static(path)
            metrics.record_histogram(
                "app_http_response", elapsed,
                path=path, method=req.method, status=str(resp.status),
            )
            return resp

        return handle

    return mw


def _normalize_static(path: str) -> str:
    """Collapse static asset paths to one label value
    (middleware/metrics.go static normalization)."""
    if "." in path.rsplit("/", 1)[-1]:
        return path.rsplit("/", 1)[0] + "/<asset>"
    return path
