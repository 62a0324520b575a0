"""The handler Context: request + container + trace-aware logger (a copy of
``gofr_tpu/context.py``).

Reference parity: pkg/gofr/context.go:18-38 — Context embeds the stdlib
context (here: the request + cancellation state), the Request, the
*Container, a trace-aware ContextLogger, and ``Out`` terminal access for CMD
apps. ``trace()`` opens user spans (context.go:62-72), ``bind`` binds the
body (context.go:74), ``get_auth_info`` exposes auth claims
(context.go:121-133), ``get_correlation_id`` returns the active trace id
(context.go:181-183). WebSocket write helpers (context.go:81-108) live on the
bound connection.

Datasource access mirrors ``ctx.TPU`` / ``ctx.SQL`` in the reference:
``ctx.tpu`` (the device datasource, ``App.add_tpu``), ``ctx.sql``,
``ctx.redis``, ``ctx.file``, ``ctx.kv_store`` and ``ctx.cache`` (the
container's slots, filled by ``App.add_datasource(name, ds)``),
``ctx.serving``, the broker through ``get_publisher`` / ``get_subscriber``,
``ctx.datasource(name)`` (any other family: ``document``, ``widecolumn``,
``search``, ``timeseries``), plus ``ctx.get_http_service(name)``.
"""

from __future__ import annotations

from typing import Any

from gofr_tpu_torch.container.container import Container
from gofr_tpu_torch.logging.logger import ContextLogger
from gofr_tpu_torch.tracing.trace import Span, current_span


class AuthInfo:
    """context.go:121-133 / middleware auth results."""

    def __init__(self, method: str = "", username: str = "", api_key: str = "", claims: dict | None = None) -> None:
        self.method = method  # "basic" | "apikey" | "oauth" | ""
        self.username = username
        self.api_key = api_key
        self.claims = claims or {}

    def get_username(self) -> str:
        return self.username

    def get_apikey(self) -> str:
        return self.api_key

    def get_claims(self) -> dict:
        return self.claims


class Context:
    def __init__(
        self,
        request: Any,
        container: Container,
        responder: Any = None,
        out: Any = None,
    ) -> None:
        self.request = request
        self.container = container
        self.responder = responder
        self.out = out  # terminal for CMD apps (cli/terminal.py)
        self.auth: AuthInfo = getattr(request, "auth", None) or AuthInfo()
        self.websocket: Any = None  # bound by the WS transport
        span = current_span()
        self.logger = ContextLogger(
            container.logger,
            trace_id=span.trace_id if span else None,
            span_id=span.span_id if span else None,
        )
        self._canceled = False

    # -- request passthroughs -------------------------------------------------
    def param(self, key: str) -> str:
        return self.request.param(key)

    def params(self, key: str) -> list[str]:
        return self.request.params(key)

    def path_param(self, key: str) -> str:
        return self.request.path_param(key)

    def bind(self, target: Any) -> Any:
        return self.request.bind(target)

    def header(self, key: str) -> str:
        getter = getattr(self.request, "header", None)
        return getter(key) if callable(getter) else ""

    # -- container accessors (ctx.SQL etc.) -----------------------------------
    @property
    def config(self) -> Any:
        return self.container.config

    @property
    def metrics(self) -> Any:
        return self.container.metrics_manager

    @property
    def tpu(self) -> Any:
        return self.container.tpu

    @property
    def sql(self) -> Any:
        return self.container.sql

    @property
    def redis(self) -> Any:
        return self.container.redis

    @property
    def kv_store(self) -> Any:
        return self.container.kv_store

    @property
    def file(self) -> Any:
        return self.container.file

    @property
    def cache(self) -> Any:
        return self.container.cache

    @property
    def serving(self) -> Any:
        return self.container.serving

    def get_http_service(self, name: str) -> Any:
        return self.container.get_http_service(name)

    def get_publisher(self) -> Any:
        return self.container.get_publisher()

    def get_subscriber(self) -> Any:
        return self.container.get_subscriber()

    def datasource(self, name: str) -> Any:
        return self.container.extra_datasources.get(name)

    # -- tracing / identity ----------------------------------------------------
    def trace(self, name: str) -> Span:
        """Open a user span as a child of the request span
        (context.go:62-72)."""
        return self.container.tracer.start_span(name)

    def get_correlation_id(self) -> str:
        span = current_span()
        return span.trace_id if span else ""

    def get_auth_info(self) -> AuthInfo:
        return self.auth

    # -- cancellation ----------------------------------------------------------
    def cancel(self) -> None:
        self._canceled = True

    def is_canceled(self) -> bool:
        return self._canceled

    # -- websocket write helpers (context.go:81-108) ---------------------------
    def write_message_to_socket(self, data: Any) -> None:
        if self.websocket is None:
            raise RuntimeError("no websocket bound to this context")
        self.websocket.send(data)

    def write_message_to_service(self, service_name: str, data: Any) -> None:
        manager = self.container.ws_manager
        if manager is None:
            raise RuntimeError("no websocket manager configured")
        manager.write_to_service(service_name, data)
