"""The handler Context: request + container + trace-aware logger (a copy of
``gofr_tpu/context.py`` without the auth, CMD-terminal and WebSocket parts,
which are not ported).

Reference parity: pkg/gofr/context.go:18-38 — Context embeds the stdlib
context (here: the request + cancellation state), the Request, the
*Container and a trace-aware ContextLogger. ``trace()`` opens user spans
(context.go:62-72), ``bind`` binds the body (context.go:74),
``get_correlation_id`` returns the active trace id (context.go:181-183).

Datasource access mirrors ``ctx.SQL`` / ``ctx.Redis`` in the reference:
``ctx.serving``, the broker through ``get_publisher``,
``ctx.datasource(name)``, plus ``ctx.get_http_service(name)``.
"""

from __future__ import annotations

from typing import Any

from gofr_tpu_torch.container.container import Container
from gofr_tpu_torch.logging.logger import ContextLogger
from gofr_tpu_torch.tracing.trace import Span, current_span


class Context:
    def __init__(
        self,
        request: Any,
        container: Container,
        responder: Any = None,
    ) -> None:
        self.request = request
        self.container = container
        self.responder = responder
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
    def serving(self) -> Any:
        return self.container.serving

    def get_http_service(self, name: str) -> Any:
        return self.container.get_http_service(name)

    def get_publisher(self) -> Any:
        return self.container.get_publisher()

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

    # -- cancellation ----------------------------------------------------------
    def cancel(self) -> None:
        self._canceled = True

    def is_canceled(self) -> bool:
        return self._canceled
