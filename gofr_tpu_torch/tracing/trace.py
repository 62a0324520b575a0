"""Span/Tracer core with contextvar propagation and W3C tracecontext (port of
``gofr_tpu/tracing/trace.py``, the same code).

Reference parity: span creation per route (http/router.go:47), per-request
span in middleware (middleware/tracer.go:15-32), user spans via
``ctx.trace(name)`` (context.go:62-72), trace propagation over HTTP headers
(W3C, otel.go:34) and gRPC metadata (grpc/log.go:179-202).
"""

from __future__ import annotations

import os
import contextvars
import re
import threading
import time
from typing import Any

_TRACEPARENT_RE = re.compile(r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")

_current_span: contextvars.ContextVar["Span | None"] = contextvars.ContextVar(
    "gofr_current_span", default=None
)


def _rand_hex(nbytes: int) -> str:
    # os.urandom().hex() measures ~4x faster than random.choices and is
    # collision-safe across processes (span ids are per-request hot path)
    return os.urandom(nbytes).hex()


class Span:
    """A single timed operation. End with ``end()`` or use as a context
    manager. Thread-safe attribute/event mutation."""

    __slots__ = (
        "name", "trace_id", "span_id", "parent_id", "start_ns", "end_ns",
        "attributes", "events", "status_code", "status_desc", "kind",
        "sampled", "_tracer", "_lock", "_token",
    )

    def __init__(
        self,
        name: str,
        trace_id: str,
        span_id: str,
        parent_id: str | None,
        tracer: "Tracer | None",
        *,
        kind: str = "internal",
        sampled: bool = True,
    ) -> None:
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.start_ns = time.time_ns()
        self.end_ns: int | None = None
        self.attributes: dict[str, Any] = {}
        self.events: list[tuple[int, str, dict]] = []
        self.status_code = "UNSET"
        self.status_desc = ""
        self.kind = kind
        self.sampled = sampled
        self._tracer = tracer
        self._lock = threading.Lock()
        self._token: contextvars.Token | None = None

    def set_attribute(self, key: str, value: Any) -> "Span":
        with self._lock:
            self.attributes[key] = value
        return self

    def add_event(self, name: str, attributes: dict | None = None) -> "Span":
        with self._lock:
            self.events.append((time.time_ns(), name, attributes or {}))
        return self

    def set_status(self, code: str, description: str = "") -> "Span":
        self.status_code = code
        self.status_desc = description
        return self

    def record_exception(self, exc: BaseException) -> "Span":
        self.add_event("exception", {"exception.type": type(exc).__name__, "exception.message": str(exc)})
        return self.set_status("ERROR", str(exc))

    @property
    def duration_us(self) -> float:
        end = self.end_ns if self.end_ns is not None else time.time_ns()
        return (end - self.start_ns) / 1e3

    def end(self) -> None:
        # check-and-set under the lock: concurrent enders are an expected
        # path (a drain/stop sweep force-closing a request's spans while
        # the engine thread exits its `with span:` block) — both passing
        # the guard would double-export and double-decrement the live
        # count, sending Tracer.open_spans() negative
        with self._lock:
            if self.end_ns is not None:
                return
            self.end_ns = time.time_ns()
        if self._token is not None:
            try:
                _current_span.reset(self._token)
            except ValueError:
                pass  # ended in a different context than it started
            self._token = None
        if self._tracer is not None:
            self._tracer._on_close(self)  # live-span accounting, always
            if self.sampled:
                self._tracer._on_end(self)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> None:
        if exc is not None:
            self.record_exception(exc)
        self.end()


class Tracer:
    """Creates spans, applies ratio sampling, and hands finished spans to the
    processor (otel.go:26-35)."""

    def __init__(
        self,
        service_name: str = "gofr-app",
        processor: Any = None,
        sample_ratio: float = 1.0,
    ) -> None:
        self.service_name = service_name
        self.processor = processor
        self.sample_ratio = max(0.0, min(1.0, sample_ratio))
        # live-span accounting: started minus ended. The chaos tier's
        # leaked-span check asserts this returns to zero after drain() —
        # an instrumentation path that opens a span and loses it on a
        # fault would otherwise grow silently forever.
        self._live_mu = threading.Lock()
        self._live = 0

    def start_span(
        self,
        name: str,
        *,
        parent: Span | None = None,
        remote_trace_id: str | None = None,
        remote_span_id: str | None = None,
        kind: str = "internal",
        activate: bool = True,
    ) -> Span:
        if parent is None:
            parent = _current_span.get()
        if parent is not None:
            trace_id, parent_id, sampled = parent.trace_id, parent.span_id, parent.sampled
        elif remote_trace_id:
            trace_id, parent_id = remote_trace_id, remote_span_id
            sampled = self._sample(trace_id)
        else:
            trace_id, parent_id = _rand_hex(16), None
            sampled = self._sample(trace_id)
        span = Span(name, trace_id, _rand_hex(8), parent_id, self, kind=kind, sampled=sampled)
        with self._live_mu:
            self._live += 1
        if activate:
            span._token = _current_span.set(span)
        return span

    def _sample(self, trace_id: str) -> bool:
        if self.sample_ratio >= 1.0:
            return True
        if self.sample_ratio <= 0.0:
            return False
        # deterministic by trace id, like OTel's TraceIDRatioBased
        return (int(trace_id[:16], 16) / float(1 << 64)) < self.sample_ratio

    def set_sample_ratio(self, ratio: float) -> None:
        """Live sample-ratio adjustment (the remote trace-ratio poller,
        logging/remote.py): clamped to [0, 1], applies to spans started
        after the call."""
        self.sample_ratio = max(0.0, min(1.0, float(ratio)))

    def _on_end(self, span: Span) -> None:
        if self.processor is not None:
            self.processor.on_end(span)

    def _on_close(self, span: Span) -> None:
        with self._live_mu:
            self._live -= 1

    def open_spans(self) -> int:
        """Spans started but not yet ended — the leaked-span audit."""
        with self._live_mu:
            return self._live

    def set_sample_ratio(self, ratio: float) -> None:
        """Live sample-ratio adjustment (the remote trace-ratio poller,
        logging/remote.py): clamped to [0, 1], applies to spans started
        after the call."""
        self.sample_ratio = max(0.0, min(1.0, float(ratio)))

    def shutdown(self) -> None:
        if self.processor is not None:
            self.processor.shutdown()


def current_span() -> Span | None:
    return _current_span.get()


def extract_traceparent(header: str | None) -> tuple[str, str] | None:
    """Parse a W3C ``traceparent`` header into (trace_id, span_id)."""
    if not header:
        return None
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if not m:
        return None
    _, trace_id, span_id, _ = m.groups()
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return trace_id, span_id


def format_traceparent(span: Span) -> str:
    flags = "01" if span.sampled else "00"
    return f"00-{span.trace_id}-{span.span_id}-{flags}"


def new_tracer(service_name: str = "gofr-app", processor: Any = None, sample_ratio: float = 1.0) -> Tracer:
    return Tracer(service_name, processor, sample_ratio)
