"""Span export pipeline: batch processor + exporters (port of
``gofr_tpu/tracing/export.py``; the OTLP scope is this package's name).

Reference parity: batch span processor + exporter selection by
``TRACE_EXPORTER`` env (otel.go:81-144); the "gofr" exporter posts
zipkin-style JSON (exporter.go:23-125); console exporter for dev.
"""

from __future__ import annotations

import json
import queue
import threading
import urllib.request
from typing import Any

from gofr_tpu_torch.tracing.trace import Span


class InMemoryExporter:
    """Collects spans for tests."""

    def __init__(self) -> None:
        self.spans: list[Span] = []
        self._lock = threading.Lock()

    def export(self, spans: list[Span]) -> None:
        with self._lock:
            self.spans.extend(spans)

    def shutdown(self) -> None:
        pass


class ConsoleExporter:
    def __init__(self, logger: Any = None) -> None:
        self._logger = logger

    def export(self, spans: list[Span]) -> None:
        for s in spans:
            line = f"span={s.name} trace={s.trace_id} id={s.span_id} dur_us={s.duration_us:.0f}"
            if self._logger is not None:
                self._logger.debug(line)
            else:
                print(line)

    def shutdown(self) -> None:
        pass


class ZipkinJSONExporter:
    """POSTs zipkin-v2 JSON batches, the wire shape of the reference's custom
    "gofr" exporter (exporter.go:49-125)."""

    def __init__(self, url: str, service_name: str = "gofr-app",
                 timeout: float = 5.0, auth_header: str = "",
                 logger: Any = None) -> None:
        self.url = url
        self.service_name = service_name
        self.timeout = timeout
        self.auth_header = auth_header
        self._logger = logger

    def export(self, spans: list[Span]) -> None:
        payload = [
            {
                "id": s.span_id,
                "traceId": s.trace_id,
                "parentId": s.parent_id,
                "name": s.name,
                "timestamp": s.start_ns // 1000,
                "duration": max(1, int(s.duration_us)),
                "kind": s.kind.upper(),
                "localEndpoint": {"serviceName": self.service_name},
                "tags": {str(k): str(v) for k, v in s.attributes.items()},
                "annotations": [
                    {"timestamp": ts // 1000, "value": name} for ts, name, _ in s.events
                ],
            }
            for s in spans
        ]
        headers = {"Content-Type": "application/json"}
        if self.auth_header:
            headers["Authorization"] = self.auth_header
        try:
            req = urllib.request.Request(
                self.url,
                data=json.dumps(payload).encode("utf-8"),
                headers=headers,
            )
            urllib.request.urlopen(req, timeout=self.timeout).close()
        except Exception as exc:
            if self._logger is not None:
                self._logger.debug(f"span export failed: {exc}")

    def shutdown(self) -> None:
        pass


_OTLP_KIND = {
    "internal": 1, "server": 2, "client": 3, "producer": 4, "consumer": 5,
}
_OTLP_STATUS = {"UNSET": 0, "OK": 1, "ERROR": 2}


class OTLPHTTPExporter:
    """OTLP over HTTP with JSON encoding (the opentelemetry-proto JSON
    mapping): POST resourceSpans to a collector's ``/v1/traces``. This is
    the exporter an operator actually points at a 2026 stack — Jaeger,
    Tempo, vendor collectors all ingest OTLP/HTTP. Parity target:
    otel.go:104-119 (otlp/jaeger both build an OTLP exporter;
    TRACER_AUTH_KEY rides the Authorization header)."""

    def __init__(
        self,
        url: str,
        service_name: str = "gofr-app",
        timeout: float = 5.0,
        auth_header: str = "",
        logger: Any = None,
    ) -> None:
        self.url = url
        self.service_name = service_name
        self.timeout = timeout
        self.auth_header = auth_header
        self._logger = logger

    def _span_json(self, s: Span) -> dict:
        out = {
            "traceId": s.trace_id,
            "spanId": s.span_id,
            "name": s.name,
            "kind": _OTLP_KIND.get(s.kind, 1),
            # nanos serialize as STRINGS in the OTLP JSON mapping (int64)
            "startTimeUnixNano": str(s.start_ns),
            "endTimeUnixNano": str(s.end_ns or s.start_ns),
            "attributes": [
                {"key": str(k), "value": {"stringValue": str(v)}}
                for k, v in s.attributes.items()
            ],
            "events": [
                {
                    "timeUnixNano": str(ts),
                    "name": name,
                    "attributes": [
                        {"key": str(k), "value": {"stringValue": str(v)}}
                        for k, v in (attrs or {}).items()
                    ],
                }
                for ts, name, attrs in s.events
            ],
            "status": {"code": _OTLP_STATUS.get(s.status_code, 0)},
        }
        if s.parent_id:
            out["parentSpanId"] = s.parent_id
        if s.status_desc:
            out["status"]["message"] = s.status_desc
        return out

    def export(self, spans: list[Span]) -> None:
        payload = {
            "resourceSpans": [
                {
                    "resource": {
                        "attributes": [
                            {
                                "key": "service.name",
                                "value": {"stringValue": self.service_name},
                            }
                        ]
                    },
                    "scopeSpans": [
                        {
                            "scope": {"name": "gofr_tpu_torch.tracing"},
                            "spans": [self._span_json(s) for s in spans],
                        }
                    ],
                }
            ]
        }
        headers = {"Content-Type": "application/json"}
        if self.auth_header:
            headers["Authorization"] = self.auth_header
        try:
            req = urllib.request.Request(
                self.url, data=json.dumps(payload).encode(), headers=headers
            )
            urllib.request.urlopen(req, timeout=self.timeout).close()
        except Exception as exc:
            if self._logger is not None:
                self._logger.debug(f"otlp span export failed: {exc}")

    def shutdown(self) -> None:
        pass


class BatchSpanProcessor:
    """Buffers finished spans and exports in batches from a daemon thread
    (otel.go batch span processor semantics)."""

    def __init__(self, exporter: Any, max_batch: int = 512, interval: float = 2.0, max_queue: int = 4096) -> None:
        self._exporter = exporter
        self._queue: queue.Queue = queue.Queue(maxsize=max_queue)
        self._max_batch = max_batch
        self._interval = interval
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, name="span-export", daemon=True)
        self._thread.start()

    def on_end(self, span: Span) -> None:
        try:
            self._queue.put_nowait(span)
        except queue.Full:
            pass  # drop rather than block the hot path

    def _drain(self) -> list[Span]:
        batch: list[Span] = []
        while len(batch) < self._max_batch:
            try:
                batch.append(self._queue.get_nowait())
            except queue.Empty:
                break
        return batch

    def _loop(self) -> None:
        while not self._stop.wait(self._interval):
            batch = self._drain()
            if batch:
                self._exporter.export(batch)
        # final flush
        batch = self._drain()
        if batch:
            self._exporter.export(batch)

    def force_flush(self) -> None:
        batch = self._drain()
        if batch:
            self._exporter.export(batch)

    def shutdown(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._exporter.shutdown()


class SimpleSpanProcessor:
    """Synchronous export — used in tests."""

    def __init__(self, exporter: Any) -> None:
        self._exporter = exporter

    def on_end(self, span: Span) -> None:
        self._exporter.export([span])

    def force_flush(self) -> None:
        pass

    def shutdown(self) -> None:
        self._exporter.shutdown()


def build_exporter(config: Any, logger: Any = None) -> Any | None:
    """Exporter selection by TRACE_EXPORTER (otel.go:81-144):

    - ``otlp`` / ``jaeger`` → OTLP/HTTP JSON to TRACER_URL or
      ``http://TRACER_HOST:TRACER_PORT/v1/traces`` (otel.go:104-119 —
      jaeger ingests OTLP natively);
    - ``zipkin`` → zipkin-v2 JSON to TRACER_URL or
      ``http://TRACER_HOST:TRACER_PORT/api/v2/spans`` (otel.go:121-135);
    - ``gofr`` → zipkin-shape JSON to the hosted collector
      (exporter.go:23-125);
    - ``console`` → dev stdout; anything else → None (disabled).

    TRACER_AUTH_KEY becomes the Authorization header, as in the
    reference."""
    name = (config.get("TRACE_EXPORTER") or "").lower()
    if not name:
        return None
    service = config.get_or_default("APP_NAME", "gofr-app")
    if name == "console":
        return ConsoleExporter(logger)
    url = config.get("TRACER_URL")
    host = config.get("TRACER_HOST")
    auth = config.get_or_default("TRACER_AUTH_KEY", "")
    if name in ("otlp", "jaeger"):
        if not url and host:
            # 4318 is the OTLP/HTTP port every standard collector
            # (jaeger, tempo, otel-collector) listens on; 9411 is zipkin's
            port = config.get_or_default("TRACER_PORT", "4318")
            url = f"http://{host}:{port}/v1/traces"
        if url:
            return OTLPHTTPExporter(url, service, auth_header=auth,
                                    logger=logger)
    if name == "gofr":
        url = url or "https://tracer-api.gofr.dev/api/spans"
        return ZipkinJSONExporter(url, service, auth_header=auth,
                                  logger=logger)
    if name == "zipkin":
        if not url and host:
            port = config.get_or_default("TRACER_PORT", "9411")
            url = f"http://{host}:{port}/api/v2/spans"
        if url:
            return ZipkinJSONExporter(url, service, auth_header=auth,
                                      logger=logger)
    if logger is not None:
        if name in ("otlp", "jaeger", "zipkin"):
            # a known exporter with no endpoint is a CONFIG gap — blaming
            # the exporter name would send the operator down the wrong path
            logger.error(
                f"TRACE_EXPORTER={name} needs TRACER_URL or TRACER_HOST; "
                "tracing disabled"
            )
        else:
            logger.error(f"unsupported TRACE_EXPORTER: {name}")
    return None
