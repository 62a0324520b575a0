"""Tracing of the port: spans with contextvar propagation, W3C
``traceparent`` parse and format, a ratio sampler and the export pipeline
(a copy of ``gofr_tpu/tracing``). The engine hangs each request's spans
off the caller's span passed as ``submit(trace_ctx=...)``."""

from gofr_tpu_torch.tracing.export import (
    BatchSpanProcessor,
    ConsoleExporter,
    InMemoryExporter,
    OTLPHTTPExporter,
    SimpleSpanProcessor,
    ZipkinJSONExporter,
    build_exporter,
)
from gofr_tpu_torch.tracing.trace import (
    Span,
    Tracer,
    current_span,
    extract_traceparent,
    format_traceparent,
    new_tracer,
)

__all__ = [
    "BatchSpanProcessor", "ConsoleExporter", "InMemoryExporter", "OTLPHTTPExporter",
    "SimpleSpanProcessor", "Span", "Tracer", "ZipkinJSONExporter", "build_exporter",
    "current_span", "extract_traceparent", "format_traceparent", "new_tracer",
]
