"""The port's tracing package against the JAX package's, on the CPU:
``traceparent`` formatting and parsing, the ratio sampler's decision for
the same trace ids, the span tree with contextvar propagation and live-span
accounting, and the exporters (in-memory, console, batch, the Zipkin and
OTLP payloads against a local collector, and exporter selection).
"""

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np
import pytest

pytest.importorskip("torch")

from gofr_tpu import tracing as jtracing  # noqa: E402
from gofr_tpu.tracing import export as jexport  # noqa: E402
from gofr_tpu_torch import tracing  # noqa: E402
from gofr_tpu_torch.tracing import export  # noqa: E402

SIDES = {"ref": (jtracing, jexport), "port": (tracing, export)}


def test_traceparent_round_trip_agrees():
    rng = np.random.default_rng(0)
    headers = ["garbage", "", None, "00-" + "0" * 32 + "-" + "1" * 16 + "-01",
               "00-" + "a" * 32 + "-" + "0" * 16 + "-01",
               " 00-" + "AB" * 16 + "-" + "cd" * 8 + "-00 ",
               "01-" + "f" * 32 + "-" + "e" * 16 + "-01x"]
    for _ in range(50):
        headers.append(f"{rng.integers(0, 256):02x}-{os.urandom(16).hex()}-"
                       f"{os.urandom(8).hex()}-{rng.integers(0, 256):02x}")
    for h in headers:
        assert tracing.extract_traceparent(h) == jtracing.extract_traceparent(h), h
    for side, (mod, _) in SIDES.items():
        tracer = mod.Tracer("t")
        for sampled in (True, False):
            span = tracer.start_span("s", activate=False)
            span.sampled = sampled
            header = mod.format_traceparent(span)
            assert header == jtracing.format_traceparent(span) == tracing.format_traceparent(span)
            assert mod.extract_traceparent(header) == (span.trace_id, span.span_id)
            span.end()
        assert tracer.open_spans() == 0, side


@pytest.mark.parametrize("ratio", [0.0, 0.1, 0.5, 0.9, 1.0, -1.0, 2.0])
def test_ratio_sampler_decides_the_same(ratio):
    ref, port = jtracing.Tracer("t", sample_ratio=ratio), tracing.Tracer("t", sample_ratio=ratio)
    assert port.sample_ratio == ref.sample_ratio
    rng = np.random.default_rng(int(abs(ratio) * 10))
    for _ in range(200):
        tid = rng.bytes(16).hex()
        assert port._sample(tid) == ref._sample(tid)
        a = port.start_span("r", remote_trace_id=tid, remote_span_id="b" * 16, activate=False)
        b = ref.start_span("r", remote_trace_id=tid, remote_span_id="b" * 16, activate=False)
        assert (a.sampled, a.trace_id, a.parent_id) == (b.sampled, b.trace_id, b.parent_id)
        a.end()
        b.end()
    for r in (0.3, 5.0, -2.0):
        port.set_sample_ratio(r)
        ref.set_sample_ratio(r)
        assert port.sample_ratio == ref.sample_ratio


def _tree(mod, exp_mod) -> tuple[list, int, object]:
    """The same span program on either side: nested activated spans, an
    unactivated child with an explicit parent, an exception, a double end
    and an unsampled tree; returns what was exported."""
    exporter = exp_mod.InMemoryExporter()
    tracer = mod.Tracer("t", exp_mod.SimpleSpanProcessor(exporter))
    with tracer.start_span("root", kind="server") as root:
        assert mod.current_span() is root
        with tracer.start_span("child") as child:
            child.set_attribute("k", 1).add_event("e", {"a": "b"})
            side = tracer.start_span("side", parent=root, activate=False)
            assert mod.current_span() is child
        side.end()
        side.end()  # idempotent
        with pytest.raises(ValueError):
            with tracer.start_span("fails"):
                raise ValueError("boom")
    assert mod.current_span() is None
    tracer.set_sample_ratio(0.0)
    with tracer.start_span("unsampled") as u:
        with tracer.start_span("unsampled child") as uc:
            assert not uc.sampled and uc.trace_id == u.trace_id
    live = tracer.open_spans()
    out = [(s.name, s.kind, s.status_code, s.status_desc, dict(s.attributes),
            [(n, a) for _, n, a in s.events],
            None if s.parent_id is None else [x.span_id for x in exporter.spans].index(s.parent_id)
            if s.parent_id in [x.span_id for x in exporter.spans] else "outside",
            s.trace_id == exporter.spans[-1].trace_id, s.end_ns >= s.start_ns)
           for s in exporter.spans]
    return out, live, exporter


def test_span_tree_and_live_accounting_agree():
    ref, ref_live, _ = _tree(jtracing, jexport)
    port, port_live, _ = _tree(tracing, export)
    assert port == ref
    assert port_live == ref_live == 0
    assert [x[0] for x in port] == ["child", "side", "fails", "root"]


def test_console_and_batch_exporters_agree():
    for mod, exp_mod in SIDES.values():
        lines = []

        class Log:
            def debug(self, line):
                lines.append(line.split(" trace=")[0])

        mem = exp_mod.InMemoryExporter()
        batch = exp_mod.BatchSpanProcessor(mem, max_batch=3, interval=60.0)
        tracer = mod.Tracer("t", batch)
        for i in range(7):
            tracer.start_span(f"s{i}", activate=False).end()
        batch.force_flush()
        assert [s.name for s in mem.spans] == ["s0", "s1", "s2"]
        batch.shutdown()  # its final flush exports one more batch
        assert [s.name for s in mem.spans] == [f"s{i}" for i in range(6)]
        batch.force_flush()
        assert [s.name for s in mem.spans] == [f"s{i}" for i in range(7)]
        exp_mod.ConsoleExporter(Log()).export(mem.spans[:2])
        assert lines == ["span=s0", "span=s1"]


class _Collector(BaseHTTPRequestHandler):
    received: list = []

    def do_POST(self):
        body = self.rfile.read(int(self.headers["Content-Length"]))
        type(self).received.append((self.path, self.headers.get("Authorization"), json.loads(body)))
        self.send_response(200)
        self.end_headers()

    def log_message(self, *a):
        pass


def _strip(payload):
    """The payload less ids, times and the instrumentation scope (each
    package names itself)."""
    if isinstance(payload, dict):
        return {k: _strip(v) for k, v in payload.items()
                if k not in ("traceId", "spanId", "parentSpanId", "id", "parentId",
                             "startTimeUnixNano", "endTimeUnixNano", "timeUnixNano",
                             "timestamp", "duration", "scope")}
    if isinstance(payload, list):
        return [_strip(v) for v in payload]
    return payload


def test_zipkin_and_otlp_payloads_agree():
    """Both exporters post the same shapes to a local collector."""
    httpd = HTTPServer(("127.0.0.1", 0), _Collector)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        payloads = {}
        for side, (mod, exp_mod) in SIDES.items():
            _Collector.received = []
            base = f"http://127.0.0.1:{httpd.server_port}"
            for exporter in (exp_mod.OTLPHTTPExporter(base + "/v1/traces", "svc", auth_header="k"),
                             exp_mod.ZipkinJSONExporter(base + "/api/v2/spans", "svc")):
                tracer = mod.new_tracer("svc", processor=exp_mod.SimpleSpanProcessor(exporter))
                with tracer.start_span("parent", kind="server") as parent:
                    parent.set_attribute("http.route", "/x")
                    parent.add_event("hit", {"n": 1})
                    with tracer.start_span("child", kind="client") as child:
                        child.set_status("ERROR", "bad")
            payloads[side] = [(p, a, _strip(body)) for p, a, body in _Collector.received]
            assert len(payloads[side]) == 4
        assert payloads["port"] == payloads["ref"]
        otlp = _Collector.received[0][2]
        assert otlp["resourceSpans"][0]["scopeSpans"][0]["scope"]["name"] == "gofr_tpu_torch.tracing"
    finally:
        httpd.shutdown()


def test_exporter_selection_agrees():
    class Cfg(dict):
        def get(self, k, d=None):  # noqa: A003
            return dict.get(self, k, d)

        def get_or_default(self, k, d):
            return dict.get(self, k, d) or d

    configs = [
        Cfg(TRACE_EXPORTER="otlp", TRACER_HOST="c", TRACER_PORT="4318", TRACER_AUTH_KEY="k"),
        Cfg(TRACE_EXPORTER="jaeger", TRACER_URL="http://j/v1/traces"),
        Cfg(TRACE_EXPORTER="zipkin", TRACER_HOST="z"),
        Cfg(TRACE_EXPORTER="gofr"), Cfg(TRACE_EXPORTER="console"), Cfg(TRACE_EXPORTER="otlp"),
        Cfg(TRACE_EXPORTER="bogus"), Cfg(),
    ]
    for c in configs:
        a, b = export.build_exporter(c), jexport.build_exporter(c)
        assert type(a).__name__ == type(b).__name__
        assert getattr(a, "url", None) == getattr(b, "url", None)
        assert getattr(a, "auth_header", None) == getattr(b, "auth_header", None)
