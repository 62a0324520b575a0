"""The port's service client against the JAX package's
(``gofr_tpu/service``): ``HTTPService`` against a tiny local server (verbs,
statuses, headers, the traceparent it sends, the histogram it records, a
streamed body), the ``CircuitBreaker`` and ``Retry`` options driven by
seeded sequences of outcomes (the same state transitions, results and inner
calls on both sides), the header options, and ``retry_after_from_headers``
over a table."""

import http.server
import json
import random
import threading
import time

import pytest

from gofr_tpu import service as r_service
from gofr_tpu.metrics import new_metrics_manager as r_manager
from gofr_tpu.service import options as r_options
from gofr_tpu.tracing import Tracer as RTracer
from gofr_tpu_torch import service as t_service
from gofr_tpu_torch.metrics import new_metrics_manager as t_manager
from gofr_tpu_torch.service import options as t_options
from gofr_tpu_torch.testutil import get_free_port
from gofr_tpu_torch.tracing import Tracer as TTracer

SIDES = {"ref": (r_service, r_options, r_manager, RTracer),
         "port": (t_service, t_options, t_manager, TTracer)}


class _Handler(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *args):
        pass

    def _send(self, code, body=b"{}", headers=None):
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _route(self, method):
        length = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(length) if length else b""
        if self.path.startswith("/status/"):
            code = int(self.path.split("/")[2].split("?")[0])
            self._send(code, json.dumps({"code": code}).encode(), {"Retry-After": "3"})
        elif self.path == "/sse":
            lines = b"id: 0\ndata: {\"id\": 7}\n\ndata: [DONE]\n\n"
            self._send(200, lines, {"Content-Type": "text/event-stream"})
        else:
            echo = {"method": method, "path": self.path, "body": body.decode(),
                    "traceparent": self.headers.get("traceparent", ""),
                    "auth": self.headers.get("Authorization", ""),
                    "key": self.headers.get("X-API-Key", ""),
                    "custom": self.headers.get("X-Custom", ""),
                    "ctype": self.headers.get("Content-Type", "")}
            self._send(200, json.dumps(echo).encode())

    def do_GET(self):
        self._route("GET")

    def do_POST(self):
        self._route("POST")

    def do_PUT(self):
        self._route("PUT")

    def do_PATCH(self):
        self._route("PATCH")

    def do_DELETE(self):
        self._route("DELETE")


@pytest.fixture(scope="module")
def server():
    port = get_free_port()
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", port), _Handler)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{port}"
    srv.shutdown()
    srv.server_close()


def _norm(resp, tracer_span=None):
    body = resp.json()
    if isinstance(body, dict) and body.get("traceparent"):
        parts = body["traceparent"].split("-")
        assert len(parts) == 4 and parts[0] == "00" and len(parts[1]) == 32
        if tracer_span is not None:
            assert parts[1] == tracer_span.trace_id
        body["traceparent"] = "present"
    return resp.status_code, resp.ok, body, resp.headers.get("Retry-After")


VERBS = [("get", "/a", {"params": {"q": ["1", "2"]}}), ("post", "/b", {"json": {"x": 1}}),
         ("post", "/raw", {"body": b"bytes"}), ("put", "/c", {"json": [1]}),
         ("patch", "/d", {"body": b"p"}), ("delete", "/e", {}),
         ("get", "/status/404", {}), ("get", "/status/503", {}), ("post", "/status/429", {})]


@pytest.mark.parametrize("verb,path,kw", VERBS)
def test_http_service_verbs(server, verb, path, kw):
    got = {}
    for name, (svc_mod, _, manager, tracer_cls) in SIDES.items():
        metrics = manager()
        metrics.new_histogram("app_http_service_response", "d")
        tracer = tracer_cls("svc")
        svc = svc_mod.HTTPService(server, None, metrics, tracer)
        resp = getattr(svc, verb)(path, **kw)
        hist = metrics.get("app_http_service_response")
        labels = {"path": server, "method": verb.upper(), "status": str(resp.status_code)}
        assert hist.snapshot(labels)[1] == 1
        assert tracer.open_spans() == 0
        got[name] = _norm(resp)
    assert got["port"] == got["ref"]


def test_traceparent_follows_the_current_span(server):
    for _, (svc_mod, _, _, tracer_cls) in SIDES.items():
        tracer = tracer_cls("caller")
        with tracer.start_span("outer") as span:
            resp = svc_mod.HTTPService(server).get("/t")
        _norm(resp, span)
        assert resp.json()["traceparent"].split("-")[1] == span.trace_id


def test_stream_and_health(server):
    got = {}
    for name, (svc_mod, _, _, _) in SIDES.items():
        svc = svc_mod.HTTPService(server)
        s = svc.stream("POST", "/sse", json={"a": 1})
        lines = list(s.lines())
        s.close()
        bad = svc.stream("GET", "/status/503")
        detail = bad.read_body()
        bad.close()
        health = svc.health_check()
        down = svc_mod.HTTPService("http://127.0.0.1:1").health_check()
        down["details"].pop("error", None)
        got[name] = (s.status_code, lines, bad.status_code, detail, health, down)
    assert got["port"] == got["ref"]


@pytest.mark.parametrize("option", ["basic", "apikey", "headers", "stack"])
def test_header_options(server, option):
    got = {}
    for name, (svc_mod, opts, _, _) in SIDES.items():
        chosen = {
            "basic": [opts.BasicAuthConfig("u", "p")],
            "apikey": [opts.APIKeyConfig("k1")],
            "headers": [opts.DefaultHeaders({"X-Custom": "c"})],
            "stack": [opts.DefaultHeaders({"X-Custom": "c"}), opts.APIKeyConfig("k2"),
                      opts.HealthConfig("/status/200", timeout=1.0)],
        }[option]
        svc = svc_mod.new_http_service(server, None, None, None, *chosen)
        got[name] = (_norm(svc.get("/h", headers={"X-Custom": "override"} if option == "stack"
                                   else None)), svc.health_check())
    assert got["port"] == got["ref"]


# ------------------------------------------------------- breaker and retry, scripted
class Scripted:
    """An inner client that answers from a script: a status code, or an
    exception class name to raise; health checks answer from their own
    script. Records every call."""

    def __init__(self, opts, outcomes, health):
        self.opts = opts
        self.outcomes = list(outcomes)
        self.health = list(health)
        self.calls = []
        self.address = "http://scripted"
        self.gate = None  # a threading.Event the health check waits on, when set up

    def request(self, method, path, **kw):
        self.calls.append((method, path))
        out = self.outcomes.pop(0) if self.outcomes else 200
        if out == "ConnectionError":
            raise ConnectionError("reset")
        if out == "CircuitBreakerError":
            raise self.opts.CircuitBreakerError(self.address)
        headers = {"Retry-After": "0.001"} if out in (429, 503) else {}
        return self.opts.ServiceResponse(out, headers, b"")

    stream = request

    def health_check(self):
        if self.gate is not None:  # the breaker's probe waits for the test's go
            self.gate.wait(timeout=5)
        self.calls.append(("HEALTH", ""))
        up = self.health.pop(0) if self.health else True
        return {"status": "UP" if up else "DOWN"}


def _script(seed, n):
    rng = random.Random(seed)
    pool = [200, 200, 404, 500, 503, 429, "ConnectionError"]
    return [rng.choice(pool) for _ in range(n)]


def _await_probe(cb, inner) -> None:
    """Open the gate of the breaker's probe, wait for it to close the
    breaker, and let it finish publishing; then shut the gate again."""
    inner.gate.set()
    deadline = time.monotonic() + 5
    while cb.is_open and time.monotonic() < deadline:
        time.sleep(0.005)
    assert not cb.is_open
    # the closing probe publishes after it clears the state: let it finish
    # before the next request, or the next failures race it (Queue C 58,
    # still in the reference)
    cb._probe_thread.join(timeout=5)
    assert not cb._probe_thread.is_alive()
    inner.gate.clear()


@pytest.mark.parametrize("seed", range(6))
def test_circuit_breaker_transitions(seed):
    """The probe's health checks wait for a gate the test opens once a
    request has met the open breaker (and at the end, when the breaker is
    still open): the probe cannot close the breaker before the opening
    request has published, nor before the next request, whatever the
    host's load. Without the gate, a thread late by one 10 ms interval
    changed the sequence on one side only (Queue C 62):
    ``test_breaker_probe_overtaking_the_opening_publish`` forces each of
    those interleavings on both packages."""
    got = {}
    for name, (_, opts, manager, _) in SIDES.items():
        inner = Scripted(opts, _script(seed, 40), [False, False, True])
        inner.gate = threading.Event()
        metrics = manager()
        metrics.new_gauge("app_service_breaker_state", "d")
        inner.metrics = metrics
        cb = opts.CircuitBreakerConfig(threshold=3, interval=0.01).add_option(inner)
        transitions = []
        cb.on_state_change = transitions.append
        record = []
        for i in range(40):
            try:
                resp = cb.request("GET", f"/r{i}")
                record.append(resp.status_code)
            except Exception as exc:
                record.append(type(exc).__name__)
                if isinstance(exc, opts.CircuitBreakerError):
                    _await_probe(cb, inner)
        if cb.is_open:
            _await_probe(cb, inner)
        gauge = metrics.get("app_service_breaker_state").value({"address": "http://scripted"})
        got[name] = (record, transitions, list(inner.calls), gauge)
    assert got["port"] == got["ref"]
    assert True in got["port"][1] or "CircuitBreakerError" not in got["port"][0]


class _SlowOpenGauge:
    """Metrics whose write of the open state (1.0) first waits until the
    breaker has closed again: the opening request's thread is late to
    publish, and the probe closes the breaker meanwhile."""

    def __init__(self, metrics, cb_of) -> None:
        self.metrics, self.cb_of = metrics, cb_of

    def set_gauge(self, name, value, **labels):
        if value == 1.0:
            deadline = time.monotonic() + 5
            while self.cb_of().is_open and time.monotonic() < deadline:
                time.sleep(0.002)
        self.metrics.set_gauge(name, value, **labels)

    def __getattr__(self, name):
        return getattr(self.metrics, name)


@pytest.mark.parametrize("late", ["publish", "next_request"])
def test_breaker_probe_overtaking_the_opening_publish(late):
    """Queue C 62's two interleavings, forced on both packages with the
    probe's 10 ms interval. ``publish``: the opening request's thread is
    late between opening the breaker and publishing it, and the probe closes
    it meanwhile. The port publishes in the state's order (open, then
    closed; the gauge ends 0); the reference publishes the close first and
    leaves the gauge at 1 on a closed breaker, the fault Queue C 58 settled
    in the port. ``next_request``: the thread is late to its next request,
    and the probe closes the breaker first: the next request reaches the
    inner client on both packages alike; only a lateness on one side and
    not the other made the seeded test's two sides differ."""
    got = {}
    for name, (_, opts, manager, _) in SIDES.items():
        inner = Scripted(opts, [503, 503, 503, 200], [])
        metrics = manager()
        metrics.new_gauge("app_service_breaker_state", "d")
        cb = None
        inner.metrics = _SlowOpenGauge(metrics, lambda: cb) if late == "publish" else metrics
        cb = opts.CircuitBreakerConfig(threshold=3, interval=0.01).add_option(inner)
        transitions = []
        cb.on_state_change = transitions.append
        record = []
        for i in range(4):
            if late == "next_request" and i == 3:
                deadline = time.monotonic() + 5
                while cb.is_open and time.monotonic() < deadline:
                    time.sleep(0.002)
                cb._probe_thread.join(timeout=5)
            try:
                record.append(cb.request("GET", f"/r{i}").status_code)
            except Exception as exc:
                record.append(type(exc).__name__)
        cb._probe_thread.join(timeout=5)
        gauge = metrics.get("app_service_breaker_state").value({"address": "http://scripted"})
        got[name] = (record, transitions, [c for c in inner.calls if c[0] != "HEALTH"], gauge,
                     cb.is_open)
    if late == "publish":
        assert got["port"] == ([503, 503, 503, 200], [True, False],
                               [("GET", f"/r{i}") for i in range(4)], 0.0, False)
        assert got["ref"][1] == [False, True] and got["ref"][3] == 1.0 and not got["ref"][4]
    else:
        assert got["port"] == got["ref"] == (
            [503, 503, 503, 200], [True, False], [("GET", f"/r{i}") for i in range(4)], 0.0,
            False)


def test_breaker_reopened_while_its_probe_closes_recovers():
    """Queue C 58: three failing requests made from the first
    ``on_state_change(False)`` reopen the breaker while its probe closes it.
    The reference's closing probe then sets the shared stop event and ends
    the new probe: it stays open with no probe alive. The port's closes again,
    publishing every transition in order."""
    got = {}
    for name, (_, opts, manager, _) in SIDES.items():
        inner = Scripted(opts, [503] * 6, [])
        metrics = manager()
        metrics.new_gauge("app_service_breaker_state", "d")
        inner.metrics = metrics
        cb = opts.CircuitBreakerConfig(threshold=3, interval=0.01).add_option(inner)
        transitions = []

        def hook(open_, cb=cb, transitions=transitions):
            transitions.append(open_)
            if open_ is False and transitions.count(False) == 1:
                for i in range(3):
                    cb.request("GET", f"/again{i}")

        cb.on_state_change = hook
        for i in range(3):
            cb.request("GET", f"/r{i}")
        time.sleep(1.0)
        probe = cb._probe_thread
        gauge = metrics.get("app_service_breaker_state").value({"address": "http://scripted"})
        got[name] = (cb.is_open, probe.is_alive(), transitions, gauge)
    ref_open, ref_probing, _, _ = got["ref"]
    assert ref_open and not ref_probing
    port_open, port_probing, transitions, gauge = got["port"]
    assert not port_open and not port_probing
    assert transitions == [True, False, True, False]
    assert gauge == (1.0 if port_open else 0.0)


def test_breaker_transitions_alternate_under_contention():
    """More threads than cores open and close the port's breaker over and
    over (threshold 1, a probe every millisecond, the switch interval
    shortened): the transitions it publishes alternate open, closed, open,
    ..., and once the last probe has ended the gauge equals ``is_open``."""
    import sys

    inner = Scripted(t_options, [503] * 100000, [])
    metrics = t_manager()
    metrics.new_gauge("app_service_breaker_state", "d")
    inner.metrics = metrics
    cb = t_options.CircuitBreakerConfig(threshold=1, interval=0.001).add_option(inner)
    transitions = []
    cb.on_state_change = transitions.append
    deadline = time.monotonic() + 3.0

    def worker():
        while time.monotonic() < deadline:
            try:
                cb.request("GET", "/x")
            except t_options.CircuitBreakerError:
                pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    t_end = time.monotonic() + 10
    while cb.is_open and time.monotonic() < t_end:
        time.sleep(0.005)
    cb._probe_thread.join(timeout=10)
    assert not cb.is_open and not cb._probe_thread.is_alive()
    assert len(transitions) >= 4
    assert transitions == [k % 2 == 0 for k in range(len(transitions))]
    assert metrics.get("app_service_breaker_state").value({"address": "http://scripted"}) == 0.0


def test_breaker_close_stops_a_live_probe():
    inner = Scripted(t_options, [503] * 3, [False] * 1000)
    cb = t_options.CircuitBreakerConfig(threshold=3, interval=0.01).add_option(inner)
    for i in range(3):
        cb.request("GET", f"/r{i}")
    assert cb.is_open and cb._probe_thread.is_alive()
    cb.close()
    cb._probe_thread.join(timeout=5)
    assert not cb._probe_thread.is_alive() and cb.is_open


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("jitter", [False, True])
def test_retry_ladder(seed, jitter):
    got = {}
    for name, (_, opts, _, _) in SIDES.items():
        script = _script(seed, 30)
        if seed % 4 == 3:
            script[2] = "CircuitBreakerError"  # a breaker opening mid-ladder stops it
        inner = Scripted(opts, script, [])
        retry = opts.RetryConfig(max_retries=3, backoff=0.0005, multiplier=2.0,
                                 max_backoff=0.002, jitter=jitter).add_option(inner)
        retry._rng.seed(seed)
        record = []
        for i in range(8):
            try:
                record.append(retry.request("POST", f"/q{i}").status_code)
            except Exception as exc:
                record.append(type(exc).__name__)
        delays = [retry._delay(a, ra) for a in (1, 2, 3) for ra in (None, 0.001, 10.0)]
        got[name] = (record, inner.calls, delays)
    assert got["port"] == got["ref"]


def test_retry_respects_max_elapsed():
    got = {}
    for name, (_, opts, _, _) in SIDES.items():
        inner = Scripted(opts, [503] * 10, [])
        retry = opts.RetryConfig(max_retries=5, backoff=0.05, jitter=False,
                                 max_elapsed=0.12).add_option(inner)
        got[name] = (retry.request("GET", "/x").status_code, len(inner.calls))
    assert got["port"] == got["ref"] == (503, 2)


@pytest.mark.parametrize("headers", [
    {}, {"Retry-After": "2"}, {"retry-after": "0.25"}, {"RETRY-AFTER": "-1"},
    {"Retry-After": "Wed, 21 Oct 2015 07:28:00 GMT"}, {"Retry-After": ""},
    {"X-Other": "1", "Retry-After": "1e3"}, {"Retry-After": "nan"},
])
def test_retry_after_from_headers(headers):
    ref = r_options.retry_after_from_headers(headers)
    port = t_options.retry_after_from_headers(headers)
    assert (ref != ref and port != port) or port == ref
