"""The rest of the port's app surface beside the JAX package's: static files
and swagger (the ``./static`` autodetect, ``/.well-known/openapi.json`` and
``/.well-known/swagger``: the same status codes, bytes and content types),
the remote log-level and trace-ratio pollers against a local HTTP stub
(``REMOTE_LOG_URL``, ``REMOTE_TRACE_RATIO_URL``), the start and stop
telemetry ping (payload, the ``GOFR_TELEMETRY=false`` opt-out, the
``TELEMETRY_ENDPOINT`` POST), and CMD mode (routing by prefix, help, flags
as params): the same exit codes and output for the same argv.

One row differs on purpose (ROADMAP Queue C 31): the reference's static
lookup takes a sibling directory that shares the static directory's
prefix (``static2`` beside ``static``) for its own, so
``/static/..%2Fstatic2/x`` serves a file outside ``./static``; the port
answers it 404."""

import http.server
import io
import json
import threading
import time

import pytest

import gofr_tpu
from gofr_tpu import telemetry as rtel
from gofr_tpu.cli import CMDRequest as RCMDRequest
from gofr_tpu.cli import run_cmd as r_run_cmd
from gofr_tpu.config import MapConfig as RMapConfig
from gofr_tpu.container.container import Container as RContainer
from gofr_tpu.logging import Level as RLevel
from gofr_tpu.logging.remote import RemoteLevelService as RRemoteLevel
from gofr_tpu.logging.remote import RemoteTraceRatioService as RRemoteRatio
from gofr_tpu_torch import telemetry as ttel
from gofr_tpu_torch.app import App as TApp
from gofr_tpu_torch.app import new_cmd as t_new_cmd
from gofr_tpu_torch.cli import CMDRequest as TCMDRequest
from gofr_tpu_torch.cli import Output
from gofr_tpu_torch.cli import run_cmd as t_run_cmd
from gofr_tpu_torch.config import MapConfig as TMapConfig
from gofr_tpu_torch.container.container import Container as TContainer
from gofr_tpu_torch.http import swagger as tswagger
from gofr_tpu_torch.logging import Level as TLevel
from gofr_tpu_torch.logging.remote import RemoteLevelService as TRemoteLevel
from gofr_tpu_torch.logging.remote import RemoteTraceRatioService as TRemoteRatio
from gofr_tpu_torch.testutil import fetch, get_free_port, start_app, stop_app

SPEC = {"openapi": "3.0.0", "info": {"title": "surface", "version": "1"},
        "paths": {"/hello": {"get": {"responses": {"200": {"description": "hi"}}}}}}


def _values(side: str, **extra) -> dict:
    return {"HTTP_PORT": str(get_free_port()), "METRICS_PORT": str(get_free_port()),
            "HTTP_HOST": "127.0.0.1", "APP_NAME": f"surface-{side}", "LOG_LEVEL": "FATAL",
            "SHUTDOWN_GRACE_PERIOD": "5", **extra}


@pytest.fixture(scope="module")
def static_apps(tmp_path_factory):
    """Both apps built in a directory that holds ``./static`` (with an
    ``openapi.json``, a ``404.html``, a nested file) and a sibling
    ``./static2``: the autodetect registers the static route and swagger."""
    import os

    root = tmp_path_factory.mktemp("site")
    static = root / "static"
    (static / "sub").mkdir(parents=True)
    (static / "index.html").write_text("<h1>index</h1>")
    (static / "app.css").write_text("body { color: red }")
    (static / "sub" / "data.json").write_text('{"x": 1}')
    (static / "404.html").write_text("<h1>not here</h1>")
    (static / "openapi.json").write_text(json.dumps(SPEC))
    (root / "static2").mkdir()
    (root / "static2" / "secret.txt").write_text("outside the static directory")
    (root / "secret.txt").write_text("the parent directory")
    cwd = os.getcwd()
    os.chdir(root)  # for the fixture's life: both read the spec path at request time
    try:
        apps = {"ref": gofr_tpu.App(RMapConfig(_values("ref"), use_env=False)),
                "port": TApp(TMapConfig(_values("port"), use_env=False))}
        threads = {side: start_app(app) for side, app in apps.items()}
        yield apps
        for side, app in apps.items():
            stop_app(app, threads[side])
    finally:
        os.chdir(cwd)


PATHS = ["/static", "/static/", "/static/index.html", "/static/app.css",
         "/static/sub/data.json", "/static/missing.png", "/static/openapi.json",
         "/static/sub/openapi.json", "/static/..%2Fsecret.txt", "/static/../secret.txt",
         "/.well-known/openapi.json", "/.well-known/swagger", "/nothing"]


@pytest.mark.parametrize("path", PATHS)
def test_static_and_swagger_answer_like_the_reference(static_apps, path):
    got = {}
    for side, app in static_apps.items():
        status, headers, body = fetch(f"http://127.0.0.1:{app.http_port}{path}")
        got[side] = (status, headers.get("Content-Type"), body)
    assert got["port"] == got["ref"]


def test_static_and_swagger_contents(static_apps):
    base = f"http://127.0.0.1:{static_apps['port'].http_port}"
    assert fetch(base + "/static/index.html")[2] == b"<h1>index</h1>"
    status, headers, body = fetch(base + "/static/missing.png")
    assert (status, body) == (404, b"<h1>not here</h1>")
    assert fetch(base + "/static/openapi.json")[0] == 403
    assert json.loads(fetch(base + "/.well-known/openapi.json")[2]) == SPEC
    status, headers, body = fetch(base + "/.well-known/swagger")
    assert status == 200 and headers["Content-Type"].startswith("text/html")
    with open(gofr_tpu.__path__[0] + "/http/static/swagger_ui.html", "rb") as f:
        assert body == f.read() == tswagger.swagger_ui_html()


def test_sibling_directory_escape_queue_c_31(static_apps):
    """Queue C 31: a path that climbs out of ``./static`` into a sibling
    sharing its prefix is served by the reference and refused by the port."""
    path = "/static/..%2Fstatic2/secret.txt"
    ref = fetch(f"http://127.0.0.1:{static_apps['ref'].http_port}{path}")
    port = fetch(f"http://127.0.0.1:{static_apps['port'].http_port}{path}")
    assert (ref[0], ref[2]) == (200, b"outside the static directory")
    assert port[0] == 404 and b"outside" not in port[2]


def test_add_static_files_without_the_autodetect(tmp_path, monkeypatch):
    (tmp_path / "a.txt").write_text("A")
    monkeypatch.chdir(tmp_path)  # no ./static here
    app = TApp(TMapConfig(_values("port"), use_env=False))
    app.add_static_files("/files/", str(tmp_path))
    thread = start_app(app)
    try:
        base = f"http://127.0.0.1:{app.http_port}"
        assert fetch(base + "/files/a.txt")[:3:2] == (200, b"A")
        assert fetch(base + "/files/b.txt")[0] == 404
        assert fetch(base + "/.well-known/swagger")[0] == 404  # no spec, no swagger
    finally:
        stop_app(app, thread)


# ----------------------------------------------------------- remote pollers
class _Stub:
    """A local HTTP server answering every GET with the current ``body``
    and recording every POST's body."""

    def __init__(self, body: dict):
        self.body, self.posts = body, []
        stub = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                data = json.dumps(stub.body).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_POST(self):
                stub.posts.append(json.loads(self.rfile.read(int(self.headers["Content-Length"]))))
                self.send_response(204)
                self.end_headers()

            def log_message(self, *a):
                pass

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        threading.Thread(target=self.server.serve_forever, daemon=True).start()
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}/"

    def close(self):
        self.server.shutdown()


def test_remote_level_service_parsing(monkeypatch):
    """The reference's ``test_remote_level_service_parsing`` on both."""

    class FakeResp:
        def read(self):
            return json.dumps({"data": [{"serviceName": "app", "logLevel": "DEBUG"}]}).encode()

        def __enter__(self):
            return self

        def __exit__(self, *a):
            pass

    monkeypatch.setattr("urllib.request.urlopen", lambda url, timeout: FakeResp())
    assert TRemoteLevel("http://example.invalid/level").fetch_level() == TLevel.DEBUG
    assert RRemoteLevel("http://example.invalid/level").fetch_level() == RLevel.DEBUG


BODIES = [{"data": [{"serviceName": "app", "logLevel": "WARN"}]}, {"data": {"logLevel": "ERROR"}},
          {"data": [{"LOG_LEVEL": {"LOG_LEVEL": "DEBUG"}}]}, {"data": [{"sampleRatio": 0.25}]},
          {"data": {"traceRatio": "0.5"}}, {"data": [{"TRACER_RATIO": "x"}, {"sampleRatio": 2}]},
          {"data": "nonsense"}, {"nodata": 1}, [1, 2]]


@pytest.mark.parametrize("body", BODIES, ids=range(len(BODIES)))
def test_remote_services_read_payloads_like_the_reference(body):
    stub = _Stub(body)
    try:
        assert TRemoteRatio(stub.url).fetch_ratio() == RRemoteRatio(stub.url).fetch_ratio()
        if isinstance(body, dict):
            port, ref = TRemoteLevel(stub.url).fetch_level(), RRemoteLevel(stub.url).fetch_level()
            assert (port and port.name) == (ref and ref.name)
    finally:
        stub.close()


def test_remote_pollers_change_the_live_level_and_ratio():
    """A container with ``REMOTE_LOG_URL`` and ``REMOTE_TRACE_RATIO_URL``
    polls both every 0.05 s: the logger's level and the tracer's sample
    ratio follow the stub on both packages; ``close`` stops the pollers."""
    stub = _Stub({"data": [{"serviceName": "app", "logLevel": "DEBUG", "sampleRatio": 0.25}]})
    try:
        containers = {}
        for side, (cls, config) in {"ref": (RContainer, RMapConfig),
                                    "port": (TContainer, TMapConfig)}.items():
            containers[side] = cls(config({
                "APP_NAME": side, "LOG_LEVEL": "FATAL", "REMOTE_LOG_URL": stub.url,
                "REMOTE_LOG_FETCH_INTERVAL": "0.05", "REMOTE_TRACE_RATIO_URL": stub.url,
                "REMOTE_TRACE_RATIO_INTERVAL": "0.05"}, use_env=False))
        t_end = time.monotonic() + 10
        seen = {}
        while time.monotonic() < t_end:
            seen = {side: (c.logger.level.name, c.tracer.sample_ratio)
                    for side, c in containers.items()}
            if all(v == ("DEBUG", 0.25) for v in seen.values()):
                break
            time.sleep(0.02)
        assert seen == {"ref": ("DEBUG", 0.25), "port": ("DEBUG", 0.25)}
        stub.body = {"data": [{"logLevel": "ERROR", "sampleRatio": 1.5}]}
        t_end = time.monotonic() + 10
        port = containers["port"]
        while (port.logger.level.name, port.tracer.sample_ratio) != ("ERROR", 1.0):
            assert time.monotonic() < t_end
            time.sleep(0.02)
        threads = [port._remote_log_thread, port._remote_trace_thread]
        for c in containers.values():
            c.close()
        for t in threads:
            t.join(timeout=5)
            assert not t.is_alive()
    finally:
        stub.close()


# ----------------------------------------------------------------- telemetry
class _Log:
    def __init__(self):
        self.lines = []

    def debug(self, message):
        self.lines.append(message)


def _ping(module, config_cls, values: dict, event: str) -> list:
    log = _Log()
    before = set(threading.enumerate())
    module.send_ping(config_cls(values, use_env=False), event, log)
    for t in set(threading.enumerate()) - before:
        t.join(timeout=10)
    return log.lines


def test_telemetry_payload_and_opt_out_equal_the_reference():
    for event in ("start", "stop"):
        assert ttel.build_ping(None, event) == rtel.build_ping(None, event)
        assert _ping(ttel, TMapConfig, {}, event) == _ping(rtel, RMapConfig, {}, event)
        assert _ping(ttel, TMapConfig, {}, event)[0].startswith(f"telemetry {event}: {{")
        assert _ping(ttel, TMapConfig, {"GOFR_TELEMETRY": "FALSE"}, event) == []
    assert set(ttel.build_ping(None, "start")) == {"event", "framework_version", "python", "os",
                                                   "arch"}


def test_telemetry_endpoint_receives_the_same_post():
    stub = _Stub({})
    try:
        for module, config in ((rtel, RMapConfig), (ttel, TMapConfig)):
            assert _ping(module, config, {"TELEMETRY_ENDPOINT": stub.url}, "start") == []
        assert len(stub.posts) == 2 and stub.posts[0] == stub.posts[1]
        assert stub.posts[0]["event"] == "start"
    finally:
        stub.close()


def test_app_pings_at_start_and_stop():
    """``App.run`` pings at start and at stop, at DEBUG on its logger."""
    buf = io.StringIO()
    from gofr_tpu_torch.logging import Logger

    app = TApp(TMapConfig(_values("port", LOG_LEVEL="DEBUG"), use_env=False))
    app.logger = app.container.logger = Logger(TLevel.DEBUG, buf, buf, exit_on_fatal=False)
    stop_app(app, start_app(app))
    pings = [json.loads(line)["message"].split(":")[0] for line in buf.getvalue().splitlines()
             if json.loads(line)["message"].startswith("telemetry")]
    assert pings == ["telemetry start", "telemetry stop"]


# ------------------------------------------------------------------- CMD mode
def _cmd_app(side):
    def hello(ctx):
        return f"hello {ctx.param('name') or 'world'}"

    def fail(ctx):
        raise ValueError("nope")

    def echo(ctx):
        return {"flags": ctx.bind(dict), "list": ctx.params("ids"), "out": ctx.out is not None}

    values = {"APP_NAME": "tool", "LOG_LEVEL": "FATAL"}
    app = (gofr_tpu.new_cmd(RMapConfig(values, use_env=False)) if side == "ref"
           else t_new_cmd(TMapConfig(values, use_env=False)))
    app.sub_command("hello", hello, "greets")
    app.sub_command("help-me", hello, "greets too")
    app.sub_command("boom", fail, "fails")
    app.sub_command("echo", echo, "echoes its flags")
    return app


ARGVS = [["hello", "-name=ada"], ["h"], ["hel"], ["nope"], ["--help"], ["-h"], [], ["boom"],
         ["echo", "--dry", "--env=prod", "key=val", "-x=", "ids=1,2,3", "extra"], ["bo"]]


@pytest.mark.parametrize("argv", ARGVS, ids=[" ".join(a) or "empty" for a in ARGVS])
def test_cmd_routing_equals_the_reference(capsys, argv):
    """The reference's ``test_cmd_routing_and_flags`` argv set and more: the
    same exit code and stdout from both packages."""
    got = {}
    for side, run in (("ref", r_run_cmd), ("port", t_run_cmd)):
        code = run(_cmd_app(side), list(argv))
        got[side] = (code, capsys.readouterr().out)
    assert got["port"] == got["ref"]


def test_cmd_routing_and_flags(capsys):
    """The reference's ``test_cmd_routing_and_flags`` on the port."""
    app = _cmd_app("port")
    assert t_run_cmd(app, ["hello", "-name=ada"]) == 0
    assert "hello ada" in capsys.readouterr().out
    assert t_run_cmd(app, ["boom"]) == 1
    assert t_run_cmd(app, ["nope"]) == 1
    assert "Available commands" in capsys.readouterr().out
    assert t_run_cmd(app, ["--help"]) == 0
    assert "greets" in capsys.readouterr().out
    assert app.run() is not None and app.is_cmd  # CMD apps run the router, not servers


@pytest.mark.parametrize("argv", [["migrate", "-dry=true", "--env=prod", "key=val", "extra"],
                                  ["x", "--flag", "-y", "--empty=", "a=b=c"], []])
def test_cmd_request_parsing(argv):
    """The reference's ``test_cmd_request_parsing`` on both, field for field."""
    port, ref = TCMDRequest(argv), RCMDRequest(argv)
    assert (port.command, port.flags, port.positional) == (ref.command, ref.flags, ref.positional)
    if argv and argv[0] == "migrate":
        assert port.command == "migrate" and port.param("dry") == "true"
        assert port.param("env") == "prod" and port.param("key") == "val"
        assert port.positional == ["migrate", "extra"]


def test_terminal_output_off_a_tty():
    buf = io.StringIO()
    out = Output(buf)
    out.println("a", 1)
    out.printf("%s-%d\n", "b", 2)
    out.error("bad")
    out.clear_line()
    out.hide_cursor()
    assert buf.getvalue() == "a 1\nb-2\nerror: bad\n"
    assert out.colorize("x", "red") == "x" and out.get_size() == (0, 0)
