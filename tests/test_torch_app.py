"""The port's ``App`` beside the JAX package's (``gofr_tpu.App``), each booted
on free ports on a thread and asked the same things over real sockets:
routes, path params, body binding, typed errors, custom middleware, CORS,
HEAD and 405, the default health and alive routes, the metrics port
(``/metrics`` with the ``app_http_*`` series, the debug routes, the
profiler's 405 and 409), the draining 503, and ``on_start``/``on_shutdown``
order. Responses must agree in status, body and headers apart from the
per-request trace id."""

import json

import pytest

import gofr_tpu
from gofr_tpu.config import MapConfig as RMapConfig
from gofr_tpu.http import errors as r_errors
from gofr_tpu_torch.app import App as TApp
from gofr_tpu_torch.config import MapConfig as TMapConfig
from gofr_tpu_torch.http import errors as t_errors
from gofr_tpu_torch.metrics import lint_exposition
from gofr_tpu_torch.testutil import fetch, get_free_port, start_app, stop_app

SIDES = {"ref": (gofr_tpu.App, RMapConfig, r_errors), "port": (TApp, TMapConfig, t_errors)}


def _config(cls, **extra):
    values = {"HTTP_PORT": str(get_free_port()), "METRICS_PORT": str(get_free_port()),
              "APP_NAME": "pair-app", "LOG_LEVEL": "FATAL", "SHUTDOWN_GRACE_PERIOD": "5",
              "HTTP_HOST": "127.0.0.1"}
    values.update(extra)
    return cls(values, use_env=False)


def _register(app, errors, order):
    def tag_middleware(inner):
        async def handle(req):
            resp = await inner(req)
            resp.headers["X-Tagged"] = req.path
            return resp
        return handle

    app.use_middleware(tag_middleware)
    app.get("/hello", lambda ctx: {"message": "hi"})
    app.get("/user/{id}", lambda ctx: {"id": ctx.path_param("id"), "q": ctx.param("q")})
    app.post("/items", lambda ctx: ctx.bind(dict))
    app.put("/items/{id}", lambda ctx: {"put": ctx.path_param("id")})
    app.delete("/items/{id}", lambda ctx: None)
    app.patch("/items/{id}", lambda ctx: {"patched": True})

    def missing(ctx):
        raise errors.ErrorEntityNotFound("user", ctx.path_param("id"))

    def shed(ctx):
        raise errors.ErrorTooManyRequests(retry_after=1.5)

    def bug(ctx):
        raise KeyError("panic")

    async def header_echo(ctx):
        return {"tenant": ctx.header("x-tenant-id"), "corr": bool(ctx.get_correlation_id())}

    app.get("/missing/{id}", missing)
    app.post("/shed", shed)
    app.get("/bug", bug)
    app.get("/headers", header_echo)
    app.on_start(lambda ctx: order.append("start-1"))

    async def start_two(ctx):
        order.append("start-2")

    app.on_start(start_two)
    app.on_shutdown(lambda: order.append("shutdown-1"))

    async def shutdown_two():
        order.append("shutdown-2")

    app.on_shutdown(shutdown_two)


@pytest.fixture(scope="module")
def apps():
    out = {}
    for name, (app_cls, cfg_cls, errors) in SIDES.items():
        order: list = []
        app = app_cls(_config(cfg_cls))
        _register(app, errors, order)
        thread = start_app(app)
        out[name] = (app, thread, order)
    yield out
    for app, thread, _ in out.values():
        if thread.is_alive():
            stop_app(app, thread)


HOP = {"Date", "X-Correlation-ID", "Content-Length"}


def _ask(app, path, method="GET", body=None, headers=None, metrics=False):
    port = app.metrics_port if metrics else app.http_port
    status, hdrs, data = fetch(f"http://127.0.0.1:{port}{path}", method, body, headers)
    return status, {k: v for k, v in hdrs.items() if k not in HOP}, data


REQUESTS = [
    ("/hello", "GET", None, None),
    ("/user/42?q=x", "GET", None, None),
    ("/items", "POST", b'{"a": 1}', {"Content-Type": "application/json"}),
    ("/items", "POST", b"{bad", {"Content-Type": "application/json"}),
    ("/items", "POST", b"a=1&b=2", {"Content-Type": "application/x-www-form-urlencoded"}),
    ("/items/3", "PUT", b"", None),
    ("/items/3", "PATCH", b"", None),
    ("/items/3", "DELETE", None, None),
    ("/missing/9", "GET", None, None),
    ("/shed", "POST", b"", None),
    ("/bug", "GET", None, None),
    ("/headers", "GET", None, {"X-Tenant-Id": "gold"}),
    ("/hello", "POST", b"", None),
    ("/nowhere", "GET", None, None),
    ("/hello", "HEAD", None, None),
    ("/hello", "OPTIONS", None, {"Origin": "http://x"}),
    ("/.well-known/alive", "GET", None, None),
]


@pytest.mark.parametrize("path,method,body,headers", REQUESTS)
def test_same_answers(apps, path, method, body, headers):
    got = {name: _ask(app, path, method, body, headers) for name, (app, _, _) in apps.items()}
    assert got["port"] == got["ref"]
    status, hdrs, _ = got["port"]
    # CORS answers a preflight before the user middleware runs
    assert hdrs.get("X-Tagged") == (None if method == "OPTIONS" else path.split("?")[0])
    assert hdrs["Access-Control-Allow-Origin"] == "*"
    if path == "/shed":
        assert status == 429 and hdrs["Retry-After"] == "2"


def test_correlation_header_is_the_traceparent_trace(apps):
    trace = "4bf92f3577b34da6a3ce929d0e0e4736"
    for app, _, _ in apps.values():
        _, hdrs, _ = fetch(f"http://127.0.0.1:{app.http_port}/hello",
                           headers={"traceparent": f"00-{trace}-00f067aa0ba902b7-01"})
        assert hdrs["X-Correlation-ID"] == trace


def test_health_and_metrics_port(apps):
    got = {}
    for name, (app, _, _) in apps.items():
        _, _, health = _ask(app, "/.well-known/health")
        _, _, mhealth = _ask(app, "/.well-known/health", metrics=True)
        alive = _ask(app, "/.well-known/alive", metrics=True)
        status, hdrs, text = _ask(app, "/metrics", metrics=True)
        text = text.decode()
        families = sorted({line.split()[2] for line in text.splitlines()
                           if line.startswith("# TYPE")})
        series = [line for line in text.splitlines()
                  if line.startswith("app_http_response_count") and 'path="/hello"' in line]
        vars_ = json.loads(_ask(app, "/debug/vars", metrics=True)[2])
        vars_.pop("threads")
        threads = _ask(app, "/debug/threads", metrics=True)
        gc_ = json.loads(_ask(app, "/debug/gc", metrics=True)[2])
        prof_get = _ask(app, "/debug/profiler/start", metrics=True)
        stop_idle = _ask(app, "/debug/profiler/stop", "POST", b"", metrics=True)
        nothing = _ask(app, "/nothing", metrics=True)
        got[name] = (json.loads(health), json.loads(mhealth), alive, status, hdrs, families,
                     vars_, threads[0], sorted(gc_), prof_get, stop_idle, nothing, bool(series))
        if name == "port":
            assert lint_exposition(text) == []
    assert got["port"] == got["ref"]
    assert got["port"][0]["data"]["status"] == "UP" and got["port"][-1]


def test_port_profiler_writes_a_chrome_trace(apps, tmp_path):
    """``/debug/profiler/start`` then ``stop`` writes a ``torch.profiler``
    Chrome trace into ``dir``; a second start while one runs is a 409."""
    app = apps["port"][0]
    d = tmp_path / "prof"
    start = _ask(app, f"/debug/profiler/start?dir={d}", "POST", b"", metrics=True)
    assert start[0] == 200 and json.loads(start[2]) == {"profiling": True, "dir": str(d)}
    assert _ask(app, f"/debug/profiler/start?dir={d}", "POST", b"", metrics=True)[0] == 409
    _ask(app, "/hello")
    status, _, body = _ask(app, "/debug/profiler/stop", "POST", b"", metrics=True)
    out = json.loads(body)
    assert status == 200 and out["profiling"] is False
    trace = json.loads(open(out["trace"]).read())
    assert trace["traceEvents"]


def test_drain_then_shutdown_order(apps):
    """After ``drain()`` new work gets the retriable 503 while the probes
    still answer (DRAINING); the hooks run in registration order."""
    got = {}
    for name, (app, thread, order) in apps.items():
        assert order == ["start-1", "start-2"]
        app.container.draining = True  # the flag drain() flips first
        busy = _ask(app, "/hello")
        health = json.loads(_ask(app, "/.well-known/health")[2])
        app.drain()
        thread.join(timeout=30)
        assert not thread.is_alive()
        got[name] = (busy, health["data"]["status"], list(order))
    assert got["port"] == got["ref"]
    busy, status, order = got["port"]
    assert busy[0] == 503 and busy[1]["Retry-After"] == "1"
    assert status == "DRAINING"
    assert order == ["start-1", "start-2", "shutdown-1", "shutdown-2"]


@pytest.mark.parametrize("failing", [False, True])
def test_on_start_failure_aborts(failing):
    """A failing on-start hook aborts startup on both sides: ``run``
    returns without serving."""
    import threading

    for app_cls, cfg_cls, _ in SIDES.values():
        app = app_cls(_config(cfg_cls))
        seen = []

        def hook(ctx):
            seen.append(ctx.container is app.container)
            if failing:
                raise RuntimeError("no")

        app.on_start(hook)
        if failing:
            thread = threading.Thread(target=app.run, daemon=True)
            thread.start()
            thread.join(timeout=10)
            assert not thread.is_alive()
        else:
            stop_app(app, start_app(app))
        assert seen == [True]


def test_memory_pubsub_backend():
    for app_cls, cfg_cls, _ in SIDES.values():
        app = app_cls(_config(cfg_cls, PUBSUB_BACKEND="memory"))
        assert type(app.container.pubsub).__name__ == "InMemoryBroker"
        assert app.container.get_publisher() is app.container.pubsub
        app.container.close()
    # the networked brokers are ported: KAFKA builds the port's own client,
    # and a dark broker at boot is DOWN health, not a crash; an unknown
    # backend raises the reference's error
    for app_cls, cfg_cls, _ in SIDES.values():
        app = app_cls(_config(cfg_cls, PUBSUB_BACKEND="kafka", PUBSUB_BROKER="127.0.0.1:1"))
        assert type(app.container.pubsub).__module__ == (
            "gofr_tpu_torch.pubsub.kafka" if app_cls is TApp else "gofr_tpu.datasource.pubsub.kafka")
        assert app.container.health()["details"]["pubsub"]["status"] == "DOWN"
        app.container.close()
    with pytest.raises(ValueError, match="unknown PUBSUB_BACKEND 'BOGUS'"):
        TApp(_config(TMapConfig, PUBSUB_BACKEND="bogus"))


def test_router_routes_and_health():
    """``register_router_routes`` serves ``/routerz``, joins the router to
    the aggregated health and starts and stops it with the app."""
    from gofr_tpu.serving import handlers as r_handlers
    from gofr_tpu.serving import router as r_router
    from gofr_tpu_torch.serving import handlers as t_handlers
    from gofr_tpu_torch.serving import router as t_router

    got = {}
    for name, (app_cls, cfg_cls, _) in SIDES.items():
        handlers, router_mod = (r_handlers, r_router) if name == "ref" else (t_handlers, t_router)
        app = app_cls(_config(cfg_cls))
        router = router_mod.Router(router_mod.RouterConfig(heartbeat_s=0.05))
        handlers.register_router_routes(app, router)
        thread = start_app(app)
        try:
            status, _, body = _ask(app, "/routerz")
            health = _ask(app, "/.well-known/health")
        finally:
            stop_app(app, thread)
        got[name] = (status, sorted(json.loads(body)["data"]),
                     sorted(json.loads(health[2])["data"]["details"]))
    assert got["port"] == got["ref"]
    assert "router" in got["port"][2]


def test_add_http_service_and_datasource_health():
    class Probe:
        def __init__(self):
            self.wired = []

        def use_logger(self, logger):
            self.wired.append("logger")

        def use_metrics(self, metrics):
            self.wired.append("metrics")

        def use_tracer(self, tracer):
            self.wired.append("tracer")

        def connect(self):
            self.wired.append("connect")

        def health_check(self):
            return {"status": "DOWN", "details": {"why": "probe"}}

    got = {}
    for name, (app_cls, cfg_cls, _) in SIDES.items():
        app = app_cls(_config(cfg_cls))
        probe = Probe()
        app.add_datasource("probe", probe)
        app.add_http_service("peer", "http://127.0.0.1:1")
        health = app.container.health()
        health["details"]["services"]["peer"]["details"].pop("error")
        got[name] = (probe.wired, health)
        app.container.close()
    assert got["port"] == got["ref"]
    assert got["port"][1]["status"] == "DEGRADED"


def test_mock_container_redis_and_the_context_datasource_accessors():
    """``new_mock_container()`` fills ``redis`` with each package's
    ``InMemoryRedis`` and ``kv_store`` with its ``InMemoryKVStore``;
    ``ctx.redis``, ``ctx.file``, ``ctx.kv_store`` and
    ``ctx.cache`` read the container's slots, as the reference's do; a
    handler that uses them answers the same on both apps."""
    from gofr_tpu.context import Context as RContext
    from gofr_tpu.datasource.file import LocalFileSystem as RLocalFileSystem
    from gofr_tpu.datasource.redis import InMemoryRedis as RInMemoryRedis
    from gofr_tpu.testutil import new_mock_container as r_new_mock_container
    from gofr_tpu_torch.context import Context as TContext
    from gofr_tpu_torch.datasource.file import LocalFileSystem
    from gofr_tpu_torch.datasource.redis import InMemoryRedis
    from gofr_tpu_torch.testutil import new_mock_container

    kinds = {}
    for name, new, ctx_cls, redis_cls in (
            ("ref", r_new_mock_container, RContext, RInMemoryRedis),
            ("port", new_mock_container, TContext, InMemoryRedis)):
        container, mocks = new()
        assert type(mocks.redis) is redis_cls and container.redis is mocks.redis
        container.cache = cache = object()
        ctx = ctx_cls(None, container)
        assert ctx.redis is container.redis and ctx.kv_store is container.kv_store
        assert ctx.file is container.file is None and ctx.cache is cache
        mocks.redis.set("k", "v", ttl_seconds=60)
        mocks.kv_store.set("job", "done")
        kinds[name] = (ctx.redis.get("k"), ctx.kv_store is mocks.kv_store,
                       type(ctx.kv_store).__name__, ctx.kv_store.get("job"),
                       sorted(container.health()["details"]))
        container.close()
    assert kinds["ref"][0] == kinds["port"][0] == "v"
    assert kinds["port"] == kinds["ref"]
    assert kinds["port"][1:4] == (True, "InMemoryKVStore", "done")
    assert "kv_store" in kinds["port"][4]

    got = {}
    for name, (app_cls, cfg_cls, _), redis_cls, fs_cls in (
            ("ref", SIDES["ref"], RInMemoryRedis, RLocalFileSystem),
            ("port", SIDES["port"], InMemoryRedis, LocalFileSystem)):
        app = app_cls(_config(cfg_cls))
        app.add_datasource("redis", redis_cls())
        app.add_datasource("file", fs_cls("."))

        def slots(ctx):
            ctx.redis.set("seen", "1")
            return {"redis": type(ctx.redis).__name__, "file": type(ctx.file).__name__,
                    "kv": ctx.kv_store is None, "cache": ctx.cache is None,
                    "seen": ctx.redis.get("seen")}

        app.get("/slots", slots)
        thread = start_app(app)
        try:
            status, _, body = _ask(app, "/slots")
            health = _ask(app, "/.well-known/health")
        finally:
            stop_app(app, thread)
        details = json.loads(health[2])["data"]["details"]
        got[name] = (status, json.loads(body)["data"], details["redis"]["status"],
                     details["file"]["status"])
    assert got["port"] == got["ref"] == (200, {"redis": "InMemoryRedis",
                                               "file": "LocalFileSystem", "kv": True,
                                               "cache": True, "seen": "1"}, "UP", "UP")
