"""The App: public API, wiring, lifecycle (the part of ``gofr_tpu/app.py``
that serving uses).

Reference parity: pkg/gofr/gofr.go:31-50 (App struct), factory.go:17-95
(New with the default health routes, port defaults HTTP=8000/metrics=2121
default.go:3-7), run.go:15-95 (Run: signal hook, on-start hooks, servers
started together), gofr.go:76-101 (Shutdown with SHUTDOWN_GRACE_PERIOD then
force-close), rest.go:9-31 (route verbs), gofr.go:343 (OnStart).

What the port holds: routes and ``use_middleware``, ``on_start`` /
``on_shutdown``, ``add_http_service``, ``add_datasource``, the HTTP and
metrics servers, ``run``/``run_async`` (signal handlers only on the main
thread), ``stop``, ``drain`` and ``shutdown``, the default
``/.well-known/{health,alive}`` routes, and the in-memory broker when
``PUBSUB_BACKEND=MEMORY``. Cron jobs, subscribers, gRPC, WebSocket,
migrations, CMD mode, auth, swagger and static files are not ported.

Port addition: ``HTTP_HOST`` (default ``0.0.0.0``) is the address both
servers bind, so a test or a smoke run can keep them on ``127.0.0.1``.
"""

from __future__ import annotations

import asyncio
import os
import signal
from typing import Any, Callable

from gofr_tpu_torch.config import Config, EnvConfig
from gofr_tpu_torch.container.container import Container
from gofr_tpu_torch.context import Context
from gofr_tpu_torch.handler import Handler, alive_handler, health_handler
from gofr_tpu_torch.http.dispatch import Dispatcher
from gofr_tpu_torch.http.middleware import (
    CORSConfig,
    chain,
    cors_middleware,
    logging_middleware,
    metrics_middleware,
    tracing_middleware,
)
from gofr_tpu_torch.http.request import Request
from gofr_tpu_torch.http.router import Router
from gofr_tpu_torch.http.server import HTTPServer
from gofr_tpu_torch.metrics.server import MetricsHandler

DEFAULT_HTTP_PORT = 8000
DEFAULT_METRICS_PORT = 2121
DEFAULT_SHUTDOWN_GRACE_SECONDS = 30.0


def build_pubsub(config: Config) -> Any:
    """PUBSUB_BACKEND switch (container/container.go:132-172): ``MEMORY`` is
    the port's in-memory broker; unset is None (apps wire their own through
    ``add_datasource``). The networked brokers are not ported."""
    backend = (config.get("PUBSUB_BACKEND") or "").strip().upper()
    if not backend:
        return None
    if backend == "MEMORY":
        from gofr_tpu_torch.pubsub import InMemoryBroker

        return InMemoryBroker.from_config(config)
    raise ValueError(f"PUBSUB_BACKEND {backend!r}: only MEMORY is ported")


class App:
    """gofr.New() analogue. Construct, register routes and services, then
    ``run()``."""

    def __init__(self, config: Config | None = None) -> None:
        if config is None:
            config = EnvConfig(os.environ.get("GOFR_CONFIGS_DIR", "./configs"))
        self.config = config
        self.container = Container(config)
        self.logger = self.container.logger
        self.router = Router()
        self._user_middlewares: list[Any] = []
        self._on_start_hooks: list[Callable] = []
        self._on_shutdown_hooks: list[Callable] = []
        self._shutdown_event: asyncio.Event | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._servers: list[Any] = []

        self.http_host = self.config.get_or_default("HTTP_HOST", "0.0.0.0")
        self.http_port = int(self.config.get_or_default("HTTP_PORT", str(DEFAULT_HTTP_PORT)))
        self.metrics_port = int(self.config.get_or_default("METRICS_PORT", str(DEFAULT_METRICS_PORT)))

        # a dark broker at boot is a DEGRADED health state, not a crash —
        # the reference logs and continues (container.go's connect errors)
        broker = build_pubsub(self.config)
        if broker is not None:
            try:
                self.container.register_datasource("pubsub", broker)
            except Exception as exc:
                self.logger.error(f"pubsub backend connect failed: {exc}")
                self.container.pubsub = broker  # health_check reports DOWN

        self.router.add("GET", "/.well-known/health", health_handler)
        self.router.add("GET", "/.well-known/alive", alive_handler)

    # ------------------------------------------------------------------ routes
    def get(self, pattern: str, handler: Handler) -> None:
        self.add_route("GET", pattern, handler)

    def post(self, pattern: str, handler: Handler) -> None:
        self.add_route("POST", pattern, handler)

    def put(self, pattern: str, handler: Handler) -> None:
        self.add_route("PUT", pattern, handler)

    def patch(self, pattern: str, handler: Handler) -> None:
        self.add_route("PATCH", pattern, handler)

    def delete(self, pattern: str, handler: Handler) -> None:
        self.add_route("DELETE", pattern, handler)

    def options(self, pattern: str, handler: Handler) -> None:
        self.add_route("OPTIONS", pattern, handler)

    def add_route(self, method: str, pattern: str, handler: Handler) -> None:
        self.router.add(method, pattern, handler)

    def use_middleware(self, *mws: Any) -> None:
        """App-level custom middleware (http/router.go:29)."""
        self._user_middlewares.extend(mws)

    # ------------------------------------------------------- services & stores
    def add_http_service(self, name: str, address: str, *options: Any) -> None:
        """RegisterService for outbound HTTP (container.Services,
        service/new.go:78-87)."""
        from gofr_tpu_torch.service import new_http_service

        self.container.services[name] = new_http_service(
            address,
            self.container.logger,
            self.container.metrics_manager,
            self.container.tracer,
            *options,
        )

    def add_datasource(self, name: str, ds: Any) -> None:
        """external_db.go Add* analogue for any provider-pattern
        datasource."""
        self.container.register_datasource(name, ds)

    # ---------------------------------------------------------------- lifecycle
    def on_start(self, hook: Callable) -> None:
        """gofr.go:343-349: ordered hooks run before servers; failure aborts
        startup."""
        self._on_start_hooks.append(hook)

    def on_shutdown(self, hook: Callable) -> None:
        self._on_shutdown_hooks.append(hook)

    # ---------------------------------------------------------------- running
    def _build_http_handler(self) -> Any:
        timeout_s = self.config.get("REQUEST_TIMEOUT")
        timeout = float(timeout_s) if timeout_s else None
        dispatcher = Dispatcher(self.router, self.container, timeout)
        middlewares = [
            tracing_middleware(self.container.tracer),
            logging_middleware(self.logger, config=self.config),
            cors_middleware(CORSConfig(self.config), self.router),
            metrics_middleware(self.container.metrics_manager, self.router),
        ]
        middlewares.extend(self._user_middlewares)
        return chain(dispatcher, middlewares)

    async def _start_servers(self) -> None:
        http_server = HTTPServer(
            self._build_http_handler(),
            self.http_port,
            host=self.http_host,
            logger=self.logger,
            cert_file=self.config.get("CERT_FILE"),
            key_file=self.config.get("KEY_FILE"),
        )
        metrics_server = HTTPServer(
            MetricsHandler(self.container), self.metrics_port, host=self.http_host,
            logger=self.logger,
        )
        self._servers = [metrics_server, http_server]
        await metrics_server.start()
        await http_server.start()

    async def _run_on_start_hooks(self) -> None:
        """run.go:39-53: ordered, abort on first error."""
        for hook in self._on_start_hooks:
            ctx = Context(Request("GET", "/", {}, {}, b""), self.container)
            result = hook(ctx)
            if asyncio.iscoroutine(result):
                await result

    async def run_async(self) -> None:
        """App.Run (run.go:15-36) on the current event loop."""
        self._shutdown_event = asyncio.Event()
        loop = asyncio.get_running_loop()
        self._loop = loop
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                loop.add_signal_handler(sig, self._shutdown_event.set)
            except (NotImplementedError, RuntimeError, ValueError):
                pass  # not on the main thread (tests) or unsupported platform
        try:
            await self._run_on_start_hooks()
        except Exception as exc:
            self.logger.error(f"error in OnStart hook, aborting startup: {exc}")
            self.container.close()
            return
        await self._start_servers()
        self.logger.info(
            f"{self.container.app_name} started: "
            f"http=:{self.http_port} metrics=:{self.metrics_port}"
        )
        await self._shutdown_event.wait()
        await self.shutdown()

    def run(self) -> None:
        try:
            asyncio.run(self.run_async())
        except KeyboardInterrupt:
            pass

    def stop(self) -> None:
        """Request shutdown from any thread."""
        ev = self._shutdown_event
        loop = self._loop
        if ev is None or loop is None:
            return
        try:
            loop.call_soon_threadsafe(ev.set)
        except RuntimeError:
            pass  # loop already closed

    def drain(self) -> None:
        """Coordinated graceful drain, from any thread: flip health to
        DRAINING and reject new work with a retriable 503 + Retry-After
        immediately, then run the normal shutdown sequence — whose hooks
        drain the serving engine within its drain deadline. The
        admin-trigger twin of SIGTERM."""
        self.container.draining = True
        self.stop()

    async def shutdown(self) -> None:
        """gofr.go:76-101 + shutdown.go:14-48: grace period then force.
        Order matters for request-lifecycle correctness: the draining flag
        flips FIRST (new work bounces with a retriable status while the
        event loop keeps pumping in-flight streams), shutdown hooks —
        including the engine drain, which blocks up to its drain deadline —
        run in the executor so those streams can actually finish, and only
        then do the servers close."""
        grace = float(self.config.get_or_default("SHUTDOWN_GRACE_PERIOD", str(DEFAULT_SHUTDOWN_GRACE_SECONDS)))
        self.container.draining = True
        self.logger.info("shutting down gracefully (draining)...")
        loop = asyncio.get_running_loop()
        for hook in self._on_shutdown_hooks:
            try:
                if asyncio.iscoroutinefunction(hook):
                    await hook()
                else:
                    result = await loop.run_in_executor(None, hook)
                    if asyncio.iscoroutine(result):
                        await result
            except Exception as exc:
                self.logger.error(f"error in shutdown hook: {exc}")
        try:
            await asyncio.wait_for(self._shutdown_servers(), timeout=grace)
        except asyncio.TimeoutError:
            self.logger.error("graceful shutdown timed out; forcing close")
        self.container.close()
        self.logger.info("shutdown complete")

    async def _shutdown_servers(self) -> None:
        for server in self._servers:
            await server.shutdown()
