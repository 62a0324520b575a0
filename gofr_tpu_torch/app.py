"""The App: public API, wiring, lifecycle (a copy of ``gofr_tpu/app.py``).

Reference parity: pkg/gofr/gofr.go:31-50 (App struct), factory.go:17-95
(New/NewCMD with the default health routes, swagger/static autodetect, port
defaults HTTP=8000/metrics=2121 default.go:3-7), run.go:15-95 (Run: signal
hook, on-start hooks, servers started together), gofr.go:76-101 (Shutdown
with SHUTDOWN_GRACE_PERIOD then force-close), rest.go:9-31 (route verbs),
gofr.go:233 (Subscribe), gofr.go:271 (AddCronJob), gofr.go:343 (OnStart),
auth.go:16-104 (Enable*Auth).

What the port holds: routes, static files and ``use_middleware``; the
Basic, API-key, OAuth and provider auth middlewares, ahead of the user's
and on the WebSocket upgrade; ``websocket`` and ``add_ws_service``;
``subscribe`` and ``add_cron_job``; ``on_start`` / ``on_shutdown``,
``add_http_service``, ``add_datasource``, ``add_tpu`` (the device
datasource on the card, ``ctx.tpu``), the HTTP and metrics servers,
``run``/``run_async`` (signal handlers only on the main thread), ``stop``,
``drain`` and ``shutdown``, the start and stop telemetry ping, the default
``/.well-known/{health,alive}`` routes with the ``./static`` and swagger
autodetect, the broker that ``PUBSUB_BACKEND`` names (``MEMORY``,
``KAFKA``, ``NATS``, ``MQTT``, ``EVENTHUB`` or ``GOOGLE``; a dark broker at
boot is DEGRADED health), the SQL
datasource when ``DB_DIALECT`` is set (sqlite, postgres, mysql; a dark
database at boot is DEGRADED health, not a crash), ``migrate``
(gofr.go:220-227, versioned migrations with a ``gofr_migration`` table)
and ``add_rest_handlers`` (crud_handlers.go, CRUD routes over
``ctx.sql``), the gRPC server on ``GRPC_PORT`` (default 9000) with
``register_grpc_service`` and ``grpc_server`` (grpc.go:21-269, on the port's
own wire, ``grpcx/``), and CMD mode (``new_cmd``, ``sub_command``).

Port addition: ``HTTP_HOST`` (default ``0.0.0.0``) is the address the HTTP
and metrics servers bind, and the gRPC server's too when set, so a test or a
smoke run can keep them on ``127.0.0.1``.
"""

from __future__ import annotations

import asyncio
import os
import signal
from typing import Any, Callable

from gofr_tpu_torch.config import Config, EnvConfig
from gofr_tpu_torch.container.container import Container
from gofr_tpu_torch.context import Context
from gofr_tpu_torch.cron import Crontab, _NoopRequest
from gofr_tpu_torch.handler import Handler, alive_handler, health_handler
from gofr_tpu_torch.http.dispatch import Dispatcher
from gofr_tpu_torch.http.middleware import (
    CORSConfig,
    api_key_auth_middleware,
    auth_middleware,
    basic_auth_middleware,
    chain,
    cors_middleware,
    logging_middleware,
    metrics_middleware,
    oauth_middleware,
    tracing_middleware,
)
from gofr_tpu_torch.http.router import Router
from gofr_tpu_torch.http.server import HTTPServer
from gofr_tpu_torch.metrics.server import MetricsHandler
from gofr_tpu_torch.subscriber import SubscriptionManager

DEFAULT_HTTP_PORT = 8000
DEFAULT_GRPC_PORT = 9000
DEFAULT_METRICS_PORT = 2121
DEFAULT_SHUTDOWN_GRACE_SECONDS = 30.0


class App:
    """gofr.New() analogue. Construct, register routes and services, then
    ``run()``."""

    def __init__(self, config: Config | None = None, *, is_cmd: bool = False) -> None:
        if config is None:
            config = EnvConfig(os.environ.get("GOFR_CONFIGS_DIR", "./configs"))
        self.config = config
        self.container = Container(config)
        self.logger = self.container.logger
        self.router = Router()
        self.is_cmd = is_cmd
        self._middlewares: list[Any] = []  # auth, ahead of the user's
        self._user_middlewares: list[Any] = []
        self.subscription_manager = SubscriptionManager(self.container)
        self.crontab = Crontab(self.container)
        self._ws_registry: dict[str, Handler] = {}
        self._cmd_routes: list[tuple[str, Handler, str]] = []
        self._on_start_hooks: list[Callable] = []
        self._on_shutdown_hooks: list[Callable] = []
        self._shutdown_event: asyncio.Event | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._servers: list[Any] = []
        self._grpc_server: Any = None

        self.http_host = self.config.get_or_default("HTTP_HOST", "0.0.0.0")
        self.http_port = int(self.config.get_or_default("HTTP_PORT", str(DEFAULT_HTTP_PORT)))
        self.grpc_port = int(self.config.get_or_default("GRPC_PORT", str(DEFAULT_GRPC_PORT)))
        self.metrics_port = int(self.config.get_or_default("METRICS_PORT", str(DEFAULT_METRICS_PORT)))

        # a dark broker at boot is a DEGRADED health state, not a crash —
        # the reference logs and continues (container.go's connect errors)
        from gofr_tpu_torch.pubsub import build_pubsub

        broker = build_pubsub(self.config)
        if broker is not None:
            try:
                self.container.register_datasource("pubsub", broker)
            except Exception as exc:
                self.logger.error(f"pubsub backend connect failed: {exc}")
                self.container.pubsub = broker  # health_check reports DOWN

        # SQL from config (container.go:128-130): DB_DIALECT selects
        # sqlite/postgres/mysql (sql.go:212-237). A dark database at boot is
        # DEGRADED health, not a crash; the wire dialects' keepalive loop
        # reconnects
        if self.config.get("DB_DIALECT"):
            from gofr_tpu_torch.datasource.sql import new_sql

            db = new_sql(self.config)
            try:
                self.container.register_datasource("sql", db)
            except Exception as exc:
                self.logger.error(f"sql backend connect failed: {exc}")
                self.container.sql = db  # health_check reports DOWN

        if not is_cmd:
            self._register_defaults()

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

    def add_static_files(self, url_prefix: str, fs_dir: str) -> None:
        self.router.add_static_files(url_prefix, fs_dir)

    def use_middleware(self, *mws: Any) -> None:
        """App-level custom middleware (http/router.go:29)."""
        self._user_middlewares.extend(mws)

    def _register_defaults(self) -> None:
        """factory.go:48-78: health routes, swagger + static autodetect."""
        self.router.add("GET", "/.well-known/health", health_handler)
        self.router.add("GET", "/.well-known/alive", alive_handler)
        if os.path.isdir("./static"):
            self.add_static_files("/static", "./static")
            if os.path.isfile("./static/openapi.json"):
                self._register_swagger("./static/openapi.json")

    def _register_swagger(self, spec_path: str) -> None:
        from gofr_tpu_torch.http.swagger import swagger_handlers

        spec_handler, ui_handler = swagger_handlers(spec_path)
        self.router.add("GET", "/.well-known/openapi.json", spec_handler)
        self.router.add("GET", "/.well-known/swagger", ui_handler)

    # ----------------------------------------------------------------- auth
    def enable_basic_auth(self, users: dict[str, str]) -> None:
        self._middlewares.append(basic_auth_middleware(users=users))

    def enable_basic_auth_with_validator(self, validate: Callable[[Any, str, str], bool]) -> None:
        self._middlewares.append(
            basic_auth_middleware(validate_with_container=validate, container=self.container)
        )

    def enable_api_key_auth(self, *keys: str) -> None:
        self._middlewares.append(api_key_auth_middleware(keys=list(keys)))

    def enable_api_key_auth_with_validator(self, validate: Callable[[Any, str], bool]) -> None:
        self._middlewares.append(
            api_key_auth_middleware(validate_with_container=validate, container=self.container)
        )

    def enable_oauth(self, jwks_url: str, refresh_interval: float = 3600.0, **kw: Any) -> None:
        self._middlewares.append(
            oauth_middleware(jwks_url=jwks_url, refresh_interval=refresh_interval, **kw)
        )

    def enable_auth_provider(self, provider: Any) -> None:
        self._middlewares.append(auth_middleware(provider))

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

    def add_tpu(self, tpu: Any) -> None:
        """Wire the device datasource (``datasource.tpu.new_tpu``): it
        connects, joins health, and handlers reach it as ``ctx.tpu``."""
        self.container.register_datasource("tpu", tpu)

    def add_rest_handlers(self, entity_cls: type, table: str | None = None) -> None:
        """AddRESTHandlers (crud_handlers.go): POST, GET, GET by id, PUT and
        DELETE routes for a dataclass entity, backed by ``ctx.sql``; a method
        of the same name on the entity overrides each default."""
        from gofr_tpu_torch.crud import add_rest_handlers

        add_rest_handlers(self, entity_cls, table)

    def migrate(self, migrations: dict[int, Any]) -> None:
        """gofr.go:220-227: runs the versions above the last applied one now,
        against the container's datasources (``migration.run_migrations``).
        A version's ``ds.tpu`` work on the card is a one-time warm-up and
        check, not a cache: a CUDA graph does not outlive its process, so a
        restart skips the version and keeps nothing of its capture."""
        from gofr_tpu_torch.migration import run_migrations

        run_migrations(migrations, self.container)

    # ------------------------------------------------------------ async + cron
    def subscribe(self, topic: str, handler: Handler) -> None:
        """gofr.go:233-249."""
        self.subscription_manager.register(topic, handler)

    def add_cron_job(self, schedule: str, name: str, handler: Handler) -> None:
        """gofr.go:271-287."""
        self.crontab.add(schedule, name, handler)

    # -- gRPC ------------------------------------------------------------------
    def register_grpc_service(self, servicer: Any, adder: Callable | None = None) -> None:
        """grpc.go:200-269: register an implementation; the container is
        injected into a ``container`` attribute when present."""
        self.grpc_server.register(servicer, adder)

    @property
    def grpc_server(self) -> Any:
        from gofr_tpu_torch.grpcx.server import GRPCServer

        if self._grpc_server is None:
            self._grpc_server = GRPCServer(self.container, self.grpc_port, self.config)
        return self._grpc_server

    # -- WebSocket -------------------------------------------------------------
    def websocket(self, pattern: str, handler: Handler) -> None:
        """websocket.go:30-49: per-message handler loop on an upgraded
        connection."""
        self._ws_registry[pattern] = handler

    def add_ws_service(self, name: str, url: str, *, reconnect: bool = True) -> None:
        from gofr_tpu_torch.websocket import WSManager

        if self.container.ws_manager is None:
            self.container.ws_manager = WSManager(self.logger)
        self.container.ws_manager.add_service(name, url, reconnect=reconnect)

    # -- CMD -------------------------------------------------------------------
    def sub_command(self, pattern: str, handler: Handler, description: str = "") -> None:
        self._cmd_routes.append((pattern, handler, description))

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
        middlewares.extend(self._middlewares)  # auth
        middlewares.extend(self._user_middlewares)
        return chain(dispatcher, middlewares)

    async def _start_servers(self) -> None:
        handler = self._build_http_handler()
        ws_upgrader = None
        if self._ws_registry:
            from gofr_tpu_torch.websocket import WSManager, WSUpgrader

            if self.container.ws_manager is None:
                self.container.ws_manager = WSManager(self.logger)
            ws_upgrader = WSUpgrader(
                self._ws_registry,
                self.container,
                middlewares=self._middlewares + self._user_middlewares,
            )

        http_server = HTTPServer(
            handler,
            self.http_port,
            host=self.http_host,
            logger=self.logger,
            cert_file=self.config.get("CERT_FILE"),
            key_file=self.config.get("KEY_FILE"),
            ws_upgrader=ws_upgrader,
        )
        metrics_server = HTTPServer(
            MetricsHandler(self.container), self.metrics_port, host=self.http_host,
            logger=self.logger,
        )
        self._servers = [metrics_server, http_server]
        await metrics_server.start()
        await http_server.start()
        if self.container.ws_manager is not None:
            await self.container.ws_manager.connect_services()
        if self._grpc_server is not None:
            await self._grpc_server.start()
        await self.subscription_manager.start()
        await self.crontab.start()

    async def _run_on_start_hooks(self) -> None:
        """run.go:39-53: ordered, abort on first error."""
        for hook in self._on_start_hooks:
            ctx = Context(_NoopRequest(), self.container)
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
            + (f" grpc=:{self.grpc_port}" if self._grpc_server else "")
        )
        from gofr_tpu_torch.telemetry import send_ping

        send_ping(self.config, "start", self.logger)
        await self._shutdown_event.wait()
        send_ping(self.config, "stop", self.logger)
        await self.shutdown()

    def run(self) -> int | None:
        if self.is_cmd:
            return self._run_cmd()
        try:
            asyncio.run(self.run_async())
        except KeyboardInterrupt:
            pass
        return None

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
        DRAINING and reject new work with a retriable status immediately
        (HTTP 503 + Retry-After, WS upgrade 503), then run the normal shutdown sequence — whose hooks
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
        await self.subscription_manager.stop()
        await self.crontab.stop()
        if self.container.ws_manager is not None:
            await self.container.ws_manager.close()
        if self._grpc_server is not None:
            await self._grpc_server.shutdown()
        for server in self._servers:
            await server.shutdown()

    # -- CMD execution (cmd.go:35-164) ----------------------------------------
    def _run_cmd(self) -> int:
        from gofr_tpu_torch.cli import run_cmd

        return run_cmd(self)


def new_cmd(config: Config | None = None) -> App:
    """NewCMD (factory.go:81-95): no servers, subcommand routing."""
    return App(config, is_cmd=True)
