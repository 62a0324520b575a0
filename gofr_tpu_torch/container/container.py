"""The dependency-injection Container (the part of
``gofr_tpu/container/container.py`` that serving uses).

Reference parity: pkg/gofr/container/container.go:43-177 — owns the Logger,
the metrics Manager, the tracer, the inter-service HTTP clients
(``services``) and the datasources; builds them from Config; registers the
framework metrics (:252-284); ``close()`` tears everything down (:179-199).
Health aggregation lives in health.py (container/health.go:8-98).

What the port holds: config, logger, ``metrics_manager`` (the port's
``metrics.Manager`` with the serving catalog,
``serving/metrics_catalog.py``, and the framework series below), the tracer with
``build_exporter``, the remote log-level (``REMOTE_LOG_URL``) and trace
sample-ratio (``REMOTE_TRACE_RATIO_URL``) pollers (:101-113), ``services``,
``serving``, ``ws_manager``, ``register_datasource`` and the ``draining``
flag, and the datasource slots of the reference (:397-413): ``tpu``
(``App.add_tpu``; ``ctx.tpu``), ``sql`` (``DB_DIALECT``; ``ctx.sql``),
``pubsub``, ``redis`` (``datasource/redis``: the RESP2 client or
``InMemoryRedis``), ``file`` (``datasource/file``: local, S3, GCS, FTP or
SFTP), ``kv_store`` (``datasource/kv``: in memory, a JSON file, TTLs or
DynamoDB) and ``cache``; each stays ``None`` until a datasource is
registered under that name (``App.add_datasource``). Any other name (the
``document``, ``widecolumn``, ``search`` and ``timeseries`` families) goes
to ``extra_datasources``, which ``ctx.datasource(name)`` reads.
Each joins ``datasource_pairs`` and the health aggregate. The provider
pattern (``wire_provider``) and the datasource contracts live in
``container/datasources.py``.
"""

from __future__ import annotations

import os
import threading
import weakref
from typing import Any

from gofr_tpu_torch.config import Config, EnvConfig
from gofr_tpu_torch.container.datasources import wire_provider  # noqa: F401  (its old home)
from gofr_tpu_torch.logging import Logger, new_logger, parse_level, start_remote_level_poller
from gofr_tpu_torch.metrics import Manager, new_metrics_manager
from gofr_tpu_torch.serving.metrics_catalog import register_serving_metrics
from gofr_tpu_torch.tracing import BatchSpanProcessor, Tracer, build_exporter, new_tracer

FRAMEWORK_VERSION = "dev"  # the reference's version.FRAMEWORK

# (kind, name, description) of the series the reference's container
# registers beside those of the serving catalog (which holds the app,
# HTTP, service-client and breaker series the port records), under its
# names and kinds: the two runtime gauges read at scrape time. The
# subscribers', the device datasource's and the SQL, Redis and file
# datasources' series are in the catalog, with their emitters
# (``subscriber.py``, ``datasource/tpu/client.py``, ``datasource/sql/``,
# ``datasource/redis/client.py``, ``datasource/file/``).
FRAMEWORK_METRICS: tuple[tuple[str, str, str], ...] = (
    ("gauge", "app_go_routines", "Number of live threads (goroutine analogue)"),
    ("gauge", "app_sys_memory_alloc", "Resident memory of the process in bytes"),
)


# the container's own datasource attributes, in the reference's order
# (container/container.py:397-413); any other name is an extra datasource
DATASOURCE_SLOTS = ("tpu", "sql", "redis", "pubsub", "kv_store", "file", "cache")


class Container:
    """Holds every cross-cutting dependency handlers may use."""

    def __init__(self, config: Config | None = None, logger: Logger | None = None) -> None:
        self.config: Config = config if config is not None else EnvConfig()
        self.app_name = self.config.get_or_default("APP_NAME", "gofr-app")
        self.app_version = self.config.get_or_default("APP_VERSION", "dev")

        if logger is not None:
            self.logger = logger
        else:
            self.logger = new_logger(parse_level(self.config.get_or_default("LOG_LEVEL", "INFO")))
            remote_url = self.config.get("REMOTE_LOG_URL")
            if remote_url:
                interval = float(
                    self.config.get_or_default("REMOTE_LOG_FETCH_INTERVAL", "15")
                )
                self._remote_log_thread = start_remote_level_poller(
                    self.logger, remote_url, interval
                )

        self.metrics_manager: Manager = new_metrics_manager(self.logger)
        self.tracer: Tracer = self._build_tracer()
        # live trace sample-ratio adjustment: the sibling of the remote
        # log-level poller (logging/remote.py) — an incident responder
        # raises sampling on a live fleet without a restart
        ratio_url = self.config.get("REMOTE_TRACE_RATIO_URL")
        if ratio_url:
            from gofr_tpu_torch.logging.remote import start_remote_trace_ratio_poller

            interval = float(
                self.config.get_or_default("REMOTE_TRACE_RATIO_INTERVAL", "15")
            )
            self._remote_trace_thread = start_remote_trace_ratio_poller(
                self.tracer, ratio_url, interval, logger=self.logger
            )

        # datasources: the device (App.add_tpu), SQL (DB_DIALECT), the
        # broker (PUBSUB_BACKEND, or one registered as "pubsub"), the slots
        # a migration reads by name, and any other by name
        # (App.add_datasource)
        self.tpu: Any = None
        self.sql: Any = None
        self.redis: Any = None
        self.pubsub: Any = None
        self.kv_store: Any = None
        self.file: Any = None
        self.cache: Any = None
        self.services: dict[str, Any] = {}
        self.extra_datasources: dict[str, Any] = {}
        self.serving: Any = None  # the serving engine (serving/handlers.py)
        self.ws_manager: Any = None  # websocket.WSManager, made by the App
        # request-lifecycle drain flag: flipped by App.drain()/shutdown();
        # HTTP dispatch rejects new work with a retriable 503 while it is set
        self.draining = False

        self._closed = False
        self._lock = threading.Lock()
        self._subscription_manager_ref: Any = None

        self.register_framework_metrics()

    @property
    def subscription_manager(self) -> Any:
        """The App's ``SubscriptionManager`` (health reads its consumers),
        or None. Held weakly: the manager holds this container, and a
        strong back-reference would keep the container, and the engine it
        serves with its weights on the card, alive in a cycle until a
        garbage collection."""
        ref = self._subscription_manager_ref
        return None if ref is None else ref()

    @subscription_manager.setter
    def subscription_manager(self, manager: Any) -> None:
        self._subscription_manager_ref = None if manager is None else weakref.ref(manager)

    # -- construction helpers -------------------------------------------------
    def _build_tracer(self) -> Tracer:
        exporter = build_exporter(self.config, self.logger)
        processor = BatchSpanProcessor(exporter) if exporter is not None else None
        ratio = float(self.config.get_or_default("TRACER_RATIO", "1"))
        return new_tracer(self.app_name, processor, ratio)

    def register_framework_metrics(self) -> None:
        """Framework metric registration (container/container.go:252-284):
        the serving catalog and :data:`FRAMEWORK_METRICS`, then the app's
        info and runtime gauges."""
        m = self.metrics_manager
        register_serving_metrics(m)
        for kind, name, description in FRAMEWORK_METRICS:
            getattr(m, f"new_{kind}")(name, description)
        m.set_gauge("app_info", 1, app_name=self.app_name, app_version=self.app_version,
                    framework_version=FRAMEWORK_VERSION)
        m.get("app_go_routines").observe_with(lambda: {(): float(threading.active_count())})
        m.get("app_sys_memory_alloc").observe_with(lambda: {(): float(_rss_bytes())})

    # -- accessors mirroring the reference's API ------------------------------
    @property
    def metrics(self) -> Manager:
        return self.metrics_manager

    def get_http_service(self, name: str) -> Any:
        """container.GetHTTPService (container/container.go:286-292)."""
        return self.services.get(name)

    def get_publisher(self) -> Any:
        """container/container.go:294-300."""
        return self.pubsub

    def get_subscriber(self) -> Any:
        return self.pubsub

    def register_datasource(self, name: str, ds: Any) -> None:
        """Wire and connect a provider-pattern datasource (external_db.go
        Add* analogue); its ``health_check`` joins ``/.well-known/health``."""
        wire_provider(ds, self.logger, self.metrics_manager, self.tracer)
        if name in DATASOURCE_SLOTS:
            setattr(self, name, ds)
        else:
            self.extra_datasources[name] = ds

    def datasource_pairs(self) -> list[tuple[str, Any]]:
        return [*((name, getattr(self, name)) for name in DATASOURCE_SLOTS),
                *self.extra_datasources.items()]

    def health(self) -> dict[str, Any]:
        from gofr_tpu_torch.container.health import aggregate_health

        return aggregate_health(self)

    def close(self) -> None:
        """container/container.go:179-199."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        for name, ds in self.datasource_pairs():
            closer = getattr(ds, "close", None)
            if callable(closer):
                try:
                    closer()
                except Exception as exc:
                    self.logger.debug(f"error closing {name}: {exc}")
        if self.serving is not None and hasattr(self.serving, "stop"):
            try:
                self.serving.stop()
            except Exception:
                pass
        self.tracer.shutdown()
        for attr in ("_remote_log_thread", "_remote_trace_thread"):
            thread = getattr(self, attr, None)
            if thread is not None:
                thread._gofr_stop.set()


def _rss_bytes() -> int:
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return 0
