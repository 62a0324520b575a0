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
``build_exporter``, ``services``, ``serving``, ``register_datasource`` and
the ``draining`` flag. The provider wiring of SQL, Redis, files and the
networked brokers (``container/datasources.py``), the remote log-level and
trace-ratio pollers are not ported.
"""

from __future__ import annotations

import os
import threading
from typing import Any

from gofr_tpu_torch.config import Config, EnvConfig
from gofr_tpu_torch.logging import Logger, new_logger, parse_level
from gofr_tpu_torch.metrics import Manager, new_metrics_manager
from gofr_tpu_torch.serving.metrics_catalog import register_serving_metrics
from gofr_tpu_torch.tracing import BatchSpanProcessor, Tracer, build_exporter, new_tracer

FRAMEWORK_VERSION = "dev"  # the reference's version.FRAMEWORK

# (kind, name, description) of the series the reference's container
# registers beside those of the serving catalog (which holds the app,
# HTTP, service-client and breaker series the port records), under its
# names and kinds, all with the default buckets: the two runtime gauges
# read at scrape time, and the datasource series (SQL, Redis, files,
# subscribers, the TPU mesh breaker). The port has no emitter of the
# datasource series yet; they are registered so that a dashboard built on
# the reference reads the same families.
FRAMEWORK_METRICS: tuple[tuple[str, str, str], ...] = (
    ("gauge", "app_go_routines", "Number of live threads (goroutine analogue)"),
    ("gauge", "app_sys_memory_alloc", "Resident memory of the process in bytes"),
    ("histogram", "app_sql_stats", "Response time of SQL queries in milliseconds"),
    ("gauge", "app_sql_open_connections", "Number of open SQL connections"),
    ("gauge", "app_sql_inuse_connections", "Number of inuse SQL connections"),
    ("histogram", "app_redis_stats", "Response time of Redis commands in milliseconds"),
    ("histogram", "app_file_stats", "Duration of file-system operations in milliseconds"),
    ("counter", "app_pubsub_subscribe_total_count", "Number of total subscribe operations"),
    ("counter", "app_pubsub_subscribe_success_count",
     "Number of successful subscribe operations"),
    ("counter", "app_pubsub_commit_fail_count",
     "Commits that failed after a successful handler run (the broker redelivers)"),
    ("counter", "app_pubsub_redeliveries_total",
     "Messages delivered more than once to this consumer group"),
    ("counter", "app_pubsub_dlq_total",
     "Messages dead-lettered after exhausting their delivery budget"),
    ("gauge", "app_pubsub_consumer_lag",
     "Undelivered backlog behind this consumer group, per topic"),
    ("histogram", "app_pubsub_handler_duration_seconds", "Subscriber handler execution time"),
    ("gauge", "app_tpu_duty_cycle", "Fraction of wall time the TPU executed in the last window"),
    ("counter", "app_tpu_devices_excluded_total",
     "Devices excluded from the mesh by the sick-chip breaker"),
)



def wire_provider(ds: Any, logger: Any, metrics: Any, tracer: Any) -> None:
    """Apply the provider pattern to a datasource then connect it
    (``gofr_tpu/container/datasources.py`` ``wire_provider``;
    datasources.go:346-359)."""
    if hasattr(ds, "use_logger"):
        ds.use_logger(logger)
    if hasattr(ds, "use_metrics"):
        ds.use_metrics(metrics)
    if hasattr(ds, "use_tracer"):
        ds.use_tracer(tracer)
    if hasattr(ds, "connect"):
        ds.connect()


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

        self.metrics_manager: Manager = new_metrics_manager(self.logger)
        self.tracer: Tracer = self._build_tracer()

        # datasources: the broker (PUBSUB_BACKEND, or one registered as
        # "pubsub"), and any other by name (App.add_datasource)
        self.pubsub: Any = None
        self.services: dict[str, Any] = {}
        self.extra_datasources: dict[str, Any] = {}
        self.serving: Any = None  # the serving engine (serving/handlers.py)
        # request-lifecycle drain flag: flipped by App.drain()/shutdown();
        # HTTP dispatch rejects new work with a retriable 503 while it is set
        self.draining = False

        self._closed = False
        self._lock = threading.Lock()

        self.register_framework_metrics()

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
        return self.pubsub

    def register_datasource(self, name: str, ds: Any) -> None:
        """Wire and connect a provider-pattern datasource (external_db.go
        Add* analogue); its ``health_check`` joins ``/.well-known/health``."""
        wire_provider(ds, self.logger, self.metrics_manager, self.tracer)
        if name == "pubsub":
            self.pubsub = ds
        else:
            self.extra_datasources[name] = ds

    def datasource_pairs(self) -> list[tuple[str, Any]]:
        return [("pubsub", self.pubsub), *self.extra_datasources.items()]

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


def _rss_bytes() -> int:
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return 0
