"""Remote log-level + trace sample-ratio management (a copy of
``gofr_tpu/logging/remote.py``).

Reference parity: pkg/gofr/logging/remotelogger/dynamic_level_logger.go:141-277
— a background poller fetches ``{"data":[{"serviceName":..., "logLevel":...}]}``
from ``REMOTE_LOG_URL`` every ``REMOTE_LOG_FETCH_INTERVAL`` seconds (default
15) and applies the level via ``change_level`` on the live logger. Wired as
the default logger path by the Container when the URL is configured
(container/container.go:101-113).

The trace sample-ratio poller is the sibling mechanism for the tracing
plane (docs/observability.md "Sampling knobs"): ``REMOTE_TRACE_RATIO_URL``
serves ``{"data":[{"sampleRatio": 0.25}]}`` and the poller applies it via
``Tracer.set_sample_ratio`` — an incident responder turns sampling up on
a live fleet, then back down, without restarting anything.
"""

from __future__ import annotations

import json
import threading
import urllib.request
from typing import Any

from gofr_tpu_torch.logging.level import Level, parse_level

DEFAULT_FETCH_INTERVAL_SECONDS = 15.0


class RemoteLevelService:
    """Fetches the desired log level from a remote endpoint."""

    def __init__(self, url: str, timeout: float = 5.0) -> None:
        self.url = url
        self.timeout = timeout

    def fetch_level(self) -> Level | None:
        try:
            with urllib.request.urlopen(self.url, timeout=self.timeout) as resp:
                body = json.loads(resp.read().decode("utf-8"))
        except Exception:
            return None
        data: Any = body.get("data")
        if isinstance(data, dict):
            data = [data]
        if not isinstance(data, list):
            return None
        for item in data:
            lvl = item.get("logLevel") or item.get("LOG_LEVEL")
            if isinstance(lvl, dict):
                lvl = lvl.get("LOG_LEVEL")
            if lvl:
                return parse_level(str(lvl))
        return None


def start_remote_level_poller(
    logger: Any,
    url: str,
    interval: float = DEFAULT_FETCH_INTERVAL_SECONDS,
    stop_event: threading.Event | None = None,
) -> threading.Thread:
    """Spawn the level-poll daemon thread (dynamic_level_logger.go:141-166)."""
    svc = RemoteLevelService(url)
    stop = stop_event or threading.Event()

    def loop() -> None:
        while not stop.wait(interval):
            level = svc.fetch_level()
            if level is not None and level != logger.level:
                logger.info(
                    "LOG_LEVEL updated from %s to %s" % (logger.level.name, level.name)
                )
                logger.change_level(level)

    t = threading.Thread(target=loop, name="remote-log-level", daemon=True)
    t._gofr_stop = stop  # type: ignore[attr-defined]
    t.start()
    return t


class RemoteTraceRatioService:
    """Fetches the desired trace sample ratio from a remote endpoint.
    Accepted payload shapes mirror the log-level service:
    ``{"data": [{"sampleRatio": 0.25}]}`` (also ``traceRatio`` /
    ``TRACER_RATIO`` keys, and a bare dict instead of a list)."""

    _KEYS = ("sampleRatio", "traceRatio", "TRACER_RATIO")

    def __init__(self, url: str, timeout: float = 5.0) -> None:
        self.url = url
        self.timeout = timeout

    def fetch_ratio(self) -> float | None:
        try:
            with urllib.request.urlopen(self.url, timeout=self.timeout) as resp:
                body = json.loads(resp.read().decode("utf-8"))
        except Exception:
            return None
        data: Any = body.get("data") if isinstance(body, dict) else None
        if isinstance(data, dict):
            data = [data]
        if not isinstance(data, list):
            return None
        for item in data:
            if not isinstance(item, dict):
                continue
            for key in self._KEYS:
                value = item.get(key)
                if value is None:
                    continue
                try:
                    return float(value)
                except (TypeError, ValueError):
                    continue
        return None


def start_remote_trace_ratio_poller(
    tracer: Any,
    url: str,
    interval: float = DEFAULT_FETCH_INTERVAL_SECONDS,
    stop_event: threading.Event | None = None,
    logger: Any = None,
) -> threading.Thread:
    """Spawn the trace sample-ratio poll daemon — the tracing twin of
    :func:`start_remote_level_poller`."""
    svc = RemoteTraceRatioService(url)
    stop = stop_event or threading.Event()

    def loop() -> None:
        while not stop.wait(interval):
            ratio = svc.fetch_ratio()
            if ratio is None:
                continue
            clamped = max(0.0, min(1.0, ratio))
            if clamped != tracer.sample_ratio:
                if logger is not None:
                    logger.info(
                        "trace sample ratio updated from %g to %g"
                        % (tracer.sample_ratio, clamped)
                    )
                tracer.set_sample_ratio(clamped)

    t = threading.Thread(target=loop, name="remote-trace-ratio", daemon=True)
    t._gofr_stop = stop  # type: ignore[attr-defined]
    t.start()
    return t
