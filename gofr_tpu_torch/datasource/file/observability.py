"""Observability wrapper for file systems (datasource/file/observability.go):
logs every operation with duration and records metrics.

The port's copy of ``gofr_tpu/datasource/file/observability.py``; it imports nothing of the JAX package.
"""

from __future__ import annotations

import io
import time
from typing import Any


class FileLog:
    def __init__(self, operation: str, target: str, duration_us: int) -> None:
        self.operation, self.target, self.duration = operation, target, duration_us

    def pretty_print(self, writer: io.TextIOBase) -> None:
        writer.write(f"\x1b[38;5;8mFILE\x1b[0m {self.duration:>8}µs {self.operation} {self.target}")

    def __str__(self) -> str:
        return f"FILE {self.duration}µs {self.operation} {self.target}"


_WRAPPED = (
    "create", "open", "open_file", "remove", "remove_all", "rename",
    "mkdir", "read_dir", "stat", "chdir", "getwd",
)


class ObservedFileSystem:
    def __init__(self, inner: Any, logger: Any = None, metrics: Any = None) -> None:
        self._inner = inner
        self._logger = logger
        self._metrics = metrics

    def use_logger(self, logger: Any) -> None:
        self._logger = logger

    def use_metrics(self, metrics: Any) -> None:
        self._metrics = metrics

    def use_tracer(self, tracer: Any) -> None:
        pass

    def connect(self) -> None:
        if hasattr(self._inner, "connect"):
            self._inner.connect()

    def __getattr__(self, name: str) -> Any:
        attr = getattr(self._inner, name)
        if name not in _WRAPPED or not callable(attr):
            return attr

        def wrapped(*args: Any, **kw: Any) -> Any:
            start = time.perf_counter()
            status = "SUCCESS"
            try:
                return attr(*args, **kw)
            except Exception:
                status = "ERROR"
                raise
            finally:
                duration_us = int((time.perf_counter() - start) * 1e6)
                if self._logger is not None:
                    target = str(args[0]) if args else ""
                    self._logger.debug(FileLog(name, target, duration_us))
                if self._metrics is not None:
                    self._metrics.record_histogram(
                        "app_file_stats", duration_us / 1000.0,
                        operation=name, status=status,
                    )

        return wrapped

    def health_check(self) -> dict[str, Any]:
        return self._inner.health_check()

    def close(self) -> None:
        if hasattr(self._inner, "close"):
            self._inner.close()
