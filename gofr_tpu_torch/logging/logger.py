"""Structured logger: JSON for pipes, pretty colorized output for TTYs (a
copy of ``gofr_tpu/logging/logger.py`` over the port's tracer).

Reference parity: pkg/gofr/logging/logger.go — level filtering (:98-126),
TTY detection to choose format (:88-92, 234-246), ``PrettyPrint`` protocol for
structured payloads (:19-21), error-defined log levels (:262-270), and the
ContextLogger that injects trace/span ids into every line
(ctx_logger.go:14-67).
"""

from __future__ import annotations

import io
import json
import os
import sys
import threading
import time
from typing import Any, Protocol, runtime_checkable

from gofr_tpu_torch.logging.level import Level, parse_level
from gofr_tpu_torch.tracing.trace import current_span

_TERMINAL_CLEAR = "\x1b[0m"


@runtime_checkable
class PrettyPrint(Protocol):
    """Objects that know how to render themselves on a terminal
    (logger.go:19-21). Datasource query logs and request logs implement this
    so the pretty output stays scannable."""

    def pretty_print(self, writer: io.TextIOBase) -> None: ...


@runtime_checkable
class LevelError(Protocol):
    """Errors may define the level they should be logged at
    (logger.go:262-270)."""

    def log_level(self) -> Level: ...


class Logger:
    """Leveled structured logger.

    Output format: one JSON object per line when the sink is not a TTY (or
    when ``LOG_JSON=true``); colorized human format on a TTY. FATAL exits the
    process like the reference (logger.go:214-218) unless ``exit_on_fatal`` is
    disabled (tests).
    """

    def __init__(
        self,
        level: Level = Level.INFO,
        out: Any = None,
        err: Any = None,
        *,
        exit_on_fatal: bool = True,
    ) -> None:
        self.level = level
        self._out = out if out is not None else sys.stdout
        self._err = err if err is not None else sys.stderr
        self._lock = threading.Lock()
        self._exit_on_fatal = exit_on_fatal
        self._is_terminal = self._detect_terminal()

    # -- level management (remote log level calls change_level) --------------
    def change_level(self, level: Level) -> None:
        self.level = level

    def _detect_terminal(self) -> bool:
        if os.environ.get("LOG_JSON", "").lower() in ("1", "true"):
            return False
        try:
            return bool(self._out.isatty())
        except (AttributeError, ValueError):
            return False

    # -- emit -----------------------------------------------------------------
    def _log(self, level: Level, args: tuple, kwargs: dict[str, Any]) -> None:
        if level < self.level:
            return
        message: Any
        if len(args) == 1:
            message = args[0]
        elif args and isinstance(args[0], str) and "%" in args[0]:
            try:
                message = args[0] % args[1:]
            except (TypeError, ValueError):
                message = " ".join(str(a) for a in args)
        else:
            message = " ".join(str(a) for a in args) if args else ""

        entry: dict[str, Any] = {
            "level": level.name,
            "time": time.strftime("%Y-%m-%dT%H:%M:%S", time.localtime())
            + f".{int((time.time() % 1) * 1e6):06d}",
            "message": message if not isinstance(message, PrettyPrint) else None,
        }
        if isinstance(message, PrettyPrint):
            entry["message"] = getattr(message, "__dict__", str(message))
        entry.update({k: v for k, v in kwargs.items() if v is not None})
        if "trace_id" not in entry:
            # trace/log correlation: any record emitted under an active
            # span carries its ids, so `grep <trace_id>` surfaces the
            # request's structured logs alongside its span tree and
            # /requestz timeline. Explicit ids (ContextLogger) win.
            span = current_span()
            if span is not None:
                entry["trace_id"] = span.trace_id
                entry["span_id"] = span.span_id

        sink = self._err if level >= Level.ERROR else self._out
        with self._lock:
            if self._is_terminal:
                self._pretty(sink, level, message, entry)
            else:
                try:
                    sink.write(json.dumps(entry, default=str) + "\n")
                except ValueError:  # closed file during interpreter teardown
                    return
            try:
                sink.flush()
            except (ValueError, OSError):
                pass
        if level == Level.FATAL and self._exit_on_fatal:
            raise SystemExit(1)

    def _pretty(self, sink: Any, level: Level, message: Any, entry: dict) -> None:
        ts = entry["time"]
        sink.write(f"\x1b[38;5;{level.color}m{level.name:<5}\x1b[0m [{ts}] ")
        trace = entry.get("trace_id")
        if trace:
            sink.write(f"\x1b[38;5;8m{trace}\x1b[0m ")
        if isinstance(message, PrettyPrint):
            message.pretty_print(sink)
        else:
            sink.write(f"{message}")
        sink.write("\n")

    # -- public api (logger.go:26-42) ----------------------------------------
    def debug(self, *args: Any, **kw: Any) -> None:
        self._log(Level.DEBUG, args, kw)

    def info(self, *args: Any, **kw: Any) -> None:
        self._log(Level.INFO, args, kw)

    def notice(self, *args: Any, **kw: Any) -> None:
        self._log(Level.NOTICE, args, kw)

    def warn(self, *args: Any, **kw: Any) -> None:
        self._log(Level.WARN, args, kw)

    def error(self, *args: Any, **kw: Any) -> None:
        self._log(Level.ERROR, args, kw)

    def fatal(self, *args: Any, **kw: Any) -> None:
        self._log(Level.FATAL, args, kw)

    def log(self, *args: Any, **kw: Any) -> None:
        self._log(Level.INFO, args, kw)

    def log_error(self, err: BaseException, *args: Any, **kw: Any) -> None:
        """Log an error at the level the error itself defines, defaulting to
        ERROR (logger.go:262-270)."""
        level = Level.ERROR
        if isinstance(err, LevelError):
            level = err.log_level()
        self._log(level, args or (str(err),), kw)


class ContextLogger:
    """Wraps a Logger and injects the active trace/span ids into every entry
    (ctx_logger.go:14-67). Built per-request by the Context."""

    def __init__(self, base: Logger, trace_id: str | None = None, span_id: str | None = None) -> None:
        self._base = base
        self.trace_id = trace_id
        self.span_id = span_id

    @property
    def level(self) -> Level:
        return self._base.level

    def change_level(self, level: Level) -> None:
        self._base.change_level(level)

    def _kw(self, kw: dict[str, Any]) -> dict[str, Any]:
        if self.trace_id:
            kw.setdefault("trace_id", self.trace_id)
        if self.span_id:
            kw.setdefault("span_id", self.span_id)
        return kw

    def debug(self, *args: Any, **kw: Any) -> None:
        self._base.debug(*args, **self._kw(kw))

    def info(self, *args: Any, **kw: Any) -> None:
        self._base.info(*args, **self._kw(kw))

    def notice(self, *args: Any, **kw: Any) -> None:
        self._base.notice(*args, **self._kw(kw))

    def warn(self, *args: Any, **kw: Any) -> None:
        self._base.warn(*args, **self._kw(kw))

    def error(self, *args: Any, **kw: Any) -> None:
        self._base.error(*args, **self._kw(kw))

    def fatal(self, *args: Any, **kw: Any) -> None:
        self._base.fatal(*args, **self._kw(kw))

    def log(self, *args: Any, **kw: Any) -> None:
        self._base.log(*args, **self._kw(kw))

    def log_error(self, err: BaseException, *args: Any, **kw: Any) -> None:
        self._base.log_error(err, *args, **self._kw(kw))


def new_logger(level: Level | str = Level.INFO, **kw: Any) -> Logger:
    if isinstance(level, str):
        level = parse_level(level)
    return Logger(level, **kw)
