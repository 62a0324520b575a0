"""Leveled, structured, trace-aware logging of the port (a copy of
``gofr_tpu/logging``): levels DEBUG..FATAL, JSON lines for pipes and a
colorized format for terminals, the error-defined log level, and
``ContextLogger``. A record emitted under an active span of the port's
tracer carries its ``trace_id``/``span_id`` (log correlation). The remote
log-level poller is not ported."""

from gofr_tpu_torch.logging.level import Level, parse_level
from gofr_tpu_torch.logging.logger import ContextLogger, Logger, PrettyPrint, new_logger

__all__ = ["ContextLogger", "Level", "Logger", "PrettyPrint", "new_logger", "parse_level"]
