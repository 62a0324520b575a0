"""Leveled, structured, trace-aware logging of the port (a copy of
``gofr_tpu/logging``): levels DEBUG..FATAL, JSON lines for pipes and a
colorized format for terminals, the error-defined log level,
``ContextLogger``, and the remote log-level poller (``logging/remote.py``,
with its trace sample-ratio twin). A record emitted under an active span of
the port's tracer carries its ``trace_id``/``span_id`` (log correlation)."""

from gofr_tpu_torch.logging.level import Level, parse_level
from gofr_tpu_torch.logging.logger import ContextLogger, Logger, PrettyPrint, new_logger
from gofr_tpu_torch.logging.remote import RemoteLevelService, start_remote_level_poller

__all__ = ["ContextLogger", "Level", "Logger", "PrettyPrint", "RemoteLevelService", "new_logger",
           "parse_level", "start_remote_level_poller"]
