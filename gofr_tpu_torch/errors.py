"""Typed errors of the request lifecycle (a copy of what the serving engine
raises from ``gofr_tpu/http/errors.py``; the port imports nothing of the
JAX package).

Each carries the HTTP status a transport answers with. A retriable
rejection (shed, drain, stop) carries ``retry_after`` in seconds, which
reaches the client as a ``Retry-After`` header. The log level of the
reference's classes is left out: the port has no logger of its own yet.
"""

from __future__ import annotations

import math
from typing import Any


class HTTPError(Exception):
    """Base for the lifecycle's errors: carries ``status_code``."""

    status_code: int = 500
    # retriable rejections (shed, drain) advertise when to come back
    retry_after: float | None = None

    def __init__(self, message: str = "") -> None:
        super().__init__(message or self.__class__.default_message())
        self.message = message or self.__class__.default_message()

    @classmethod
    def default_message(cls) -> str:
        return "internal server error"

    def response_fields(self) -> dict[str, Any] | None:
        """Extra fields of the error payload; None for none."""
        return None

    def response_headers(self) -> dict[str, str]:
        if self.retry_after is not None:
            return {"Retry-After": str(max(1, math.ceil(self.retry_after)))}
        return {}


class ErrorServiceUnavailable(HTTPError):
    """503: the engine is draining or stopped; retry on another replica."""

    status_code = 503

    def __init__(self, message: str = "", *, retry_after: float | None = None) -> None:
        super().__init__(message)
        self.retry_after = retry_after

    @classmethod
    def default_message(cls) -> str:
        return "service unavailable"


class ErrorTooManyRequests(HTTPError):
    """429: the admission queue is full, or the shed estimator predicts a
    wait past the request's deadline or the configured threshold.
    ``retry_after`` is the predicted queue wait."""

    status_code = 429

    def __init__(self, message: str = "", *, retry_after: float | None = None) -> None:
        super().__init__(message)
        self.retry_after = retry_after

    def response_fields(self) -> dict[str, Any] | None:
        if self.retry_after is not None:
            return {"retry_after_s": round(self.retry_after, 3)}
        return None

    @classmethod
    def default_message(cls) -> str:
        return "server overloaded, retry later"


class ErrorRequestEntityTooLarge(HTTPError):
    """413: the request can never be served by this configuration (a
    prompt needing more KV pages than the whole pool holds). Not a 429,
    which would invite a retry of a permanent condition; no
    ``Retry-After``."""

    status_code = 413

    @classmethod
    def default_message(cls) -> str:
        return "request exceeds this replica's serving capacity"


class ErrorDeadlineExceeded(HTTPError):
    """504: the caller's deadline passed while the request was still
    queued. A request past its deadline mid-stream resolves normally, with
    finish reason ``deadline_exceeded``."""

    status_code = 504

    @classmethod
    def default_message(cls) -> str:
        return "deadline exceeded before completion"
