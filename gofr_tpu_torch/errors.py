"""Typed errors of the request lifecycle (a copy of what the serving engine
raises from ``gofr_tpu/http/errors.py``, and the service client's
``CircuitBreakerError``; the port imports nothing of the JAX package).

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


class ErrorInvalidParam(HTTPError):
    """400: a client error in the named parameters (an unknown LoRA
    adapter, an adapter on an engine without a registry, an empty prompt
    or a prompt token outside the vocabulary, a negative
    ``max_new_tokens``); never retriable."""

    status_code = 400

    def __init__(self, *params: str) -> None:
        self.params = list(params)
        super().__init__(f"'{len(self.params)}' invalid parameter(s): {', '.join(self.params)}")


class ErrorEntityNotFound(HTTPError):
    """404: nothing under that name (a resume of an idempotency key this
    replica never saw, or whose replay window lost the frames asked for)."""

    status_code = 404

    def __init__(self, name: str = "entity", value: str = "") -> None:
        self.name, self.value = name, value
        super().__init__(f"No entity found with {name}: {value}")


class ErrorStaleEpoch(HTTPError):
    """409: the caller presented a fence epoch that is not the replica's
    current one. It acts on a view from before a ``warm_restart``, so its
    view of the scheduler, the KV residency and the request registry is
    stale. Not retriable as it stands: the caller refreshes its view (the
    heartbeat carries the current epoch) first."""

    status_code = 409

    @classmethod
    def default_message(cls) -> str:
        return "stale fence epoch; refresh membership and retry"


class CircuitBreakerError(Exception):
    """503: an inter-replica circuit breaker is open, so the replica behind
    it is treated as gone (a copy of ``gofr_tpu/service/options.py``'s;
    the router's failover counts it retriable)."""

    status_code = 503

    def __init__(self, address: str) -> None:
        super().__init__(f"circuit breaker open for {address}")
