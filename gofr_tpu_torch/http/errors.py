"""Typed HTTP errors with status codes and log levels (a copy of
``gofr_tpu/http/errors.py``). The port has one hierarchy of them: the
engine, the router's ``RETRIABLE_ERRORS``, the responder and
``serving/remote.error_from_status`` all use these classes, and
``gofr_tpu_torch.errors`` re-exports them.

Reference parity: pkg/gofr/http/errors.go (187 LoC) — ErrorInvalidRoute (404),
ErrorRequestTimeout (408), ErrorPanicRecovery (500), ErrorClientClosedRequest
(499), ErrorMissingParam, ErrorInvalidParam, ErrorEntityNotFound,
ErrorEntityAlreadyExist; errors carry both an HTTP status and the level they
log at (logging/logger.go:262-270).
"""

from __future__ import annotations

from typing import Any

from gofr_tpu_torch.logging.level import Level


class HTTPError(Exception):
    """Base for framework errors: carries status_code and log level."""

    status_code: int = 500
    level: Level = Level.ERROR

    def __init__(self, message: str = "") -> None:
        super().__init__(message or self.__class__.default_message())
        self.message = message or self.__class__.default_message()

    @classmethod
    def default_message(cls) -> str:
        return "internal server error"

    def log_level(self) -> Level:
        return self.level

    def response_fields(self) -> dict[str, Any] | None:
        """Custom error payload fields (ResponseMarshaller analogue,
        http/responder.go:163-183). Override to add fields."""
        return None

    # retriable rejections (shed, drain) advertise when to come back;
    # the Responder copies these onto the wire response
    retry_after: float | None = None

    def response_headers(self) -> dict[str, str]:
        if self.retry_after is not None:
            import math

            return {"Retry-After": str(max(1, math.ceil(self.retry_after)))}
        return {}


class ErrorInvalidRoute(HTTPError):
    status_code = 404
    level = Level.INFO

    @classmethod
    def default_message(cls) -> str:
        return "route not registered"


class ErrorEntityNotFound(HTTPError):
    status_code = 404
    level = Level.INFO

    def __init__(self, name: str = "entity", value: str = "") -> None:
        self.name, self.value = name, value
        super().__init__(f"No entity found with {name}: {value}")


class ErrorEntityAlreadyExist(HTTPError):
    status_code = 409
    level = Level.WARN

    @classmethod
    def default_message(cls) -> str:
        return "entity already exists"


class ErrorInvalidParam(HTTPError):
    status_code = 400
    level = Level.INFO

    def __init__(self, *params: str) -> None:
        self.params = list(params)
        count = len(self.params)
        super().__init__(f"'{count}' invalid parameter(s): {', '.join(self.params)}")


class ErrorMissingParam(HTTPError):
    status_code = 400
    level = Level.INFO

    def __init__(self, *params: str) -> None:
        self.params = list(params)
        count = len(self.params)
        super().__init__(f"'{count}' missing parameter(s): {', '.join(self.params)}")


class ErrorValidation(HTTPError):
    status_code = 400
    level = Level.INFO

    def __init__(self, *errors: str) -> None:
        self.errors = list(errors)
        super().__init__("validation failed: " + "; ".join(self.errors))


class ErrorRequestTimeout(HTTPError):
    status_code = 408
    level = Level.INFO

    @classmethod
    def default_message(cls) -> str:
        return "request timed out"


class ErrorClientClosedRequest(HTTPError):
    status_code = 499
    level = Level.INFO

    @classmethod
    def default_message(cls) -> str:
        return "client closed request"


class ErrorPanicRecovery(HTTPError):
    status_code = 500
    level = Level.ERROR

    @classmethod
    def default_message(cls) -> str:
        return "some unexpected error has occurred"


class ErrorServiceUnavailable(HTTPError):
    status_code = 503
    level = Level.WARN

    def __init__(self, message: str = "", *, retry_after: float | None = None) -> None:
        super().__init__(message)
        self.retry_after = retry_after

    @classmethod
    def default_message(cls) -> str:
        return "service unavailable"


class ErrorTooManyRequests(HTTPError):
    """TPU-build addition: admission control rejection when the batch queue
    is saturated (continuous-batching backpressure) or the shed estimator
    predicts the request would wait past its deadline. ``retry_after``
    (seconds) is the estimator's predicted queue wait; it reaches clients
    as a ``Retry-After`` header (HTTP) / retry-delay detail (gRPC)."""

    status_code = 429
    level = Level.WARN

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
    """TPU-build addition: the request can NEVER be served by this
    replica's configuration — a prompt needing more KV pages than the
    whole pool holds, however empty. Deliberately NOT a 429: 429 invites
    clients to retry a permanent condition forever. 413 (and gRPC
    ``FAILED_PRECONDITION``) tells them to shrink the request or find a
    bigger replica; no ``Retry-After`` is ever attached."""

    status_code = 413
    level = Level.INFO

    @classmethod
    def default_message(cls) -> str:
        return "request exceeds this replica's serving capacity"


class ErrorStaleEpoch(HTTPError):
    """HA-plane addition (docs/robustness.md "The HA plane"): the caller
    presented a fence epoch older than the replica's current one — it is
    acting on membership state from before a ``warm_restart`` /
    ``begin_reclaim`` / re-registration, so its view of this replica's
    scheduler, KV residency and request registry is stale. 409 and NOT
    retriable: a fenced zombie must refresh its membership view (the
    heartbeat gossips the current epoch), never blind-retry the same
    stale claim."""

    status_code = 409
    level = Level.WARN

    @classmethod
    def default_message(cls) -> str:
        return "stale fence epoch; refresh membership and retry"


class ErrorDeadlineExceeded(HTTPError):
    """Request-lifecycle addition: the caller's deadline passed before the
    request produced a result (expired in queue, or shed at admission after
    queueing). Mid-stream expiry instead resolves normally with finish
    reason ``deadline_exceeded``. 504: the server accepted but could not
    complete in time — distinct from 408 (client idle) and 429 (rejected
    up front)."""

    status_code = 504
    level = Level.INFO

    @classmethod
    def default_message(cls) -> str:
        return "deadline exceeded before completion"


def status_from_error(err: BaseException | None, method: str, has_data: bool) -> int:
    """Map (error, method) -> HTTP status (http/responder.go:102-159):
    no error: GET/PUT/PATCH→200, POST→201 (202 when partial), DELETE→204;
    typed errors use their own status; unknown errors → 500; data+error →
    206 partial content."""
    if err is None:
        if method == "POST":
            return 201
        if method == "DELETE":
            return 204
        return 200
    if has_data:
        return 206
    if isinstance(err, HTTPError):
        return err.status_code
    status = getattr(err, "status_code", None)
    if isinstance(status, int) and 100 <= status <= 599:
        return status
    return 500
