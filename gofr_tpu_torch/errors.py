"""The typed errors of the request lifecycle, under the names the serving
modules import: re-exports of ``gofr_tpu_torch.http.errors`` (each carries
its HTTP status and log level, and a retriable rejection its
``retry_after``) and of the service client's ``CircuitBreakerError``. One
class hierarchy: what the engine raises is what the responder renders and
what ``serving/remote.error_from_status`` rebuilds from a status."""

from gofr_tpu_torch.http.errors import (
    ErrorDeadlineExceeded,
    ErrorEntityNotFound,
    ErrorInvalidParam,
    ErrorRequestEntityTooLarge,
    ErrorServiceUnavailable,
    ErrorStaleEpoch,
    ErrorTooManyRequests,
    HTTPError,
)
from gofr_tpu_torch.service.options import CircuitBreakerError

__all__ = [
    "CircuitBreakerError", "ErrorDeadlineExceeded", "ErrorEntityNotFound", "ErrorInvalidParam",
    "ErrorRequestEntityTooLarge", "ErrorServiceUnavailable", "ErrorStaleEpoch",
    "ErrorTooManyRequests", "HTTPError",
]
