"""HTTP plumbing of the port's app (a copy of ``gofr_tpu/http``): typed
errors, the request and its body binding, the responder, the router, the
asyncio HTTP/1.1 server and the dispatcher. Static files, swagger and the
auth middleware are not ported."""

from gofr_tpu_torch.http.errors import (
    ErrorClientClosedRequest,
    ErrorDeadlineExceeded,
    ErrorEntityAlreadyExist,
    ErrorEntityNotFound,
    ErrorInvalidParam,
    ErrorInvalidRoute,
    ErrorMissingParam,
    ErrorPanicRecovery,
    ErrorRequestEntityTooLarge,
    ErrorRequestTimeout,
    ErrorServiceUnavailable,
    ErrorStaleEpoch,
    ErrorTooManyRequests,
    ErrorValidation,
    HTTPError,
)
from gofr_tpu_torch.http.request import Request, UploadedFile
from gofr_tpu_torch.http.responder import Responder, WireResponse
from gofr_tpu_torch.http.router import Router

__all__ = [
    "HTTPError",
    "ErrorInvalidRoute",
    "ErrorEntityNotFound",
    "ErrorEntityAlreadyExist",
    "ErrorInvalidParam",
    "ErrorMissingParam",
    "ErrorValidation",
    "ErrorRequestTimeout",
    "ErrorClientClosedRequest",
    "ErrorPanicRecovery",
    "ErrorServiceUnavailable",
    "ErrorTooManyRequests",
    "ErrorRequestEntityTooLarge",
    "ErrorStaleEpoch",
    "ErrorDeadlineExceeded",
    "Request",
    "UploadedFile",
    "Responder",
    "WireResponse",
    "Router",
]
