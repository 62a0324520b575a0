"""HTTP Responder: renders handler results into wire responses (a copy of
``gofr_tpu/http/responder.py`` over the port's tracer).

Reference parity: pkg/gofr/http/responder.go:29-99 — renders File / Template /
Redirect / Raw / Response types; status mapping from method+error
(:102-159: POST→201, DELETE→204, data+error→206 partial content); error
envelope with custom fields via ``response_fields`` (ResponseMarshaller,
:163-183); X-Correlation-ID header from the active trace
(middleware/logger.go:101).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

from gofr_tpu_torch.http import response as resp_types
from gofr_tpu_torch.http.errors import status_from_error
from gofr_tpu_torch.tracing.trace import current_span


@dataclasses.dataclass
class WireResponse:
    status: int = 200
    headers: dict[str, str] = dataclasses.field(default_factory=dict)
    body: bytes = b""
    stream: Any = None  # async iterator of bytes chunks → chunked transfer


def draining_response() -> WireResponse:
    """The one retriable-503 the server sends while draining (Retry-After,
    Connection: close, the error envelope)."""
    return WireResponse(
        status=503,
        headers={
            "Content-Type": "application/json",
            "Retry-After": "1",
            "Connection": "close",
        },
        body=b'{"error":{"message":"server draining; retry on another replica"}}',
    )


def _jsonable(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {k: _jsonable(v) for k, v in dataclasses.asdict(obj).items()}
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, bytes):
        return obj.decode("utf-8", "replace")
    if hasattr(obj, "__dict__") and not isinstance(obj, type):
        d = {k: _jsonable(v) for k, v in vars(obj).items() if not k.startswith("_")}
        if d:
            return d
    return obj


class Responder:
    """Builds the WireResponse for a (result, error) pair."""

    def respond(self, result: Any, err: BaseException | None, method: str = "GET") -> WireResponse:
        headers: dict[str, str] = {}
        span = current_span()
        if span is not None:
            headers["X-Correlation-ID"] = span.trace_id

        # unwrap Response envelope for metadata/headers
        metadata = None
        if isinstance(result, resp_types.Response):
            metadata = result.metadata
            if result.headers:
                headers.update(result.headers)
            result = result.data

        if err is None:
            special = self._render_special(result, headers, method)
            if special is not None:
                return special

        status = status_from_error(err, method, has_data=result is not None)
        envelope: dict[str, Any] = {}
        if err is not None:
            envelope["error"] = self._error_obj(err)
            hdr_fn = getattr(err, "response_headers", None)
            if callable(hdr_fn):  # Retry-After on shed/drain rejections
                headers.update(hdr_fn() or {})
        if result is not None or err is None:
            envelope["data"] = _jsonable(result)
        if metadata:
            envelope["metadata"] = _jsonable(metadata)

        if status == 204:
            return WireResponse(status=status, headers=headers)
        headers.setdefault("Content-Type", "application/json")
        body = json.dumps(envelope, default=str).encode("utf-8")
        return WireResponse(status=status, headers=headers, body=body)

    def _render_special(self, result: Any, headers: dict[str, str], method: str) -> WireResponse | None:
        if isinstance(result, resp_types.Raw):
            headers.setdefault("Content-Type", "application/json")
            return WireResponse(
                status=status_from_error(None, method, True),
                headers=headers,
                body=json.dumps(_jsonable(result.data), default=str).encode("utf-8"),
            )
        if isinstance(result, resp_types.File):
            headers["Content-Type"] = result.content_type
            return WireResponse(status=200, headers=headers, body=result.content)
        if isinstance(result, resp_types.Redirect):
            headers["Location"] = result.url
            return WireResponse(status=302, headers=headers)
        if isinstance(result, resp_types.Template):
            headers["Content-Type"] = "text/html"
            return WireResponse(status=200, headers=headers, body=result.render().encode("utf-8"))
        return None

    def _error_obj(self, err: BaseException) -> dict[str, Any]:
        obj: dict[str, Any] = {"message": str(err) or err.__class__.__name__}
        fields = getattr(err, "response_fields", None)
        if callable(fields):
            extra = fields()
            if extra:
                obj.update(_jsonable(extra))
        return obj
