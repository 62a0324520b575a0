"""HTTP Request implementation: params, path params, body binding (a copy of
``gofr_tpu/http/request.py``).

Reference parity: pkg/gofr/http/request.go — the Request interface
(request.go:29-32), JSON / multipart / x-www-form-urlencoded / binary body
binding (request.go:58-79, form_data_binder.go, multipart_file_bind.go), the
32 MB multipart memory cap (request.go:18), and hostname/params accessors.

Binding targets: ``dict`` (raw), dataclass types, or plain classes with
annotated fields. Form values are coerced to the annotated type (int, float,
bool, list) like the reference's reflect-based form mapper.
"""

from __future__ import annotations

import dataclasses
import io
import json
import typing
import urllib.parse
from email.parser import BytesParser
from email.policy import HTTP as HTTP_POLICY
from typing import Any

MAX_MULTIPART_MEMORY = 32 << 20  # 32 MB (request.go:18)


@dataclasses.dataclass
class UploadedFile:
    """A bound multipart file (multipart_file_bind.go)."""

    filename: str
    content_type: str
    content: bytes

    def read(self) -> bytes:
        return self.content

    def open(self) -> io.BytesIO:
        return io.BytesIO(self.content)


from gofr_tpu_torch.http.errors import HTTPError
from gofr_tpu_torch.logging.level import Level


class BindError(HTTPError):
    """Body-binding failures are client errors (400), like the reference's
    Bind error mapping (http/request.go:58-79)."""

    status_code = 400
    level = Level.INFO


class Request:
    """Adapts a raw HTTP request to the framework's Request contract
    (pkg/gofr/request.go:10-17): ``context``, ``param``, ``path_param``,
    ``bind``, ``host_name``."""

    def __init__(
        self,
        method: str,
        path: str,
        query: dict[str, list[str]],
        headers: dict[str, str],
        body: bytes,
        path_params: dict[str, str] | None = None,
        remote_addr: str = "",
    ) -> None:
        self.method = method.upper()
        self.path = path
        self.query = query
        self.headers = {k.lower(): v for k, v in headers.items()}
        self.body = body
        self.path_params = path_params or {}
        self.remote_addr = remote_addr

    # -- accessors (request.go:10-17) ----------------------------------------
    def param(self, key: str) -> str:
        vals = self.query.get(key)
        return vals[0] if vals else ""

    def params(self, key: str) -> list[str]:
        out: list[str] = []
        for v in self.query.get(key, []):
            out.extend(p for p in v.split(",") if p != "")
        return out

    def path_param(self, key: str) -> str:
        return self.path_params.get(key, "")

    def header(self, key: str) -> str:
        return self.headers.get(key.lower(), "")

    def host_name(self) -> str:
        proto = self.headers.get("x-forwarded-proto", "http")
        return f"{proto}://{self.headers.get('host', '')}"

    @property
    def content_type(self) -> str:
        return self.headers.get("content-type", "").split(";")[0].strip().lower()

    # -- binding (request.go:58-79) ------------------------------------------
    def bind(self, target: Any) -> Any:
        ct = self.content_type
        if ct == "application/json" or (not ct and self.body[:1] in (b"{", b"[")):
            return self._bind_json(target)
        if ct == "multipart/form-data":
            return self._bind_fields(self._parse_multipart(), target)
        if ct == "application/x-www-form-urlencoded":
            fields = {
                k: (vs[0] if len(vs) == 1 else vs)
                for k, vs in urllib.parse.parse_qs(
                    self.body.decode("utf-8", "replace"), keep_blank_values=True
                ).items()
            }
            return self._bind_fields(fields, target)
        if ct in ("application/octet-stream", "text/plain"):
            return self._bind_binary(target)
        raise BindError(f"unsupported Content-Type: {ct or '(none)'}")

    def _bind_json(self, target: Any) -> Any:
        try:
            data = json.loads(self.body.decode("utf-8")) if self.body else None
        except (json.JSONDecodeError, UnicodeDecodeError) as exc:
            raise BindError(f"invalid JSON body: {exc}") from exc
        if target is dict or target is None:
            return data
        if isinstance(target, dict):
            target.clear()
            if isinstance(data, dict):
                target.update(data)
            return target
        if isinstance(data, dict):
            return _construct(target, data)
        raise BindError("JSON body must be an object to bind into a struct")

    def _bind_binary(self, target: Any) -> Any:
        if target is bytes or target is None:
            return self.body
        if target is str:
            return self.body.decode("utf-8", "replace")
        raise BindError("binary body binds to bytes or str")

    def _parse_multipart(self) -> dict[str, Any]:
        if len(self.body) > MAX_MULTIPART_MEMORY:
            raise BindError("multipart body exceeds 32 MB limit")
        raw_ct = self.headers.get("content-type", "")
        header = (
            b"Content-Type: " + raw_ct.encode("latin-1") + b"\r\nMIME-Version: 1.0\r\n\r\n"
        )
        msg = BytesParser(policy=HTTP_POLICY).parsebytes(header + self.body)
        fields: dict[str, Any] = {}
        for part in msg.iter_parts():
            name = part.get_param("name", header="content-disposition")
            if not name:
                continue
            filename = part.get_filename()
            payload = part.get_payload(decode=True) or b""
            if filename:
                fields[name] = UploadedFile(
                    filename=filename,
                    content_type=part.get_content_type(),
                    content=payload,
                )
            else:
                fields[name] = payload.decode("utf-8", "replace")
        return fields

    def _bind_fields(self, fields: dict[str, Any], target: Any) -> Any:
        if target is dict or target is None:
            return fields
        if isinstance(target, dict):
            target.clear()
            target.update(fields)
            return target
        return _construct(target, fields, coerce=True)


def _construct(target: Any, data: dict[str, Any], coerce: bool = False) -> Any:
    """Build an instance of ``target`` from a field dict; unknown keys are
    ignored (reflect-based mapper semantics, form_data_binder.go)."""
    cls = target if isinstance(target, type) else type(target)
    hints = typing.get_type_hints(cls) if hasattr(cls, "__annotations__") else {}
    if dataclasses.is_dataclass(cls):
        names = {f.name for f in dataclasses.fields(cls)}
        kwargs = {}
        for key, value in data.items():
            k = _match_field(key, names)
            if k is None:
                continue
            kwargs[k] = _coerce(value, hints.get(k)) if coerce else value
        try:
            obj = cls(**kwargs)
        except TypeError as exc:
            raise BindError(str(exc)) from exc
    else:
        obj = target if not isinstance(target, type) else _instantiate(cls)
        names = set(hints) | set(getattr(obj, "__dict__", {}))
        for key, value in data.items():
            k = _match_field(key, names)
            if k is None:
                continue
            setattr(obj, k, _coerce(value, hints.get(k)) if coerce else value)
    return obj


def _instantiate(cls: type) -> Any:
    try:
        return cls()
    except TypeError as exc:
        raise BindError(f"cannot instantiate {cls.__name__}: {exc}") from exc


def _match_field(key: str, names: set[str]) -> str | None:
    if key in names:
        return key
    lowered = key.lower().replace("-", "_")
    for n in names:
        if n.lower() == lowered:
            return n
    return None


def _coerce(value: Any, hint: Any) -> Any:
    if hint is None or isinstance(value, UploadedFile):
        return value
    origin = typing.get_origin(hint)
    if origin in (list, tuple):
        items = value if isinstance(value, list) else str(value).split(",")
        args = typing.get_args(hint)
        inner = args[0] if args else str
        return [_coerce(i, inner) for i in items]
    if hint is bool:
        return str(value).strip().lower() in ("1", "true", "yes", "on")
    if hint in (int, float, str):
        try:
            return hint(value)
        except (TypeError, ValueError) as exc:
            raise BindError(f"cannot convert {value!r} to {hint.__name__}") from exc
    return value
