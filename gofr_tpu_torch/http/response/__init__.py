"""Response wrapper types rendered by the Responder (a copy of
``gofr_tpu/http/response``).

Reference parity: pkg/gofr/http/response/{file,raw,redirect,template,
response}.go — returning one of these from a handler short-circuits the
default JSON envelope.
"""

from __future__ import annotations

import dataclasses
import string
from typing import Any


@dataclasses.dataclass
class Response:
    """JSON envelope with metadata and custom headers
    (response/response.go)."""

    data: Any = None
    metadata: dict[str, Any] | None = None
    headers: dict[str, str] | None = None


@dataclasses.dataclass
class Raw:
    """Marshal ``data`` as-is, without the {"data": ...} envelope
    (response/raw.go)."""

    data: Any = None


@dataclasses.dataclass
class File:
    """Binary body with content type (response/file.go)."""

    content: bytes = b""
    content_type: str = "application/octet-stream"


@dataclasses.dataclass
class Redirect:
    """302 redirect (response/redirect.go)."""

    url: str = "/"


@dataclasses.dataclass
class Template:
    """Render ``$variable``-substituted template file from ./templates
    (response/template.go; html/template swapped for string.Template)."""

    data: dict[str, Any] | None = None
    name: str = ""
    directory: str = "./templates"

    def render(self) -> str:
        with open(f"{self.directory}/{self.name}", encoding="utf-8") as f:
            tpl = string.Template(f.read())
        return tpl.safe_substitute(self.data or {})
