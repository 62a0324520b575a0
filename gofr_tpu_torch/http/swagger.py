"""Swagger / OpenAPI rendering (a copy of ``gofr_tpu/http/swagger.py``, with
its own copy of the UI asset).

Reference parity: pkg/gofr/swagger.go:15-70 + pkg/gofr/static/ — when
``./static/openapi.json`` exists it is served at
``/.well-known/openapi.json`` and an **embedded** UI at
``/.well-known/swagger``. The UI asset (http/static/swagger_ui.html) is
a fully self-contained vanilla-JS OpenAPI explorer — grouped operations,
parameter/schema tables, sample bodies resolved through ``$ref``, and
try-it-out execution — shipped in the package like the reference's
go:embed bundle; no CDN or external fetch is ever made."""

from __future__ import annotations

import functools
import json
import os
from typing import Any, Callable

from gofr_tpu_torch.http.response import File, Raw

_UI_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "static", "swagger_ui.html")


@functools.lru_cache(maxsize=1)
def swagger_ui_html() -> bytes:
    # immutable at runtime — load once, like go:embed
    with open(_UI_PATH, "rb") as f:
        return f.read()


def swagger_handlers(spec_path: str) -> tuple[Callable, Callable]:
    def spec_handler(ctx: Any) -> Any:
        with open(spec_path, encoding="utf-8") as f:
            return Raw(json.load(f))

    def ui_handler(ctx: Any) -> Any:
        return File(content=swagger_ui_html(), content_type="text/html")

    return spec_handler, ui_handler
