"""HTTP router with path templates and per-route middleware (a copy of
``gofr_tpu/http/router.py`` without static files, which are not ported).

Reference parity: pkg/gofr/http/router.go — route registration wrapped in
tracing (:46-49), registered-method tracking for CORS (:29-48).
Pattern syntax is the reference's mux style: ``/user/{id}`` path parameters
plus a trailing wildcard ``/files/{path...}``.
"""

from __future__ import annotations

import re
from typing import Any, Callable

WELL_KNOWN_PREFIX = "/.well-known"


class Route:
    def __init__(self, method: str, pattern: str, handler: Any) -> None:
        self.method = method.upper()
        self.pattern = pattern
        self.handler = handler
        self.regex, self.param_names = _compile(pattern)

    def match(self, path: str) -> dict[str, str] | None:
        m = self.regex.match(path)
        if not m:
            return None
        return {name: m.group(name) for name in self.param_names}


def _compile(pattern: str) -> tuple[re.Pattern, list[str]]:
    parts: list[str] = []
    names: list[str] = []
    i = 0
    for seg in pattern.split("/"):
        if not seg:
            continue
        i += 1
        if seg.startswith("{") and seg.endswith("...}"):
            name = seg[1:-4]
            names.append(name)
            parts.append(f"(?P<{name}>.+)")
        elif seg.startswith("{") and seg.endswith("}"):
            name = seg[1:-1]
            names.append(name)
            parts.append(f"(?P<{name}>[^/]+)")
        else:
            parts.append(re.escape(seg))
    body = "/".join(parts)
    regex = re.compile("^/" + body + "/?$" if body else "^/$")
    return regex, names


class Router:
    """Method+path router. Middlewares registered via ``use_middleware`` wrap
    the matched handler outermost-first, mirroring the reference's chain
    (http_server.go:36-41)."""

    def __init__(self) -> None:
        self.routes: list[Route] = []
        self.middlewares: list[Callable] = []

    def add(self, method: str, pattern: str, handler: Any) -> None:
        self.routes.append(Route(method, pattern, handler))

    def use_middleware(self, *mws: Callable) -> None:
        self.middlewares.extend(mws)

    def registered_methods(self, path: str | None = None) -> list[str]:
        """Methods registered (optionally for one path) — feeds CORS
        Access-Control-Allow-Methods (router.go:29-48)."""
        methods = {
            r.method
            for r in self.routes
            if path is None or r.match(path) is not None
        }
        return sorted(methods)

    def lookup(self, method: str, path: str) -> tuple[Any, dict[str, str]] | None:
        for r in self.routes:
            if r.method != method.upper():
                continue
            params = r.match(path)
            if params is not None:
                return r.handler, params
        return None

    def path_exists(self, path: str) -> bool:
        return any(r.match(path) is not None for r in self.routes)

    def route_template(self, method: str, path: str) -> str | None:
        """The registered pattern a path matched — used as the low-cardinality
        metric label (middleware/metrics.go path templating)."""
        for r in self.routes:
            if r.method == method.upper() and r.match(path) is not None:
                return r.pattern
        return None
