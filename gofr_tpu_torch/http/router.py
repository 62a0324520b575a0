"""HTTP router with path templates, per-route middleware, static files (a
copy of ``gofr_tpu/http/router.py``).

Reference parity: pkg/gofr/http/router.go — route registration wrapped in
tracing (:46-49), registered-method tracking for CORS (:29-48), static file
serving with 404.html support and the openapi.json restriction (:66-113).
Pattern syntax is the reference's mux style: ``/user/{id}`` path parameters
plus a trailing wildcard ``/static/{path...}``.
"""

from __future__ import annotations

import os
import re
from typing import Any, Callable

WELL_KNOWN_PREFIX = "/.well-known"
DEFAULT_SWAGGER_FILE = "openapi.json"


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
        self._static_dirs: list[tuple[str, str]] = []  # (url_prefix, fs_dir)

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

    def add_static_files(self, url_prefix: str, fs_dir: str) -> None:
        """Serve a directory (router.go:66-78). openapi.json is only served
        via /.well-known/openapi.json, and a 404.html in the directory is
        used for missing files (router.go:92-113)."""
        self._static_dirs.append((url_prefix.rstrip("/"), os.path.abspath(fs_dir)))

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

    def static_lookup(self, path: str) -> tuple[str, str] | None:
        """Resolve a static file. Returns (file_path, disposition) where
        disposition is 'ok' | 'not_found_page' | 'forbidden'."""
        for prefix, fs_dir in self._static_dirs:
            if not path.startswith(prefix + "/") and path != prefix:
                continue
            rel = path[len(prefix):].lstrip("/") or "index.html"
            if os.path.basename(rel) == DEFAULT_SWAGGER_FILE:
                return os.path.join(fs_dir, rel), "forbidden"
            full = os.path.normpath(os.path.join(fs_dir, rel))
            if not full.startswith(fs_dir + os.sep):
                # path traversal; the separator keeps a sibling directory
                # that shares the prefix (``static2`` beside ``static``) out
                continue
            if os.path.isfile(full):
                return full, "ok"
            fallback = os.path.join(fs_dir, "404.html")
            if os.path.isfile(fallback):
                return fallback, "not_found_page"
        return None
