"""Route dispatch: wire request → Context → handler → wire response (a copy
of ``gofr_tpu/http/dispatch.py``).

This is the glue the reference spreads across http_server.go:36-59 and
handler.go:55-113: router lookup (static files, the catch-all 404 and the
405), Context construction, timeout from ``REQUEST_TIMEOUT``, the draining
503, and rendering through the Responder.
"""

from __future__ import annotations

import asyncio
import mimetypes
from typing import Any

from gofr_tpu_torch.context import Context
from gofr_tpu_torch.handler import catch_all_handler, execute_handler
from gofr_tpu_torch.http.responder import Responder, WireResponse, draining_response
from gofr_tpu_torch.http.router import Router


class Dispatcher:
    def __init__(self, router: Router, container: Any, request_timeout: float | None = None) -> None:
        self.router = router
        self.container = container
        self.responder = Responder()
        self.request_timeout = request_timeout

    # probe routes stay served while draining so load balancers can SEE the
    # DRAINING state instead of inferring it from connection errors
    _DRAIN_EXEMPT = ("/.well-known/health", "/.well-known/alive")

    async def __call__(self, req: Any) -> WireResponse:
        if getattr(self.container, "draining", False) and req.path not in self._DRAIN_EXEMPT:
            return draining_response()
        # static files first-match after routes (router.go:66-78)
        match = self.router.lookup(req.method, req.path)
        if match is None:
            static = self.router.static_lookup(req.path)
            if static is not None:
                return await self._serve_static(static)
            if req.method == "HEAD":
                match_get = self.router.lookup("GET", req.path)
                if match_get is not None:
                    match = match_get
        if match is None:
            if self.router.path_exists(req.path):
                return WireResponse(
                    status=405,
                    headers={"Content-Type": "application/json"},
                    body=b'{"error":{"message":"method not allowed"}}',
                )
            handler, params = catch_all_handler, {}
        else:
            handler, params = match
        req.path_params = params

        ctx = Context(req, self.container, self.responder)
        result = await execute_handler(handler, ctx, self.request_timeout)

        if isinstance(result.data, WireResponse):  # raw wire responses (streams)
            return result.data
        return self.responder.respond(result.data, result.error, req.method)

    async def _serve_static(self, static: tuple[str, str]) -> WireResponse:
        path, disposition = static
        if disposition == "forbidden":
            return WireResponse(status=403, body=b"403 forbidden")
        ctype = mimetypes.guess_type(path)[0] or "application/octet-stream"

        def _read() -> bytes:  # sync file I/O runs off the event loop
            with open(path, "rb") as f:
                return f.read()

        try:
            content = await asyncio.get_running_loop().run_in_executor(None, _read)
        except OSError:
            return WireResponse(status=404, body=b"404 not found")
        status = 200 if disposition == "ok" else 404
        return WireResponse(status=status, headers={"Content-Type": ctype}, body=content)
