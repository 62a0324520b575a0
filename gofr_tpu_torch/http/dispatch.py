"""Route dispatch: wire request → Context → handler → wire response (a copy
of ``gofr_tpu/http/dispatch.py`` without static files).

This is the glue the reference spreads across http_server.go:36-59 and
handler.go:55-113: router lookup (the catch-all 404 and the 405), Context
construction, timeout from ``REQUEST_TIMEOUT``, the draining 503, and
rendering through the Responder.
"""

from __future__ import annotations

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
        match = self.router.lookup(req.method, req.path)
        if match is None:
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
