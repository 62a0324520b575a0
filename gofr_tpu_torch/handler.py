"""Transport-agnostic handler execution (a copy of ``gofr_tpu/handler.py``).

Reference parity: pkg/gofr/handler.go — ``Handler func(*Context)(any,error)``
(handler.go:25) becomes "a callable taking Context returning a result (or
raising)". ``execute_handler`` reproduces ServeHTTP's semantics
(handler.go:55-113): the user function runs isolated (worker thread for sync
handlers — the analogue of the reference's per-request goroutine — or as an
awaitable for async handlers), raced against the request timeout
(``REQUEST_TIMEOUT``) and client disconnect; panics are caught and become
ErrorPanicRecovery with a logged stack. ``health_handler`` / ``alive`` and
the catch-all 404 mirror handler.go:115-151.
"""

from __future__ import annotations

import asyncio
import traceback
from typing import Any, Awaitable, Callable

from gofr_tpu_torch.context import Context
from gofr_tpu_torch.http.errors import (
    ErrorInvalidRoute,
    ErrorPanicRecovery,
    ErrorRequestTimeout,
)

Handler = Callable[[Context], Any]


class HandlerResult:
    __slots__ = ("data", "error")

    def __init__(self, data: Any = None, error: BaseException | None = None) -> None:
        self.data = data
        self.error = error


async def execute_handler(
    handler: Handler,
    ctx: Context,
    timeout: float | None = None,
) -> HandlerResult:
    """Run a handler with timeout + panic isolation (handler.go:55-113)."""

    async def invoke() -> Any:
        result = handler(ctx)
        if isinstance(result, Awaitable):
            result = await result
        return result

    loop = asyncio.get_running_loop()
    if asyncio.iscoroutinefunction(handler):
        task: Any = asyncio.ensure_future(invoke())
    else:
        # Sync handlers run in the default executor so a blocking TPU call
        # (or DB query) never stalls the event loop — the reference's
        # dedicated goroutine per request (handler.go:78-86).
        def call() -> Any:
            return handler(ctx)

        task = loop.run_in_executor(None, call)

    try:
        if timeout is not None and timeout > 0:
            data = await asyncio.wait_for(asyncio.shield(task), timeout)
        else:
            data = await task
        return HandlerResult(data=data)
    except asyncio.TimeoutError:
        ctx.cancel()
        # like the reference, the in-flight worker cannot be force-killed; it
        # is left to finish against a canceled context (handler.go:88-95)
        task.cancel()
        return HandlerResult(error=ErrorRequestTimeout())
    except asyncio.CancelledError:
        raise
    except Exception as exc:
        if _is_user_error(exc):
            return HandlerResult(error=exc)
        ctx.logger.error(
            f"panic recovered: {exc}",
            stack=traceback.format_exc(limit=20),
        )
        return HandlerResult(error=ErrorPanicRecovery())


def _is_user_error(exc: BaseException) -> bool:
    """Typed errors (anything carrying status_code or log_level) are
    deliberate handler returns; bare exceptions are treated as panics
    (handler.go:88-104 maps goroutine panics to 500)."""
    return hasattr(exc, "status_code") or hasattr(exc, "log_level")


def health_handler(ctx: Context) -> Any:
    """/.well-known/health (handler.go:115-117)."""
    return ctx.container.health()


def alive_handler(ctx: Context) -> Any:
    """/.well-known/alive (handler.go:119-123)."""
    return {"status": "UP"}


def catch_all_handler(ctx: Context) -> Any:
    """404 for unregistered routes (handler.go:137-151)."""
    raise ErrorInvalidRoute()
