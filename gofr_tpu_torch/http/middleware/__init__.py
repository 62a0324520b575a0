"""HTTP middleware chain of the port's app (a copy of
``gofr_tpu/http/middleware``): registered in the order Tracer → Logging →
CORS → Metrics (http_server.go:36-41). A middleware is
``Callable[[next_handler], handler]`` over async wire handlers. The auth
middlewares (basic, API key, OAuth/JWT) are not ported."""

from gofr_tpu_torch.http.middleware.core import (
    CORSConfig,
    Middleware,
    WireHandler,
    chain,
    cors_middleware,
    logging_middleware,
    metrics_middleware,
    tracing_middleware,
)

__all__ = [
    "CORSConfig",
    "Middleware",
    "WireHandler",
    "chain",
    "tracing_middleware",
    "logging_middleware",
    "cors_middleware",
    "metrics_middleware",
]
