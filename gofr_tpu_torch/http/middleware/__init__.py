"""HTTP middleware chain of the port's app (a copy of
``gofr_tpu/http/middleware``): registered in the order Tracer → Logging →
CORS → Metrics (http_server.go:36-41), then optional auth (basic, API key,
OAuth/JWT) and the WebSocket upgrade. A middleware is
``Callable[[next_handler], handler]`` over async wire handlers."""

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
from gofr_tpu_torch.http.middleware.auth import (
    AuthProvider,
    api_key_auth_middleware,
    auth_middleware,
    basic_auth_middleware,
    oauth_middleware,
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
    "AuthProvider",
    "auth_middleware",
    "basic_auth_middleware",
    "api_key_auth_middleware",
    "oauth_middleware",
]
