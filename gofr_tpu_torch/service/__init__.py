"""Inter-service HTTP client of the port (a copy of ``gofr_tpu/service``).

Base client with per-request span, trace propagation, structured log +
``app_http_service_response`` histogram (service/new.go:136-210), and an
Options decorator chain (service/options.go:3-5): circuit breaker
(circuit_breaker.go:24-157), retry (retry.go:96-109), basic/API-key/OAuth
auth, default headers, custom health (health_config.go:5-31).
"""

from gofr_tpu_torch.service.client import (
    HTTPService,
    ServiceResponse,
    StreamingServiceResponse,
    new_http_service,
)
from gofr_tpu_torch.service.options import (
    APIKeyConfig,
    BasicAuthConfig,
    CircuitBreaker,
    CircuitBreakerConfig,
    CircuitBreakerError,
    DefaultHeaders,
    HealthConfig,
    OAuthConfig,
    Retry,
    RetryConfig,
    retry_after_from_headers,
)

__all__ = [
    "HTTPService",
    "ServiceResponse",
    "StreamingServiceResponse",
    "new_http_service",
    "CircuitBreaker",
    "CircuitBreakerConfig",
    "CircuitBreakerError",
    "Retry",
    "RetryConfig",
    "retry_after_from_headers",
    "BasicAuthConfig",
    "APIKeyConfig",
    "OAuthConfig",
    "DefaultHeaders",
    "HealthConfig",
]
