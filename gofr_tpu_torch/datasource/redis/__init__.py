"""Redis datasource.

Reference parity: pkg/gofr/datasource/redis/ — go-redis client with per-
command QUERY logs + ``app_redis_stats`` histogram (redis/hook.go), tracing
(redis.go:60-64), health (redis/health.go). This build ships its own RESP2
socket client (no vendor lib in the image) plus an in-memory fake with TTL
semantics for tests (the redismock/miniredis analogue).

The port's copy of ``gofr_tpu/datasource/redis/__init__.py``; it imports nothing of the JAX package.
"""

from gofr_tpu_torch.datasource.redis.client import RedisClient, new_redis
from gofr_tpu_torch.datasource.redis.memory import InMemoryRedis

__all__ = ["RedisClient", "new_redis", "InMemoryRedis"]
