"""In-memory Redis fake with TTL semantics (miniredis analogue for tests).

The port's copy of ``gofr_tpu/datasource/redis/memory.py``; it imports nothing of the JAX package.
"""

from __future__ import annotations

import threading
import time
from typing import Any


class InMemoryRedis:
    def __init__(self) -> None:
        self._data: dict[str, Any] = {}
        self._hashes: dict[str, dict[str, str]] = {}
        self._expiry: dict[str, float] = {}
        self._lock = threading.RLock()

    # provider pattern no-ops (fake is always "connected")
    def use_logger(self, logger: Any) -> None:
        pass

    def use_metrics(self, metrics: Any) -> None:
        pass

    def use_tracer(self, tracer: Any) -> None:
        pass

    def connect(self) -> None:
        pass

    def _expired(self, key: str) -> bool:
        exp = self._expiry.get(key)
        if exp is not None and time.monotonic() >= exp:
            self._data.pop(key, None)
            self._hashes.pop(key, None)
            self._expiry.pop(key, None)
            return True
        return False

    def get(self, key: str) -> str | None:
        with self._lock:
            if self._expired(key):
                return None
            val = self._data.get(key)
            return None if val is None else str(val)

    def set(self, key: str, value: Any, ttl_seconds: float | None = None) -> bool:
        with self._lock:
            self._data[key] = str(value)
            if ttl_seconds is not None:
                self._expiry[key] = time.monotonic() + ttl_seconds
            else:
                self._expiry.pop(key, None)
            return True

    def delete(self, *keys: str) -> int:
        with self._lock:
            n = 0
            for k in keys:
                if k in self._data or k in self._hashes:
                    self._data.pop(k, None)
                    self._hashes.pop(k, None)
                    self._expiry.pop(k, None)
                    n += 1
            return n

    def exists(self, *keys: str) -> int:
        with self._lock:
            return sum(
                1 for k in keys if not self._expired(k) and (k in self._data or k in self._hashes)
            )

    def incr(self, key: str) -> int:
        with self._lock:
            self._expired(key)
            val = int(self._data.get(key, "0")) + 1
            self._data[key] = str(val)
            return val

    def hset(self, key: str, field: str, value: Any) -> int:
        with self._lock:
            h = self._hashes.setdefault(key, {})
            created = 0 if field in h else 1
            h[field] = str(value)
            return created

    def hget(self, key: str, field: str) -> str | None:
        with self._lock:
            if self._expired(key):
                return None
            return self._hashes.get(key, {}).get(field)

    def hgetall(self, key: str) -> dict[str, str]:
        with self._lock:
            if self._expired(key):
                return {}
            return dict(self._hashes.get(key, {}))

    def expire(self, key: str, ttl_seconds: float) -> bool:
        with self._lock:
            if key in self._data or key in self._hashes:
                self._expiry[key] = time.monotonic() + ttl_seconds
                return True
            return False

    def ttl(self, key: str) -> float:
        with self._lock:
            if self._expired(key) or key not in self._expiry:
                return -1.0
            return max(0.0, self._expiry[key] - time.monotonic())

    def ping(self) -> bool:
        return True

    def close(self) -> None:
        pass

    def health_check(self) -> dict[str, Any]:
        return {"status": "UP", "details": {"backend": "in-memory"}}
