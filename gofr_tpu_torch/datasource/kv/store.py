"""Embedded KV stores implementing the KVStore contract
(container/datasources.go:366-378): get/set/delete + health.

The port's copy of ``gofr_tpu/datasource/kv/store.py``; it imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any


class KVError(KeyError):
    pass


class InMemoryKVStore:
    def __init__(self) -> None:
        self._data: dict[str, str] = {}
        self._lock = threading.Lock()

    def use_logger(self, logger: Any) -> None:
        pass

    def use_metrics(self, metrics: Any) -> None:
        pass

    def use_tracer(self, tracer: Any) -> None:
        pass

    def connect(self) -> None:
        pass

    def get(self, key: str) -> str:
        with self._lock:
            if key not in self._data:
                raise KVError(key)
            return self._data[key]

    def set(self, key: str, value: str) -> None:
        with self._lock:
            self._data[key] = value

    def delete(self, key: str) -> None:
        with self._lock:
            self._data.pop(key, None)

    def close(self) -> None:
        pass

    def health_check(self) -> dict[str, Any]:
        return {"status": "UP", "details": {"backend": "memory", "keys": len(self._data)}}


class FileKVStore(InMemoryKVStore):
    """Persistent embedded store (badger analogue, kv-store/badger): an
    append-free JSON snapshot flushed on every write — small-state durability
    (weight-cache bookkeeping, migration versions), not a log-structured DB."""

    def __init__(self, path: str = "./kv_store.json") -> None:
        super().__init__()
        self.path = path

    def connect(self) -> None:
        try:
            with open(self.path, encoding="utf-8") as f:
                self._data = {str(k): str(v) for k, v in json.load(f).items()}
        except (OSError, json.JSONDecodeError):
            self._data = {}

    def _flush(self) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(self._data, f)
        os.replace(tmp, self.path)

    def set(self, key: str, value: str) -> None:
        with self._lock:
            self._data[key] = value
            self._flush()

    def delete(self, key: str) -> None:
        with self._lock:
            self._data.pop(key, None)
            self._flush()

    def health_check(self) -> dict[str, Any]:
        return {"status": "UP", "details": {"backend": "file", "path": self.path, "keys": len(self._data)}}


class TTLKVStore(InMemoryKVStore):
    """DynamoDB-flavored KV: per-key time-to-live with lazy expiry
    (reference: datasource/kv-store/dynamodb — the managed-TTL analogue;
    badger's entry TTL). Keys expire on read/scan; ``purge()`` sweeps."""

    def __init__(self, default_ttl: float | None = None) -> None:
        super().__init__()
        self.default_ttl = default_ttl
        self._expires: dict[str, float] = {}

    @classmethod
    def from_config(cls, config: Any) -> "TTLKVStore":
        ttl = config.get("KV_DEFAULT_TTL_SECONDS")
        # 0 (and negatives) mean "no expiry" — the common config convention
        return cls(float(ttl) if ttl and float(ttl) > 0 else None)

    def _expired(self, key: str) -> bool:
        import time

        deadline = self._expires.get(key)
        return deadline is not None and time.monotonic() >= deadline

    def set(self, key: str, value: str, ttl: float | None = None) -> None:
        import time

        with self._lock:
            self._data[key] = value
            ttl = ttl if ttl is not None else self.default_ttl
            if ttl is not None:
                self._expires[key] = time.monotonic() + ttl
            else:
                self._expires.pop(key, None)

    def get(self, key: str) -> str:
        with self._lock:
            if key in self._data and self._expired(key):
                del self._data[key]
                del self._expires[key]
            if key not in self._data:
                raise KVError(key)
            return self._data[key]

    def delete(self, key: str) -> None:
        with self._lock:
            self._data.pop(key, None)
            self._expires.pop(key, None)

    def purge(self) -> int:
        """Remove all expired keys; returns the count (cron-able sweep)."""
        with self._lock:
            dead = [k for k in self._data if self._expired(k)]
            for k in dead:
                del self._data[k]
                del self._expires[k]
            return len(dead)

    def health_check(self) -> dict[str, Any]:
        with self._lock:
            return {
                "status": "UP",
                "details": {
                    "backend": "ttl-memory",
                    "keys": len(self._data),
                    "keys_with_ttl": len(self._expires),
                },
            }
