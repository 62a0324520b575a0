"""Thread-safe name->instrument store (port of ``gofr_tpu/metrics/store.py``;
no device state, copied as it is so the port imports nothing of the JAX
package)."""

from __future__ import annotations

import threading
from typing import Any


class MetricsError(Exception):
    pass


class Store:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._instruments: dict[str, Any] = {}

    def register(self, name: str, instrument: Any) -> None:
        with self._lock:
            if name in self._instruments:
                raise MetricsError(f"metric {name} already registered")
            self._instruments[name] = instrument

    def get(self, name: str) -> Any:
        with self._lock:
            inst = self._instruments.get(name)
        if inst is None:
            raise MetricsError(f"metric {name} is not registered")
        return inst

    def try_get(self, name: str) -> Any | None:
        with self._lock:
            return self._instruments.get(name)

    def all(self) -> list[Any]:
        with self._lock:
            return list(self._instruments.values())
