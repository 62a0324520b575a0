"""Mock container: the datasources faked, for handler tests (the port's
copy of ``gofr_tpu/testutil/mock_container.py``).

Reference parity: pkg/gofr/container/mock_container.go:20-46,96-140 — one
call returns a Container whose datasources are in-memory fakes plus a
``mocks`` handle for assertions. The device datasource fake records
compiled functions and calls them eagerly, on whatever device their
arguments lie (the CPU in tests); the SQL datasource is an in-memory
``SQLite``; ``redis`` is the port's ``InMemoryRedis`` and ``kv_store``
its ``InMemoryKVStore``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from gofr_tpu_torch.config import MapConfig
from gofr_tpu_torch.container.container import Container
from gofr_tpu_torch.logging import Level, new_logger


class MockTPU:
    """Records compile/execute calls; calls the function eagerly."""

    def __init__(self) -> None:
        self.compiled: dict[str, Any] = {}
        self.execute_calls: list[tuple[str, tuple, dict]] = []

    def use_logger(self, logger: Any) -> None:
        pass

    def use_metrics(self, metrics: Any) -> None:
        pass

    def use_tracer(self, tracer: Any) -> None:
        pass

    def connect(self) -> None:
        pass

    def compile(self, name: str, fn: Any, *abstract_args: Any, **options: Any) -> Any:
        self.compiled[name] = fn
        return fn

    def execute(self, name: str, *args: Any, **kwargs: Any) -> Any:
        self.execute_calls.append((name, args, kwargs))
        fn = self.compiled.get(name)
        if fn is None:
            raise KeyError(f"executable {name} not compiled")
        return fn(*args, **kwargs)

    def device_count(self) -> int:
        return 1

    def mesh(self) -> Any:
        return None

    def hbm_stats(self) -> dict[str, Any]:
        return {"bytes_in_use": 0, "bytes_limit": 0}

    def health_check(self) -> dict[str, Any]:
        return {"status": "UP", "backend": "mock", "devices": 1}


class MockPubSub:
    """In-memory broker fake with published-message capture."""

    def __init__(self) -> None:
        self.published: list[tuple[str, bytes, dict]] = []
        self.queues: dict[str, list] = {}

    def publish(self, topic: str, message: bytes, metadata: dict | None = None) -> None:
        self.published.append((topic, message, metadata or {}))
        self.queues.setdefault(topic, []).append((message, metadata or {}))

    def subscribe(self, topic: str) -> Any:
        from gofr_tpu_torch.pubsub.message import Message

        queue = self.queues.setdefault(topic, [])
        if not queue:
            return None
        value, metadata = queue.pop(0)

        def _nack(requeue: bool) -> None:
            if requeue:  # head of the queue: redelivered next subscribe
                queue.insert(0, (value, metadata))

        return Message(topic=topic, value=value, metadata=metadata, nacker=_nack)

    def create_topic(self, name: str) -> None:
        self.queues.setdefault(name, [])

    def delete_topic(self, name: str) -> None:
        self.queues.pop(name, None)

    def health_check(self) -> dict[str, Any]:
        return {"status": "UP", "backend": "mock"}

    def close(self) -> None:
        pass


@dataclasses.dataclass
class Mocks:
    tpu: MockTPU
    pubsub: MockPubSub
    sql: Any
    redis: Any
    kv_store: Any


class MockContainer(Container):
    pass


def new_mock_container(configs: dict[str, str] | None = None) -> tuple[MockContainer, Mocks]:
    """NewMockContainer(t) analogue (mock_container.go:96-140)."""
    config = MapConfig(configs or {}, use_env=False)
    logger = new_logger(Level.ERROR, exit_on_fatal=False)
    container = MockContainer(config, logger=logger)

    from gofr_tpu_torch.datasource.kv import InMemoryKVStore
    from gofr_tpu_torch.datasource.redis import InMemoryRedis
    from gofr_tpu_torch.datasource.sql import SQLite

    tpu = MockTPU()
    pubsub = MockPubSub()
    sql = SQLite(":memory:")
    redis = InMemoryRedis()
    kv = InMemoryKVStore()
    for name, ds in (("tpu", tpu), ("pubsub", pubsub), ("sql", sql), ("redis", redis),
                     ("kv_store", kv)):
        container.register_datasource(name, ds)
    return container, Mocks(tpu=tpu, pubsub=pubsub, sql=sql, redis=redis, kv_store=kv)
