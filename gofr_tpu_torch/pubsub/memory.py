"""In-memory broker: full Pub/Sub contract without a networked service (a
copy of ``gofr_tpu/datasource/pubsub/memory.py``; the membership
heartbeats of the port's router tier ride it).

Semantics follow the kafka driver (datasource/pubsub/kafka/kafka.go):
per-topic append-only log, consumer-group offsets, commit advances the
group's offset (at-least-once: an uncommitted message is redelivered to the
next subscribe call). Async-friendly: ``subscribe`` blocks on an
asyncio-compatible threading Event with timeout so subscriber loops poll
cheaply.
"""

from __future__ import annotations

import threading
from typing import Any

from gofr_tpu_torch import chaos
from gofr_tpu_torch.pubsub.message import Message


class InMemoryBroker:
    def __init__(self, consumer_group: str = "default", poll_timeout: float = 0.2) -> None:
        self.consumer_group = consumer_group
        self.poll_timeout = poll_timeout
        self._topics: dict[str, list[tuple[bytes, dict]]] = {}
        self._offsets: dict[tuple[str, str], int] = {}  # (group, topic) -> next index
        self._pending: dict[tuple[str, str], int] = {}  # delivered-but-uncommitted index
        self._lock = threading.Lock()
        self._data_available = threading.Condition(self._lock)
        self._logger: Any = None
        self._metrics: Any = None
        self._closed = False

    @classmethod
    def from_config(cls, config: Any) -> "InMemoryBroker":
        return cls(config.get_or_default("CONSUMER_ID", "default"))

    # -- provider pattern ------------------------------------------------------
    def use_logger(self, logger: Any) -> None:
        self._logger = logger

    def use_metrics(self, metrics: Any) -> None:
        self._metrics = metrics

    def use_tracer(self, tracer: Any) -> None:
        pass

    def connect(self) -> None:
        if self._logger:
            self._logger.debug("in-memory broker ready")

    # -- Publisher -------------------------------------------------------------
    def publish(self, topic: str, message: bytes, metadata: dict | None = None) -> None:
        if self._metrics:
            self._metrics.increment_counter("app_pubsub_publish_total_count", topic=topic)
        chaos.maybe_fail("pubsub.publish")
        with self._data_available:
            self._topics.setdefault(topic, []).append(
                (message if isinstance(message, bytes) else str(message).encode(), metadata or {})
            )
            self._data_available.notify_all()
        if self._metrics:
            self._metrics.increment_counter("app_pubsub_publish_success_count", topic=topic)

    # -- Subscriber ------------------------------------------------------------
    def subscribe(self, topic: str) -> Message | None:
        """Deliver the next message for this consumer group, or None after
        the poll timeout (subscriber loops handle the None and re-poll)."""
        key = (self.consumer_group, topic)
        with self._data_available:
            log = self._topics.setdefault(topic, [])
            offset = self._pending.get(key, self._offsets.get(key, 0))
            if offset >= len(log):
                self._data_available.wait(self.poll_timeout)
                if offset >= len(log):
                    return None
            value, metadata = log[offset]
            self._pending[key] = offset  # redelivered until committed

            def _commit(idx: int = offset) -> None:
                with self._lock:
                    self._offsets[key] = idx + 1
                    self._pending.pop(key, None)

            def _nack(requeue: bool, idx: int = offset) -> None:
                if requeue:
                    # leave the pending marker: the next subscribe call
                    # redelivers this offset (the at-least-once contract)
                    return
                _commit(idx)  # drop = advance past it without processing

            return Message(
                topic=topic, value=value, metadata=metadata,
                committer=_commit, nacker=_nack, message_id=str(offset),
            )

    def group_view(self, consumer_group: str) -> "InMemoryBroker":
        """A second consumer identity over the SAME log (docs/robustness.md
        "The HA plane"): shares topics, offsets and the data-available
        condition, differs only in group. Two routers in an HA pair each
        take their own view so BOTH observe every heartbeat — group
        offsets are keyed (group, topic), so the views never steal each
        other's messages."""
        view = InMemoryBroker.__new__(InMemoryBroker)
        view.consumer_group = consumer_group
        view.poll_timeout = self.poll_timeout
        view._topics = self._topics
        view._offsets = self._offsets
        view._pending = self._pending
        view._lock = self._lock
        view._data_available = self._data_available
        view._logger = self._logger
        view._metrics = self._metrics
        view._closed = False
        return view

    # -- topic admin (kafka.go topic create/delete) ----------------------------
    def create_topic(self, name: str) -> None:
        with self._lock:
            self._topics.setdefault(name, [])

    def delete_topic(self, name: str) -> None:
        with self._lock:
            self._topics.pop(name, None)

    def backlog(self, topic: str) -> int:
        with self._lock:
            key = (self.consumer_group, topic)
            return len(self._topics.get(topic, [])) - self._offsets.get(key, 0)

    def close(self) -> None:
        self._closed = True

    def health_check(self) -> dict[str, Any]:
        with self._lock:
            return {
                "status": "UP",
                "details": {
                    "backend": "memory",
                    "topics": len(self._topics),
                    "messages": sum(len(v) for v in self._topics.values()),
                },
            }
