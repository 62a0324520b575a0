"""Pub/Sub Message — implements the Request contract (a copy of
``gofr_tpu/datasource/pubsub/message.py``).

Reference parity: datasource/pubsub/message.go:13-115 — a broker message
binds into str/int/float/bool/struct and exposes topic metadata through the
Request accessors, so the same Handler signature serves HTTP and async
consumers (SURVEY §3.4).

Settlement contract (docs/datasources.md "Delivery semantics"):
``commit()`` settles positively (the broker advances past the message),
``nack(requeue=)`` settles negatively (requeue → redeliver, else drop).
Both are idempotent and mutually exclusive through ``committed`` — the
framework subscriber loop settles every message it delivers, so a handler
that also settles must not double-fire the broker ack path.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable

from gofr_tpu_torch import chaos


class Message:
    def __init__(
        self,
        topic: str,
        value: bytes,
        metadata: dict[str, str] | None = None,
        committer: Callable[[], None] | None = None,
        nacker: Callable[[bool], None] | None = None,
        message_id: str | None = None,
    ) -> None:
        self.topic = topic
        self.value = value if isinstance(value, bytes) else str(value).encode()
        self.metadata = metadata or {}
        self._committer = committer
        self._nacker = nacker
        # stable per-message identity ACROSS redeliveries (kafka/memory
        # offset, MQTT packet id, google PubsubMessage.message_id) — the
        # subscriber's attempt tracking keys on it so two identical
        # payloads don't share a delivery budget. None where the broker
        # has no stable handle (NATS core, EventHub): tracking falls back
        # to content identity, where identical payloads DO share a record
        # — a documented best-effort, not a correctness hole (the budget
        # still bounds redelivery; it may just trip early for duplicates).
        self.message_id = message_id
        self.committed = False  # settled (ack OR nack); double-settle is a no-op

    # -- Request contract ------------------------------------------------------
    def param(self, key: str) -> str:
        if key == "topic":
            return self.topic
        return self.metadata.get(key, "")

    def params(self, key: str) -> list[str]:
        v = self.param(key)
        return [v] if v else []

    def path_param(self, key: str) -> str:
        return self.param(key)

    def header(self, key: str) -> str:
        return self.metadata.get(key.lower(), "")

    def host_name(self) -> str:
        return ""

    def bind(self, target: Any) -> Any:
        """message.go:45-115: bind payload to primitives or structs."""
        text = self.value.decode("utf-8", "replace")
        if target is None or target is str:
            return text
        if target is bytes:
            return self.value
        if target is int:
            return int(text)
        if target is float:
            return float(text)
        if target is bool:
            return text.strip().lower() in ("1", "true", "yes")
        data = json.loads(text)
        if target is dict:
            return data
        if isinstance(target, dict):
            target.clear()
            target.update(data)
            return target
        cls = target if isinstance(target, type) else type(target)
        if dataclasses.is_dataclass(cls):
            names = {f.name for f in dataclasses.fields(cls)}
            return cls(**{k: v for k, v in data.items() if k in names})
        obj = target if not isinstance(target, type) else cls()
        for k, v in data.items():
            setattr(obj, k, v)
        return obj

    # -- Committer (interface.go Committer + nack) -----------------------------
    def commit(self) -> None:
        """Settle positively. Idempotent: once settled (by commit OR nack)
        further calls are no-ops, so handler + framework double-commit is
        safe across all drivers. ``committed`` flips only after the broker
        ack went through — a failed ack leaves the message redeliverable."""
        if self.committed:
            return
        chaos.maybe_fail("pubsub.ack")
        if self._committer is not None:
            self._committer()
        self.committed = True

    def nack(self, requeue: bool = True) -> None:
        """Settle negatively. ``requeue=True`` asks the broker to redeliver
        (native nack where the protocol has one, offset-hold emulation where
        it doesn't); ``requeue=False`` drops the message (advances past it
        without processing). Idempotent, mutually exclusive with commit."""
        if self.committed:
            return
        chaos.maybe_fail("pubsub.ack")
        if self._nacker is not None:
            self._nacker(requeue)
        elif not requeue and self._committer is not None:
            # drop on a driver without a nacker: advancing past the message
            # is exactly what its commit does
            self._committer()
        self.committed = True
