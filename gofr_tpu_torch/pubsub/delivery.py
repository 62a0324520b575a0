"""Delivery-reliability policy: bounded redelivery + dead-letter routing (a
copy of ``gofr_tpu/datasource/pubsub/delivery.py``).

The at-least-once brokers (memory/kafka/nats/mqtt/google/eventhub) redeliver
any message that is not committed — which is exactly right for transient
handler failures and exactly wrong for a poison message, which would wedge
its topic in a redelivery hot loop forever. :class:`DeliveryPolicy` bounds
that loop: a message gets ``max_attempts`` deliveries with exponential
full-jitter backoff between them (the ``service.RetryConfig`` ladder
semantics — a fixed interval synchronizes every consumer's retries into
coordinated waves), and when the budget is exhausted the message is
published to ``<topic>.dlq`` with its failure history and committed so the
topic keeps flowing.

Config:

- ``PUBSUB_MAX_ATTEMPTS`` / ``PUBSUB_RETRY_BACKOFF_SECONDS`` /
  ``PUBSUB_RETRY_MULTIPLIER`` / ``PUBSUB_RETRY_MAX_BACKOFF_SECONDS`` —
  global defaults.
- ``PUBSUB_<TOPIC>_MAX_ATTEMPTS`` — per-topic override; the topic name is
  upper-cased with every non-alphanumeric run collapsed to ``_``
  (``asr-jobs`` → ``PUBSUB_ASR_JOBS_MAX_ATTEMPTS``).

The attempts counter also rides in message metadata under
:data:`ATTEMPTS_KEY`, so handlers can see which delivery they are on and
brokers that persist metadata carry it across redeliveries.
"""

from __future__ import annotations

import dataclasses
import random
import re
import time
from typing import Any

DLQ_SUFFIX = ".dlq"

# metadata keys the framework writes; excluded from message identity
ATTEMPTS_KEY = "gofr_attempts"
DLQ_SOURCE_TOPIC_KEY = "gofr_dlq_source_topic"
DLQ_ERROR_KEY = "gofr_dlq_error"
DLQ_ATTEMPTS_KEY = "gofr_dlq_attempts"
DLQ_FIRST_TS_KEY = "gofr_dlq_first_delivery_ts"
DLQ_LAST_TS_KEY = "gofr_dlq_last_delivery_ts"


def dlq_topic(topic: str) -> str:
    return topic + DLQ_SUFFIX


def is_dlq_topic(topic: str) -> bool:
    return topic.endswith(DLQ_SUFFIX)


def _env_key(topic: str) -> str:
    return re.sub(r"[^A-Za-z0-9]+", "_", topic).upper()


@dataclasses.dataclass(frozen=True)
class DeliveryPolicy:
    """Redelivery budget for one topic's consumer."""

    max_attempts: int = 5  # total deliveries, the first one included
    backoff: float = 0.05  # base delay before the first redelivery
    multiplier: float = 2.0
    max_backoff: float = 5.0
    jitter: bool = True  # full jitter; False = deterministic exponential

    def delay(self, attempt: int, rng: random.Random | None = None) -> float:
        """Backoff before redelivery number ``attempt`` (1-based), drawn
        uniformly from [0, backoff·multiplier^(attempt-1)] capped at
        ``max_backoff`` — RetryConfig's full-jitter ladder. The exponent is
        clamped: attempts grow without bound when a DLQ publish keeps
        failing, and ``2.0**1024`` raises OverflowError — which would
        escape the backoff path and turn the paced redelivery into the
        very hot loop the delay exists to prevent."""
        exponent = min(max(attempt - 1, 0), 64)
        exp = min(self.max_backoff, self.backoff * (self.multiplier ** exponent))
        if not self.jitter:
            return exp
        return (rng or random).uniform(0.0, exp)

    @classmethod
    def from_config(cls, config: Any, topic: str) -> "DeliveryPolicy":
        """Global knobs with a per-topic ``PUBSUB_<TOPIC>_MAX_ATTEMPTS``
        override. A missing/empty config object yields the defaults."""
        defaults = cls()
        if config is None:
            return defaults

        def _get(key: str, fallback: float) -> float:
            try:
                raw = config.get_or_default(key, str(fallback))
                return float(raw)
            except (TypeError, ValueError):
                return fallback

        max_attempts = int(_get("PUBSUB_MAX_ATTEMPTS", defaults.max_attempts))
        per_topic = None
        try:
            per_topic = config.get(f"PUBSUB_{_env_key(topic)}_MAX_ATTEMPTS")
        except Exception:
            per_topic = None
        if per_topic:
            try:
                max_attempts = int(str(per_topic).strip())
            except ValueError:
                pass
        return cls(
            max_attempts=max(1, max_attempts),
            backoff=_get("PUBSUB_RETRY_BACKOFF_SECONDS", defaults.backoff),
            multiplier=_get("PUBSUB_RETRY_MULTIPLIER", defaults.multiplier),
            max_backoff=_get("PUBSUB_RETRY_MAX_BACKOFF_SECONDS", defaults.max_backoff),
        )


class AttemptRecord:
    """Delivery history for one in-flight message, kept by the consumer
    (brokers that cannot persist metadata across redeliveries — kafka
    refetches headers from the log — still get a correct count)."""

    __slots__ = ("attempts", "first_ts", "last_ts", "last_error")

    def __init__(self) -> None:
        self.attempts = 0
        self.first_ts = 0.0
        self.last_ts = 0.0
        self.last_error = ""

    def record_delivery(self) -> int:
        now = time.time()
        if self.attempts == 0:
            self.first_ts = now
        self.last_ts = now
        self.attempts += 1
        return self.attempts

    def dlq_metadata(self, source_topic: str) -> dict[str, str]:
        return {
            DLQ_SOURCE_TOPIC_KEY: source_topic,
            DLQ_ERROR_KEY: self.last_error[:512],
            DLQ_ATTEMPTS_KEY: str(self.attempts),
            DLQ_FIRST_TS_KEY: f"{self.first_ts:.6f}",
            DLQ_LAST_TS_KEY: f"{self.last_ts:.6f}",
        }


# headers a broker adds to a redelivery only: not part of a message's identity
REDELIVERY_MARKERS = frozenset({"Nats-Redelivered"})


def message_key(topic: str, value: bytes, metadata: dict | None,
                message_id: str | None = None) -> tuple:
    """Identity of a message for attempt tracking. Prefer the broker's
    stable per-message id (kafka/memory offset, MQTT packet id) — it must
    be stable ACROSS redeliveries, which is why per-delivery handles like
    google ack_ids don't qualify. Fall back to payload + the stable
    (non-framework) metadata; framework bookkeeping keys are excluded —
    the memory broker shares the stored metadata dict with deliveries, so
    the attempts counter itself must not change the key — and so are the
    markers a broker sets on a redelivery only (NATS's
    ``Nats-Redelivered``; the reference keeps it, so its first delivery
    and the rest count as two messages: ROADMAP Queue C 47)."""
    if message_id is not None:
        return (topic, "id", str(message_id))
    stable = tuple(
        sorted(
            (str(k), str(v))
            for k, v in (metadata or {}).items()
            if not str(k).startswith("gofr_") and str(k) not in REDELIVERY_MARKERS
        )
    )
    return (topic, bytes(value), stable)
