"""Google Pub/Sub driver over the google.pubsub.v1 gRPC surface (a copy of
``gofr_tpu/datasource/pubsub/google.py`` on the port's own gRPC wire).

Reference parity: pkg/gofr/datasource/pubsub/google/google.go:1-395 —
topic ensure-on-publish, one subscription per consumer group
(``getOrCreateSubscription``), ack-deadline redelivery (at-least-once),
health check, pubsub counters. The reference wraps
cloud.google.com/go/pubsub, whose transport is the gRPC services restated
in ``protos/pubsub_v1.proto``; this driver speaks that wire directly through
the port's blocking channel (``grpcx/h2.py``), message classes built from
the committed descriptor set (``grpcx/protowire.py``). Point
``GOOGLE_PUBSUB_ENDPOINT`` at the emulator, the in-process fake
(``testutil/google_pubsub.py``), or a production proxy.

Contract mapping (datasource/pubsub/interface.go:11-33):
- ``publish`` → ensure topic, Publish with metadata as attributes
- ``subscribe`` → ensure ``{group}-{topic}`` subscription, Pull(1);
  ``Message.commit()`` → Acknowledge; an unacked message comes back
  after the ack deadline (subscriber.go:75-78 at-least-once)
- ``backlog`` → undelivered count for the group's subscription
"""

from __future__ import annotations

import os
import threading
from typing import Any

from gofr_tpu_torch.grpcx.h2 import BlockingChannel, RpcError, StatusCode
from gofr_tpu_torch.grpcx.protowire import load_messages
from gofr_tpu_torch.pubsub.message import Message

_PROTO_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "protos")

with open(os.path.join(_PROTO_DIR, "pubsub_v1.binpb"), "rb") as _f:
    PUBSUB_FDS = _f.read()

MESSAGES = load_messages(PUBSUB_FDS)
_P = "google.pubsub.v1"

# (service, method, response type) of the nine calls the driver makes
STUBS = (
    ("Publisher", "CreateTopic", "Topic"),
    ("Publisher", "DeleteTopic", "Empty"),
    ("Publisher", "ListTopics", "ListTopicsResponse"),
    ("Publisher", "Publish", "PublishResponse"),
    ("Subscriber", "CreateSubscription", "Subscription"),
    ("Subscriber", "DeleteSubscription", "Empty"),
    ("Subscriber", "Pull", "PullResponse"),
    ("Subscriber", "Acknowledge", "Empty"),
    ("Subscriber", "ModifyAckDeadline", "Empty"),
)


def _mc(channel: BlockingChannel, service: str, method: str, out_type: str):
    out_cls = MESSAGES[f"{_P}.{out_type}"]
    return channel.unary_unary(
        f"/{_P}.{service}/{method}",
        request_serializer=lambda m: m.SerializeToString(),
        response_deserializer=out_cls.FromString,
    )


class GooglePubSubClient:
    def __init__(
        self,
        endpoint: str = "localhost:8681",
        project: str = "gofr",
        consumer_group: str = "gofr",
        ack_deadline_seconds: int = 10,
        poll_timeout: float = 0.2,
        connect_timeout: float = 5.0,
    ) -> None:
        self.endpoint = endpoint
        self.project = project
        self.consumer_group = consumer_group
        self.ack_deadline_seconds = ack_deadline_seconds
        self.poll_timeout = poll_timeout
        self.connect_timeout = connect_timeout
        self._channel: BlockingChannel | None = None
        self._stubs: dict[str, Any] = {}
        self._known_topics: set[str] = set()
        self._known_subs: set[str] = set()
        self._lock = threading.Lock()
        self._logger: Any = None
        self._metrics: Any = None

    @classmethod
    def from_config(cls, config: Any) -> "GooglePubSubClient":
        return cls(
            endpoint=config.get_or_default("GOOGLE_PUBSUB_ENDPOINT", "localhost:8681"),
            project=config.get_or_default("GOOGLE_PROJECT_ID", "gofr"),
            consumer_group=config.get_or_default("GOOGLE_PUBSUB_SUBSCRIPTION_NAME",
                                                 config.get_or_default("CONSUMER_ID", "gofr")),
            ack_deadline_seconds=int(
                config.get_or_default("GOOGLE_PUBSUB_ACK_DEADLINE_SECONDS", "10")
            ),
        )

    # -- provider pattern --------------------------------------------------
    def use_logger(self, logger: Any) -> None:
        self._logger = logger

    def use_metrics(self, metrics: Any) -> None:
        self._metrics = metrics

    def use_tracer(self, tracer: Any) -> None:
        pass

    def connect(self) -> None:
        self._ensure_channel()
        # fail fast if the endpoint is dark (the reference's client makes a
        # first RPC on connect too)
        self._list_topics()
        if self._logger:
            self._logger.log(f"connected to google pub/sub at {self.endpoint}")

    def _ensure_channel(self) -> BlockingChannel:
        with self._lock:
            if self._channel is None:
                self._channel = BlockingChannel(self.endpoint)
                for svc, method, out in STUBS:
                    self._stubs[f"{svc}.{method}"] = _mc(self._channel, svc, method, out)
            return self._channel

    def _call(self, stub: str, request: Any, timeout: float | None = None) -> Any:
        self._ensure_channel()
        return self._stubs[stub](request, timeout=timeout or self.connect_timeout)

    # -- names -------------------------------------------------------------
    def _topic_path(self, topic: str) -> str:
        return f"projects/{self.project}/topics/{topic}"

    def _sub_path(self, topic: str) -> str:
        return f"projects/{self.project}/subscriptions/{self.consumer_group}-{topic}"

    def _ensure_topic(self, topic: str) -> None:
        if topic in self._known_topics:
            return
        try:
            self._call("Publisher.CreateTopic",
                       MESSAGES[f"{_P}.Topic"](name=self._topic_path(topic)))
        except RpcError as exc:
            if exc.code() != StatusCode.ALREADY_EXISTS:
                raise
        self._known_topics.add(topic)

    def _ensure_subscription(self, topic: str) -> str:
        """google.go getOrCreateSubscription: one subscription per
        consumer group per topic."""
        sub = self._sub_path(topic)
        if sub in self._known_subs:
            return sub
        self._ensure_topic(topic)
        try:
            self._call(
                "Subscriber.CreateSubscription",
                MESSAGES[f"{_P}.Subscription"](
                    name=sub, topic=self._topic_path(topic),
                    ack_deadline_seconds=self.ack_deadline_seconds,
                ),
            )
        except RpcError as exc:
            if exc.code() != StatusCode.ALREADY_EXISTS:
                raise
        self._known_subs.add(sub)
        return sub

    # -- Publisher ---------------------------------------------------------
    def publish(self, topic: str, message: bytes, metadata: dict | None = None) -> None:
        if self._metrics:
            self._metrics.increment_counter("app_pubsub_publish_total_count", topic=topic)
        self._ensure_topic(topic)
        value = message if isinstance(message, bytes) else str(message).encode()
        msg = MESSAGES[f"{_P}.PubsubMessage"](data=value)
        for k, v in (metadata or {}).items():
            msg.attributes[str(k)] = str(v)
        req = MESSAGES[f"{_P}.PublishRequest"](topic=self._topic_path(topic))
        req.messages.append(msg)
        self._call("Publisher.Publish", req)
        if self._metrics:
            self._metrics.increment_counter("app_pubsub_publish_success_count", topic=topic)
        if self._logger:
            self._logger.debug(f"published to pubsub topic {topic}: {len(value)}B")

    # -- Subscriber --------------------------------------------------------
    def subscribe(self, topic: str) -> Message | None:
        sub = self._ensure_subscription(topic)
        try:
            resp = self._call(
                "Subscriber.Pull",
                MESSAGES[f"{_P}.PullRequest"](subscription=sub, max_messages=1),
                timeout=self.poll_timeout + self.connect_timeout,
            )
        except RpcError as exc:
            if exc.code() == StatusCode.DEADLINE_EXCEEDED:
                return None
            raise
        if not resp.received_messages:
            return None
        rm = resp.received_messages[0]
        ack_id = rm.ack_id

        def _commit() -> None:
            self._call(
                "Subscriber.Acknowledge",
                MESSAGES[f"{_P}.AcknowledgeRequest"](subscription=sub, ack_ids=[ack_id]),
            )

        def _nack(requeue: bool) -> None:
            if requeue:
                # the native Pub/Sub nack: ack deadline 0 = redeliver now
                self._call(
                    "Subscriber.ModifyAckDeadline",
                    MESSAGES[f"{_P}.ModifyAckDeadlineRequest"](
                        subscription=sub, ack_ids=[ack_id], ack_deadline_seconds=0,
                    ),
                )
            else:
                _commit()

        return Message(
            topic=topic,
            value=bytes(rm.message.data),
            metadata=dict(rm.message.attributes),
            committer=_commit,
            nacker=_nack,
            # broker-assigned PubsubMessage.message_id is stable across
            # redeliveries (unlike the per-delivery ack_id)
            message_id=str(rm.message.message_id) or None,
        )

    # -- admin / health ----------------------------------------------------
    def create_topic(self, name: str) -> None:
        self._ensure_topic(name)

    def delete_topic(self, name: str) -> None:
        try:
            self._call("Publisher.DeleteTopic",
                       MESSAGES[f"{_P}.DeleteTopicRequest"](topic=self._topic_path(name)))
        except RpcError as exc:
            if exc.code() != StatusCode.NOT_FOUND:
                raise
        self._known_topics.discard(name)

    def _list_topics(self) -> list[str]:
        resp = self._call(
            "Publisher.ListTopics",
            MESSAGES[f"{_P}.ListTopicsRequest"](project=f"projects/{self.project}"),
        )
        return [t.name for t in resp.topics]

    def backlog(self, topic: str) -> int:
        """Undelivered messages for the group's subscription: one probe
        Pull with immediate re-deadline so nothing is consumed."""
        sub = self._ensure_subscription(topic)
        resp = self._call(
            "Subscriber.Pull",
            MESSAGES[f"{_P}.PullRequest"](subscription=sub, max_messages=1000),
        )
        if resp.received_messages:
            self._call(
                "Subscriber.ModifyAckDeadline",
                MESSAGES[f"{_P}.ModifyAckDeadlineRequest"](
                    subscription=sub,
                    ack_ids=[m.ack_id for m in resp.received_messages],
                    ack_deadline_seconds=0,  # 0 = immediate redelivery (nack)
                ),
            )
        return len(resp.received_messages)

    def health_check(self) -> dict[str, Any]:
        try:
            topics = self._list_topics()
            return {
                "status": "UP",
                "details": {
                    "backend": "google",
                    "endpoint": self.endpoint,
                    "project": self.project,
                    "consumer_group": self.consumer_group,
                    "topics": len(topics),
                },
            }
        except (RpcError, OSError) as exc:
            return {
                "status": "DOWN",
                "details": {"backend": "google", "endpoint": self.endpoint, "error": str(exc)},
            }

    def close(self) -> None:
        with self._lock:
            if self._channel is not None:
                self._channel.close()
                self._channel = None
                self._stubs.clear()
