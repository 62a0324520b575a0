"""The port's pubsub (copies of ``gofr_tpu/datasource/pubsub``): the
in-memory broker that the membership heartbeats and the app's subscribers
(``subscriber.py``) ride, the delivery policy with its dead-letter topics,
and the networked drivers behind ``PUBSUB_BACKEND``, each speaking its wire
protocol itself over a socket: Kafka (``kafka.py`` over ``kafka_wire.py``),
NATS (``nats.py``), MQTT 3.1.1 (``mqtt.py``), Azure Event Hubs over AMQP
1.0 (``eventhub.py`` over ``amqp_wire.py``) and Google Pub/Sub over gRPC
(``google.py`` on the port's own gRPC wire, ``grpcx/``)."""

from gofr_tpu_torch.pubsub.delivery import DeliveryPolicy, dlq_topic
from gofr_tpu_torch.pubsub.kafka import KafkaClient
from gofr_tpu_torch.pubsub.memory import InMemoryBroker
from gofr_tpu_torch.pubsub.message import Message


def build_pubsub(config):
    """PUBSUB_BACKEND switch (container/container.go:132-172): KAFKA |
    GOOGLE | MQTT | NATS | EVENTHUB | MEMORY → a connected-contract client,
    or None when unset (apps wire their own via app.add_datasource)."""
    backend = (config.get("PUBSUB_BACKEND") or "").strip().upper()
    if not backend:
        return None
    if backend == "KAFKA":
        return KafkaClient.from_config(config)
    if backend == "MQTT":
        from gofr_tpu_torch.pubsub.mqtt import MQTTClient

        return MQTTClient.from_config(config)
    if backend == "GOOGLE":
        from gofr_tpu_torch.pubsub.google import GooglePubSubClient

        return GooglePubSubClient.from_config(config)
    if backend == "NATS":
        from gofr_tpu_torch.pubsub.nats import NatsClient

        return NatsClient.from_config(config)
    if backend == "EVENTHUB":
        from gofr_tpu_torch.pubsub.eventhub import EventHubClient

        return EventHubClient.from_config(config)
    if backend == "MEMORY":
        return InMemoryBroker.from_config(config)
    raise ValueError(f"unknown PUBSUB_BACKEND {backend!r}")


__all__ = [
    "Message", "InMemoryBroker", "KafkaClient", "build_pubsub",
    "DeliveryPolicy", "dlq_topic",
]
