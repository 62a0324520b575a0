"""Test doubles and helpers of the port (copies of ``gofr_tpu/testutil``
modules that raise the port's errors, free ports, an app runner, tokenizer
assets written from code, and the in-process brokers the networked pubsub
drivers talk to: Kafka, NATS, MQTT and Event Hubs)."""

from gofr_tpu_torch.testutil.apps import fetch, start_app, stop_app, wait_ready
from gofr_tpu_torch.testutil.eventhub_server import MiniEventHubServer
from gofr_tpu_torch.testutil.kafka_broker import MiniKafkaBroker
from gofr_tpu_torch.testutil.mock_container import MockContainer, new_mock_container
from gofr_tpu_torch.testutil.mqtt_broker import MiniMQTTBroker
from gofr_tpu_torch.testutil.nats_broker import MiniNatsBroker
from gofr_tpu_torch.testutil.ports import ServerConfigs, get_free_port, new_server_configs

__all__ = ["MiniEventHubServer", "MiniKafkaBroker", "MiniMQTTBroker", "MiniNatsBroker",
           "MockContainer", "ServerConfigs", "fetch", "get_free_port", "new_mock_container",
           "new_server_configs", "start_app", "stop_app", "wait_ready"]
