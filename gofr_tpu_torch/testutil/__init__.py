"""Test doubles and helpers of the port (copies of ``gofr_tpu/testutil``
modules that raise the port's errors, free ports, an app runner, tokenizer
assets written from code, the in-process brokers the networked pubsub
drivers talk to: Kafka, NATS, MQTT and Event Hubs, and the servers the
file systems and the Redis client talk to: ``FakeObjectStore`` (S3 and
GCS), ``MiniFTPServer``, ``MiniSFTPServer`` and ``MiniRedisServer``, and the
servers the KV, document, wide-column and search drivers talk to:
``MiniDynamoDBServer``, ``MiniMongoServer``, ``MiniCassandraServer`` and
``MiniSolrServer``, and the ClickHouse HTTP server the columnar driver talks
to, ``MiniClickHouseServer``)."""

from gofr_tpu_torch.testutil.apps import fetch, start_app, stop_app, wait_ready
from gofr_tpu_torch.testutil.cassandra_server import MiniCassandraServer
from gofr_tpu_torch.testutil.clickhouse_server import MiniClickHouseServer
from gofr_tpu_torch.testutil.dynamodb_server import MiniDynamoDBServer
from gofr_tpu_torch.testutil.eventhub_server import MiniEventHubServer
from gofr_tpu_torch.testutil.ftp_server import MiniFTPServer
from gofr_tpu_torch.testutil.kafka_broker import MiniKafkaBroker
from gofr_tpu_torch.testutil.mock_container import MockContainer, new_mock_container
from gofr_tpu_torch.testutil.mongo_server import MiniMongoServer
from gofr_tpu_torch.testutil.mqtt_broker import MiniMQTTBroker
from gofr_tpu_torch.testutil.nats_broker import MiniNatsBroker
from gofr_tpu_torch.testutil.object_store_server import FakeObjectStore
from gofr_tpu_torch.testutil.ports import ServerConfigs, get_free_port, new_server_configs
from gofr_tpu_torch.testutil.redis_server import MiniRedisServer
from gofr_tpu_torch.testutil.sftp_server import MiniSFTPServer
from gofr_tpu_torch.testutil.solr_server import MiniSolrServer

__all__ = ["FakeObjectStore", "MiniCassandraServer", "MiniClickHouseServer",
           "MiniDynamoDBServer", "MiniEventHubServer",
           "MiniFTPServer", "MiniKafkaBroker", "MiniMQTTBroker", "MiniMongoServer",
           "MiniNatsBroker", "MiniRedisServer", "MiniSFTPServer", "MiniSolrServer",
           "MockContainer", "ServerConfigs", "fetch", "get_free_port", "new_mock_container",
           "new_server_configs", "start_app", "stop_app", "wait_ready"]
