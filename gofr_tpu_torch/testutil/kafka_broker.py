"""In-process Kafka mini-broker for tests (a copy of
``gofr_tpu/testutil/kafka_broker.py``).

Speaks the wire subset the driver uses (pubsub/kafka_wire.py):
**Produce v3 / Fetch v4 with record-batch v2 only** — like a real
Kafka ≥0.11 broker it answers legacy Produce/Fetch versions with
UNSUPPORTED_VERSION and magic-0/1 payloads with CORRUPT_MESSAGE, so the
driver is no longer validated by its own mirror (VERDICT r2 item 5) —
plus ListOffsets, Metadata, OffsetCommit/OffsetFetch (consumer-group
offsets), CreateTopics/DeleteTopics. Single-node, any number of
single-partition topics, append-only in-memory logs. Stands in for the
reference CI's Kafka service container (SURVEY §4 tier 4) the way
testutil/mqtt_broker.py does for MQTT.
"""

from __future__ import annotations

import socket
import struct
import threading
from typing import Any

from gofr_tpu_torch.pubsub import kafka_wire as wire

# (key, value, headers) triples
LogEntry = tuple  # type alias for readability


class MiniKafkaBroker:
    def __init__(self, port: int = 0, auto_create_topics: bool = True) -> None:
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind(("127.0.0.1", port))
        self._server.listen(16)
        self.port = self._server.getsockname()[1]
        self.auto_create_topics = auto_create_topics

        self._logs: dict[str, list[tuple[bytes | None, bytes, list]]] = {}
        self._group_offsets: dict[tuple[str, str, int], int] = {}
        self._lock = threading.Lock()
        self._data = threading.Condition(self._lock)
        self._running = True
        self._threads: list[threading.Thread] = []
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="kafka-broker", daemon=True
        )
        self._accept_thread.start()

    @property
    def address(self) -> str:
        return f"127.0.0.1:{self.port}"

    def close(self) -> None:
        self._running = False
        try:
            self._server.close()
        except OSError:
            pass
        with self._data:
            self._data.notify_all()

    # -- server loops ------------------------------------------------------------
    def _accept_loop(self) -> None:
        while self._running:
            try:
                conn, _ = self._server.accept()
            except OSError:
                return
            t = threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True
            )
            t.start()
            self._threads.append(t)

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            while self._running:
                frame = wire.read_frame(lambda n: wire.recv_exact(conn, n))
                r = wire.Reader(frame)
                api_key = r.int16()
                api_version = r.int16()
                correlation_id = r.int32()
                r.string()  # client_id
                body = self._dispatch(api_key, api_version, r)
                resp = wire.int32(correlation_id) + body
                conn.sendall(wire.int32(len(resp)) + resp)
        except (ConnectionError, OSError, struct.error, wire.KafkaError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _dispatch(self, api_key: int, api_version: int, r: wire.Reader) -> bytes:
        # record-batch-v2 era strictness: a real ≥0.11 broker does not
        # accept the legacy produce/fetch framings this repo used to speak
        if api_key == wire.PRODUCE and api_version < wire.PRODUCE_API_VERSION:
            return self._produce_error_response(r, wire.UNSUPPORTED_VERSION,
                                                legacy_version=api_version)
        if api_key == wire.FETCH and api_version < wire.FETCH_API_VERSION:
            return self._fetch_error_response_legacy(r)
        handler = {
            wire.PRODUCE: self._handle_produce,
            wire.FETCH: self._handle_fetch,
            wire.LIST_OFFSETS: self._handle_list_offsets,
            wire.METADATA: self._handle_metadata,
            wire.OFFSET_COMMIT: self._handle_offset_commit,
            wire.OFFSET_FETCH: self._handle_offset_fetch,
            wire.CREATE_TOPICS: self._handle_create_topics,
            wire.DELETE_TOPICS: self._handle_delete_topics,
        }.get(api_key)
        if handler is None:
            raise wire.KafkaError(-1, f"unsupported api {api_key}")
        return handler(r)

    def _produce_error_response(
        self, r: wire.Reader, code: int, legacy_version: int
    ) -> bytes:
        """UNSUPPORTED_VERSION for a legacy (v0-v2) produce, framed the
        way that client expects so it surfaces as a typed error, not a
        hang."""
        r.int16(), r.int32()  # acks, timeout (no transactional_id pre-v3)
        topics_out = []
        for _ in range(r.int32()):
            topic = r.string() or ""
            parts_out = []
            for _ in range(r.int32()):
                partition = r.int32()
                r._take(r.int32())  # payload, ignored
                part = wire.int32(partition) + wire.int16(code) + wire.int64(-1)
                if legacy_version >= 2:
                    part += wire.int64(-1)
                parts_out.append(part)
            topics_out.append(wire.string(topic) + wire.array(parts_out))
        return wire.array(topics_out)

    def _fetch_error_response_legacy(self, r: wire.Reader) -> bytes:
        """UNSUPPORTED_VERSION per partition in v0 response shape."""
        r.int32(), r.int32(), r.int32()  # replica, max_wait, min_bytes
        topics_out = []
        for _ in range(r.int32()):
            topic = r.string() or ""
            parts_out = []
            for _ in range(r.int32()):
                partition = r.int32()
                r.int64(), r.int32()  # offset, max_bytes
                parts_out.append(
                    wire.int32(partition)
                    + wire.int16(wire.UNSUPPORTED_VERSION)
                    + wire.int64(-1)
                    + wire.bytes_(b"")
                )
            topics_out.append(wire.string(topic) + wire.array(parts_out))
        return wire.array(topics_out)

    # -- api handlers --------------------------------------------------------------
    def _topic_exists_or_create(self, topic: str) -> bool:
        if topic in self._logs:
            return True
        if self.auto_create_topics:
            self._logs[topic] = []
            return True
        return False

    def _handle_produce(self, r: wire.Reader) -> bytes:
        """Produce v3: record-batch v2 payloads only; magic 0/1 →
        CORRUPT_MESSAGE (what a modern broker does)."""
        r.string()  # transactional_id
        r.int16()  # acks
        r.int32()  # timeout
        topics_out = []
        for _ in range(r.int32()):
            topic = r.string() or ""
            parts_out = []
            for _ in range(r.int32()):
                partition = r.int32()
                record_set = r._take(r.int32())

                def part_resp(err: int, base: int) -> bytes:
                    return (
                        wire.int32(partition)
                        + wire.int16(err)
                        + wire.int64(base)
                        + wire.int64(-1)  # log append time (v2+)
                    )

                try:
                    entries = wire.decode_record_batches(record_set)
                except wire.KafkaError as exc:
                    parts_out.append(part_resp(
                        exc.code if exc.code > 0 else wire.CORRUPT_MESSAGE, -1
                    ))
                    continue
                with self._data:
                    if not self._topic_exists_or_create(topic):
                        parts_out.append(
                            part_resp(wire.UNKNOWN_TOPIC_OR_PARTITION, -1)
                        )
                        continue
                    log = self._logs[topic]
                    base = len(log)
                    for _, key, value, headers in entries:
                        log.append((key, value, headers))
                    self._data.notify_all()
                parts_out.append(part_resp(wire.NONE, base))
            topics_out.append(wire.string(topic) + wire.array(parts_out))
        return wire.array(topics_out)

    def _handle_fetch(self, r: wire.Reader) -> bytes:
        """Fetch v4: record-batch v2 record sets, v4 partition headers."""
        r.int32()  # replica_id
        max_wait_ms = r.int32()
        r.int32()  # min_bytes
        r.int32()  # max_bytes (response-wide, v3+)
        r.int8()  # isolation_level (v4+)
        requests = []
        for _ in range(r.int32()):
            topic = r.string() or ""
            for _ in range(r.int32()):
                partition = r.int32()
                offset = r.int64()
                max_bytes = r.int32()
                requests.append((topic, partition, offset, max_bytes))

        def part_v4(partition: int, err: int, high: int, records: bytes) -> bytes:
            return (
                wire.int32(partition)
                + wire.int16(err)
                + wire.int64(high)
                + wire.int64(high)  # last stable offset
                + wire.array([])  # aborted transactions
                + wire.bytes_(records)
            )

        # long-poll: wait up to max_wait for any requested topic to grow
        deadline = max_wait_ms / 1000.0
        with self._data:
            if not any(
                offset < len(self._logs.get(topic, []))
                for topic, _, offset, _ in requests
            ):
                self._data.wait(deadline)

            topics_out = []
            for topic, partition, offset, max_bytes in requests:
                log = self._logs.get(topic)
                if log is None and not self._topic_exists_or_create(topic):
                    topics_out.append(
                        wire.string(topic)
                        + wire.array([
                            part_v4(partition, wire.UNKNOWN_TOPIC_OR_PARTITION, -1, b"")
                        ])
                    )
                    continue
                log = self._logs[topic]
                high = len(log)
                if offset > high:
                    topics_out.append(
                        wire.string(topic)
                        + wire.array([
                            part_v4(partition, wire.OFFSET_OUT_OF_RANGE, high, b"")
                        ])
                    )
                    continue
                entries, size = [], 0
                for idx in range(offset, high):
                    key, value, headers = log[idx]
                    size += 70 + len(key or b"") + len(value)
                    if entries and size > max_bytes:
                        break
                    entries.append((key, value, headers))
                records = (
                    wire.encode_record_batch(offset, entries) if entries else b""
                )
                topics_out.append(
                    wire.string(topic)
                    + wire.array([part_v4(partition, wire.NONE, high, records)])
                )
            return wire.int32(0) + wire.array(topics_out)  # throttle_time + topics

    def _handle_list_offsets(self, r: wire.Reader) -> bytes:
        r.int32()  # replica_id
        topics_out = []
        for _ in range(r.int32()):
            topic = r.string() or ""
            parts_out = []
            for _ in range(r.int32()):
                partition = r.int32()
                timestamp = r.int64()
                r.int32()  # max offsets
                with self._lock:
                    log = self._logs.get(topic, [])
                    offset = 0 if timestamp == wire.EARLIEST_TIMESTAMP else len(log)
                parts_out.append(
                    wire.int32(partition)
                    + wire.int16(wire.NONE)
                    + wire.array([wire.int64(offset)])
                )
            topics_out.append(wire.string(topic) + wire.array(parts_out))
        return wire.array(topics_out)

    def _handle_metadata(self, r: wire.Reader) -> bytes:
        requested = [r.string() or "" for _ in range(r.int32())]
        with self._lock:
            names = requested or sorted(self._logs)
            topics_out = []
            for name in names:
                exists = name in self._logs
                err = wire.NONE if exists else wire.UNKNOWN_TOPIC_OR_PARTITION
                topics_out.append(
                    wire.int16(err)
                    + wire.string(name)
                    + wire.array([
                        wire.int16(wire.NONE)
                        + wire.int32(0)  # partition id
                        + wire.int32(0)  # leader: this node
                        + wire.array([wire.int32(0)])
                        + wire.array([wire.int32(0)])
                    ])
                )
        brokers = wire.array([
            wire.int32(0) + wire.string("127.0.0.1") + wire.int32(self.port)
        ])
        return brokers + wire.array(topics_out)

    def _handle_offset_commit(self, r: wire.Reader) -> bytes:
        group = r.string() or ""
        topics_out = []
        for _ in range(r.int32()):
            topic = r.string() or ""
            parts_out = []
            for _ in range(r.int32()):
                partition = r.int32()
                offset = r.int64()
                r.string()  # metadata
                with self._lock:
                    self._group_offsets[(group, topic, partition)] = offset
                parts_out.append(wire.int32(partition) + wire.int16(wire.NONE))
            topics_out.append(wire.string(topic) + wire.array(parts_out))
        return wire.array(topics_out)

    def _handle_offset_fetch(self, r: wire.Reader) -> bytes:
        group = r.string() or ""
        topics_out = []
        for _ in range(r.int32()):
            topic = r.string() or ""
            parts_out = []
            for _ in range(r.int32()):
                partition = r.int32()
                with self._lock:
                    offset = self._group_offsets.get((group, topic, partition), -1)
                parts_out.append(
                    wire.int32(partition)
                    + wire.int64(offset)
                    + wire.string("")
                    + wire.int16(wire.NONE)
                )
            topics_out.append(wire.string(topic) + wire.array(parts_out))
        return wire.array(topics_out)

    def _handle_create_topics(self, r: wire.Reader) -> bytes:
        topics_out = []
        for _ in range(r.int32()):
            name = r.string() or ""
            r.int32()  # num_partitions (single-partition broker)
            r.int16()  # replication factor
            for _ in range(r.int32()):  # assignments
                r.int32()
                for _ in range(r.int32()):
                    r.int32()
            for _ in range(r.int32()):  # configs
                r.string(), r.string()
            with self._lock:
                err = wire.TOPIC_ALREADY_EXISTS if name in self._logs else wire.NONE
                self._logs.setdefault(name, [])
            topics_out.append(wire.string(name) + wire.int16(err))
        r.int32()  # timeout (trailing in v0 request — already consumed topics)
        return wire.array(topics_out)

    def _handle_delete_topics(self, r: wire.Reader) -> bytes:
        names = [r.string() or "" for _ in range(r.int32())]
        r.int32()  # timeout
        topics_out = []
        with self._lock:
            for name in names:
                err = (
                    wire.NONE
                    if self._logs.pop(name, None) is not None
                    else wire.UNKNOWN_TOPIC_OR_PARTITION
                )
                topics_out.append(wire.string(name) + wire.int16(err))
        return wire.array(topics_out)

    # -- test inspection -----------------------------------------------------------
    def log(self, topic: str) -> list[tuple[bytes | None, bytes, list]]:
        """[(key, value, headers)] appended to the topic."""
        with self._lock:
            return list(self._logs.get(topic, []))

    def committed(self, group: str, topic: str, partition: int = 0) -> int:
        with self._lock:
            return self._group_offsets.get((group, topic, partition), -1)


def start_kafka_broker(**kw: Any) -> MiniKafkaBroker:
    return MiniKafkaBroker(**kw)
