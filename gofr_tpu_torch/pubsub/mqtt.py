"""MQTT 3.1.1 Pub/Sub driver — real wire protocol over TCP (a copy of
``gofr_tpu/datasource/pubsub/mqtt.py``).

Reference parity: datasource/pubsub/mqtt/mqtt.go (~700 LoC, eclipse/paho).
The image has no vendored MQTT client, so this driver implements the
3.1.1 protocol directly (OASIS spec): CONNECT/CONNACK, PUBLISH with QoS 0
and 1 (PUBACK), SUBSCRIBE/SUBACK, PINGREQ/PINGRESP, DISCONNECT — the
subset the reference driver exercises. At-least-once matches the broker
contract (subscriber.go:75-78): a QoS-1 inbound PUBLISH is PUBACKed on
``Message.commit()``, so an uncommitted message is redelivered by the
broker (DUP) after reconnect.

Tests run against the in-process broker in testutil/mqtt_broker.py — the
reference's CI-service-container pattern (SURVEY §4 tier 4) without
docker.
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from typing import Any

from gofr_tpu_torch.pubsub.message import Message

# packet types (MQTT-2.2.1)
CONNECT, CONNACK = 1, 2
PUBLISH, PUBACK = 3, 4
SUBSCRIBE, SUBACK = 8, 9
UNSUBSCRIBE, UNSUBACK = 10, 11
PINGREQ, PINGRESP = 12, 13
DISCONNECT = 14


class MQTTError(ConnectionError):
    pass


# ---------------------------------------------------------------- wire codec
def encode_remaining_length(n: int) -> bytes:
    """MQTT variable-length int (MQTT-2.2.3)."""
    out = bytearray()
    while True:
        byte = n % 128
        n //= 128
        out.append(byte | (0x80 if n else 0))
        if not n:
            return bytes(out)


def encode_string(s: str) -> bytes:
    data = s.encode()
    return struct.pack(">H", len(data)) + data


def packet(ptype: int, flags: int, payload: bytes) -> bytes:
    return bytes([(ptype << 4) | flags]) + encode_remaining_length(len(payload)) + payload


def read_packet(sock: socket.socket) -> tuple[int, int, bytes]:
    """Read one MQTT control packet; returns (type, flags, body)."""
    first = _read_exact(sock, 1)[0]
    ptype, flags = first >> 4, first & 0x0F
    length = 0
    multiplier = 1
    for _ in range(4):
        byte = _read_exact(sock, 1)[0]
        length += (byte & 0x7F) * multiplier
        if not byte & 0x80:
            break
        multiplier *= 128
    else:
        raise MQTTError("malformed remaining length")
    body = _read_exact(sock, length) if length else b""
    return ptype, flags, body


def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise MQTTError("connection closed")
        buf += chunk
    return buf


def connect_packet(client_id: str, keepalive: int, clean_session: bool) -> bytes:
    flags = 0x02 if clean_session else 0x00
    payload = (
        encode_string("MQTT") + bytes([4])  # protocol level 4 = 3.1.1
        + bytes([flags]) + struct.pack(">H", keepalive)
        + encode_string(client_id)
    )
    return packet(CONNECT, 0, payload)


def publish_packet(topic: str, payload: bytes, qos: int, packet_id: int, dup: bool = False) -> bytes:
    flags = (qos << 1) | (0x08 if dup else 0)
    body = encode_string(topic)
    if qos > 0:
        body += struct.pack(">H", packet_id)
    return packet(PUBLISH, flags, body + payload)


def parse_publish(flags: int, body: bytes) -> tuple[str, bytes, int, int]:
    """Returns (topic, payload, qos, packet_id)."""
    qos = (flags >> 1) & 0x03
    tlen = struct.unpack(">H", body[:2])[0]
    topic = body[2:2 + tlen].decode()
    rest = body[2 + tlen:]
    packet_id = 0
    if qos > 0:
        packet_id = struct.unpack(">H", rest[:2])[0]
        rest = rest[2:]
    return topic, rest, qos, packet_id


def subscribe_packet(packet_id: int, topic: str, qos: int) -> bytes:
    return packet(SUBSCRIBE, 0x02, struct.pack(">H", packet_id) + encode_string(topic) + bytes([qos]))


def topic_matches(pattern: str, topic: str) -> bool:
    """MQTT topic filter match with + and # wildcards (MQTT-4.7)."""
    p_parts = pattern.split("/")
    t_parts = topic.split("/")
    for i, p in enumerate(p_parts):
        if p == "#":
            return True
        if i >= len(t_parts):
            return False
        if p != "+" and p != t_parts[i]:
            return False
    return len(p_parts) == len(t_parts)


# ---------------------------------------------------------------- the driver
class MQTTClient:
    """Pub/Sub driver speaking MQTT 3.1.1. Same contract as the in-memory
    broker (publish/subscribe/create_topic/health_check/close)."""

    def __init__(
        self,
        host: str = "localhost",
        port: int = 1883,
        client_id: str | None = None,
        *,
        qos: int = 1,
        keepalive: int = 30,
        poll_timeout: float = 0.2,
    ) -> None:
        self.host = host
        self.port = port
        self.client_id = client_id or f"gofr-tpu-{id(self):x}"
        self.qos = qos
        self.keepalive = keepalive
        self.poll_timeout = poll_timeout
        self._sock: socket.socket | None = None
        self._lock = threading.Lock()  # serializes writes
        self._next_packet_id = 0
        self._acks: dict[int, threading.Event] = {}
        self._inbox: list[tuple[str, bytes, int, int]] = []
        self._inbox_cv = threading.Condition()
        self._subscribed: set[str] = set()
        self._reader: threading.Thread | None = None
        self._pinger: threading.Thread | None = None
        self._closed = False
        self._stop_ev = threading.Event()  # interrupts reconnect/ping waits
        self._connected = False
        # PINGREQ/PINGRESP bookkeeping for the close() flush barrier: the
        # broker answers pings in order, so resp-count catching up to
        # req-count proves everything sent before the last PINGREQ was
        # applied broker-side (a bare Event could be released by a stale
        # PINGRESP answering the keepalive pinger's earlier request)
        self._ping_cv = threading.Condition()
        self._pings_sent = 0
        self._pings_received = 0
        self._last_error: str | None = None
        self._logger: Any = None
        self._metrics: Any = None
        self._tracer: Any = None

    @classmethod
    def from_config(cls, config: Any) -> "MQTTClient":
        return cls(
            host=config.get_or_default("MQTT_HOST", "localhost"),
            port=int(config.get_or_default("MQTT_PORT", "1883")),
            client_id=config.get("MQTT_CLIENT_ID"),
            qos=int(config.get_or_default("MQTT_QOS", "1")),
            keepalive=int(config.get_or_default("MQTT_KEEPALIVE", "30")),
        )

    # -- provider pattern ------------------------------------------------------
    def use_logger(self, logger: Any) -> None:
        self._logger = logger

    def use_metrics(self, metrics: Any) -> None:
        self._metrics = metrics

    def use_tracer(self, tracer: Any) -> None:
        self._tracer = tracer

    def connect(self) -> None:
        self._connect_socket()
        if self._logger:
            self._logger.info(
                f"connected to MQTT broker at {self.host}:{self.port} "
                f"(client_id={self.client_id}, qos={self.qos})"
            )

    def _connect_socket(self) -> None:
        sock = socket.create_connection((self.host, self.port), timeout=10)
        sock.settimeout(None)
        sock.sendall(connect_packet(self.client_id, self.keepalive, clean_session=False))
        ptype, _, body = read_packet(sock)
        if ptype != CONNACK or len(body) < 2 or body[1] != 0:
            sock.close()
            raise MQTTError(f"CONNACK refused: {body!r}")
        self._sock = sock
        # new socket generation: in-flight pings from the old connection
        # will never be answered — reset so the close() barrier stays
        # satisfiable after a reconnect
        with self._ping_cv:
            self._pings_sent = 0
            self._pings_received = 0
        self._connected = True
        self._reader = threading.Thread(target=self._read_loop, daemon=True,
                                        name="mqtt-reader")
        self._reader.start()
        # the pinger is bound to THIS socket generation: after a reconnect
        # the old pinger sees self._sock is no longer its socket and exits
        # (otherwise every reconnect would leak one pinger thread)
        self._pinger = threading.Thread(target=self._ping_loop, args=(sock,),
                                        daemon=True, name="mqtt-pinger")
        self._pinger.start()
        # restore subscriptions after a reconnect
        for topic in list(self._subscribed):
            self._send_subscribe(topic)

    def _send(self, data: bytes) -> None:
        with self._lock:
            if self._sock is None:
                raise MQTTError("not connected")
            # gofrlint: disable=hold-and-block -- MQTT packet-write
            # serialization on the shared socket; the lock guards the wire,
            # so I/O under it IS the serialization contract
            self._sock.sendall(data)

    def _send_ping(self) -> int:
        """Send PINGREQ; returns the resp-count that acknowledges it."""
        with self._ping_cv:
            self._pings_sent += 1
            target = self._pings_sent
        self._send(packet(PINGREQ, 0, b""))
        return target

    def _packet_id(self) -> int:
        with self._lock:
            self._next_packet_id = (self._next_packet_id % 0xFFFF) + 1
            return self._next_packet_id

    # -- reader / keepalive ----------------------------------------------------
    def _read_loop(self) -> None:
        try:
            while not self._closed and self._sock is not None:
                ptype, flags, body = read_packet(self._sock)
                if ptype == PUBLISH:
                    topic, payload, qos, pid = parse_publish(flags, body)
                    with self._inbox_cv:
                        self._inbox.append((topic, payload, qos, pid))
                        self._inbox_cv.notify_all()
                elif ptype in (PUBACK, SUBACK, UNSUBACK):
                    pid = struct.unpack(">H", body[:2])[0]
                    ev = self._acks.pop(pid, None)
                    if ev:
                        ev.set()
                elif ptype == PINGRESP:
                    with self._ping_cv:
                        self._pings_received += 1
                        self._ping_cv.notify_all()
        except (MQTTError, OSError) as exc:
            self._connected = False
            self._last_error = str(exc)
            if not self._closed:
                if self._logger:
                    self._logger.warn(f"mqtt connection lost: {exc}; reconnecting")
                self._reconnect_loop()

    def _reconnect_loop(self) -> None:
        backoff = 0.2
        while not self._closed:
            try:
                self._connect_socket()
                return
            except (OSError, MQTTError) as exc:
                self._last_error = str(exc)
                if self._stop_ev.wait(backoff):
                    return  # close() interrupted the backoff
                backoff = min(backoff * 2, 5.0)

    def _ping_loop(self, sock: socket.socket) -> None:
        interval = max(self.keepalive / 2, 1)
        while not self._closed and self._sock is sock:
            if self._stop_ev.wait(interval):
                return  # close() interrupted the keepalive wait
            if self._closed or self._sock is not sock:
                return  # superseded by a reconnect
            try:
                self._send_ping()
            except (MQTTError, OSError):
                return  # reader notices the dead socket

    # -- Pub/Sub contract ------------------------------------------------------
    def publish(self, topic: str, message: bytes, metadata: dict | None = None) -> None:
        if isinstance(message, str):
            message = message.encode()
        pid = self._packet_id() if self.qos > 0 else 0
        ev = threading.Event()
        if self.qos > 0:
            self._acks[pid] = ev
        self._send(publish_packet(topic, message, self.qos, pid))
        if self.qos > 0 and not ev.wait(timeout=10):
            self._acks.pop(pid, None)
            raise MQTTError(f"PUBACK timeout for packet {pid}")
        if self._metrics:
            self._metrics.increment_counter("app_pubsub_publish_total_count", topic=topic)
            self._metrics.increment_counter("app_pubsub_publish_success_count", topic=topic)

    def _send_subscribe(self, topic: str) -> None:
        pid = self._packet_id()
        ev = threading.Event()
        self._acks[pid] = ev
        self._send(subscribe_packet(pid, topic, self.qos))
        if not ev.wait(timeout=10):
            self._acks.pop(pid, None)
            raise MQTTError(f"SUBACK timeout for {topic}")

    def subscribe(self, topic: str) -> Message | None:
        """Deliver the next matching message or None after poll_timeout.
        commit() PUBACKs (QoS 1) — the at-least-once contract."""
        if topic not in self._subscribed:
            self._send_subscribe(topic)
            self._subscribed.add(topic)
        deadline = time.monotonic() + self.poll_timeout
        with self._inbox_cv:
            while True:
                for i, (mtopic, payload, qos, pid) in enumerate(self._inbox):
                    if topic_matches(topic, mtopic):
                        self._inbox.pop(i)
                        return self._make_message(mtopic, payload, qos, pid)
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._inbox_cv.wait(remaining)

    def _make_message(self, topic: str, payload: bytes, qos: int, pid: int) -> Message:
        def _commit() -> None:
            # a failed PUBACK send must RAISE: the subscriber loop counts
            # commit failures distinctly and must not count a success (the
            # broker will redeliver the unacked message as DUP)
            if qos > 0:
                self._send(packet(PUBACK, 0, struct.pack(">H", pid)))

        def _nack(requeue: bool) -> None:
            # MQTT 3.1.1 has no negative ack (the broker only redelivers
            # DUP after reconnect): emulate requeue by re-enqueueing into
            # the local inbox so a later subscribe() delivers it again;
            # drop = PUBACK without processing.
            if requeue:
                with self._inbox_cv:
                    self._inbox.append((topic, payload, qos, pid))
                    self._inbox_cv.notify_all()
            else:
                _commit()

        # NOTE: the subscribe/commit counters are recorded by the framework
        # subscriber loop (subscriber.py); the reference counts
        # app_pubsub_subscribe_total_count here too, so every delivery twice
        # (ROADMAP Queue C 46)
        # the packet id is stable across redeliveries (broker resends with
        # DUP under the same pid; local re-enqueue keeps it) — but only
        # QoS>0 carries one
        return Message(topic=topic, value=payload, metadata={"qos": str(qos)},
                       committer=_commit, nacker=_nack,
                       message_id=str(pid) if qos > 0 else None)

    def create_topic(self, name: str) -> None:
        pass  # MQTT topics are implicit

    def delete_topic(self, name: str) -> None:
        pass

    def health_check(self) -> dict[str, Any]:
        details: dict[str, Any] = {
            "host": f"{self.host}:{self.port}",
            "backend": "MQTT",
            "client_id": self.client_id,
            "connected": self._connected,
            "subscriptions": sorted(self._subscribed),
        }
        if not self._connected:
            if self._last_error:
                details["error"] = self._last_error
            return {"status": "DOWN", "details": details}
        return {"status": "UP", "details": details}

    def close(self) -> None:
        # flush barrier: the broker processes a connection's packets in
        # order, so the PINGRESP answering the ping sent HERE proves every
        # prior packet (e.g. a commit's PUBACK) was applied broker-side
        if self._connected and self._sock is not None:
            try:
                target = self._send_ping()
                deadline = time.monotonic() + 2
                with self._ping_cv:
                    while self._pings_received < target:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            break
                        self._ping_cv.wait(remaining)
            except (MQTTError, OSError):
                pass
        self._closed = True
        self._stop_ev.set()
        self._connected = False
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.sendall(packet(DISCONNECT, 0, b""))
                sock.close()
            except OSError:
                pass


def new_mqtt(config: Any) -> MQTTClient:
    return MQTTClient.from_config(config)
