"""NATS Pub/Sub driver — the core NATS text protocol over TCP (a copy of
``gofr_tpu/datasource/pubsub/nats.py``).

Reference parity: pkg/gofr/datasource/pubsub/nats (1,487 LoC over
nats.go + JetStream). This image has no NATS client, so the driver
speaks the published wire protocol directly (like kafka_wire/mqtt):

- ``INFO {json}`` ← server hello; ``CONNECT {json}`` → handshake
- ``PUB <subject> [reply] <#bytes>\\r\\n<payload>\\r\\n``
- ``SUB <subject> [queue] <sid>\\r\\n`` — queue groups give Kafka-style
  consumer-group load balancing (each group sees every message once)
- ``MSG <subject> <sid> [reply] <#bytes>\\r\\n<payload>\\r\\n`` ← delivery
- ``HPUB``/``HMSG`` — headers variant (NATS 2.2+) carrying message
  metadata, like Kafka record headers
- ``PING``/``PONG`` keepalive, ``+OK``/``-ERR`` acks in verbose mode

At-least-once: the driver requests JetStream-style explicit acks by
publishing with a reply inbox; ``Message.commit()`` publishes the ack.
The in-process broker (testutil/nats_broker.py) redelivers unacked
messages after an ack-wait, so the subscriber-loop contract
(commit-on-success, subscriber.go:75-78) holds end to end.
"""

from __future__ import annotations

import itertools
import json
import queue
import socket
import threading
from typing import Any

from gofr_tpu_torch.pubsub.message import Message

CRLF = b"\r\n"


class NatsError(ConnectionError):
    pass


def encode_headers(headers: dict[str, str]) -> bytes:
    out = b"NATS/1.0\r\n"
    for k, v in headers.items():
        out += f"{k}: {v}".encode() + CRLF
    return out + CRLF


def decode_headers(data: bytes) -> dict[str, str]:
    lines = data.split(CRLF)
    out: dict[str, str] = {}
    for line in lines[1:]:  # first line is "NATS/1.0"
        if not line:
            continue
        key, _, value = line.partition(b":")
        out[key.decode().strip()] = value.decode().strip()
    return out


class _Conn:
    """Line/payload framing over the socket with a reader thread."""

    def __init__(self, host: str, port: int, timeout: float) -> None:
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.settimeout(None)
        self._buf = b""
        self._wlock = threading.Lock()

    def send(self, data: bytes) -> None:
        with self._wlock:
            # gofrlint: disable=hold-and-block -- NATS protocol-line write
            # serialization: _wlock keeps PUB/SUB frames from interleaving
            self.sock.sendall(data)

    def read_line(self) -> bytes:
        while CRLF not in self._buf:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise NatsError("connection closed by server")
            self._buf += chunk
        line, self._buf = self._buf.split(CRLF, 1)
        return line

    def read_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise NatsError("connection closed by server")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


class NatsClient:
    """The Pub/Sub Client contract over core NATS + ack inboxes."""

    def __init__(
        self,
        server: str = "localhost:4222",
        consumer_group: str = "gofr",
        client_name: str = "gofr-tpu",
        poll_timeout: float = 0.2,
        connect_timeout: float = 5.0,
    ) -> None:
        host, _, port = server.partition(":")
        self.server = server
        self.host, self.port = host or "localhost", int(port or 4222)
        self.consumer_group = consumer_group
        self.client_name = client_name
        self.poll_timeout = poll_timeout
        self.connect_timeout = connect_timeout
        self._conn: _Conn | None = None
        self._reader: threading.Thread | None = None
        self._sids = itertools.count(1)
        self._subs: dict[str, int] = {}  # subject → sid
        self._inboxes: dict[int, "queue.Queue"] = {}
        self._server_info: dict[str, Any] = {}
        self._lock = threading.Lock()
        self._closed = False
        self._logger: Any = None
        self._metrics: Any = None

    @classmethod
    def from_config(cls, config: Any) -> "NatsClient":
        return cls(
            server=config.get_or_default("NATS_SERVER", "localhost:4222"),
            consumer_group=config.get_or_default("CONSUMER_ID", "gofr"),
        )

    # -- provider pattern --------------------------------------------------
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
            self._logger.log(f"connected to nats at {self.server}")

    def _ensure_connected(self) -> None:
        if self._conn is not None:
            return
        if self._closed:
            raise NatsError("client closed")
        conn = _Conn(self.host, self.port, self.connect_timeout)
        line = conn.read_line()
        if not line.startswith(b"INFO "):
            raise NatsError(f"expected INFO, got {line[:40]!r}")
        self._server_info = json.loads(line[5:])
        connect_opts = {
            "verbose": False, "pedantic": False, "name": self.client_name,
            "lang": "python-gofr", "version": "1", "headers": True,
        }
        conn.send(b"CONNECT " + json.dumps(connect_opts).encode() + CRLF)
        conn.send(b"PING" + CRLF)
        line = conn.read_line()
        if line != b"PONG":
            raise NatsError(f"expected PONG, got {line[:40]!r}")
        self._conn = conn
        self._reader = threading.Thread(
            target=self._read_loop, daemon=True, name="nats-reader"
        )
        self._reader.start()

    def _read_loop(self) -> None:
        conn = self._conn
        try:
            while not self._closed and conn is self._conn:
                line = conn.read_line()
                if line == b"PING":
                    conn.send(b"PONG" + CRLF)
                elif line.startswith(b"MSG ") or line.startswith(b"HMSG "):
                    self._on_msg(conn, line)
                elif line.startswith(b"-ERR"):
                    if self._logger:
                        self._logger.error(f"nats server error: {line.decode()}")
                # PONG / +OK / INFO updates are ignorable here
        except (NatsError, OSError):
            pass
        finally:
            # a dead connection must be VISIBLE: clear state so the next
            # publish/subscribe/health call reconnects and resubscribes
            # instead of silently dropping into the void
            with self._lock:
                if conn is self._conn:
                    conn.close()
                    self._conn = None
                    self._subs.clear()
                    self._inboxes.clear()
            if self._logger and not self._closed:
                self._logger.warn("nats connection lost; will reconnect on next use")

    def _on_msg(self, conn: _Conn, line: bytes) -> None:
        parts = line.decode().split(" ")
        has_headers = parts[0] == "HMSG"
        # MSG  <subject> <sid> [reply] <total>
        # HMSG <subject> <sid> [reply] <hdr_len> <total>
        if has_headers:
            subject, sid = parts[1], int(parts[2])
            if len(parts) == 6:
                reply, hdr_len, total = parts[3], int(parts[4]), int(parts[5])
            else:
                reply, hdr_len, total = "", int(parts[3]), int(parts[4])
        else:
            subject, sid = parts[1], int(parts[2])
            if len(parts) == 5:
                reply, hdr_len, total = parts[3], 0, int(parts[4])
            else:
                reply, hdr_len, total = "", 0, int(parts[3])
        payload = conn.read_exact(total)
        conn.read_exact(2)  # trailing CRLF
        headers = decode_headers(payload[:hdr_len]) if hdr_len else {}
        body = payload[hdr_len:]
        inbox = self._inboxes.get(sid)
        if inbox is not None:
            inbox.put((subject, reply, headers, body))

    # -- Publisher ---------------------------------------------------------
    def publish(self, topic: str, message: bytes, metadata: dict | None = None) -> None:
        if self._metrics:
            self._metrics.increment_counter("app_pubsub_publish_total_count", topic=topic)
        with self._lock:
            self._ensure_connected()
        value = message if isinstance(message, bytes) else str(message).encode()
        if metadata:
            hdr = encode_headers({str(k): str(v) for k, v in metadata.items()})
            frame = (
                f"HPUB {topic} {len(hdr)} {len(hdr) + len(value)}".encode() + CRLF
                + hdr + value + CRLF
            )
        else:
            frame = f"PUB {topic} {len(value)}".encode() + CRLF + value + CRLF
        self._conn.send(frame)
        if self._metrics:
            self._metrics.increment_counter("app_pubsub_publish_success_count", topic=topic)

    # -- Subscriber --------------------------------------------------------
    def _ensure_subscribed(self, topic: str) -> int:
        with self._lock:
            self._ensure_connected()
            sid = self._subs.get(topic)
            if sid is None:
                sid = next(self._sids)
                self._subs[topic] = sid
                self._inboxes[sid] = queue.Queue()
                # queue group = consumer group: one delivery per group
                self._conn.send(
                    f"SUB {topic} {self.consumer_group} {sid}".encode() + CRLF
                )
            return sid

    def subscribe(self, topic: str) -> Message | None:
        sid = self._ensure_subscribed(topic)
        try:
            subject, reply, headers, body = self._inboxes[sid].get(
                timeout=self.poll_timeout
            )
        except queue.Empty:
            return None

        def _commit() -> None:
            # JetStream-style explicit ack: reply inbox carries the ack
            if reply:
                self.publish(reply, b"+ACK")

        def _nack(requeue: bool) -> None:
            # JetStream-style negative ack: -NAK asks for immediate
            # redelivery, +TERM stops delivery of the message for good
            if reply:
                self.publish(reply, b"-NAK" if requeue else b"+TERM")

        return Message(
            topic=subject, value=body, metadata=headers,
            committer=_commit, nacker=_nack,
        )

    # -- admin / health ----------------------------------------------------
    def create_topic(self, name: str) -> None:
        pass  # NATS subjects are implicit

    def delete_topic(self, name: str) -> None:
        with self._lock:
            sid = self._subs.pop(name, None)
            if sid is not None and self._conn is not None:
                self._conn.send(f"UNSUB {sid}".encode() + CRLF)
                self._inboxes.pop(sid, None)

    def backlog(self, topic: str) -> int:
        sid = self._subs.get(topic)
        if sid is None:
            return 0
        return self._inboxes[sid].qsize()

    def health_check(self) -> dict[str, Any]:
        try:
            with self._lock:
                self._ensure_connected()
            return {
                "status": "UP",
                "details": {
                    "backend": "nats",
                    "host": self.server,
                    "consumer_group": self.consumer_group,
                    "server_name": self._server_info.get("server_name", ""),
                    "subscriptions": len(self._subs),
                },
            }
        except (OSError, NatsError) as exc:
            return {
                "status": "DOWN",
                "details": {"backend": "nats", "host": self.server, "error": str(exc)},
            }

    def close(self) -> None:
        self._closed = True
        with self._lock:
            if self._conn is not None:
                self._conn.close()
                self._conn = None
