"""In-process MQTT 3.1.1 mini-broker for tests and local dev (a copy of
``gofr_tpu/testutil/mqtt_broker.py``).

Plays the role of the reference's CI service containers (kafka/redis in
.github/workflows/go.yml:38-77 — SURVEY §4 tier 4): a real TCP endpoint
speaking the real protocol, so the driver's wire codec, QoS-1 ack flow,
keepalive, and reconnect logic are tested end-to-end without docker.

Supported: CONNECT/CONNACK, SUBSCRIBE/SUBACK with +/# wildcard filters,
PUBLISH QoS 0/1 (PUBACK to the publisher; QoS-1 delivery redelivers with
DUP on reconnect until the subscriber PUBACKs), UNSUBSCRIBE, PINGREQ,
DISCONNECT.

One difference from the reference's fake: each accepted socket sets
``TCP_NODELAY`` (the reference's fake holds a PUBLISH that follows a PUBACK
on one connection about 44 ms on Linux loopback, behind the client's delayed
ACK); no byte on the wire changes.
"""

from __future__ import annotations

import socket
import struct
import threading
from typing import Any

from gofr_tpu_torch.pubsub.mqtt import (
    CONNACK,
    CONNECT,
    DISCONNECT,
    PINGREQ,
    PINGRESP,
    PUBACK,
    PUBLISH,
    SUBACK,
    SUBSCRIBE,
    UNSUBACK,
    UNSUBSCRIBE,
    MQTTError,
    encode_string,
    packet,
    parse_publish,
    publish_packet,
    read_packet,
    topic_matches,
)


class _Session:
    """Per-client-id state that survives reconnects (clean_session=0)."""

    def __init__(self, client_id: str) -> None:
        self.client_id = client_id
        self.subscriptions: dict[str, int] = {}  # filter -> qos
        self.unacked: dict[int, tuple[str, bytes]] = {}  # pid -> (topic, payload)
        self.conn: socket.socket | None = None
        self.lock = threading.Lock()

    def send(self, data: bytes) -> None:
        with self.lock:
            if self.conn is not None:
                try:
                    self.conn.sendall(data)
                except OSError:
                    self.conn = None


class MiniMQTTBroker:
    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(16)
        self.host, self.port = self._listener.getsockname()
        self._sessions: dict[str, _Session] = {}
        self._mu = threading.Lock()
        self._next_pid = 0
        self._closed = False
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="mqtt-broker-accept"
        )

    def start(self) -> "MiniMQTTBroker":
        self._accept_thread.start()
        return self

    def stop(self) -> None:
        self._closed = True
        try:
            self._listener.close()
        except OSError:
            pass
        with self._mu:
            for sess in self._sessions.values():
                with sess.lock:
                    if sess.conn is not None:
                        try:
                            sess.conn.close()
                        except OSError:
                            pass

    # ------------------------------------------------------------- internals
    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            # a PUBACK to a session followed by a PUBLISH to it is two small
            # sends: without this, Nagle's algorithm holds the PUBLISH behind
            # the client's delayed ACK (~44 ms)
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True,
                name="mqtt-broker-conn",
            ).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        sess: _Session | None = None
        try:
            ptype, _, body = read_packet(conn)
            if ptype != CONNECT:
                conn.close()
                return
            # body: proto name(6) + level(1) + flags(1) + keepalive(2) + client id
            idx = 2 + struct.unpack(">H", body[:2])[0] + 1 + 1 + 2
            cid_len = struct.unpack(">H", body[idx:idx + 2])[0]
            client_id = body[idx + 2: idx + 2 + cid_len].decode()
            with self._mu:
                sess = self._sessions.setdefault(client_id, _Session(client_id))
            session_present = bool(sess.subscriptions)
            with sess.lock:
                sess.conn = conn
            conn.sendall(packet(CONNACK, 0, bytes([1 if session_present else 0, 0])))
            # QoS-1 redelivery with DUP (MQTT-4.4)
            for pid, (topic, payload) in list(sess.unacked.items()):
                sess.send(publish_packet(topic, payload, 1, pid, dup=True))

            while not self._closed:
                ptype, flags, body = read_packet(conn)
                if ptype == PUBLISH:
                    self._handle_publish(sess, flags, body)
                elif ptype == SUBSCRIBE:
                    pid = struct.unpack(">H", body[:2])[0]
                    rest, granted = body[2:], []
                    while rest:
                        tlen = struct.unpack(">H", rest[:2])[0]
                        topic = rest[2:2 + tlen].decode()
                        qos = rest[2 + tlen]
                        sess.subscriptions[topic] = qos
                        granted.append(qos)
                        rest = rest[3 + tlen:]
                    sess.send(packet(SUBACK, 0, struct.pack(">H", pid) + bytes(granted)))
                elif ptype == UNSUBSCRIBE:
                    pid = struct.unpack(">H", body[:2])[0]
                    rest = body[2:]
                    while rest:
                        tlen = struct.unpack(">H", rest[:2])[0]
                        sess.subscriptions.pop(rest[2:2 + tlen].decode(), None)
                        rest = rest[2 + tlen:]
                    sess.send(packet(UNSUBACK, 0, struct.pack(">H", pid)))
                elif ptype == PUBACK:
                    pid = struct.unpack(">H", body[:2])[0]
                    sess.unacked.pop(pid, None)
                elif ptype == PINGREQ:
                    sess.send(packet(PINGRESP, 0, b""))
                elif ptype == DISCONNECT:
                    break
        except (MQTTError, OSError):
            pass
        finally:
            if sess is not None:
                with sess.lock:
                    if sess.conn is conn:
                        sess.conn = None
            try:
                conn.close()
            except OSError:
                pass

    def _handle_publish(self, publisher: _Session, flags: int, body: bytes) -> None:
        topic, payload, qos, pid = parse_publish(flags, body)
        if qos > 0:
            publisher.send(packet(PUBACK, 0, struct.pack(">H", pid)))
        with self._mu:
            sessions = list(self._sessions.values())
        for sess in sessions:
            for pattern, sub_qos in sess.subscriptions.items():
                if topic_matches(pattern, topic):
                    out_qos = min(qos, sub_qos)
                    if out_qos > 0:
                        with self._mu:
                            self._next_pid = (self._next_pid % 0xFFFF) + 1
                            out_pid = self._next_pid
                        sess.unacked[out_pid] = (topic, payload)
                        sess.send(publish_packet(topic, payload, 1, out_pid))
                    else:
                        sess.send(publish_packet(topic, payload, 0, 0))
                    break  # one delivery per session


__all__ = ["MiniMQTTBroker"]
