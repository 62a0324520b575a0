"""In-process NATS broker for tests (SURVEY §4 tier 4 service-container
stand-in, like kafka_broker.py; a copy of ``gofr_tpu/testutil/nats_broker.py``).

Core NATS text protocol: INFO/CONNECT/PING/PONG, PUB/HPUB, SUB with
**queue groups** (one delivery per group, round-robin within), UNSUB,
MSG/HMSG delivery with headers. At-least-once on top: every queue-group
delivery carries a reply inbox; a ``+ACK`` published there settles it,
and unsettled messages are redelivered to the group after ``ack_wait``
seconds (the JetStream ack model reduced to its observable contract).
"""

from __future__ import annotations

import itertools
import json
import socket
import threading
import time
from typing import Any

CRLF = b"\r\n"


class _Subscription:
    def __init__(self, conn: "_ClientConn", subject: str, queue_group: str,
                 sid: int) -> None:
        self.conn = conn
        self.subject = subject
        self.queue_group = queue_group
        self.sid = sid


class _Pending:
    __slots__ = ("subject", "headers", "body", "group", "deadline", "inbox")

    def __init__(self, subject: str, headers: dict, body: bytes, group: str,
                 deadline: float, inbox: str) -> None:
        self.subject = subject
        self.headers = headers
        self.body = body
        self.group = group
        self.deadline = deadline
        self.inbox = inbox


class MiniNatsBroker:
    def __init__(self, port: int = 0, ack_wait: float = 1.0) -> None:
        self.ack_wait = ack_wait
        self._subs: list[_Subscription] = []
        self._pending: dict[str, _Pending] = {}  # inbox → unacked delivery
        self._rr: dict[tuple[str, str], int] = {}
        self._conns: list["_ClientConn"] = []
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._running = True
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind(("127.0.0.1", port))
        self._server.listen(16)
        self.port = self._server.getsockname()[1]
        threading.Thread(target=self._accept_loop, daemon=True,
                         name="nats-broker").start()
        threading.Thread(target=self._redeliver_loop, daemon=True,
                         name="nats-redeliver").start()

    @property
    def address(self) -> str:
        return f"127.0.0.1:{self.port}"

    def close(self) -> None:
        self._running = False
        try:
            self._server.close()
        except OSError:
            pass
        # a real broker shutdown severs client connections too — clients
        # must observe the loss, not keep talking to a zombie socket.
        # shutdown() (not just close()) sends the FIN even while the conn
        # thread is blocked in recv.
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.sock.close()
            except OSError:
                pass

    # -- loops --------------------------------------------------------------
    def _accept_loop(self) -> None:
        while self._running:
            try:
                conn, _ = self._server.accept()
            except OSError:
                return
            client = _ClientConn(self, conn)
            with self._lock:
                self._conns.append(client)
            threading.Thread(target=client.run, daemon=True).start()

    def _redeliver_loop(self) -> None:
        while self._running:
            time.sleep(self.ack_wait / 4)
            now = time.monotonic()
            with self._lock:
                expired = [p for p in self._pending.values() if p.deadline <= now]
                for p in expired:
                    del self._pending[p.inbox]
            for p in expired:
                self._route(p.subject, p.headers, p.body, redelivered=True)

    # -- routing -------------------------------------------------------------
    def _match(self, pattern: str, subject: str) -> bool:
        pp, sp = pattern.split("."), subject.split(".")
        for i, tok in enumerate(pp):
            if tok == ">":
                return True
            if i >= len(sp):
                return False
            if tok != "*" and tok != sp[i]:
                return False
        return len(pp) == len(sp)

    def _route(self, subject: str, headers: dict, body: bytes,
               redelivered: bool = False) -> None:
        nak_pending: _Pending | None = None
        with self._lock:
            # ack inboxes bypass group delivery: +ACK/+TERM settle, -NAK
            # asks for immediate redelivery (the JetStream ack vocabulary)
            if subject.startswith("_ACK."):
                p = self._pending.pop(subject, None)
                if p is not None and body.strip() == b"-NAK":
                    nak_pending = p
                else:
                    return
        if nak_pending is not None:
            self._route(nak_pending.subject, nak_pending.headers,
                        nak_pending.body, redelivered=True)
            return
        with self._lock:
            by_group: dict[str, list[_Subscription]] = {}
            plain: list[_Subscription] = []
            for s in self._subs:
                if not self._match(s.subject, subject):
                    continue
                if s.queue_group:
                    by_group.setdefault(s.queue_group, []).append(s)
                else:
                    plain.append(s)
            targets: list[tuple[_Subscription, str]] = [(s, "") for s in plain]
            for group, members in by_group.items():
                idx = self._rr.get((subject, group), 0)
                self._rr[(subject, group)] = idx + 1
                chosen = members[idx % len(members)]
                inbox = f"_ACK.{next(self._ids)}"
                self._pending[inbox] = _Pending(
                    subject, headers, body, group,
                    time.monotonic() + self.ack_wait, inbox,
                )
                targets.append((chosen, inbox))
        for sub, inbox in targets:
            hdrs = dict(headers)
            if redelivered and inbox:
                hdrs["Nats-Redelivered"] = "true"
            sub.conn.deliver(sub, subject, inbox, hdrs, body)

    # -- test inspection -----------------------------------------------------
    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending)


class _ClientConn:
    def __init__(self, broker: MiniNatsBroker, sock: socket.socket) -> None:
        self.broker = broker
        self.sock = sock
        self._buf = b""
        self._wlock = threading.Lock()
        self._my_subs: list[_Subscription] = []

    # -- io ------------------------------------------------------------------
    def _read_line(self) -> bytes:
        while CRLF not in self._buf:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionError("client gone")
            self._buf += chunk
        line, self._buf = self._buf.split(CRLF, 1)
        return line

    def _read_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise ConnectionError("client gone")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def _send(self, data: bytes) -> None:
        with self._wlock:
            self.sock.sendall(data)

    def deliver(self, sub: _Subscription, subject: str, reply: str,
                headers: dict, body: bytes) -> None:
        try:
            if headers:
                from gofr_tpu_torch.pubsub.nats import encode_headers

                hdr = encode_headers(headers)
                head = f"HMSG {subject} {sub.sid}"
                if reply:
                    head += f" {reply}"
                head += f" {len(hdr)} {len(hdr) + len(body)}"
                self._send(head.encode() + CRLF + hdr + body + CRLF)
            else:
                head = f"MSG {subject} {sub.sid}"
                if reply:
                    head += f" {reply}"
                head += f" {len(body)}"
                self._send(head.encode() + CRLF + body + CRLF)
        except OSError:
            pass

    # -- protocol ------------------------------------------------------------
    def run(self) -> None:
        broker = self.broker
        try:
            self._send(
                b"INFO "
                + json.dumps({
                    "server_name": "gofr-mini-nats", "version": "2.10-mini",
                    "headers": True, "max_payload": 1 << 20,
                }).encode()
                + CRLF
            )
            while broker._running:
                line = self._read_line()
                verb, _, rest = line.partition(b" ")
                verb = verb.upper()
                if verb == b"CONNECT":
                    pass
                elif verb == b"PING":
                    self._send(b"PONG" + CRLF)
                elif verb == b"PONG":
                    pass
                elif verb == b"SUB":
                    parts = rest.decode().split()
                    if len(parts) == 3:
                        subject, group, sid = parts
                    else:
                        subject, sid = parts
                        group = ""
                    sub = _Subscription(self, subject, group, int(sid))
                    self._my_subs.append(sub)
                    with broker._lock:
                        broker._subs.append(sub)
                elif verb == b"UNSUB":
                    sid = int(rest.decode().split()[0])
                    with broker._lock:
                        broker._subs = [
                            s for s in broker._subs
                            if not (s.conn is self and s.sid == sid)
                        ]
                elif verb in (b"PUB", b"HPUB"):
                    parts = rest.decode().split()
                    if verb == b"PUB":
                        # PUB <subject> [reply] <total>
                        subject = parts[0]
                        total = int(parts[-1])
                        hdr_len = 0
                    else:
                        # HPUB <subject> [reply] <hdr_len> <total>
                        subject = parts[0]
                        hdr_len, total = int(parts[-2]), int(parts[-1])
                    payload = self._read_exact(total)
                    self._read_exact(2)  # CRLF
                    headers = {}
                    if hdr_len:
                        from gofr_tpu_torch.pubsub.nats import decode_headers

                        headers = decode_headers(payload[:hdr_len])
                    broker._route(subject, headers, payload[hdr_len:])
                else:
                    self._send(b"-ERR 'Unknown Protocol Operation'" + CRLF)
        except (ConnectionError, OSError, ValueError):
            pass
        finally:
            with broker._lock:
                broker._subs = [s for s in broker._subs if s.conn is not self]
            try:
                self.sock.close()
            except OSError:
                pass


def start_nats_broker(**kw: Any) -> MiniNatsBroker:
    return MiniNatsBroker(**kw)
