"""In-process Event Hubs stand-in for tests (SURVEY §4 tier 4 service-
container analogue, like kafka_broker.py / nats_broker.py; a copy of
``gofr_tpu/testutil/eventhub_server.py``).

Speaks the same AMQP 1.0 subset as the driver (pubsub/amqp_wire.py):
SASL PLAIN/ANONYMOUS, open/begin, attach (sender and receiver roles),
flow credit, transfer, disposition. Event Hub semantics on top:

- a hub (topic) is a fixed set of partitions; publishes land on a
  partition by round-robin (or by the ``partition-key`` application
  property's hash when present);
- consumers attach per-partition receiver links at
  ``<hub>/ConsumerGroups/<group>/Partitions/<n>``;
- per (hub, group, partition) a cursor tracks the next undelivered
  offset; an ``accepted`` disposition checkpoints through the delivered
  offset (the reference SDK's blob-checkpoint reduced to its observable
  contract) — unacknowledged messages are redelivered to the next
  attaching receiver.

One difference from the reference's fake: each accepted socket sets
``TCP_NODELAY`` (the reference's fake holds a frame that follows another on
one connection about 44 ms on Linux loopback, behind the client's delayed
ACK); no byte on the wire changes.
"""

from __future__ import annotations

import itertools
import socket
import struct
import threading
from typing import Any

from gofr_tpu_torch.pubsub import amqp_wire as wire
from gofr_tpu_torch.pubsub.amqp_wire import Described, Symbol, Ubyte, Uint


class _Partition:
    def __init__(self) -> None:
        self.messages: list[bytes] = []  # raw AMQP message sections
        self.cursors: dict[str, int] = {}  # group → next-undelivered offset
        self.acked: dict[str, int] = {}  # group → checkpointed offset (excl.)


class _ReceiverLink:
    __slots__ = ("handle", "server_handle", "topic", "group", "partition",
                 "credit", "delivered")

    def __init__(self, handle: int, server_handle: int, topic: str, group: str,
                 partition: int) -> None:
        self.handle = handle  # the CLIENT's handle (incoming frames carry it)
        self.server_handle = server_handle  # OUR handle (outgoing frames carry it)
        self.topic = topic
        self.group = group
        self.partition = partition
        self.credit = 0
        self.delivered: dict[int, int] = {}  # delivery_id → message offset


class MiniEventHubServer:
    def __init__(self, port: int = 0, partitions: int = 2) -> None:
        self.partitions = partitions
        self._topics: dict[str, list[_Partition]] = {}
        self._rr = itertools.count(0)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(("127.0.0.1", port))
        self._listener.listen(16)
        self.port = self._listener.getsockname()[1]
        self._closed = False
        self._threads: list[threading.Thread] = []
        self.auth_attempts: list[tuple[str, str]] = []  # (mechanism, identity)

    def start(self) -> "MiniEventHubServer":
        t = threading.Thread(target=self._accept_loop, daemon=True,
                             name="eventhub-server")
        t.start()
        self._threads.append(t)
        return self

    def close(self) -> None:
        self._closed = True
        try:
            self._listener.close()
        except OSError:
            pass
        with self._cond:
            self._cond.notify_all()

    # -- introspection for tests ------------------------------------------
    def topic_depth(self, topic: str, group: str = "$Default") -> int:
        """Messages not yet checkpointed by ``group`` across partitions."""
        with self._lock:
            parts = self._topics.get(topic, [])
            return sum(len(p.messages) - p.acked.get(group, 0) for p in parts)

    def _partitions_for(self, topic: str) -> list[_Partition]:
        parts = self._topics.get(topic)
        if parts is None:
            parts = [_Partition() for _ in range(self.partitions)]
            self._topics[topic] = parts
        return parts

    # -- connection handling ----------------------------------------------
    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            # frames go out one small send each (a disposition's echo, a
            # transfer behind a flow): without this, Nagle's algorithm holds
            # the second behind the client's delayed ACK (~44 ms)
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            t = threading.Thread(
                target=self._serve, args=(conn,), daemon=True,
                name="eventhub-conn",
            )
            t.start()
            self._threads.append(t)

    def _serve(self, sock: socket.socket) -> None:
        state = _ConnState(self, sock)
        try:
            state.run()
        except (wire.AmqpError, OSError, struct.error, IndexError):
            pass
        finally:
            state.stop()
            try:
                sock.close()
            except OSError:
                pass


class _ConnState:
    """One client connection: protocol pumps + delivery thread."""

    def __init__(self, server: MiniEventHubServer, sock: socket.socket) -> None:
        self.server = server
        self.sock = sock
        self._rbuf = b""
        self._wlock = threading.Lock()
        self._receivers: dict[int, _ReceiverLink] = {}
        self._sender_addresses: dict[int, str] = {}  # sender handle → target
        # sender handle → (our echo handle, transfers since last grant):
        # brokers replenish link credit as transfers consume it (AMQP
        # §2.6.7); without this a client enforcing credit stalls at the
        # initial grant
        self._sender_grants: dict[int, tuple[int, int]] = {}
        # deliberately DIFFERENT numbering from any client (spec §2.6.2:
        # each endpoint assigns its own handles; frames carry the sender's)
        # — catches clients that route incoming frames by their own handle
        self._server_handles = itertools.count(100)
        self._delivery_ids = itertools.count(0)
        self._stop = threading.Event()

    # -- io ----------------------------------------------------------------
    def _recv_exact(self, n: int) -> bytes:
        while len(self._rbuf) < n:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise wire.AmqpError("client disconnected")
            self._rbuf += chunk
        out, self._rbuf = self._rbuf[:n], self._rbuf[n:]
        return out

    def _send(self, data: bytes) -> None:
        with self._wlock:
            self.sock.sendall(data)

    # -- lifecycle ---------------------------------------------------------
    def run(self) -> None:
        header = self._recv_exact(8)
        if header == wire.PROTO_SASL:
            self._sasl()
            header = self._recv_exact(8)
        if header != wire.PROTO_AMQP:
            raise wire.AmqpError("expected AMQP protocol header")
        self._send(wire.PROTO_AMQP)
        pump = threading.Thread(target=self._delivery_pump, daemon=True,
                                name="eventhub-delivery")
        pump.start()
        while True:
            _, ftype, perf, payload = wire.read_frame(self._recv_exact)
            if perf is None:
                continue
            if not self._handle(perf, payload):
                return

    def stop(self) -> None:
        self._stop.set()
        with self.server._cond:
            # a dying connection's delivered-but-unacked messages must
            # redeliver: roll its partitions' cursors back to the
            # checkpoint so the next attach (or a racing live pump) sees
            # them — without this, a pump that reserved a message just as
            # its socket died swallows it forever
            for link in self._receivers.values():
                parts = self.server._topics.get(link.topic)
                if parts is not None:
                    part = parts[link.partition]
                    part.cursors[link.group] = part.acked.get(link.group, 0)
            self._receivers.clear()
            self.server._cond.notify_all()

    def _sasl(self) -> None:
        self._send(wire.PROTO_SASL)
        mechs = Described(wire.SASL_MECHANISMS, [[Symbol("PLAIN"), Symbol("ANONYMOUS")]])
        self._send(wire.encode_frame(0, mechs, frame_type=wire.FRAME_SASL))
        _, _, init, _ = wire.read_frame(self._recv_exact)
        if init is None or init.descriptor != wire.SASL_INIT:
            raise wire.AmqpError("expected sasl-init")
        mech = str(init.value[0])
        identity = ""
        if mech == "PLAIN" and len(init.value) > 1 and init.value[1]:
            parts = bytes(init.value[1]).split(b"\x00")
            identity = parts[1].decode() if len(parts) > 1 else ""
        self.server.auth_attempts.append((mech, identity))
        outcome = Described(wire.SASL_OUTCOME, [Ubyte(0), None])
        self._send(wire.encode_frame(0, outcome, frame_type=wire.FRAME_SASL))

    # -- frame handling ----------------------------------------------------
    def _handle(self, perf: Described, payload: bytes) -> bool:
        fields = perf.value if isinstance(perf.value, list) else []
        d = perf.descriptor
        if d == wire.OPEN:
            self._send(wire.encode_frame(
                0, Described(wire.OPEN, ["mini-eventhub", None, Uint(1 << 20)])
            ))
        elif d == wire.BEGIN:
            self._send(wire.encode_frame(
                0, Described(wire.BEGIN, [Uint(0), Uint(0), Uint(2048), Uint(2048)])
            ))
        elif d == wire.ATTACH:
            self._attach(fields)
        elif d == wire.FLOW:
            if len(fields) > 6 and fields[4] is not None:
                link = self._receivers.get(int(fields[4]))
                if link is not None:
                    with self.server._cond:
                        link.credit = int(fields[6] or 0)
                        self.server._cond.notify_all()
        elif d == wire.TRANSFER:
            self._transfer(fields, payload)
        elif d == wire.DISPOSITION:
            self._disposition(fields)
        elif d == wire.DETACH:
            handle = int(fields[0]) if fields else -1
            self._receivers.pop(handle, None)
            self._send(wire.encode_frame(0, Described(wire.DETACH, [Uint(handle), True])))
        elif d == wire.END:
            self._send(wire.encode_frame(0, Described(wire.END, [])))
        elif d == wire.CLOSE:
            self._send(wire.encode_frame(0, Described(wire.CLOSE, [])))
            return False
        return True

    def _attach(self, fields: list) -> None:
        name = fields[0]
        handle = int(fields[1])
        client_is_receiver = bool(fields[2])
        if client_is_receiver:
            # client receives: source address names hub/group/partition
            source = fields[5]
            address = source.value[0] if isinstance(source, Described) else str(source)
            topic, group, partition = _parse_partition_address(str(address))
            server_handle = next(self._server_handles)
            with self.server._lock:
                self.server._partitions_for(topic)
                link = _ReceiverLink(handle, server_handle, topic, group, partition)
                # delivery resumes from the checkpoint, not the old cursor:
                # unacked-but-delivered messages redeliver to this link
                part = self.server._topics[topic][partition]
                part.cursors[group] = part.acked.get(group, 0)
                self._receivers[handle] = link
            echo = Described(wire.ATTACH, [
                name, Uint(server_handle), False, Ubyte(0), Ubyte(0),
                Described(wire.SOURCE, [address]),
                Described(wire.TARGET, [None]),
            ])
            self._send(wire.encode_frame(0, echo))
        else:
            # client sends into the hub node: record handle → target address
            target = fields[6] if len(fields) > 6 else None
            address = (
                str(target.value[0])
                if isinstance(target, Described) and target.value else ""
            )
            self._sender_addresses[handle] = address
            server_handle = next(self._server_handles)
            self._sender_grants[handle] = (server_handle, 0)
            echo = Described(wire.ATTACH, [
                name, Uint(server_handle), True, Ubyte(0), Ubyte(0),
                Described(wire.SOURCE, [None]),
                Described(wire.TARGET, [address or None]),
            ])
            self._send(wire.encode_frame(0, echo))
            flow = Described(wire.FLOW, [
                Uint(0), Uint(2048), Uint(0), Uint(2048),
                Uint(server_handle), Uint(0), Uint(1000),
            ])
            self._send(wire.encode_frame(0, flow))

    def _transfer(self, fields: list, payload: bytes) -> None:
        # find the sender link's target address by handle: we echoed the
        # client's attach, so reconstruct from the transfer handle registry.
        handle = int(fields[0])
        address = self._sender_addresses.get(handle)
        if address is None:
            return
        body, props = wire.decode_message(payload)
        with self.server._cond:
            parts = self.server._partitions_for(address)
            pkey = props.get("partition-key") or props.get(Symbol("partition-key"))
            if pkey is not None:
                idx = hash(str(pkey)) % len(parts)
            else:
                idx = next(self.server._rr) % len(parts)
            parts[idx].messages.append(payload)
            self.server._cond.notify_all()
        grant = self._sender_grants.get(handle)
        if grant is not None:
            server_handle, received = grant[0], grant[1] + 1
            if received % 500 == 0:  # top the window back up before it drains
                # delivery-count (field 5) carries OUR receive count so the
                # client's §2.6.7 arithmetic (count + credit - sent) lands
                # on a fresh window of 1000
                flow = Described(wire.FLOW, [
                    Uint(0), Uint(2048), Uint(0), Uint(2048),
                    Uint(server_handle), Uint(received), Uint(1000),
                ])
                self._send(wire.encode_frame(0, flow))
            self._sender_grants[handle] = (server_handle, received)

    def _disposition(self, fields: list) -> None:
        first = int(fields[1])
        last = int(fields[2]) if len(fields) > 2 and fields[2] is not None else first
        state = fields[4] if len(fields) > 4 else None
        released = (
            isinstance(state, Described) and state.descriptor == wire.RELEASED
        )
        with self.server._cond:
            for link in self._receivers.values():
                for did in range(first, last + 1):
                    offset = link.delivered.pop(did, None)
                    if offset is None:
                        continue
                    part = self.server._topics[link.topic][link.partition]
                    if released:
                        # AMQP RELEASED: the delivery goes back to the node —
                        # rewind the group cursor so the pump redelivers it
                        cur = part.cursors.get(link.group, 0)
                        part.cursors[link.group] = min(cur, offset)
                    else:
                        prev = part.acked.get(link.group, 0)
                        part.acked[link.group] = max(prev, offset + 1)
            self.server._cond.notify_all()

    # -- delivery ----------------------------------------------------------
    def _delivery_pump(self) -> None:
        """Push undelivered messages to receiver links with credit."""
        server = self.server
        while not self._stop.is_set():
            sends: list[tuple[_ReceiverLink, int, int, bytes]] = []
            with server._cond:
                for link in self._receivers.values():
                    part = server._topics.get(link.topic, [None] * (link.partition + 1))[link.partition]
                    if part is None:
                        continue
                    cursor = part.cursors.get(link.group, 0)
                    while link.credit > 0 and cursor < len(part.messages):
                        did = next(self._delivery_ids)
                        sends.append((link, did, cursor, part.messages[cursor]))
                        link.delivered[did] = cursor
                        cursor += 1
                        link.credit -= 1
                    part.cursors[link.group] = cursor
                if not sends:
                    server._cond.wait(timeout=0.1)
                    continue
            for link, did, _offset, payload in sends:
                transfer = Described(wire.TRANSFER, [
                    Uint(link.server_handle), Uint(did),
                    struct.pack(">I", did), Uint(0), False,
                ])
                try:
                    self._send(wire.encode_frame(0, transfer, payload))
                except OSError:
                    return


def _parse_partition_address(address: str) -> tuple[str, str, int]:
    """``<hub>/ConsumerGroups/<group>/Partitions/<n>`` → (hub, group, n)."""
    parts = address.strip("/").split("/")
    try:
        cg = parts.index("ConsumerGroups")
        topic = "/".join(parts[:cg])
        group = parts[cg + 1]
        partition = int(parts[parts.index("Partitions") + 1])
        return topic, group, partition
    except (ValueError, IndexError):
        return address, "$Default", 0
