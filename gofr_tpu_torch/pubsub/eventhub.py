"""Azure Event Hubs Pub/Sub driver over from-scratch AMQP 1.0 (a copy of
``gofr_tpu/datasource/pubsub/eventhub.py``).

Reference parity: pkg/gofr/datasource/pubsub/eventhub/eventhub.go (787
LoC over the azeventhubs SDK). Behavior contract mirrored:

- ``Connect`` validates configs and dials the hub (eventhub.go:140-226);
  here: TCP → SASL PLAIN/ANONYMOUS → AMQP open/begin.
- ``Subscribe`` drains all partitions and returns the first available
  event (eventhub.go:248-263: "checks all partitions for the first
  available event"); commit sends the AMQP accepted disposition — the
  SDK's checkpoint analogue.
- ``Publish`` sends to the hub's node, optionally partitioned by a
  metadata key (eventhub.go:435-483).
- ``CreateTopic``/``DeleteTopic`` log "not supported" and return None —
  Event Hub has no data-plane topic management (eventhub.go:491-507);
  the ``gofr_migrations`` carve-out is kept so migrations never fail.
- ``Health`` reports connection state + partition count (the reference
  punts with "not implemented" — eventhub.go:485-489; we do better and
  keep the UP/DOWN contract every other driver honors).

Connection string format (Azure portal): ``Endpoint=sb://host[:port]/;
SharedAccessKeyName=<n>;SharedAccessKey=<k>[;EntityPath=<hub>]``.
"""

from __future__ import annotations

import itertools
import queue
import socket
import struct
import threading
from typing import Any

from gofr_tpu_torch.pubsub import amqp_wire as wire
from gofr_tpu_torch.pubsub.amqp_wire import (
    AmqpError,
    Described,
    Symbol,
    Ubyte,
    Uint,
    Ulong,
)
from gofr_tpu_torch.pubsub.message import Message

DEFAULT_PORT = 5671  # amqps; the from-scratch stack uses plain TCP (test rig)


def parse_connection_string(cs: str) -> dict[str, str]:
    out: dict[str, str] = {}
    for part in cs.split(";"):
        part = part.strip()
        if not part or "=" not in part:
            continue
        key, _, value = part.partition("=")
        out[key.strip()] = value.strip()
    ep = out.get("Endpoint", "")
    if ep.startswith("sb://"):
        hostport = ep[5:].strip("/")
        host, _, port = hostport.partition(":")
        out["host"] = host
        out["port"] = port or str(DEFAULT_PORT)
    return out


class _Link:
    __slots__ = ("name", "handle", "role", "address", "attached", "credit",
                 "credit_cv", "sent", "remote_handle", "queue")

    def __init__(self, name: str, handle: int, role: str, address: str) -> None:
        self.name = name
        self.handle = handle
        self.role = role  # "sender" | "receiver"
        self.address = address
        self.attached = threading.Event()
        self.credit = 0  # sender: broker FLOW grants; guarded by credit_cv
        self.credit_cv = threading.Condition()
        self.sent = 0  # sender: local delivery-count (transfers issued)
        self.remote_handle: int | None = None
        self.queue: "queue.Queue[tuple[int, bytes]]" = queue.Queue()


class EventHubClient:
    """Publisher/Subscriber/Client contract (interface.go:11-33) over the
    AMQP link protocol Event Hubs speaks."""

    def __init__(
        self,
        connection_string: str = "",
        eventhub_name: str = "",
        consumer_group: str = "$Default",
        host: str = "",
        port: int = 0,
        partitions: int = 2,
        poll_timeout: float = 0.2,
        connect_timeout: float = 5.0,
    ) -> None:
        parsed = parse_connection_string(connection_string) if connection_string else {}
        self.host = host or parsed.get("host", "localhost")
        self.port = int(port or int(parsed.get("port", DEFAULT_PORT)))
        self.eventhub_name = eventhub_name or parsed.get("EntityPath", "")
        self.sas_key_name = parsed.get("SharedAccessKeyName", "")
        self.sas_key = parsed.get("SharedAccessKey", "")
        self.consumer_group = consumer_group or "$Default"
        if partitions < 1:
            # a clear config error beats the ZeroDivisionError subscribe()'s
            # partition rotation would hit on an empty address list
            raise ValueError(
                f"EVENTHUB_PARTITIONS must be >= 1 (got {partitions})"
            )
        self.partitions = partitions
        self.poll_timeout = poll_timeout
        self.connect_timeout = connect_timeout

        self._sock: socket.socket | None = None
        self._rbuf = b""
        self._wlock = threading.Lock()
        self._lock = threading.Lock()
        # registry lock: guards the _receivers AND _senders registries and
        # is never held across a blocking wait — the reader thread takes it
        # on DETACH, and taking self._lock there instead could
        # deadlock-by-timeout (the attach path holds self._lock while
        # waiting for echoes only the reader can deliver). Always acquired
        # INSIDE self._lock when both are held (lock-order-static pins it).
        self._reg_lock = threading.Lock()
        self._handles = itertools.count(0)
        self._delivery_ids = itertools.count(0)
        self._links: dict[int, _Link] = {}  # local handle → link
        self._links_by_remote: dict[int, _Link] = {}  # peer handle → link
        self._senders: dict[str, _Link] = {}  # address → sender link
        self._receivers: dict[str, list[_Link]] = {}  # topic → receiver links
        self._rr_start: dict[str, int] = {}  # topic → next partition to poll
        self._next_outgoing_id = 0
        self._reader: threading.Thread | None = None
        self._closed = False
        self._connected = threading.Event()
        self._logger: Any = None
        self._metrics: Any = None

    @classmethod
    def from_config(cls, config: Any) -> "EventHubClient":
        return cls(
            connection_string=config.get_or_default("EVENTHUB_CONNECTION_STRING", ""),
            eventhub_name=config.get_or_default("EVENTHUB_NAME", ""),
            consumer_group=config.get_or_default("CONSUMER_ID", "$Default"),
            host=config.get_or_default("EVENTHUB_HOST", ""),
            port=int(config.get_or_default("EVENTHUB_PORT", "0")),
            partitions=int(config.get_or_default("EVENTHUB_PARTITIONS", "2")),
        )

    # -- provider pattern --------------------------------------------------
    def use_logger(self, logger: Any) -> None:
        self._logger = logger

    def use_metrics(self, metrics: Any) -> None:
        self._metrics = metrics

    def use_tracer(self, tracer: Any) -> None:
        pass

    # -- connection --------------------------------------------------------
    def connect(self) -> None:
        with self._lock:
            self._ensure_connected()
        if self._logger:
            self._logger.log(
                f"connected to eventhub {self.eventhub_name or '(unnamed)'} "
                f"at {self.host}:{self.port}"
            )

    def _ensure_connected(self) -> None:
        if self._sock is not None:
            return
        if self._closed:
            raise AmqpError("client closed")
        sock = socket.create_connection(
            (self.host, self.port), timeout=self.connect_timeout
        )
        sock.settimeout(None)
        self._sock = sock
        self._rbuf = b""
        try:
            self._sasl_handshake()
            self._amqp_open()
        except BaseException:
            self._sock = None
            sock.close()
            raise
        self._reader = threading.Thread(
            target=self._read_loop, daemon=True, name="eventhub-reader"
        )
        self._reader.start()

    def _send_raw(self, data: bytes) -> None:
        with self._wlock:
            assert self._sock is not None
            # gofrlint: disable=hold-and-block -- AMQP frame-write
            # serialization: _wlock exists to keep concurrent frames from
            # interleaving on the shared socket; it guards nothing else
            self._sock.sendall(data)

    def _recv_exact(self, n: int) -> bytes:
        while len(self._rbuf) < n:
            sock = self._sock
            if sock is None:  # closed underneath the reader thread
                raise AmqpError("connection closed")
            chunk = sock.recv(65536)
            if not chunk:
                raise AmqpError("connection closed by peer")
            self._rbuf += chunk
        out, self._rbuf = self._rbuf[:n], self._rbuf[n:]
        return out

    def _sasl_handshake(self) -> None:
        self._send_raw(wire.PROTO_SASL)
        if self._recv_exact(8) != wire.PROTO_SASL:
            raise AmqpError("peer rejected SASL protocol header")
        _, ftype, perf, _ = wire.read_frame(self._recv_exact)
        if perf is None or perf.descriptor != wire.SASL_MECHANISMS:
            raise AmqpError("expected sasl-mechanisms")
        if self.sas_key_name:
            mech = Symbol("PLAIN")
            initial = b"\x00" + self.sas_key_name.encode() + b"\x00" + self.sas_key.encode()
        else:
            mech = Symbol("ANONYMOUS")
            initial = b""
        init = Described(wire.SASL_INIT, [mech, initial, self.host])
        self._send_raw(wire.encode_frame(0, init, frame_type=wire.FRAME_SASL))
        _, _, outcome, _ = wire.read_frame(self._recv_exact)
        if outcome is None or outcome.descriptor != wire.SASL_OUTCOME:
            raise AmqpError("expected sasl-outcome")
        code = int(outcome.value[0]) if outcome.value else 1
        if code != 0:
            raise AmqpError(f"SASL auth failed (code {code})")

    def _amqp_open(self) -> None:
        self._send_raw(wire.PROTO_AMQP)
        if self._recv_exact(8) != wire.PROTO_AMQP:
            raise AmqpError("peer rejected AMQP protocol header")
        container = f"gofr-tpu-{id(self) & 0xFFFF}"
        self._send_raw(wire.encode_frame(
            0, Described(wire.OPEN, [container, self.host, Uint(1 << 20)])
        ))
        self._send_raw(wire.encode_frame(
            0, Described(wire.BEGIN, [None, Uint(0), Uint(2048), Uint(2048)])
        ))
        opened = begun = False
        while not (opened and begun):
            _, _, perf, _ = wire.read_frame(self._recv_exact)
            if perf is None:
                continue
            if perf.descriptor == wire.OPEN:
                opened = True
            elif perf.descriptor == wire.BEGIN:
                begun = True
            elif perf.descriptor == wire.CLOSE:
                raise AmqpError(f"peer closed during open: {perf.value}")
        self._connected.set()

    # -- reader loop -------------------------------------------------------
    def _read_loop(self) -> None:
        sock = self._sock
        try:
            while not self._closed and sock is self._sock:
                _, ftype, perf, payload = wire.read_frame(self._recv_exact)
                if perf is None:
                    continue
                self._dispatch(perf, payload)
        except (AmqpError, OSError, struct.error):
            pass
        finally:
            with self._lock:
                if sock is self._sock:
                    try:
                        sock.close()
                    except OSError:
                        pass
                    self._sock = None
                    self._links.clear()
                    self._links_by_remote.clear()
                    with self._reg_lock:
                        self._senders.clear()
                        self._receivers.clear()
                    self._connected.clear()
            if self._logger and not self._closed:
                self._logger.warn("eventhub connection lost; will reconnect on next use")

    def _dispatch(self, perf: Described, payload: bytes) -> None:
        fields = perf.value if isinstance(perf.value, list) else []
        if perf.descriptor == wire.ATTACH:
            # [name, handle, role, ...]: the peer's attach echo. The handle
            # in it is the handle the PEER assigned to its end of the link
            # (AMQP 1.0 §2.6.2) — all subsequent peer frames carry THAT
            # handle, so index the link by it. Snapshot the dict: _attach
            # on other threads mutates it concurrently.
            name = fields[0] if fields else ""
            for link in list(self._links.values()):
                if link.name == name:
                    link.remote_handle = int(fields[1])
                    self._links_by_remote[link.remote_handle] = link
                    link.attached.set()
        elif perf.descriptor == wire.FLOW:
            # [next-in-id, in-window, next-out-id, out-window, handle,
            #  delivery-count, link-credit, ...] → sender credit grant
            if len(fields) > 6 and fields[4] is not None:
                link = self._links_by_remote.get(int(fields[4]))
                if link is not None:
                    with link.credit_cv:
                        # §2.6.7: available credit = broker's snapshot of
                        # delivery-count + link-credit, minus transfers WE
                        # issued since that snapshot — setting the raw
                        # link-credit would re-grant in-flight transfers
                        base = int(fields[5] or 0) + int(fields[6] or 0)
                        link.credit = base - link.sent
                        link.credit_cv.notify_all()
                    link.attached.set()
        elif perf.descriptor == wire.TRANSFER:
            handle = int(fields[0])
            delivery_id = int(fields[1]) if len(fields) > 1 and fields[1] is not None else 0
            link = self._links_by_remote.get(handle)
            if link is not None:
                link.queue.put((delivery_id, payload))
        elif perf.descriptor == wire.DETACH:
            handle = int(fields[0]) if fields else -1
            link = self._links_by_remote.pop(handle, None)
            if link is not None:
                # a detached link must leave the registries, or publish/
                # subscribe() burns its per-link timeout on a dead link
                # forever. The REGISTRY lock serializes this against
                # _sender()'s get-or-attach and subscribe()'s snapshot —
                # an unguarded pop here could race _sender() caching a
                # fresh link for the same address and evict the NEW one.
                self._links.pop(link.handle, None)
                with self._reg_lock:
                    self._senders.pop(link.address, None)
                    for topic, links in list(self._receivers.items()):
                        if link in links:
                            links.remove(link)
                            if not links:
                                del self._receivers[topic]
        elif perf.descriptor == wire.CLOSE:
            raise AmqpError(f"peer closed connection: {fields}")

    # -- links -------------------------------------------------------------
    def _attach(self, role: str, address: str) -> _Link:
        handle = next(self._handles)
        link = _Link(f"{role}-{address}-{handle}", handle, role, address)
        self._links[handle] = link
        if role == "sender":
            # role=False (sender), source=our container, target=node address
            perf = Described(wire.ATTACH, [
                link.name, Uint(handle), False, Ubyte(2), Ubyte(0),
                Described(wire.SOURCE, [None]),
                Described(wire.TARGET, [address]),
            ])
        else:
            perf = Described(wire.ATTACH, [
                link.name, Uint(handle), True, Ubyte(0), Ubyte(0),
                Described(wire.SOURCE, [address]),
                Described(wire.TARGET, [None]),
            ])
        self._send_raw(wire.encode_frame(0, perf))
        if not link.attached.wait(self.connect_timeout):
            self._links.pop(handle, None)
            raise AmqpError(f"attach timeout for {address}")
        if role == "receiver":
            self._grant_credit(link, 100)
        return link

    def _grant_credit(self, link: _Link, credit: int) -> None:
        perf = Described(wire.FLOW, [
            Uint(0), Uint(2048), Uint(self._next_outgoing_id), Uint(2048),
            Uint(link.handle), Uint(0), Uint(credit),
        ])
        self._send_raw(wire.encode_frame(0, perf))

    def _sender(self, address: str) -> _Link:
        with self._lock:
            self._ensure_connected()
            with self._reg_lock:
                link = self._senders.get(address)
            if link is None:
                link = self._attach("sender", address)
                with self._reg_lock:
                    self._senders[address] = link
            return link

    def _partition_addresses(self, topic: str) -> list[str]:
        return [
            f"{topic}/ConsumerGroups/{self.consumer_group}/Partitions/{p}"
            for p in range(self.partitions)
        ]

    def _ensure_receivers(self, topic: str) -> list[_Link]:
        with self._lock:
            self._ensure_connected()
            with self._reg_lock:
                links = self._receivers.get(topic)
                if links:
                    # COPY: the reader thread mutates the stored list on
                    # detach while subscribe() iterates its snapshot
                    return list(links)
            links = [self._attach("receiver", a)
                     for a in self._partition_addresses(topic)]
            with self._reg_lock:
                self._receivers[topic] = links
            return list(links)

    # -- pubsub contract ---------------------------------------------------
    def publish(self, topic: str, message: bytes, metadata: dict | None = None) -> None:
        if isinstance(message, str):
            message = message.encode()
        link = self._sender(topic)
        # AMQP 1.0 flow control (§2.6.7): a sender may only transfer while
        # it holds link credit granted by the broker's FLOW. Sending
        # without credit is a protocol violation a real broker answers by
        # dropping or detaching — and success metrics would still have
        # incremented (ADVICE r4 medium). Wait for a grant, consume one.
        with link.credit_cv:
            if not link.credit_cv.wait_for(
                lambda: link.credit > 0, timeout=self.connect_timeout
            ):
                raise AmqpError(
                    f"publish to {topic}: no link credit granted within "
                    f"{self.connect_timeout}s (broker flow control)"
                )
            link.credit -= 1
            link.sent += 1
        delivery_id = next(self._delivery_ids)
        body = wire.encode_message(message, metadata)
        transfer = Described(wire.TRANSFER, [
            Uint(link.handle), Uint(delivery_id),
            struct.pack(">I", delivery_id), Uint(0), True,
        ])
        self._next_outgoing_id += 1
        self._send_raw(wire.encode_frame(0, transfer, body))
        if self._metrics:
            self._metrics.increment_counter(
                "app_pubsub_publish_total_count", topic=topic
            )
            self._metrics.increment_counter(
                "app_pubsub_publish_success_count", topic=topic
            )

    def subscribe(self, topic: str) -> Message | None:
        """First available event across ALL partitions (eventhub.go:248).
        Returns None when no event arrives within poll_timeout."""
        links = self._ensure_receivers(topic)
        # NOTE: the subscribe/commit counters are recorded by the framework
        # subscriber loop (subscriber.py); the reference also counts
        # app_pubsub_subscribe_total_count here on every poll, empty ones
        # included, and app_pubsub_subscribe_success_count below on every
        # delivery before its handler ran (ROADMAP Queue C 46)
        deadline = self.poll_timeout
        per_link = max(deadline / max(len(links), 1), 0.02)
        # rotate the starting partition per call: a fixed order starves
        # partitions behind a busy one (code-review r4)
        start = self._rr_start.get(topic, 0) % len(links)
        self._rr_start[topic] = start + 1
        links = links[start:] + links[:start]
        for link in links:
            try:
                delivery_id, payload = link.queue.get(timeout=per_link)
            except queue.Empty:
                continue
            body, props = wire.decode_message(payload)
            metadata = {str(k): str(v) for k, v in props.items()}
            metadata["partition"] = link.address.rsplit("/", 1)[-1]

            def _commit(did: int = delivery_id, lk: _Link = link) -> None:
                disp = Described(wire.DISPOSITION, [
                    True, Uint(did), Uint(did), True,
                    Described(wire.ACCEPTED, []),
                ])
                self._send_raw(wire.encode_frame(0, disp))
                self._grant_credit(lk, 100)

            def _nack(requeue: bool, did: int = delivery_id, lk: _Link = link) -> None:
                # AMQP 1.0 §3.4: RELEASED returns the delivery to the node
                # for redelivery; drop settles with ACCEPTED (the Event Hub
                # checkpoint model has no per-message poison slot)
                if not requeue:
                    _commit(did, lk)
                    return
                disp = Described(wire.DISPOSITION, [
                    True, Uint(did), Uint(did), True,
                    Described(wire.RELEASED, []),
                ])
                self._send_raw(wire.encode_frame(0, disp))
                self._grant_credit(lk, 100)

            return Message(topic, body, metadata, committer=_commit, nacker=_nack)
        return None

    def create_topic(self, name: str) -> None:
        """Event Hub has no data-plane topic creation (eventhub.go:491-500);
        the migrations table carve-out never fails the migration runner."""
        if name == "gofr_migrations":
            return
        if self._logger:
            self._logger.error("topic creation is not supported in Event Hub")

    def delete_topic(self, name: str) -> None:
        if self._logger:
            self._logger.error("topic deletion is not supported in Event Hub")

    def health_check(self) -> dict[str, Any]:
        details = {
            "host": f"{self.host}:{self.port}",
            "eventhub": self.eventhub_name,
            "consumer_group": self.consumer_group,
            "partitions": self.partitions,
            "backend": "EVENTHUB",
        }
        if self._sock is None:
            try:
                with self._lock:
                    self._ensure_connected()
            except (AmqpError, OSError) as exc:
                details["error"] = str(exc)
                return {"status": "DOWN", "details": details}
        return {"status": "UP", "details": details}

    def close(self) -> None:
        self._closed = True
        sock = self._sock
        if sock is not None:
            try:
                self._send_raw(wire.encode_frame(0, Described(wire.CLOSE, [])))
            except (AmqpError, OSError):
                pass
            try:
                sock.close()
            except OSError:
                pass
            self._sock = None


def new_eventhub(config: Any) -> EventHubClient:
    return EventHubClient.from_config(config)
